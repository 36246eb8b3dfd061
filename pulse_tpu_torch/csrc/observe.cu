// K2: the 934-float observation of the imitation env, one thread per env:
// the heading-local self observation (v1) of the post-merge body state and
// the imitation task observation (v6, one future step) against the
// reference bodies at the next control time.
//
// Replaces the TPU kernel pulse_tpu/env/pallas_obs.py:pallas_observe (body
// _build_obs_kernel). Plain version:
// pulse_tpu_torch/env/cuda_obs.py:observe_plain. The heading is the atan2
// form of the plain version (humanoid_math.cuh heading), not the TPU
// kernel's half-angle form.
//
// Bound on the H100: by bytes. An env reads 624 floats and writes 934 and
// does a few thousand float operations on them, so the kernel streams.
// Inputs and outputs are [rows, B]: a warp's 32 loads of one row are one
// 128-byte line. No shared memory and no local arrays.
#include <cuda_runtime.h>

#include "humanoid_math.cuh"

using namespace hm;

__global__ void __launch_bounds__(128) observe_kernel(const float* __restrict__ in,
                                                      float* __restrict__ out, int B, int J,
                                                      int local_root_obs, int root_height_obs) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const float* x = in + e;
  float* y = out + e;
  auto rd = [&](int r) { return x[(size_t)r * B]; };
  auto wr = [&](int r, float v) { y[(size_t)r * B] = v; };
  // body block pos 3J | rot 4J | vel 3J | ang 3J, then the same for the ref
  auto v3at = [&](int base, int b) { return V3{rd(base + 3 * b), rd(base + 3 * b + 1), rd(base + 3 * b + 2)}; };
  auto q4at = [&](int base, int b) {
    return Q4{rd(base + 4 * b), rd(base + 4 * b + 1), rd(base + 4 * b + 2), rd(base + 4 * b + 3)};
  };
  const int bp = 0, br = 3 * J, bv = 7 * J, ba = 10 * J;
  const int rp = 13 * J, rr = rp + 3 * J, rv = rp + 7 * J, ra = rp + 10 * J;

  const V3 root_pos = v3at(bp, 0);
  const Q4 root_rot = q4at(br, 0);
  const float h = heading(root_rot);
  const Q4 hinv = zrot(-h), hq = zrot(h);
  float tn[6];

  // ---- self obs: [root_h?, local pos (J-1)*3, rot J*6, vel J*3, ang J*3] -- //
  int o = 0;
  if (root_height_obs) wr(o++, root_pos.z);
  const int o_pos = o, o_rot = o_pos + 3 * (J - 1), o_vel = o_rot + 6 * J, o_ang = o_vel + 3 * J;
  const int t0 = o_ang + 3 * J;  // task obs, category-major over bodies
  for (int b = 0; b < J; ++b) {
    const V3 pos = v3at(bp, b), vel = v3at(bv, b), ang = v3at(ba, b);
    const Q4 rot = q4at(br, b);
    if (b > 0) {
      const V3 lp = qrot(hinv, pos - root_pos);
      wr(o_pos + 3 * (b - 1), lp.x); wr(o_pos + 3 * (b - 1) + 1, lp.y); wr(o_pos + 3 * (b - 1) + 2, lp.z);
    }
    tan_norm((b == 0 && !local_root_obs) ? root_rot : qmul(hinv, rot), tn);
    for (int k = 0; k < 6; ++k) wr(o_rot + 6 * b + k, tn[k]);
    const V3 lv = qrot(hinv, vel), la = qrot(hinv, ang);
    wr(o_vel + 3 * b, lv.x); wr(o_vel + 3 * b + 1, lv.y); wr(o_vel + 3 * b + 2, lv.z);
    wr(o_ang + 3 * b, la.x); wr(o_ang + 3 * b + 1, la.y); wr(o_ang + 3 * b + 2, la.z);

    // ---- task obs v6 --------------------------------------------------- //
    const V3 rpos = v3at(rp, b), rvel = v3at(rv, b), rang = v3at(ra, b);
    const Q4 rrot = q4at(rr, b);
    const V3 dp = qrot(hinv, rpos - pos);
    const V3 dv = qrot(hinv, rvel - vel);
    const V3 da = qrot(hinv, rang - ang);
    const V3 lrp = qrot(hinv, rpos - root_pos);
    const int c0 = t0 + 3 * b, c2 = t0 + 9 * J + 3 * b, c3 = t0 + 12 * J + 3 * b, c4 = t0 + 15 * J + 3 * b;
    wr(c0, dp.x); wr(c0 + 1, dp.y); wr(c0 + 2, dp.z);
    wr(c2, dv.x); wr(c2 + 1, dv.y); wr(c2 + 2, dv.z);
    wr(c3, da.x); wr(c3 + 1, da.y); wr(c3 + 2, da.z);
    wr(c4, lrp.x); wr(c4 + 1, lrp.y); wr(c4 + 2, lrp.z);
    tan_norm(qmul(qmul(hinv, qmul(rrot, qconj(rot))), hq), tn);
    for (int k = 0; k < 6; ++k) wr(t0 + 3 * J + 6 * b + k, tn[k]);
    tan_norm(qmul(hinv, rrot), tn);
    for (int k = 0; k < 6; ++k) wr(t0 + 18 * J + 6 * b + k, tn[k]);
  }
}

extern "C" {

// in: [26 J, B] f32, out: [(root_h) + 15 J - 3 + 24 J, B] f32.
int k2_observe(const float* in, float* out, int B, int J, int local_root_obs, int root_height_obs,
               int block, void* stream) {
  observe_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      in, out, B, J, local_root_obs, root_height_obs);
  return (int)cudaGetLastError();
}

}  // extern "C"
