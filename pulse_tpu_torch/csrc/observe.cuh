// K2's work for one (env, body) pair: the observation entries of body b of
// env e, the heading-local self observation (v1) of the post-merge body
// state and the imitation task observation (v6, one future step) against
// the reference bodies at the next control time.
//
// Mirrors pulse_tpu_torch/env/cuda_obs.py:observe_plain formula for formula,
// with its atan2 heading (humanoid_math.cuh heading), not the TPU kernel's
// half-angle form. __host__ __device__, so g++ builds it for the host and
// the CPU tests hold it, looped over (env, body), against the plain version.
#pragma once

#include "humanoid_math.cuh"

namespace hm {

// K2's inputs, eight [B, J, *] tensors read in place: env e's block of input
// k is contiguous at p[k] + e * stride[k]. In order: the bodies' pos, rot,
// vel, ang; the reference bodies' pos, rot, vel, ang.
constexpr int kObsInputs = 8;
struct ObsIn {
  const float* p[kObsInputs];
  long long stride[kObsInputs];
};

HD V3 v3_at(const float* p) { return V3{p[0], p[1], p[2]}; }
HD Q4 q4_at(const float* p) { return Q4{p[0], p[1], p[2], p[3]}; }

// Writes body b's entries of env e's observation row y: in the self
// observation [root_h?, local pos (J-1)*3, rot J*6, vel J*3, ang J*3] the
// root height (b = 0), its local position (b > 0), rotation tan-norm, local
// velocity and angular velocity; in the task observation, from column
// task_col, category-major over bodies [pos diff 3J, rot diff 6J, vel diff
// 3J, ang diff 3J, local ref pos 3J, local ref rot 6J], its six blocks.
// Every pair reads its env's root and derives the heading itself.
HDN void observe_body(const ObsIn& in, long long e, int b, int J, int local_root_obs, int root_height_obs,
                      RowsOut y, int task_col) {
  auto at = [&](int k) { return in.p[k] + e * in.stride[k]; };
  const V3 root_pos = v3_at(at(0));
  const Q4 root_rot = q4_at(at(1));
  const float h = heading(root_rot);
  const Q4 hinv = zrot(-h), hq = zrot(h);
  const V3 pos = v3_at(at(0) + 3 * b), vel = v3_at(at(2) + 3 * b), ang = v3_at(at(3) + 3 * b);
  const Q4 rot = q4_at(at(1) + 4 * b);
  float tn[6];

  // ---- self obs v1 ---------------------------------------------------- //
  const int o_pos = root_height_obs ? 1 : 0, o_rot = o_pos + 3 * (J - 1), o_vel = o_rot + 6 * J,
            o_ang = o_vel + 3 * J;
  if (root_height_obs && b == 0) y(0, root_pos.z);
  if (b > 0) {
    const V3 lp = qrot(hinv, pos - root_pos);
    y(o_pos + 3 * (b - 1), lp.x); y(o_pos + 3 * (b - 1) + 1, lp.y); y(o_pos + 3 * (b - 1) + 2, lp.z);
  }
  tan_norm((b == 0 && !local_root_obs) ? root_rot : qmul(hinv, rot), tn);
  for (int k = 0; k < 6; ++k) y(o_rot + 6 * b + k, tn[k]);
  const V3 lv = qrot(hinv, vel), la = qrot(hinv, ang);
  y(o_vel + 3 * b, lv.x); y(o_vel + 3 * b + 1, lv.y); y(o_vel + 3 * b + 2, lv.z);
  y(o_ang + 3 * b, la.x); y(o_ang + 3 * b + 1, la.y); y(o_ang + 3 * b + 2, la.z);

  // ---- task obs v6 ---------------------------------------------------- //
  const V3 rpos = v3_at(at(4) + 3 * b), rvel = v3_at(at(6) + 3 * b), rang = v3_at(at(7) + 3 * b);
  const Q4 rrot = q4_at(at(5) + 4 * b);
  const V3 dp = qrot(hinv, rpos - pos);
  const V3 dv = qrot(hinv, rvel - vel);
  const V3 da = qrot(hinv, rang - ang);
  const V3 lrp = qrot(hinv, rpos - root_pos);
  const int t0 = task_col;
  const int c0 = t0 + 3 * b, c2 = t0 + 9 * J + 3 * b, c3 = t0 + 12 * J + 3 * b, c4 = t0 + 15 * J + 3 * b;
  y(c0, dp.x); y(c0 + 1, dp.y); y(c0 + 2, dp.z);
  y(c2, dv.x); y(c2 + 1, dv.y); y(c2 + 2, dv.z);
  y(c3, da.x); y(c3 + 1, da.y); y(c3 + 2, da.z);
  y(c4, lrp.x); y(c4 + 1, lrp.y); y(c4 + 2, lrp.z);
  tan_norm(qmul(qmul(hinv, qmul(rrot, qconj(rot))), hq), tn);
  for (int k = 0; k < 6; ++k) y(t0 + 3 * J + 6 * b + k, tn[k]);
  tan_norm(qmul(hinv, rrot), tn);
  for (int k = 0; k < 6; ++k) y(t0 + 18 * J + 6 * b + k, tn[k]);
}

}  // namespace hm
