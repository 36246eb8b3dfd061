// K1: the whole pre-merge env step of the imitation env in one launch, one
// thread per env: steps_per_control physics substeps and the final FK
// (physics_step.cuh), then the imitation reward with its four raw terms, the
// mean/max termination distance over the reset bodies, and the AMP
// discriminator row of the stepped state.
//
// Replaces the TPU kernel pulse_tpu/env/pallas_obs.py:pallas_step_reward_amp
// (physics body substep_pallas._build_kernel, epilogue _reward_amp_tiles).
// Plain version: pulse_tpu_torch/env/cuda_obs.py:step_reward_amp_plain.
//
// Bound on the H100: by operations, not bytes. An env reads 555 floats and
// writes 797 (~5.4 KB), but runs 4 substeps of the articulated-body
// algorithm over 24 bodies, tens of thousands of float operations. The
// design keeps it simple: one thread per env, the model in constant memory,
// inputs and outputs in [rows, B] layout so neighbouring threads touch
// neighbouring addresses, the per-env scratch in local memory. At 3072 envs
// that is only 96 warps for 132 SMs: the card is under-filled, and spreading
// one env over a warp's lanes is later work.
#include <cuda_runtime.h>
#include <stddef.h>

#include "physics_step.cuh"

using namespace hm;

#define MAX_KEY 8

// 4-byte fields only: no padding. Packed by env/cuda_obs.py in this order.
struct EnvConsts {
  int num_key, num_reset, local_root_obs, root_height_obs;
  int amp_v, pad0, pad1, pad2;
  int key_ids[MAX_KEY];
  int reset_ids[MAX_J];
  float k_pos, k_rot, k_vel, k_ang_vel;
  float w_pos, w_rot, w_vel, w_ang_vel;
};

static __constant__ EnvConsts c_env;

__global__ void __launch_bounds__(64) step_reward_amp_kernel(const float* __restrict__ in,
                                                             float* __restrict__ out, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const int J = c_model.J, Jm1 = J - 1;
  const float* x = in + e;
  float* y = out + e;
  auto rd = [&](int r) { return x[(size_t)r * B]; };
  auto wr = [&](int r, float v) { y[(size_t)r * B] = v; };

  // ---- input rows: state | pd target | reference bodies ------------------ //
  const int r_jrot = 7, r_v6 = 7 + 4 * Jm1, r_om = r_v6 + 6, n_state = r_om + 3 * Jm1;
  const int r_pd = n_state, r_ref = n_state + 3 * Jm1;
  PhysState s;
  s.root_pos = V3{rd(0), rd(1), rd(2)};
  s.root_rot = Q4{rd(3), rd(4), rd(5), rd(6)};
  s.v6 = S6{V3{rd(r_v6), rd(r_v6 + 1), rd(r_v6 + 2)}, V3{rd(r_v6 + 3), rd(r_v6 + 4), rd(r_v6 + 5)}};
  V3 pd[MAX_J - 1];
  for (int j = 0; j < Jm1; ++j) {
    const int q0 = r_jrot + 4 * j, o0 = r_om + 3 * j, p0 = r_pd + 3 * j;
    s.jrot[j] = Q4{rd(q0), rd(q0 + 1), rd(q0 + 2), rd(q0 + 3)};
    s.omega[j] = V3{rd(o0), rd(o0 + 1), rd(o0 + 2)};
    pd[j] = V3{rd(p0), rd(p0 + 1), rd(p0 + 2)};
  }

  V3 contact[MAX_J];
  WorldBodies wb;
  control_step(s, pd, contact, wb);

  // ---- physics output rows: state | contact 3J | bodies 13J ------------- //
  wr(0, s.root_pos.x); wr(1, s.root_pos.y); wr(2, s.root_pos.z);
  wr(3, s.root_rot.x); wr(4, s.root_rot.y); wr(5, s.root_rot.z); wr(6, s.root_rot.w);
  wr(r_v6, s.v6.w.x); wr(r_v6 + 1, s.v6.w.y); wr(r_v6 + 2, s.v6.w.z);
  wr(r_v6 + 3, s.v6.v.x); wr(r_v6 + 4, s.v6.v.y); wr(r_v6 + 5, s.v6.v.z);
  for (int j = 0; j < Jm1; ++j) {
    const int q0 = r_jrot + 4 * j, o0 = r_om + 3 * j;
    wr(q0, s.jrot[j].x); wr(q0 + 1, s.jrot[j].y); wr(q0 + 2, s.jrot[j].z); wr(q0 + 3, s.jrot[j].w);
    wr(o0, s.omega[j].x); wr(o0 + 1, s.omega[j].y); wr(o0 + 2, s.omega[j].z);
  }
  const int r_contact = n_state, r_body = n_state + 3 * J, r_ra = r_body + 13 * J;
  for (int b = 0; b < J; ++b) {
    const int c0 = r_contact + 3 * b, b0 = r_body + 13 * b;
    wr(c0, contact[b].x); wr(c0 + 1, contact[b].y); wr(c0 + 2, contact[b].z);
    wr(b0, wb.pos[b].x); wr(b0 + 1, wb.pos[b].y); wr(b0 + 2, wb.pos[b].z);
    wr(b0 + 3, wb.rot[b].x); wr(b0 + 4, wb.rot[b].y); wr(b0 + 5, wb.rot[b].z); wr(b0 + 6, wb.rot[b].w);
    wr(b0 + 7, wb.vel[b].x); wr(b0 + 8, wb.vel[b].y); wr(b0 + 9, wb.vel[b].z);
    wr(b0 + 10, wb.ang[b].x); wr(b0 + 11, wb.ang[b].y); wr(b0 + 12, wb.ang[b].z);
  }

  // ---- imitation reward (env/kernels.py compute_imitation_reward) -------- //
  const int rp = r_ref, rr = r_ref + 3 * J, rv = r_ref + 7 * J, ra = r_ref + 10 * J;
  auto ref3 = [&](int base, int b) { return V3{rd(base + 3 * b), rd(base + 3 * b + 1), rd(base + 3 * b + 2)}; };
  float pos_sq = 0.0f, rot_sq = 0.0f, vel_sq = 0.0f, ang_sq = 0.0f;
  for (int b = 0; b < J; ++b) {
    pos_sq += sq3(ref3(rp, b) - wb.pos[b]);
    vel_sq += sq3(ref3(rv, b) - wb.vel[b]);
    ang_sq += sq3(ref3(ra, b) - wb.ang[b]);
    const Q4 rrot = Q4{rd(rr + 4 * b), rd(rr + 4 * b + 1), rd(rr + 4 * b + 2), rd(rr + 4 * b + 3)};
    const float a = quat_angle(qmul(rrot, qconj(wb.rot[b])));
    rot_sq += a * a;
  }
  const float r_pos = expf(-c_env.k_pos * (pos_sq / (3.0f * J)));
  const float r_rot = expf(-c_env.k_rot * (rot_sq / (float)J));
  const float r_vel = expf(-c_env.k_vel * (vel_sq / (3.0f * J)));
  const float r_ang = expf(-c_env.k_ang_vel * (ang_sq / (3.0f * J)));
  wr(r_ra, c_env.w_pos * r_pos + c_env.w_rot * r_rot + c_env.w_vel * r_vel + c_env.w_ang_vel * r_ang);
  wr(r_ra + 1, r_pos); wr(r_ra + 2, r_rot); wr(r_ra + 3, r_vel); wr(r_ra + 4, r_ang);

  // ---- termination distances over the reset bodies ------------------------ //
  float dsum = 0.0f, dmax = 0.0f;
  for (int i = 0; i < c_env.num_reset; ++i) {
    const int b = c_env.reset_ids[i];
    const float d = sqrtf(sq3(wb.pos[b] - ref3(rp, b)));
    dsum += d;
    dmax = fmaxf(dmax, d);
  }
  wr(r_ra + 5, dsum / (float)c_env.num_reset);
  wr(r_ra + 6, dmax);

  // ---- AMP row (build_amp_observations_smpl / _v2) ------------------------ //
  int o = r_ra + 7;
  float tn[6];
  const V3 root_pos = wb.pos[0];
  const Q4 root_rot = wb.rot[0];
  const Q4 hinv = zrot(-heading(root_rot));
  if (c_env.root_height_obs) wr(o++, root_pos.z);
  tan_norm(c_env.local_root_obs ? qmul(hinv, root_rot) : root_rot, tn);
  for (int k = 0; k < 6; ++k) wr(o++, tn[k]);
  const V3 lv = qrot(hinv, wb.vel[0]), la = qrot(hinv, wb.ang[0]);
  wr(o++, lv.x); wr(o++, lv.y); wr(o++, lv.z);
  wr(o++, la.x); wr(o++, la.y); wr(o++, la.z);
  for (int j = 0; j < Jm1; ++j) {  // dof_to_obs_smpl of the exp-map dof
    tan_norm(expmap_to_quat(quat_to_expmap(s.jrot[j])), tn);
    for (int k = 0; k < 6; ++k) wr(o++, tn[k]);
  }
  for (int j = 0; j < Jm1; ++j) {
    wr(o++, s.omega[j].x); wr(o++, s.omega[j].y); wr(o++, s.omega[j].z);
  }
  for (int i = 0; i < c_env.num_key; ++i) {
    const V3 kp = qrot(hinv, wb.pos[c_env.key_ids[i]] - root_pos);
    wr(o++, kp.x); wr(o++, kp.y); wr(o++, kp.z);
  }
  if (c_env.amp_v == 2) {
    for (int i = 0; i < c_env.num_key; ++i) {
      const V3 kv = qrot(hinv, wb.vel[c_env.key_ids[i]]);
      wr(o++, kv.x); wr(o++, kv.y); wr(o++, kv.z);
    }
  }
}

extern "C" {

size_t k1_model_consts_bytes() { return sizeof(ModelConsts); }
size_t k1_env_consts_bytes() { return sizeof(EnvConsts); }

// Upload the model and env constant tables (once per model) on `stream`.
int k1_set_consts(const void* model, size_t model_bytes, const void* env, size_t env_bytes,
                  void* stream) {
  if (model_bytes != sizeof(ModelConsts) || env_bytes != sizeof(EnvConsts)) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemcpyToSymbolAsync(c_model, model, model_bytes, 0, cudaMemcpyHostToDevice, st);
  cudaMemcpyToSymbolAsync(c_env, env, env_bytes, 0, cudaMemcpyHostToDevice, st);
  return (int)cudaGetLastError();
}

// in: [555, B] f32, out: [797, B] f32 at the SMPL humanoid's J = 24.
int k1_step_reward_amp(const float* in, float* out, int B, int block, void* stream) {
  step_reward_amp_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(in, out, B);
  return (int)cudaGetLastError();
}

const char* k_error_string(int code) {
  return code < 0 ? "constant table size mismatch" : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
