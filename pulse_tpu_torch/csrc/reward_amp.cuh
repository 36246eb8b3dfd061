// The imitation env's reward/AMP epilogue for ONE env on an already-stepped
// state: the 4-term imitation reward and its raw terms, the mean/max
// termination distance over the reset bodies, and the AMP discriminator row.
// K1 (step_reward_amp.cu) runs it after the physics, RA (reward_amp.cu) on a
// state K3 stepped.
//
// Mirrors pulse_tpu_torch/env/cuda_obs.py:reward_amp_plain formula for
// formula. __host__ __device__ and free of __constant__ memory (the caller
// passes its EnvConsts), so g++ builds it for the host and the CPU tests hold
// it against the plain version.
#pragma once

#include "humanoid_math.cuh"

#define MAX_KEY 8

namespace hm {

// 4-byte fields only: no padding. Packed by env/cuda_obs.py in this order.
struct EnvConsts {
  int num_key, num_reset, local_root_obs, root_height_obs;
  int amp_v, J, pad1, pad2;
  int key_ids[MAX_KEY];
  int reset_ids[MAX_J];
  float k_pos, k_rot, k_vel, k_ang_vel;
  float w_pos, w_rot, w_vel, w_ang_vel;
};

// Rows of the epilogue's output: reward | 4 raws | dist mean | dist max |
// AMP row.
constexpr int kRaRows = 7;

// Stepped world bodies pos/rot/vel/ang [J] and joint rotations / angular
// velocities [J-1]; `ref` holds the reference bodies (pos 3J | rot 4J | vel
// 3J | ang 3J, body-minor). Writes the output rows through `out`. Lane
// `lane` of `lanes` (K1's group; RA runs one lane) writes the AMP row's dof
// tan-norms of its joints j = lane, lane + lanes, ...; lane 0 writes all
// other rows. Every row is computed the same way whatever the split.
HD void reward_amp(const EnvConsts& c, const V3* pos, const Q4* rot, const V3* vel, const V3* ang,
                   const Q4* jrot, const V3* omega, RowsIn ref, RowsOut out, int lane = 0, int lanes = 1) {
  const int J = c.J, Jm1 = J - 1;
  const int rp = 0, rr = 3 * J, rv = 7 * J, ra = 10 * J;
  // AMP row: [root height] | root tan-norm 6 | root vel 3 | root ang 3 | dof
  // tan-norms 6(J-1) | dof velocities 3(J-1) | key positions | [key vels]
  const int o_dof = kRaRows + (c.root_height_obs ? 1 : 0) + 12;
  float tn[6];
  for (int j = lane; j < Jm1; j += lanes) {  // dof_to_obs_smpl of the exp-map dof
    tan_norm(expmap_to_quat(quat_to_expmap(jrot[j])), tn);
    for (int k = 0; k < 6; ++k) out(o_dof + 6 * j + k, tn[k]);
  }
  if (lane != 0) return;

  // ---- imitation reward (env/kernels.py compute_imitation_reward) -------- //
  float pos_sq = 0.0f, rot_sq = 0.0f, vel_sq = 0.0f, ang_sq = 0.0f;
  for (int b = 0; b < J; ++b) {
    const V3 rpos = V3{ref(rp + 3 * b), ref(rp + 3 * b + 1), ref(rp + 3 * b + 2)};
    const V3 rvel = V3{ref(rv + 3 * b), ref(rv + 3 * b + 1), ref(rv + 3 * b + 2)};
    const V3 rang = V3{ref(ra + 3 * b), ref(ra + 3 * b + 1), ref(ra + 3 * b + 2)};
    pos_sq += sq3(rpos - pos[b]);
    vel_sq += sq3(rvel - vel[b]);
    ang_sq += sq3(rang - ang[b]);
    const Q4 rrot = Q4{ref(rr + 4 * b), ref(rr + 4 * b + 1), ref(rr + 4 * b + 2), ref(rr + 4 * b + 3)};
    const float a = quat_angle(qmul(rrot, qconj(rot[b])));
    rot_sq += a * a;
  }
  const float r_pos = expf(-c.k_pos * (pos_sq / (3.0f * J)));
  const float r_rot = expf(-c.k_rot * (rot_sq / (float)J));
  const float r_vel = expf(-c.k_vel * (vel_sq / (3.0f * J)));
  const float r_ang = expf(-c.k_ang_vel * (ang_sq / (3.0f * J)));
  out(0, c.w_pos * r_pos + c.w_rot * r_rot + c.w_vel * r_vel + c.w_ang_vel * r_ang);
  out(1, r_pos); out(2, r_rot); out(3, r_vel); out(4, r_ang);

  // ---- termination distances over the reset bodies ------------------------ //
  float dsum = 0.0f, dmax = 0.0f;
  for (int i = 0; i < c.num_reset; ++i) {
    const int b = c.reset_ids[i];
    const V3 rpos = V3{ref(rp + 3 * b), ref(rp + 3 * b + 1), ref(rp + 3 * b + 2)};
    const float d = sqrtf(sq3(pos[b] - rpos));
    dsum += d;
    dmax = fmaxf(dmax, d);
  }
  out(5, dsum / (float)c.num_reset);
  out(6, dmax);

  // ---- AMP row (build_amp_observations_smpl / _v2) ------------------------ //
  int o = kRaRows;
  const V3 root_pos = pos[0];
  const Q4 root_rot = rot[0];
  const Q4 hinv = zrot(-heading(root_rot));
  if (c.root_height_obs) out(o++, root_pos.z);
  tan_norm(c.local_root_obs ? qmul(hinv, root_rot) : root_rot, tn);
  for (int k = 0; k < 6; ++k) out(o++, tn[k]);
  const V3 lv = qrot(hinv, vel[0]), la = qrot(hinv, ang[0]);
  out(o++, lv.x); out(o++, lv.y); out(o++, lv.z);
  out(o++, la.x); out(o++, la.y); out(o++, la.z);
  o = o_dof + 6 * Jm1;
  for (int j = 0; j < Jm1; ++j) {
    out(o++, omega[j].x); out(o++, omega[j].y); out(o++, omega[j].z);
  }
  for (int i = 0; i < c.num_key; ++i) {
    const V3 kp = qrot(hinv, pos[c.key_ids[i]] - root_pos);
    out(o++, kp.x); out(o++, kp.y); out(o++, kp.z);
  }
  if (c.amp_v == 2) {
    for (int i = 0; i < c.num_key; ++i) {
      const V3 kv = qrot(hinv, vel[c.key_ids[i]]);
      out(o++, kv.x); out(o++, kv.y); out(o++, kv.z);
    }
  }
}

}  // namespace hm
