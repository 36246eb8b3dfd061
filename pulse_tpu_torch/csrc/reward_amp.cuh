// The imitation env's reward/AMP epilogue for ONE env on an already-stepped
// state: the 4-term imitation reward and its raw terms, the mean/max
// termination distance over the reset bodies, and the AMP discriminator row.
// K1 (step_reward_amp.cu) runs it after the physics on its group's lanes, RA
// (reward_amp.cu) on a state K3 stepped, one warp an env.
//
// Mirrors pulse_tpu_torch/env/cuda_obs.py:reward_amp_plain formula for
// formula. __host__ __device__ and free of __constant__ memory (the caller
// passes its EnvConsts), so g++ builds it for the host and the CPU tests hold
// it against the plain version.
//
// The epilogue is three phases:
//   (a) body_terms: body b's four squared errors against the reference and
//       its distance to it;
//   (b) reward_amp_dof: the AMP row's dof entries (tan-norm of the exp-map
//       joint rotation, joint angular velocity) of joints j = lane, lane +
//       lanes, ...;
//   (c) reward_amp_finish, on one lane: the sums of (a)'s terms in body
//       order 0..J-1, the reward and its raws, the distances over the reset
//       bodies, and the AMP row's root and key-body entries.
// K1 runs (b) over its group and (c) on lane 0 with (a) inline; RA runs (a)
// one lane a body into shared memory, (b) over its warp, then (c) on lane 0.
// Each term and each sum is rounded on its own (mul_rn, add_rn), so a term
// stored and then added gives the bits of one added at once: K3 -> RA equals
// K1 bit for bit.
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

// Rows of the epilogue's output record (K1): reward | 4 raws | dist mean |
// dist max | AMP row.
constexpr int kRaRows = 7;

// Where the epilogue writes one env's outputs.
struct EpiOut {
  RowsOut reward, raw, dist_mean, dist_max, amp;
};
// K1's record: the outputs as consecutive rows of y.
HD EpiOut epi_rows(RowsOut y) {
  const long long s = y.stride;
  return EpiOut{y, RowsOut{y.p + s, s}, RowsOut{y.p + 5 * s, s}, RowsOut{y.p + 6 * s, s},
                RowsOut{y.p + kRaRows * s, s}};
}

struct BodyTerms {
  float pos_sq, rot_sq, vel_sq, ang_sq, dist;
};

// (a) Body b's terms against the reference bodies `ref` (pos 3J | rot 4J |
// vel 3J | ang 3J, body-minor): compute_imitation_reward's squared errors
// and the termination distance.
HD BodyTerms body_terms(int J, int b, V3 pos, Q4 rot, V3 vel, V3 ang, RowsIn ref) {
  const int rr = 3 * J, rv = 7 * J, ra = 10 * J;
  const V3 rpos = V3{ref(3 * b), ref(3 * b + 1), ref(3 * b + 2)};
  const Q4 rrot = Q4{ref(rr + 4 * b), ref(rr + 4 * b + 1), ref(rr + 4 * b + 2), ref(rr + 4 * b + 3)};
  const V3 rvel = V3{ref(rv + 3 * b), ref(rv + 3 * b + 1), ref(rv + 3 * b + 2)};
  const V3 rang = V3{ref(ra + 3 * b), ref(ra + 3 * b + 1), ref(ra + 3 * b + 2)};
  const float a = quat_angle(qmul(rrot, qconj(rot)));
  const float pos_sq = sq3_rn(rpos - pos);
  return BodyTerms{pos_sq, mul_rn(a, a), sq3_rn(rvel - vel), sq3_rn(rang - ang), sqrtf(pos_sq)};
}

// (b) The AMP row's dof tan-norms (dof_to_obs_smpl of the exp-map dof) and
// dof velocities of joints j = lane, lane + lanes, ...
HD void reward_amp_dof(const EnvConsts& c, const Q4* jrot, const V3* omega, RowsOut amp, int lane, int lanes) {
  const int Jm1 = c.J - 1;
  const int o_dof = (c.root_height_obs ? 1 : 0) + 12, o_vel = o_dof + 6 * Jm1;
  float tn[6];
  for (int j = lane; j < Jm1; j += lanes) {
    tan_norm(expmap_to_quat(quat_to_expmap(jrot[j])), tn);
    for (int k = 0; k < 6; ++k) amp(o_dof + 6 * j + k, tn[k]);
    amp(o_vel + 3 * j, omega[j].x); amp(o_vel + 3 * j + 1, omega[j].y); amp(o_vel + 3 * j + 2, omega[j].z);
  }
}

// (c) The rest, on one lane. terms(b) gives body b's BodyTerms; the stepped
// world bodies pos/rot/vel/ang [J].
template <class Terms>
HD void reward_amp_finish(const EnvConsts& c, Terms terms, const V3* pos, const Q4* rot, const V3* vel,
                          const V3* ang, const EpiOut& out) {
  const int J = c.J, Jm1 = J - 1;
  // ---- imitation reward (env/kernels.py compute_imitation_reward) -------- //
  float pos_sq = 0.0f, rot_sq = 0.0f, vel_sq = 0.0f, ang_sq = 0.0f;
  for (int b = 0; b < J; ++b) {
    const BodyTerms t = terms(b);
    pos_sq = add_rn(pos_sq, t.pos_sq);
    rot_sq = add_rn(rot_sq, t.rot_sq);
    vel_sq = add_rn(vel_sq, t.vel_sq);
    ang_sq = add_rn(ang_sq, t.ang_sq);
  }
  const float r_pos = expf(-c.k_pos * (pos_sq / (3.0f * J)));
  const float r_rot = expf(-c.k_rot * (rot_sq / (float)J));
  const float r_vel = expf(-c.k_vel * (vel_sq / (3.0f * J)));
  const float r_ang = expf(-c.k_ang_vel * (ang_sq / (3.0f * J)));
  out.reward(0, c.w_pos * r_pos + c.w_rot * r_rot + c.w_vel * r_vel + c.w_ang_vel * r_ang);
  out.raw(0, r_pos); out.raw(1, r_rot); out.raw(2, r_vel); out.raw(3, r_ang);

  // ---- termination distances over the reset bodies ------------------------ //
  float dsum = 0.0f, dmax = 0.0f;
  for (int i = 0; i < c.num_reset; ++i) {
    const float d = terms(c.reset_ids[i]).dist;
    dsum = add_rn(dsum, d);
    dmax = fmaxf(dmax, d);
  }
  out.dist_mean(0, dsum / (float)c.num_reset);
  out.dist_max(0, dmax);

  // ---- AMP row (build_amp_observations_smpl / _v2) ------------------------ //
  // [root height] | root tan-norm 6 | root vel 3 | root ang 3 | dof
  // tan-norms 6(J-1) and dof velocities 3(J-1) (phase b) | key positions |
  // [key vels]
  const RowsOut amp = out.amp;
  int o = 0;
  const V3 root_pos = pos[0];
  const Q4 root_rot = rot[0];
  const Q4 hinv = zrot(-heading(root_rot));
  float tn[6];
  if (c.root_height_obs) amp(o++, root_pos.z);
  tan_norm(c.local_root_obs ? qmul(hinv, root_rot) : root_rot, tn);
  for (int k = 0; k < 6; ++k) amp(o++, tn[k]);
  const V3 lv = qrot(hinv, vel[0]), la = qrot(hinv, ang[0]);
  amp(o++, lv.x); amp(o++, lv.y); amp(o++, lv.z);
  amp(o++, la.x); amp(o++, la.y); amp(o++, la.z);
  o += 9 * Jm1;
  for (int i = 0; i < c.num_key; ++i) {
    const V3 kp = qrot(hinv, pos[c.key_ids[i]] - root_pos);
    amp(o++, kp.x); amp(o++, kp.y); amp(o++, kp.z);
  }
  if (c.amp_v == 2) {
    for (int i = 0; i < c.num_key; ++i) {
      const V3 kv = qrot(hinv, vel[c.key_ids[i]]);
      amp(o++, kv.x); amp(o++, kv.y); amp(o++, kv.z);
    }
  }
}

// K1's epilogue: stepped world bodies pos/rot/vel/ang [J] and joint
// rotations / angular velocities [J-1]; `ref` the reference bodies. Writes
// the output record through `out` (epi_rows). Lane `lane` of `lanes` writes
// phase (b)'s joints j = lane, lane + lanes, ...; lane 0 runs phase (c) with
// the body terms computed as it sums them.
HD void reward_amp(const EnvConsts& c, const V3* pos, const Q4* rot, const V3* vel, const V3* ang,
                   const Q4* jrot, const V3* omega, RowsIn ref, RowsOut out, int lane = 0, int lanes = 1) {
  const EpiOut o = epi_rows(out);
  reward_amp_dof(c, jrot, omega, o.amp, lane, lanes);
  if (lane == 0)
    reward_amp_finish(c, [&](int b) { return body_terms(c.J, b, pos[b], rot[b], vel[b], ang[b], ref); },
                      pos, rot, vel, ang, o);
}

// ---- RA: one env a warp, its record staged in shared memory --------------- //

// RA's inputs, ten [B, ...] tensors read in place: env e's block of input k
// is contiguous at p[k] + e * stride[k] (a view into wider rows, such as
// K3's joint_rot, has a stride larger than its block). In order: the stepped
// bodies' pos, rot, vel, ang [J, *], the joint rotations [J-1, 4] and angular
// velocities [J-1, 3], the reference bodies' pos, rot, vel, ang [J, *].
constexpr int kRaInputs = 10;
struct RaIn {
  const float* p[kRaInputs];
  long long stride[kRaInputs];
};

// RA's outputs: reward [B], raw [B, 4], dist mean [B], dist max [B] and the
// AMP row [B, >= A], env e's at p[k] + e * stride[k].
struct RaOut {
  float* p[5];
  long long stride[5];
  HD EpiOut env(long long e) const {
    return EpiOut{RowsOut{p[0] + e * stride[0], 1}, RowsOut{p[1] + e * stride[1], 1},
                  RowsOut{p[2] + e * stride[2], 1}, RowsOut{p[3] + e * stride[3], 1},
                  RowsOut{p[4] + e * stride[4], 1}};
  }
};

// One env's record in shared memory: 785 floats of inputs at J = 24 and
// phase (a)'s terms, 3,620 bytes.
struct RaEnv {
  V3 pos[MAX_J];
  Q4 rot[MAX_J];
  V3 vel[MAX_J], ang[MAX_J];
  Q4 jrot[MAX_J - 1];
  V3 omega[MAX_J - 1];
  float ref[13 * MAX_J];   // pos 3J | rot 4J | vel 3J | ang 3J
  BodyTerms terms[MAX_J];
};

// The lanes copy env e's ten input blocks into s, lane l taking floats l,
// l + G, ... of each: a warp's loads of one block are consecutive
// addresses, and every lane issues all its loads before its first store,
// so the warp keeps them all in flight (~25 a lane at G = 32).
template <int G>
HDN void ra_stage(int J, const RaIn& in, long long e, RaEnv& s, int lane) {
  constexpr int kIt = (4 * MAX_J + G - 1) / G;   // a lane's loads of the widest block
  const int Jm1 = J - 1;
  const int n[kRaInputs] = {3 * J, 4 * J, 3 * J, 3 * J, 4 * Jm1, 3 * Jm1, 3 * J, 4 * J, 3 * J, 3 * J};
  float* const dst[kRaInputs] = {&s.pos[0].x, &s.rot[0].x, &s.vel[0].x, &s.ang[0].x, &s.jrot[0].x,
                                 &s.omega[0].x, s.ref, s.ref + 3 * J, s.ref + 7 * J, s.ref + 10 * J};
  float v[kRaInputs][kIt];
#pragma unroll
  for (int k = 0; k < kRaInputs; ++k) {
    const float* src = in.p[k] + e * in.stride[k];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = lane + G * it;
      v[k][it] = i < n[k] ? src[i] : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < kRaInputs; ++k) {
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = lane + G * it;
      if (i < n[k]) dst[k][i] = v[k][it];
    }
  }
}

// RA for env e on a group of G lanes: stage, then phases (a) and (b) over
// the lanes, then (c) on lane 0.
template <int G>
HDN void reward_amp_env(const Lanes<G>& run, const EnvConsts& c, const RaIn& in, const RaOut& out, long long e,
                        RaEnv& s) {
  const int J = c.J;
  const EpiOut o = out.env(e);
  run([&](int lane) { ra_stage<G>(J, in, e, s, lane); });
  run([&](int lane) {
    for (int b = lane; b < J; b += G)
      s.terms[b] = body_terms(J, b, s.pos[b], s.rot[b], s.vel[b], s.ang[b], RowsIn{s.ref, 1});
    reward_amp_dof(c, s.jrot, s.omega, o.amp, lane, G);
  });
  run([&](int lane) {
    if (lane == 0) reward_amp_finish(c, [&](int b) { return s.terms[b]; }, s.pos, s.rot, s.vel, s.ang, o);
  });
}

}  // namespace hm
