// One control step of the humanoid physics for ONE env, run by a group of G
// lanes: steps_per_control substeps (FK with pass-1 velocities, plane
// contacts, stable-PD torques with limit springs, bias forces, ABA passes 2
// and 3, semi-implicit integration) and the final world-frame FK.
//
// Mirrors the plain version pulse_tpu_torch/physics/substep_fused.py and
// physics/step.py formula for formula; the articulated-inertia update uses
// the 3x3-block form of the TPU kernel (pulse_tpu/physics/substep_pallas.py
// _substep_tiles). Sibling contributions are added to the parent one at a
// time in reverse level order, where the plain version sums them per level
// first: that reorders float adds only.
//
// What bounds it, and the design. A control step is ~223k float operations
// an env on a few KB of state, so the kernels are bound by operations, and
// in practice by the latency of long chains of dependent ones. One thread
// per env (the TPU kernel's one env per vector lane) left 3072 envs as 96
// warps on 132 SMs, one warp an SM, with a 12 KB working set in local
// memory. Here a group of G lanes (G a template parameter; every group lies
// in one warp) steps one env, and the env's working set (Work, 8.3 KB) lives
// in the block's shared memory. The step is a fixed sequence of phases; in
// each, the lanes split the phase's bodies, joints or contact points, and
// the group's barrier (__syncwarp over its lanes) ends it:
//   * FK with pass-1 velocities, level by level, root first;
//   * contacts: one lane per point writes its force and moment to the
//     point's own slot; then one lane per body adds its points' slots in
//     increasing point index (beside it, the PD torques over the joints);
//   * bias forces and inertia load, over the bodies;
//   * ABA pass 2, leaves to root, level by level: a body first adds its
//     children's contributions from their own slots, in reverse level
//     order, then writes its own to its slots (no atomics);
//   * the root solve and root integration on one lane;
//   * ABA pass 3 and joint integration, level by level;
//   * after the last substep the final FK, level by level.
// Every sum runs in the same order for every G, so the result does not
// depend on G: bit for bit on the host, to rounding on the card. The
// topology a phase walks (level starts, children, each body's contact
// points) comes from the ModelConsts table.
//
// The code is templated on a model view, through which it reads every
// model value:
//   * TableView: the whole model from one ModelConsts table. K1 and K3 pass
//     their __constant__ c_model.
//   * RowsView (K3-rows): the topology and config scalars from the table,
//     every per-env value (the fields of physics/substep_cuda.py
//     model_rows_layout) from the env's record of model rows. The per-body
//     fields every substep reads (lt, mass, com, Isym: the first kHotRows
//     rows) are staged in shared memory by the group; the rest is read from
//     global memory where it is used. Each body's spatial inertia is rebuilt
//     from its A block, mass and com (B = m [c]x, C = m 1), as the TPU
//     kernel's _model_tiles does.
// Everything here is __host__ __device__: on the host, g++ builds it for
// the tests, and Lanes runs each phase for all G lanes in turn.
#pragma once

#include "humanoid_math.cuh"

#define MAX_P 72    // ground contact points
#define MAX_J1 25   // MAX_J + 1: start offsets, the end included

namespace hm {

// Lanes per env of K1, K3 and K3-rows (physics/substep_cuda.py GROUP).
constexpr int kGroup = 8;
// The model rows K3-rows stages in shared memory: lt 3, mass 1, com 3,
// Isym 6 per body, rows [0, 13 J) of model_rows_layout.
constexpr int kHotRows = 13 * MAX_J;

// All fields are 4-byte scalars or arrays of them, so the layout has no
// padding; pulse_tpu_torch/physics/substep_cuda.py packs the same fields in
// the same order.
struct ModelConsts {
  int J, P, n_sub, n_lev;
  int order[MAX_J];       // bodies in level order, root first
  int parent[MAX_J];
  int lev_start[MAX_J1];  // level l: order[lev_start[l] .. lev_start[l + 1])
  int ch_start[MAX_J1];   // children of b: ch[ch_start[b] .. ch_start[b + 1]),
  int ch[MAX_J];          //   in the order pass 2 adds them (reverse level order)
  int cp_start[MAX_J1];   // contact points of b: cp_of[cp_start[b] ..
  int cp_of[MAX_P];       //   cp_start[b + 1]), in increasing index
  float lt[MAX_J][3];     // joint origin in the parent frame
  float mass[MAX_J];
  float com[MAX_J][3];
  float IA[MAX_J][9];     // spatial inertia about the body origin, blocks
  float IB[MAX_J][9];     //   [[A, B], [B^T, C]], row-major 3x3 each
  float IC[MAX_J][9];
  float kp[MAX_J];        // per joint j = body - 1
  float kd[MAX_J];
  float armature[MAX_J];
  float dof_lo[MAX_J][3];
  float dof_hi[MAX_J][3];
  int cp_body[MAX_P];
  float cp_off[MAX_P][3];
  float cp_radius[MAX_P];
  float cp_fric[MAX_P];
  float h, gravity, ks, kc, freg, fmax, wmax, vmax;
  float lstiff, ldamp, taumax, lim_dex;  // lim_dex = h (ldamp + h lstiff)
};

#if defined(__CUDACC__)
// Every translation unit that includes this header (K1, K3) has its own
// copy, uploaded by its own *_set_consts entry point.
static __constant__ ModelConsts c_model;
#endif

HD V3 cm_v3(const float (*a)[3], int i) { return V3{a[i][0], a[i][1], a[i][2]}; }
HD M3 cm_m3(const float (*a)[9], int i) {
  M3 r;
  for (int k = 0; k < 9; ++k) r.m[k / 3][k % 3] = a[i][k];
  return r;
}

// Both views reach the table twice: through `c` for what every lane of a
// group reads alike (counts, level starts, config scalars), and through `d`
// for what each lane reads at its own body, joint or point. On the card `c`
// is the unit's __constant__ c_model, whose cache serves one address a
// cycle, and `d` the same bytes through their global address, read via L1,
// which serves a warp's scattered addresses together. On the host both are
// the one table.

// The whole model from one table.
struct TableView {
  const ModelConsts* c;
  const ModelConsts* d;
  HD V3 lt(int b) const { return cm_v3(d->lt, b); }
  HD float mass(int b) const { return d->mass[b]; }
  HD V3 com(int b) const { return cm_v3(d->com, b); }
  HD void inertia(int b, M3& A, M3& B, M3& C) const {
    A = cm_m3(d->IA, b);
    B = cm_m3(d->IB, b);
    C = cm_m3(d->IC, b);
  }
  HD float kp(int j) const { return d->kp[j]; }
  HD float kd(int j) const { return d->kd[j]; }
  HD float armature(int j) const { return d->armature[j]; }
  HD float dof_lo(int j, int k) const { return d->dof_lo[j][k]; }
  HD float dof_hi(int j, int k) const { return d->dof_hi[j][k]; }
  HD V3 cp_off(int i) const { return cm_v3(d->cp_off, i); }
  HD float cp_radius(int i) const { return d->cp_radius[i]; }
  HD float cp_fric(int i) const { return d->cp_fric[i]; }
};

// Topology and config from the table, per-env values from the env's model
// rows, at the row offsets of model_rows_layout(J, P): rows [0, 13 J) from
// the staged copy `hot`, the rest from `m`.
struct RowsView {
  const ModelConsts* c;
  const ModelConsts* d;
  const float* hot;
  RowsIn m;
  int r_mass, r_com, r_isym, r_kp, r_kd, r_arm, r_lo, r_hi, r_cpo, r_cpr, r_cpf;
  HD RowsView(const ModelConsts* c_, const ModelConsts* d_, const float* hot_, RowsIn m_)
      : c(c_), d(d_), hot(hot_), m(m_) {
    const int J = c->J, Jm1 = J - 1, P = c->P;
    r_mass = 3 * J;            // lt occupies rows [0, 3J)
    r_com = r_mass + J;
    r_isym = r_com + 3 * J;
    r_kp = r_isym + 6 * J;     // = 13 J, the end of the hot rows
    r_kd = r_kp + Jm1;
    r_arm = r_kd + Jm1;
    r_lo = r_arm + Jm1;
    r_hi = r_lo + 3 * Jm1;
    r_cpo = r_hi + 3 * Jm1;
    r_cpr = r_cpo + 3 * P;
    r_cpf = r_cpr + P;
  }
  HD V3 hot3(int r) const { return V3{hot[r], hot[r + 1], hot[r + 2]}; }
  HD V3 lt(int b) const { return hot3(3 * b); }
  HD float mass(int b) const { return hot[r_mass + b]; }
  HD V3 com(int b) const { return hot3(r_com + 3 * b); }
  HD void inertia(int b, M3& A, M3& B, M3& C) const {
    const float* s = hot + r_isym + 6 * b;   // A's entries 00 01 02 11 12 22
    const float s0 = s[0], s1 = s[1], s2 = s[2], s3 = s[3], s4 = s[4], s5 = s[5];
    A.m[0][0] = s0; A.m[0][1] = s1; A.m[0][2] = s2;
    A.m[1][0] = s1; A.m[1][1] = s3; A.m[1][2] = s4;
    A.m[2][0] = s2; A.m[2][1] = s4; A.m[2][2] = s5;
    const float mb = mass(b);
    const M3 cx = skew(com(b));
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k) {
        B.m[i][k] = mb * cx.m[i][k];
        C.m[i][k] = i == k ? mb : 0.0f;
      }
  }
  HD float kp(int j) const { return m(r_kp + j); }
  HD float kd(int j) const { return m(r_kd + j); }
  HD float armature(int j) const { return m(r_arm + j); }
  HD float dof_lo(int j, int k) const { return m(r_lo + 3 * j + k); }
  HD float dof_hi(int j, int k) const { return m(r_hi + 3 * j + k); }
  HD V3 cp_off(int i) const { return V3{m(r_cpo + 3 * i), m(r_cpo + 3 * i + 1), m(r_cpo + 3 * i + 2)}; }
  HD float cp_radius(int i) const { return m(r_cpr + i); }
  HD float cp_fric(int i) const { return m(r_cpf + i); }
};

// ---- the env's working set ------------------------------------------------ //
// 2,084 floats (8,336 bytes) at MAX_J = 24, MAX_P = 72. Two unions alias
// what is dead: the FK bodies and their contact forces die with the bias
// phase, and their slots then hold the pass-2 contributions, then pass 3's
// accelerations; the contact points' slots die before the inertias are
// loaded, and the inertias after pass 3, before the final FK.

struct Kin {                 // FK .. bias forces
  Q4 rot[MAX_J];
  V3 pos[MAX_J];
  S6 v[MAX_J];               // spatial velocity, body frame
  S6 fext[MAX_J];            // contact wrench, world frame
};
struct Up {                  // pass 2: a body's articulated inertia in its
  M3 oA[MAX_J];              //   parent's frame (its C block in Inertia C)
  M3 oB[MAX_J];
};
struct Inertia {             // bias forces .. pass 3: after a body's pass-2
  M3 A[MAX_J];               //   step A, B are its U = [A; B^T] and C its
  M3 B[MAX_J];               //   contribution's C block
  M3 C[MAX_J];
};
struct Contacts {            // each point's force and moment about its body
  V3 f[MAX_P];
  V3 n[MAX_P];
};
struct WorldBodies {         // physics/state.py refresh_kinematics
  V3 pos[MAX_J];
  Q4 rot[MAX_J];
  V3 vel[MAX_J];
  V3 ang[MAX_J];
};

struct Work {
  // the generalized-coordinate state, carried through the control step
  V3 root_pos;
  Q4 root_rot;
  S6 v6;                     // root spatial velocity, root frame
  Q4 jrot[MAX_J - 1];        // parent-from-child joint rotations
  V3 omega[MAX_J - 1];       // joint angular velocity, child frame
  Q4 target[MAX_J - 1];      // PD target as quaternions
  V3 acc[MAX_J];             // net contact force, summed over the substeps
  // per substep
  S6 cbias[MAX_J];
  S6 pA[MAX_J];              // bias force; after pass 2, the body's on its parent
  V3 tau[MAX_J - 1];         // joint torque; after pass 2, u = tau - pA.w
  V3 dex[MAX_J - 1];         // implicit damping and limit terms of D
  M3 Dinv[MAX_J];
  union { Kin k; Up up; S6 a[MAX_J]; } x;
  union { Inertia I; Contacts cp; WorldBodies wb; } y;
};

// ---- the phases ----------------------------------------------------------- //

// FK and pass-1 velocities of level l's bodies, with their velocity-product
// terms.
template <int G, class Model>
HDN void fk_level(const Model& M, Work& w, int l, int lane) {
  const ModelConsts &c = *M.c, &d = *M.d;
  Kin& k = w.x.k;
  for (int i = c.lev_start[l] + lane; i < c.lev_start[l + 1]; i += G) {
    const int b = d.order[i];
    if (b == 0) {
      k.rot[0] = w.root_rot;
      k.pos[0] = w.root_pos;
      k.v[0] = w.v6;
      w.cbias[0] = s6_zero();
      continue;
    }
    const int p = d.parent[b];
    const Q4 q_pc = w.jrot[b - 1];
    const V3 lt = M.lt(b);
    const Q4 rot_p = k.rot[p];
    const S6 om = S6{w.omega[b - 1], V3{0, 0, 0}};
    k.rot[b] = qmul_norm(rot_p, q_pc);
    k.pos[b] = k.pos[p] + qrot(rot_p, lt);
    const S6 v = motion_to_child(q_pc, lt, k.v[p]) + om;
    k.v[b] = v;
    w.cbias[b] = cross_motion(v, om);
  }
}

// Plane contacts (physics/contact.py): each point's world force and its
// moment about the body origin, to the point's own slot.
template <int G, class Model>
HDN void contact_points(const Model& M, Work& w, int lane) {
  const ModelConsts &c = *M.c, &d = *M.d;
  const Kin& k = w.x.k;
  Contacts& cp = w.y.cp;
  for (int i = lane; i < c.P; i += G) {
    const int bi = d.cp_body[i];
    const Q4 rot = k.rot[bi];
    const V3 pos = k.pos[bi];
    const S6 v = k.v[bi];
    const V3 pw = pos + qrot(rot, M.cp_off(i));
    const V3 arm = pw - pos;
    const float depth = M.cp_radius(i) - pw.z;
    const V3 vp = qrot(rot, v.v) + cross(qrot(rot, v.w), arm);
    const float vn = vp.z;
    float fn = depth > 0.0f ? fmaxf(c.ks * depth - c.kc * vn, 0.0f) : 0.0f;
    fn = fminf(fn, c.fmax);
    const float vt_norm = sqrtf(vp.x * vp.x + vp.y * vp.y + 1e-12f);
    const float scale = fminf(vt_norm / c.freg, 1.0f);
    const float coef = -(M.cp_fric(i) * fn * scale / vt_norm);
    const V3 fw = V3{coef * vp.x, coef * vp.y, fn};
    cp.f[i] = fw;
    cp.n[i] = cross(arm, fw);
  }
}

// Each body's contact wrench and its substep's share of acc, from its
// points' slots in increasing index; the stable-PD torques and limit springs
// (physics/dynamics.py) of each joint.
template <int G, class Model>
HDN void gather_and_torques(const Model& M, Work& w, int lane) {
  const ModelConsts &c = *M.c, &d = *M.d;
  const Contacts& cp = w.y.cp;
  for (int b = lane; b < c.J; b += G) {
    S6 f = s6_zero();
    V3 acc = w.acc[b];
    for (int q = d.cp_start[b]; q < d.cp_start[b + 1]; ++q) {
      const int i = d.cp_of[q];
      const V3 fw = cp.f[i];
      f.w = f.w + cp.n[i];
      f.v = f.v + fw;
      acc = acc + fw;
    }
    w.x.k.fext[b] = f;
    w.acc[b] = acc;
  }
  const float h = c.h;
  for (int j = lane; j < c.J - 1; j += G) {
    const float kp = M.kp(j), kd = M.kd(j);
    const Q4 q = w.jrot[j];
    const V3 omj = w.omega[j];
    const V3 err = quat_to_expmap(qmul_norm(qconj(q), w.target[j]));
    const V3 t = err * kp - omj * (kp * h + kd);
    const V3 dof = quat_to_expmap(q);
    const float d[3] = {dof.x, dof.y, dof.z};
    const float tt[3] = {t.x, t.y, t.z};
    const float om[3] = {omj.x, omj.y, omj.z};
    float to[3], dx[3];
    for (int k = 0; k < 3; ++k) {
      const float excess = fmaxf(d[k] - M.dof_hi(j, k), 0.0f) +
                           fminf(d[k] - M.dof_lo(j, k), 0.0f);
      const bool active = excess != 0.0f;
      const float lim = -c.lstiff * excess - (active ? c.ldamp * om[k] : 0.0f);
      to[k] = fminf(fmaxf(tt[k] + lim, -c.taumax), c.taumax);
      dx[k] = h * kd + (active ? c.lim_dex : 0.0f);
    }
    w.tau[j] = V3{to[0], to[1], to[2]};
    w.dex[j] = V3{dx[0], dx[1], dx[2]};
  }
}

// Gravity and bias forces, and each body's own spatial inertia.
template <int G, class Model>
HDN void bias_forces(const Model& M, Work& w, int lane) {
  const ModelConsts& c = *M.c;
  const Kin& k = w.x.k;
  Inertia& I = w.y.I;
  for (int b = lane; b < c.J; b += G) {
    const Q4 rot = k.rot[b];
    const S6 v = k.v[b];
    const S6 fe = k.fext[b];
    const V3 fg = V3{0.0f, 0.0f, M.mass(b) * c.gravity};
    const V3 com_w = qrot(rot, M.com(b));
    const S6 f_body = S6{qrot_inv(rot, fe.w + cross(com_w, fg)), qrot_inv(rot, fe.v + fg)};
    M3 A, B, C;
    M.inertia(b, A, B, C);
    I.A[b] = A;
    I.B[b] = B;
    I.C[b] = C;
    w.pA[b] = cross_force(v, mul_inertia(A, B, C, v)) - f_body;
  }
}

// A body's articulated inertia and bias force: its own plus its children's
// contributions, in the order of the children list.
HD void articulated(const ModelConsts& d, const Work& w, int b, M3& A, M3& B, M3& C, S6& pA) {
  A = w.y.I.A[b];
  B = w.y.I.B[b];
  C = w.y.I.C[b];
  pA = w.pA[b];
  for (int q = d.ch_start[b]; q < d.ch_start[b + 1]; ++q) {
    const int ch = d.ch[q];
    A = m3_add(A, w.x.up.oA[ch]);
    B = m3_add(B, w.x.up.oB[ch]);
    C = m3_add(C, w.y.I.C[ch]);
    pA = pA + w.pA[ch];
  }
}

// ABA pass 2 (leaves -> root) for level l >= 1: each body gathers its
// children, then leaves its U (in its A, B), D^-1, u and its contributions to
// the parent in its own slots.
template <int G, class Model>
HDN void aba_pass2_level(const Model& M, Work& w, int l, int lane) {
  const ModelConsts &c = *M.c, &d = *M.d;
  for (int i = c.lev_start[l] + lane; i < c.lev_start[l + 1]; i += G) {
    const int b = d.order[i], j = b - 1;
    M3 A, B, C;
    S6 pAb;
    articulated(d, w, b, A, B, C, pAb);
    M3 D = A;
    const V3 dex = w.dex[j];
    D.m[0][0] += M.armature(j) + dex.x;
    D.m[1][1] += M.armature(j) + dex.y;
    D.m[2][2] += M.armature(j) + dex.z;
    const M3 Di = inv3(D);
    const V3 ub = w.tau[j] - pAb.w;
    // Ia = IA - U D^-1 U^T with U = [A; B^T]
    const M3 M1 = m3_mul(A, Di);
    const M3 IaA = m3_sub(A, m3_mul(M1, A));
    const M3 IaB = m3_sub(B, m3_mul(M1, B));
    const M3 IaC = m3_sub(C, m3_mul(m3_T(B), m3_mul(Di, B)));
    const V3 y = m3_vec(Di, ub);
    const S6 pa = pAb + mul_inertia(IaA, IaB, IaC, w.cbias[b]) + S6{m3_vec(A, y), m3_tvec(B, y)};
    const Q4 q_pc = w.jrot[j];
    const V3 lt = M.lt(b);
    M3 pAA, pAB, pAC;
    inertia_to_parent(q_pc, lt, IaA, IaB, IaC, pAA, pAB, pAC);
    w.y.I.A[b] = A;
    w.y.I.B[b] = B;
    w.y.I.C[b] = pAC;
    w.x.up.oA[b] = pAA;
    w.x.up.oB[b] = pAB;
    w.pA[b] = force_to_parent(q_pc, lt, pa);
    w.Dinv[b] = Di;
    w.tau[j] = ub;
  }
}

// The root's spatial acceleration (on lane 0, after pass 2) and the root's
// semi-implicit integration, which nothing later in the substep reads.
template <class Model>
HDN void root_step(const Model& M, Work& w) {
  const ModelConsts& c = *M.c;
  M3 A, B, C;
  S6 pA0;
  articulated(*M.d, w, 0, A, B, C, pA0);
  const S6 a0 = solve6_sym(A, B, C, pA0);
  const S6 a = S6{-a0.w, -a0.v};
  w.x.a[0] = a;
  const float h = c.h, wmax = c.wmax, vmax = c.vmax;
  V3 om = w.v6.w + a.w * h;
  V3 vl = w.v6.v + a.v * h;
  om = V3{fminf(fmaxf(om.x, -wmax), wmax), fminf(fmaxf(om.y, -wmax), wmax), fminf(fmaxf(om.z, -wmax), wmax)};
  vl = V3{fminf(fmaxf(vl.x, -vmax), vmax), fminf(fmaxf(vl.y, -vmax), vmax), fminf(fmaxf(vl.z, -vmax), vmax)};
  w.v6 = S6{om, vl};
  w.root_pos = w.root_pos + qrot(w.root_rot, vl) * h;
  w.root_rot = qmul_norm(w.root_rot, expmap_to_quat(om * h));
}

// ABA pass 3 (root -> leaves) and joint integration for level l >= 1.
template <int G, class Model>
HDN void aba_pass3_level(const Model& M, Work& w, int l, int lane) {
  const ModelConsts &c = *M.c, &d = *M.d;
  const float h = c.h, wmax = c.wmax;
  for (int i = c.lev_start[l] + lane; i < c.lev_start[l + 1]; i += G) {
    const int b = d.order[i], p = d.parent[b], j = b - 1;
    const Q4 q = w.jrot[j];
    const S6 a_p = motion_to_child(q, M.lt(b), w.x.a[p]) + w.cbias[b];
    const V3 ut_ap = m3_tvec(w.y.I.A[b], a_p.w) + m3_vec(w.y.I.B[b], a_p.v);
    const M3 Di = w.Dinv[b];
    const V3 qdd = m3_vec(Di, w.tau[j]) - m3_vec(Di, ut_ap);
    w.x.a[b] = a_p + S6{qdd, V3{0, 0, 0}};
    V3 om = w.omega[j] + qdd * h;
    om = V3{fminf(fmaxf(om.x, -wmax), wmax), fminf(fmaxf(om.y, -wmax), wmax),
            fminf(fmaxf(om.z, -wmax), wmax)};
    w.omega[j] = om;
    w.jrot[j] = qmul_norm(q, expmap_to_quat(om * h));
  }
}

// World body state of the generalized coordinates for level l.
template <int G, class Model>
HDN void final_fk_level(const Model& M, Work& w, int l, int lane) {
  const ModelConsts &c = *M.c, &d = *M.d;
  WorldBodies& wb = w.y.wb;
  for (int i = c.lev_start[l] + lane; i < c.lev_start[l + 1]; i += G) {
    const int b = d.order[i];
    if (b == 0) {
      wb.pos[0] = w.root_pos;
      wb.rot[0] = w.root_rot;
      wb.ang[0] = qrot(w.root_rot, w.v6.w);
      wb.vel[0] = qrot(w.root_rot, w.v6.v);
      continue;
    }
    const int p = d.parent[b];
    const Q4 rot_p = wb.rot[p];
    const V3 pos_p = wb.pos[p];
    const Q4 rot = qmul_norm(rot_p, w.jrot[b - 1]);
    const V3 pos = pos_p + qrot(rot_p, M.lt(b));
    const V3 r = pos - pos_p;
    wb.rot[b] = rot;
    wb.pos[b] = pos;
    wb.vel[b] = wb.vel[p] + cross(wb.ang[p], r);
    wb.ang[b] = wb.ang[p] + qrot(rot, w.omega[b - 1]);
  }
}

// ---- the per-env record, env-major ([B, rows]) ----------------------------- //
// state: root pos 3 | root rot 4 | joint rot 4(J-1) | root vel6 6 | joint
// omega 3(J-1), 7 + 7(J-1) + 6 rows; then, on input, the PD target 3(J-1)
// and, on output, contact 3J | world bodies 13J (pos 3, rot 4, vel 3, ang 3
// per body).
HD int state_rows(int J) { return 13 + 7 * (J - 1); }

template <int G>
HDN void read_inputs(int J, RowsIn x, Work& w, int lane) {
  const int Jm1 = J - 1;
  const int r_jrot = 7, r_v6 = 7 + 4 * Jm1, r_om = r_v6 + 6, r_pd = r_om + 3 * Jm1;
  if (lane == 0) {
    w.root_pos = V3{x(0), x(1), x(2)};
    w.root_rot = Q4{x(3), x(4), x(5), x(6)};
    w.v6 = S6{V3{x(r_v6), x(r_v6 + 1), x(r_v6 + 2)}, V3{x(r_v6 + 3), x(r_v6 + 4), x(r_v6 + 5)}};
  }
  for (int j = lane; j < Jm1; j += G) {
    const int q0 = r_jrot + 4 * j, o0 = r_om + 3 * j, p0 = r_pd + 3 * j;
    w.jrot[j] = Q4{x(q0), x(q0 + 1), x(q0 + 2), x(q0 + 3)};
    w.omega[j] = V3{x(o0), x(o0 + 1), x(o0 + 2)};
    w.target[j] = expmap_to_quat(V3{x(p0), x(p0 + 1), x(p0 + 2)});
  }
  for (int b = lane; b < J; b += G) w.acc[b] = V3{0, 0, 0};
}

// The stepped state, the substep-mean contact force and the world bodies.
template <int G>
HDN void write_outputs(const ModelConsts& c, const Work& w, RowsOut y, int lane) {
  const int J = c.J, Jm1 = J - 1;
  const int r_jrot = 7, r_v6 = 7 + 4 * Jm1, r_om = r_v6 + 6, n_state = r_om + 3 * Jm1;
  const int r_contact = n_state, r_body = n_state + 3 * J;
  const float inv_n = 1.0f / (float)c.n_sub;
  if (lane == 0) {
    y(0, w.root_pos.x); y(1, w.root_pos.y); y(2, w.root_pos.z);
    y(3, w.root_rot.x); y(4, w.root_rot.y); y(5, w.root_rot.z); y(6, w.root_rot.w);
    y(r_v6, w.v6.w.x); y(r_v6 + 1, w.v6.w.y); y(r_v6 + 2, w.v6.w.z);
    y(r_v6 + 3, w.v6.v.x); y(r_v6 + 4, w.v6.v.y); y(r_v6 + 5, w.v6.v.z);
  }
  for (int j = lane; j < Jm1; j += G) {
    const int q0 = r_jrot + 4 * j, o0 = r_om + 3 * j;
    const Q4 q = w.jrot[j];
    const V3 om = w.omega[j];
    y(q0, q.x); y(q0 + 1, q.y); y(q0 + 2, q.z); y(q0 + 3, q.w);
    y(o0, om.x); y(o0 + 1, om.y); y(o0 + 2, om.z);
  }
  const WorldBodies& wb = w.y.wb;
  for (int b = lane; b < J; b += G) {
    const int c0 = r_contact + 3 * b, b0 = r_body + 13 * b;
    const V3 f = w.acc[b] * inv_n;
    y(c0, f.x); y(c0 + 1, f.y); y(c0 + 2, f.z);
    y(b0, wb.pos[b].x); y(b0 + 1, wb.pos[b].y); y(b0 + 2, wb.pos[b].z);
    y(b0 + 3, wb.rot[b].x); y(b0 + 4, wb.rot[b].y); y(b0 + 5, wb.rot[b].z); y(b0 + 6, wb.rot[b].w);
    y(b0 + 7, wb.vel[b].x); y(b0 + 8, wb.vel[b].y); y(b0 + 9, wb.vel[b].z);
    y(b0 + 10, wb.ang[b].x); y(b0 + 11, wb.ang[b].y); y(b0 + 12, wb.ang[b].z);
  }
}

// K3-rows: the group copies the env's hot model rows to `hot`.
template <int G>
HDN void stage_hot_rows(int J, RowsIn m, float* hot, int lane) {
  for (int r = lane; r < 13 * J; r += G) hot[r] = m(r);
}

// ---- the control step --------------------------------------------------- //
// Reads the env's inputs from x, runs steps_per_control substeps under the
// held PD target and the final FK, and, if `live`, writes the outputs
// through y. Every lane of the group reaches every barrier; a group past
// the batch (live false) steps a copy of a real env's inputs and writes
// nothing. The world bodies stay in w.y.wb for an epilogue.
template <int G, class Model>
HDN void step_env(const Lanes<G>& run, const Model& M, Work& w, RowsIn x, RowsOut y, bool live) {
  const ModelConsts& c = *M.c;
  run([&](int lane) { read_inputs<G>(c.J, x, w, lane); });
  for (int s = 0; s < c.n_sub; ++s) {
    for (int l = 0; l < c.n_lev; ++l) run([&](int lane) { fk_level<G>(M, w, l, lane); });
    run([&](int lane) { contact_points<G>(M, w, lane); });
    run([&](int lane) { gather_and_torques<G>(M, w, lane); });
    run([&](int lane) { bias_forces<G>(M, w, lane); });
    for (int l = c.n_lev - 1; l >= 1; --l) run([&](int lane) { aba_pass2_level<G>(M, w, l, lane); });
    run([&](int lane) {
      if (lane == 0) root_step(M, w);
    });
    for (int l = 1; l < c.n_lev; ++l) run([&](int lane) { aba_pass3_level<G>(M, w, l, lane); });
  }
  for (int l = 0; l < c.n_lev; ++l) run([&](int lane) { final_fk_level<G>(M, w, l, lane); });
  run([&](int lane) {
    if (live) write_outputs<G>(c, w, y, lane);
  });
}

// ---- launch geometry ------------------------------------------------------ //
// Envs a block: 8, so that 3 blocks (24 envs: 200 KB for K1 and K3, 230 KB
// with K3-rows' hot rows) fit in an SM's 228 KB of shared memory and 3072
// envs (23.3 an SM) run in one wave. Blocks of 4 envs pay the 1 KB an SM
// keeps per block twice as often, and K3-rows then fits 20 envs an SM.
constexpr int kEnvsPerBlock = 8;

// The group sizes built for the card: G = 1 (the one-lane baseline), the
// chosen kGroup among them, and the others chip_smoke.py times beside it.
#define HM_GROUPS(X) X(1) X(4) X(8) X(16) X(32)

}  // namespace hm
