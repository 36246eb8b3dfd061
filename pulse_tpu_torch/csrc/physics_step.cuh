// One control step of the humanoid physics for ONE env, run by one thread:
// steps_per_control substeps (FK with pass-1 velocities, plane contacts,
// stable-PD torques with limit springs, bias forces, ABA passes 2 and 3,
// semi-implicit integration) and the final world-frame FK.
//
// Mirrors the plain version pulse_tpu_torch/physics/substep_fused.py and
// physics/step.py formula for formula; the articulated-inertia update uses
// the 3x3-block form of the TPU kernel (pulse_tpu/physics/substep_pallas.py
// _substep_tiles). Sibling contributions are added to the parent one at a
// time in reverse level order, where the plain version sums them per level
// first: that reorders float adds only.
//
// The code is templated on a model view, through which it reads every
// model value:
//   * TableView: the whole model from one ModelConsts table. K1 and K3 pass
//     their __constant__ c_model: every thread of a warp reads the same
//     address, the case constant memory serves in one transaction.
//   * RowsView (K3-rows): the topology and config scalars from the table,
//     every per-env value (the fields of physics/substep_cuda.py
//     model_rows_layout) from the env's column of a [n_model, B] block of
//     model rows in global memory, read where it is used: neighbouring
//     threads are neighbouring envs, so the loads coalesce, and the block
//     (10.6 MB at 3072 envs) stays in the 50 MB L2. Each body's spatial
//     inertia is rebuilt from its A block, mass and com (B = m [c]x,
//     C = m 1), as the TPU kernel's _model_tiles does.
// Bodies are walked with runtime loops over the level order, not unrolled,
// so the per-env working set (~11 KB: body poses, spatial velocities,
// articulated inertias, U/D^-1/u of pass 2) lives in local memory, cached
// in L1/L2. Everything here is __host__ __device__, so g++ builds it for
// the host tests with a view over a table and rows in memory.
#pragma once

#include "humanoid_math.cuh"

#define MAX_P 72   // ground contact points

namespace hm {

// All fields are 4-byte scalars or arrays of them, so the layout has no
// padding; pulse_tpu_torch/physics/substep_cuda.py packs the same fields in
// the same order.
struct ModelConsts {
  int J, P, n_sub, pad0;
  int order[MAX_J];       // bodies in level order, root first
  int parent[MAX_J];
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

// The whole model from one table.
struct TableView {
  const ModelConsts* c;
  HD V3 lt(int b) const { return cm_v3(c->lt, b); }
  HD float mass(int b) const { return c->mass[b]; }
  HD V3 com(int b) const { return cm_v3(c->com, b); }
  HD void inertia(int b, M3& A, M3& B, M3& C) const {
    A = cm_m3(c->IA, b);
    B = cm_m3(c->IB, b);
    C = cm_m3(c->IC, b);
  }
  HD float kp(int j) const { return c->kp[j]; }
  HD float kd(int j) const { return c->kd[j]; }
  HD float armature(int j) const { return c->armature[j]; }
  HD float dof_lo(int j, int k) const { return c->dof_lo[j][k]; }
  HD float dof_hi(int j, int k) const { return c->dof_hi[j][k]; }
  HD V3 cp_off(int i) const { return cm_v3(c->cp_off, i); }
  HD float cp_radius(int i) const { return c->cp_radius[i]; }
  HD float cp_fric(int i) const { return c->cp_fric[i]; }
};

// Topology and config from the table, per-env values from the env's model
// rows, at the row offsets of model_rows_layout(J, P).
struct RowsView {
  const ModelConsts* c;
  RowsIn m;
  int r_mass, r_com, r_isym, r_kp, r_kd, r_arm, r_lo, r_hi, r_cpo, r_cpr, r_cpf;
  HD RowsView(const ModelConsts* c_, RowsIn m_) : c(c_), m(m_) {
    const int J = c->J, Jm1 = J - 1, P = c->P;
    r_mass = 3 * J;            // lt occupies rows [0, 3J)
    r_com = r_mass + J;
    r_isym = r_com + 3 * J;
    r_kp = r_isym + 6 * J;
    r_kd = r_kp + Jm1;
    r_arm = r_kd + Jm1;
    r_lo = r_arm + Jm1;
    r_hi = r_lo + 3 * Jm1;
    r_cpo = r_hi + 3 * Jm1;
    r_cpr = r_cpo + 3 * P;
    r_cpf = r_cpr + P;
  }
  HD V3 at3(int r) const { return V3{m(r), m(r + 1), m(r + 2)}; }
  HD V3 lt(int b) const { return at3(3 * b); }
  HD float mass(int b) const { return m(r_mass + b); }
  HD V3 com(int b) const { return at3(r_com + 3 * b); }
  HD void inertia(int b, M3& A, M3& B, M3& C) const {
    const int r = r_isym + 6 * b;   // A's entries 00 01 02 11 12 22
    const float s0 = m(r), s1 = m(r + 1), s2 = m(r + 2), s3 = m(r + 3), s4 = m(r + 4), s5 = m(r + 5);
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
  HD V3 cp_off(int i) const { return at3(r_cpo + 3 * i); }
  HD float cp_radius(int i) const { return m(r_cpr + i); }
  HD float cp_fric(int i) const { return m(r_cpf + i); }
};

struct PhysState {
  V3 root_pos;
  Q4 root_rot;
  S6 v6;                  // root spatial velocity, root frame
  Q4 jrot[MAX_J - 1];     // parent-from-child joint rotations
  V3 omega[MAX_J - 1];    // joint angular velocity, child frame
};

struct WorldBodies {
  V3 pos[MAX_J];
  Q4 rot[MAX_J];
  V3 vel[MAX_J];
  V3 ang[MAX_J];
};

// One substep; adds this substep's net contact force per body to acc.
template <class Model>
HDN void substep(const Model& M, PhysState& s, const Q4* target, V3* acc) {
  const ModelConsts& c = *M.c;
  const int J = c.J;
  const float h = c.h;

  // ---- FK + pass-1 velocities ------------------------------------------ //
  Q4 rot[MAX_J];
  V3 pos[MAX_J];
  S6 v[MAX_J];
  rot[0] = s.root_rot;
  pos[0] = s.root_pos;
  v[0] = s.v6;
  for (int k = 1; k < J; ++k) {
    const int b = c.order[k], p = c.parent[b];
    const Q4 q_pc = s.jrot[b - 1];
    const V3 lt = M.lt(b);
    rot[b] = qmul_norm(rot[p], q_pc);
    pos[b] = pos[p] + qrot(rot[p], lt);
    v[b] = motion_to_child(q_pc, lt, v[p]) + S6{s.omega[b - 1], V3{0, 0, 0}};
  }
  S6 cbias[MAX_J];
  cbias[0] = s6_zero();
  for (int b = 1; b < J; ++b) cbias[b] = cross_motion(v[b], S6{s.omega[b - 1], V3{0, 0, 0}});

  // ---- plane contacts (physics/contact.py) ------------------------------ //
  S6 fext[MAX_J];
  for (int b = 0; b < J; ++b) fext[b] = s6_zero();
  for (int i = 0; i < c.P; ++i) {
    const int bi = c.cp_body[i];
    const V3 pw = pos[bi] + qrot(rot[bi], M.cp_off(i));
    const V3 arm = pw - pos[bi];
    const float depth = M.cp_radius(i) - pw.z;
    const V3 vp = qrot(rot[bi], v[bi].v) + cross(qrot(rot[bi], v[bi].w), arm);
    const float vn = vp.z;
    float fn = depth > 0.0f ? fmaxf(c.ks * depth - c.kc * vn, 0.0f) : 0.0f;
    fn = fminf(fn, c.fmax);
    const float vt_norm = sqrtf(vp.x * vp.x + vp.y * vp.y + 1e-12f);
    const float scale = fminf(vt_norm / c.freg, 1.0f);
    const float coef = -(M.cp_fric(i) * fn * scale / vt_norm);
    const V3 fw = V3{coef * vp.x, coef * vp.y, fn};
    fext[bi].w = fext[bi].w + cross(arm, fw);
    fext[bi].v = fext[bi].v + fw;
    acc[bi] = acc[bi] + fw;
  }

  // ---- stable-PD torques + limit springs (physics/dynamics.py) ----------- //
  V3 tau[MAX_J - 1], dex[MAX_J - 1];
  for (int j = 0; j < J - 1; ++j) {
    const float kp = M.kp(j), kd = M.kd(j);
    const V3 err = quat_to_expmap(qmul_norm(qconj(s.jrot[j]), target[j]));
    const V3 t = err * kp - s.omega[j] * (kp * h + kd);
    const V3 dof = quat_to_expmap(s.jrot[j]);
    const float d[3] = {dof.x, dof.y, dof.z};
    const float tt[3] = {t.x, t.y, t.z};
    const float om[3] = {s.omega[j].x, s.omega[j].y, s.omega[j].z};
    float to[3], dx[3];
    for (int k = 0; k < 3; ++k) {
      const float excess = fmaxf(d[k] - M.dof_hi(j, k), 0.0f) +
                           fminf(d[k] - M.dof_lo(j, k), 0.0f);
      const bool active = excess != 0.0f;
      const float lim = -c.lstiff * excess - (active ? c.ldamp * om[k] : 0.0f);
      to[k] = fminf(fmaxf(tt[k] + lim, -c.taumax), c.taumax);
      dx[k] = h * kd + (active ? c.lim_dex : 0.0f);
    }
    tau[j] = V3{to[0], to[1], to[2]};
    dex[j] = V3{dx[0], dx[1], dx[2]};
  }

  // ---- bias forces -------------------------------------------------------- //
  S6 pA[MAX_J];
  M3 IA[MAX_J], IB[MAX_J], IC[MAX_J];
  for (int b = 0; b < J; ++b) {
    const V3 fg = V3{0.0f, 0.0f, M.mass(b) * c.gravity};
    const V3 com_w = qrot(rot[b], M.com(b));
    const S6 f_body = S6{qrot_inv(rot[b], fext[b].w + cross(com_w, fg)),
                         qrot_inv(rot[b], fext[b].v + fg)};
    M.inertia(b, IA[b], IB[b], IC[b]);
    pA[b] = cross_force(v[b], mul_inertia(IA[b], IB[b], IC[b], v[b])) - f_body;
  }

  // ---- ABA pass 2 (leaves -> root) ---------------------------------------- //
  M3 UA[MAX_J], UB[MAX_J], Dinv[MAX_J];
  V3 u[MAX_J];
  for (int k = J - 1; k >= 1; --k) {
    const int b = c.order[k], p = c.parent[b], j = b - 1;
    const M3 A = IA[b], B = IB[b], C = IC[b];
    M3 D = A;
    D.m[0][0] += M.armature(j) + dex[j].x;
    D.m[1][1] += M.armature(j) + dex[j].y;
    D.m[2][2] += M.armature(j) + dex[j].z;
    const M3 Di = inv3(D);
    const V3 ub = tau[j] - pA[b].w;
    // Ia = IA - U D^-1 U^T with U = [A; B^T]
    const M3 M1 = m3_mul(A, Di);
    const M3 IaA = m3_sub(A, m3_mul(M1, A));
    const M3 IaB = m3_sub(B, m3_mul(M1, B));
    const M3 IaC = m3_sub(C, m3_mul(m3_T(B), m3_mul(Di, B)));
    const V3 y = m3_vec(Di, ub);
    const S6 pa = pA[b] + mul_inertia(IaA, IaB, IaC, cbias[b]) + S6{m3_vec(A, y), m3_tvec(B, y)};
    const Q4 q_pc = s.jrot[j];
    const V3 lt = M.lt(b);
    M3 pAA, pAB, pAC;
    inertia_to_parent(q_pc, lt, IaA, IaB, IaC, pAA, pAB, pAC);
    IA[p] = m3_add(IA[p], pAA);
    IB[p] = m3_add(IB[p], pAB);
    IC[p] = m3_add(IC[p], pAC);
    pA[p] = pA[p] + force_to_parent(q_pc, lt, pa);
    UA[b] = A;
    UB[b] = B;
    Dinv[b] = Di;
    u[b] = ub;
  }

  // ---- ABA pass 3 (root -> leaves) and joint integration ------------------ //
  S6 a[MAX_J];
  const S6 a0 = solve6_sym(IA[0], IB[0], IC[0], pA[0]);
  a[0] = S6{-a0.w, -a0.v};
  const float wmax = c.wmax, vmax = c.vmax;
  for (int k = 1; k < J; ++k) {
    const int b = c.order[k], p = c.parent[b], j = b - 1;
    const S6 a_p = motion_to_child(s.jrot[j], M.lt(b), a[p]) + cbias[b];
    const V3 ut_ap = m3_tvec(UA[b], a_p.w) + m3_vec(UB[b], a_p.v);
    const V3 qdd = m3_vec(Dinv[b], u[b]) - m3_vec(Dinv[b], ut_ap);
    a[b] = a_p + S6{qdd, V3{0, 0, 0}};
    V3 om = s.omega[j] + qdd * h;
    om = V3{fminf(fmaxf(om.x, -wmax), wmax), fminf(fmaxf(om.y, -wmax), wmax),
            fminf(fmaxf(om.z, -wmax), wmax)};
    s.omega[j] = om;
    s.jrot[j] = qmul_norm(s.jrot[j], expmap_to_quat(om * h));
  }

  // ---- root integration --------------------------------------------------- //
  V3 w = s.v6.w + a[0].w * h;
  V3 vl = s.v6.v + a[0].v * h;
  w = V3{fminf(fmaxf(w.x, -wmax), wmax), fminf(fmaxf(w.y, -wmax), wmax), fminf(fmaxf(w.z, -wmax), wmax)};
  vl = V3{fminf(fmaxf(vl.x, -vmax), vmax), fminf(fmaxf(vl.y, -vmax), vmax), fminf(fmaxf(vl.z, -vmax), vmax)};
  s.v6 = S6{w, vl};
  s.root_pos = s.root_pos + qrot(s.root_rot, vl) * h;
  s.root_rot = qmul_norm(s.root_rot, expmap_to_quat(w * h));
}

// World body state of the generalized coordinates (physics/state.py
// refresh_kinematics).
template <class Model>
HDN void final_fk(const Model& M, const PhysState& s, WorldBodies& wb) {
  const ModelConsts& c = *M.c;
  const int J = c.J;
  wb.pos[0] = s.root_pos;
  wb.rot[0] = s.root_rot;
  wb.ang[0] = qrot(s.root_rot, s.v6.w);
  wb.vel[0] = qrot(s.root_rot, s.v6.v);
  for (int k = 1; k < J; ++k) {
    const int b = c.order[k], p = c.parent[b];
    wb.rot[b] = qmul_norm(wb.rot[p], s.jrot[b - 1]);
    wb.pos[b] = wb.pos[p] + qrot(wb.rot[p], M.lt(b));
    const V3 r = wb.pos[b] - wb.pos[p];
    wb.vel[b] = wb.vel[p] + cross(wb.ang[p], r);
    wb.ang[b] = wb.ang[p] + qrot(wb.rot[b], s.omega[b - 1]);
  }
}

// steps_per_control substeps under the held PD target, then final FK.
// acc receives the substep-mean net contact force per body.
template <class Model>
HDN void control_step(const Model& M, PhysState& s, const V3* pd_target, V3* acc, WorldBodies& wb) {
  const ModelConsts& c = *M.c;
  const int J = c.J;
  Q4 target[MAX_J - 1];
  for (int j = 0; j < J - 1; ++j) target[j] = expmap_to_quat(pd_target[j]);
  for (int b = 0; b < J; ++b) acc[b] = V3{0, 0, 0};
  for (int i = 0; i < c.n_sub; ++i) substep(M, s, target, acc);
  const float inv_n = 1.0f / (float)c.n_sub;
  for (int b = 0; b < J; ++b) acc[b] = acc[b] * inv_n;
  final_fk(M, s, wb);
}

// ---- the per-env record in [rows, B] layout ------------------------------ //
// state: root pos 3 | root rot 4 | joint rot 4(J-1) | root vel6 6 | joint
// omega 3(J-1), 7 + 7(J-1) + 6 rows; then, on input, the PD target 3(J-1)
// and, on output, contact 3J | world bodies 13J (pos 3, rot 4, vel 3, ang 3
// per body).
HD int state_rows(int J) { return 13 + 7 * (J - 1); }

HDN void read_step_inputs(int J, RowsIn x, PhysState& s, V3* pd) {
  const int Jm1 = J - 1;
  const int r_jrot = 7, r_v6 = 7 + 4 * Jm1, r_om = r_v6 + 6, r_pd = r_om + 3 * Jm1;
  s.root_pos = V3{x(0), x(1), x(2)};
  s.root_rot = Q4{x(3), x(4), x(5), x(6)};
  s.v6 = S6{V3{x(r_v6), x(r_v6 + 1), x(r_v6 + 2)}, V3{x(r_v6 + 3), x(r_v6 + 4), x(r_v6 + 5)}};
  for (int j = 0; j < Jm1; ++j) {
    const int q0 = r_jrot + 4 * j, o0 = r_om + 3 * j, p0 = r_pd + 3 * j;
    s.jrot[j] = Q4{x(q0), x(q0 + 1), x(q0 + 2), x(q0 + 3)};
    s.omega[j] = V3{x(o0), x(o0 + 1), x(o0 + 2)};
    pd[j] = V3{x(p0), x(p0 + 1), x(p0 + 2)};
  }
}

HDN void write_step_outputs(int J, RowsOut y, const PhysState& s, const V3* contact, const WorldBodies& wb) {
  const int Jm1 = J - 1;
  const int r_jrot = 7, r_v6 = 7 + 4 * Jm1, r_om = r_v6 + 6, n_state = r_om + 3 * Jm1;
  y(0, s.root_pos.x); y(1, s.root_pos.y); y(2, s.root_pos.z);
  y(3, s.root_rot.x); y(4, s.root_rot.y); y(5, s.root_rot.z); y(6, s.root_rot.w);
  y(r_v6, s.v6.w.x); y(r_v6 + 1, s.v6.w.y); y(r_v6 + 2, s.v6.w.z);
  y(r_v6 + 3, s.v6.v.x); y(r_v6 + 4, s.v6.v.y); y(r_v6 + 5, s.v6.v.z);
  for (int j = 0; j < Jm1; ++j) {
    const int q0 = r_jrot + 4 * j, o0 = r_om + 3 * j;
    y(q0, s.jrot[j].x); y(q0 + 1, s.jrot[j].y); y(q0 + 2, s.jrot[j].z); y(q0 + 3, s.jrot[j].w);
    y(o0, s.omega[j].x); y(o0 + 1, s.omega[j].y); y(o0 + 2, s.omega[j].z);
  }
  const int r_contact = n_state, r_body = n_state + 3 * J;
  for (int b = 0; b < J; ++b) {
    const int c0 = r_contact + 3 * b, b0 = r_body + 13 * b;
    y(c0, contact[b].x); y(c0 + 1, contact[b].y); y(c0 + 2, contact[b].z);
    y(b0, wb.pos[b].x); y(b0 + 1, wb.pos[b].y); y(b0 + 2, wb.pos[b].z);
    y(b0 + 3, wb.rot[b].x); y(b0 + 4, wb.rot[b].y); y(b0 + 5, wb.rot[b].z); y(b0 + 6, wb.rot[b].w);
    y(b0 + 7, wb.vel[b].x); y(b0 + 8, wb.vel[b].y); y(b0 + 9, wb.vel[b].z);
    y(b0 + 10, wb.ang[b].x); y(b0 + 11, wb.ang[b].y); y(b0 + 12, wb.ang[b].z);
  }
}

}  // namespace hm
