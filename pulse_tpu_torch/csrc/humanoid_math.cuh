// Per-env math shared by the humanoid kernels: xyzw quaternions, exp maps,
// tan-norm, heading, 3x3 blocks and Featherstone spatial transforms; and the
// lane group (Lanes) that runs a kernel's phases for one env.
//
// Every function mirrors a plain PyTorch function of the port
// (pulse_tpu_torch/ops/quat.py, physics/spatial.py, env/kernels.py) formula
// for formula, so kernel and plain version differ only by rounding order.
// All are __host__ __device__ and use only <math.h> functions, so a host
// compiler can build them too.
#pragma once

#include <math.h>

// HD: small helpers, always inlined; HDN: the larger per-env stages, left to
// the compiler (static: each translation unit keeps its own copy).
#if defined(__CUDACC__)
#define HD __host__ __device__ __forceinline__
#define HDN static __host__ __device__
#else
#define HD inline
#define HDN static inline
#endif

#define MAX_J 24   // bodies: the kernels' per-env arrays are sized by it

namespace hm {

constexpr float kEps = 1e-9f;
constexpr float kMinTheta = 1e-5f;
constexpr float kPi = 3.14159265358979323846f;

struct V3 { float x, y, z; };
struct Q4 { float x, y, z, w; };
struct M3 { float m[3][3]; };

// One env's record: value r lives at p[r * stride] (stride 1 for the
// env-major records the kernels read and write).
struct RowsIn {
  const float* p;
  long long stride;
  HD float operator()(int r) const { return p[r * stride]; }
};
struct RowsOut {
  float* p;
  long long stride;
  HD void operator()(int r, float v) const { p[r * stride] = v; }
};

// One env's group of G lanes. A phase is a function of the lane; run(f)
// runs it and then the group's barrier. On the card each lane runs its own
// f(lane) and waits at __syncwarp for the group's lanes; on the host one
// thread runs f for each lane in turn, which gives the same result because
// no lane reads in a phase what another lane writes in it.
template <int G>
struct Lanes {
  static_assert(G >= 1 && G <= 32 && 32 % G == 0, "a group lies in one warp");
  int lane;
  unsigned mask;
  template <class F>
  HD void operator()(F f) const {
#if defined(__CUDA_ARCH__)
    f(lane);
    __syncwarp(mask);
#else
    for (int l = 0; l < G; ++l) f(l);
#endif
  }
};

#if defined(__CUDACC__)
// The group's lanes within the warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  return G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (threadIdx.x % 32 / G * G);
}
#endif

// Float multiply and add that the compiler may not fuse into an FMA: where
// two kernels must give the same bits from one sum (K1's epilogue and RA),
// each term is rounded the same way whether it is added at once or first
// stored. The host compiler does not contract (x86-64 without -mfma).
HD float mul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
HD float add_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

HD V3 v3(float x, float y, float z) { return V3{x, y, z}; }
HD V3 operator+(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
HD V3 operator-(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
HD V3 operator*(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
HD V3 operator-(V3 a) { return V3{-a.x, -a.y, -a.z}; }
HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
HD V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
HD float sq3(V3 a) { return dot(a, a); }
// |a|^2 with every product and sum rounded on its own (mul_rn, add_rn)
HD float sq3_rn(V3 a) { return add_rn(add_rn(mul_rn(a.x, a.x), mul_rn(a.y, a.y)), mul_rn(a.z, a.z)); }

// ---- quaternions (ops/quat.py) ------------------------------------------ //

HD Q4 qmul(Q4 a, Q4 b) {
  return Q4{a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
            a.w * b.y + a.y * b.w + a.z * b.x - a.x * b.z,
            a.w * b.z + a.z * b.w + a.x * b.y - a.y * b.x,
            a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z};
}
HD Q4 qunit(Q4 q) {
  float n = fmaxf(sqrtf(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w), kEps);
  return Q4{q.x / n, q.y / n, q.z / n, q.w / n};
}
HD Q4 qmul_norm(Q4 a, Q4 b) { return qunit(qmul(a, b)); }
HD Q4 qconj(Q4 q) { return Q4{-q.x, -q.y, -q.z, q.w}; }
HD V3 qvec(Q4 q) { return V3{q.x, q.y, q.z}; }

// quat_rotate: v(2w^2-1) + 2w (q x v) + 2 q (q.v)
HD V3 qrot(Q4 q, V3 v) {
  V3 u = qvec(q);
  V3 a = v * (2.0f * q.w * q.w - 1.0f);
  V3 b = cross(u, v) * q.w * 2.0f;
  V3 c = u * dot(u, v) * 2.0f;
  return a + b + c;
}
HD V3 qrot_inv(Q4 q, V3 v) { return qrot(qconj(q), v); }

HD float normalize_angle(float t) {
  return t - 2.0f * kPi * floorf((t + kPi) / (2.0f * kPi));
}

// exp_map_to_quat: zero map -> identity
HD Q4 expmap_to_quat(V3 e) {
  float nsq = sq3(e);
  bool mask = nsq > kMinTheta * kMinTheta;
  float angle = sqrtf(mask ? nsq : 1.0f);
  V3 axis = V3{e.x / angle, e.y / angle, e.z / angle};
  angle = mask ? normalize_angle(angle) : 0.0f;
  if (!mask) axis = V3{0.0f, 0.0f, 1.0f};
  float half = 0.5f * angle;
  float s = sinf(half);
  return Q4{axis.x * s, axis.y * s, axis.z * s, cosf(half)};
}

// quat_to_angle_axis's angle, with acosf (the plain version's arccos)
HD float quat_angle(Q4 q) {
  float w = fminf(fmaxf(q.w, -1.0f), 1.0f);
  float sin_half = sqrtf(fmaxf(1.0f - w * w, 0.0f));
  return sin_half > kMinTheta ? normalize_angle(2.0f * acosf(w)) : 0.0f;
}

HD V3 quat_to_expmap(Q4 q) {
  float w = fminf(fmaxf(q.w, -1.0f), 1.0f);
  float sin_half = sqrtf(fmaxf(1.0f - w * w, 0.0f));
  if (!(sin_half > kMinTheta)) return V3{0.0f, 0.0f, 0.0f};
  float angle = normalize_angle(2.0f * acosf(w));
  return V3{q.x / sin_half, q.y / sin_half, q.z / sin_half} * angle;
}

// quat_to_tan_norm: [rotated +x, rotated +z]
HD void tan_norm(Q4 q, float* out) {
  V3 t = qrot(q, V3{1.0f, 0.0f, 0.0f});
  V3 n = qrot(q, V3{0.0f, 0.0f, 1.0f});
  out[0] = t.x; out[1] = t.y; out[2] = t.z;
  out[3] = n.x; out[4] = n.y; out[5] = n.z;
}

// Heading h = atan2 of the rotated +x axis on the xy plane
// (calc_heading). The kernels use this atan2 form, the same as the plain
// version, not the Pallas kernels' branch-free half-angle form.
HD float heading(Q4 q) {
  V3 d = qrot(q, V3{1.0f, 0.0f, 0.0f});
  return atan2f(d.y, d.x);
}
// z-rotation quaternion [0, 0, sin(a/2), cos(a/2)] (quat_from_angle_axis
// about +z): heading_inv = zrot(-heading), heading = zrot(heading)
HD Q4 zrot(float a) { return Q4{0.0f, 0.0f, sinf(0.5f * a), cosf(0.5f * a)}; }

// ---- 3x3 blocks ------------------------------------------------------------ //

HD M3 m3_zero() {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i][j] = 0.0f;
  return r;
}
HD M3 m3_mul(const M3& a, const M3& b) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r.m[i][j] = a.m[i][0] * b.m[0][j] + a.m[i][1] * b.m[1][j] + a.m[i][2] * b.m[2][j];
  return r;
}
HD M3 m3_T(const M3& a) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i][j] = a.m[j][i];
  return r;
}
HD M3 m3_add(const M3& a, const M3& b) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i][j] = a.m[i][j] + b.m[i][j];
  return r;
}
HD M3 m3_sub(const M3& a, const M3& b) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i][j] = a.m[i][j] - b.m[i][j];
  return r;
}
HD V3 m3_vec(const M3& a, V3 v) {
  return V3{a.m[0][0] * v.x + a.m[0][1] * v.y + a.m[0][2] * v.z,
            a.m[1][0] * v.x + a.m[1][1] * v.y + a.m[1][2] * v.z,
            a.m[2][0] * v.x + a.m[2][1] * v.y + a.m[2][2] * v.z};
}
// a^T v
HD V3 m3_tvec(const M3& a, V3 v) {
  return V3{a.m[0][0] * v.x + a.m[1][0] * v.y + a.m[2][0] * v.z,
            a.m[0][1] * v.x + a.m[1][1] * v.y + a.m[2][1] * v.z,
            a.m[0][2] * v.x + a.m[1][2] * v.y + a.m[2][2] * v.z};
}
// adjugate-formula inverse (spatial.inv3)
HD M3 inv3(const M3& m) {
  float a = m.m[0][0], b = m.m[0][1], c = m.m[0][2];
  float d = m.m[1][0], e = m.m[1][1], f = m.m[1][2];
  float g = m.m[2][0], h = m.m[2][1], i = m.m[2][2];
  float A = e * i - f * h, B = c * h - b * i, C = b * f - c * e;
  float D = f * g - d * i, E = a * i - c * g, F = c * d - a * f;
  float G = d * h - e * g, H = b * g - a * h, I = a * e - b * d;
  float s = 1.0f / (a * A + b * D + c * G);
  M3 r;
  r.m[0][0] = A * s; r.m[0][1] = B * s; r.m[0][2] = C * s;
  r.m[1][0] = D * s; r.m[1][1] = E * s; r.m[1][2] = F * s;
  r.m[2][0] = G * s; r.m[2][1] = H * s; r.m[2][2] = I * s;
  return r;
}
HD M3 skew(V3 r) {
  M3 s;
  s.m[0][0] = 0.0f; s.m[0][1] = -r.z; s.m[0][2] = r.y;
  s.m[1][0] = r.z;  s.m[1][1] = 0.0f; s.m[1][2] = -r.x;
  s.m[2][0] = -r.y; s.m[2][1] = r.x;  s.m[2][2] = 0.0f;
  return s;
}
// rotation matrix of conj(q): the child-from-parent matrix E
HD M3 quat_to_matrix_conj(Q4 q) {
  float x = -q.x, y = -q.y, z = -q.z, w = q.w;
  float xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  M3 r;
  r.m[0][0] = 1 - 2 * (yy + zz); r.m[0][1] = 2 * (xy - wz); r.m[0][2] = 2 * (xz + wy);
  r.m[1][0] = 2 * (xy + wz); r.m[1][1] = 1 - 2 * (xx + zz); r.m[1][2] = 2 * (yz - wx);
  r.m[2][0] = 2 * (xz - wy); r.m[2][1] = 2 * (yz + wx); r.m[2][2] = 1 - 2 * (xx + yy);
  return r;
}

// ---- spatial vectors: (angular, linear) ------------------------------------ //

struct S6 { V3 w, v; };
HD S6 operator+(const S6& a, const S6& b) { return S6{a.w + b.w, a.v + b.v}; }
HD S6 operator-(const S6& a, const S6& b) { return S6{a.w - b.w, a.v - b.v}; }
HD S6 s6_zero() { return S6{V3{0, 0, 0}, V3{0, 0, 0}}; }

// cross_motion: (wa x wb, wa x vb + va x wb)
HD S6 cross_motion(const S6& a, const S6& b) {
  return S6{cross(a.w, b.w), cross(a.w, b.v) + cross(a.v, b.w)};
}
// cross_force: (wa x n + va x f, wa x f)
HD S6 cross_force(const S6& a, const S6& f) {
  return S6{cross(a.w, f.w) + cross(a.v, f.v), cross(a.w, f.v)};
}
HD S6 motion_to_child(Q4 q_pc, V3 r, const S6& v) {
  return S6{qrot_inv(q_pc, v.w), qrot_inv(q_pc, v.v + cross(v.w, r))};
}
HD S6 force_to_parent(Q4 q_pc, V3 r, const S6& f) {
  V3 fp = qrot(q_pc, f.v);
  return S6{qrot(q_pc, f.w) + cross(r, fp), fp};
}
// [[A, B], [B^T, C]] (w, v)
HD S6 mul_inertia(const M3& A, const M3& B, const M3& C, const S6& x) {
  return S6{m3_vec(A, x.w) + m3_vec(B, x.v), m3_tvec(B, x.w) + m3_vec(C, x.v)};
}
// Schur-complement solve of [[A, B], [B^T, C]] x = rhs (spatial.solve6_sym)
HD S6 solve6_sym(const M3& A, const M3& B, const M3& C, const S6& rhs) {
  M3 Ainv = inv3(A);
  M3 BtAinv = m3_mul(m3_T(B), Ainv);
  M3 Sinv = inv3(m3_sub(C, m3_mul(BtAinv, B)));
  V3 x1 = m3_vec(Sinv, rhs.v - m3_vec(BtAinv, rhs.w));
  V3 x0 = m3_vec(Ainv, rhs.w - m3_vec(B, x1));
  return S6{x0, x1};
}
// Congruence M^T I M with M = [[E, 0], [-E rx, E]] on 3x3 blocks
HD void inertia_to_parent(Q4 q_pc, V3 r, const M3& A, const M3& B, const M3& C,
                          M3& oA, M3& oB, M3& oC) {
  M3 E = quat_to_matrix_conj(q_pc);
  M3 S = m3_mul(E, skew(r));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) S.m[i][j] = -S.m[i][j];
  M3 Et = m3_T(E), St = m3_T(S);
  M3 X1 = m3_add(m3_mul(Et, A), m3_mul(St, m3_T(B)));
  M3 X2 = m3_add(m3_mul(Et, B), m3_mul(St, C));
  oA = m3_add(m3_mul(X1, E), m3_mul(X2, S));
  oB = m3_mul(X2, E);
  oC = m3_mul(m3_mul(Et, C), E);
}

}  // namespace hm
