"""Spatial (6D) vector algebra, Featherstone style, on batched tensors.

Counterpart of `pulse_tpu/physics/spatial.py`. Motion vectors are
(angular, linear), force vectors (torque, force); a frame transform is
(q_pc parent-from-child rotation, r child origin in the parent frame).
"""

from __future__ import annotations

import torch

from pulse_tpu_torch.ops import quat as q


def ang(v: torch.Tensor) -> torch.Tensor:
    return v[..., 0:3]


def lin(v: torch.Tensor) -> torch.Tensor:
    return v[..., 3:6]


def make(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.cat([w, v], dim=-1)


def cross_motion(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(w_a x w_b, w_a x v_b + v_a x w_b)."""
    return make(q.cross(ang(a), ang(b)), q.cross(ang(a), lin(b)) + q.cross(lin(a), ang(b)))


def cross_force(a: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(w_a x n + v_a x f, w_a x f)."""
    return make(q.cross(ang(a), ang(f)) + q.cross(lin(a), lin(f)), q.cross(ang(a), lin(f)))


def motion_to_child(q_pc: torch.Tensor, r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    w_p, v_p = ang(v), lin(v)
    return make(q.quat_rotate_inverse(q_pc, w_p), q.quat_rotate_inverse(q_pc, v_p + q.cross(w_p, r)))


def force_to_parent(q_pc: torch.Tensor, r: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    f_p = q.quat_rotate(q_pc, lin(f))
    return make(q.quat_rotate(q_pc, ang(f)) + q.cross(r, f_p), f_p)


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1), torch.stack([-y, x, zero], -1)],
        dim=-2,
    )


def quat_to_matrix(qq: torch.Tensor) -> torch.Tensor:
    x, y, z, w = qq.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def motion_matrix_to_child(q_pc: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """6x6 M with v_child = M v_parent."""
    E_t = quat_to_matrix(q.quat_conjugate(q_pc))
    rx = skew(r).expand_as(E_t)
    zero = torch.zeros_like(E_t)
    top = torch.cat([E_t, zero], dim=-1)
    bot = torch.cat([-E_t @ rx, E_t], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inertia_to_parent(q_pc: torch.Tensor, r: torch.Tensor, I_c: torch.Tensor) -> torch.Tensor:
    """I_p = M^T I_c M with M = motion_matrix_to_child."""
    M = motion_matrix_to_child(q_pc, r)
    return M.transpose(-1, -2) @ I_c @ M


def spatial_inertia(mass: torch.Tensor, com: torch.Tensor, inertia_com: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about the body-frame origin."""
    cx = skew(com)
    m = mass[..., None, None]
    top_left = inertia_com + m * (cx @ cx.transpose(-1, -2))
    eye = torch.eye(3, dtype=cx.dtype).expand_as(cx)
    top = torch.cat([top_left, m * cx], dim=-1)
    bot = torch.cat([m * cx.transpose(-1, -2), m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def mul_inertia(I: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (I @ v[..., None])[..., 0]


def inv3(m: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 inverse via the adjugate formula."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I_ = a * e - b * d
    det = a * A + b * D + c * G
    out = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1), torch.stack([G, H, I_], -1)], -2)
    return out * (1.0 / det)[..., None, None]


def solve6_sym(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve M x = rhs for SPD 6x6 M by the 2x2-block Schur complement."""
    A = M[..., 0:3, 0:3]
    B = M[..., 0:3, 3:6]
    C = M[..., 3:6, 3:6]
    r0 = rhs[..., 0:3, None]
    r1 = rhs[..., 3:6, None]
    Ainv = inv3(A)
    BtAinv = B.transpose(-1, -2) @ Ainv
    Sinv = inv3(C - BtAinv @ B)
    x1 = Sinv @ (r1 - BtAinv @ r0)
    x0 = Ainv @ (r0 - B @ x1)
    return torch.cat([x0, x1], dim=-2)[..., 0]
