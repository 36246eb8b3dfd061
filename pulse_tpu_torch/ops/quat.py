"""Batched xyzw quaternion algebra on torch tensors.

Counterpart of `pulse_tpu/ops/quat.py`: the same formulas, the same edge
handling, broadcast over any leading batch shape. Quaternions are xyzw
(vector part first), vectors are [..., 3].
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-9
_MIN_THETA = 1e-5


def _unit_axis(like: torch.Tensor, k: int) -> torch.Tensor:
    e = torch.zeros_like(like[..., :3])
    e[..., k] = 1.0
    return e


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, broadcasting the leading ones."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def quat_unit(q: torch.Tensor) -> torch.Tensor:
    """Normalize to unit length (safe at 0)."""
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_mul_norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return quat_unit(quat_mul(a, b))


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


quat_inverse = quat_conjugate


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by unit quaternion q (broadcasting)."""
    q_w = q[..., 3:4]
    q_vec = q[..., :3]
    a = v * (2.0 * q_w * q_w - 1.0)
    b = cross(q_vec, v) * q_w * 2.0
    c = q_vec * torch.sum(q_vec * v, dim=-1, keepdim=True) * 2.0
    return a + b + c


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conjugate(q), v)


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi]."""
    return theta - 2 * math.pi * torch.floor((theta + math.pi) / (2 * math.pi))


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle[..., None]
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def quat_to_angle_axis(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Angle in (-pi, pi] and unit axis; near identity: angle 0, axis +z."""
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    sin_half = torch.sqrt(torch.clamp(1.0 - w * w, min=0.0))
    angle = normalize_angle(2.0 * torch.arccos(w))
    mask = sin_half > _MIN_THETA
    safe_sin = torch.where(mask, sin_half, torch.ones_like(sin_half))
    axis = q[..., :3] / safe_sin[..., None]
    angle = torch.where(mask, angle, torch.zeros_like(angle))
    axis = torch.where(mask[..., None], axis, _unit_axis(q, 2))
    return angle, axis


def quat_angle(q: torch.Tensor) -> torch.Tensor:
    return quat_to_angle_axis(q)[0]


def quat_to_exp_map(q: torch.Tensor) -> torch.Tensor:
    angle, axis = quat_to_angle_axis(q)
    return angle[..., None] * axis


def exp_map_to_quat(exp_map: torch.Tensor) -> torch.Tensor:
    """Quaternion from exponential-map coordinates (zero map -> identity)."""
    norm_sq = torch.sum(exp_map * exp_map, dim=-1)
    mask = norm_sq > _MIN_THETA * _MIN_THETA
    angle = torch.sqrt(torch.where(mask, norm_sq, torch.ones_like(norm_sq)))
    axis = exp_map / angle[..., None]
    angle = torch.where(mask, normalize_angle(angle), torch.zeros_like(angle))
    axis = torch.where(mask[..., None], axis, _unit_axis(exp_map, 2))
    return quat_from_angle_axis(angle, axis)


def quat_to_tan_norm(q: torch.Tensor) -> torch.Tensor:
    """[rotated +x, rotated +z] 6-vector."""
    tan = quat_rotate(q, _unit_axis(q, 0))
    norm = quat_rotate(q, _unit_axis(q, 2))
    return torch.cat([tan, norm], dim=-1)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation; near-parallel falls back to the midpoint and
    |cos| >= 1 returns q0. `t` is [...] or [..., 1]."""
    if t.ndim == q0.ndim - 1:
        t = t[..., None]
    cos_half = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(cos_half < 0, -q1, q1)
    cos_half = torch.abs(cos_half)
    half = torch.arccos(torch.clamp(cos_half, -1.0, 1.0))
    sin_half = torch.sqrt(torch.clamp(1.0 - cos_half * cos_half, min=0.0))
    small = torch.abs(sin_half) < 1e-3
    safe_sin = torch.where(small, torch.ones_like(sin_half), sin_half)
    ratio_a = torch.sin((1.0 - t) * half) / safe_sin
    ratio_b = torch.sin(t * half) / safe_sin
    out = ratio_a * q0 + ratio_b * q1
    out = torch.where(small, 0.5 * q0 + 0.5 * q1, out)
    return torch.where(cos_half >= 1.0, q0, out)


def calc_heading(q: torch.Tensor) -> torch.Tensor:
    """Yaw of the rotated +x axis on the xy plane."""
    rot_dir = quat_rotate(q, _unit_axis(q, 0))
    return torch.atan2(rot_dir[..., 1], rot_dir[..., 0])


def calc_heading_quat(q: torch.Tensor) -> torch.Tensor:
    return quat_from_angle_axis(calc_heading(q), _unit_axis(q, 2))


def calc_heading_quat_inv(q: torch.Tensor) -> torch.Tensor:
    return quat_from_angle_axis(-calc_heading(q), _unit_axis(q, 2))
