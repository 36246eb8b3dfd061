"""Self collision: capsule-capsule contact over a fixed set of body pairs,
batched over envs.

Counterpart of `pulse_tpu/physics/self_collision.py`: every geom of a body
becomes that body's one capsule proxy (a sphere a capsule of length 0, a
box a capsule along its longest axis with a radius bounding its cross
section); the candidate pairs leave out a body's parent, grandparent and
siblings; a touching pair pushes its bodies apart along the closest points'
axis with the ground contact's compliant law, equal and opposite. It runs
in plain PyTorch inside the plain substep (`substep_fused.fused_substep`,
with `PhysicsConfig.self_collision`): the CUDA kernels do not cover it, as
the TPU kernel does not.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pulse_tpu_torch.ops import quat as q


@functools.lru_cache(maxsize=8)
def _pair_table(parents: tuple) -> tuple[np.ndarray, np.ndarray]:
    """(a, b) body indices of every candidate pair, a < b, without a body's
    parent, grandparent or siblings."""
    J = len(parents)

    def ancestors(i, k=2):
        out = set()
        p = parents[i]
        for _ in range(k):
            if p < 0:
                break
            out.add(p)
            p = parents[p]
        return out

    pairs = []
    for i in range(J):
        anc_i = ancestors(i)
        for j in range(i + 1, J):
            if j in anc_i or i in ancestors(j) or parents[i] == parents[j] == max(parents[i], -1) and parents[i] >= 0:
                continue
            if parents[j] == i or parents[i] == j:
                continue
            pairs.append((i, j))
    a = np.asarray([p[0] for p in pairs], np.int32)
    b = np.asarray([p[1] for p in pairs], np.int32)
    return a, b


def capsule_proxies(spec) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each body's capsule: its two ends in the body frame [J, 3] twice and
    its radius [J] (the last geom of a body sets them)."""
    from pulse_tpu_torch.assets.robot_spec import GeomType

    J = spec.num_bodies
    p0 = np.zeros((J, 3), np.float32)
    p1 = np.zeros((J, 3), np.float32)
    radius = np.zeros(J, np.float32)
    for g in range(len(spec.geom_body)):
        bidx = int(spec.geom_body[g])
        t = int(spec.geom_type[g])
        pos = spec.geom_pos[g]
        quat = spec.geom_quat[g]
        size = spec.geom_size[g]

        def rot(v):
            uv = np.cross(quat[:3], v)
            uuv = np.cross(quat[:3], uv)
            return v + 2.0 * (quat[3] * uv + uuv)

        if t == GeomType.SPHERE:
            a = b = pos
            r = size[0]
        elif t == GeomType.CAPSULE:
            axis = rot(np.asarray([0.0, 0.0, 1.0]))
            a, b = pos + size[1] * axis, pos - size[1] * axis
            r = size[0]
        else:
            long_ax = int(np.argmax(size))
            axis = rot(np.eye(3)[long_ax])
            a = pos + size[long_ax] * axis
            b = pos - size[long_ax] * axis
            other = [k for k in range(3) if k != long_ax]
            r = float(np.sqrt(size[other[0]] ** 2 + size[other[1]] ** 2) * 0.7)
        p0[bidx], p1[bidx], radius[bidx] = a, b, r
    return p0, p1, radius


def _segment_closest(a0, a1, b0, b1) -> tuple[torch.Tensor, torch.Tensor]:
    """The closest points of segments [a0, a1] and [b0, b1] ([..., 3])."""
    d1 = a1 - a0
    d2 = b1 - b0
    r = a0 - b0
    a = torch.sum(d1 * d1, dim=-1)
    e = torch.sum(d2 * d2, dim=-1)
    f = torch.sum(d2 * r, dim=-1)
    c = torch.sum(d1 * r, dim=-1)
    b = torch.sum(d1 * d2, dim=-1)
    denom = a * e - b * b
    s = torch.where(denom > 1e-9, torch.clamp((b * f - c * e) / torch.clamp(denom, min=1e-9), 0, 1), 0.0)
    t = torch.where(e > 1e-9, torch.clamp((b * s + f) / torch.clamp(e, min=1e-9), 0, 1), 0.0)
    # s again for the clamped t
    s = torch.where(a > 1e-9, torch.clamp((b * t - c) / torch.clamp(a, min=1e-9), 0, 1), 0.0)
    return a0 + s[..., None] * d1, b0 + t[..., None] * d2


def self_collision_forces(model, cap_p0, cap_p1, cap_r, body_pos: torch.Tensor, body_rot: torch.Tensor,
                          body_vel: torch.Tensor, body_ang_vel: torch.Tensor) -> torch.Tensor:
    """World spatial forces [B, J, 6] (torque about the body origin, force)
    of the self contacts of [B] humanoids. The capsule leaves are shared
    ([J, 3], [J]) or per env ([B, J, 3], [B, J]); `body_vel` is the
    velocity of the body origin."""
    cfg = model.config
    a_np, b_np = _pair_table(model.parents)
    ia = torch.as_tensor(a_np, dtype=torch.long, device=body_pos.device)
    ib = torch.as_tensor(b_np, dtype=torch.long, device=body_pos.device)
    p0 = cap_p0 if cap_p0.dim() == 3 else cap_p0[None]
    p1 = cap_p1 if cap_p1.dim() == 3 else cap_p1[None]
    rad = cap_r if cap_r.dim() == 2 else cap_r[None]

    w_p0 = body_pos + q.quat_rotate(body_rot, p0)
    w_p1 = body_pos + q.quat_rotate(body_rot, p1)
    pa, pb = _segment_closest(w_p0[:, ia], w_p1[:, ia], w_p0[:, ib], w_p1[:, ib])
    delta = pa - pb
    dist = torch.sqrt(torch.sum(delta * delta, dim=-1) + 1e-12)
    pen = (rad[:, ia] + rad[:, ib]) - dist
    n = delta / dist[..., None]      # pushes body a away from body b

    va = body_vel[:, ia] + q.cross(body_ang_vel[:, ia], pa - body_pos[:, ia])
    vb = body_vel[:, ib] + q.cross(body_ang_vel[:, ib], pb - body_pos[:, ib])
    vn = torch.sum((va - vb) * n, dim=-1)
    fmag = torch.where(pen > 0.0, torch.clamp(cfg.contact_stiffness * pen - cfg.contact_damping * vn, min=0.0), 0.0)
    f = fmag[..., None] * n

    B, J = body_pos.shape[0], model.num_bodies
    f_ext = body_pos.new_zeros(B, J, 6)
    f_ext.index_add_(1, ia, torch.cat([q.cross(pa - body_pos[:, ia], f), f], dim=-1))
    f_ext.index_add_(1, ib, torch.cat([q.cross(pb - body_pos[:, ib], -f), -f], dim=-1))
    return f_ext
