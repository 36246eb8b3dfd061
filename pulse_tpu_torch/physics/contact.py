"""Ground-plane contact: compliant normal force plus regularized Coulomb
friction over the model's proxy points (sphere centres, capsule ends, box
corners), batched over envs.

Counterpart of `pulse_tpu/physics/contact.py` (flat plane z = 0). The
per-point leaves ([P] shared or [B, P] per-env) broadcast over the batch;
`cp_body` is shared.
"""

from __future__ import annotations

import torch

from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics.model import Model


def plane_contact_forces(
    model: Model,
    body_pos: torch.Tensor,      # [B, J, 3]
    body_rot: torch.Tensor,      # [B, J, 4]
    body_vel: torch.Tensor,      # [B, J, 3] velocity of the body origin
    body_ang_vel: torch.Tensor,  # [B, J, 3]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (f_ext [B, J, 6] world (torque about the body origin, force),
    net contact force [B, J, 3])."""
    cfg = model.config
    b = model.cp_body
    p = body_pos[:, b] + q.quat_rotate(body_rot[:, b], model.cp_offset)
    normal = torch.zeros_like(p)
    normal[..., 2] = 1.0
    depth = model.cp_radius - p[..., 2]
    arm = p - body_pos[:, b]
    vp = body_vel[:, b] + q.cross(body_ang_vel[:, b], arm)
    vn = torch.sum(vp * normal, dim=-1)
    fn = torch.where(
        depth > 0.0,
        torch.clamp(cfg.contact_stiffness * depth - cfg.contact_damping * vn, min=0.0),
        torch.zeros_like(depth),
    )
    fn = torch.clamp(fn, max=cfg.max_contact_force)
    vt = vp - vn[..., None] * normal
    vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1) + 1e-12)
    scale = torch.clamp(vt_norm / cfg.friction_regularization, max=1.0)
    ft = -(model.cp_friction * fn * scale / vt_norm)[..., None] * vt
    f_w = fn[..., None] * normal + ft
    n_w = q.cross(arm, f_w)
    B, J = body_pos.shape[0], model.num_bodies
    f_ext = body_pos.new_zeros(B, J, 6).index_add_(1, b, torch.cat([n_w, f_w], dim=-1))
    net = body_pos.new_zeros(B, J, 3).index_add_(1, b, f_w)
    return f_ext, net
