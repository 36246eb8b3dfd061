"""Stable-PD joint torques for the articulated-body step.

Counterpart of `spd_joint_torques` in `pulse_tpu/physics/dynamics.py`:
tau = kp*err - (kp*h + kd)*omega with kd*h folded into the joint-space
inertia, plus implicitly damped joint-limit springs.
"""

from __future__ import annotations

import torch

from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics.model import Model
from pulse_tpu_torch.physics.state import PhysicsState


def spd_joint_torques(
    model: Model, state: PhysicsState, pd_target_dof: torch.Tensor, h: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """pd_target_dof [B, D] exp-map targets. Returns (tau [B, J-1, 3] in the
    child frames, d_extra [B, J-1, 3] extra implicit joint-inertia diagonal)."""
    B = pd_target_dof.shape[0]
    Jm1 = model.num_joints
    cfg = model.config
    target_rot = q.exp_map_to_quat(pd_target_dof.reshape(B, Jm1, 3))
    err = q.quat_to_exp_map(q.quat_mul_norm(q.quat_inverse(state.joint_rot), target_rot))
    kp = model.joint_kp[..., None]     # [J-1, 1], or [B, J-1, 1] per-env
    kd = model.joint_kd[..., None]
    tau = kp * err - (kp * h + kd) * state.joint_omega

    dof = q.quat_to_exp_map(state.joint_rot).reshape(B, -1)
    excess = torch.clamp(dof - model.dof_upper, min=0.0) + torch.clamp(dof - model.dof_lower, max=0.0)
    active = (excess != 0.0).reshape(B, Jm1, 3)
    limit_tau = (-cfg.limit_stiffness * excess).reshape(B, Jm1, 3)
    zero = torch.zeros_like(limit_tau)
    limit_tau = limit_tau - torch.where(active, cfg.limit_damping * state.joint_omega, zero)

    tau = torch.clamp(tau + limit_tau, -cfg.torque_limit, cfg.torque_limit)
    d_extra = h * kd + torch.where(active, zero + h * (cfg.limit_damping + h * cfg.limit_stiffness), zero)
    return tau, d_extra
