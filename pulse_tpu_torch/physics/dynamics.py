"""Joint torques for the articulated-body step.

Counterpart of `spd_joint_torques` and `explicit_joint_torques` in
`pulse_tpu/physics/dynamics.py`: stable PD, tau = kp*err - (kp*h + kd)*omega
with kd*h folded into the joint-space inertia, or raw torques with
passive damping folded the same way; both plus implicitly damped
joint-limit springs.
"""

from __future__ import annotations

import torch

from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics.model import Model
from pulse_tpu_torch.physics.state import PhysicsState


def _limit_springs(model: Model, state: PhysicsState) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The joint-limit penalty springs (per exp-map axis): (torque
    [B, J-1, 3], active [B, J-1, 3] bool, zeros like the torque)."""
    B, Jm1, cfg = state.joint_rot.shape[0], model.num_joints, model.config
    dof = q.quat_to_exp_map(state.joint_rot).reshape(B, -1)
    excess = torch.clamp(dof - model.dof_upper, min=0.0) + torch.clamp(dof - model.dof_lower, max=0.0)
    active = (excess != 0.0).reshape(B, Jm1, 3)
    limit_tau = (-cfg.limit_stiffness * excess).reshape(B, Jm1, 3)
    zero = torch.zeros_like(limit_tau)
    limit_tau = limit_tau - torch.where(active, cfg.limit_damping * state.joint_omega, zero)
    return limit_tau, active, zero


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

    limit_tau, active, zero = _limit_springs(model, state)
    tau = torch.clamp(tau + limit_tau, -cfg.torque_limit, cfg.torque_limit)
    d_extra = h * kd + torch.where(active, zero + h * (cfg.limit_damping + h * cfg.limit_stiffness), zero)
    return tau, d_extra


def explicit_joint_torques(
    model: Model, state: PhysicsState, tau_dof: torch.Tensor, h: float, passive_kd: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw actuation torques tau_dof ([B, D] or [B, J-1, 3]) plus the
    joint-limit springs, no PD drive: the pd and force control modes.
    `passive_kd` ([J-1] or [B, J-1]) is passive joint damping, folded
    implicitly as stable PD folds kd. Returns (tau, d_extra) as
    `spd_joint_torques` does."""
    B, Jm1, cfg = tau_dof.shape[0], model.num_joints, model.config
    tau = tau_dof.reshape(B, Jm1, 3)
    d_passive = tau.new_zeros(1, 1, 1)
    if passive_kd is not None:
        kd = passive_kd[..., None]
        tau = tau - kd * state.joint_omega
        d_passive = h * kd
    limit_tau, active, zero = _limit_springs(model, state)
    tau = torch.clamp(tau + limit_tau, -cfg.torque_limit, cfg.torque_limit)
    d_extra = d_passive + torch.where(active, zero + h * (cfg.limit_damping + h * cfg.limit_stiffness), zero)
    return tau, d_extra
