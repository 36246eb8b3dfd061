"""One 120 Hz physics substep, batched over envs: FK with pass-1 body
velocities in one level sweep, plane contacts, stable-PD torques, the
articulated-body algorithm's passes 2 and 3 (`aba_fast.solve_accelerations`),
and semi-implicit integration (`integrate`).

Counterpart of `pulse_tpu/physics/substep_fused.py` (stable PD): the
contacts on the plane or the model's terrain (`contact.plane_contact_forces`),
and with `PhysicsConfig.self_collision` the capsule self contacts
(`self_collision.self_collision_forces`), counted in the contact force. On
flat ground without self collision this plain version is the oracle of the
CUDA kernel in `pulse_tpu_torch/csrc/physics_step.cuh`. The model may be shared or batched
(per-env shapes): its per-body leaves are read with a leading env axis,
[1, ...] or [B, ...], and broadcast against the [B, ...] state.
"""

from __future__ import annotations

import torch

from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics import spatial as sp
from pulse_tpu_torch.physics.aba_fast import bias_forces, joint_frames, solve_accelerations
from pulse_tpu_torch.physics.contact import plane_contact_forces
from pulse_tpu_torch.physics.dynamics import spd_joint_torques
from pulse_tpu_torch.physics.model import Model
from pulse_tpu_torch.physics.self_collision import self_collision_forces
from pulse_tpu_torch.physics.state import PhysicsState


def fused_substep(model: Model, state: PhysicsState, pd_target_dof: torch.Tensor, h: float) -> PhysicsState:
    B = state.root_pos.shape[0]
    J = model.num_bodies
    g = state.root_pos.new_tensor([0.0, 0.0, model.config.gravity])
    q_pc, r_off, omega = joint_frames(model, state)
    zeros3 = torch.zeros_like(omega)

    # ---- FK + pass-1 velocities ---------------------------------------- #
    rots = state.root_pos.new_zeros(B, J, 4)
    poss = state.root_pos.new_zeros(B, J, 3)
    v = state.root_pos.new_zeros(B, J, 6)
    rots[:, 0] = state.root_rot
    poss[:, 0] = state.root_pos
    v[:, 0] = state.root_vel6
    for b, p in model.level_index:
        p_rot = rots[:, p]
        rots[:, b] = q.quat_mul_norm(p_rot, state.joint_rot[:, b - 1])
        poss[:, b] = poss[:, p] + q.quat_rotate(p_rot, r_off[:, b])
        vJ = torch.cat([omega[:, b], zeros3[:, b]], dim=-1)
        v[:, b] = sp.motion_to_child(q_pc[:, b], r_off[:, b], v[:, p]) + vJ
    c_bias = sp.cross_motion(v, torch.cat([omega, zeros3], dim=-1))
    w_world = q.quat_rotate(rots, v[..., 0:3])
    vl_world = q.quat_rotate(rots, v[..., 3:6])

    f_ext, net_contact = plane_contact_forces(model, poss, rots, vl_world, w_world)
    if model.config.self_collision:
        f_self = self_collision_forces(model, model.cap_p0, model.cap_p1, model.cap_r, poss, rots, vl_world, w_world)
        f_ext = f_ext + f_self
        net_contact = net_contact + f_self[..., 3:6]
    tau, d_extra = spd_joint_torques(model, state, pd_target_dof, h)
    pA = bias_forces(model, v, f_ext, rots, g)
    a0, qdd = solve_accelerations(model, q_pc, r_off, c_bias, pA, tau, d_extra)
    return integrate(model, state, a0, qdd, h, net_contact)


def integrate(model: Model, state: PhysicsState, a0: torch.Tensor, qdd: torch.Tensor, h: float,
              contact_force: torch.Tensor) -> PhysicsState:
    """Semi-implicit Euler: the velocities (clamped to the config's
    maxima) first, then the positions with the new velocities."""
    cfg = model.config
    root_vel6 = state.root_vel6 + h * a0
    joint_omega = state.joint_omega + h * qdd
    wmax, vmax = cfg.max_angular_velocity, cfg.max_linear_velocity
    root_vel6 = torch.cat(
        [torch.clamp(root_vel6[:, 0:3], -wmax, wmax), torch.clamp(root_vel6[:, 3:6], -vmax, vmax)], dim=-1
    )
    joint_omega = torch.clamp(joint_omega, -wmax, wmax)
    root_rot = q.quat_mul_norm(state.root_rot, q.exp_map_to_quat(h * root_vel6[:, 0:3]))
    root_pos = state.root_pos + h * q.quat_rotate(state.root_rot, root_vel6[:, 3:6])
    joint_rot = q.quat_mul_norm(state.joint_rot, q.exp_map_to_quat(h * joint_omega))
    return state.replace(
        root_pos=root_pos,
        root_rot=root_rot,
        joint_rot=joint_rot,
        root_vel6=root_vel6,
        joint_omega=joint_omega,
        contact_force=contact_force,
    )
