"""One 120 Hz physics substep, batched over envs: FK with pass-1 body
velocities in one level sweep, plane contacts, stable-PD torques, the
articulated-body algorithm's passes 2 and 3, and semi-implicit integration.

Counterpart of `pulse_tpu/physics/substep_fused.py` (flat plane, stable PD).
This plain version is the oracle of the CUDA kernel in
`pulse_tpu_torch/csrc/physics_step.cuh`. The model may be shared or batched
(per-env shapes): its per-body leaves are read with a leading env axis,
[1, ...] or [B, ...], and broadcast against the [B, ...] state.
"""

from __future__ import annotations

import torch

from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics import spatial as sp
from pulse_tpu_torch.physics.contact import plane_contact_forces
from pulse_tpu_torch.physics.dynamics import spd_joint_torques
from pulse_tpu_torch.physics.model import Model
from pulse_tpu_torch.physics.state import PhysicsState


def fused_substep(model: Model, state: PhysicsState, pd_target_dof: torch.Tensor, h: float) -> PhysicsState:
    B = state.root_pos.shape[0]
    J = model.num_bodies
    cfg = model.config
    levels = model.level_index
    g = state.root_pos.new_tensor([0.0, 0.0, cfg.gravity])

    ident = torch.zeros_like(state.root_rot[:, None])
    ident[..., 3] = 1.0
    q_pc = torch.cat([ident, state.joint_rot], dim=1)
    r_off = model.env_axis(model.local_translation)    # [1 or B, J, 3]
    omega = torch.cat([torch.zeros_like(state.joint_omega[:, :1]), state.joint_omega], dim=1)
    zeros3 = torch.zeros_like(omega)

    # ---- FK + pass-1 velocities ---------------------------------------- #
    rots = state.root_pos.new_zeros(B, J, 4)
    poss = state.root_pos.new_zeros(B, J, 3)
    v = state.root_pos.new_zeros(B, J, 6)
    rots[:, 0] = state.root_rot
    poss[:, 0] = state.root_pos
    v[:, 0] = state.root_vel6
    for b, p in levels:
        p_rot = rots[:, p]
        rots[:, b] = q.quat_mul_norm(p_rot, state.joint_rot[:, b - 1])
        poss[:, b] = poss[:, p] + q.quat_rotate(p_rot, r_off[:, b])
        vJ = torch.cat([omega[:, b], zeros3[:, b]], dim=-1)
        v[:, b] = sp.motion_to_child(q_pc[:, b], r_off[:, b], v[:, p]) + vJ
    c_bias = sp.cross_motion(v, torch.cat([omega, zeros3], dim=-1))
    w_world = q.quat_rotate(rots, v[..., 0:3])
    vl_world = q.quat_rotate(rots, v[..., 3:6])

    f_ext, net_contact = plane_contact_forces(model, poss, rots, vl_world, w_world)
    tau, d_extra = spd_joint_torques(model, state, pd_target_dof, h)

    # ---- bias forces ------------------------------------------------------ #
    f_grav_w = model.body_mass[..., None] * g
    com_w = q.quat_rotate(rots, model.body_com)
    n_tot = f_ext[..., 0:3] + q.cross(com_w, f_grav_w)
    f_tot = f_ext[..., 3:6] + f_grav_w
    f_body = sp.make(q.quat_rotate_inverse(rots, n_tot), q.quat_rotate_inverse(rots, f_tot))
    pA = sp.cross_force(v, sp.mul_inertia(model.spatial_inertia, v)) - f_body
    IA = model.spatial_inertia.expand(B, J, 6, 6).clone()

    # ---- ABA pass 2 (leaves -> root) -------------------------------------- #
    U_all = state.root_pos.new_zeros(B, J, 6, 3)
    Dinv_all = state.root_pos.new_zeros(B, J, 3, 3)
    u_all = state.root_pos.new_zeros(B, J, 3)
    eye3 = torch.eye(3, device=state.root_pos.device)
    armature = model.env_axis(model.joint_armature)
    for b, p in reversed(levels):
        IA_b = IA[:, b]
        U = IA_b[..., 0:3]
        diag = armature[:, b - 1][..., None, None] * eye3 + torch.diag_embed(d_extra[:, b - 1])
        Dinv = sp.inv3(IA_b[..., 0:3, 0:3] + diag)
        u = tau[:, b - 1] - pA[:, b, 0:3]
        Ia = IA_b - U @ Dinv @ U.transpose(-1, -2)
        pa = pA[:, b] + sp.mul_inertia(Ia, c_bias[:, b]) + (U @ (Dinv @ u[..., None]))[..., 0]
        Ia_p = sp.inertia_to_parent(q_pc[:, b], r_off[:, b], Ia)
        pa_p = sp.force_to_parent(q_pc[:, b], r_off[:, b], pa)
        # children summed per parent first, then added (segment_sum order)
        IA = IA + torch.zeros_like(IA).index_add_(1, p, Ia_p)
        pA = pA + torch.zeros_like(pA).index_add_(1, p, pa_p)
        U_all[:, b] = U
        Dinv_all[:, b] = Dinv
        u_all[:, b] = u

    # ---- ABA pass 3 (root -> leaves) -------------------------------------- #
    a = state.root_pos.new_zeros(B, J, 6)
    a[:, 0] = -sp.solve6_sym(IA[:, 0], pA[:, 0])
    qdd = state.root_pos.new_zeros(B, J, 3)
    for b, p in levels:
        a_p = sp.motion_to_child(q_pc[:, b], r_off[:, b], a[:, p]) + c_bias[:, b]
        Dinv_b = Dinv_all[:, b]
        Ut_ap = (U_all[:, b].transpose(-1, -2) @ a_p[..., None])[..., 0]
        qdd_b = (Dinv_b @ u_all[:, b, :, None])[..., 0] - (Dinv_b @ Ut_ap[..., None])[..., 0]
        a[:, b] = a_p + torch.cat([qdd_b, zeros3[:, b]], dim=-1)
        qdd[:, b] = qdd_b

    # ---- integrate --------------------------------------------------------- #
    root_vel6 = state.root_vel6 + h * a[:, 0]
    joint_omega = state.joint_omega + h * qdd[:, 1:]
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
        contact_force=net_contact,
    )
