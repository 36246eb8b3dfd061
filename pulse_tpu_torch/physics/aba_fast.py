"""Articulated-body dynamics by tree level, batched over envs, with
external spatial forces.

Counterpart of `pulse_tpu/physics/aba_fast.py`: the bodies are processed
level by level (root to leaves for the velocities and accelerations,
leaves to root for the articulated inertias), each level one batched
gather, its math and a scatter. The model may be shared or batched: its
per-body leaves broadcast against the [B, ...] state. `fused_substep` runs
the same bias forces and passes 2-3 after its own FK sweep.
"""

from __future__ import annotations

import torch

from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics import spatial as sp
from pulse_tpu_torch.physics.model import Model
from pulse_tpu_torch.physics.state import PhysicsState


def joint_frames(model: Model, state: PhysicsState) -> tuple:
    """(q_pc [B, J, 4] parent-from-child rotations, identity at the root;
    r_off [1 or B, J, 3] joint offsets; omega [B, J, 3] joint rates, zero
    at the root)."""
    ident = torch.zeros_like(state.root_rot[:, None])
    ident[..., 3] = 1.0
    q_pc = torch.cat([ident, state.joint_rot], dim=1)
    omega = torch.cat([torch.zeros_like(state.joint_omega[:, :1]), state.joint_omega], dim=1)
    return q_pc, model.env_axis(model.local_translation), omega


def bias_forces(model: Model, v: torch.Tensor, f_ext_world: torch.Tensor, body_rot_world: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """[B, J, 6] pA = v x* (I v) - f, with f the external force (world
    torque about the body origin, force) plus gravity, in the body frames."""
    f_grav_w = model.body_mass[..., None] * g
    com_w = q.quat_rotate(body_rot_world, model.body_com)
    n_tot = f_ext_world[..., 0:3] + q.cross(com_w, f_grav_w)
    f_tot = f_ext_world[..., 3:6] + f_grav_w
    f_body = sp.make(q.quat_rotate_inverse(body_rot_world, n_tot), q.quat_rotate_inverse(body_rot_world, f_tot))
    return sp.cross_force(v, sp.mul_inertia(model.spatial_inertia, v)) - f_body


def solve_accelerations(model: Model, q_pc: torch.Tensor, r_off: torch.Tensor, c_bias: torch.Tensor,
                        pA: torch.Tensor, tau: torch.Tensor, d_extra: torch.Tensor | None):
    """ABA passes 2 (articulated inertias, leaves to root) and 3
    (accelerations, root to leaves). Returns (root spatial acceleration
    [B, 6] in the root frame, joint qdd [B, J-1, 3])."""
    B, J = pA.shape[0], model.num_bodies
    levels = model.level_index
    IA = model.spatial_inertia.expand(B, J, 6, 6).clone()
    U_all = pA.new_zeros(B, J, 6, 3)
    Dinv_all = pA.new_zeros(B, J, 3, 3)
    u_all = pA.new_zeros(B, J, 3)
    eye3 = torch.eye(3, device=pA.device)
    armature = model.env_axis(model.joint_armature)
    for b, p in reversed(levels):
        IA_b = IA[:, b]
        U = IA_b[..., 0:3]
        diag = armature[:, b - 1][..., None, None] * eye3
        if d_extra is not None:
            diag = diag + torch.diag_embed(d_extra[:, b - 1])
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

    a = pA.new_zeros(B, J, 6)
    a[:, 0] = -sp.solve6_sym(IA[:, 0], pA[:, 0])
    qdd = pA.new_zeros(B, J, 3)
    zeros3 = pA.new_zeros(B, 3)
    for b, p in levels:
        a_p = sp.motion_to_child(q_pc[:, b], r_off[:, b], a[:, p]) + c_bias[:, b]
        Dinv_b = Dinv_all[:, b]
        Ut_ap = (U_all[:, b].transpose(-1, -2) @ a_p[..., None])[..., 0]
        qdd_b = (Dinv_b @ u_all[:, b, :, None])[..., 0] - (Dinv_b @ Ut_ap[..., None])[..., 0]
        a[:, b] = a_p + torch.cat([qdd_b, zeros3[:, None].expand(-1, len(b), -1)], dim=-1)
        qdd[:, b] = qdd_b
    return a[:, 0], qdd[:, 1:]


def aba_fast(model: Model, state: PhysicsState, joint_tau: torch.Tensor, f_ext_world: torch.Tensor,
             body_rot_world: torch.Tensor, h: float, d_extra: torch.Tensor | None = None):
    """Forward dynamics of [B] humanoids: joint_tau [B, J-1, 3] in the child
    frames, f_ext_world [B, J, 6] world spatial forces (torque about the body
    origin, force), body_rot_world [B, J, 4], d_extra [B, J-1, 3] an extra
    implicit joint-inertia diagonal. Returns (root spatial acceleration
    [B, 6] in the root frame, joint qdd [B, J-1, 3])."""
    B, J = state.root_pos.shape[0], model.num_bodies
    g = state.root_pos.new_tensor([0.0, 0.0, model.config.gravity])
    q_pc, r_off, omega = joint_frames(model, state)
    zeros3 = torch.zeros_like(omega)
    v = state.root_pos.new_zeros(B, J, 6)
    v[:, 0] = state.root_vel6
    for b, p in model.level_index:
        vJ = torch.cat([omega[:, b], zeros3[:, b]], dim=-1)
        v[:, b] = sp.motion_to_child(q_pc[:, b], r_off[:, b], v[:, p]) + vJ
    c_bias = sp.cross_motion(v, torch.cat([omega, zeros3], dim=-1))
    pA = bias_forces(model, v, f_ext_world, body_rot_world, g)
    return solve_accelerations(model, q_pc, r_off, c_bias, pA, joint_tau, d_extra)
