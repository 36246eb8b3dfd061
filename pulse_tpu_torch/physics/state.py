"""Batched physics state: generalized coordinates plus derived world-frame
body quantities, every field with a leading env axis B.

Counterpart of `pulse_tpu/physics/state.py`:
  root_pos [B, 3], root_rot [B, 4] world-from-root xyzw,
  joint_rot [B, J-1, 4] parent-from-child ball joints,
  root_vel6 [B, 6] root spatial velocity in the root frame (ang, lin),
  joint_omega [B, J-1, 3] joint angular velocity in the child frame,
  body_pos/body_rot/body_vel/body_ang_vel [B, J, *] world frame,
  contact_force [B, J, 3] net world contact force per body.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics.model import Model


@dataclasses.dataclass
class PhysicsState:
    root_pos: torch.Tensor
    root_rot: torch.Tensor
    joint_rot: torch.Tensor
    root_vel6: torch.Tensor
    joint_omega: torch.Tensor
    body_pos: torch.Tensor
    body_rot: torch.Tensor
    body_vel: torch.Tensor
    body_ang_vel: torch.Tensor
    contact_force: torch.Tensor

    def replace(self, **kw) -> "PhysicsState":
        return dataclasses.replace(self, **kw)


def physics_state_from_numpy(d: dict, device=None) -> PhysicsState:
    """Build a state from a dict of numpy arrays keyed by field name (e.g. a
    JAX PhysicsState converted leaf by leaf)."""
    return PhysicsState(
        **{f.name: torch.as_tensor(np.asarray(d[f.name], np.float32), device=device)
           for f in dataclasses.fields(PhysicsState)}
    )


@functools.lru_cache(maxsize=8)
def _level_meta(levels: tuple, num_bodies: int):
    """Static per-level bookkeeping derived from Model.levels."""
    body_ids = [np.asarray(b, np.int32) for b, _ in levels]
    parent_ids = [np.asarray(p, np.int32) for _, p in levels]
    parent_local = [np.zeros(0, np.int32)]
    for l in range(1, len(levels)):
        prev_pos = {int(g): i for i, g in enumerate(body_ids[l - 1])}
        parent_local.append(np.asarray([prev_pos[int(p)] for p in parent_ids[l]], np.int32))
    perm_b = np.concatenate(body_ids)
    inv_perm_b = np.empty(num_bodies, np.int32)
    inv_perm_b[perm_b] = np.arange(num_bodies, dtype=np.int32)
    sizes = [len(b) for b in body_ids]
    return {
        "body_ids": body_ids,
        "parent_local": parent_local,
        "perm_b": perm_b,
        "inv_perm_b": inv_perm_b,
        "perm_j": np.concatenate(body_ids[1:]) - 1,
        "sizes": sizes,
        "starts": np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32),
    }


def refresh_kinematics(model: Model, state: PhysicsState) -> PhysicsState:
    """Recompute world body pose and velocity from generalized coordinates,
    level by level (parents always sit exactly one level up)."""
    meta = _level_meta(model.levels, model.num_bodies)
    dev = state.root_pos.device
    perm_j = torch.as_tensor(meta["perm_j"], dtype=torch.long, device=dev)
    jr = state.joint_rot[:, perm_j]
    om = state.joint_omega[:, perm_j]
    lt = model.env_axis(model.local_translation)[:, perm_j + 1]   # [1 or B, J-1, 3]
    starts = meta["starts"]

    rot_lv = [state.root_rot[:, None]]
    pos_lv = [state.root_pos[:, None]]
    w_lv = [q.quat_rotate(state.root_rot, state.root_vel6[:, 0:3])[:, None]]
    v_lv = [q.quat_rotate(state.root_rot, state.root_vel6[:, 3:6])[:, None]]
    for l in range(1, len(meta["body_ids"])):
        pl = torch.as_tensor(meta["parent_local"][l], dtype=torch.long, device=dev)
        s = int(starts[l]) - 1
        e = s + meta["sizes"][l]
        p_rot = rot_lv[l - 1][:, pl]
        p_pos = pos_lv[l - 1][:, pl]
        rot_l = q.quat_mul_norm(p_rot, jr[:, s:e])
        pos_l = p_pos + q.quat_rotate(p_rot, lt[:, s:e])
        r = pos_l - p_pos
        v_lv.append(v_lv[l - 1][:, pl] + q.cross(w_lv[l - 1][:, pl], r))
        w_lv.append(w_lv[l - 1][:, pl] + q.quat_rotate(rot_l, om[:, s:e]))
        rot_lv.append(rot_l)
        pos_lv.append(pos_l)
    inv = torch.as_tensor(meta["inv_perm_b"], dtype=torch.long, device=dev)
    return state.replace(
        body_pos=torch.cat(pos_lv, 1)[:, inv],
        body_rot=torch.cat(rot_lv, 1)[:, inv],
        body_vel=torch.cat(v_lv, 1)[:, inv],
        body_ang_vel=torch.cat(w_lv, 1)[:, inv],
    )


def state_from_kinematics(
    model: Model,
    root_pos: torch.Tensor,
    root_rot: torch.Tensor,
    dof_pos: torch.Tensor,
    root_vel: torch.Tensor,
    root_ang_vel: torch.Tensor,
    dof_vel: torch.Tensor,
) -> PhysicsState:
    """State of [B] humanoids from motion-lib style quantities (world-frame
    root velocities, exp-map dof [B, D]), with FK for the world bodies."""
    B, Jm1, J = root_pos.shape[0], model.num_joints, model.num_bodies
    root_vel6 = torch.cat(
        [q.quat_rotate_inverse(root_rot, root_ang_vel), q.quat_rotate_inverse(root_rot, root_vel)], dim=-1
    )
    z3 = torch.zeros(B, J, 3, device=root_pos.device)
    state = PhysicsState(
        root_pos=root_pos,
        root_rot=q.quat_unit(root_rot),
        joint_rot=q.exp_map_to_quat(dof_pos.reshape(B, Jm1, 3)),
        root_vel6=root_vel6,
        joint_omega=dof_vel.reshape(B, Jm1, 3),
        # the world bodies are filled by refresh_kinematics
        body_pos=z3,
        body_rot=torch.zeros(B, J, 4, device=root_pos.device),
        body_vel=z3,
        body_ang_vel=z3,
        contact_force=z3,
    )
    return refresh_kinematics(model, state)


def state_from_motion_ref(model: Model, ref: dict) -> PhysicsState:
    """Reset state straight from a get_motion_state dict: the motion tables
    already hold the FK'd body poses and velocities, so no FK runs here."""
    B = ref["root_pos"].shape[0]
    root_rot = q.quat_unit(ref["root_rot"])
    root_vel6 = torch.cat(
        [q.quat_rotate_inverse(root_rot, ref["root_ang_vel"]), q.quat_rotate_inverse(root_rot, ref["root_vel"])],
        dim=-1,
    )
    return PhysicsState(
        root_pos=ref["root_pos"],
        root_rot=root_rot,
        joint_rot=ref["local_rot"][:, 1:],
        root_vel6=root_vel6,
        joint_omega=ref["dof_vel"].reshape(B, model.num_joints, 3),
        body_pos=ref["rg_pos"],
        body_rot=ref["rb_rot"],
        body_vel=ref["body_vel"],
        body_ang_vel=ref["body_ang_vel"],
        contact_force=torch.zeros_like(ref["rg_pos"]),
    )


def dof_pos_from_state(state: PhysicsState) -> torch.Tensor:
    """[B, D] exp-map dof positions."""
    return q.quat_to_exp_map(state.joint_rot).flatten(1)


def dof_vel_from_state(state: PhysicsState) -> torch.Tensor:
    """[B, D] local joint angular velocities."""
    return state.joint_omega.flatten(1)
