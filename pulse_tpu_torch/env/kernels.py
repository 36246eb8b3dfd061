"""Observation, reward, termination and AMP-observation functions, batched
over envs.

Counterpart of the functions of `pulse_tpu/env/kernels.py` that the
imitation env (task obs v6-v9) and the AMP envs (the generic fall check)
use. Quaternions are xyzw; the humanoid starts upright. They are also the
plain versions of kernels K1's epilogue and K2
(`pulse_tpu_torch/env/cuda_obs.py`).
"""

from __future__ import annotations

import torch

from pulse_tpu_torch.ops import quat as q


def dof_to_obs_smpl(dof_pos: torch.Tensor) -> torch.Tensor:
    """Exp-map dof triplets -> 6D tan-norm per joint. [..., D] -> [..., 2D]."""
    shape = dof_pos.shape
    em = dof_pos.reshape(shape[:-1] + (shape[-1] // 3, 3))
    return q.quat_to_tan_norm(q.exp_map_to_quat(em)).reshape(shape[:-1] + (shape[-1] * 2,))


def compute_humanoid_self_obs_max(
    body_pos: torch.Tensor,      # [B, J, 3]
    body_rot: torch.Tensor,      # [B, J, 4]
    body_vel: torch.Tensor,      # [B, J, 3]
    body_ang_vel: torch.Tensor,  # [B, J, 3]
    local_root_obs: bool = True,
    root_height_obs: bool = True,
) -> torch.Tensor:
    """[root_h?, local body pos (J-1)*3, local body rot J*6, local body vel
    J*3, local body ang vel J*3], heading-local."""
    B = body_pos.shape[0]
    root_pos = body_pos[:, 0]
    root_rot = body_rot[:, 0]
    h_exp = q.calc_heading_quat_inv(root_rot)[:, None, :]
    local_body_pos = q.quat_rotate(h_exp, body_pos - root_pos[:, None, :]).reshape(B, -1)[:, 3:]
    local_body_rot_obs = q.quat_to_tan_norm(q.quat_mul(h_exp.expand_as(body_rot), body_rot))
    if not local_root_obs:
        local_body_rot_obs[:, 0] = q.quat_to_tan_norm(root_rot)
    parts = [root_pos[:, 2:3]] if root_height_obs else []
    parts += [
        local_body_pos,
        local_body_rot_obs.reshape(B, -1),
        q.quat_rotate(h_exp, body_vel).reshape(B, -1),
        q.quat_rotate(h_exp, body_ang_vel).reshape(B, -1),
    ]
    return torch.cat(parts, dim=-1)


def compute_imitation_observations_v6(
    root_pos: torch.Tensor,          # [B, 3]
    root_rot: torch.Tensor,          # [B, 4]
    body_pos: torch.Tensor,          # [B, J, 3]
    body_rot: torch.Tensor,          # [B, J, 4]
    body_vel: torch.Tensor,          # [B, J, 3]
    body_ang_vel: torch.Tensor,      # [B, J, 3]
    ref_body_pos: torch.Tensor,      # [B, T, J, 3]
    ref_body_rot: torch.Tensor,      # [B, T, J, 4]
    ref_body_vel: torch.Tensor,      # [B, T, J, 3]
    ref_body_ang_vel: torch.Tensor,  # [B, T, J, 3]
) -> torch.Tensor:
    """Imitation task obs v6: heading-local diffs of pos/rot/vel/ang vel plus
    heading-local ref pos/rot, per future step. -> [B, T*J*24]."""
    B, T = ref_body_pos.shape[:2]
    heading_inv = q.calc_heading_quat_inv(root_rot)[:, None, None, :]
    heading = q.calc_heading_quat(root_rot)[:, None, None, :]
    diff_local_pos = q.quat_rotate(heading_inv, ref_body_pos - body_pos[:, None])
    diff_rot = q.quat_mul(ref_body_rot, q.quat_conjugate(body_rot[:, None]))
    hi = heading_inv.expand_as(diff_rot)
    diff_local_rot = q.quat_mul(q.quat_mul(hi, diff_rot), heading.expand_as(diff_rot))
    diff_local_vel = q.quat_rotate(heading_inv, ref_body_vel - body_vel[:, None])
    diff_local_ang_vel = q.quat_rotate(heading_inv, ref_body_ang_vel - body_ang_vel[:, None])
    local_ref_pos = q.quat_rotate(heading_inv, ref_body_pos - root_pos[:, None, None, :])
    local_ref_rot = q.quat_to_tan_norm(q.quat_mul(hi, ref_body_rot))
    obs = torch.cat(
        [
            diff_local_pos.reshape(B, T, -1),
            q.quat_to_tan_norm(diff_local_rot).reshape(B, T, -1),
            diff_local_vel.reshape(B, T, -1),
            diff_local_ang_vel.reshape(B, T, -1),
            local_ref_pos.reshape(B, T, -1),
            local_ref_rot.reshape(B, T, -1),
        ],
        dim=-1,
    )
    return obs.reshape(B, -1)


def compute_imitation_observations_v7(
    root_pos: torch.Tensor,      # [B, 3]
    root_rot: torch.Tensor,      # [B, 4]
    body_pos: torch.Tensor,      # [B, J, 3]
    body_vel: torch.Tensor,      # [B, J, 3]
    ref_body_pos: torch.Tensor,  # [B, T, J, 3]
    ref_body_vel: torch.Tensor,  # [B, T, J, 3]
) -> torch.Tensor:
    """Position-only imitation obs: heading-local pos and vel diffs and ref
    pos, per future step. -> [B, T*J*9]."""
    B, T = ref_body_pos.shape[:2]
    heading_inv = q.calc_heading_quat_inv(root_rot)[:, None, None, :]
    obs = torch.cat(
        [
            q.quat_rotate(heading_inv, ref_body_pos - body_pos[:, None]).reshape(B, T, -1),
            q.quat_rotate(heading_inv, ref_body_vel - body_vel[:, None]).reshape(B, T, -1),
            q.quat_rotate(heading_inv, ref_body_pos - root_pos[:, None, None, :]).reshape(B, T, -1),
        ],
        dim=-1,
    )
    return obs.reshape(B, -1)


def compute_imitation_observations_v8(
    root_pos: torch.Tensor,          # [B, 3]
    root_rot: torch.Tensor,          # [B, 4]
    body_pos: torch.Tensor,          # [B, J, 3]
    body_rot: torch.Tensor,          # [B, J, 4]
    body_vel: torch.Tensor,          # [B, J, 3]
    body_ang_vel: torch.Tensor,      # [B, J, 3]
    ref_body_pos: torch.Tensor,      # [B, T, J, 3]
    ref_body_rot: torch.Tensor,      # [B, T, J, 4]
    ref_body_vel: torch.Tensor,      # [B, T, J, 3]
    ref_body_ang_vel: torch.Tensor,  # [B, T, J, 3]
) -> torch.Tensor:
    """v8: heading-local diffs against the first future step only, then the
    heading-local ref pos/rot/vel/ang vel of every step, each block over all
    steps (the JAX package's layout for T > 1). -> [B, J*15 + T*J*15]."""
    B = ref_body_pos.shape[0]
    heading_inv1 = q.calc_heading_quat_inv(root_rot)[:, None, :]
    heading1 = q.calc_heading_quat(root_rot)[:, None, :]
    diff_rot = q.quat_mul(ref_body_rot[:, 0], q.quat_conjugate(body_rot))
    hi1 = heading_inv1.expand_as(diff_rot)
    diff_local_rot = q.quat_mul(q.quat_mul(hi1, diff_rot), heading1.expand_as(diff_rot))
    heading_inv = heading_inv1[:, None]
    parts = [
        q.quat_rotate(heading_inv1, ref_body_pos[:, 0] - body_pos),
        q.quat_to_tan_norm(diff_local_rot),
        q.quat_rotate(heading_inv1, ref_body_vel[:, 0] - body_vel),
        q.quat_rotate(heading_inv1, ref_body_ang_vel[:, 0] - body_ang_vel),
        q.quat_rotate(heading_inv, ref_body_pos - root_pos[:, None, None, :]),
        q.quat_to_tan_norm(q.quat_mul(heading_inv.expand_as(ref_body_rot), ref_body_rot)),
        q.quat_rotate(heading_inv, ref_body_vel),
        q.quat_rotate(heading_inv, ref_body_ang_vel),
    ]
    return torch.cat([p.reshape(B, -1) for p in parts], dim=-1)


def compute_imitation_observations_v9(
    root_pos: torch.Tensor,          # [B, 3]
    root_rot: torch.Tensor,          # [B, 4]
    body_pos: torch.Tensor,          # [B, J, 3]
    body_rot: torch.Tensor,          # [B, J, 4]
    body_vel: torch.Tensor,          # [B, J, 3]
    body_ang_vel: torch.Tensor,      # [B, J, 3]
    ref_body_pos: torch.Tensor,      # [B, T, J, 3]
    ref_body_rot: torch.Tensor,      # [B, T, J, 4]
    ref_root_vel: torch.Tensor,      # [B, T, 3]
    ref_root_ang_vel: torch.Tensor,  # [B, T, 3]
) -> torch.Tensor:
    """v9: v6's pos/rot diffs and ref pos/rot, but velocity diffs of the
    root only (body 0 of the given bodies). -> [B, T*(J*18+6)]."""
    B, T = ref_body_pos.shape[:2]
    heading_inv = q.calc_heading_quat_inv(root_rot)[:, None, None, :]
    heading = q.calc_heading_quat(root_rot)[:, None, None, :]
    diff_rot = q.quat_mul(ref_body_rot, q.quat_conjugate(body_rot[:, None]))
    hi = heading_inv.expand_as(diff_rot)
    diff_local_rot = q.quat_mul(q.quat_mul(hi, diff_rot), heading.expand_as(diff_rot))
    heading_inv_root = heading_inv[:, 0]
    obs = torch.cat(
        [
            q.quat_rotate(heading_inv, ref_body_pos - body_pos[:, None]).reshape(B, T, -1),
            q.quat_to_tan_norm(diff_local_rot).reshape(B, T, -1),
            q.quat_rotate(heading_inv_root, ref_root_vel - body_vel[:, None, 0]),
            q.quat_rotate(heading_inv_root, ref_root_ang_vel - body_ang_vel[:, None, 0]),
            q.quat_rotate(heading_inv, ref_body_pos - root_pos[:, None, None, :]).reshape(B, T, -1),
            q.quat_to_tan_norm(q.quat_mul(hi, ref_body_rot)).reshape(B, T, -1),
        ],
        dim=-1,
    )
    return obs.reshape(B, -1)


def compute_imitation_reward(
    body_pos, body_rot, body_vel, body_ang_vel,
    ref_body_pos, ref_body_rot, ref_body_vel, ref_body_ang_vel,
    k_pos: float = 100.0, k_rot: float = 10.0, k_vel: float = 0.1, k_ang_vel: float = 0.1,
    w_pos: float = 0.5, w_rot: float = 0.3, w_vel: float = 0.1, w_ang_vel: float = 0.1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """w·exp(-k·MSE) imitation terms over [B, J, *] bodies.
    Returns (reward [B], raw terms [B, 4])."""
    def mse(a, b):
        return torch.mean(torch.mean((a - b) ** 2, dim=-1), dim=-1)

    r_pos = torch.exp(-k_pos * mse(ref_body_pos, body_pos))
    angle = q.quat_angle(q.quat_mul(ref_body_rot, q.quat_conjugate(body_rot)))
    r_rot = torch.exp(-k_rot * torch.mean(angle ** 2, dim=-1))
    r_vel = torch.exp(-k_vel * mse(ref_body_vel, body_vel))
    r_ang_vel = torch.exp(-k_ang_vel * mse(ref_body_ang_vel, body_ang_vel))
    reward = w_pos * r_pos + w_rot * r_rot + w_vel * r_vel + w_ang_vel * r_ang_vel
    return reward, torch.stack([r_pos, r_rot, r_vel, r_ang_vel], dim=-1)


def compute_power_penalty(tau: torch.Tensor, dof_vel: torch.Tensor, coefficient: float = 0.0005) -> torch.Tensor:
    """Energy penalty -c * sum |tau * qvel| over the dofs. [B, D] -> [B]."""
    return -coefficient * torch.sum(torch.abs(tau * dof_vel), dim=-1)


def compute_humanoid_im_reset(
    progress: torch.Tensor,       # [B] int
    body_pos: torch.Tensor,       # [B, Jr, 3] tracked reset bodies
    ref_body_pos: torch.Tensor,   # [B, Jr, 3]
    pass_time: torch.Tensor,      # [B] bool
    termination_distance: float = 0.25,
    use_mean: bool = True,
    enable_early_termination: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fall when the mean (or any) tracked-body distance to the reference
    exceeds the threshold; reset on fall or clip end. -> (reset, terminated)."""
    dist = torch.linalg.vector_norm(body_pos - ref_body_pos, dim=-1)
    fallen = torch.mean(dist, dim=-1) > termination_distance if use_mean else torch.any(
        dist > termination_distance, dim=-1
    )
    fallen = fallen & (progress > 1)
    if not enable_early_termination:
        fallen = torch.zeros_like(fallen)
    return pass_time | fallen, fallen


def compute_humanoid_reset(
    progress: torch.Tensor,              # [B] int
    contact_force: torch.Tensor,         # [B, J, 3]
    body_pos: torch.Tensor,              # [B, J, 3]
    non_contact_body_ids: torch.Tensor,  # [Jn] bodies that must not touch the ground
    termination_height: float,
    max_episode_length: int,
    enable_early_termination: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Generic fall check: a non-foot body has a contact force above 0.1 and
    a non-foot body is below the termination height, after the first step;
    reset on a fall or at the episode's last step. -> (reset, fallen)."""
    fall_contact = (contact_force[:, non_contact_body_ids].abs() > 0.1).flatten(1).any(dim=-1)
    fall_height = (body_pos[:, non_contact_body_ids, 2] < termination_height).any(dim=-1)
    fallen = fall_contact & fall_height & (progress > 1)
    if not enable_early_termination:
        fallen = torch.zeros_like(fallen)
    return (progress >= max_episode_length - 1) | fallen, fallen


def _amp_parts(root_pos, root_rot, root_vel, root_ang_vel, dof_pos, dof_vel, key_body_pos,
               local_root_obs, root_height_obs):
    heading_inv = q.calc_heading_quat_inv(root_rot)
    root_rot_obs = q.quat_mul(heading_inv, root_rot) if local_root_obs else root_rot
    local_key = q.quat_rotate(heading_inv[:, None, :], key_body_pos - root_pos[:, None, :])
    parts = [root_pos[:, 2:3]] if root_height_obs else []
    parts += [
        q.quat_to_tan_norm(root_rot_obs),
        q.quat_rotate(heading_inv, root_vel),
        q.quat_rotate(heading_inv, root_ang_vel),
        dof_to_obs_smpl(dof_pos),
        dof_vel,
        local_key.reshape(root_pos.shape[0], -1),
    ]
    return parts, heading_inv


def _shape_tails(shape_params, limb_weight_params) -> list:
    return [t for t in (shape_params, limb_weight_params) if t is not None]


def build_amp_observations_smpl(
    root_pos, root_rot, root_vel, root_ang_vel, dof_pos, dof_vel, key_body_pos,
    local_root_obs: bool = True, root_height_obs: bool = True,
    shape_params=None, limb_weight_params=None,
) -> torch.Tensor:
    """AMP discriminator obs v1: [root_h?, root rot 6, local vel 3+3, dof
    tan-norm 2D, dof vel D, local key pos 3K, shape 11?, limb 10?], the
    tails being the given per-env [B, 11] gender+betas and [B, 10] limb
    weights (has_shape_obs_disc / has_limb_weight_obs)."""
    parts, _ = _amp_parts(root_pos, root_rot, root_vel, root_ang_vel, dof_pos, dof_vel,
                          key_body_pos, local_root_obs, root_height_obs)
    return torch.cat(parts + _shape_tails(shape_params, limb_weight_params), dim=-1)


def build_amp_observations_smpl_v2(
    root_pos, root_rot, root_vel, root_ang_vel, dof_pos, dof_vel, key_body_pos, key_body_vel,
    local_root_obs: bool = True, root_height_obs: bool = True,
    shape_params=None, limb_weight_params=None,
) -> torch.Tensor:
    """AMP obs v2: v1's channels plus heading-local key-body velocities,
    then the same shape tails."""
    parts, heading_inv = _amp_parts(root_pos, root_rot, root_vel, root_ang_vel, dof_pos, dof_vel,
                                    key_body_pos, local_root_obs, root_height_obs)
    key_vel = q.quat_rotate(heading_inv[:, None, :], key_body_vel).reshape(root_pos.shape[0], -1)
    return torch.cat(parts + [key_vel] + _shape_tails(shape_params, limb_weight_params), dim=-1)
