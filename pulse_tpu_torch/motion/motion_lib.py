"""Device-resident motion library on torch tensors.

Counterpart of `pulse_tpu/motion/motion_lib.py` (store, sampling, state
query). All frames of all clips live concatenated in flat tensors with
per-clip `length_starts`; a query is gathers plus lerp/slerp.

Frame layout: gts/grs/gvs/gavs [F, J, 3|4] global body pos/rot/vel/ang vel,
lrs [F, J, 4] local joint rotations, dvs [F, D] dof velocities. Per clip:
shape_params [M, 11] (gender, 10 betas) and limb_weights [M, 10], the body
shape the AMP demo rows carry in their shape channels (zeros for clips
without shape data, as the synthetic ones).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from pulse_tpu_torch._device import resolve_device
from pulse_tpu_torch.kinematics.skeleton import (
    SkeletonTree,
    compute_angular_velocity,
    compute_linear_velocity,
    forward_kinematics,
)
from pulse_tpu_torch.ops import quat as q


@dataclasses.dataclass
class MotionData:
    gts: torch.Tensor             # [F, J, 3]
    grs: torch.Tensor             # [F, J, 4]
    gvs: torch.Tensor             # [F, J, 3]
    gavs: torch.Tensor            # [F, J, 3]
    lrs: torch.Tensor             # [F, J, 4]
    dvs: torch.Tensor             # [F, D]
    length_starts: torch.Tensor   # [M] long, first frame of each clip
    motion_lengths: torch.Tensor  # [M] seconds
    motion_num_frames: torch.Tensor  # [M] long
    motion_dt: torch.Tensor       # [M]
    sampling_prob: torch.Tensor   # [M]
    shape_params: torch.Tensor | None = None   # [M, 11] gender, betas
    limb_weights: torch.Tensor | None = None   # [M, 10]

    @property
    def num_motions(self) -> int:
        return self.motion_lengths.shape[0]


def _compute_dof_vels(local_rot: torch.Tensor, fps: float) -> torch.Tensor:
    """dof_vel[t] = exp_map(q_t^-1 q_{t+1}) * fps, last frame repeated."""
    diff = q.quat_mul_norm(q.quat_inverse(local_rot[:-1]), local_rot[1:])
    vel = q.quat_to_exp_map(diff) * fps
    return torch.cat([vel, vel[-1:]], dim=0)


def build_motion_data(
    tree: SkeletonTree,
    clips: Sequence[dict[str, Any]],
    sampling_prob: np.ndarray | None = None,
    device=None,
) -> MotionData:
    """Build the flat store from per-clip {"fps", "local_rotation" [T, J, 4],
    "root_translation" [T, 3]} and optional "shape_params" [11] and
    "limb_weights" [10] (zeros where absent). FK and velocities are
    computed on the host in float32, one clip at a time, then uploaded once
    per field."""
    device = resolve_device(device)
    fields: dict[str, list[torch.Tensor]] = {k: [] for k in ("gts", "grs", "gvs", "gavs", "lrs", "dvs")}
    nframes, fps_l = [], []
    for clip in clips:
        lr = torch.as_tensor(np.asarray(clip["local_rotation"], np.float32))
        rt = torch.as_tensor(np.asarray(clip["root_translation"], np.float32))
        fps = float(clip["fps"])
        g_rot, g_pos = forward_kinematics(tree, lr, rt)
        fields["gts"].append(g_pos)
        fields["grs"].append(g_rot)
        fields["gvs"].append(compute_linear_velocity(g_pos, fps))
        fields["gavs"].append(compute_angular_velocity(g_rot, fps))
        fields["lrs"].append(lr)
        fields["dvs"].append(_compute_dof_vels(lr[:, 1:], fps).reshape(lr.shape[0], -1))
        nframes.append(lr.shape[0])
        fps_l.append(fps)

    M = len(clips)
    nframes_np = np.asarray(nframes, np.int64)
    starts = np.concatenate([[0], np.cumsum(nframes_np)[:-1]])
    prob = np.full(M, 1.0 / M, np.float32) if sampling_prob is None else np.asarray(sampling_prob, np.float32)
    lengths = [(n - 1) / f for n, f in zip(nframes, fps_l)]

    def up(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

    return MotionData(
        **{k: torch.cat(v).to(device) for k, v in fields.items()},
        length_starts=up(starts, torch.long),
        motion_lengths=up(np.asarray(lengths, np.float32)),
        motion_num_frames=up(nframes_np, torch.long),
        motion_dt=up((1.0 / np.asarray(fps_l)).astype(np.float32)),
        sampling_prob=up(prob),
        shape_params=up(np.stack([np.asarray(c.get("shape_params", np.zeros(11)), np.float32) for c in clips])),
        limb_weights=up(np.stack([np.asarray(c.get("limb_weights", np.zeros(10)), np.float32) for c in clips])),
    )


def sample_motions(generator: torch.Generator, data: MotionData, n: int) -> torch.Tensor:
    """Categorical clip sampling by the store's weights. [n] long."""
    return torch.multinomial(data.sampling_prob, n, replacement=True, generator=generator)


def sample_time(
    generator: torch.Generator, data: MotionData, motion_ids: torch.Tensor, truncate_time: float = 0.0
) -> torch.Tensor:
    """Uniform phase over the (possibly truncated) clip length."""
    phase = torch.rand(motion_ids.shape, generator=generator, device=motion_ids.device)
    return phase * torch.clamp(data.motion_lengths[motion_ids] - truncate_time, min=0.0)


def _calc_frame_blend(time, length, num_frames, dt):
    """Two-frame index + blend factor."""
    phase = torch.clamp(time / torch.clamp(length, min=1e-6), 0.0, 1.0)
    time = torch.clamp(time, min=0.0)
    f0 = (phase * (num_frames - 1)).to(torch.long)
    f1 = torch.minimum(f0 + 1, num_frames - 1)
    blend = torch.clamp((time - f0.to(time.dtype) * dt) / dt, 0.0, 1.0)
    return f0, f1, blend


def get_motion_state(
    data: MotionData, motion_ids: torch.Tensor, motion_times: torch.Tensor, offset: torch.Tensor | None = None
) -> dict[str, torch.Tensor]:
    """Blended reference state at arbitrary times: lerp for positions and
    velocities, slerp for rotations, dof_pos the exp-map of the slerped
    local joint rotations. An `offset` [..., 3] (a cycled clip's world
    shift) is added to the body positions, and so to root_pos, only."""
    f0, f1, blend = _calc_frame_blend(
        motion_times,
        data.motion_lengths[motion_ids],
        data.motion_num_frames[motion_ids],
        data.motion_dt[motion_ids],
    )
    f0l = f0 + data.length_starts[motion_ids]
    f1l = f1 + data.length_starts[motion_ids]
    b1 = blend[..., None]
    b2 = blend[..., None, None]

    def lerp(table, b):
        return (1.0 - b) * table[f0l] + b * table[f1l]

    rg_pos = lerp(data.gts, b2)
    if offset is not None:
        rg_pos = rg_pos + offset[..., None, :]
    body_vel = lerp(data.gvs, b2)
    body_ang_vel = lerp(data.gavs, b2)
    dof_vel = lerp(data.dvs, b1)
    local_rot = q.slerp(data.lrs[f0l], data.lrs[f1l], b2)
    rb_rot = q.slerp(data.grs[f0l], data.grs[f1l], b2)
    dof_pos = q.quat_to_exp_map(local_rot[..., 1:, :]).reshape(*motion_ids.shape, -1)
    return {
        "root_pos": rg_pos[..., 0, :],
        "root_rot": rb_rot[..., 0, :],
        "dof_pos": dof_pos,
        "root_vel": body_vel[..., 0, :],
        "root_ang_vel": body_ang_vel[..., 0, :],
        "dof_vel": dof_vel,
        "rg_pos": rg_pos,
        "rb_rot": rb_rot,
        "body_vel": body_vel,
        "body_ang_vel": body_ang_vel,
        "local_rot": local_rot,
    }


# --------------------------------------------------------------------------- #
# PMCP adaptive sampling (≙ motion_lib_base.py:348-384)
# --------------------------------------------------------------------------- #

def update_hard_sampling_weight(data: MotionData, failed_ids: torch.Tensor) -> MotionData:
    """Hard-negative mining: sample only clips that failed evaluation.

    failed_ids: [M] bool mask. If nothing failed, falls back to uniform.
    Returns a new MotionData; to make the env's auto-resets sample by the
    new weights, copy them into the live store's `sampling_prob`."""
    failed = torch.as_tensor(failed_ids, device=data.sampling_prob.device).to(torch.bool)
    M = data.num_motions
    prob = failed.to(torch.float32)
    prob = torch.where(failed.any(), prob / torch.clamp(prob.sum(), min=1e-9), torch.full((M,), 1.0 / M, device=prob.device))
    return dataclasses.replace(data, sampling_prob=prob)


def update_soft_sampling_weight(data: MotionData, termination_history: torch.Tensor) -> MotionData:
    """Soft PMCP: weight clips by their termination counts; uniform if clean."""
    hist = torch.as_tensor(termination_history, device=data.sampling_prob.device).to(torch.float32)
    total = hist.sum()
    M = data.num_motions
    prob = torch.where(total > 0, hist / torch.clamp(total, min=1e-9), torch.full((M,), 1.0 / M, device=hist.device))
    return dataclasses.replace(data, sampling_prob=prob)
