"""Skeleton topology and batched forward kinematics on torch tensors.

Counterpart of `pulse_tpu/kinematics/skeleton.py`. The topology is host-side
numpy; FK walks the tree by depth level, one batched quaternion product per
level.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pulse_tpu_torch.ops import quat as q


@dataclasses.dataclass(frozen=True)
class SkeletonTree:
    """node_names (root first), parent_indices [J] (-1 root),
    local_translation [J, 3] joint offsets in the parent frame."""

    node_names: tuple[str, ...]
    parent_indices: np.ndarray
    local_translation: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "parent_indices", np.asarray(self.parent_indices, np.int32))
        object.__setattr__(self, "local_translation", np.asarray(self.local_translation, np.float32))

    @property
    def num_joints(self) -> int:
        return len(self.node_names)

    @property
    def levels(self) -> list[np.ndarray]:
        """Joint indices grouped by tree depth (level 0 = root)."""
        d = np.zeros(self.num_joints, np.int32)
        for i, p in enumerate(self.parent_indices):
            if p >= 0:
                d[i] = d[p] + 1
        return [np.where(d == lvl)[0].astype(np.int32) for lvl in range(int(d.max()) + 1)]

    @classmethod
    def from_dict(cls, d: dict) -> "SkeletonTree":
        return cls(
            node_names=tuple(d["node_names"]),
            parent_indices=np.asarray(d["parent_indices"], np.int32),
            local_translation=np.asarray(d["local_translation"], np.float32),
        )


def forward_kinematics(
    tree: SkeletonTree, local_rotation: torch.Tensor, root_translation: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., J, 4] local rotations, [..., 3] root position ->
    (global rotations [..., J, 4], global positions [..., J, 3])."""
    levels = tree.levels
    assert len(levels[0]) == 1, "expected a single root"
    lt = torch.as_tensor(tree.local_translation, device=local_rotation.device)
    g_rot = torch.zeros_like(local_rotation)
    g_pos = torch.zeros(local_rotation.shape[:-1] + (3,), device=local_rotation.device)
    r = int(levels[0][0])
    g_rot[..., r, :] = local_rotation[..., r, :]
    g_pos[..., r, :] = root_translation
    for ids in levels[1:]:
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=local_rotation.device)
        pids = torch.as_tensor(tree.parent_indices[ids], dtype=torch.long, device=local_rotation.device)
        p_rot = g_rot[..., pids, :]
        g_rot[..., ids_t, :] = q.quat_mul_norm(p_rot, local_rotation[..., ids_t, :])
        g_pos[..., ids_t, :] = q.quat_rotate(p_rot, lt[ids_t]) + g_pos[..., pids, :]
    return g_rot, g_pos


def global_to_local(tree: SkeletonTree, global_rotation: torch.Tensor) -> torch.Tensor:
    """Inverse of FK on rotations: the root keeps its global rotation, a
    child's local rotation is parent^-1 * child."""
    parents = torch.as_tensor(np.maximum(tree.parent_indices, 0), dtype=torch.long, device=global_rotation.device)
    local = q.quat_mul_norm(q.quat_inverse(global_rotation[..., parents, :]), global_rotation)
    is_root = torch.as_tensor(tree.parent_indices < 0, device=global_rotation.device)[..., None]
    return torch.where(is_root, global_rotation, local)


def _gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _smooth_time_axis(x: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Gaussian filter along axis 0 with edge replication (scipy
    gaussian_filter1d(mode="nearest") semantics)."""
    kernel_size = 2 * int(4.0 * sigma + 0.5) + 1
    k = _gaussian_kernel1d(kernel_size, sigma)
    pad = kernel_size // 2
    xp = torch.cat([x[:1].expand(pad, *x.shape[1:]), x, x[-1:].expand(pad, *x.shape[1:])], dim=0)
    out = float(k[0]) * xp[0 : x.shape[0]]
    for i in range(1, kernel_size):
        out = out + float(k[i]) * xp[i : i + x.shape[0]]
    return out


def compute_linear_velocity(pos: torch.Tensor, fps: float, smooth: bool = True) -> torch.Tensor:
    """[T, ..., 3] positions -> [T, ..., 3] velocities (central difference)."""
    v = torch.gradient(pos, dim=0)[0] * fps
    return _smooth_time_axis(v) if smooth else v


def compute_angular_velocity(rot: torch.Tensor, fps: float, smooth: bool = True) -> torch.Tensor:
    """[T, ..., 4] global rotations -> [T, ..., 3] world angular velocity
    (forward difference, last frame zero)."""
    diff = q.quat_mul_norm(rot[1:], q.quat_inverse(rot[:-1]))
    angle, axis = q.quat_to_angle_axis(diff)
    omega = axis * (angle[..., None] * fps)
    omega = torch.cat([omega, torch.zeros_like(omega[-1:])], dim=0)
    return _smooth_time_axis(omega) if smooth else omega
