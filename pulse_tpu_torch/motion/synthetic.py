"""Procedural walking clips for tests and the chip smoke run.

Counterpart of `make_synthetic_clips` in `pulse_tpu/motion/synthetic.py`
(same seed, same numbers): sinusoidal gait, moving root, constant pelvis
height.
"""

from __future__ import annotations

import numpy as np

from pulse_tpu_torch.kinematics.skeleton import SkeletonTree


def _aa(axis, angle):
    """xyzw quaternion from axis (3,) and angle array [T]."""
    axis = np.asarray(axis, np.float32)
    axis = axis / np.linalg.norm(axis)
    half = 0.5 * np.asarray(angle)
    return np.stack(
        [axis[0] * np.sin(half), axis[1] * np.sin(half), axis[2] * np.sin(half), np.cos(half)],
        axis=-1,
    ).astype(np.float32)


def make_synthetic_clips(
    tree: SkeletonTree,
    num_clips: int = 4,
    seconds: float = 4.0,
    fps: float = 30.0,
    seed: int = 0,
    pelvis_height: float = 0.93,
) -> list[dict]:
    """Walking-like clips: hip/knee/shoulder sinusoids + forward drift."""
    rng = np.random.default_rng(seed)
    J = tree.num_joints
    names = tree.node_names
    clips = []
    for _ in range(num_clips):
        T = int(seconds * fps) + 1
        t = np.arange(T) / fps
        freq = rng.uniform(0.8, 1.6)
        amp = rng.uniform(0.25, 0.55)
        speed = rng.uniform(0.5, 1.4)
        heading = rng.uniform(-np.pi, np.pi)
        phase = 2 * np.pi * freq * t

        local_rot = np.tile(np.asarray([0, 0, 0, 1.0], np.float32), (T, J, 1))
        local_rot[:, 0] = _aa([0, 0, 1], np.full(T, heading))

        def set_joint(name, axis, angle):
            if name in names:
                local_rot[:, names.index(name)] = _aa(axis, angle)

        set_joint("L_Hip", [0, 1, 0], amp * np.sin(phase))
        set_joint("R_Hip", [0, 1, 0], -amp * np.sin(phase))
        set_joint("L_Knee", [0, 1, 0], amp * np.clip(np.sin(phase + np.pi / 2), 0, None))
        set_joint("R_Knee", [0, 1, 0], amp * np.clip(-np.sin(phase + np.pi / 2), 0, None))
        set_joint("L_Ankle", [0, 1, 0], 0.3 * amp * np.sin(phase + np.pi))
        set_joint("R_Ankle", [0, 1, 0], -0.3 * amp * np.sin(phase + np.pi))
        set_joint("L_Shoulder", [0, 1, 0], -0.5 * amp * np.sin(phase))
        set_joint("R_Shoulder", [0, 1, 0], 0.5 * amp * np.sin(phase))
        set_joint("L_Elbow", [0, 1, 0], 0.3 * amp * (1 + np.sin(phase)))
        set_joint("R_Elbow", [0, 1, 0], 0.3 * amp * (1 - np.sin(phase)))
        set_joint("Torso", [0, 0, 1], 0.1 * amp * np.sin(phase))

        direction = np.asarray([np.cos(heading), np.sin(heading), 0.0])
        root_translation = (
            t[:, None] * speed * direction[None, :]
            + np.asarray([0.0, 0.0, pelvis_height])
            + np.stack([np.zeros(T), np.zeros(T), 0.02 * np.sin(2 * phase)], axis=-1)
        ).astype(np.float32)

        clips.append({"fps": fps, "local_rotation": local_rot, "root_translation": root_translation})
    return clips
