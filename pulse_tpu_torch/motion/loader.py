"""Motion files -> per-clip dicts for `build_motion_data`.

Counterpart of `pulse_tpu/motion/loader.py`. Three formats:
  - `.npz`: arrays `local_rotation_<i>` [T, J, 4] (xyzw),
    `root_translation_<i>` [T, 3], `fps_<i>`;
  - `.mtn`: the packed archive (`motion/archive.py`);
  - `.pkl` / `.pk`: the reference's converted-AMASS pickle, a dict of
    entries with `pose_quat` and `root_trans_offset` (plain pickle or
    uncompressed joblib dump, `motion/reference_format.py`).
"""

from __future__ import annotations

import numpy as np

from pulse_tpu_torch.kinematics.skeleton import SkeletonTree
from pulse_tpu_torch.smpl.body_model import GENDER_CODE


def load_motion_file(path: str, tree: SkeletonTree) -> list[dict]:
    if path.endswith(".npz"):
        return _load_npz(path)
    if path.endswith(".mtn"):
        from pulse_tpu_torch.motion.archive import read_archive

        return read_archive(path)
    if path.endswith((".pkl", ".pk")):
        return _load_reference_pkl(path, tree)
    raise ValueError(f"unsupported motion file {path!r}")


def _load_npz(path: str) -> list[dict]:
    clips = []
    with np.load(path) as data:
        while f"local_rotation_{len(clips)}" in data:
            i = len(clips)
            clips.append({"fps": float(data[f"fps_{i}"]),
                          "local_rotation": data[f"local_rotation_{i}"].astype(np.float32),
                          "root_translation": data[f"root_translation_{i}"].astype(np.float32)})
    if not clips:
        raise ValueError(f"{path}: no clips found")
    return clips


def _load_reference_pkl(path: str, tree: SkeletonTree) -> list[dict]:
    """Entries without `pose_quat`, or of another joint count, are skipped;
    a 1-frame clip is held for two frames so that its velocities are
    defined; an entry with `beta` gets the shape row [gender code, betas
    padded to 10] (≙ gender_beta, motion_lib_smpl.py:121-128)."""
    from pulse_tpu_torch.motion.reference_format import load_reference_pkl

    clips = []
    for key, entry in load_reference_pkl(path).items():
        if not isinstance(entry, dict) or "pose_quat" not in entry:
            continue
        lr = np.asarray(entry["pose_quat"], np.float32)
        rt = np.asarray(entry["root_trans_offset"], np.float32)
        if lr.ndim != 3 or lr.shape[1] != tree.num_joints or lr.shape[0] == 0:
            continue
        if lr.shape[0] == 1:
            lr = np.repeat(lr, 2, axis=0)
            rt = np.repeat(rt.reshape(1, 3), 2, axis=0)
        clip = {"fps": float(entry.get("fps", 30.0)), "local_rotation": lr, "root_translation": rt, "name": str(key)}
        if "beta" in entry:
            beta = np.asarray(entry["beta"], np.float32).reshape(-1)[:10]
            gender = entry.get("gender", "neutral")
            if isinstance(gender, bytes):
                gender = gender.decode()
            clip["shape_params"] = np.concatenate([[GENDER_CODE.get(str(gender), 0)],
                                                   np.pad(beta, (0, 10 - beta.shape[0]))]).astype(np.float32)
        clips.append(clip)
    if not clips:
        raise ValueError(f"{path}: no usable clips")
    return clips
