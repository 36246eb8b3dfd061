"""Convert raw AMASS `*_poses.npz` sequences into a motion archive (`.mtn`).

Counterpart of `scripts/convert_amass.py` (≙ the reference's
convert_amass_isaac.py:26-143 and process_amass_db's 30 fps resampling):
resample to 30 fps, SMPL axis-angle -> per-joint quats, the y-up -> z-up
root rotation, the joint reorder to the MJCF humanoid's depth-first order,
and with `--smpl` the ground-height fix: one batched LBS of every clip's
first frame (neutral betas) on `--device` (the card unless `cpu`).

    python -m pulse_tpu_torch.scripts.convert_amass out.mtn seq1.npz [seq2.npz ...] \
        [--smpl path/to/SMPL_NEUTRAL.pkl] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.motion.archive import write_archive
from pulse_tpu_torch.motion.reference_format import axis_angle_to_quat
from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.smpl.body_model import SMPL_JOINT_NAMES

TARGET_FPS = 30.0


def convert_sequence(path: str, target_names: tuple, mesh_offset: float = 0.92) -> dict | None:
    """One AMASS sequence -> a clip at 30 fps, or None (no poses, or fewer
    than 10 frames after resampling)."""
    with np.load(path) as data:
        if "poses" not in data or "trans" not in data:
            return None
        fps = float(data.get("mocap_framerate", data.get("mocap_frame_rate", 120.0)))
        poses, trans = np.asarray(data["poses"], np.float64), np.asarray(data["trans"], np.float64)
    stride = max(int(round(fps / TARGET_FPS)), 1)
    poses, trans = poses[:, : 24 * 3][::stride], trans[::stride]
    T = poses.shape[0]
    if T < 10:
        return None

    quats = axis_angle_to_quat(poses.reshape(T, 24, 3))
    # AMASS/SMPL is y-up: rotate the root so that the body is z-up
    r90 = torch.from_numpy(axis_angle_to_quat(np.asarray([np.pi / 2, 0.0, 0.0])))
    quats[:, 0] = q.quat_mul(r90.expand(T, 4), torch.from_numpy(quats[:, 0])).numpy()
    trans = trans[:, [0, 2, 1]] * np.asarray([1.0, -1.0, 1.0])
    quats = quats[:, [SMPL_JOINT_NAMES.index(n) for n in target_names]]
    # a fixed pelvis height; --smpl puts the body on the ground instead
    trans[:, 2] += mesh_offset - trans[0, 2]
    return {"fps": TARGET_FPS, "local_rotation": quats.astype(np.float32), "root_translation": trans.astype(np.float32)}


def ground_fix(clips: list[dict], smpl_path: str, target_names: tuple, device) -> None:
    """Shift each clip so that its first frame's lowest LBS vertex is at
    z = 0 (neutral betas): `ground_offsets`, one batched LBS on `device`."""
    from pulse_tpu_torch._device import resolve_device
    from pulse_tpu_torch.smpl.body_model import ground_offsets, load_smpl_model

    inv_order = [target_names.index(n) for n in SMPL_JOINT_NAMES]
    off = ground_offsets([load_smpl_model(smpl_path)] * len(clips), np.zeros((len(clips), 10)),
                         np.stack([c["local_rotation"][0][inv_order] for c in clips]),
                         np.stack([c["root_translation"][0] for c in clips]), resolve_device(device))
    for c, o in zip(clips, off):
        c["root_translation"][:, 2] += o


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("sequences", nargs="+")
    ap.add_argument("--smpl", default="", help="SMPL pickle for the ground-height fix")
    ap.add_argument("--device", default=None, help="device of the ground-height fix (default: the card)")
    args = ap.parse_args(argv)

    names = load_smpl_humanoid().skeleton.node_names
    clips = []
    for seq in args.sequences:
        clip = convert_sequence(seq, names)
        if clip is not None:
            clips.append(clip)
            print(f"{seq}: {clip['local_rotation'].shape[0]} frames")
        else:
            print(f"{seq}: skipped")
    if args.smpl and clips:
        ground_fix(clips, args.smpl, names, args.device)
    write_archive(args.out, clips)
    print(f"wrote {args.out}: {len(clips)} clips")


if __name__ == "__main__":
    main()
