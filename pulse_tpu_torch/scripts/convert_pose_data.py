"""Single-pose and MDM-output converters into the training pickle format.

Counterpart of `scripts/convert_pose_data.py` (≙ the reference's
convert_data_smpl.py and convert_data_mdm.py): each source's poses become
SMPL-order axis-angle with the y-up -> z-up root correction, then go
through the shared `convert_amass_entries`, whose FK runs batched on
`--device` (the card unless `cpu`). The input may be a plain pickle
or an uncompressed joblib dump (read without joblib); the output is a
plain pickle.

    # {name: {pose_aa [T, 72] or [72], trans [T, 3] or [3], beta?, gender?}}:
    python -m pulse_tpu_torch.scripts.convert_pose_data smpl in.pkl out_isaac.pkl [--device cpu]
    # MDM-style {name: {pose_euler [T, 24, 3] degrees XYZ, root_translation}}:
    python -m pulse_tpu_torch.scripts.convert_pose_data mdm in.pkl out_isaac.pkl
"""

from __future__ import annotations

import argparse

import numpy as np
from scipy.spatial.transform import Rotation as sRot

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.motion.reference_format import convert_amass_entries, load_reference_pkl, save_reference_pkl


def mdm_to_pose_aa(pose_euler: np.ndarray, trans: np.ndarray):
    """MDM euler output -> SMPL axis-angle + z-up trans (≙
    convert_data_mdm.py:48-60: intrinsic-XYZ degrees, then the x + 90 deg
    upright rotation of the root and the translation, the first frame's
    height moved to 0.92)."""
    B = pose_euler.shape[0]
    pose_aa = sRot.from_euler("XYZ", pose_euler.reshape(-1, 3), degrees=True).as_rotvec().reshape(B, -1)[:, : 24 * 3]
    transform = sRot.from_euler("xyz", [np.pi / 2, 0, 0])
    pose_aa[:, :3] = (transform * sRot.from_rotvec(pose_aa[:, :3])).as_rotvec()
    trans = np.asarray(trans, np.float64).dot(transform.as_matrix().T)
    trans[:, 2] -= trans[0, 2] - 0.92
    return pose_aa, trans


def convert(in_file: str, out_file: str, kind: str, fps: float = 30.0, device=None) -> dict:
    """The source's clips -> training pickle, the FK of every clip's frames
    batched on `device` (the card unless named)."""
    seqs = {}
    for name, entry in load_reference_pkl(in_file).items():
        if kind == "mdm":
            pose_aa, trans = mdm_to_pose_aa(np.asarray(entry["pose_euler"]), np.asarray(entry["root_translation"]))
        else:
            pose_aa = np.asarray(entry["pose_aa"], np.float64)
            trans = np.asarray(entry["trans"], np.float64)
            if pose_aa.ndim == 1:  # a single static pose: a 2-frame hold
                pose_aa, trans = np.tile(pose_aa[None], (2, 1)), np.tile(trans[None], (2, 1))
        beta = np.asarray(entry.get("beta", entry.get("betas", np.zeros(10))), np.float64).reshape(-1)[:10]
        seqs[str(name)] = {"pose_aa": pose_aa[:, : 24 * 3], "trans": trans, "fps": fps, "beta": beta,
                           "gender": str(entry.get("gender", "neutral"))}
    out = convert_amass_entries(seqs, load_smpl_humanoid().skeleton, device=device)
    for name, v in out.items():
        print(f"  {name}: {v['pose_quat'].shape[0]} frames")
    save_reference_pkl(out_file, out)
    print(f"wrote {len(out)} clips -> {out_file}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=["smpl", "mdm"])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--device", default=None, help="device of the FK (default: the card)")
    args = ap.parse_args(argv)
    convert(args.src, args.dst, args.kind, args.fps, args.device)


if __name__ == "__main__":
    main()
