"""AMASS preprocessing: raw npz sweep -> filtered 30 fps database ->
reference-format training pickle.

Counterpart of `scripts/process_amass.py`, the reference's pipeline:
  - raw (≙ process_amass_raw.py): every *_poses.npz under the AMASS root
    into one dict keyed "<dataset>_<subject>_<sequence>" with poses, trans,
    betas, gender and framerate;
  - db (≙ process_amass_db.py:159-224, process_qpos_list): every
    int(fps / 30)-th frame, the occlusion filter (a clip marked "sitting"
    or "airborne" is cut at its annotated frame, dropped when that is under
    10; any other issue drops it), the hands zeroed, betas padded to 10,
    and with `--smpl` (a pickle, or a directory of the gendered triple) the
    ground-height fix: one batched LBS per gender over the clips' first
    frames on `--device` (the card unless `cpu`);
  - isaac (≙ convert_amass_isaac.py:26-143): the joint reorder and upright
    conversion into the training schema (`motion/reference_format.py`),
    the FK of all clips' frames batched on `--device`.
Inputs may be plain pickles or uncompressed joblib dumps (read without
joblib); outputs are plain pickles, which `joblib.load` also reads.

    python -m pulse_tpu_torch.scripts.process_amass raw   <amass_root> <out_raw.pkl>
    python -m pulse_tpu_torch.scripts.process_amass db    <raw.pkl> <out_db.pkl> \\
        [--occlusion occl.pkl] [--smpl SMPL_NEUTRAL.pkl | <dir>] [--device cpu]
    python -m pulse_tpu_torch.scripts.process_amass isaac <db.pkl> <out_isaac.pkl> [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from pulse_tpu_torch.motion.reference_format import (
    axis_angle_to_quat,
    convert_amass_entries,
    load_reference_pkl,
    save_reference_pkl,
)

TARGET_FR = 30


def process_raw(amass_root: str, out_file: str) -> dict:
    """≙ process_amass_raw.py: sweep *_poses.npz into one dict."""
    db = {}
    for path in sorted(glob.glob(os.path.join(amass_root, "**", "*_poses.npz"), recursive=True)):
        key = os.path.relpath(path, amass_root).replace(os.sep, "_").replace("_poses.npz", "")
        with np.load(path, allow_pickle=True) as data:
            if "poses" not in data or "trans" not in data:
                continue
            gender = data.get("gender", "neutral")
            if hasattr(gender, "item"):
                gender = gender.item()
            if isinstance(gender, bytes):
                gender = gender.decode("utf-8")
            db[key] = {
                "poses": np.asarray(data["poses"], np.float64),
                "trans": np.asarray(data["trans"], np.float64),
                "betas": np.asarray(data["betas"], np.float64),
                "gender": str(gender),
                "mocap_framerate": float(data.get("mocap_framerate", data.get("mocap_frame_rate", 120.0))),
            }
        print(f"  {key}: {db[key]['poses'].shape[0]} frames")
    save_reference_pkl(out_file, db)
    print(f"wrote {len(db)} sequences -> {out_file}")
    return db


def _load_smpl(smpl_pkl: str):
    from pulse_tpu_torch.smpl.body_model import GenderedSMPL, load_smpl_model

    return GenderedSMPL.load(smpl_pkl) if os.path.isdir(smpl_pkl) else load_smpl_model(smpl_pkl)


def ground_fix(out: dict, smpl, device) -> None:
    """Shift each entry's trans so that its first frame's lowest LBS vertex
    touches z = 0 (≙ fix_height_smpl_vanilla), under its gender's body
    model: `ground_offsets`, one batched LBS a model on `device`."""
    from pulse_tpu_torch._device import resolve_device
    from pulse_tpu_torch.smpl.body_model import GenderedSMPL, ground_offsets

    vs = list(out.values())
    off = ground_offsets([smpl.for_gender(v["gender"]) if isinstance(smpl, GenderedSMPL) else smpl for v in vs],
                         np.stack([v["beta"] for v in vs]),
                         np.stack([axis_angle_to_quat(v["pose_aa"][0].reshape(24, 3)) for v in vs]),
                         np.stack([v["trans"][0] for v in vs]), resolve_device(device))
    for v, o in zip(vs, off):
        v["trans"] = v["trans"] + np.asarray([0, 0, o])


def process_db(raw_file: str, out_file: str, occlusion_file: str | None = None, smpl_pkl: str | None = None,
               device=None) -> dict:
    """≙ process_amass_db.py:159-224 process_qpos_list."""
    raw = load_reference_pkl(raw_file)
    occlusion = load_reference_pkl(occlusion_file) if occlusion_file else {}
    out = {}
    for k, v in raw.items():
        key = "0-" + k
        skip = max(int(float(v["mocap_framerate"]) / TARGET_FR), 1)
        # np.asarray: some upstream dbs hold torch tensors
        pose = np.asarray(v["poses"], np.float64)[::skip]
        trans = np.asarray(v["trans"], np.float64)[::skip]
        bound = pose.shape[0]
        if key in occlusion:
            issue = occlusion[key].get("issue")
            if issue in ("sitting", "airborne") and "idxes" in occlusion[key]:
                bound = occlusion[key]["idxes"][0]  # annotated at 30 fps
                if bound < 10:
                    print(f"  drop {key}: bound too small ({bound})")
                    continue
            else:
                print(f"  drop {key}: irrecoverable issue {issue!r}")
                continue
        if pose.shape[0] < 10:
            continue
        pose, trans = pose[:bound], trans[:bound]
        # SMPL only: the body pose, the hands zeroed (process_amass_db.py:192)
        pose_aa = np.concatenate([pose[:, :66], np.zeros((pose.shape[0], 6))], axis=1)
        betas = np.asarray(v.get("betas", np.zeros(10)), np.float64).reshape(-1)[:10]
        betas = np.concatenate([betas, np.zeros(10 - betas.shape[0])])
        out[key] = {"pose_aa": pose_aa, "trans": trans, "beta": betas, "seq_name": key, "gender": v["gender"]}
    if smpl_pkl and out:
        ground_fix(out, _load_smpl(smpl_pkl), device)
    save_reference_pkl(out_file, out)
    print(f"wrote {len(out)} sequences -> {out_file}")
    return out


def process_isaac(db_file: str, out_file: str, device=None) -> dict:
    """≙ convert_amass_isaac.py run(): db dict -> training pickle, the FK of
    every clip's frames batched on `device` (the card unless named)."""
    from pulse_tpu_torch.assets import load_smpl_humanoid

    db = load_reference_pkl(db_file)
    seqs = {k: {"pose_aa": np.asarray(v["pose_aa"]), "trans": np.asarray(v["trans"]), "fps": 30.0,
                "beta": np.asarray(v.get("beta", np.zeros(10))), "gender": str(v.get("gender", "neutral"))}
            for k, v in db.items()}
    out = convert_amass_entries(seqs, load_smpl_humanoid().skeleton, device=device)
    for k, v in out.items():
        print(f"  {k}: {v['pose_quat'].shape[0]} frames")
    save_reference_pkl(out_file, out)
    print(f"wrote {len(out)} clips -> {out_file}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("stage", choices=["raw", "db", "isaac"])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--occlusion", default=None)
    ap.add_argument("--smpl", default=None)
    ap.add_argument("--device", default=None, help="device of the ground fix and the FK (default: the card)")
    args = ap.parse_args(argv)
    if args.stage == "raw":
        process_raw(args.src, args.dst)
    elif args.stage == "db":
        process_db(args.src, args.dst, args.occlusion, args.smpl, args.device)
    else:
        process_isaac(args.src, args.dst, args.device)


if __name__ == "__main__":
    main()
