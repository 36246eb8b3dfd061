"""Offline SMPL mesh renderer: reference-format motion .pkl -> PNG frames.

Counterpart of `scripts/render_smpl_mesh.py` (≙ the reference's Open3D
SMPL renderers, scripts/render_smpl_o3d.py and scripts/vis/vis_smpl_o3d*.py):
the selected frames are skinned in one batched `smpl/body_model.py` `lbs`
call on the device (shape blendshapes + linear blend skinning), then drawn
with matplotlib's Poly3DCollection, one PNG a frame.

Input is the reference's AMASS-isaac motion pickle (pose_quat local xyzw in
MuJoCo joint order, root_trans_offset, beta: `motion/reference_format.py`),
which `pulse_tpu_torch.scripts.process_amass isaac` and `convert_amass` write.

    python -m pulse_tpu_torch.scripts.render_smpl_mesh --motion motions.pkl --smpl SMPL_NEUTRAL.pkl
        [--clip 0] [--out render_out] [--stride 3] [--max-frames 60] [--elev 15] [--azim 45]
        [--device cpu]

The drawing needs matplotlib: where it is missing the script raises an
ImportError that says so, after the skinning has run.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def skin_frames(smpl_model, pose_quat_mj: np.ndarray, trans: np.ndarray, betas: np.ndarray, stride: int = 1,
                max_frames: int = 120, device=None):
    """One batched LBS of the selected frames (every `stride`-th, at most
    `max_frames`) on `device`: pose_quat_mj [T, J, 4] local xyzw in MuJoCo
    order, trans [T, 3], betas [S] -> (frame indices [N], vertices [N, V, 3],
    joints [N, J, 3]) as float32 tensors on the device."""
    from pulse_tpu_torch._device import resolve_device
    from pulse_tpu_torch.motion.reference_format import MUJOCO_JOINT_NAMES
    from pulse_tpu_torch.smpl.body_model import SMPL_JOINT_NAMES, lbs

    device = resolve_device(device)
    # MuJoCo-order local rotations -> SMPL's canonical order (lbs' convention)
    perm = [MUJOCO_JOINT_NAMES.index(n) for n in SMPL_JOINT_NAMES]
    frames = np.arange(0, len(pose_quat_mj), stride)[:max_frames]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    verts, joints = lbs(smpl_model, t(betas), t(np.asarray(pose_quat_mj)[frames][:, perm]), t(np.asarray(trans)[frames]))
    return frames, verts, joints


def _pyplot():
    try:
        import matplotlib
    except ImportError as err:
        raise ImportError("render_smpl_mesh draws with matplotlib, which is not installed; the skinning "
                          "(skin_frames) runs without it") from err
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    return plt, Poly3DCollection


def render_frames(smpl_model, pose_quat_mj: np.ndarray, trans: np.ndarray, betas: np.ndarray, out_dir: str,
                  stride: int = 1, max_frames: int = 120, elev: float = 15.0, azim: float = 45.0,
                  device=None) -> list[str]:
    """Skin the selected frames (`skin_frames`) and write one PNG each;
    returns the paths."""
    frames, verts, joints = skin_frames(smpl_model, pose_quat_mj, trans, betas, stride, max_frames, device)
    plt, Poly3DCollection = _pyplot()
    verts, joints = verts.cpu().numpy(), joints.cpu().numpy()
    os.makedirs(out_dir, exist_ok=True)
    faces = smpl_model.faces
    have_mesh = faces is not None and len(faces) > 0
    paths = []
    for n, t in enumerate(frames):
        v = verts[n]
        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(111, projection="3d")
        if have_mesh:
            ax.add_collection3d(Poly3DCollection(v[faces], alpha=0.9, facecolor="#c8a17e", edgecolor="none"))
        else:
            ax.scatter(v[:, 0], v[:, 1], v[:, 2], s=2, c="#c8a17e")
        j = joints[n]
        ax.scatter(j[:, 0], j[:, 1], j[:, 2], s=6, c="k")
        c = trans[t]
        ax.set_xlim(c[0] - 1, c[0] + 1)
        ax.set_ylim(c[1] - 1, c[1] + 1)
        ax.set_zlim(0, 2)
        ax.view_init(elev=elev, azim=azim)
        ax.set_axis_off()
        path = os.path.join(out_dir, f"frame_{n:04d}.png")
        fig.savefig(path, dpi=80, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--motion", required=True, help="reference-format motion pkl")
    ap.add_argument("--smpl", required=True, help="SMPL release pickle")
    ap.add_argument("--clip", default="0", help="clip name or index in the pkl")
    ap.add_argument("--out", default="render_out")
    ap.add_argument("--stride", type=int, default=3)
    ap.add_argument("--max-frames", type=int, default=60)
    ap.add_argument("--elev", type=float, default=15.0)
    ap.add_argument("--azim", type=float, default=45.0)
    ap.add_argument("--device", default=None, help="the skinning's device (default: the card)")
    args = ap.parse_args(argv)

    from pulse_tpu_torch.motion.reference_format import load_reference_pkl
    from pulse_tpu_torch.smpl.body_model import load_smpl_model

    entries = load_reference_pkl(args.motion)
    names = list(entries)
    key = names[int(args.clip)] if args.clip.isdigit() else args.clip
    clip = entries[key]
    paths = render_frames(load_smpl_model(args.smpl), np.asarray(clip["pose_quat"]),
                          np.asarray(clip["root_trans_offset"]), np.asarray(clip.get("beta", np.zeros(10))),
                          args.out, stride=args.stride, max_frames=args.max_frames, elev=args.elev, azim=args.azim,
                          device=args.device)
    print(f"rendered {len(paths)} frames of {key!r} to {args.out}")
    return paths


if __name__ == "__main__":
    main()
