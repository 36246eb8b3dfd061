"""Kinematic motion playback: no physics, the motion store's lookups.

Counterpart of `scripts/play_motion.py` (≙ the reference's
scripts/vis/vis_motion.py playback through the Isaac viewer, headless):
the store of a motion file (or of synthetic clips) is built on the device
(the card unless named) and sampled along one clip's timeline by
`get_motion_state`; the global
body positions and rotations are dumped to .npz and optionally rendered as
a matplotlib stick-figure animation.

    python -m pulse_tpu_torch.scripts.play_motion [--motion_file f.npz|f.mtn|f.pkl]
        [--clip 0] [--fps 30] [--out playback.npz] [--render playback.mp4|.gif]
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pulse_tpu_torch._device import resolve_device
from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.motion.motion_lib import build_motion_data, get_motion_state


def playback(data, clip: int, fps: float = 30.0) -> dict:
    """A motion store (`build_motion_data`'s, on any device) sampled at
    1 / `fps` along clip `clip` -> {body_pos [T, J, 3], body_rot [T, J, 4],
    times [T]} (numpy)."""
    dev = data.gts.device
    length = float(data.motion_lengths[clip])
    times = np.arange(0.0, length, 1.0 / fps, dtype=np.float32)
    ids = torch.full(times.shape, clip, dtype=torch.long, device=dev)
    st = get_motion_state(data, ids, torch.as_tensor(times, device=dev))
    return {"body_pos": st["rg_pos"].cpu().numpy(), "body_rot": st["rb_rot"].cpu().numpy(), "times": times}


def load_clips(tree, motion_file: str = "", clip: int = 0) -> list:
    """A motion file's clips (`motion.loader.load_motion_file`), else
    enough synthetic ones to hold clip `clip`."""
    from pulse_tpu_torch.motion.loader import load_motion_file
    from pulse_tpu_torch.motion.synthetic import make_synthetic_clips

    if motion_file:
        return load_motion_file(motion_file, tree)
    return make_synthetic_clips(tree, num_clips=max(clip + 1, 1))


def render(path: str, body_pos: np.ndarray, tree, fps: float) -> None:
    """Stick-figure animation (≙ poselib's matplotlib plotters)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    parents = tree.parent_indices
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")

    def draw(i):
        ax.clear()
        p = body_pos[i]
        for j in range(1, len(parents)):
            pa = parents[j]
            ax.plot([p[pa, 0], p[j, 0]], [p[pa, 1], p[j, 1]], [p[pa, 2], p[j, 2]], "b-")
        ax.scatter(p[:, 0], p[:, 1], p[:, 2], c="r", s=8)
        c = p[0]
        ax.set_xlim(c[0] - 1, c[0] + 1)
        ax.set_ylim(c[1] - 1, c[1] + 1)
        ax.set_zlim(0, 2)
        ax.set_title(f"frame {i}")

    anim = animation.FuncAnimation(fig, draw, frames=len(body_pos), interval=1000 / fps)
    anim.save(path, writer=animation.FFMpegWriter(fps=fps) if path.endswith(".mp4") else "pillow")
    plt.close(fig)
    print(f"rendered {path}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--motion_file", default="")
    ap.add_argument("--clip", type=int, default=0)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--out", default="playback.npz")
    ap.add_argument("--render", default="")
    ap.add_argument("--device", default=None, help="the store's device (default: the card)")
    args = ap.parse_args(argv)

    tree = load_smpl_humanoid().skeleton
    data = build_motion_data(tree, load_clips(tree, args.motion_file, args.clip), device=resolve_device(args.device))
    out = playback(data, args.clip, args.fps)
    np.savez(args.out, **out, node_names=np.asarray(tree.node_names), parents=tree.parent_indices)
    print(f"wrote {args.out}: {len(out['times'])} frames x {out['body_pos'].shape[1]} bodies")
    if args.render:
        render(args.render, out["body_pos"], tree, args.fps)
    return out


if __name__ == "__main__":
    main()
