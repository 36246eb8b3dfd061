"""Interactive demo viewer and driver for `pulse_tpu_torch.scripts.demo_server`.

Counterpart of `scripts/demo_client.py` (≙ the reference's ws_client.py
viewer, video_to_pose_server.py driver and humanoid_im_demo.py clip
switching): connect to a running demo server (of either package: the wire
format is shared), optionally switch the driven clip, and print frame
summaries or save a matplotlib stick-figure animation.

    python -m pulse_tpu_torch.scripts.demo_client [--port 8765] [--frames 300]
        [--motion K] [--time T]       # switch the server onto clip K at T s
        [--render out.mp4|out.gif]    # save a stick-figure animation (matplotlib)
        [--timeout S]                 # give up on a frame after S seconds

A socket client only: it runs nothing on a device, so it takes no
`--device`.
"""

from __future__ import annotations

import argparse

import numpy as np


def receive(client, frames: int, every: int = 30) -> list[dict]:
    """`frames` frames from the server, a summary printed every `every`."""
    out = []
    for i in range(frames):
        frame = client.recv()
        out.append(frame)
        if i % every == 0:
            bp = np.asarray(frame["body_pos"])
            print(f"t={frame['t']:7.3f}s reward={frame['reward']:.3f} "
                  f"root=({bp[0, 0]:+.2f},{bp[0, 1]:+.2f},{bp[0, 2]:+.2f})")
    return out


def render(path: str, frames: list[dict]) -> None:
    """A stick-figure animation of the frames' bodies (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as anim
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    pts = np.asarray([f["body_pos"] for f in frames])

    def draw(i):
        ax.cla()
        p = pts[i]
        ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=12)
        c = pts[i, 0]
        ax.set_xlim(c[0] - 1, c[0] + 1)
        ax.set_ylim(c[1] - 1, c[1] + 1)
        ax.set_zlim(0, 2)
        ax.set_title(f"t={frames[i]['t']:.2f}s")

    a = anim.FuncAnimation(fig, draw, frames=len(frames), interval=33)
    a.save(path, writer="pillow" if path.endswith(".gif") else None)
    plt.close(fig)
    print(f"wrote {path}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--motion", type=int, default=-1)
    ap.add_argument("--time", type=float, default=0.0)
    ap.add_argument("--render", default="")
    ap.add_argument("--timeout", type=float, default=None, help="seconds to wait for a frame")
    args = ap.parse_args(argv)

    from pulse_tpu_torch.utils.pose_server import PoseClient

    client = PoseClient(host=args.host, port=args.port, timeout=args.timeout)
    try:
        if args.motion >= 0:
            client.send({"cmd": "motion", "id": args.motion, "time": args.time})
            print(f"requested motion {args.motion} @ {args.time}s")
        frames = receive(client, args.frames)
    finally:
        client.close()
    if args.render:
        render(args.render, frames)
    return frames


if __name__ == "__main__":
    main()
