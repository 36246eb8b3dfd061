"""Record a policy rollout to .npz for offline visualization.

Counterpart of `scripts/record_rollout.py` (≙ the reference's
HACK_OUTPUT_MOTION state dumps, humanoid_amp.py:785-831, and its video
recording, base_task.py:404-445, headless): a trained (or fresh) PPO policy
runs the HumanoidIm env and each step's body positions and rotations are
dumped; `pulse_tpu_torch.scripts.play_motion --render` style tooling draws
them.

    python -m pulse_tpu_torch.scripts.record_rollout [--ckpt output/<exp>/ckpt]
        [--steps 300] [--num_envs 4] [--out rollout.npz] [--device cpu]

The .npz holds body_pos / body_rot [T, 24, 3|4] of env 0, all_body_pos
[T, B, 24, 3], rewards [T, B], node_names and parents, as the JAX script's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pulse_tpu_torch.assets import load_smpl_humanoid


def record(env, policy, num_envs: int, steps: int) -> dict:
    """`steps` policy steps from a reset of `num_envs` envs -> the arrays of
    the .npz."""
    state = env.reset(num_envs)
    pos, rot, rewards = [], [], []
    for _ in range(steps):
        state = env.step(state, policy(state.obs))
        pos.append(state.physics.body_pos)
        rot.append(state.physics.body_rot)
        rewards.append(state.reward)
    pos = torch.stack(pos).cpu().numpy()
    tree = load_smpl_humanoid().skeleton
    return {"body_pos": pos[:, 0],   # the first env, for the renderer
            "body_rot": torch.stack(rot)[:, 0].cpu().numpy(),
            "all_body_pos": pos,
            "rewards": torch.stack(rewards).cpu().numpy(),
            "node_names": np.asarray(tree.node_names),
            "parents": tree.parent_indices}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--num_envs", type=int, default=4)
    ap.add_argument("--out", default="rollout.npz")
    ap.add_argument("--device", default=None, help="the env's and the policy's device (default: the card)")
    args = ap.parse_args(argv)

    from pulse_tpu_torch.scripts.common import load_policy, make_env

    env = make_env(args.device)
    out = record(env, load_policy(env, args.ckpt), args.num_envs, args.steps)
    np.savez(args.out, **out)
    print(f"wrote {args.out}: {args.steps} frames, mean reward {out['rewards'].mean():.3f}")
    return out


if __name__ == "__main__":
    main()
