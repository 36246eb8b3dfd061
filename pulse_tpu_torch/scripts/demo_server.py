"""Live demo server: stream sim frames, accept driving poses and clip
switches.

Counterpart of `scripts/demo_server.py` (≙ the reference's server mode and
demo stack, base_task.py:254-316 and humanoid_im_demo.py): a policy rolls
one HumanoidIm env while a TCP thread (`utils/pose_server.py`) broadcasts
each step's frame {"t", "body_pos", "reward"} to every connected viewer. A
client may send
  {"cmd": "motion", "id": k, "time": t}   the env is reset onto clip
                                          k mod num_motions at t seconds
  {"cmd": "pose", "root_pos": [3], "root_rot": [4] xyzw, "dof_pos": [69]}
                                          the physics state is set to that
                                          pose (kinematic drive), the rest
                                          of the env state kept
and the policy steps on from there.

    python -m pulse_tpu_torch.scripts.demo_server [--port 8765] [--steps 1000]
        [--ckpt output/<exp>/ckpt] [--device cpu]

The policy is a PPO ActorCritic restored from a port run's checkpoint
(`scripts/common.load_policy`), else a fresh reference-width one from seed
0; it acts with its clipped mean action. Viewer: `PoseClient(port=...)
.recv()`, or `python -m pulse_tpu_torch.scripts.demo_client`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def apply_command(env, state, cmd: dict | None):
    """The env state after a client command (unchanged for None or an
    unknown command)."""
    from pulse_tpu_torch.physics.state import state_from_kinematics

    if not cmd:
        return state
    dev = env.device
    if cmd.get("cmd") == "motion":
        # interactive clip switching (≙ HumanoidImDemo driving a chosen
        # clip): the env reset onto the clip and time asked for
        mid = torch.tensor([int(cmd.get("id", 0)) % int(env.motion.num_motions)], dtype=torch.long, device=dev)
        t0 = torch.tensor([float(cmd.get("time", 0.0))], dtype=torch.float32, device=dev)
        return env.reset_to(mid, t0)
    if cmd.get("cmd") == "pose":
        # kinematic drive toward the streamed pose: the physics state's
        # root and dof set directly (≙ HACK_MOTION_SYNC), at rest
        def row(key, default):
            return torch.as_tensor(np.asarray(cmd.get(key, default), np.float32), device=dev)[None]

        D = env.action_dim
        zeros3 = torch.zeros(1, 3, device=dev)
        physics = state_from_kinematics(env.model, row("root_pos", [0, 0, 0.94]), row("root_rot", [0, 0, 0, 1.0]),
                                        row("dof_pos", np.zeros(D)), zeros3, zeros3, torch.zeros(1, D, device=dev))
        return state.replace(physics=physics)
    return state


def demo_loop(env, policy, server, steps: int, state=None, on_command=None):
    """`steps` policy steps of one env, each after the latest client
    command (if any) is applied, each step's frame published. With
    `on_command(i, cmd, state)` the state a command made is handed over
    before step i runs on it. Returns the last state."""
    if state is None:
        state = env.reset(1)
    for i in range(steps):
        cmd = server.poll_command()
        if cmd:
            state = apply_command(env, state, cmd)
            if on_command is not None:
                on_command(i, cmd, state)
        state = env.step(state, policy(state.obs))
        server.publish({"t": i / 30.0, "body_pos": state.physics.body_pos[0].tolist(),
                        "reward": float(state.reward[0])})
    return state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None, help="the env's and the policy's device (default: the card)")
    args = ap.parse_args(argv)

    from pulse_tpu_torch.scripts.common import load_policy, make_env
    from pulse_tpu_torch.utils.pose_server import PoseServer

    env = make_env(args.device)
    policy = load_policy(env, args.ckpt)
    server = PoseServer(port=args.port)
    print(f"demo server on port {server.port}", flush=True)
    t0 = time.perf_counter()
    try:
        demo_loop(env, policy, server, args.steps)
    finally:
        server.close()
    print(f"{args.steps} steps, {1e3 * (time.perf_counter() - t0) / max(args.steps, 1):.2f} ms a step")


if __name__ == "__main__":
    main()
