"""Training-quality benchmark of the port: train an imitation policy on the
hard synthetic suite (or the 30-clip graded suite) and report per-clip
success and MPJPE.

The port's arm of the JAX package's `tools/bench_quality.py`, with the
same flags, defaults and settings: `PhysicsConfig()` and `EnvConfig()`
defaults, PPO with minibatch 16384, 6 mini-epochs and lr 2e-5, an
ActorCritic of 2048-1536-1024, and an eval with early termination off and
one env per clip. Its JSON keeps that tool's keys, so the two arms compare
line by line (quality/ab_*_r5.json against quality/ab_torch_r6.json). In
place of `pallas` it records the device (`port`) and, on the card,
nvidia-smi's name and power limit. It adds the training curve
(`reward_mean` every 100 epochs) and the eval's seconds.

    python -m pulse_tpu_torch.bench_quality [--epochs 1500] [--envs 2048]
        [--horizon 32] [--seed 0] [--suite hard|graded] [--out FILE]

It runs on the card; `--device cpu` (with `--units` for a narrow network)
is for the CPU test.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch


def gpu_line() -> str | None:
    """nvidia-smi's `name, power.limit` of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=1500)
    ap.add_argument("--envs", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--suite", choices=["hard", "graded"], default="hard",
                    help="hard: 6-clip v2 stress set; graded: 30-clip family benchmark")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--units", default="2048,1536,1024", help="actor and critic hidden widths")
    args = ap.parse_args(argv)

    from pulse_tpu_torch._device import resolve_device
    from pulse_tpu_torch.assets import load_smpl_humanoid
    from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv
    from pulse_tpu_torch.eval.im_eval import im_eval
    from pulse_tpu_torch.learning.networks import ActorCritic
    from pulse_tpu_torch.learning.ppo import PPOAgent, PPOConfig
    from pulse_tpu_torch.motion.motion_lib import build_motion_data
    from pulse_tpu_torch.motion.synthetic import make_graded_suite, make_hard_clips
    from pulse_tpu_torch.physics.model import PhysicsConfig, build_model
    from pulse_tpu_torch.run import _policy_fn

    device = resolve_device(args.device)
    spec = load_smpl_humanoid()
    model = build_model(spec, PhysicsConfig(), device=device)
    if args.suite == "graded":
        clips, names, families = make_graded_suite(spec.skeleton)
        suite_label = "graded_v1"
    else:
        clips, names = make_hard_clips(spec.skeleton)
        families = None
        suite_label = "hard_synthetic_v2"
    motion = build_motion_data(spec.skeleton, clips, device=device)

    env = HumanoidImEnv(model, motion, EnvConfig(), device=device, seed=args.seed)
    units = tuple(int(u) for u in args.units.split(","))
    net = ActorCritic(env.obs_dim, env.action_dim, actor_units=units, critic_units=units, device=device,
                      seed=args.seed)
    # reference net sizes + im defaults (im_z_fit.yaml)
    agent = PPOAgent(
        env,
        PPOConfig(num_envs=args.envs, horizon_length=args.horizon, minibatch_size=16384, mini_epochs=6,
                  learning_rate=2e-5),
        net,
        seed=args.seed + 1,
    )
    ts = agent.init()

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.time()
    steps_per_epoch = args.envs * args.horizon
    curve = []
    for epoch in range(args.epochs):
        ts, metrics = agent.train_epoch(ts)
        if epoch % 100 == 0:
            r = float(metrics["reward_mean"])
            fps = steps_per_epoch * (epoch + 1) / (time.time() - t0)
            curve.append({"epoch": epoch, "reward_mean": round(r, 4)})
            print(f"epoch={epoch} reward={r:.4f} fps={fps:,.0f}", flush=True)
    sync()
    train_time = time.time() - t0

    # deterministic-policy eval with early termination off
    eval_env = env.with_config(dataclasses.replace(env.config, enable_early_termination=False))
    t1 = time.time()
    result = im_eval(eval_env, _policy_fn(ts), batch_size=len(names))
    eval_time = time.time() - t1

    out = {
        "suite": suite_label,
        "port": device.type,
        "gpu": gpu_line() if device.type == "cuda" else None,
        "epochs": args.epochs,
        "envs": args.envs,
        "seed": args.seed,
        "train_steps": args.epochs * steps_per_epoch,
        "train_time_s": round(train_time, 1),
        "train_steps_per_s": round(args.epochs * steps_per_epoch / train_time, 1),
        "eval_time_s": round(eval_time, 2),
        "success_rate": round(result.success_rate, 4),
        "mpjpe_g_mm": round(result.mpjpe_g, 2),
        "mpjpe_l_mm": round(result.mpjpe_l, 2),
        "mpjpe_pa_mm": round(result.mpjpe_pa, 2),
        "per_clip": {
            n: {
                "success": bool(~result.failed_motions[i]),
                "mpjpe_g_mm": round(float(result.per_motion_mpjpe_g[i]), 2),
                "mpjpe_l_mm": round(float(result.per_motion_mpjpe_l[i]), 2),
            }
            for i, n in enumerate(names)
        },
        "curve": curve,
    }
    if families is not None:
        out["per_family"] = {
            fam: {
                "passed": int(sum(~result.failed_motions[i] for i in idx)),
                "levels": {names[i]: bool(~result.failed_motions[i]) for i in idx},
            }
            for fam, idx in families.items()
        }
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)
    return out


if __name__ == "__main__":
    main()
