"""PULSE three-stage quality benchmark of the port: teacher -> distilled
student -> prior sampling and downstream Z tasks, held to the JAX package's
committed targets.

The port's arm of the JAX package's `tools/bench_pulse.py`, with the same
flags, defaults and settings:

  stage 1  a PPO imitation teacher (ActorCritic 2048-1536-1024, bf16 trunks)
           on `make_synthetic_clips(num_clips=8)`, then `im_eval` of its
           clipped mean action with early termination off;
  stage 2  online distillation into a float32 PulseVAE (`full_precision`,
           the tool's `PulseVAE` has no compute dtype) on the plain
           imitation env, the teacher's clipped mean action as the label,
           then the student's `im_eval` (z = the posterior mean) and its
           gaps to the teacher;
  stage 3a 256 envs on the cycled reference, without early termination,
           acting for `prior_steps` steps on latents sampled from the
           learned prior: the fraction still upright, and finiteness;
  stage 3b `speed_z` and `reach_z`: AMP (0.5 task, 0.5 style) with a
           1024-512 policy over the frozen decoder, then `task_eval`.

The report keeps every key of `quality/pulse_stages_r5.json` and adds the
device (`port`), nvidia-smi's name and power limit (`gpu`), each stage's
seconds and training env steps/s (`timing`), the training curves every 100
epochs (`curves`) and each committed target of that file with the port's
value and its verdict (`targets`).

Each stage saves its weights and running stats under `--out` (`torch.save`)
and a stage whose snapshot exists is restored, not retrained, so a run can
span several processes; `--stop_after STAGE` ends it after that stage. The
student's snapshot leaves out its critic, which distillation never trains
(it is rebuilt from the seed on restore).

    python -m pulse_tpu_torch.bench_pulse [--teacher_epochs 1000]
        [--distill_epochs 3000] [--task_epochs 800] [--envs 2048]
        [--horizon 32] [--seed 0] [--num_clips 8] [--minibatch 16384]
        [--prior_steps 300] [--out output/pulse_stages]

It runs on the card; `--device cpu`, with `--units` for narrow networks and
`--task_episode_length` for a short task episode, is for the CPU test.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from pathlib import Path

import torch

from pulse_tpu_torch.bench_quality import gpu_line

R5 = Path(__file__).resolve().parent.parent / "quality" / "pulse_stages_r5.json"
STAGES = ("teacher", "student", "prior", "speed_z", "reach_z")
# the report section each committed target's prefix names
TARGET_SECTIONS = {"student": "student", "prior": "prior_sampling", "speed_z": "speed_z", "reach_z": "reach_z"}
CURVE_EVERY = 100
PRIOR_ENVS = 256
PRIOR_RESET_SEED, PRIOR_NOISE_SEED = 3, 4   # the tool's PRNGKey(3) and PRNGKey(4)
TASK_SEED_OFFSET = 7                        # and PRNGKey(seed + 7) for the task agents


def check_targets(report: dict, committed: dict) -> dict:
    """{target: {value, bound, pass}} for each committed target
    `<section>_<key>_{min,max}`: the report's `section[key]` against the
    bound. A missing or non-finite value fails."""
    out = {}
    for name, bound in committed.items():
        stem, kind = name.rsplit("_", 1)
        prefix = next(p for p in TARGET_SECTIONS if stem.startswith(p + "_"))
        value = report.get(TARGET_SECTIONS[prefix], {}).get(stem[len(prefix) + 1:])
        ok = value is not None and math.isfinite(value) and (value <= bound if kind == "max" else value >= bound)
        out[name] = {"value": value, "bound": bound, "pass": ok}
    return out


@torch.no_grad()
def prior_action(net, obs_rms, obs: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """The tool's `prior_step` up to the env step: normalize, take the self
    obs, sample z = prior mu + exp(prior logvar / 2) eps, decode, clip."""
    self_obs = obs_rms.normalize(obs)[..., : net.self_obs_dim]
    prior_mu, prior_logvar = net.prior(self_obs)
    z = prior_mu + torch.exp(0.5 * prior_logvar) * eps
    return torch.clamp(net.decoder(self_obs, z), -1.0, 1.0)


def sample_prior(env, net, obs_rms, state, steps: int, generator: torch.Generator):
    """`steps` env steps from `state` under `prior_action` with eps drawn
    from `generator`; returns the last state."""
    for _ in range(steps):
        eps = torch.randn(state.obs.shape[0], net.latent_dim, generator=generator, device=state.obs.device)
        state = env.step(state, prior_action(net, obs_rms, state.obs, eps))
    return state


def upright_stats(root_z: torch.Tensor, body_pos: torch.Tensor) -> tuple[float, bool]:
    """(fraction of envs whose root is finite and above 0.3 m, whether every
    body position is finite)."""
    upright = (root_z > 0.3) & torch.isfinite(root_z)
    return float(upright.float().mean()), bool(torch.isfinite(body_pos).all())


def _train(name: str, agent, ts, epochs: int, steps_per_epoch: int, keys: tuple, sync):
    """`epochs` of `agent.train_epoch`; returns (ts, seconds, curve of `keys`
    every CURVE_EVERY epochs)."""
    curve = []
    sync()
    t0 = time.time()
    for epoch in range(epochs):
        ts, metrics = agent.train_epoch(ts)
        if epoch % CURVE_EVERY == 0:
            row = {"epoch": epoch, **{k: round(float(metrics[k]), 4) for k in keys}}
            curve.append(row)
            fps = steps_per_epoch * (epoch + 1) / (time.time() - t0)
            print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in row.items()) + f" fps={fps:,.0f}", flush=True)
    sync()
    return ts, time.time() - t0, curve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--teacher_epochs", type=int, default=1000)
    ap.add_argument("--distill_epochs", type=int, default=3000)
    ap.add_argument("--task_epochs", type=int, default=800)
    ap.add_argument("--envs", type=int, default=2048)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num_clips", type=int, default=8)
    ap.add_argument("--minibatch", type=int, default=16384, help="reference default; lower only for CPU smokes")
    ap.add_argument("--prior_steps", type=int, default=300)
    ap.add_argument("--out", default="output/pulse_stages")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--units", default=None,
                    help="every network's hidden widths, e.g. 32,24 (default: the tool's reference widths)")
    ap.add_argument("--task_episode_length", type=int, default=300)
    ap.add_argument("--stop_after", choices=STAGES, default=None,
                    help="end after this stage (its snapshot and the report so far written)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    from pulse_tpu_torch._device import resolve_device
    from pulse_tpu_torch.assets import load_smpl_humanoid
    from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv
    from pulse_tpu_torch.env.humanoid_task import HumanoidReachEnv, HumanoidSpeedEnv, TaskConfig
    from pulse_tpu_torch.env.humanoid_z import FrozenZModel, ZActionWrapper
    from pulse_tpu_torch.eval.im_eval import im_eval
    from pulse_tpu_torch.eval.task_eval import task_eval
    from pulse_tpu_torch.learning.amp import AMPConfig
    from pulse_tpu_torch.learning.amp_agent import AMPAgent
    from pulse_tpu_torch.learning.distill import DistillAgent, DistillConfig
    from pulse_tpu_torch.learning.networks import ActorCritic, PulseVAE
    from pulse_tpu_torch.learning.ppo import PPOAgent, PPOConfig
    from pulse_tpu_torch.learning.running_norm import RunningMeanStd
    from pulse_tpu_torch.motion.motion_lib import build_motion_data
    from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
    from pulse_tpu_torch.physics.model import PhysicsConfig, build_model
    from pulse_tpu_torch.run import DeterministicPolicy, _rms_dict

    device = resolve_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    r5 = json.loads(R5.read_text())
    units = tuple(int(u) for u in args.units.split(",")) if args.units else None

    def widths(default):
        return units or default

    spec = load_smpl_humanoid()
    model = build_model(spec, PhysicsConfig(), device=device)
    clips = make_synthetic_clips(spec.skeleton, num_clips=args.num_clips)
    motion = build_motion_data(spec.skeleton, clips, device=device)
    M = motion.num_motions
    env = HumanoidImEnv(model, motion, EnvConfig(), device=device, seed=args.seed)
    eval_env = env.with_config(dataclasses.replace(env.config, enable_early_termination=False))
    steps_per_epoch = args.envs * args.horizon
    card = torch.cuda.get_device_name(0) if device.type == "cuda" else "CPU"
    report = {"envs": args.envs, "seed": args.seed, "num_clips": M,
              "epochs": {"teacher": args.teacher_epochs, "distill": args.distill_epochs, "task": args.task_epochs},
              "port": device.type, "gpu": gpu_line() if device.type == "cuda" else None, "timing": {}, "curves": {}}

    def ppo_config():
        return PPOConfig(num_envs=args.envs, horizon_length=args.horizon, minibatch_size=args.minibatch,
                         mini_epochs=6, learning_rate=2e-5)

    def restore(path):
        ck = torch.load(path, map_location=device, weights_only=True)
        print(f"[{Path(path).stem}] restored {path}", flush=True)
        return ck

    def timed_eval(fn):
        sync()
        t0 = time.time()
        r = fn()
        sync()
        return r, time.time() - t0

    def record(stage, train_s, curve, epochs, eval_s):
        report["timing"][stage] = {
            "train_s": round(train_s, 2), "eval_s": round(eval_s, 2),
            "train_env_steps_per_s": round(epochs * steps_per_epoch / train_s, 1) if train_s else None}
        report["curves"][stage] = curve

    def finish():
        nets = r5["protocol"]["nets"] if units is None else f"every hidden width {units}"
        report["protocol"] = dict(r5["protocol"], tool="pulse_tpu_torch/bench_pulse.py", nets=nets,
                                  minibatch=args.minibatch,
                                  horizon=args.horizon,
                                  suite=f"make_synthetic_clips(num_clips={M}), seed {args.seed}, one {card}")
        report["committed_targets"] = r5["committed_targets"]
        report["targets"] = check_targets(report, r5["committed_targets"])
        missed = [k for k, v in report["targets"].items() if not v["pass"]]
        print(json.dumps(report, indent=2))
        print("[targets] " + ("all met" if not missed else "missed: " + ", ".join(missed)), flush=True)
        with open(os.path.join(args.out, "pulse_stages.json"), "w") as fh:
            json.dump(report, fh, indent=2)
        return report

    # ---------------- stage 1: teacher ----------------------------------- #
    net = ActorCritic(env.obs_dim, env.action_dim, actor_units=widths((2048, 1536, 1024)),
                      critic_units=widths((2048, 1536, 1024)), device=device, seed=args.seed)
    agent = PPOAgent(env, ppo_config(), net, seed=args.seed)
    snap = os.path.join(args.out, "teacher.pt")
    ts = agent.init()
    if os.path.exists(snap):
        saved = restore(snap)
        net.load_state_dict(saved["network"])
        ts.obs_rms = RunningMeanStd(**saved["obs_rms"])
    else:
        ts, train_s, curve = _train("teacher", agent, ts, args.teacher_epochs, steps_per_epoch, ("reward_mean",),
                                    sync)
        saved = {"network": net.state_dict(), "obs_rms": _rms_dict(ts.obs_rms), "train_s": train_s, "curve": curve}
        torch.save(saved, snap)
    teacher_policy = DeterministicPolicy(net, ts.obs_rms.freeze())
    r_t, eval_s = timed_eval(lambda: im_eval(eval_env, teacher_policy, batch_size=min(M, 64)))
    record("teacher", saved["train_s"], saved["curve"], args.teacher_epochs, eval_s)
    report["teacher"] = {"success_rate": round(r_t.success_rate, 4), "mpjpe_g_mm": round(r_t.mpjpe_g, 2),
                         "mpjpe_pa_mm": round(r_t.mpjpe_pa, 2)}
    print("[teacher]", json.dumps(report["teacher"]), flush=True)
    if args.stop_after == "teacher":
        return finish()

    # ---------------- stage 2: distillation ------------------------------ #
    vae_w = {} if units is None else dict(encoder_units=units, prior_units=units, decoder_units=units,
                                          critic_units=units)
    vae = PulseVAE(env.obs_dim, env.action_dim, self_obs_dim=env.self_obs_dim, full_precision=True, device=device,
                   seed=args.seed + 1, **vae_w)
    dagent = DistillAgent(env, teacher_policy,
                          DistillConfig(num_envs=args.envs, horizon_length=args.horizon,
                                        minibatch_size=args.minibatch, mini_epochs=2,
                                        kld_anneal_start=args.distill_epochs // 2,
                                        kld_anneal_end=args.distill_epochs),
                          vae, seed=args.seed + 1)
    snap = os.path.join(args.out, "student.pt")
    ds = dagent.init()
    if os.path.exists(snap):
        saved = restore(snap)
        missing, unexpected = vae.load_state_dict(saved["network"], strict=False)
        if unexpected or not all(k.startswith("critic") for k in missing):
            raise ValueError(f"{snap}: not a student snapshot (missing {missing}, unexpected {unexpected})")
        ds.obs_rms = RunningMeanStd(**saved["obs_rms"])
    else:
        ds, train_s, curve = _train("distill", dagent, ds, args.distill_epochs, steps_per_epoch,
                                    ("bc_loss", "kld", "reward_mean"), sync)
        trained = {k: v for k, v in vae.state_dict().items() if not k.startswith("critic")}
        saved = {"network": trained, "obs_rms": _rms_dict(ds.obs_rms), "full_precision": vae.full_precision,
                 "train_s": train_s, "curve": curve}
        torch.save(saved, snap)
    s_rms = ds.obs_rms.freeze()

    @torch.no_grad()
    def student_policy(obs):
        # deterministic: z = posterior mean (zero reparam noise)
        zeros = torch.zeros(obs.shape[:-1] + (vae.latent_dim,), device=obs.device)
        return torch.clamp(vae.latent_action(s_rms.normalize(obs), zeros)["action_mu"], -1.0, 1.0)

    r_s, eval_s = timed_eval(lambda: im_eval(eval_env, student_policy, batch_size=min(M, 64)))
    record("student", saved["train_s"], saved["curve"], args.distill_epochs, eval_s)
    report["student"] = {
        "success_rate": round(r_s.success_rate, 4), "mpjpe_g_mm": round(r_s.mpjpe_g, 2),
        "mpjpe_pa_mm": round(r_s.mpjpe_pa, 2),
        "success_gap_vs_teacher": round(r_t.success_rate - r_s.success_rate, 4),
        "mpjpe_pa_gap_mm": round(r_s.mpjpe_pa - r_t.mpjpe_pa, 2),
    }
    print("[student]", json.dumps(report["student"]), flush=True)
    if args.stop_after == "student":
        return finish()

    # ---------------- stage 3a: prior-sampling stability ------------------ #
    free_env = env.with_config(dataclasses.replace(env.config, enable_early_termination=False, cycle_motion=True))
    free_env.generator.manual_seed(PRIOR_RESET_SEED)
    state = free_env.reset(PRIOR_ENVS)
    g = torch.Generator(device=device).manual_seed(PRIOR_NOISE_SEED)
    sync()
    t0 = time.time()
    state = sample_prior(free_env, vae, s_rms, state, args.prior_steps, g)
    upright, finite = upright_stats(state.physics.root_pos[:, 2], state.physics.body_pos)
    sync()
    prior_s = time.time() - t0
    report["timing"]["prior_sampling"] = {"s": round(prior_s, 2),
                                          "env_steps_per_s": round(PRIOR_ENVS * args.prior_steps / prior_s, 1)}
    report["prior_sampling"] = {"envs": PRIOR_ENVS, "steps": args.prior_steps, "upright_frac": round(upright, 4),
                                "finite": finite}
    print("[prior]", json.dumps(report["prior_sampling"]), flush=True)
    if args.stop_after == "prior":
        return finish()

    # ---------------- stage 3b: downstream Z tasks ------------------------ #
    frozen = FrozenZModel(vae, s_rms)

    def train_z_task(name, env_cls):
        task_env = ZActionWrapper(env_cls(model, motion, TaskConfig(episode_length=args.task_episode_length),
                                          device=device, seed=args.seed + TASK_SEED_OFFSET), frozen)
        z_net = ActorCritic(task_env.obs_dim, task_env.action_dim, actor_units=widths((1024, 512)),
                            critic_units=widths((1024, 512)), device=device, seed=args.seed + TASK_SEED_OFFSET)
        z_agent = AMPAgent(task_env, ppo_config(), AMPConfig(task_reward_w=0.5, disc_reward_w=0.5), z_net,
                           seed=args.seed + TASK_SEED_OFFSET)
        snap = os.path.join(args.out, f"{name}.pt")
        zts = z_agent.init()
        if os.path.exists(snap):
            saved = restore(snap)
            z_net.load_state_dict(saved["network"])
            zts.ppo.obs_rms = RunningMeanStd(**saved["obs_rms"])
        else:
            zts, train_s, curve = _train(name, z_agent, zts, args.task_epochs, steps_per_epoch,
                                         ("reward_mean", "task_reward_mean", "disc_reward_mean"), sync)
            saved = {"network": z_net.state_dict(), "obs_rms": _rms_dict(zts.ppo.obs_rms), "train_s": train_s,
                     "curve": curve}
            torch.save(saved, snap)
        z_policy = DeterministicPolicy(z_net, zts.ppo.obs_rms.freeze())
        r, eval_s = timed_eval(lambda: task_eval(task_env, z_policy, batch_size=min(args.envs, 512)))
        record(name, saved["train_s"], saved["curve"], args.task_epochs, eval_s)
        out = {"return_mean": round(r.return_mean, 2), "length_mean": round(r.length_mean, 1),
               "terminate_rate": round(r.terminate_rate, 4), "reward_per_step": round(r.reward_per_step, 4)}
        print(f"[{name}]", json.dumps(out), flush=True)
        return out

    report["speed_z"] = train_z_task("speed_z", HumanoidSpeedEnv)
    if args.stop_after == "speed_z":
        return finish()
    report["reach_z"] = train_z_task("reach_z", HumanoidReachEnv)
    return finish()


if __name__ == "__main__":
    main()
