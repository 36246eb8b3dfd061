"""Legacy argparse entry: the reference's pre-Hydra flag surface mapped
onto the port's config tree.

Counterpart of `pulse_tpu/legacy_cli.py` (≙ phc/run.py:220 and
phc/utils/config.py:208-473, get_args' custom_parameters). Users of the
reference's old CLI

    python phc/run.py --task HumanoidIm --cfg_env phc_im \\
        --motion_file data/amass_isaac.pkl --num_envs 1024 --test --epoch -1

run the same invocation here:

    python -m pulse_tpu_torch.legacy_cli --task HumanoidIm \\
        --motion_file data/amass_isaac.pkl --num_envs 1024 --test --epoch -1 [--device cpu]

Each recognized flag becomes the equivalent dotted override of
`pulse_tpu_torch.run`, the same overrides the JAX package's translation
gives; Isaac-only flags (--rl_device, --headless, --no_virtual_display, ...)
are accepted and reported as no-ops so old launch scripts keep working.
`--device` (the port's own; default the card) becomes `device=`.
"""

from __future__ import annotations

import argparse

# --task values the reference registers (phc/run.py parse_task) -> the env
# config groups (pulse_tpu_torch/configs/env/*.yaml)
_TASK_TO_ENV = {
    "Humanoid": "im",
    "HumanoidIm": "im",
    "HumanoidImDemo": "im",
    "HumanoidImZ": "im_z",
    "HumanoidImGetup": "im_getup",
    "HumanoidImMCP": "im_mcp",
    "HumanoidImMCPDemo": "im_mcp",
    "HumanoidImMCPGetup": "im_mcp_getup",
    "HumanoidImDistill": "im_vae",
    "HumanoidImDistillGetup": "im_vae",
    "HumanoidAMP": "amp",
    "HumanoidAMPGetup": "amp_getup",
    "HumanoidSpeed": "speed",
    "HumanoidSpeedZ": "speed_z",
    "HumanoidReach": "reach",
    "HumanoidReachZ": "reach_z",
    "HumanoidStrike": "strike",
    "HumanoidStrikeZ": "strike_z",
    "HumanoidTraj": "traj",
    "HumanoidTrajZ": "traj_z",
    "HumanoidPedestrianTerrain": "pedestrian_terrain",
    "HumanoidPedestrianTerrainZ": "pedestrian_terrain",
}

# env group -> its default learning group
_ENV_TO_LEARNING = {
    "im": "im_ppo",
    "im_getup": "im_ppo",
    "im_shape": "im_ppo",
    "im_mcp": "im_ppo",
    "im_mcp_getup": "im_ppo",
    "im_z": "pulse_z_task",
    "amp": "im_amp",
    "amp_getup": "im_amp",
    "im_vae": "im_z_fit",
    "speed": "pulse_z_task",
    "speed_z": "pulse_z_task",
    "reach": "pulse_z_task",
    "reach_z": "pulse_z_task",
    "strike": "pulse_z_task",
    "strike_z": "pulse_z_task",
    "traj": "pulse_z_task",
    "traj_z": "pulse_z_task",
    "pedestrian_terrain": "pulse_z_task",
}

# accepted no-op switches (Isaac Gym / rendering concerns)
_NO_OP_SWITCHES = ("debug", "headless", "horovod", "torch_deterministic", "follow", "real_traj", "show_sensors",
                   "no_virtual_display", "render_o3d", "demo")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pulse_tpu_torch legacy CLI (reference get_args flag surface)")
    # flags with a translation
    p.add_argument("--task", default="HumanoidIm")
    p.add_argument("--cfg_env", default="")
    p.add_argument("--cfg_train", default="")
    p.add_argument("--motion_file", default="")
    p.add_argument("--num_envs", type=int, default=0)
    p.add_argument("--episode_length", type=int, default=0)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max_iterations", type=int, default=0)
    p.add_argument("--horizon_length", type=int, default=-1)
    p.add_argument("--minibatch_size", type=int, default=-1)
    p.add_argument("--test", action="store_true")
    p.add_argument("--play", action="store_true")
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--checkpoint", default="Base")
    p.add_argument("--experiment", default="Base")
    p.add_argument("--logdir", default="logs/")
    p.add_argument("--network_path", default="output/")
    p.add_argument("--im_eval", action="store_true")
    p.add_argument("--has_eval", action="store_true")
    p.add_argument("--no_log", action="store_true")
    p.add_argument("--randomize", action="store_true")
    p.add_argument("--add_proj", action="store_true")
    p.add_argument("--small_terrain", action="store_true")
    p.add_argument("--server_mode", action="store_true")
    p.add_argument("--device", default=None, help="the run's device (default: the card)")
    # accepted no-ops
    for flag in _NO_OP_SWITCHES:
        p.add_argument(f"--{flag}", action="store_true")
    p.add_argument("--rl_device", default="")
    p.add_argument("--task_type", default="")
    p.add_argument("--metadata", action="store_true")
    p.add_argument("--llc_checkpoint", default="")
    p.add_argument("--resume_str", default=None)
    p.add_argument("--num_proc", type=int, default=1)
    return p


def translate(args: argparse.Namespace) -> list[str]:
    """Parsed legacy flags -> pulse_tpu_torch.run dotted overrides."""
    env = _TASK_TO_ENV.get(args.task)
    if env is None:
        raise SystemExit(f"unknown --task {args.task!r}; known: {sorted(_TASK_TO_ENV)}")
    if args.cfg_env:
        # the reference points --cfg_env at a YAML name; the env group names
        # are accepted directly
        env = args.cfg_env
    learning = args.cfg_train or _ENV_TO_LEARNING.get(env, "im_ppo")
    ov = [f"env={env}", f"learning={learning}"]
    if args.llc_checkpoint:
        # ≙ cfg.llc_checkpoint -> load_pnn (humanoid_im_mcp.py:28-42), only
        # to a key the env group declares: the MCP groups' pnn_checkpoint,
        # the Z groups' z_checkpoint (their frozen decoder); elsewhere the
        # reference treats the flag as inert
        if env in ("im_mcp", "im_mcp_getup"):
            ov.append(f"env.pnn_checkpoint={args.llc_checkpoint}")
        elif env in ("im_z", "speed_z", "reach_z", "strike_z", "traj_z"):
            ov.append(f"env.z_checkpoint={args.llc_checkpoint}")
        else:
            print(f"note: --llc_checkpoint accepted but ignored for env group {env!r} (only MCP/Z tasks consume it)")
    elif args.task in ("HumanoidImMCP", "HumanoidImMCPGetup", "HumanoidImMCPDemo"):
        print("note: MCP tasks need --llc_checkpoint <pth> (-> env.pnn_checkpoint); falling back to a fresh PNN")
    if args.motion_file:
        ov.append(f"env.motion_file={args.motion_file}")
    if args.num_envs:
        ov.append(f"num_envs={args.num_envs}")
    if args.episode_length:
        ov.append(f"env.episode_length={args.episode_length}")
    if args.seed is not None:
        ov.append(f"seed={args.seed}")
    if args.max_iterations:
        ov.append(f"max_epochs={args.max_iterations}")
    if args.horizon_length > 0:
        ov.append(f"learning.horizon_length={args.horizon_length}")
    if args.minibatch_size > 0:
        ov.append(f"learning.minibatch_size={args.minibatch_size}")
    if args.test or args.play or args.im_eval:
        ov.append("test=true")
    if args.epoch:
        ov.append(f"epoch={args.epoch}")
    if args.experiment != "Base":
        ov.append(f"exp_name={args.experiment}")
    if args.network_path != "output/":
        ov.append(f"output_dir={args.network_path}")
    if args.has_eval:
        ov.append("eval_frequency=1000")
    if args.randomize:
        ov.append("env.obs_noise_std=0.01")
    if args.add_proj:
        print("note: projectile perturbations -> HumanoidImPerturbEnv through the library API "
              "(pulse_tpu_torch/env/humanoid_im_perturb.py)")
    if args.server_mode:
        print("note: server mode -> python -m pulse_tpu_torch.scripts.demo_server")
    if args.device:
        ov.append(f"device={args.device}")
    ignored = [f for f in _NO_OP_SWITCHES if getattr(args, f)]
    if args.rl_device:
        ignored.append("rl_device")
    if ignored:
        print(f"legacy flags accepted but not applicable: {ignored}")
    return ov


def main(argv=None):
    overrides = translate(build_parser().parse_args(argv))
    print("pulse_tpu_torch.run", " ".join(overrides))
    from pulse_tpu_torch import run

    return run.main(overrides)


if __name__ == "__main__":
    main()
