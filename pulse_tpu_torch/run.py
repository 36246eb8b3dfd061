"""CLI entry point: config-driven PPO / AMP training, PULSE distillation and
downstream tasks in PULSE's latent space.

Counterpart of `pulse_tpu/run.py`:

    python -m pulse_tpu_torch.run env=im_getup learning=im_ppo num_envs=3072
    python -m pulse_tpu_torch.run env=im_vr learning=im_ppo num_envs=3072
    python -m pulse_tpu_torch.run env=amp learning=im_amp num_envs=3072
    python -m pulse_tpu_torch.run env=im_mcp learning=im_ppo num_envs=3072
    python -m pulse_tpu_torch.run env=im learning=im_amp env.randomize=true num_envs=3072
    python -m pulse_tpu_torch.run env=im_vae learning=im_z_fit num_envs=3072 \
        learning.teacher_checkpoint=output/<exp>/ckpt
    python -m pulse_tpu_torch.run env=speed_z learning=pulse_z_task num_envs=3072 \
        env.z_checkpoint=output/<distill exp>/ckpt
    python -m pulse_tpu_torch.run env=strike learning=pulse_z_task num_envs=3072
    python -m pulse_tpu_torch.run env=pedestrian_terrain learning=pulse_z_task num_envs=3072
    python -m pulse_tpu_torch.run env=im_mcp learning=im_ppo env.pnn_checkpoint=<PHC pnn>.pth
    python -m pulse_tpu_torch.run env=im learning=im_ppo env.motion_file=<amass_isaac_train>.pkl

composes the YAML config tree (`utils/config.py`), builds the model, the
motion store (the clips of `env.motion_file`: a `.npz`, a `.mtn` archive or
the reference's converted-AMASS `.pkl`, read without joblib; else synthetic
clips), the env and the agent (PPO, PPO with the AMP
discriminator, or distillation of a frozen PPO teacher into a PulseVAE),
and runs the epoch loop (calling the agent's `pre_epoch` schedule before
each epoch where it has one) with JSONL metric lines every
`log_frequency` epochs and `torch.save` checkpoints of the train state
every `save_frequency` epochs and at the end.
With `epoch` not 0 the latest checkpoint of the experiment is restored.
`device=cpu` runs the kernels' plain PyTorch versions on the CPU, and
`env.use_pallas_physics=false` runs them on the card.

`test=true` evaluates the (restored) policy instead of training: `im_eval`
over every clip with early termination off on an imitation env, the
episode returns of `task_eval` on a task env, printed as JSON. With
`eval_frequency=N` im_eval runs every N epochs of training on an
imitation env, and the
clips it failed become the only ones the env's resets sample (PMCP
hard-negative mining); the weights are not checkpointed, so a resumed run
starts uniform.

Ported: the HumanoidIm and HumanoidImGetup tasks (and their distillation
names HumanoidImDistill and HumanoidImDistillGetup, and the demo names
HumanoidImDemo and HumanoidImMCPDemo of HumanoidIm and HumanoidImMCP, which
`scripts/demo_server.py` drives live), the pure-AMP tasks
HumanoidAMP and HumanoidAMPGetup (`env=amp`, `env=amp_getup`) and the MCP
tasks HumanoidImMCP and HumanoidImMCPGetup (`env=im_mcp`,
`env=im_mcp_getup`: composer weights over a frozen PNN, which without
`env.pnn_checkpoint` is drawn fresh from the seed), with `agent: ppo`,
`agent: amp` (`learning=im_amp`) or `agent: distill`, every observation,
state-init, far-goal, occlusion and noise option of theirs (`env=im_vr`:
VR three-point tracking), the isaac_pd, pd and force control modes
(`env.control_mode`), domain randomization (`env.randomize=true` with
`env.randomization_params`), and HumanoidIm with per-env body
shapes (`env=im_shape`: isotropic scales, or SMPL-beta skeletons with
`env.smpl_model_path`, also under the four getup tasks with
`env.shape_variation=true`); PULSE's downstream tasks HumanoidSpeed,
HumanoidReach, HumanoidTraj, HumanoidStrike and HumanoidPedestrianTerrain
(`env=speed`, `env=reach`, `env=traj`, `env=strike`,
`env=pedestrian_terrain`), and with latent actions decoded by a frozen
PulseVAE their Z names and HumanoidImZ (`env=speed_z`, ..., `env=strike_z`,
`env.task=HumanoidPedestrianTerrainZ`, `env=im_z`; `env.z_checkpoint` one of
the port's distillation runs or a reference PULSE `.pth`, else a fresh
PulseVAE from seed 0), trained with `learning=pulse_z_task`. The reference's
PHC `.pth` checkpoints load as the MCP envs' frozen PNN
(`env.pnn_checkpoint`) and as the PNN and composer teacher of distillation
(`learning.teacher_pnn_checkpoint`, `learning.teacher_composer_checkpoint`).
A checkpoint file is read as a reference one by its content (a "model"
dict of `a2c_network.*` keys), not by its suffix as the JAX package does,
which would take the port's own `epoch_N.pt` for one. Other tasks raise
ValueError. The distill agent has no evaluator: `test=true` and `eval_frequency`
raise with it.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import sys
import time

import torch

# the demo task names: the same envs, driven live by scripts/demo_server.py
# (≙ pulse_tpu/run.py's im_plain registry)
_DEMO_TASKS = {"HumanoidImDemo": "HumanoidIm", "HumanoidImMCPDemo": "HumanoidImMCP"}
# the downstream task envs, and their latent-action (Z) names
_TASK_ENVS = ("HumanoidSpeed", "HumanoidReach", "HumanoidTraj", "HumanoidStrike", "HumanoidPedestrianTerrain")


def build_model_from_cfg(cfg, device):
    from pulse_tpu_torch.assets import load_smpl_humanoid
    from pulse_tpu_torch.physics.model import PhysicsConfig, build_model

    sim = cfg["sim"]
    pc = PhysicsConfig(
        dt=float(sim["dt"]),
        substeps=int(sim["substeps"]),
        control_freq_inv=int(sim["control_freq_inv"]),
        gravity=float(sim["gravity"]),
        contact_stiffness=float(sim["contact_stiffness"]),
        contact_damping=float(sim["contact_damping"]),
        friction_regularization=float(sim["friction_regularization"]),
        limit_stiffness=float(sim["limit_stiffness"]),
        limit_damping=float(sim["limit_damping"]),
        kp_scale=float(sim["kp_scale"]),
        kd_scale=float(sim["kd_scale"]),
    )
    spec = load_smpl_humanoid()
    return spec, build_model(spec, pc, device=device)


def build_motion_from_cfg(cfg, spec, device):
    """The clips of `env.motion_file` (.npz, .mtn, .pkl / .pk), else
    `env.num_synthetic_clips` synthetic ones, as a store on `device`."""
    from pulse_tpu_torch.motion.loader import load_motion_file
    from pulse_tpu_torch.motion.motion_lib import build_motion_data
    from pulse_tpu_torch.motion.synthetic import make_synthetic_clips

    motion_file = cfg["env"].get("motion_file", "")
    if motion_file:
        clips = load_motion_file(motion_file, spec.skeleton)
    else:
        clips = make_synthetic_clips(spec.skeleton, num_clips=int(cfg["env"].get("num_synthetic_clips", 4)))
    return build_motion_data(spec.skeleton, clips, device=device)


def _build_dr(e):
    """env.randomize + env.randomization_params -> DRConfig, or None."""
    if not bool(e.get("randomize", False)):
        return None
    from pulse_tpu_torch.env.domain_rand import dr_config_from_dict

    return dr_config_from_dict(dict(e.get("randomization_params") or {}))


def build_env_from_cfg(cfg, model, motion, device):
    from pulse_tpu_torch.env.humanoid_im import DEFAULT_KEY_BODIES, DEFAULT_RESET_BODIES, EnvConfig, HumanoidImEnv
    from pulse_tpu_torch.env.humanoid_amp_getup import HumanoidAMPEnv, HumanoidAMPGetupEnv
    from pulse_tpu_torch.env.humanoid_im_getup import GetupConfig, HumanoidImGetupEnv
    from pulse_tpu_torch.env.humanoid_im_mcp import HumanoidImMCPEnv, HumanoidImMCPGetupEnv

    e = cfg["env"]
    task = _DEMO_TASKS.get(e["task"], e["task"])
    if task.removesuffix("Z") in _TASK_ENVS:
        return build_task_env_from_cfg(cfg, model, motion, device)
    # the distillation tasks are the imitation envs under another name;
    # HumanoidImZ is HumanoidIm with latent actions
    getup = task in ("HumanoidImGetup", "HumanoidImDistillGetup", "HumanoidAMPGetup", "HumanoidImMCPGetup")
    if not getup and task not in ("HumanoidIm", "HumanoidImDistill", "HumanoidAMP", "HumanoidImMCP", "HumanoidImZ"):
        raise ValueError(f"unknown task {task!r}")
    common = dict(
        termination_distance=float(e["termination_distance"]),
        enable_early_termination=bool(e["enable_early_termination"]),
        use_mean_termination=bool(e["use_mean_termination"]),
        num_traj_samples=int(e["num_traj_samples"]),
        traj_sample_timestep=float(e["traj_sample_timestep"]),
        local_root_obs=bool(e["local_root_obs"]),
        root_height_obs=bool(e["root_height_obs"]),
        state_init=str(e["state_init"]),
        hybrid_init_prob=float(e["hybrid_init_prob"]),
        episode_length=int(e["episode_length"]),
        power_reward=bool(e["power_reward"]),
        power_coefficient=float(e["power_coefficient"]),
        cycle_motion=bool(e["cycle_motion"]),
        control_mode=str(e.get("control_mode", "isaac_pd")),
        use_pallas_physics=bool(e.get("use_pallas_physics", True)),
        power_scale=float(e.get("power_scale", 1.0)),
        obs_v=int(e.get("obs_v", 6)),
        self_obs_v=int(e.get("self_obs_v", 1)),
        self_obs_hist_steps=int(e.get("self_obs_hist_steps", 5)),
        obs_noise_std=float(e.get("obs_noise_std", 0.0)),
        zero_out_far=bool(e.get("zero_out_far", False)),
        zero_out_far_distance=float(e.get("zero_out_far_distance", 5.0)),
        occlusion_prob=float(e.get("occlusion_prob", 0.0)),
        occlusion_frac=float(e.get("occlusion_frac", 0.25)),
        num_amp_obs_steps=int(e.get("num_amp_obs_steps", 10)),
        amp_obs_v=int(e.get("amp_obs_v", 1)),
        has_shape_obs=bool(e.get("has_shape_obs", False)),
        has_shape_obs_disc=bool(e.get("has_shape_obs_disc", False)),
        has_limb_weight_obs=bool(e.get("has_limb_weight_obs", False)),
        key_bodies=tuple(e["key_bodies"]) if e.get("key_bodies") else DEFAULT_KEY_BODIES,
        reset_bodies=tuple(e["reset_bodies"]) if e.get("reset_bodies") else DEFAULT_RESET_BODIES,
        track_bodies=tuple(e["track_bodies"]) if e.get("track_bodies") else None,
        dr=_build_dr(e),
        **{k: float(v) for k, v in (e.get("reward_specs") or {}).items()},
    )
    seed = int(cfg["seed"])
    amp_kw = {"termination_height": float(e.get("termination_height", 0.15))}
    if not getup:
        ec = EnvConfig(**common)
        if task == "HumanoidAMP":
            env = HumanoidAMPEnv(model, motion, ec, device=device, seed=seed, **amp_kw)
        elif task == "HumanoidImMCP":
            pnn, pnn_rms = build_pnn_from_cfg(cfg, model, motion, ec, device)
            env = HumanoidImMCPEnv(model, motion, ec, device=device, seed=seed, pnn=pnn, obs_rms=pnn_rms)
        else:
            env = HumanoidImEnv(model, motion, ec, device=device, seed=seed)
    else:
        gc = GetupConfig(
            recovery_steps=int(e.get("recovery_steps", 90)),
            recovery_episode_prob=float(e.get("recovery_episode_prob", 0.3)),
            fall_init_prob=float(e.get("fall_init_prob", 0.1)),
            num_fall_states=int(e.get("num_fall_states", 256)),
            fall_settle_steps=int(e.get("fall_settle_steps", 60)),
            **common,
        )
        if task == "HumanoidAMPGetup":
            env = HumanoidAMPGetupEnv(model, motion, gc, device=device, seed=seed, **amp_kw)
        elif task == "HumanoidImMCPGetup":
            pnn, pnn_rms = build_pnn_from_cfg(cfg, model, motion, gc, device)
            env = HumanoidImMCPGetupEnv(model, motion, gc, device=device, seed=seed, pnn=pnn, obs_rms=pnn_rms)
        else:
            env = HumanoidImGetupEnv(model, motion, gc, device=device, seed=seed)
    if bool(e.get("shape_variation", False)):
        # per-env body shapes (PHC's has_shape_variation), drawn from a
        # stream of their own as the JAX package's seed + 7 key; a getup
        # env keeps the fall states it settled under the shared model
        smpl = None
        if str(e.get("smpl_model_path", "") or ""):
            from pulse_tpu_torch.smpl.body_model import load_smpl_model

            smpl = load_smpl_model(str(e["smpl_model_path"]))
        env.enable_shape_variation(int(cfg["num_envs"]), smpl_model=smpl,
                                   beta_std=float(e.get("shape_beta_std", 1.0)),
                                   generator=torch.Generator(device=env.device).manual_seed(seed + 7))
    env = _randomize_props(cfg, env)
    return wrap_env_z(cfg, env) if task == "HumanoidImZ" else env


def _randomize_props(cfg, env):
    """DR's per-env physical props (after any shape variation), drawn from
    a stream of their own, as the JAX package's seed + 11 key."""
    if env.config.dr is not None:
        env.randomize_physical_props(int(cfg["num_envs"]),
                                     generator=torch.Generator(device=env.device).manual_seed(int(cfg["seed"]) + 11))
    return env


def build_task_env_from_cfg(cfg, model, motion, device):
    """A speed, reach, traj, strike or pedestrian-terrain env (`env=speed`
    ...), wrapped with the frozen PULSE decoder for the Z names
    (`env=speed_z` ...)."""
    from pulse_tpu_torch.env.humanoid_strike import HumanoidStrikeEnv
    from pulse_tpu_torch.env.humanoid_task import HumanoidReachEnv, HumanoidSpeedEnv, HumanoidTrajEnv, TaskConfig
    from pulse_tpu_torch.env.humanoid_terrain import HumanoidPedestrianTerrainEnv

    e = cfg["env"]
    task = e["task"]
    kw = dict(episode_length=int(e["episode_length"]), termination_height=float(e.get("termination_height", 0.15)),
              enable_early_termination=bool(e["enable_early_termination"]))
    base = task.removesuffix("Z")
    if base == "HumanoidSpeed":
        kw.update(tar_speed_min=float(e.get("tar_speed_min", 0.0)), tar_speed_max=float(e.get("tar_speed_max", 5.0)))
    elif base == "HumanoidReach":
        kw.update(reach_body=str(e.get("reach_body", "R_Hand")))
    cls = {"HumanoidSpeed": HumanoidSpeedEnv, "HumanoidReach": HumanoidReachEnv, "HumanoidTraj": HumanoidTrajEnv,
           "HumanoidStrike": HumanoidStrikeEnv, "HumanoidPedestrianTerrain": HumanoidPedestrianTerrainEnv}[base]
    env = cls(model, motion, TaskConfig(**kw), device=device, seed=int(cfg["seed"]))
    return wrap_env_z(cfg, env) if task.endswith("Z") else env


def _pulse_vae_from_state_dict(sd: dict, device):
    """A PulseVAE at the widths of one of the port's checkpoints' state
    dicts, its weights loaded."""
    from pulse_tpu_torch.learning.networks import PulseVAE

    def units(prefix):   # the Linear layers of an MLP tower, in order
        return [w.shape[0] for k, w in sd.items()
                if k.startswith(prefix + ".") and k.endswith(".weight") and k.count(".") == prefix.count(".") + 2]

    net = PulseVAE(sd["encoder.trunk.0.weight"].shape[1], sd["decoder.out.weight"].shape[0],
                   latent_dim=sd["encoder.z_mu.weight"].shape[0], self_obs_dim=sd["prior.trunk.0.weight"].shape[1],
                   encoder_units=units("encoder.trunk"), prior_units=units("prior.trunk"),
                   decoder_units=units("decoder.trunk"), critic_units=units("critic"), device=device)
    net.load_state_dict(sd)
    return net


def wrap_env_z(cfg, env):
    """Wrap an env with the frozen PULSE decoder (PHC's HumanoidZ mixin).
    `env.z_checkpoint` is one of the port's distillation runs (its `ckpt/`
    directory, whose latest `epoch_N.pt` is read, or one such file) or a
    reference PULSE checkpoint (`utils/checkpoint.py`); the PulseVAE takes
    the checkpoint's widths (its obs width is the distillation env's) and
    its input stats. Without a checkpoint a fresh PulseVAE from seed 0 and
    unit stats stand in, as in the JAX package. `FrozenZModel` makes the
    PulseVAE float32 whatever the distillation's precision, as the JAX
    package's."""
    from pulse_tpu_torch.env.humanoid_z import FrozenZModel, ZActionWrapper
    from pulse_tpu_torch.learning.networks import PulseVAE
    from pulse_tpu_torch.learning.running_norm import RunningMeanStd
    from pulse_tpu_torch.utils import checkpoint as ref

    e = cfg["env"]
    ckpt = str(e.get("z_checkpoint", "") or "")
    if ckpt:
        path, ck = _load_run_checkpoint(ckpt, env.device, reference_ok=True)
        if ref.is_reference_checkpoint(ck):
            net = ref.import_pulse_vae(ck["model"], device=env.device)
            obs_rms = ref.import_running_mean_std(ck["model"], device=env.device)
            print(f"frozen z model imported from the reference checkpoint {path}")
        else:
            net = _pulse_vae_from_state_dict(ck["network"], env.device)
            obs_rms = RunningMeanStd(**ck["obs_rms"])
            print(f"frozen z model restored from {path}")
    else:
        net = PulseVAE(env.obs_dim, env.action_dim, latent_dim=int(e.get("embedding_size", 32)),
                       self_obs_dim=env.self_obs_dim, device=env.device, seed=0)
        obs_rms = RunningMeanStd.create(env.obs_dim, device=env.device)
    return ZActionWrapper(env, FrozenZModel(net, obs_rms))


def build_pnn_from_cfg(cfg, model, motion, env_config, device):
    """(PNN, its frozen input stats or None): the frozen primitives of the
    MCP envs. With `env.pnn_checkpoint` (or `learning.teacher_pnn_checkpoint`)
    the reference PHC `.pth` is imported, its columns' activation
    `learning.teacher_activation` (default relu), with its running stats;
    else a fresh PNN(obs -> 69 dof, `env.num_prim` columns of
    `learning.pnn_units`, default 512-512) drawn from seed + PNN_SEED_OFFSET
    stands in, on raw observations."""
    from pulse_tpu_torch.env.humanoid_im import HumanoidImEnv
    from pulse_tpu_torch.learning.pnn import PNN
    from pulse_tpu_torch.utils import checkpoint as ref

    e, l = cfg["env"], cfg["learning"]
    ckpt = str(e.get("pnn_checkpoint", "") or l.get("teacher_pnn_checkpoint", "") or "")
    if ckpt:
        sd = ref.load_torch_checkpoint(ckpt)["model"]
        pnn, info = ref.import_pnn(sd, activation=str(l.get("teacher_activation", "relu")), device=device)
        print(f"frozen PNN imported from {ckpt} ({info})")
        return pnn, ref.import_running_mean_std(sd, device=device).freeze()
    probe = HumanoidImEnv(model, motion, env_config, device=device)
    return PNN(probe.obs_dim, probe.action_dim, int(e.get("num_prim", 3)), tuple(l.get("pnn_units", (512, 512))),
               device=device, seed=int(cfg["seed"]) + PNN_SEED_OFFSET), None


def build_agent_from_cfg(cfg, env):
    from pulse_tpu_torch.learning.networks import ActorCritic
    from pulse_tpu_torch.learning.ppo import PPOAgent, PPOConfig

    l = cfg["learning"]
    kind = l["agent"]
    seed = int(cfg["seed"])
    if kind == "distill":
        from pulse_tpu_torch.learning.distill import DistillAgent, DistillConfig
        from pulse_tpu_torch.learning.networks import PulseVAE

        teacher = build_teacher_from_cfg(cfg, env)
        dc = DistillConfig(
            num_envs=int(cfg["num_envs"]),
            horizon_length=int(l["horizon_length"]),
            minibatch_size=int(l["minibatch_size"]),
            mini_epochs=int(l["mini_epochs"]),
            kin_lr=float(l["kin_lr"]),
            grad_norm=float(l["grad_norm"]),
            kld_coefficient=float(l["kld_coefficient"]),
            kld_coefficient_min=float(l["kld_coefficient_min"]),
            kld_anneal_start=int(l["kld_anneal_start"]),
            kld_anneal_end=int(l["kld_anneal_end"]),
            ar1_coefficient=float(l["ar1_coefficient"]),
        )
        net = PulseVAE(
            env.obs_dim, env.action_dim,
            latent_dim=int(l["latent_dim"]),
            self_obs_dim=env.self_obs_dim,
            encoder_units=tuple(l["encoder_units"]),
            prior_units=tuple(l["prior_units"]),
            decoder_units=tuple(l["decoder_units"]),
            # bf16 trunks unless asked (the JAX package's dtype=None then)
            full_precision=bool(l.get("full_precision", False)),
            device=env.device,
            seed=seed,
        )
        return DistillAgent(env, teacher, dc, net, seed=seed + 1)
    if kind not in ("ppo", "amp"):
        raise ValueError(f"unknown agent {kind!r}")
    ppo_cfg = PPOConfig(
        num_envs=int(cfg["num_envs"]),
        horizon_length=int(l["horizon_length"]),
        minibatch_size=int(l["minibatch_size"]),
        mini_epochs=int(l["mini_epochs"]),
        gamma=float(l["gamma"]),
        tau=float(l["tau"]),
        learning_rate=float(l["learning_rate"]),
        e_clip=float(l["e_clip"]),
        critic_coef=float(l["critic_coef"]),
        bounds_loss_coef=float(l["bounds_loss_coef"]),
        grad_norm=float(l["grad_norm"]),
        normalize_input=bool(l["normalize_input"]),
        normalize_value=bool(l["normalize_value"]),
        normalize_advantage=bool(l["normalize_advantage"]),
    )
    net = ActorCritic(
        env.obs_dim, env.action_dim,
        actor_units=tuple(l["actor_units"]),
        critic_units=tuple(l["critic_units"]),
        init_sigma=float(l["init_sigma"]),
        device=env.device,
        seed=seed,
    )
    # the agent's generator gets its own stream, apart from the env's
    if kind == "ppo":
        return PPOAgent(env, ppo_cfg, net, seed=seed + 1)
    from pulse_tpu_torch.learning.amp import AMPConfig
    from pulse_tpu_torch.learning.amp_agent import AMPAgent

    amp_cfg = AMPConfig(
        disc_units=tuple(l["disc_units"]),
        disc_coef=float(l["disc_coef"]),
        disc_logit_reg=float(l["disc_logit_reg"]),
        disc_grad_penalty=float(l["disc_grad_penalty"]),
        disc_reward_scale=float(l["disc_reward_scale"]),
        disc_weight_decay=float(l["disc_weight_decay"]),
        amp_batch_size=int(l["amp_batch_size"]),
        amp_buffer_size=int(l["amp_buffer_size"]),
        task_reward_w=float(l["task_reward_w"]),
        disc_reward_w=float(l["disc_reward_w"]),
    )
    e = cfg["env"]
    return AMPAgent(env, ppo_cfg, amp_cfg, net, getup_update_epoch=int(e.get("getup_update_epoch", 0)),
                    shape_resampling_interval=int(e.get("shape_resampling_interval", 0)), seed=seed + 1)


TEACHER_SEED = 7   # the JAX package's stand-in teacher is drawn from PRNGKey(7)
PNN_SEED_OFFSET = 13   # and its stand-in PNN primitives from PRNGKey(seed + 13)


def build_teacher_from_cfg(cfg, env):
    """The frozen teacher of distillation. With
    `learning.teacher_pnn_checkpoint`, PHC's PNN and composer from reference
    `.pth` checkpoints (the composer from `teacher_composer_checkpoint`, else
    the PNN's file), both with `teacher_activation` (default relu) and the
    composer's head that activation in place of its softmax, as the
    reference's distillation rebuilds it, on observations normalized by the
    PNN checkpoint's stats (`learning.pnn.make_pnn_mcp_teacher`). Else the
    deterministic policy of one of the port's PPO checkpoints
    (`learning.teacher_checkpoint`: a run's `ckpt/` directory, whose latest
    `epoch_N.pt` is read, or one such file), with its normalizer frozen; the
    checkpoint's network fixes the widths. Without a checkpoint a fresh
    network (`teacher_actor_units` / `teacher_critic_units`, default
    2048-1536-1024) from a seed of its own stands in, on observations
    normalized by zero mean and unit variance."""
    from pulse_tpu_torch.learning.networks import ActorCritic
    from pulse_tpu_torch.learning.running_norm import RunningMeanStd

    l = cfg["learning"]
    pnn_ckpt = str(l.get("teacher_pnn_checkpoint", "") or "")
    if pnn_ckpt:
        from pulse_tpu_torch.learning.pnn import make_pnn_mcp_teacher
        from pulse_tpu_torch.utils import checkpoint as ref

        act = str(l.get("teacher_activation", "relu"))
        pnn_sd = ref.load_torch_checkpoint(pnn_ckpt)["model"]
        comp_ckpt = str(l.get("teacher_composer_checkpoint", "") or "") or pnn_ckpt
        comp_sd = pnn_sd if comp_ckpt == pnn_ckpt else ref.load_torch_checkpoint(comp_ckpt)["model"]
        pnn, info = ref.import_pnn(pnn_sd, activation=act, device=env.device)
        comp = ref.import_mcp_composer(comp_sd, activation=act, final=act, device=env.device)
        print(f"PNN teacher imported from {pnn_ckpt} ({info}), composer from {comp_ckpt}")
        return make_pnn_mcp_teacher(pnn, comp, ref.import_running_mean_std(pnn_sd, device=env.device).freeze())
    ckpt = str(l.get("teacher_checkpoint", "") or "")
    if ckpt:
        path, ck = _load_run_checkpoint(ckpt, env.device)
        sd = ck["network"]
        units = {tower: [w.shape[0] for k, w in sd.items() if k.startswith(tower + ".") and k.endswith(".weight")]
                 for tower in ("actor", "critic")}
        net = ActorCritic(env.obs_dim, env.action_dim, actor_units=units["actor"], critic_units=units["critic"],
                          device=env.device)
        net.load_state_dict(sd)
        obs_rms = RunningMeanStd(**ck["obs_rms"])
        print(f"teacher restored from {path}")
    else:
        net = ActorCritic(env.obs_dim, env.action_dim,
                          actor_units=tuple(l.get("teacher_actor_units", (2048, 1536, 1024))),
                          critic_units=tuple(l.get("teacher_critic_units", (2048, 1536, 1024))),
                          device=env.device, seed=TEACHER_SEED)
        obs_rms = RunningMeanStd.create(env.obs_dim, device=env.device)
    net.requires_grad_(False)
    return DeterministicPolicy(net.eval(), obs_rms.freeze())


# --------------------------------------------------------------------------- #
# checkpoints: the train state without the env state (num_envs-dependent)
# --------------------------------------------------------------------------- #

def _rms_dict(r) -> dict:
    return {"mean": r.mean, "var": r.var, "count": r.count}


def save_checkpoint(ckpt_dir: str, epoch: int, ts) -> str:
    """A PPO TrainState's or a DistillState's network, optimizer,
    normalizers and epoch (and a PulseVAE's `full_precision`, which a
    restore leaves to the config, as the JAX package's); of an
    AMPTrainState its PPO state's, and under "amp" the discriminator, its
    optimizer, `amp_rms`, both buffers and the reward weights."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"epoch_{epoch}.pt")
    inner = getattr(ts, "ppo", ts)
    state = {"network": inner.network.state_dict(), "optimizer": inner.optimizer.state_dict(),
             "obs_rms": _rms_dict(inner.obs_rms), "epoch": inner.epoch}
    if hasattr(inner, "value_rms"):
        state["value_rms"] = _rms_dict(inner.value_rms)
    if hasattr(inner.network, "full_precision"):
        state["full_precision"] = inner.network.full_precision
    if hasattr(ts, "amp"):
        a = ts.amp
        state["amp"] = {"disc": a.disc.state_dict(), "optimizer": a.optimizer.state_dict(),
                        "amp_rms": _rms_dict(a.amp_rms), "task_reward_w": a.task_reward_w,
                        "disc_reward_w": a.disc_reward_w,
                        **{k: {"data": b.data, "head": b.head, "size": b.size}
                           for k, b in (("demo_buffer", a.demo_buffer), ("replay_buffer", a.replay_buffer))}}
    torch.save(state, path)
    return path


def _load_run_checkpoint(ckpt: str, device, reference_ok: bool = False) -> tuple[str, dict]:
    """(path, contents) of a checkpoint: the latest `epoch_N.pt` of a run's
    `ckpt/` directory, or the file itself, read with `weights_only`. With
    `reference_ok`, a file (not a directory) that holds more than tensors
    and plain data, as a reference `.pth` may, is read on the CPU by
    `utils.checkpoint.load_torch_checkpoint`, which says so."""
    import pickle

    from pulse_tpu_torch.utils.checkpoint import load_torch_checkpoint

    path = latest_checkpoint(ckpt) if os.path.isdir(ckpt) else ckpt
    if path is None:
        raise FileNotFoundError(f"no epoch_N.pt checkpoint in {ckpt}")
    try:
        return path, torch.load(path, map_location=device, weights_only=True)
    except pickle.UnpicklingError:
        if not reference_ok or path != ckpt:
            raise
        return path, load_torch_checkpoint(path)


def latest_checkpoint(ckpt_dir: str) -> str | None:
    found = [(int(m.group(1)), p) for p in glob.glob(os.path.join(ckpt_dir, "epoch_*.pt"))
             if (m := re.search(r"epoch_(\d+)\.pt$", p))]
    return max(found)[1] if found else None


def restore_checkpoint(path: str, ts):
    from pulse_tpu_torch.learning.running_norm import RunningMeanStd

    inner = getattr(ts, "ppo", ts)
    dev = inner.obs_rms.mean.device
    ck = torch.load(path, map_location=dev, weights_only=True)
    inner.network.load_state_dict(ck["network"])
    inner.optimizer.load_state_dict(ck["optimizer"])
    rms = {k: RunningMeanStd(**ck[k]) for k in ("obs_rms", "value_rms") if k in ck}
    inner = dataclasses.replace(inner, epoch=int(ck["epoch"]), **rms)
    if not hasattr(ts, "amp"):
        return inner
    from pulse_tpu_torch.learning.amp import RingBuffer

    a = ck["amp"]
    ts.amp.disc.load_state_dict(a["disc"])
    ts.amp.optimizer.load_state_dict(a["optimizer"])
    amp = dataclasses.replace(ts.amp, amp_rms=RunningMeanStd(**a["amp_rms"]), task_reward_w=a["task_reward_w"],
                              disc_reward_w=a["disc_reward_w"],
                              **{k: RingBuffer(**a[k]) for k in ("demo_buffer", "replay_buffer")})
    return dataclasses.replace(ts, ppo=inner, amp=amp)


@dataclasses.dataclass
class TrainResult:
    agent: object
    train_state: object
    metrics: list            # one dict of floats per epoch run


def main(argv=None):
    """Train and return a TrainResult, or with test=true evaluate and
    return the EvalResult."""
    from pulse_tpu_torch._device import resolve_device
    from pulse_tpu_torch.utils.config import load_config
    from pulse_tpu_torch.utils.logger import MetricLogger

    cfg = load_config(argv if argv is not None else sys.argv[1:])
    if cfg["learning"]["agent"] == "distill" and (cfg["test"] or int(cfg.get("eval_frequency", 0)) > 0):
        # the JAX package's run_eval cannot evaluate a distill state either
        # (its policy calls PulseVAE without z_noise and unpacks its dict)
        raise NotImplementedError("test=true and eval_frequency evaluate a PPO policy; the distill agent has no "
                                  "evaluator")
    if cfg.get("use_wandb", False):
        raise ValueError("use_wandb=true: the port logs metrics to metrics.jsonl only (no wandb sink)")
    device = resolve_device(cfg["device"])

    out_dir = os.path.join(cfg["output_dir"], cfg["exp_name"])
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        json.dump(cfg, fh, indent=2, default=str)

    spec, model = build_model_from_cfg(cfg, device)
    motion = build_motion_from_cfg(cfg, spec, device)
    env = build_env_from_cfg(cfg, model, motion, device)
    agent = build_agent_from_cfg(cfg, env)

    ts = agent.init()
    ckpt_dir = os.path.join(out_dir, "ckpt")
    epoch0 = 0
    if int(cfg["epoch"]) != 0:
        path = latest_checkpoint(ckpt_dir)
        if path:
            ts = restore_checkpoint(path, ts)
            epoch0 = int(re.search(r"epoch_(\d+)\.pt$", path).group(1))
            print(f"restored {path}")

    if cfg["test"]:
        return run_eval(cfg, env, ts)

    logger = MetricLogger(out_dir)
    t_start = time.time()
    t_window, e_window = t_start, epoch0   # windowed fps
    steps_per_epoch = int(cfg["num_envs"]) * int(cfg["learning"]["horizon_length"])
    history = []
    for epoch in range(epoch0, int(cfg["max_epochs"])):
        if hasattr(agent, "pre_epoch"):
            ts = agent.pre_epoch(ts, epoch)
        ts, metrics = agent.train_epoch(ts)
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(metrics)
        if epoch % int(cfg["log_frequency"]) == 0:
            now = time.time()
            line = dict(metrics, time=round(now - t_start, 1),
                        fps=round(steps_per_epoch * (epoch - e_window + 1) / max(now - t_window, 1e-6)))
            t_window, e_window = now, epoch + 1
            logger.log(line, epoch)
            print(f"epoch={epoch} " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in line.items()), flush=True)
        if int(cfg["save_frequency"]) > 0 and epoch > 0 and epoch % int(cfg["save_frequency"]) == 0:
            save_checkpoint(ckpt_dir, epoch, ts)
        # periodic im_eval + PMCP hard-negative reweighting (≙ IMAmpAgent
        # eval feedback, im_amp.py:136-242): the new weights are written
        # into the motion store the env's resets sample from
        ef = int(cfg.get("eval_frequency", 0))
        if ef > 0 and epoch > epoch0 and epoch % ef == 0 and hasattr(env, "reset_to"):
            from pulse_tpu_torch.motion.motion_lib import update_hard_sampling_weight

            result = run_eval(cfg, env, ts)
            env.motion.sampling_prob.copy_(
                update_hard_sampling_weight(env.motion, torch.as_tensor(result.failed_motions)).sampling_prob)
    save_checkpoint(ckpt_dir, int(cfg["max_epochs"]), ts)
    return TrainResult(agent=agent, train_state=ts, metrics=history)


@dataclasses.dataclass
class DeterministicPolicy:
    """The mean action of an ActorCritic on observations normalized by
    `obs_rms`, clipped to the action bounds."""

    network: object
    obs_rms: object

    @torch.no_grad()
    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.network.mean_action(self.obs_rms.normalize(obs)), -1.0, 1.0)


def _policy_fn(ts) -> DeterministicPolicy:
    """The deterministic policy of a PPO train state (an AMP train state's
    PPO state)."""
    ts = getattr(ts, "ppo", ts)
    return DeterministicPolicy(ts.network, ts.obs_rms)


def run_eval(cfg, env, ts):
    """`test=true`. An imitation env (one with `reset_to`, also Z-wrapped):
    im_eval of the train state's policy over every clip (success rate and
    MPJPE, ≙ im_amp_players.py), `num_envs` clips a batch, with early
    termination switched off, so that mid-clip auto-resets do not pollute
    the accumulation (failure is latched separately). A task env:
    task_eval's episode returns over one episode length at `num_envs` envs.
    The result is printed as JSON."""
    from pulse_tpu_torch.eval import im_eval, task_eval

    if not hasattr(env, "reset_to"):
        result = task_eval(env, _policy_fn(ts), batch_size=int(cfg["num_envs"]))
        print(json.dumps(dataclasses.asdict(result), indent=2))
        return result
    if env.config.enable_early_termination:
        env = env.with_config(dataclasses.replace(env.config, enable_early_termination=False))
    result = im_eval(env, _policy_fn(ts), batch_size=int(cfg["num_envs"]))
    print(json.dumps(dataclass_to_dict(result), indent=2))
    return result


def dataclass_to_dict(d) -> dict:
    """A dataclass as a JSON-ready dict: numpy arrays become lists."""
    import numpy as np

    return {k: v.tolist() if isinstance(v, np.ndarray) else v for k, v in dataclasses.asdict(d).items()}


if __name__ == "__main__":
    main()
