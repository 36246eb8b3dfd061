"""What the port's entry-point scripts share: the demo env and the policies
they restore.

Counterpart of `__graft_entry__.py`'s `_make_env`, which the JAX package's
scripts import: the SMPL humanoid, the default PhysicsConfig, 2 synthetic
clips of 2 s and the default EnvConfig, here on a device (the card unless
named).
"""

from __future__ import annotations

import torch

from pulse_tpu_torch._device import resolve_device


def make_env(device=None, config=None, seconds: float = 2.0):
    """A HumanoidImEnv on `device`: the SMPL humanoid, the default physics,
    2 synthetic clips of `seconds` and `config` (default EnvConfig())."""
    from pulse_tpu_torch.assets import load_smpl_humanoid
    from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv
    from pulse_tpu_torch.motion.motion_lib import build_motion_data
    from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
    from pulse_tpu_torch.physics.model import PhysicsConfig, build_model

    device = resolve_device(device)
    spec = load_smpl_humanoid()
    model = build_model(spec, PhysicsConfig(), device=device)
    motion = build_motion_data(spec.skeleton, make_synthetic_clips(spec.skeleton, num_clips=2, seconds=seconds),
                               device=device)
    return HumanoidImEnv(model, motion, config or EnvConfig(), device=device)


def load_policy(env, ckpt: str = ""):
    """The deterministic policy (clipped mean action on normalized obs,
    `run.DeterministicPolicy`) of a PPO ActorCritic. With `ckpt` (a port
    run's `ckpt/` directory, whose latest `epoch_N.pt` is read, or one such
    file) the network takes the checkpoint's widths and is restored through
    `run.restore_checkpoint`; without it a fresh reference-width
    (2048-1536-1024) network from seed 0 and unit stats stand in."""
    from pulse_tpu_torch import run
    from pulse_tpu_torch.learning.networks import ActorCritic
    from pulse_tpu_torch.learning.ppo import TrainState
    from pulse_tpu_torch.learning.running_norm import RunningMeanStd

    units = {}
    path = ""
    if ckpt:
        path = run.latest_checkpoint(ckpt) or ckpt
        sd = torch.load(path, map_location=env.device, weights_only=True)["network"]
        units = {f"{t}_units": [w.shape[0] for k, w in sd.items() if k.startswith(t + ".") and k.endswith(".weight")]
                 for t in ("actor", "critic")}
    net = ActorCritic(env.obs_dim, env.action_dim, device=env.device, **units)
    ts = TrainState(network=net, optimizer=torch.optim.Adam(net.parameters()),
                    obs_rms=RunningMeanStd.create(env.obs_dim, device=env.device),
                    value_rms=RunningMeanStd.create(1, device=env.device), env_state=None)
    if path:
        ts = run.restore_checkpoint(path, ts)
        print(f"restored {path}")
    return run.DeterministicPolicy(ts.network, ts.obs_rms)
