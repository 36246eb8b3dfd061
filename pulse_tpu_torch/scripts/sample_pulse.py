"""Sample motion from PULSE as a generative model.

Counterpart of `scripts/sample_pulse.py` (≙ the reference README's
sampling, SURVEY §3.4): each step z is drawn from the learned prior on the
current normalized self obs, z = prior_mu + exp(prior_logvar / 2) eps T
(amp_network_z_builder.py:101-116, eps standard normal from the script's
own generator, T the temperature), the decoder turns it into motor
actions (clipped), and the humanoid improvises with early termination off
on the cycled reference. Dumps frames for `play_motion`-style tooling.

    python -m pulse_tpu_torch.scripts.sample_pulse [--ckpt output/<distill exp>/ckpt]
        [--steps 300] [--num_envs 2] [--temperature 1.0] [--out pulse_samples.npz]
        [--device cpu]

The PulseVAE is a port distillation run's (`env=im_vae learning=im_z_fit`,
its widths and input stats), else a fresh reference-width one from seed 0
with unit stats.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pulse_tpu_torch.assets import load_smpl_humanoid


# the latent draws' generator seed (the JAX script draws from PRNGKey(2))
SEED = 2


def make_sample_env(device=None):
    """The sampler's env: the SMPL humanoid on 2 synthetic 4 s clips, early
    termination off, the reference cycled."""
    from pulse_tpu_torch.env.humanoid_im import EnvConfig
    from pulse_tpu_torch.scripts.common import make_env

    return make_env(device, EnvConfig(enable_early_termination=False, cycle_motion=True), seconds=4.0)


def load_pulse_vae(env, ckpt: str = ""):
    """(PulseVAE, its input RunningMeanStd): a port distillation run's (its
    `ckpt/` directory or an `epoch_N.pt`), else fresh from seed 0."""
    from pulse_tpu_torch import run
    from pulse_tpu_torch.learning.networks import PulseVAE
    from pulse_tpu_torch.learning.running_norm import RunningMeanStd

    if not ckpt:
        return (PulseVAE(env.obs_dim, env.action_dim, self_obs_dim=env.self_obs_dim, device=env.device, seed=0),
                RunningMeanStd.create(env.obs_dim, device=env.device))
    path, ck = run._load_run_checkpoint(ckpt, env.device)
    net = run._pulse_vae_from_state_dict(ck["network"], env.device)
    net.set_full_precision(bool(ck.get("full_precision", False)))
    print(f"restored {path}")
    return net, RunningMeanStd(**ck["obs_rms"])


@torch.no_grad()
def sample_action(net, obs_rms, obs: torch.Tensor, eps: torch.Tensor, temperature: float = 1.0) -> dict:
    """`PulseVAE.prior_sample` on the normalized self obs with the noise
    `eps` [B, L] (standard normal) times the temperature: the prior's mu and
    logvar, z and the decoded action (unclipped)."""
    return net.prior_sample(obs_rms.normalize(obs)[..., : net.self_obs_dim], eps * temperature)


def sample(env, net, obs_rms, num_envs: int, steps: int, temperature: float = 1.0) -> dict:
    """`steps` prior-sampling steps from a reset of `num_envs` envs -> the
    arrays of the .npz, with the counts of `terminations` (0: early
    termination is off) and `episodes_ended` (an env's episode ends only at
    the env's episode_length)."""
    gen = torch.Generator(device=env.device).manual_seed(SEED)
    state = env.reset(num_envs)
    frames = []
    ended = torch.zeros((), dtype=torch.long, device=env.device)
    terminated = torch.zeros_like(ended)
    for _ in range(steps):
        eps = torch.randn(num_envs, net.latent_dim, generator=gen, device=env.device)
        action = sample_action(net, obs_rms, state.obs, eps, temperature)["action"]
        state = env.step(state, torch.clamp(action, -1.0, 1.0))
        frames.append(state.physics.body_pos)
        ended += state.done.sum()
        terminated += state.terminate.sum()
    pos = torch.stack(frames).cpu().numpy()
    tree = load_smpl_humanoid().skeleton
    return {"body_pos": pos[:, 0], "all_body_pos": pos, "node_names": np.asarray(tree.node_names),
            "parents": tree.parent_indices, "episodes_ended": int(ended), "terminations": int(terminated)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--num_envs", type=int, default=2)
    ap.add_argument("--out", default="pulse_samples.npz")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default=None, help="the env's and the PulseVAE's device (default: the card)")
    args = ap.parse_args(argv)

    env = make_sample_env(args.device)
    net, obs_rms = load_pulse_vae(env, args.ckpt)
    out = sample(env, net, obs_rms, args.num_envs, args.steps, args.temperature)
    np.savez(args.out, **{k: v for k, v in out.items() if k not in ("episodes_ended", "terminations")})
    print(f"wrote {args.out}: {args.steps} frames x {args.num_envs} envs")
    return out


if __name__ == "__main__":
    main()
