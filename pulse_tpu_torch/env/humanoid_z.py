"""Latent-action wrapper: a downstream policy acts in PULSE's latent space.

Counterpart of `pulse_tpu/env/humanoid_z.py` (PHC's HumanoidZ mixin): the
task policy outputs a 32-d latent; the wrapper shifts it by the frozen
prior's mean on the current self obs, decodes it with the frozen PULSE
decoder to motor actions, clips them to [-1, 1] and steps the wrapped env.
The self obs is normalized with the frozen running stats of the
distillation (their first `self_obs_dim` entries).

The decode runs in float32 with autocast off, as the JAX package's
`wrap_env_z` builds its PulseVAE without a compute dtype: `FrozenZModel`
switches its PulseVAE to `full_precision`. The PulseVAE is not trained.
"""

from __future__ import annotations

import dataclasses

import torch

from pulse_tpu_torch.learning.networks import PulseVAE, pulse_vae_from_jax
from pulse_tpu_torch.learning.running_norm import RunningMeanStd, running_mean_std_from_jax


@dataclasses.dataclass
class FrozenZModel:
    """The frozen PulseVAE (only its prior and decoder are read), switched to
    full precision, and the running stats over the full distillation obs."""

    network: PulseVAE
    obs_rms: RunningMeanStd
    use_vae_prior: bool = True

    def __post_init__(self):
        self.network.requires_grad_(False).eval().set_full_precision(True)
        self.obs_rms = self.obs_rms.freeze()


def frozen_z_model_from_jax(params: dict, obs_rms: dict, use_vae_prior: bool = True, device=None) -> FrozenZModel:
    """A FrozenZModel from a flax PulseVAE param tree and a JAX
    RunningMeanStd's {mean, var, count}, all numpy leaves."""
    return FrozenZModel(network=pulse_vae_from_jax(params, device=device),
                        obs_rms=running_mean_std_from_jax(obs_rms, device=device), use_vae_prior=use_vae_prior)


class ZActionWrapper:
    """Wraps an env so that its actions are latents (action_dim =
    latent_dim). Every other attribute is the wrapped env's."""

    def __init__(self, env, frozen: FrozenZModel):
        net = frozen.network
        if net.self_obs_dim != env.self_obs_dim or net.decoder.out.out_features != env.action_dim:
            raise ValueError(f"frozen PulseVAE (self obs {net.self_obs_dim}, action "
                             f"{net.decoder.out.out_features}) does not fit the env (self obs {env.self_obs_dim}, "
                             f"action {env.action_dim})")
        self.env = env
        self.frozen = frozen
        self.action_dim = net.latent_dim
        n = net.self_obs_dim
        rms = frozen.obs_rms
        self._self_rms = RunningMeanStd(mean=rms.mean[:n], var=rms.var[:n], count=rms.count, frozen=True)

    def __getattr__(self, name):
        # the rest of the env's surface (obs_dim, reset_to, motion, ...), so
        # that a wrapped imitation env reaches im_eval's motion sweep
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.env, name)

    @torch.no_grad()
    def decode_z(self, self_obs_raw: torch.Tensor, action_z: torch.Tensor) -> torch.Tensor:
        """Latents [B, L] -> motor actions [B, A] (unclipped), float32."""
        net = self.frozen.network
        self_obs = self._self_rms.normalize(self_obs_raw.float())
        z = action_z.float()
        if self.frozen.use_vae_prior:
            z = net.prior(self_obs)[0] + z
        return net.decoder(self_obs, z)

    def reset(self, num_envs: int):
        return self.env.reset(num_envs)

    def step(self, state, action_z: torch.Tensor):
        motor = self.decode_z(state.obs[:, : self.frozen.network.self_obs_dim], action_z)
        return self.env.step(state, torch.clamp(motor, -1.0, 1.0))

    def with_config(self, config) -> "ZActionWrapper":
        """The wrapped env rebuilt with another config, wrapped again."""
        return ZActionWrapper(self.env.with_config(config), self.frozen)
