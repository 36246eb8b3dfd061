"""The acting half of PPO: one policy step over a batch of observations.

Counterpart of `gaussian_neglogp` and `PPOAgent._policy_step` in
`pulse_tpu/learning/ppo.py`. The update, GAE and the rollout storage come
with the training slice.
"""

from __future__ import annotations

import math

import torch

from pulse_tpu_torch.learning.networks import ActorCritic
from pulse_tpu_torch.learning.running_norm import RunningMeanStd


def gaussian_neglogp(mu: torch.Tensor, log_sigma: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    d = action - mu
    return (
        0.5 * torch.sum((d / torch.exp(log_sigma)) ** 2, dim=-1)
        + torch.sum(log_sigma)
        + 0.5 * mu.shape[-1] * math.log(2 * math.pi)
    )


@torch.no_grad()
def policy_step(
    net: ActorCritic,
    obs: torch.Tensor,
    generator: torch.Generator,
    obs_rms: RunningMeanStd | None = None,
    value_rms: RunningMeanStd | None = None,
):
    """Sample a Gaussian action for each observation. Normalizers that are
    None are skipped. Returns (action, mu, neglogp, value)."""
    obs_norm = obs_rms.normalize(obs) if obs_rms is not None else obs
    mu, log_sigma, value = net(obs_norm)
    if value_rms is not None:
        value = value_rms.denormalize(value[..., None])[..., 0]
    eps = torch.randn(mu.shape, generator=generator, device=mu.device)
    action = mu + torch.exp(log_sigma) * eps
    return action, mu, gaussian_neglogp(mu, log_sigma, action), value
