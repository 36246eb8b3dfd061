"""Policy/value network: separate actor and critic MLP towers with a
Gaussian policy head of fixed (or learned) log-sigma.

Counterpart of `MLP` and `ActorCritic` in `pulse_tpu/learning/networks.py`.
On CUDA the towers run under bf16 autocast; parameters and both heads stay
float32. On the CPU everything is float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from pulse_tpu_torch._device import resolve_device

_ACT = {"relu": nn.ReLU, "silu": nn.SiLU, "elu": nn.ELU, "tanh": nn.Tanh, "gelu": nn.GELU}

# flax truncated_normal variance scaling: the std of a unit normal cut at
# +-2 is 0.8796..., so the draw is rescaled to reach the target variance
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(w: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    """flax variance_scaling(scale, "fan_in", "truncated_normal") on a torch
    [out, in] weight."""
    std = math.sqrt(scale / w.shape[1]) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class MLP(nn.Sequential):
    def __init__(self, in_dim: int, units: Sequence[int], activation: str = "silu"):
        layers = []
        for u in units:
            layers += [nn.Linear(in_dim, u), _ACT[activation]()]
            in_dim = u
        super().__init__(*layers)


class ActorCritic(nn.Module):
    """forward(obs) -> (mu [B, A], log_sigma [A], value [B])."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        actor_units: Sequence[int] = (2048, 1536, 1024),
        critic_units: Sequence[int] = (2048, 1536, 1024),
        activation: str = "silu",
        init_sigma: float = -2.9,
        learn_sigma: bool = False,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.actor = MLP(obs_dim, actor_units, activation)
        self.critic = MLP(obs_dim, critic_units, activation)
        self.mu = nn.Linear(actor_units[-1], action_dim)
        self.value = nn.Linear(critic_units[-1], 1)
        sigma = torch.full((action_dim,), float(init_sigma))
        if learn_sigma:
            self.log_sigma = nn.Parameter(sigma)
        else:
            self.register_buffer("log_sigma", sigma)
        # flax defaults: lecun-normal (scale 1) kernels, zero biases; the mu
        # head at scale 0.01
        g = torch.Generator().manual_seed(seed)
        for lin in self.modules():
            if isinstance(lin, nn.Linear):
                _variance_scaling_(lin.weight.data, 0.01 if lin is self.mu else 1.0, g)
                nn.init.zeros_(lin.bias)
        self.to(device)

    def forward(self, obs: torch.Tensor):
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=obs.is_cuda):
            h_actor = self.actor(obs)
            h_critic = self.critic(obs)
        mu = self.mu(h_actor.float())
        value = self.value(h_critic.float())[..., 0]
        return mu, self.log_sigma, value


def _tower(p: dict) -> list:
    return [p[f"Dense_{i}"] for i in range(len(p))]


def flax_leaves(net: ActorCritic, tree: dict):
    """(torch parameter or buffer, the matching leaf of a flax ActorCritic
    tree in torch layout) pairs. The tree is the param tree or one shaped
    like it (Adam's moments): MLP_0 actor, MLP_1 critic, Dense_0 mu head,
    Dense_1 value head, optional log_sigma. Flax kernels are [in, out];
    torch weights [out, in]."""
    linears = [m for m in net.actor if isinstance(m, nn.Linear)] + [m for m in net.critic if isinstance(m, nn.Linear)]
    dense = _tower(tree["MLP_0"]) + _tower(tree["MLP_1"]) + [tree["Dense_0"], tree["Dense_1"]]
    for lin, d in zip(linears + [net.mu, net.value], dense):
        yield lin.weight, torch.tensor(np.asarray(d["kernel"], np.float32).T)
        yield lin.bias, torch.tensor(np.asarray(d["bias"], np.float32))
    if "log_sigma" in tree:
        yield net.log_sigma, torch.tensor(np.asarray(tree["log_sigma"], np.float32))


def actor_critic_from_jax(params: dict, activation: str = "silu", init_sigma: float = -2.9,
                          device=None) -> ActorCritic:
    """Load a flax ActorCritic param tree (numpy leaves) into an
    ActorCritic of the same widths."""
    actor, critic = _tower(params["MLP_0"]), _tower(params["MLP_1"])
    obs_dim = np.asarray(actor[0]["kernel"]).shape[0]
    action_dim = np.asarray(params["Dense_0"]["kernel"]).shape[1]
    net = ActorCritic(
        obs_dim, action_dim,
        actor_units=[np.asarray(d["kernel"]).shape[1] for d in actor],
        critic_units=[np.asarray(d["kernel"]).shape[1] for d in critic],
        activation=activation, init_sigma=init_sigma, learn_sigma="log_sigma" in params,
        device="cpu",
    )
    with torch.no_grad():
        for t, x in flax_leaves(net, params):
            t.copy_(x)
    return net.to(resolve_device(device))
