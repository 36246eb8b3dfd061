"""Policy/value network, AMP discriminator and the PULSE VAE.

Counterpart of `MLP`, `ActorCritic`, `Discriminator`, `Encoder`, `Prior`,
`Decoder`, `PulseVAE` and `kl_multi` in `pulse_tpu/learning/networks.py`:

  * `ActorCritic`: separate actor and critic MLP towers with a Gaussian
    policy head of fixed (or learned) log-sigma;
  * `Discriminator`: AMP's MLP to one logit, always float32 (its R1
    penalty differentiates through it twice);
  * `PulseVAE`: PULSE's student, an encoder of the whole observation to a
    posterior (mu, logvar), a learned prior of the self observation, and a
    decoder of [self obs, prior mu + posterior sample] to the action, plus
    a critic tower that distillation does not train.

On CUDA the MLP trunks of the policy and the VAE run under bf16 autocast;
parameters and every head stay float32 (the VAE's heads compute in their
weights' dtype, so that a float64 copy runs in float64). On the CPU
everything is float32. `PulseVAE(full_precision=True)` (the JAX package's
`PulseVAE(dtype=None)`) computes everything in float32 with autocast off,
on CUDA too.
Initialization is flax's default (lecun-normal kernels, zero biases), but
for the discriminator's logit layer (uniform, fan-in variance 1).
"""

from __future__ import annotations

import contextlib
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


def _autocast(x: torch.Tensor, full_precision: bool = False):
    """bf16 autocast of an MLP trunk on CUDA; with full_precision autocast
    off on the tensor's device, an enclosing one's too."""
    if full_precision:
        return torch.autocast(x.device.type, enabled=False)
    return torch.autocast("cuda", dtype=torch.bfloat16, enabled=x.is_cuda)


def _heads(x: torch.Tensor, full_precision: bool):
    """The float32 heads after a trunk: with full_precision autocast off,
    an enclosing one's too."""
    return torch.autocast(x.device.type, enabled=False) if full_precision else contextlib.nullcontext()


def _flax_init_(module: nn.Module, seed: int, scale_of=lambda lin: 1.0) -> None:
    """flax default initialization of every Linear of `module`: kernels by
    variance scaling (`scale_of(linear)`, lecun-normal at 1), biases zero."""
    g = torch.Generator().manual_seed(seed)
    for lin in module.modules():
        if isinstance(lin, nn.Linear):
            _variance_scaling_(lin.weight.data, scale_of(lin), g)
            nn.init.zeros_(lin.bias)


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
        # the mu head at scale 0.01
        _flax_init_(self, seed, lambda lin: 0.01 if lin is self.mu else 1.0)
        self.to(device)

    def forward(self, obs: torch.Tensor):
        with _autocast(obs):
            h_actor = self.actor(obs)
            h_critic = self.critic(obs)
        mu = self.mu(h_actor.float())
        value = self.value(h_critic.float())[..., 0]
        return mu, self.log_sigma, value

    def mean_action(self, obs: torch.Tensor) -> torch.Tensor:
        """forward's mu without running the critic tower."""
        with _autocast(obs):
            h_actor = self.actor(obs)
        return self.mu(h_actor.float())


class Discriminator(nn.Module):
    """forward(amp_obs [..., in_dim]) -> logit [...]: an MLP, then one
    logit. Computes in float32 with autocast off, whatever the caller's."""

    def __init__(self, in_dim: int, units: Sequence[int] = (1024, 512), activation: str = "relu", device=None,
                 seed: int = 0):
        super().__init__()
        self.trunk = MLP(in_dim, units, activation)
        self.logit = nn.Linear(units[-1], 1)
        _flax_init_(self, seed)
        # flax variance_scaling(1, "fan_in", "uniform"): symmetric, so the
        # fresh discriminator favours neither side
        bound = math.sqrt(3.0 / units[-1])
        with torch.no_grad():
            self.logit.weight.uniform_(-bound, bound, generator=torch.Generator().manual_seed(seed + 1))
        self.to(resolve_device(device))

    def forward(self, amp_obs: torch.Tensor) -> torch.Tensor:
        with torch.autocast(amp_obs.device.type, enabled=False):
            return self.logit(self.trunk(amp_obs.float()))[..., 0]


class Encoder(nn.Module):
    """Posterior encoder: obs -> (z_mu, z_logvar). The trunk, then an
    unactivated `z_proj` to 5 latent widths, then the two heads."""

    def __init__(self, obs_dim: int, latent_dim: int = 32, units: Sequence[int] = (2048, 1536, 1024),
                 activation: str = "silu", full_precision: bool = False):
        super().__init__()
        self.full_precision = full_precision
        self.trunk = MLP(obs_dim, units, activation)
        self.z_proj = nn.Linear(units[-1], 5 * latent_dim)
        self.z_mu = nn.Linear(5 * latent_dim, latent_dim)
        self.z_logvar = nn.Linear(5 * latent_dim, latent_dim)

    def forward(self, obs: torch.Tensor):
        with _autocast(obs, self.full_precision):
            h = self.trunk(obs)
        with _heads(obs, self.full_precision):
            h = self.z_proj(h.to(self.z_proj.weight.dtype))
            return self.z_mu(h), self.z_logvar(h)


class Prior(nn.Module):
    """Learned prior: self obs -> (mu, logvar), logvar clamped to [-8, 2]
    (PULSE's clamped prior)."""

    def __init__(self, self_obs_dim: int, latent_dim: int = 32, units: Sequence[int] = (1024, 512),
                 activation: str = "silu", full_precision: bool = False):
        super().__init__()
        self.full_precision = full_precision
        self.trunk = MLP(self_obs_dim, units, activation)
        self.mu = nn.Linear(units[-1], latent_dim)
        self.logvar = nn.Linear(units[-1], latent_dim)

    def forward(self, self_obs: torch.Tensor):
        with _autocast(self_obs, self.full_precision):
            h = self.trunk(self_obs).to(self.mu.weight.dtype)
        with _heads(self_obs, self.full_precision):
            return self.mu(h), torch.clamp(self.logvar(h), -8.0, 2.0)


class Decoder(nn.Module):
    """[self obs, z] -> action."""

    def __init__(self, self_obs_dim: int, latent_dim: int, action_dim: int,
                 units: Sequence[int] = (1024, 1024, 512), activation: str = "silu", full_precision: bool = False):
        super().__init__()
        self.full_precision = full_precision
        self.trunk = MLP(self_obs_dim + latent_dim, units, activation)
        self.out = nn.Linear(units[-1], action_dim)

    def forward(self, self_obs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        with _autocast(self_obs, self.full_precision):
            h = self.trunk(torch.cat([self_obs, z], dim=-1))
        with _heads(self_obs, self.full_precision):
            return self.out(h.to(self.out.weight.dtype))


class PulseVAE(nn.Module):
    """forward(obs, z_noise) -> {action_mu, post_mu, post_logvar, prior_mu,
    prior_logvar, value}. The decoder reads prior_mu + post_mu +
    exp(post_logvar / 2) z_noise; the critic reads the whole obs. With
    `full_precision` no part autocasts (the JAX package's `dtype=None`)."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        latent_dim: int = 32,
        self_obs_dim: int = 358,
        encoder_units: Sequence[int] = (2048, 1536, 1024),
        prior_units: Sequence[int] = (1024, 512),
        decoder_units: Sequence[int] = (1024, 1024, 512),
        critic_units: Sequence[int] = (2048, 1536, 1024),
        activation: str = "silu",
        full_precision: bool = False,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.latent_dim, self.self_obs_dim = latent_dim, self_obs_dim
        self.full_precision = full_precision
        self.encoder = Encoder(obs_dim, latent_dim, encoder_units, activation, full_precision)
        self.prior = Prior(self_obs_dim, latent_dim, prior_units, activation, full_precision)
        self.decoder = Decoder(self_obs_dim, latent_dim, action_dim, decoder_units, activation, full_precision)
        self.critic = MLP(obs_dim, critic_units, activation)
        self.critic_head = nn.Linear(critic_units[-1], 1)
        _flax_init_(self, seed)
        self.to(device)

    def set_full_precision(self, full_precision: bool) -> "PulseVAE":
        """Switch every part's autocast (see `full_precision`); returns self."""
        for m in (self, self.encoder, self.prior, self.decoder):
            m.full_precision = bool(full_precision)
        return self

    def latent_action(self, obs: torch.Tensor, z_noise: torch.Tensor) -> dict:
        """Every output but the value: what distillation trains on."""
        self_obs = obs[..., : self.self_obs_dim]
        post_mu, post_logvar = self.encoder(obs)
        prior_mu, prior_logvar = self.prior(self_obs)
        z = post_mu + torch.exp(0.5 * post_logvar) * z_noise
        return {"action_mu": self.decoder(self_obs, prior_mu + z), "post_mu": post_mu, "post_logvar": post_logvar,
                "prior_mu": prior_mu, "prior_logvar": prior_logvar}

    def prior_sample(self, self_obs: torch.Tensor, eps: torch.Tensor) -> dict:
        """PULSE as a generative model: the prior's mu and logvar on the
        (normalized) self obs, z = mu + exp(logvar / 2) eps and the decoded
        action (unclipped)."""
        prior_mu, prior_logvar = self.prior(self_obs)
        z = prior_mu + torch.exp(0.5 * prior_logvar) * eps
        return {"prior_mu": prior_mu, "prior_logvar": prior_logvar, "z": z, "action": self.decoder(self_obs, z)}

    def value(self, obs: torch.Tensor) -> torch.Tensor:
        with _autocast(obs, self.full_precision):
            h = self.critic(obs)
        with _heads(obs, self.full_precision):
            return self.critic_head(h.to(self.critic_head.weight.dtype))[..., 0]

    def forward(self, obs: torch.Tensor, z_noise: torch.Tensor) -> dict:
        return dict(self.latent_action(obs, z_noise), value=self.value(obs))


def kl_multi(mu0, logvar0, mu1, logvar1) -> torch.Tensor:
    """KL(N0 || N1) of diagonal Gaussians, summed over the last axis."""
    return 0.5 * torch.sum(logvar1 - logvar0 + (torch.exp(logvar0) + (mu0 - mu1) ** 2) / torch.exp(logvar1) - 1.0,
                           dim=-1)


def _tower(p: dict) -> list:
    return [p[f"Dense_{i}"] for i in range(len(p))]


def _linears(mlp: MLP) -> list:
    return [m for m in mlp if isinstance(m, nn.Linear)]


def _dense_leaves(pairs):
    """(torch Linear, flax Dense dict) pairs -> (parameter, leaf in torch
    layout) pairs. Flax kernels are [in, out]; torch weights [out, in]."""
    for lin, d in pairs:
        yield lin.weight, torch.tensor(np.asarray(d["kernel"], np.float32).T)
        yield lin.bias, torch.tensor(np.asarray(d["bias"], np.float32))


def flax_leaves(net: ActorCritic, tree: dict):
    """(torch parameter or buffer, the matching leaf of a flax ActorCritic
    tree in torch layout) pairs. The tree is the param tree or one shaped
    like it (Adam's moments): MLP_0 actor, MLP_1 critic, Dense_0 mu head,
    Dense_1 value head, optional log_sigma."""
    linears = _linears(net.actor) + _linears(net.critic) + [net.mu, net.value]
    dense = _tower(tree["MLP_0"]) + _tower(tree["MLP_1"]) + [tree["Dense_0"], tree["Dense_1"]]
    yield from _dense_leaves(zip(linears, dense))
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


def disc_leaves(net: Discriminator, tree: dict):
    """(torch parameter, the matching leaf of a flax Discriminator tree in
    torch layout) pairs, for the param tree or one shaped like it (Adam's
    moments): MLP_0 the trunk, the top-level Dense_0 the logit."""
    yield from _dense_leaves(zip(_linears(net.trunk) + [net.logit], _tower(tree["MLP_0"]) + [tree["Dense_0"]]))


def discriminator_from_jax(params: dict, activation: str = "relu", device=None) -> Discriminator:
    """Load a flax Discriminator param tree (numpy leaves) into a
    Discriminator of the same widths."""
    trunk = _tower(params["MLP_0"])
    net = Discriminator(np.asarray(trunk[0]["kernel"]).shape[0], [np.asarray(d["kernel"]).shape[1] for d in trunk],
                        activation, device="cpu")
    with torch.no_grad():
        for t, x in disc_leaves(net, params):
            t.copy_(x)
    return net.to(resolve_device(device))


def vae_leaves(net: PulseVAE, tree: dict):
    """(torch parameter, the matching leaf of a flax PulseVAE tree in torch
    layout) pairs, for the param tree or one shaped like it (Adam's
    moments)."""
    e, p, d = tree["encoder"], tree["prior"], tree["decoder"]
    yield from _dense_leaves(zip(
        _linears(net.encoder.trunk) + [net.encoder.z_proj, net.encoder.z_mu, net.encoder.z_logvar]
        + _linears(net.prior.trunk) + [net.prior.mu, net.prior.logvar]
        + _linears(net.decoder.trunk) + [net.decoder.out] + _linears(net.critic) + [net.critic_head],
        _tower(e["MLP_0"]) + [e["z_proj"], e["z_mu"], e["z_logvar"]]
        + _tower(p["MLP_0"]) + [p["prior_mu"], p["prior_logvar"]]
        + _tower(d["MLP_0"]) + [d["Dense_0"]] + _tower(tree["critic"]) + [tree["critic_head"]]))


def pulse_vae_from_jax(params: dict, activation: str = "silu", full_precision: bool = False,
                       device=None) -> PulseVAE:
    """Load a flax PulseVAE param tree (numpy leaves) into a PulseVAE of the
    same widths."""
    def widths(tower):
        return [np.asarray(t["kernel"]).shape[1] for t in _tower(tower)]

    e, p, d = params["encoder"], params["prior"], params["decoder"]
    net = PulseVAE(
        obs_dim=np.asarray(e["MLP_0"]["Dense_0"]["kernel"]).shape[0],
        action_dim=np.asarray(d["Dense_0"]["kernel"]).shape[1],
        latent_dim=np.asarray(e["z_mu"]["kernel"]).shape[1],
        self_obs_dim=np.asarray(p["MLP_0"]["Dense_0"]["kernel"]).shape[0],
        encoder_units=widths(e["MLP_0"]), prior_units=widths(p["MLP_0"]), decoder_units=widths(d["MLP_0"]),
        critic_units=widths(params["critic"]), activation=activation, full_precision=full_precision, device="cpu",
    )
    with torch.no_grad():
        for t, x in vae_leaves(net, params):
            t.copy_(x)
    return net.to(resolve_device(device))
