"""Policy/value networks, AMP discriminator, the PULSE VAE and the latent
heads.

Counterpart of `pulse_tpu/learning/networks.py`:

  * `ActorCritic`: separate actor and critic MLP towers with a Gaussian
    policy head of fixed (or learned) log-sigma;
  * `RNNActorCritic`: an MLP trunk, flax's LSTM cell (carry (c, h), reset
    by the `done` flag before the cell runs) and the two heads;
  * `CNNActorCritic`: the obs' trailing grid through `ConvEncoder` (flax's
    'SAME' padding, channels-last flatten), then the two towers;
  * `SeptActorCritic`: self-obs and task-obs towers (and an optional
    max-pooled point-net channel) into the actor, the critic on the whole
    obs;
  * `Discriminator`: AMP's MLP to one logit, always float32 (its R1
    penalty differentiates through it twice);
  * `PulseVAE`: PULSE's student, an encoder of the whole observation to a
    posterior (mu, logvar), a learned prior of the self observation, and a
    decoder of [self obs, prior mu + posterior sample] to the action, plus
    a critic tower that distillation does not train;
  * `ZEmbedding`: the sphere and VQ latent heads (`vq_quantizer`).

Each has a loader from the JAX package's param tree (numpy leaves),
`*_from_jax`, and a `*_leaves` map of such a tree onto its parameters.

On CUDA the MLP trunks of the policy and the VAE (and the CNN's
convolutions) run under bf16 autocast; parameters and every head stay
float32 (the VAE's heads compute in their weights' dtype, so that a
float64 copy runs in float64), and so do the LSTM cell, `SeptActorCritic`
and `ZEmbedding`, as in the JAX package. On the CPU everything is float32.
`PulseVAE(full_precision=True)` (the JAX package's `PulseVAE(dtype=None)`)
computes everything in float32 with autocast off, on CUDA too.
Initialization is flax's default (lecun-normal kernels, zero biases), but
for the discriminator's logit layer (uniform, fan-in variance 1) and the
LSTM's recurrent kernels (orthogonal).
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from pulse_tpu_torch._device import resolve_device

_ACT = {"relu": nn.ReLU, "silu": nn.SiLU, "elu": nn.ELU, "tanh": nn.Tanh, "gelu": nn.GELU}

# flax truncated_normal variance scaling: the std of a unit normal cut at
# +-2 is 0.8796..., so the draw is rescaled to reach the target variance
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(w: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    """flax variance_scaling(scale, "fan_in", "truncated_normal") on a torch
    [out, in, ...] weight (a Linear's or a convolution's)."""
    std = math.sqrt(scale / w[0].numel()) / _TRUNC_STD
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


def _f32(x: torch.Tensor):
    """Autocast off on x's device, an enclosing one's too: the float32
    parts of a network."""
    return torch.autocast(x.device.type, enabled=False)


def _heads(x: torch.Tensor, full_precision: bool):
    """The float32 heads after a trunk: with full_precision autocast off,
    an enclosing one's too."""
    return _f32(x) if full_precision else contextlib.nullcontext()


def _flax_init_(module: nn.Module, seed: int, scale_of=lambda lin: 1.0) -> None:
    """flax default initialization of every Linear and Conv2d of `module`:
    kernels by variance scaling (`scale_of(layer)`, lecun-normal at 1),
    biases zero."""
    g = torch.Generator().manual_seed(seed)
    for lin in module.modules():
        if isinstance(lin, (nn.Linear, nn.Conv2d)):
            _variance_scaling_(lin.weight.data, scale_of(lin), g)
            if lin.bias is not None:
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


class LSTMCell(nn.Module):
    """flax's OptimizedLSTMCell: gates i, f, g, o from an input projection
    without a bias plus a hidden projection with one; the carry is (c, h).
    forward(carry, x) -> ((c', h'), h')."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.ih = nn.Linear(in_dim, 4 * hidden, bias=False)
        self.hh = nn.Linear(hidden, 4 * hidden)

    def forward(self, carry, x: torch.Tensor):
        c, h = carry
        i, f, g, o = (self.ih(x) + self.hh(h)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class RNNActorCritic(nn.Module):
    """A shared MLP trunk, an LSTM cell, then the mu and value heads.
    forward(carry, obs, done=None) -> (carry', (mu, log_sigma, value)):
    `done` [B] zeroes an env's carry before the cell runs, so that the
    first obs of an episode does not see the last one's memory. The trunk
    autocasts to bf16 on CUDA; the cell and the heads run in float32."""

    is_recurrent = True

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        trunk_units: Sequence[int] = (1024, 512),
        rnn_size: int = 256,
        activation: str = "silu",
        init_sigma: float = -2.9,
        learn_sigma: bool = False,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.rnn_size = rnn_size
        self.trunk = MLP(obs_dim, trunk_units, activation)
        self.cell = LSTMCell(trunk_units[-1], rnn_size)
        self.mu = nn.Linear(rnn_size, action_dim)
        self.value = nn.Linear(rnn_size, 1)
        sigma = torch.full((action_dim,), float(init_sigma))
        if learn_sigma:
            self.log_sigma = nn.Parameter(sigma)
        else:
            self.register_buffer("log_sigma", sigma)
        _flax_init_(self, seed, lambda lin: 0.01 if lin is self.mu else 1.0)
        # flax's recurrent kernels: orthogonal, one [H, H] block a gate
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for block in self.cell.hh.weight.data.chunk(4, dim=0):
                nn.init.orthogonal_(block, generator=g)
        self.to(device)

    def initial_carry(self, batch: int) -> tuple:
        z = torch.zeros(batch, self.rnn_size, device=self.mu.weight.device)
        return (z, z.clone())

    def forward(self, carry, obs: torch.Tensor, done: torch.Tensor | None = None):
        if done is not None:
            keep = (~done.bool()).float()[..., None]
            carry = (carry[0] * keep, carry[1] * keep)
        with _autocast(obs):
            x = self.trunk(obs)
        with _f32(obs):
            carry, x = self.cell(carry, x.float())
            mu = self.mu(x)
            value = self.value(x)[..., 0]
        return carry, (mu, self.log_sigma, value)


def _same_pad(n: int, k: int, s: int) -> tuple:
    """flax 'SAME' padding of one axis: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_out_dim(grid_shape: Sequence[int], channels: Sequence[int], strides: Sequence[int]) -> int:
    """The flattened feature width of 'SAME'-padded convolutions."""
    h, w = grid_shape
    for s in strides:
        h, w = -(-h // s), -(-w // s)
    return h * w * channels[-1]


class ConvEncoder(nn.Module):
    """Conv2d layers with flax's 'SAME' padding (for stride 2 and k 3 on an
    even size: 0 before, 1 after), each then the activation; the features
    flattened channels-last, as flax's [H, W, C]. forward(x [N, C, H, W])
    -> [N, H' W' C']."""

    def __init__(self, in_channels: int = 1, channels: Sequence[int] = (16, 32), kernels: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (2, 2), activation: str = "silu"):
        super().__init__()
        self.convs = nn.ModuleList()
        for ch, k, s in zip(channels, kernels, strides):
            self.convs.append(nn.Conv2d(in_channels, ch, k, stride=s))
            in_channels = ch
        self.act = _ACT[activation]()

    def out_dim(self, grid_shape: Sequence[int]) -> int:
        return _conv_out_dim(grid_shape, [c.out_channels for c in self.convs], [c.stride[0] for c in self.convs])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            (k, _), (s, _) = conv.kernel_size, conv.stride
            ph, pw = _same_pad(x.shape[-2], k, s), _same_pad(x.shape[-1], k, s)
            x = self.act(conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1]))))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class CNNActorCritic(nn.Module):
    """An actor-critic whose obs ends in a grid (the 16 x 16 height map):
    the grid through a ConvEncoder, its features after the flat obs, then
    the actor and critic MLPs and their heads. forward(obs) -> (mu,
    log_sigma, value). On CUDA the convolutions and the MLPs autocast to
    bf16; the features enter the concat and the heads in float32."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        grid_shape: Sequence[int] = (16, 16),
        conv_channels: Sequence[int] = (16, 32),
        actor_units: Sequence[int] = (1024, 512),
        critic_units: Sequence[int] = (1024, 512),
        activation: str = "silu",
        init_sigma: float = -2.9,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.grid_shape = tuple(grid_shape)
        self.conv = ConvEncoder(1, conv_channels, activation=activation)
        feat_dim = obs_dim - self.grid_shape[0] * self.grid_shape[1] + self.conv.out_dim(self.grid_shape)
        self.actor = MLP(feat_dim, actor_units, activation)
        self.critic = MLP(feat_dim, critic_units, activation)
        self.mu = nn.Linear(actor_units[-1], action_dim)
        self.value = nn.Linear(critic_units[-1], 1)
        self.register_buffer("log_sigma", torch.full((action_dim,), float(init_sigma)))
        _flax_init_(self, seed, lambda lin: 0.01 if lin is self.mu else 1.0)
        self.to(device)

    def features(self, obs: torch.Tensor) -> torch.Tensor:
        """[..., flat obs ++ the grid's conv features] in float32."""
        gh, gw = self.grid_shape
        lead = obs.shape[:-1]
        flat, grid = obs[..., : -gh * gw], obs[..., -gh * gw:]
        with _autocast(obs):
            enc = self.conv(grid.reshape(-1, 1, gh, gw))
        return torch.cat([flat, enc.float().reshape(*lead, -1)], dim=-1)

    def forward(self, obs: torch.Tensor):
        feat = self.features(obs)
        with _autocast(obs):
            h_actor = self.actor(feat)
            h_critic = self.critic(feat)
        with _f32(obs):
            mu = self.mu(h_actor.float())
            value = self.value(h_critic.float())[..., 0]
        return mu, self.log_sigma, value


class SeptActorCritic(nn.Module):
    """Separate self-obs and task-obs towers whose features (and, with
    `num_points`, the max-pooled features of a shared per-point MLP over
    the task obs' last num_points * point_dim entries) feed the actor MLP;
    the critic MLP reads the whole obs. forward(obs) -> (mu, log_sigma,
    value). Everything computes in float32 (the JAX module has no compute
    dtype), with autocast off."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        self_obs_dim: int,
        self_units: Sequence[int] = (1024, 512),
        task_units: Sequence[int] = (1024, 512),
        actor_units: Sequence[int] = (1024, 512),
        critic_units: Sequence[int] = (2048, 1024),
        activation: str = "silu",
        init_sigma: float = -2.9,
        num_points: int = 0,
        point_dim: int = 0,
        point_units: Sequence[int] = (64, 64),
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.self_obs_dim, self.num_points, self.point_dim = self_obs_dim, num_points, point_dim
        n_pts = num_points * point_dim
        self.point_net = MLP(point_dim, point_units, activation) if num_points > 0 else None
        self.self_enc = MLP(self_obs_dim, self_units, activation)
        self.task_enc = MLP(obs_dim - self_obs_dim - n_pts, task_units, activation)
        actor_in = self_units[-1] + task_units[-1] + (point_units[-1] if num_points > 0 else 0)
        self.actor = MLP(actor_in, actor_units, activation)
        self.critic = MLP(obs_dim, critic_units, activation)
        self.mu = nn.Linear(actor_units[-1], action_dim)
        self.value = nn.Linear(critic_units[-1], 1)
        self.register_buffer("log_sigma", torch.full((action_dim,), float(init_sigma)))
        _flax_init_(self, seed)
        self.to(device)

    def forward(self, obs: torch.Tensor):
        with _f32(obs):
            obs = obs.float()
            self_obs, task_obs = obs[..., : self.self_obs_dim], obs[..., self.self_obs_dim:]
            feats = []
            if self.num_points > 0:
                n_pts = self.num_points * self.point_dim
                pts = task_obs[..., -n_pts:].reshape(*task_obs.shape[:-1], self.num_points, self.point_dim)
                task_obs = task_obs[..., :-n_pts]
                feats.append(self.point_net(pts).amax(dim=-2))
            h = self.actor(torch.cat([self.self_enc(self_obs), self.task_enc(task_obs), *feats], dim=-1))
            return self.mu(h), self.log_sigma, self.value(self.critic(obs))[..., 0]


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


class ZEmbedding(nn.Module):
    """The latent head of the non-Gaussian z spaces, forward(feat,
    codebook=None) -> (z, extras):

      * "sphere": a projection onto the sphere of radius embedding_norm;
      * "vq_vae": the nearest codebook entry, straight-through;
      * "vq_vae_hybrid": the code, then a continuous channel clipped to
        [-0.1, 0.1];
      * "vq_vae_res": the sphere-projected code quantized, projected again
        and scaled by sin(z_var) + 1.

    extras holds the quantizer's commit and codebook losses, the indexes and
    the pre-quantization z (none for "sphere"). float32, autocast off."""

    Z_TYPES = ("sphere", "vq_vae", "vq_vae_hybrid", "vq_vae_res")

    def __init__(self, in_dim: int, latent_dim: int = 32, z_type: str = "sphere", embedding_norm: float = 5.0,
                 device=None, seed: int = 0):
        super().__init__()
        if z_type not in self.Z_TYPES:
            raise ValueError(f"unknown z_type {z_type!r}")
        self.z_type, self.embedding_norm = z_type, embedding_norm
        if z_type == "sphere":
            self.z_proj = nn.Linear(in_dim, latent_dim)
        else:
            self.z_quant = nn.Linear(in_dim, latent_dim)
        if z_type in ("vq_vae_hybrid", "vq_vae_res"):
            self.z_var = nn.Linear(in_dim, latent_dim)
        _flax_init_(self, seed)
        self.to(resolve_device(device))

    def forward(self, feat: torch.Tensor, codebook=None):
        from pulse_tpu_torch.learning.vq_quantizer import project_to_norm, quantize

        with _f32(feat):
            feat = feat.float()
            if self.z_type == "sphere":
                return project_to_norm(self.z_proj(feat), self.embedding_norm, "sphere"), {}
            z = self.z_quant(feat)
            if self.z_type == "vq_vae_res":
                z_q, idx, losses = quantize(codebook, project_to_norm(z, self.embedding_norm, "sphere"))
                out = project_to_norm(z_q, self.embedding_norm, "sphere") * (torch.sin(self.z_var(feat)) + 1.0)
            else:
                z_q, idx, losses = quantize(codebook, z)
                out = z_q
                if self.z_type == "vq_vae_hybrid":
                    out = torch.cat([z_q, project_to_norm(self.z_var(feat), 0.1, "uniform")], dim=-1)
            return out, {"indexes": idx, "z_before_quant": z, **losses}


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


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _load(net: nn.Module, leaves) -> nn.Module:
    with torch.no_grad():
        for t, x in leaves:
            t.copy_(x)
    return net


def rnn_leaves(net: RNNActorCritic, tree: dict):
    """(torch parameter or buffer, the matching leaf of a flax
    RNNActorCritic tree in torch layout) pairs, for the param tree or one
    shaped like it: MLP_0 the trunk, OptimizedLSTMCell_0 the cell (the
    input kernels ii, if, ig, io stacked into `ih`, the hidden kernels and
    biases hi, hf, hg, ho into `hh`), Dense_0 mu, Dense_1 value, optional
    log_sigma."""
    cell = tree["OptimizedLSTMCell_0"]
    yield from _dense_leaves(zip(_linears(net.trunk) + [net.mu, net.value],
                                 _tower(tree["MLP_0"]) + [tree["Dense_0"], tree["Dense_1"]]))
    yield net.cell.ih.weight, torch.tensor(np.concatenate([_np(cell[k]["kernel"]) for k in ("ii", "if", "ig", "io")],
                                                          axis=1).T)
    yield net.cell.hh.weight, torch.tensor(np.concatenate([_np(cell[k]["kernel"]) for k in ("hi", "hf", "hg", "ho")],
                                                          axis=1).T)
    yield net.cell.hh.bias, torch.tensor(np.concatenate([_np(cell[k]["bias"]) for k in ("hi", "hf", "hg", "ho")]))
    if "log_sigma" in tree:
        yield net.log_sigma, torch.tensor(_np(tree["log_sigma"]))


def rnn_actor_critic_from_jax(params: dict, activation: str = "silu", init_sigma: float = -2.9,
                              device=None) -> RNNActorCritic:
    """Load a flax RNNActorCritic param tree (numpy leaves) into an
    RNNActorCritic of the same widths."""
    trunk = _tower(params["MLP_0"])
    net = RNNActorCritic(
        _np(trunk[0]["kernel"]).shape[0], _np(params["Dense_0"]["kernel"]).shape[1],
        trunk_units=[_np(d["kernel"]).shape[1] for d in trunk],
        rnn_size=_np(params["OptimizedLSTMCell_0"]["hi"]["kernel"]).shape[0], activation=activation,
        init_sigma=init_sigma, learn_sigma="log_sigma" in params, device="cpu",
    )
    return _load(net, rnn_leaves(net, params)).to(resolve_device(device))


def sept_leaves(net: SeptActorCritic, tree: dict):
    """(torch parameter, leaf of a flax SeptActorCritic tree in torch
    layout) pairs: the towers self_enc, task_enc, actor, critic and
    point_net by name, Dense_0 mu, Dense_1 value."""
    names = ["self_enc", "task_enc", "actor", "critic"] + (["point_net"] if net.point_net is not None else [])
    pairs = [(lin, d) for n in names for lin, d in zip(_linears(getattr(net, n)), _tower(tree[n]))]
    yield from _dense_leaves(pairs + [(net.mu, tree["Dense_0"]), (net.value, tree["Dense_1"])])


def sept_actor_critic_from_jax(params: dict, self_obs_dim: int | None = None, activation: str = "silu",
                               init_sigma: float = -2.9, device=None) -> SeptActorCritic:
    """Load a flax SeptActorCritic param tree (numpy leaves) into a
    SeptActorCritic of the same widths. The obs, self-obs and point widths
    are read off the kernels; the point count is what the critic's input
    leaves past the self and task towers'."""
    def widths(name):
        return [_np(d["kernel"]).shape[1] for d in _tower(params[name])]

    def in_dim(name):
        return _np(params[name]["Dense_0"]["kernel"]).shape[0]

    obs_dim, self_dim = in_dim("critic"), in_dim("self_enc") if self_obs_dim is None else self_obs_dim
    point_dim = in_dim("point_net") if "point_net" in params else 0
    num_points = (obs_dim - self_dim - in_dim("task_enc")) // point_dim if point_dim else 0
    net = SeptActorCritic(
        obs_dim, _np(params["Dense_0"]["kernel"]).shape[1], self_dim, self_units=widths("self_enc"),
        task_units=widths("task_enc"), actor_units=widths("actor"), critic_units=widths("critic"),
        activation=activation, init_sigma=init_sigma, num_points=num_points, point_dim=point_dim,
        point_units=widths("point_net") if point_dim else (64, 64), device="cpu",
    )
    return _load(net, sept_leaves(net, params)).to(resolve_device(device))


def cnn_leaves(net: CNNActorCritic, tree: dict):
    """(torch parameter, leaf of a flax CNNActorCritic tree in torch layout)
    pairs: conv/Conv_i kernels [kh, kw, in, out] to [out, in, kh, kw], MLP_0
    actor, MLP_1 critic, Dense_0 mu, Dense_1 value."""
    for i, conv in enumerate(net.conv.convs):
        c = tree["conv"][f"Conv_{i}"]
        yield conv.weight, torch.tensor(_np(c["kernel"]).transpose(3, 2, 0, 1).copy())
        yield conv.bias, torch.tensor(_np(c["bias"]))
    yield from _dense_leaves(zip(_linears(net.actor) + _linears(net.critic) + [net.mu, net.value],
                                 _tower(tree["MLP_0"]) + _tower(tree["MLP_1"]) + [tree["Dense_0"], tree["Dense_1"]]))


def cnn_actor_critic_from_jax(params: dict, grid_shape: Sequence[int] = (16, 16), activation: str = "silu",
                              init_sigma: float = -2.9, device=None) -> CNNActorCritic:
    """Load a flax CNNActorCritic param tree (numpy leaves, strides 2) into
    a CNNActorCritic of the same widths."""
    channels = [_np(params["conv"][f"Conv_{i}"]["kernel"]).shape[3] for i in range(len(params["conv"]))]
    conv_dim = _conv_out_dim(grid_shape, channels, [2] * len(channels))
    feat_dim = _np(params["MLP_0"]["Dense_0"]["kernel"]).shape[0]
    net = CNNActorCritic(
        feat_dim - conv_dim + grid_shape[0] * grid_shape[1], _np(params["Dense_0"]["kernel"]).shape[1],
        grid_shape=grid_shape, conv_channels=channels,
        actor_units=[_np(d["kernel"]).shape[1] for d in _tower(params["MLP_0"])],
        critic_units=[_np(d["kernel"]).shape[1] for d in _tower(params["MLP_1"])],
        activation=activation, init_sigma=init_sigma, device="cpu",
    )
    return _load(net, cnn_leaves(net, params)).to(resolve_device(device))


def z_embedding_leaves(net: ZEmbedding, tree: dict):
    """(torch parameter, leaf of a flax ZEmbedding tree in torch layout)
    pairs: z_proj, or z_quant and z_var."""
    yield from _dense_leaves((getattr(net, n), tree[n]) for n in ("z_proj", "z_quant", "z_var") if n in tree)


def z_embedding_from_jax(params: dict, z_type: str, embedding_norm: float = 5.0, device=None) -> ZEmbedding:
    """Load a flax ZEmbedding param tree (numpy leaves) into a ZEmbedding of
    the same z type and widths."""
    k = _np(params["z_proj" if z_type == "sphere" else "z_quant"]["kernel"])
    net = ZEmbedding(k.shape[0], k.shape[1], z_type, embedding_norm, device="cpu")
    return _load(net, z_embedding_leaves(net, params)).to(resolve_device(device))
