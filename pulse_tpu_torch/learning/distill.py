"""PULSE online distillation: a PulseVAE student imitates a frozen teacher
while the env runs on the student's actions.

Counterpart of `pulse_tpu/learning/distill.py`:

  * `rollout` steps the env `horizon_length` times on clip(student
    action_mu, -1, 1), the student reading the normalized observation and a
    latent noise drawn from the agent's generator, and stores in [T, B, ...]
    buffers allocated once the raw observation, the teacher's action on it,
    the noise and the env's reward.
  * `update` absorbs the rollout into `obs_rms`, normalizes the observations
    once with the new stats (with `normalize_input` off, neither: the
    rollout and the update read the raw obs), and runs `mini_epochs`
    passes of shuffled minibatches over the (T - 1) B consecutive
    (t - 1, t) pairs, gathered by index, minimizing

        RMSE(student mu_t, teacher action_t)
          + kld_coef(epoch) KL(posterior_t || learned prior_t)
          + ar1_coefficient KL(posterior_t || N(ar1_rho post_mu_{t-1}, 1))
          + prior_reg_coefficient |prior mu_t|^2

    with Adam (`kin_lr`) over the encoder, prior and decoder after a clip to
    the global grad norm. The loss reads only the encoder's mean at t - 1
    and no critic, so neither the critic nor the t - 1 prior and decoder
    are computed (the JAX package's graph drops them in XLA).
  * under a mesh (`env.mesh`) `update` is the data-parallel update (the
    JAX package's `_update_dp`): each rank minibatches the pairs of its own
    envs, `obs_rms` absorbs the global moments, every batch mean in the
    loss is the global mean (`parallel.global_mean`: bc is the square root
    of the global MSE, so averaging per-rank gradients of per-rank losses
    would not give the global gradient), and the gradients, each carrying
    the global mean's 1 / D, are sum-all-reduced before the clip and the
    Adam step. The latent noise then comes from the rank's own generator.

On CUDA the network's trunks run under bf16 autocast.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from pulse_tpu_torch.learning.networks import PulseVAE, kl_multi, pulse_vae_from_jax, vae_leaves
from pulse_tpu_torch.learning.ppo import _find_adam_state, clip_by_global_norm_
from pulse_tpu_torch.learning.running_norm import RunningMeanStd, running_mean_std_from_jax
from pulse_tpu_torch.parallel.mesh import all_reduce_sum_, global_mean, grads_of, pmoments, rollout_generator


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    num_envs: int = 64
    horizon_length: int = 32
    minibatch_size: int = 1024
    mini_epochs: int = 2
    kin_lr: float = 5e-4
    grad_norm: float = 50.0
    kld_coefficient: float = 0.01
    kld_coefficient_min: float = 0.001
    kld_anneal_start: int = 2500
    kld_anneal_end: int = 5000
    ar1_coefficient: float = 0.005
    ar1_rho: float = 0.95
    prior_reg_coefficient: float = 0.0001
    normalize_input: bool = True     # off: the student reads and trains on the raw obs


@dataclasses.dataclass
class DistillState:
    network: PulseVAE
    optimizer: torch.optim.Adam      # over the encoder, prior and decoder
    obs_rms: RunningMeanStd
    env_state: Any
    epoch: int = 0


@dataclasses.dataclass
class DistillRollout:
    """[T, B, ...] buffers of one rollout."""

    obs: torch.Tensor          # [T, B, O] raw
    gt_action: torch.Tensor    # [T, B, A] the teacher's
    z_noise: torch.Tensor      # [T, B, L]
    rewards: torch.Tensor      # [T, B] the env's (logged, not trained on)

    @classmethod
    def empty(cls, T: int, B: int, obs_dim: int, action_dim: int, latent_dim: int, device) -> "DistillRollout":
        return cls(obs=torch.empty(T, B, obs_dim, device=device), gt_action=torch.empty(T, B, action_dim, device=device),
                   z_noise=torch.empty(T, B, latent_dim, device=device), rewards=torch.empty(T, B, device=device))


def trained_parameters(net: PulseVAE) -> list:
    """The parameters distillation trains: the encoder's, prior's and
    decoder's (the critic gets no gradient from the loss)."""
    return [*net.encoder.parameters(), *net.prior.parameters(), *net.decoder.parameters()]


class DistillAgent:
    """Distills `teacher_fn(raw obs) -> action` into a PulseVAE student. Owns
    the env, the config and the random generator; the state (network,
    optimizer, normalizer, env state) is passed in and out."""

    def __init__(self, env, teacher_fn: Callable[[torch.Tensor], torch.Tensor], config: DistillConfig | None = None,
                 network: PulseVAE | None = None, seed: int = 0):
        self.env = env
        self.teacher_fn = teacher_fn
        self.config = config or DistillConfig()
        self.device = env.device
        self.network = network or PulseVAE(env.obs_dim, env.action_dim, self_obs_dim=env.self_obs_dim,
                                           device=self.device, seed=seed)
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._buffers: DistillRollout | None = None

    def init(self) -> DistillState:
        cfg = self.config
        return DistillState(
            network=self.network,
            optimizer=torch.optim.Adam(trained_parameters(self.network), lr=cfg.kin_lr),
            obs_rms=RunningMeanStd.create(self.env.obs_dim, device=self.device),
            env_state=self.env.reset(cfg.num_envs),
        )

    @torch.no_grad()
    def rollout(self, ds: DistillState) -> tuple[DistillState, DistillRollout]:
        """horizon_length env steps on the student's actions; returns the
        buffers (overwritten by the next rollout)."""
        cfg, env, net = self.config, self.env, ds.network
        T, B = cfg.horizon_length, ds.env_state.obs.shape[0]
        if self._buffers is None or self._buffers.obs.shape[:2] != (T, B):
            self._buffers = DistillRollout.empty(T, B, env.obs_dim, env.action_dim, net.latent_dim, self.device)
        roll = self._buffers
        st, g = ds.env_state, rollout_generator(self)
        for t in range(T):
            z = torch.randn(B, net.latent_dim, generator=g, device=self.device)
            obs_in = ds.obs_rms.normalize(st.obs) if cfg.normalize_input else st.obs
            action = torch.clamp(net.latent_action(obs_in, z)["action_mu"], -1.0, 1.0)
            roll.obs[t] = st.obs
            roll.gt_action[t] = self.teacher_fn(st.obs)
            roll.z_noise[t] = z
            st = env.step(st, action)
            roll.rewards[t] = st.reward
        ds.env_state = st
        return ds, roll

    def kld_coef(self, epoch: int) -> float:
        """kld_coefficient annealed linearly to kld_coefficient_min over
        epochs [kld_anneal_start, kld_anneal_end]."""
        cfg = self.config
        frac = min(max((epoch - cfg.kld_anneal_start) / max(cfg.kld_anneal_end - cfg.kld_anneal_start, 1), 0.0), 1.0)
        return cfg.kld_coefficient + frac * (cfg.kld_coefficient_min - cfg.kld_coefficient)

    def loss(self, net: PulseVAE, obs_prev: torch.Tensor, obs: torch.Tensor, z_noise: torch.Tensor,
             gt_action: torch.Tensor, epoch: int, mesh=None):
        """(total loss, {bc_loss, kld, ar1, prior_reg}) of a minibatch of
        (t - 1, t) pairs of normalized observations; z_noise and gt_action
        are those of t. bc is the RMSE over the whole minibatch and every
        action dimension. With a mesh every mean is over all the ranks'
        minibatches (`global_mean`)."""
        cfg = self.config
        out = net.latent_action(obs, z_noise)
        z_prev, _ = net.encoder(obs_prev)     # the AR(1) target keeps its gradient, as in the JAX package
        terms = [(out["action_mu"] - gt_action) ** 2,
                 kl_multi(out["post_mu"], out["post_logvar"], out["prior_mu"], out["prior_logvar"]),
                 kl_multi(out["post_mu"], out["post_logvar"], cfg.ar1_rho * z_prev,
                          torch.zeros_like(out["post_logvar"])),
                 torch.sum(out["prior_mu"] ** 2, dim=-1)]
        mse, kld, ar1, prior_reg = global_mean(terms, mesh) if mesh is not None else [t.mean() for t in terms]
        bc = torch.sqrt(mse)
        total = (bc + self.kld_coef(epoch) * kld + cfg.ar1_coefficient * ar1
                 + cfg.prior_reg_coefficient * prior_reg)
        return total, {"bc_loss": bc.detach(), "kld": kld.detach(), "ar1": ar1.detach(),
                       "prior_reg": prior_reg.detach()}

    def update(self, ds: DistillState, roll: DistillRollout) -> tuple[DistillState, dict]:
        """The distillation update of a rollout [T, B]. Under a mesh
        (`env.mesh`) it is the data-parallel update (the JAX package's
        `_update_dp`): the rollout is this rank's shard, `obs_rms` absorbs
        the global moments (E[x²] − m², at count T · B · D), each rank
        shuffles its own (T - 1) B pairs with the replicated generator into
        minibatches of minibatch_size / D pairs, the loss's means are global
        and the gradients are sum-all-reduced before the clip, so every rank
        takes the same step and logs the same metrics; ValueError unless
        the mesh size divides num_envs and the global minibatch."""
        cfg = self.config
        mesh = getattr(self.env, "mesh", None)
        D = 1 if mesh is None else mesh.size
        T, B = roll.obs.shape[:2]
        flat = roll.obs.reshape(T * B, -1)
        # pair p = (t - 1, t) of env b is rows (p, p + B) of the [T * B] views, p = (t - 1) B + b
        N = (T - 1) * B
        mb = min(cfg.minibatch_size, N * D)
        if mesh is not None and (cfg.num_envs % D or mb % D):
            raise ValueError(f"DP update needs num_envs ({cfg.num_envs}) and minibatch_size ({mb}) divisible by "
                             f"the mesh size ({D})")
        obs_rms = ds.obs_rms
        if cfg.normalize_input:
            obs_rms = (obs_rms.update(flat) if mesh is None
                       else obs_rms.update_moments(*pmoments(flat, mesh), T * B * D))
        obs_n = obs_rms.normalize(flat) if cfg.normalize_input else flat
        z_noise, gt = roll.z_noise.reshape(T * B, -1), roll.gt_action.reshape(T * B, -1)
        mb //= D     # this rank's pairs a minibatch
        params = [p for group in ds.optimizer.param_groups for p in group["params"]]
        steps = []
        for _ in range(cfg.mini_epochs):
            perm = torch.randperm(N, generator=self.generator, device=self.device)
            for i in range(N // mb):
                prev = perm[i * mb : (i + 1) * mb]
                cur = prev + B
                total, metrics = self.loss(ds.network, obs_n[prev], obs_n[cur], z_noise[cur], gt[cur], ds.epoch,
                                           mesh)
                ds.optimizer.zero_grad(set_to_none=True)
                total.backward()
                if mesh is not None:
                    all_reduce_sum_(grads_of(params), mesh)
                clip_by_global_norm_([p.grad for p in params], cfg.grad_norm)
                ds.optimizer.step()
                steps.append(metrics)
        metrics = {k: torch.stack([m[k] for m in steps]).mean() for k in steps[0]}
        metrics["kld_coef"] = self.kld_coef(ds.epoch)
        ds.obs_rms = obs_rms
        ds.epoch += 1
        return ds, metrics

    def train_epoch(self, ds: DistillState):
        """One distillation epoch: rollout, update. The metrics also hold the
        env's mean reward and each phase's seconds (host clock, ended by a
        device synchronize)."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        t0 = time.perf_counter()
        ds, roll = self.rollout(ds)
        sync()
        t1 = time.perf_counter()
        ds, metrics = self.update(ds, roll)
        sync()
        t2 = time.perf_counter()
        metrics.update(reward_mean=roll.rewards.mean(), rollout_s=t1 - t0, update_s=t2 - t1)
        return ds, metrics


def distill_state_from_jax(jax_ds, kin_lr: float, env_state=None, activation: str = "silu",
                           device=None) -> DistillState:
    """The port's DistillState from a JAX DistillState with numpy leaves:
    params through pulse_vae_from_jax, optax Adam's count/mu/nu of the
    trained parameters into torch Adam's step/exp_avg/exp_avg_sq (kernels
    transposed), and the normalizer."""
    net = pulse_vae_from_jax(jax_ds.params, activation=activation, device=device)
    trained = trained_parameters(net)
    opt = torch.optim.Adam(trained, lr=kin_lr)
    adam = _find_adam_state(jax_ds.opt_state)
    mu, nu = dict(vae_leaves(net, adam.mu)), dict(vae_leaves(net, adam.nu))
    for p in trained:
        opt.state[p] = {"step": torch.tensor(float(adam.count)), "exp_avg": mu[p].to(p.device),
                        "exp_avg_sq": nu[p].to(p.device)}
    r = jax_ds.obs_rms
    obs_rms = running_mean_std_from_jax({"mean": r.mean, "var": r.var, "count": r.count},
                                        device=net.critic_head.weight.device)
    return DistillState(network=net, optimizer=opt, obs_rms=obs_rms, env_state=env_state, epoch=int(jax_ds.epoch))
