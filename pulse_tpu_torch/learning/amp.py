"""AMP, the adversarial motion prior: discriminator, style reward, buffers.

Counterpart of `pulse_tpu/learning/amp.py`:

  * demos are windows of `num_amp_obs_steps` consecutive AMP rows sampled
    from the motion store, newest frame first, each row carrying its own
    clip's shape columns;
  * the demo and replay buffers are fixed-size device ring buffers;
  * the discriminator loss is the BCE (as softplus) of agent against demo
    logits, plus an R1 gradient penalty on the normalized demo inputs, an
    L2 on the logit layer's kernel and a weight decay on every kernel;
  * the style reward is -log(1 - sigmoid(D)), mixed with the task reward
    by `task_reward_w` / `disc_reward_w` (device scalars, so that a
    schedule can flip them between epochs);
  * under a mesh (`env.mesh`) the discriminator step is `_update_dp`:
    the demo and replay batches are drawn on every rank alike and each
    rank takes its slice, the agent rows come from the rank's own rollout
    shard, `amp_rms` absorbs the global moments, the gradients and metrics
    are mean-all-reduced, and the replay push is every rank's agent rows
    in rank order, so the buffers stay the same on every rank.

The discriminator computes in float32 (`networks.Discriminator`) and is
trained by its own Adam. Random draws come from the module's
`torch.Generator`, but for a mesh's rank-local masks (`rollout_generator`).
Everything here is GEMMs, gathers and elementwise ops: no hand kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from pulse_tpu_torch.learning.networks import Discriminator, disc_leaves, discriminator_from_jax
from pulse_tpu_torch.learning.ppo import _find_adam_state
from pulse_tpu_torch.learning.running_norm import RunningMeanStd, running_mean_std_from_jax
from pulse_tpu_torch.motion.motion_lib import get_motion_state, sample_motions, sample_time
from pulse_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_mean_, grads_of, rollout_generator


@dataclasses.dataclass(frozen=True)
class AMPConfig:
    disc_units: tuple = (1024, 512)
    disc_coef: float = 5.0              # unused, as in the JAX package (own optimizer, own lr)
    disc_logit_reg: float = 0.01
    disc_grad_penalty: float = 5.0
    disc_reward_scale: float = 2.0
    disc_weight_decay: float = 0.0001
    disc_learning_rate: float = 1e-4
    amp_batch_size: int = 512
    amp_buffer_size: int = 16384
    task_reward_w: float = 0.5
    disc_reward_w: float = 0.5
    # zero a random contiguous chunk of the disc inputs of a share of the batch
    amp_dropout: bool = False
    amp_dropout_prob: float = 0.3
    amp_dropout_frac: float = 0.2


@dataclasses.dataclass
class RingBuffer:
    """Fixed-size device buffer: pushes wrap around, samples are uniform
    over the filled rows. `push` writes in place."""

    data: torch.Tensor   # [capacity, dim]
    head: int = 0
    size: int = 0

    @classmethod
    def create(cls, capacity: int, dim: int, device=None) -> "RingBuffer":
        return cls(torch.zeros(capacity, dim, device=device))

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def push(self, batch: torch.Tensor) -> None:
        """Row i of the batch goes to (head + i) % capacity; of a batch
        longer than the buffer the last rows win."""
        n, cap = batch.shape[0], self.capacity
        keep = min(n, cap)
        idx = (self.head + n - keep + torch.arange(keep, device=self.data.device)) % cap
        self.data[idx] = batch[n - keep:]
        self.head = (self.head + n) % cap
        self.size = min(self.size + n, cap)

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        idx = torch.randint(0, max(self.size, 1), (n,), generator=generator, device=self.data.device)
        return self.data[idx]


@dataclasses.dataclass
class AMPState:
    disc: Discriminator
    optimizer: torch.optim.Adam      # over the discriminator's parameters
    amp_rms: RunningMeanStd
    demo_buffer: RingBuffer
    replay_buffer: RingBuffer
    task_reward_w: torch.Tensor      # [] the reward mix, flipped by the getup schedule
    disc_reward_w: torch.Tensor


class AMPModule:
    """The AMP piece of an agent: owns the env, the config and the random
    generator; the state (discriminator, optimizer, normalizer, buffers,
    weights) is passed in and out."""

    def __init__(self, env, config: AMPConfig | None = None, seed: int = 0):
        self.env = env
        self.config = config or AMPConfig()
        self.device = env.device
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def init(self) -> AMPState:
        """A fresh discriminator, and the demo buffer a quarter full."""
        cfg, dim, dev = self.config, self.env.amp_obs_dim, self.device
        disc = Discriminator(dim, cfg.disc_units, device=dev, seed=self.seed)
        state = AMPState(
            disc=disc,
            optimizer=torch.optim.Adam(disc.parameters(), lr=cfg.disc_learning_rate),
            amp_rms=RunningMeanStd.create(dim, device=dev),
            demo_buffer=RingBuffer.create(cfg.amp_buffer_size, dim, device=dev),
            replay_buffer=RingBuffer.create(cfg.amp_buffer_size, dim, device=dev),
            task_reward_w=torch.tensor(cfg.task_reward_w, device=dev),
            disc_reward_w=torch.tensor(cfg.disc_reward_w, device=dev),
        )
        state.demo_buffer.push(self.fetch_demo(cfg.amp_buffer_size // 4))
        return state

    # ------------------------------------------------------------------ #
    # demos from the motion store
    # ------------------------------------------------------------------ #

    def _dt_steps(self) -> tuple[float, int]:
        return self.env.model.config.control_dt, self.env.config.num_amp_obs_steps

    def fetch_demo(self, n: int) -> torch.Tensor:
        """[n, S·A] demo windows: a clip by the store's weights, an end time
        at least S - 1 steps into it, the S frames back from there."""
        motion, g = self.env.motion, self.generator
        dt, S = self._dt_steps()
        ids = sample_motions(g, motion, n)
        t0 = sample_time(g, motion, ids, truncate_time=dt * (S - 1)) + dt * (S - 1)
        return self._build_demo_steps(ids, t0, S)

    def _build_demo_steps(self, ids: torch.Tensor, t0: torch.Tensor, steps: int) -> torch.Tensor:
        """AMP rows of `steps` frames at t0 - k·dt, k = 0..steps-1 (newest
        first), each with its clip's shape columns: [n, steps·A]."""
        dt, _ = self._dt_steps()
        times = t0[:, None] - torch.arange(steps, dtype=torch.float32, device=self.device) * dt
        flat_ids = ids.repeat_interleave(steps)
        st = get_motion_state(self.env.motion, flat_ids, times.reshape(-1))
        return self.env.amp_obs_from_motion_state(st, self._demo_shape_rows(flat_ids)).reshape(ids.shape[0], -1)

    def _demo_shape_rows(self, flat_ids: torch.Tensor) -> torch.Tensor | None:
        """Per-sample rows laid out as the env's shape row ([gender, betas]?
        [limb weights]?) from the store's per-clip shape params; None when
        the AMP rows carry no shape channels."""
        cfg, m = self.env.config, self.env.motion
        # a task env's config has none of the flags
        shape_disc, limb, shape = (getattr(cfg, k, False) for k in ("has_shape_obs_disc", "has_limb_weight_obs",
                                                                     "has_shape_obs"))
        if not (shape_disc or limb):
            return None
        parts = []
        if shape:
            parts.append(m.shape_params[flat_ids])
        if limb:
            parts.append(m.limb_weights[flat_ids])
        return torch.cat(parts, dim=-1)

    def fetch_demo_enc_pair(self, n: int, enc_steps: int = 30):
        """An encoder/discriminator demo pair: one `enc_steps` window a clip
        and a num_amp_obs_steps window inside it. Returns (ids, enc_times,
        enc_obs [n, enc_steps·A], times, obs [n, S·A])."""
        motion, g = self.env.motion, self.generator
        dt, S = self._dt_steps()
        enc_window = dt * (enc_steps - 1)
        ids = sample_motions(g, motion, n)
        span = torch.clamp(motion.motion_lengths[ids], max=enc_window)
        enc_t = sample_time(g, motion, ids, truncate_time=enc_window) + span
        t = enc_t - torch.rand(n, generator=g, device=self.device) * torch.clamp(span - dt * S, min=0.0)
        return ids, enc_t, self._build_demo_steps(ids, enc_t, enc_steps), t, self._build_demo_steps(ids, t, S)

    def fetch_demo_pair(self, n: int, enc_steps: int = 30):
        """Two nearby `enc_steps` windows of one clip (a positive pair for a
        motion encoder). Returns (ids, t0, obs0, t1, obs1)."""
        motion, g = self.env.motion, self.generator
        dt, _ = self._dt_steps()
        enc_window = dt * (enc_steps - 1)
        ids = sample_motions(g, motion, n)
        lengths = motion.motion_lengths[ids]
        t0 = sample_time(g, motion, ids, truncate_time=enc_window) + torch.clamp(lengths, max=enc_window)
        t1 = torch.minimum(t0 + torch.rand(n, generator=g, device=self.device) * 0.5, lengths)
        return ids, t0, self._build_demo_steps(ids, t0, enc_steps), t1, self._build_demo_steps(ids, t1, enc_steps)

    # ------------------------------------------------------------------ #
    # rewards
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def disc_reward(self, state: AMPState, amp_obs: torch.Tensor) -> torch.Tensor:
        """Style reward [...] of AMP windows [..., S·A]:
        -log(max(1 - sigmoid(D), 1e-4)) · disc_reward_scale."""
        prob = torch.sigmoid(state.disc(state.amp_rms.normalize(amp_obs)))
        return -torch.log(torch.clamp(1.0 - prob, min=1e-4)) * self.config.disc_reward_scale

    def combine_rewards(self, task_r: torch.Tensor, disc_r: torch.Tensor,
                        state: AMPState | None = None) -> torch.Tensor:
        """The task/style mix, by the state's weights where given."""
        if state is not None:
            return state.task_reward_w * task_r + state.disc_reward_w * disc_r
        cfg = self.config
        return cfg.task_reward_w * task_r + cfg.disc_reward_w * disc_r

    # ------------------------------------------------------------------ #
    # discriminator update
    # ------------------------------------------------------------------ #

    def _disc_loss(self, disc: Discriminator, agent_obs: torch.Tensor, demo_obs: torch.Tensor,
                   rms: RunningMeanStd):
        """(total loss, {disc_loss (the BCE), disc_grad_pen, disc_acc_agent,
        disc_acc_demo}) on raw agent and demo windows. The R1 penalty is the
        gradient of the summed demo logits with respect to the
        discriminator's input, the normalized (and clipped) demo windows,
        kept in the graph so that the total backpropagates through it."""
        cfg = self.config
        agent_logits = disc(rms.normalize(agent_obs))
        demo_n = rms.normalize(demo_obs).detach().requires_grad_(True)
        demo_logits = disc(demo_n)
        bce = 0.5 * (F.softplus(agent_logits).mean() + F.softplus(-demo_logits).mean())
        (grad_demo,) = torch.autograd.grad(demo_logits.sum(), demo_n, create_graph=True)
        grad_pen = torch.sum(grad_demo**2, dim=-1).mean()
        wd = sum(torch.sum(p**2) for p in disc.parameters() if p.ndim == 2)
        logit_reg = torch.sum(disc.logit.weight**2)
        total = (bce + 0.5 * cfg.disc_grad_penalty * grad_pen + cfg.disc_logit_reg * logit_reg
                 + cfg.disc_weight_decay * wd)
        return total, {
            "disc_loss": bce.detach(),
            "disc_grad_pen": grad_pen.detach(),
            "disc_acc_agent": (agent_logits < 0).float().mean(),
            "disc_acc_demo": (demo_logits > 0).float().mean(),
        }

    def update(self, state: AMPState, rollout_amp_obs: torch.Tensor) -> tuple[AMPState, dict]:
        """One discriminator step from a rollout's AMP windows [T, B, S·A]:
        fresh demos into the demo buffer and a batch out of it; an agent
        batch from the rollout, half of it swapped for replay rows once
        replay holds any; `amp_rms` absorbs the rollout and the fresh demos
        before the loss; one Adam step; the agent batch (before the swap)
        into replay."""
        mesh = getattr(self.env, "mesh", None)
        if mesh is not None:
            return self._update_dp(mesh, state, rollout_amp_obs)
        cfg, g, dev = self.config, self.generator, self.device
        n = cfg.amp_batch_size
        flat = rollout_amp_obs.reshape(-1, rollout_amp_obs.shape[-1])

        demo_new = self.fetch_demo(n)
        state.demo_buffer.push(demo_new)
        demo_obs = state.demo_buffer.sample(g, n)
        agent_obs = flat[torch.randint(0, flat.shape[0], (n,), generator=g, device=dev)]
        replay_obs = state.replay_buffer.sample(g, n)
        use_replay = (torch.rand(n, 1, generator=g, device=dev) < 0.5) & (state.replay_buffer.size > 0)
        agent_mix = torch.where(use_replay, replay_obs, agent_obs)

        if cfg.amp_dropout:
            mask = self._dropout_mask(agent_mix.shape[-1], g)
            apply = torch.rand(n, 1, generator=g, device=dev) < cfg.amp_dropout_prob
            agent_mix = torch.where(apply, agent_mix * mask, agent_mix)
            demo_obs = torch.where(apply, demo_obs * mask, demo_obs)

        # the moments of rollout ∪ fresh demos, merged without concatenating
        # the rollout (0.9 GB at 3072 envs)
        v_f, m_f = torch.var_mean(flat, dim=0, correction=0)
        v_d, m_d = torch.var_mean(demo_new, dim=0, correction=0)
        n_f, n_d = flat.shape[0], demo_new.shape[0]
        tot = n_f + n_d
        var = (n_f * v_f + n_d * v_d + (m_f - m_d) ** 2 * (n_f * n_d / tot)) / tot
        rms = state.amp_rms.update_moments((n_f * m_f + n_d * m_d) / tot, var, tot)

        total, metrics = self._disc_loss(state.disc, agent_mix, demo_obs, rms)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.replay_buffer.push(agent_obs)
        state.amp_rms = rms
        return state, metrics

    def _dropout_mask(self, dim: int, g: torch.Generator) -> torch.Tensor:
        """[dim] ones but for a contiguous chunk of amp_dropout_frac · dim
        zeros at a start drawn from g."""
        cfg, dev = self.config, self.device
        width = max(int(dim * cfg.amp_dropout_frac), 1)
        start = torch.randint(0, max(dim - width, 1), (1,), generator=g, device=dev)
        cols = torch.arange(dim, device=dev)
        return ((cols < start) | (cols >= start + width)).float()

    def _update_dp(self, mesh, state: AMPState, rollout_amp_obs: torch.Tensor) -> tuple[AMPState, dict]:
        """`update` under data parallelism, this rank's rollout [T, B, S·A]
        its shard. From the replicated generator, alike on every rank: the
        fresh demos and their push, a demo and a replay batch of
        amp_batch_size rows, of which each rank takes its nl = n / D, the
        agent row indices (the same indices into each rank's own rows) and
        the dropout window's start. From the rank's own generator: the
        replay swap and the dropout masks. `amp_rms` absorbs the moments of
        the global rollout merged with the fresh demos; the gradients and
        metrics are mean-all-reduced before the Adam step; the replay push
        is every rank's agent rows in rank order. Raises ValueError unless
        the mesh size divides amp_batch_size."""
        cfg, g, dev = self.config, self.generator, self.device
        D, r = mesh.size, mesh.rank
        n = cfg.amp_batch_size
        if n % D:
            raise ValueError(f"DP disc update needs amp_batch_size ({n}) divisible by the mesh size ({D})")
        nl = n // D
        flat = rollout_amp_obs.reshape(-1, rollout_amp_obs.shape[-1])
        gr = rollout_generator(self)

        demo_new = self.fetch_demo(n)
        state.demo_buffer.push(demo_new)
        demo_obs = state.demo_buffer.sample(g, n)[r * nl:(r + 1) * nl]
        replay_obs = state.replay_buffer.sample(g, n)[r * nl:(r + 1) * nl]
        agent_obs = flat[torch.randint(0, flat.shape[0], (nl,), generator=g, device=dev)]
        use_replay = (torch.rand(nl, 1, generator=gr, device=dev) < 0.5) & (state.replay_buffer.size > 0)
        agent_mix = torch.where(use_replay, replay_obs, agent_obs)
        if cfg.amp_dropout:
            mask = self._dropout_mask(agent_mix.shape[-1], g)
            apply = torch.rand(nl, 1, generator=gr, device=dev) < cfg.amp_dropout_prob
            agent_mix = torch.where(apply, agent_mix * mask, agent_mix)
            demo_obs = torch.where(apply, demo_obs * mask, demo_obs)

        # the moments of [global rollout rows, fresh demos], no gather
        glob = torch.stack([flat.mean(dim=0), (flat * flat).mean(dim=0)])
        all_reduce_mean_([glob], mesh)
        n_f, n_d = flat.shape[0] * D, demo_new.shape[0]
        tot = n_f + n_d
        m = (n_f * glob[0] + n_d * demo_new.mean(dim=0)) / tot
        e2 = (n_f * glob[1] + n_d * (demo_new * demo_new).mean(dim=0)) / tot
        rms = state.amp_rms.update_moments(m, torch.clamp(e2 - m * m, min=0.0), tot)

        total, metrics = self._disc_loss(state.disc, agent_mix, demo_obs, rms)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        all_reduce_mean_(grads_of(list(state.disc.parameters())) + [metrics[k] for k in sorted(metrics)], mesh)
        state.optimizer.step()
        state.replay_buffer.push(all_gather_rows(agent_obs, mesh))
        state.amp_rms = rms
        return state, metrics


def amp_state_from_jax(jax_amp, learning_rate: float = 1e-4, device=None) -> AMPState:
    """The port's AMPState from a JAX AMPState with numpy leaves: the
    discriminator through discriminator_from_jax, optax Adam's
    count/mu/nu into torch Adam's step/exp_avg/exp_avg_sq (kernels
    transposed), `amp_rms`, both buffers and the reward weights."""
    disc = discriminator_from_jax(jax_amp.disc_params, device=device)
    dev = disc.logit.weight.device
    opt = torch.optim.Adam(disc.parameters(), lr=learning_rate)
    adam = _find_adam_state(jax_amp.disc_opt_state)
    mu, nu = dict(disc_leaves(disc, adam.mu)), dict(disc_leaves(disc, adam.nu))
    for p in disc.parameters():
        opt.state[p] = {"step": torch.tensor(float(adam.count)), "exp_avg": mu[p].to(dev),
                        "exp_avg_sq": nu[p].to(dev)}
    r = jax_amp.amp_rms

    def ring(b) -> RingBuffer:
        return RingBuffer(torch.tensor(np.asarray(b.data, np.float32), device=dev), int(b.head), int(b.size))

    return AMPState(
        disc=disc, optimizer=opt,
        amp_rms=running_mean_std_from_jax({"mean": r.mean, "var": r.var, "count": r.count}, device=dev),
        demo_buffer=ring(jax_amp.demo_buffer), replay_buffer=ring(jax_amp.replay_buffer),
        task_reward_w=torch.tensor(float(jax_amp.task_reward_w), device=dev),
        disc_reward_w=torch.tensor(float(jax_amp.disc_reward_w), device=dev),
    )
