"""PPO: rollout, GAE and the clipped-surrogate update, for feed-forward and
recurrent networks.

Counterpart of `pulse_tpu/learning/ppo.py`:

  * `rollout` steps the env `horizon_length` times under the policy and
    stores what the update reads in [T, B, ...] buffers allocated once: the
    observation, the unclipped action, its neg-log-prob, the value, the
    reward and the done/terminate flags. The env gets the clipped action.
    With a recurrent network (`network.is_recurrent`) it is
    `rollout_rnn`, which also stores the carry at each step's entry and the
    entry `done` that resets it, and carries the hidden state in
    `TrainState.hidden` from one epoch to the next.
  * `compute_gae` uses the reference's terminate-masked bootstrap: early
    termination zeroes the next value, a timeout keeps it.
  * `update` runs `mini_epochs` passes of shuffled minibatches: the loss
    normalizes obs with the stats from the start of the epoch while
    `obs_rms` absorbs the rollout (the reference's temp_running_mean; off,
    the loss reads the updated stats), `value_rms` absorbs the returns
    before they are normalized, advantages are normalized with the ddof-0
    std, and each step clips to the global grad norm (unless
    `truncate_grads` is off) before Adam. With a recurrent network it is
    `update_rnn` (truncated BPTT): the minibatches are whole sequences of
    `seq_len` consecutive steps of one env, each replayed through the cell
    from its stored first carry with the stored resets (`rnn_loss`).
  * under a mesh (`env.mesh`, `pulse_tpu_torch.parallel`), `update` is
    the data-parallel update (the JAX package's `_update_dp`): each rank
    minibatches its own rollout shard, the normalizers and the advantages
    take the global moments, and the gradients and metrics are
    mean-all-reduced before the clip and the Adam step. `update_rnn` gathers the rollout in rank order and computes
    the global update on every rank, as GSPMD computes it in the JAX
    package (which has no per-shard recurrent update).

Random draws come from the agent's `torch.Generator`: the minibatch
permutations always, the action noise without a mesh; under one the
action noise comes from the rank's own generator (`rollout_generator`).
On CUDA the network runs under bf16 autocast.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from pulse_tpu_torch.learning.networks import (ActorCritic, actor_critic_from_jax, cnn_actor_critic_from_jax, cnn_leaves,
                                               flax_leaves, rnn_actor_critic_from_jax, rnn_leaves,
                                               sept_actor_critic_from_jax, sept_leaves)
from pulse_tpu_torch.learning.running_norm import RunningMeanStd, running_mean_std_from_jax
from pulse_tpu_torch.parallel.mesh import all_reduce_mean_, gather_env_axis, grads_of, pmoments, rollout_generator


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 64
    horizon_length: int = 32
    minibatch_size: int = 512
    mini_epochs: int = 6
    gamma: float = 0.99
    tau: float = 0.95
    learning_rate: float = 2e-5
    e_clip: float = 0.2
    critic_coef: float = 5.0
    bounds_loss_coef: float = 10.0
    entropy_coef: float = 0.0
    grad_norm: float = 50.0
    normalize_input: bool = True
    normalize_value: bool = True
    normalize_advantage: bool = True
    truncate_grads: bool = True       # clip each step's gradients to grad_norm
    seq_len: int = 4                  # a recurrent network's BPTT sequence length; divides horizon_length
    temp_running_mean: bool = True    # the loss normalizes obs with the epoch-start stats


@dataclasses.dataclass
class TrainState:
    network: ActorCritic
    optimizer: torch.optim.Adam      # over all of network's parameters
    obs_rms: RunningMeanStd
    value_rms: RunningMeanStd
    env_state: Any
    epoch: int = 0
    hidden: tuple | None = None      # a recurrent network's carry (c, h) [B, H]


@dataclasses.dataclass
class Rollout:
    """What the update reads, [T, B, ...]."""

    obs: torch.Tensor          # [T, B, O] raw
    actions: torch.Tensor      # [T, B, A] unclipped
    neglogp: torch.Tensor      # [T, B]
    values: torch.Tensor       # [T, B] denormalized
    rewards: torch.Tensor      # [T, B]
    dones: torch.Tensor        # [T, B] bool
    terminates: torch.Tensor   # [T, B] bool
    # recurrent networks only: the carry (c, h) at each step's entry, before
    # the reset, and the entry done flag that resets it
    hiddens: tuple | None = None           # ([T, B, H], [T, B, H])
    prev_dones: torch.Tensor | None = None  # [T, B] bool

    @classmethod
    def empty(cls, T: int, B: int, obs_dim: int, action_dim: int, device, rnn_size: int = 0) -> "Rollout":
        f = dict(device=device)
        rec = {}
        if rnn_size:
            rec = dict(hiddens=(torch.empty(T, B, rnn_size, **f), torch.empty(T, B, rnn_size, **f)),
                       prev_dones=torch.empty(T, B, dtype=torch.bool, **f))
        return cls(
            obs=torch.empty(T, B, obs_dim, **f), actions=torch.empty(T, B, action_dim, **f),
            neglogp=torch.empty(T, B, **f), values=torch.empty(T, B, **f), rewards=torch.empty(T, B, **f),
            dones=torch.empty(T, B, dtype=torch.bool, **f), terminates=torch.empty(T, B, dtype=torch.bool, **f),
            **rec,
        )


def gaussian_neglogp(mu: torch.Tensor, log_sigma: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    d = action - mu
    return (
        0.5 * torch.sum((d / torch.exp(log_sigma)) ** 2, dim=-1)
        + torch.sum(log_sigma)
        + 0.5 * mu.shape[-1] * math.log(2 * math.pi)
    )


def _sample(mu, log_sigma, value, generator: torch.Generator, value_rms: RunningMeanStd | None):
    if value_rms is not None:
        value = value_rms.denormalize(value[..., None])[..., 0]
    eps = torch.randn(mu.shape, generator=generator, device=mu.device)
    action = mu + torch.exp(log_sigma) * eps
    return action, mu, gaussian_neglogp(mu, log_sigma, action), value


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
    return _sample(*net(obs_norm), generator, value_rms)


@torch.no_grad()
def rnn_policy_step(net, carry: tuple, obs: torch.Tensor, done: torch.Tensor, generator: torch.Generator,
                    obs_rms: RunningMeanStd | None = None, value_rms: RunningMeanStd | None = None):
    """policy_step of a recurrent network from `carry`, reset where `done`.
    Returns (carry', (action, mu, neglogp, value))."""
    obs_norm = obs_rms.normalize(obs) if obs_rms is not None else obs
    carry, out = net(carry, obs_norm, done)
    return carry, _sample(*out, generator, value_rms)


def compute_gae(cfg: PPOConfig, roll: Rollout, last_value: torch.Tensor):
    """(advantages, returns) [T, B]: a_t = delta_t + gamma tau (1 - done_t)
    a_{t+1}, with delta_t bootstrapping the next value unless the step
    terminated early."""
    next_values = torch.cat([roll.values[1:], last_value[None]], dim=0)
    not_term = 1.0 - roll.terminates.float()
    c = cfg.gamma * cfg.tau * (1.0 - roll.dones.float())
    delta = roll.rewards + cfg.gamma * next_values * not_term - roll.values
    advantages = torch.empty_like(delta)
    a = torch.zeros_like(last_value)
    for t in range(delta.shape[0] - 1, -1, -1):
        a = delta[t] + c[t] * a
        advantages[t] = a
    return advantages, advantages + roll.values


def _ppo_terms(cfg: PPOConfig, mu, neglogp, value_norm, entropy, batch: dict):
    """(total loss, {a_loss, c_loss, b_loss, entropy}) from the policy's mu
    [N, A], neg-log-probs [N] and values [N] on a minibatch's N rows."""
    ratio = torch.exp(batch["neglogp"].reshape(-1) - neglogp)
    adv = batch["advantages"].reshape(-1)
    a_loss = -torch.minimum(adv * ratio, adv * torch.clamp(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip)).mean()
    target = (batch["returns_norm"] if cfg.normalize_value else batch["returns"]).reshape(-1)
    c_loss = 0.5 * torch.mean((value_norm - target) ** 2)
    soft = 1.1   # bound loss: penalize |mu| beyond 1.1
    b_loss = torch.mean(torch.sum(torch.clamp(mu - soft, min=0.0) ** 2 + torch.clamp(mu + soft, max=0.0) ** 2, dim=-1))
    total = a_loss + cfg.critic_coef * c_loss + cfg.bounds_loss_coef * b_loss - cfg.entropy_coef * entropy
    return total, {"a_loss": a_loss.detach(), "c_loss": c_loss.detach(), "b_loss": b_loss.detach(),
                   "entropy": entropy.detach()}


def ppo_loss(cfg: PPOConfig, net: ActorCritic, batch: dict):
    """(total loss, {a_loss, c_loss, b_loss, entropy}) of one minibatch whose
    obs are already normalized."""
    mu, log_sigma, value_norm = net(batch["obs_norm"])
    neglogp = gaussian_neglogp(mu, log_sigma, batch["actions"])
    entropy = torch.sum(log_sigma + 0.5 * math.log(2 * math.pi * math.e))
    return _ppo_terms(cfg, mu, neglogp, value_norm, entropy, batch)


def rnn_loss(cfg: PPOConfig, net, batch: dict):
    """ppo_loss of a minibatch of [mb, L] sequences of normalized obs,
    each replayed through the cell from its stored first carry
    (`hidden`, (c, h) [mb, H]) with the stored entry resets
    (`prev_dones`); the entropy from the first step's log-sigma."""
    carry, obs, dones, actions = batch["hidden"], batch["obs_norm"], batch["prev_dones"], batch["actions"]
    mus, neglogps, values = [], [], []
    for step in range(obs.shape[1]):
        carry, (mu, log_sigma, value) = net(carry, obs[:, step], dones[:, step])
        if step == 0:
            entropy = torch.sum(log_sigma) + 0.5 * mu.shape[-1] * math.log(2 * math.pi * math.e)
        mus.append(mu)
        neglogps.append(gaussian_neglogp(mu, log_sigma, actions[:, step]))
        values.append(value)
    mu = torch.stack(mus, dim=1).reshape(-1, mus[0].shape[-1])
    return _ppo_terms(cfg, mu, torch.stack(neglogps, dim=1).reshape(-1), torch.stack(values, dim=1).reshape(-1),
                      entropy, batch)


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """Scale the gradients to a global norm of at most max_norm (optax
    clip_by_global_norm), in place and without a host sync."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


def _rows(v, idx: torch.Tensor):
    return tuple(x[idx] for x in v) if isinstance(v, tuple) else v[idx]


class PPOAgent:
    """Owns the env, the config and the random generator; the train state
    (network, optimizer, normalizers, env state, a recurrent network's
    carry) is passed in and out. A recurrent network (`is_recurrent`) is
    rolled out and updated by `rollout_rnn` and `update_rnn`, to which
    `rollout` and `update` hand over."""

    def __init__(self, env, config: PPOConfig | None = None, network: ActorCritic | None = None, seed: int = 0):
        self.env = env
        self.config = config or PPOConfig()
        self.device = env.device
        self.network = network or ActorCritic(env.obs_dim, env.action_dim, device=self.device, seed=seed)
        self.recurrent = bool(getattr(self.network, "is_recurrent", False))
        if self.recurrent and self.config.horizon_length % self.config.seq_len:
            raise ValueError("horizon_length must be divisible by seq_len")
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._buffers: Rollout | None = None

    def init(self) -> TrainState:
        cfg = self.config
        return TrainState(
            network=self.network,
            optimizer=torch.optim.Adam(self.network.parameters(), lr=cfg.learning_rate),
            obs_rms=RunningMeanStd.create(self.env.obs_dim, device=self.device),
            value_rms=RunningMeanStd.create(1, device=self.device),
            env_state=self.env.reset(cfg.num_envs),
            hidden=self.network.initial_carry(cfg.num_envs) if self.recurrent else None,
        )

    def _value(self, ts: TrainState, obs: torch.Tensor, done: torch.Tensor | None = None) -> torch.Tensor:
        """The denormalized value of obs; a recurrent network's from
        ts.hidden, reset where `done`."""
        cfg = self.config
        obs_norm = ts.obs_rms.normalize(obs) if cfg.normalize_input else obs
        if self.recurrent:
            _, (_, _, value) = ts.network(ts.hidden, obs_norm, done)
        else:
            _, _, value = ts.network(obs_norm)
        return ts.value_rms.denormalize(value[..., None])[..., 0] if cfg.normalize_value else value

    def _rollout_buffers(self, B: int) -> Rollout:
        T = self.config.horizon_length
        if self._buffers is None or self._buffers.obs.shape[:2] != (T, B):
            self._buffers = Rollout.empty(T, B, self.env.obs_dim, self.env.action_dim, self.device,
                                          rnn_size=self.network.rnn_size if self.recurrent else 0)
        return self._buffers

    @torch.no_grad()
    def rollout(self, ts: TrainState) -> tuple[TrainState, Rollout, torch.Tensor]:
        """horizon_length env steps; returns the buffers (overwritten by the
        next rollout) and the value of the final observation."""
        if self.recurrent:
            return self.rollout_rnn(ts)
        cfg = self.config
        roll = self._rollout_buffers(ts.env_state.obs.shape[0])
        obs_rms = ts.obs_rms if cfg.normalize_input else None
        value_rms = ts.value_rms if cfg.normalize_value else None
        st, g = ts.env_state, rollout_generator(self)
        for t in range(cfg.horizon_length):
            action, _, neglogp, value = policy_step(ts.network, st.obs, g, obs_rms, value_rms)
            roll.obs[t] = st.obs
            st = self._store_step(roll, t, st, action, neglogp, value)
        ts.env_state = st
        return ts, roll, self._value(ts, st.obs)

    @torch.no_grad()
    def rollout_rnn(self, ts: TrainState) -> tuple[TrainState, Rollout, torch.Tensor]:
        """rollout under a recurrent network: each step also stores the
        carry at its entry and its entry done flag (the env state's, which
        marks a fresh obs after an auto-reset) and runs the cell from that
        carry, reset where done; ts.hidden leaves with the carry after the
        last step, and the bootstrap value goes through the cell from it."""
        cfg = self.config
        roll = self._rollout_buffers(ts.env_state.obs.shape[0])
        obs_rms = ts.obs_rms if cfg.normalize_input else None
        value_rms = ts.value_rms if cfg.normalize_value else None
        st, hidden, g = ts.env_state, ts.hidden, rollout_generator(self)
        for t in range(cfg.horizon_length):
            roll.hiddens[0][t], roll.hiddens[1][t] = hidden
            roll.prev_dones[t] = st.done
            roll.obs[t] = st.obs
            hidden, (action, _, neglogp, value) = rnn_policy_step(ts.network, hidden, st.obs, st.done, g,
                                                                  obs_rms, value_rms)
            st = self._store_step(roll, t, st, action, neglogp, value)
        ts.env_state, ts.hidden = st, hidden
        return ts, roll, self._value(ts, st.obs, st.done)

    def _store_step(self, roll: Rollout, t: int, st, action, neglogp, value):
        """Step the env on the clipped action and store step t; returns the
        next env state."""
        roll.actions[t] = action
        roll.neglogp[t] = neglogp
        roll.values[t] = value
        st = self.env.step(st, torch.clamp(action, -1.0, 1.0))
        roll.rewards[t] = st.reward
        roll.dones[t] = st.done
        roll.terminates[t] = st.terminate
        self._record_step(t, st)
        return st

    def _record_step(self, t: int, state) -> None:
        """A hook for what a subclass keeps of step t's env state (after the
        auto-reset merge); PPO keeps nothing more."""

    def _norms(self, ts: TrainState, flat_obs: torch.Tensor, returns: torch.Tensor, mesh=None):
        """(obs_rms after the rollout, the stats the loss normalizes with,
        value_rms after the returns); with a mesh the normalizers absorb the
        global moments (E[x²] − m², at the count of every rank's rows)."""
        cfg = self.config

        def absorb(rms, x):
            if mesh is None:
                return rms.update(x)
            return rms.update_moments(*pmoments(x, mesh), x.shape[0] * mesh.size)

        obs_rms = absorb(ts.obs_rms, flat_obs) if cfg.normalize_input else ts.obs_rms
        loss_obs_rms = ts.obs_rms if cfg.temp_running_mean else obs_rms
        value_rms = absorb(ts.value_rms, returns.reshape(-1, 1)) if cfg.normalize_value else ts.value_rms
        return obs_rms, loss_obs_rms, value_rms

    def _advantages(self, advantages: torch.Tensor, mesh=None) -> torch.Tensor:
        """Normalized by their (global, with a mesh) mean and ddof-0 std."""
        if not self.config.normalize_advantage:
            return advantages
        if mesh is None:
            return (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
        m, v = pmoments(advantages.reshape(-1, 1), mesh)
        return (advantages - m[0]) / (torch.sqrt(v[0]) + 1e-8)

    def _minibatch_steps(self, ts: TrainState, data: dict, n: int, mb: int, loss, mesh=None) -> dict:
        """mini_epochs passes over n rows of `data` in shuffled minibatches of
        mb, one Adam step each; the mean metrics. With a mesh, each step's
        gradients and metrics are mean-all-reduced before the clip."""
        cfg = self.config
        params = [p for p in ts.network.parameters() if p.requires_grad]
        steps = []
        for _ in range(cfg.mini_epochs):
            perm = torch.randperm(n, generator=self.generator, device=self.device)
            for i in range(n // mb):
                idx = perm[i * mb : (i + 1) * mb]
                total, metrics = loss(cfg, ts.network, {k: _rows(v, idx) for k, v in data.items()})
                ts.optimizer.zero_grad(set_to_none=True)
                total.backward()
                if mesh is not None:
                    all_reduce_mean_(grads_of(params) + [metrics[k] for k in sorted(metrics)], mesh)
                if cfg.truncate_grads:
                    clip_by_global_norm_([p.grad for p in params], cfg.grad_norm)
                ts.optimizer.step()
                steps.append(metrics)
        return {k: torch.stack([m[k] for m in steps]).mean() for k in steps[0]}

    def update(self, ts: TrainState, roll: Rollout, advantages: torch.Tensor, returns: torch.Tensor):
        """The PPO update of a rollout [T, B]. Under a mesh (`env.mesh`) it
        is the data-parallel update (the JAX package's `_update_dp`): the
        rollout is this rank's shard of T · B · D rows, the normalizers
        and the advantages take the global moments, each rank shuffles its
        own rows with the replicated generator into minibatches of
        minibatch_size / D, and each step's gradients and metrics are
        mean-all-reduced before the clip and the Adam step, so every rank
        takes the same step; ValueError unless the mesh size divides
        num_envs and the global minibatch."""
        if self.recurrent:
            return self.update_rnn(ts, roll, advantages, returns)
        cfg = self.config
        mesh = getattr(self.env, "mesh", None)
        D = 1 if mesh is None else mesh.size
        T, B = roll.rewards.shape
        N = T * B
        mb = min(cfg.minibatch_size, N * D)
        if mesh is not None and (cfg.num_envs % D or mb % D):
            raise ValueError(f"DP update needs num_envs ({cfg.num_envs}) and minibatch_size ({mb}) divisible by "
                             f"the mesh size ({D})")
        flat_obs = roll.obs.reshape(N, -1)
        returns = returns.reshape(N)
        obs_rms, loss_obs_rms, value_rms = self._norms(ts, flat_obs, returns, mesh)
        data = {
            "obs_norm": loss_obs_rms.normalize(flat_obs) if cfg.normalize_input else flat_obs,
            "actions": roll.actions.reshape(N, -1),
            "neglogp": roll.neglogp.reshape(N),
            "advantages": self._advantages(advantages.reshape(N), mesh),
            "returns": returns,
            "returns_norm": value_rms.normalize(returns[:, None])[:, 0],
        }
        metrics = self._minibatch_steps(ts, data, N, mb // D, ppo_loss, mesh)
        ts.obs_rms, ts.value_rms = obs_rms, value_rms
        ts.epoch += 1
        return ts, metrics

    def update_rnn(self, ts: TrainState, roll: Rollout, advantages: torch.Tensor, returns: torch.Tensor):
        """update by truncated BPTT: the rollout cut into n_seq = (T / L) B
        sequences of L = seq_len consecutive steps of one env, each with
        the carry stored at its first step; minibatches of
        max(min(minibatch_size / L, n_seq), 1) sequences (`rnn_loss`).
        Under a mesh every rank gathers the rollout, the advantages and the
        returns in rank order and computes this global update on them with
        the replicated generator, so all ranks take the same steps."""
        mesh = getattr(self.env, "mesh", None)
        if mesh is not None:
            roll, advantages, returns = gather_env_axis((roll, advantages, returns), mesh, dim=1)
        cfg = self.config
        T, B = roll.rewards.shape
        L = cfg.seq_len
        n_seq = (T // L) * B

        def to_seq(x):   # [T, B, ...] -> [n_seq, L, ...]: contiguous time chunks of each env
            return x.reshape(T // L, L, B, *x.shape[2:]).transpose(1, 2).reshape(n_seq, L, *x.shape[2:])

        obs_rms, loss_obs_rms, value_rms = self._norms(ts, roll.obs.reshape(T * B, -1), returns)
        data = {
            "obs_norm": to_seq(loss_obs_rms.normalize(roll.obs) if cfg.normalize_input else roll.obs),
            "actions": to_seq(roll.actions),
            "neglogp": to_seq(roll.neglogp),
            "advantages": to_seq(self._advantages(advantages)),
            "returns": to_seq(returns),
            "prev_dones": to_seq(roll.prev_dones),
            # the carry at each sequence's first step, replayed as stored in
            # every mini-epoch
            "hidden": tuple(h.reshape(T // L, L, B, -1)[:, 0].reshape(n_seq, -1) for h in roll.hiddens),
        }
        data["returns_norm"] = value_rms.normalize(data["returns"].reshape(-1, 1)).reshape(n_seq, L)
        metrics = self._minibatch_steps(ts, data, n_seq, max(min(cfg.minibatch_size // L, n_seq), 1), rnn_loss)
        ts.obs_rms, ts.value_rms = obs_rms, value_rms
        ts.epoch += 1
        return ts, metrics

    def train_epoch(self, ts: TrainState):
        """One PPO epoch: rollout, GAE, update (the recurrent ones for a
        recurrent network). The metrics also hold each phase's seconds
        (host clock, ended by a device synchronize)."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        t0 = time.perf_counter()
        ts, roll, last_value = self.rollout(ts)
        sync()
        t1 = time.perf_counter()
        advantages, returns = compute_gae(self.config, roll, last_value)
        sync()
        t2 = time.perf_counter()
        ts, metrics = self.update(ts, roll, advantages, returns)
        sync()
        t3 = time.perf_counter()
        metrics.update(
            reward_mean=roll.rewards.mean(),
            episode_done_frac=roll.dones.float().mean(),
            rollout_s=t1 - t0, gae_s=t2 - t1, update_s=t3 - t2,
        )
        return ts, metrics


def _find_adam_state(opt_state):
    """The optax ScaleByAdamState (count, mu, nu) inside a chained state."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _find_adam_state(s)
            if found is not None:
                return found
    return None


def policy_from_jax(params: dict, activation: str = "silu", init_sigma: float = -2.9, device=None):
    """(network, its *_leaves map) of a JAX policy's param tree (numpy
    leaves), the class read off the tree: RNNActorCritic (an
    OptimizedLSTMCell_0), SeptActorCritic (self_enc), CNNActorCritic (conv)
    or ActorCritic."""
    kw = dict(activation=activation, init_sigma=init_sigma, device=device)
    if "OptimizedLSTMCell_0" in params:
        return rnn_actor_critic_from_jax(params, **kw), rnn_leaves
    if "self_enc" in params:
        return sept_actor_critic_from_jax(params, **kw), sept_leaves
    if "conv" in params:
        return cnn_actor_critic_from_jax(params, **kw), cnn_leaves
    return actor_critic_from_jax(params, **kw), flax_leaves


def train_state_from_jax(jax_ts, learning_rate: float, env_state=None, activation: str = "silu",
                         init_sigma: float = -2.9, device=None) -> TrainState:
    """The port's TrainState from a JAX TrainState with numpy leaves:
    params through policy_from_jax, optax Adam's count/mu/nu into torch
    Adam's step/exp_avg/exp_avg_sq (kernels transposed), the two
    normalizers and a recurrent network's carry."""
    net, leaves = policy_from_jax(jax_ts.params, activation=activation, init_sigma=init_sigma, device=device)
    opt = torch.optim.Adam(net.parameters(), lr=learning_rate)
    adam = _find_adam_state(jax_ts.opt_state)
    step = float(adam.count)
    for (p, m), (_, v) in zip(leaves(net, adam.mu), leaves(net, adam.nu)):
        opt.state[p] = {"step": torch.tensor(step), "exp_avg": m.to(p.device), "exp_avg_sq": v.to(p.device)}
    dev = net.mu.weight.device

    def rms(r):
        return running_mean_std_from_jax({"mean": r.mean, "var": r.var, "count": r.count}, device=dev)

    hidden = getattr(jax_ts, "hidden", None)
    if hidden is not None:
        hidden = tuple(torch.tensor(np.asarray(h, np.float32), device=dev) for h in hidden)
    return TrainState(network=net, optimizer=opt, obs_rms=rms(jax_ts.obs_rms), value_rms=rms(jax_ts.value_rms),
                      env_state=env_state, epoch=int(jax_ts.epoch), hidden=hidden)
