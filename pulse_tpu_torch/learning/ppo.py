"""PPO: rollout, GAE and the clipped-surrogate update.

Counterpart of `pulse_tpu/learning/ppo.py` (feed-forward networks; the
recurrent path and the data-parallel update are not ported):

  * `rollout` steps the env `horizon_length` times under the policy and
    stores what the update reads in [T, B, ...] buffers allocated once: the
    observation, the unclipped action, its neg-log-prob, the value, the
    reward and the done/terminate flags. The env gets the clipped action.
  * `compute_gae` uses the reference's terminate-masked bootstrap: early
    termination zeroes the next value, a timeout keeps it.
  * `update` runs `mini_epochs` passes of shuffled minibatches: the loss
    normalizes obs with the stats from the start of the epoch while
    `obs_rms` absorbs the rollout (the reference's temp_running_mean),
    `value_rms` absorbs the returns before they are normalized, advantages
    are normalized with the ddof-0 std, and each step clips to the global
    grad norm before Adam.

Random draws (action noise, minibatch permutations) come from the agent's
`torch.Generator`. On CUDA the network runs under bf16 autocast.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import torch

from pulse_tpu_torch.learning.networks import ActorCritic, actor_critic_from_jax, flax_leaves
from pulse_tpu_torch.learning.running_norm import RunningMeanStd, running_mean_std_from_jax


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


@dataclasses.dataclass
class TrainState:
    network: ActorCritic
    optimizer: torch.optim.Adam      # over all of network's parameters
    obs_rms: RunningMeanStd
    value_rms: RunningMeanStd
    env_state: Any
    epoch: int = 0


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

    @classmethod
    def empty(cls, T: int, B: int, obs_dim: int, action_dim: int, device) -> "Rollout":
        f = dict(device=device)
        return cls(
            obs=torch.empty(T, B, obs_dim, **f), actions=torch.empty(T, B, action_dim, **f),
            neglogp=torch.empty(T, B, **f), values=torch.empty(T, B, **f), rewards=torch.empty(T, B, **f),
            dones=torch.empty(T, B, dtype=torch.bool, **f), terminates=torch.empty(T, B, dtype=torch.bool, **f),
        )


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


def ppo_loss(cfg: PPOConfig, net: ActorCritic, batch: dict):
    """(total loss, {a_loss, c_loss, b_loss, entropy}) of one minibatch whose
    obs are already normalized."""
    mu, log_sigma, value_norm = net(batch["obs_norm"])
    neglogp = gaussian_neglogp(mu, log_sigma, batch["actions"])
    ratio = torch.exp(batch["neglogp"] - neglogp)
    adv = batch["advantages"]
    a_loss = -torch.minimum(adv * ratio, adv * torch.clamp(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip)).mean()
    target = batch["returns_norm"] if cfg.normalize_value else batch["returns"]
    c_loss = 0.5 * torch.mean((value_norm - target) ** 2)
    soft = 1.1   # bound loss: penalize |mu| beyond 1.1
    b_loss = torch.mean(torch.sum(torch.clamp(mu - soft, min=0.0) ** 2 + torch.clamp(mu + soft, max=0.0) ** 2, dim=-1))
    entropy = torch.sum(log_sigma + 0.5 * math.log(2 * math.pi * math.e))
    total = a_loss + cfg.critic_coef * c_loss + cfg.bounds_loss_coef * b_loss - cfg.entropy_coef * entropy
    return total, {"a_loss": a_loss.detach(), "c_loss": c_loss.detach(), "b_loss": b_loss.detach(),
                   "entropy": entropy.detach()}


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """Scale the gradients to a global norm of at most max_norm (optax
    clip_by_global_norm), in place and without a host sync."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


class PPOAgent:
    """Owns the env, the config and the random generator; the train state
    (network, optimizer, normalizers, env state) is passed in and out."""

    def __init__(self, env, config: PPOConfig | None = None, network: ActorCritic | None = None, seed: int = 0):
        self.env = env
        self.config = config or PPOConfig()
        self.device = env.device
        self.network = network or ActorCritic(env.obs_dim, env.action_dim, device=self.device, seed=seed)
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
        )

    def _value(self, ts: TrainState, obs: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        _, _, value = ts.network(ts.obs_rms.normalize(obs) if cfg.normalize_input else obs)
        return ts.value_rms.denormalize(value[..., None])[..., 0] if cfg.normalize_value else value

    @torch.no_grad()
    def rollout(self, ts: TrainState) -> tuple[TrainState, Rollout, torch.Tensor]:
        """horizon_length env steps; returns the buffers (overwritten by the
        next rollout) and the value of the final observation."""
        cfg, env = self.config, self.env
        T, B = cfg.horizon_length, ts.env_state.obs.shape[0]
        if self._buffers is None or self._buffers.obs.shape[:2] != (T, B):
            self._buffers = Rollout.empty(T, B, env.obs_dim, env.action_dim, self.device)
        roll = self._buffers
        obs_rms = ts.obs_rms if cfg.normalize_input else None
        value_rms = ts.value_rms if cfg.normalize_value else None
        st = ts.env_state
        for t in range(T):
            action, _, neglogp, value = policy_step(ts.network, st.obs, self.generator, obs_rms, value_rms)
            roll.obs[t] = st.obs
            roll.actions[t] = action
            roll.neglogp[t] = neglogp
            roll.values[t] = value
            st = env.step(st, torch.clamp(action, -1.0, 1.0))
            roll.rewards[t] = st.reward
            roll.dones[t] = st.done
            roll.terminates[t] = st.terminate
            self._record_step(t, st)
        ts.env_state = st
        return ts, roll, self._value(ts, st.obs)

    def _record_step(self, t: int, state) -> None:
        """A hook for what a subclass keeps of step t's env state (after the
        auto-reset merge); PPO keeps nothing more."""

    def update(self, ts: TrainState, roll: Rollout, advantages: torch.Tensor, returns: torch.Tensor):
        cfg = self.config
        T, B = roll.rewards.shape
        N = T * B
        flat_obs = roll.obs.reshape(N, -1)
        obs_rms = ts.obs_rms.update(flat_obs) if cfg.normalize_input else ts.obs_rms
        returns = returns.reshape(N)
        value_rms = ts.value_rms.update(returns[:, None]) if cfg.normalize_value else ts.value_rms
        adv = advantages.reshape(N)
        if cfg.normalize_advantage:
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        data = {
            # the epoch-start stats: obs_rms absorbs the rollout only after the update
            "obs_norm": ts.obs_rms.normalize(flat_obs) if cfg.normalize_input else flat_obs,
            "actions": roll.actions.reshape(N, -1),
            "neglogp": roll.neglogp.reshape(N),
            "advantages": adv,
            "returns": returns,
            "returns_norm": value_rms.normalize(returns[:, None])[:, 0],
        }
        mb = min(cfg.minibatch_size, N)
        params = [p for p in ts.network.parameters() if p.requires_grad]
        steps = []
        for _ in range(cfg.mini_epochs):
            perm = torch.randperm(N, generator=self.generator, device=self.device)
            for i in range(N // mb):
                idx = perm[i * mb : (i + 1) * mb]
                total, metrics = ppo_loss(cfg, ts.network, {k: v[idx] for k, v in data.items()})
                ts.optimizer.zero_grad(set_to_none=True)
                total.backward()
                clip_by_global_norm_([p.grad for p in params], cfg.grad_norm)
                ts.optimizer.step()
                steps.append(metrics)
        ts.obs_rms, ts.value_rms = obs_rms, value_rms
        ts.epoch += 1
        return ts, {k: torch.stack([m[k] for m in steps]).mean() for k in steps[0]}

    def train_epoch(self, ts: TrainState):
        """One PPO epoch: rollout, GAE, update. The metrics also hold each
        phase's seconds (host clock, ended by a device synchronize)."""
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


def train_state_from_jax(jax_ts, learning_rate: float, env_state=None, activation: str = "silu",
                         init_sigma: float = -2.9, device=None) -> TrainState:
    """The port's TrainState from a JAX TrainState with numpy leaves:
    params through actor_critic_from_jax, optax Adam's count/mu/nu into
    torch Adam's step/exp_avg/exp_avg_sq (kernels transposed), and the two
    normalizers."""
    net = actor_critic_from_jax(jax_ts.params, activation=activation, init_sigma=init_sigma, device=device)
    opt = torch.optim.Adam(net.parameters(), lr=learning_rate)
    adam = _find_adam_state(jax_ts.opt_state)
    step = float(adam.count)
    for (p, m), (_, v) in zip(flax_leaves(net, adam.mu), flax_leaves(net, adam.nu)):
        opt.state[p] = {"step": torch.tensor(step), "exp_avg": m.to(p.device), "exp_avg_sq": v.to(p.device)}

    def rms(r):
        return running_mean_std_from_jax({"mean": r.mean, "var": r.var, "count": r.count}, device=net.mu.weight.device)

    return TrainState(network=net, optimizer=opt, obs_rms=rms(jax_ts.obs_rms), value_rms=rms(jax_ts.value_rms),
                      env_state=env_state, epoch=int(jax_ts.epoch))
