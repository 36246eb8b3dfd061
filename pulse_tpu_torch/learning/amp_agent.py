"""AMPAgent: PPO on the task reward mixed with the discriminator's style
reward, and the discriminator's own update, each epoch.

Counterpart of `pulse_tpu/learning/amp_agent.py`:

  * `train_epoch`: the PPO rollout (which also keeps each step's AMP window
    of the post-merge env state), the style reward of the rollout under the
    discriminator and `amp_rms` from before the update, the mix, GAE, the
    PPO update on the mixed reward, then one discriminator step. With a
    recurrent network the rollout and the update are PPO's recurrent ones
    (`rollout_rnn`, `update_rnn`), and the AMP windows are kept the same
    way;
  * `pre_epoch` (between epochs): the getup schedule (task/style weights
    0/1 and every reset a fall state until `getup_update_epoch`, then
    0.5/0.5 and the env's configured probabilities) and, every
    `shape_resampling_interval` epochs, new per-env body shapes (with
    domain randomization's physical props re-layered on them), or on an
    env with DR's props alone, new prop multipliers;
  * `JointAMPDistillAgent`: one rollout feeds both the AMP update and a
    distillation (behaviour cloning + KL) step on the frozen teacher's
    actions for the rollout's observations.

Under a mesh (`env.mesh`) the PPO, discriminator and distillation updates
are their data-parallel variants (the JAX package's `_update_dp`) and the
rollout noise is the rank's own; the train state is placed with
`parallel.shard_train_state`.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from pulse_tpu_torch.learning.amp import AMPConfig, AMPModule, AMPState
from pulse_tpu_torch.learning.distill import DistillRollout, DistillState
from pulse_tpu_torch.learning.ppo import PPOAgent, PPOConfig, TrainState, compute_gae
from pulse_tpu_torch.parallel.mesh import rollout_generator

PROP_REDRAW_SEED = 19   # the JAX package re-draws the props from PRNGKey(19) folded with the epoch


@dataclasses.dataclass
class AMPTrainState:
    ppo: TrainState
    amp: AMPState


class AMPRolloutPPO(PPOAgent):
    """A PPOAgent whose rollout also keeps `amp_obs` [T, B, S·A], each
    step's env `amp_hist` flattened after the auto-reset merge, in a buffer
    allocated once and overwritten by the next rollout."""

    amp_obs: torch.Tensor | None = None

    def rollout(self, ts: TrainState):
        T, B = self.config.horizon_length, ts.env_state.obs.shape[0]
        if self.amp_obs is None or self.amp_obs.shape[:2] != (T, B):
            self.amp_obs = torch.empty(T, B, self.env.amp_obs_dim, device=self.device)
        return super().rollout(ts)

    def _record_step(self, t: int, state) -> None:
        self.amp_obs[t] = state.amp_obs


def _sync(device: torch.device):
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


class AMPAgent:
    """Owns the env, the PPO agent (its generator from `seed`) and the AMP
    module (from `seed + 1`); the train state is passed in and out.
    `last_rewards` holds the last epoch's task, style and mixed rewards
    [T, B]."""

    def __init__(self, env, ppo_config: PPOConfig | None = None, amp_config: AMPConfig | None = None,
                 network=None, getup_update_epoch: int = 0, shape_resampling_interval: int = 0, seed: int = 0):
        self.env = env
        self.device = env.device
        self.ppo = AMPRolloutPPO(env, ppo_config, network, seed=seed)
        self.amp = AMPModule(env, amp_config, seed=seed + 1)
        self.getup_update_epoch = int(getup_update_epoch)
        self.shape_resampling_interval = int(shape_resampling_interval)
        self.last_rewards: dict | None = None

    def init(self) -> AMPTrainState:
        ts = AMPTrainState(ppo=self.ppo.init(), amp=self.amp.init())
        if self.getup_update_epoch:
            # the style reward alone while the getup curriculum runs
            ts.amp.task_reward_w = torch.zeros((), device=self.device)
            ts.amp.disc_reward_w = torch.ones((), device=self.device)
        return ts

    def pre_epoch(self, ts: AMPTrainState, epoch: int) -> AMPTrainState:
        """The epoch schedule, before `train_epoch` of `epoch`."""
        env = self.env
        if self.getup_update_epoch:
            past = epoch > self.getup_update_epoch
            ts.amp.task_reward_w = torch.tensor(0.5 if past else 0.0, device=self.device)
            ts.amp.disc_reward_w = torch.tensor(0.5 if past else 1.0, device=self.device)
            if hasattr(env, "set_getup_phase"):
                env.set_getup_phase(past)
        if (self.shape_resampling_interval and epoch > 1 and epoch % self.shape_resampling_interval == 1
                and getattr(env, "batched_model", None) is not None):
            if getattr(env, "_shape_args", None) is not None:
                # the shapes in their original mode, DR's props re-layered on them
                env.resample_shapes()
            elif getattr(env, "_prop_rand_args", None) is not None:
                # DR alone: the prop multipliers re-drawn, from a stream of
                # their own for each epoch
                g = torch.Generator(device=env.device).manual_seed((PROP_REDRAW_SEED << 32) + epoch)
                env.randomize_physical_props(env._prop_rand_args["num_envs"], generator=g)
        return ts

    def train_epoch(self, ts: AMPTrainState):
        """Rollout, then `update_from_rollout`. The metrics hold each
        phase's seconds (host clock, ended by a device synchronize), the
        discriminator's apart: rollout_s, disc_reward_s, gae_s, update_s,
        disc_update_s."""
        sync = _sync(self.device)
        t0 = time.perf_counter()
        ppo_ts, roll, last_value = self.ppo.rollout(ts.ppo)
        sync()
        rollout_s = time.perf_counter() - t0
        ts, metrics = self.update_from_rollout(ts, ppo_ts, roll, last_value)
        metrics["rollout_s"] = rollout_s
        return ts, metrics

    def update_from_rollout(self, ts: AMPTrainState, ppo_ts: TrainState, roll, last_value: torch.Tensor):
        """Everything after the rollout, in the JAX package's order: the
        style reward under the discriminator and `amp_rms` from before this
        epoch's update, the mix, GAE and the PPO update on it, then the
        discriminator's step."""
        sync = _sync(self.device)
        t0 = time.perf_counter()
        amp_obs = self.ppo.amp_obs
        task_r = roll.rewards
        disc_r = self.amp.disc_reward(ts.amp, amp_obs)
        mixed = self.amp.combine_rewards(task_r, disc_r, ts.amp)
        mixed_roll = dataclasses.replace(roll, rewards=mixed)
        sync()
        t1 = time.perf_counter()
        advantages, returns = compute_gae(self.ppo.config, mixed_roll, last_value)
        sync()
        t2 = time.perf_counter()
        ppo_ts, metrics = self.ppo.update(ppo_ts, mixed_roll, advantages, returns)
        sync()
        t3 = time.perf_counter()
        amp_state, disc_metrics = self.amp.update(ts.amp, amp_obs)
        sync()
        t4 = time.perf_counter()
        self.last_rewards = {"task": task_r, "disc": disc_r, "mixed": mixed}
        metrics.update(disc_metrics)
        metrics.update(reward_mean=mixed.mean(), task_reward_mean=task_r.mean(), disc_reward_mean=disc_r.mean(),
                       episode_done_frac=roll.dones.float().mean(), disc_reward_s=t1 - t0, gae_s=t2 - t1,
                       update_s=t3 - t2, disc_update_s=t4 - t3)
        return AMPTrainState(ppo=ppo_ts, amp=amp_state), metrics


@dataclasses.dataclass
class JointTrainState:
    """The AMP train state and the distillation state, sharing one rollout."""

    amp: AMPTrainState
    distill: DistillState


class JointAMPDistillAgent:
    """AMP RL and distillation on one rollout an epoch: the PPO and
    discriminator updates, then a distillation step whose labels are the
    frozen teacher's actions on the rollout's observations. The
    distillation metrics are prefixed `kin_`."""

    def __init__(self, amp_agent: AMPAgent, distill_agent):
        self.amp_agent = amp_agent
        self.distill = distill_agent

    def init(self) -> JointTrainState:
        return JointTrainState(amp=self.amp_agent.init(), distill=self.distill.init())

    def pre_epoch(self, ts: JointTrainState, epoch: int) -> JointTrainState:
        ts.amp = self.amp_agent.pre_epoch(ts.amp, epoch)
        return ts

    def train_epoch(self, ts: JointTrainState):
        agent, dist = self.amp_agent, self.distill
        ppo_ts, roll, last_value = agent.ppo.rollout(ts.amp.ppo)
        amp_ts, metrics = agent.update_from_rollout(ts.amp, ppo_ts, roll, last_value)
        with torch.no_grad():
            gt_action = dist.teacher_fn(roll.obs)
        z_noise = torch.randn(roll.obs.shape[:-1] + (dist.network.latent_dim,), generator=rollout_generator(dist),
                              device=roll.obs.device)
        kin = DistillRollout(obs=roll.obs, gt_action=gt_action, z_noise=z_noise, rewards=roll.rewards)
        ds, kin_metrics = dist.update(ts.distill, kin)
        metrics.update({f"kin_{k}": v for k, v in kin_metrics.items()})
        return JointTrainState(amp=amp_ts, distill=ds), metrics
