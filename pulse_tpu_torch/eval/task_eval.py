"""Episode-return evaluation of downstream task envs.

Counterpart of `pulse_tpu/eval/task_eval.py` (≙ the reference's
AMPPlayerContinuous run loop, amp_players.py / common_player.py): roll a
deterministic policy with auto-reset on and report the mean return,
episode length and termination rate of the episodes that ended. This is
`test=true` for the speed, reach and traj envs and their latent (Z) forms,
which have no reference motion to score against (im_eval covers the
imitation envs).

The JAX scan is a Python loop of `num_steps` env steps under `no_grad`;
the accumulators stay on the device, with one host sync at the end.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class TaskEvalResult:
    episodes: int
    return_mean: float
    return_std: float
    length_mean: float
    terminate_rate: float
    reward_per_step: float


@torch.no_grad()
def task_eval(env, policy_fn, batch_size: int = 64, num_steps: int | None = None, seed: int = 0) -> TaskEvalResult:
    """Roll `num_steps` (default: one episode length) steps of `batch_size`
    envs from a reset, the env's generator re-seeded with `seed`. An
    episode's return and length are banked when it is done; returns are
    summed and squared in float32, as the JAX package's."""
    num_steps = num_steps or int(env.config.episode_length)
    env.generator.manual_seed(seed)
    state = env.reset(batch_size)
    dev = state.reward.device
    ret_acc = torch.zeros(batch_size, device=dev)
    ep_len = torch.zeros(batch_size, dtype=torch.int32, device=dev)
    sums = torch.zeros(2, device=dev)                       # return, return^2 of the banked episodes
    counts = torch.zeros(3, dtype=torch.int64, device=dev)  # episodes done, terminated, their steps
    step_means = torch.empty(num_steps, device=dev)
    for i in range(num_steps):
        state = env.step(state, policy_fn(state.obs))
        ret_acc = ret_acc + state.reward
        ep_len = ep_len + 1
        done = state.done
        zero = torch.zeros_like(ret_acc)
        sums += torch.stack([torch.where(done, ret_acc, zero).sum(), torch.where(done, ret_acc**2, zero).sum()])
        counts += torch.stack([done.sum(), state.terminate.sum(), torch.where(done, ep_len, 0).sum()])
        ret_acc = torch.where(done, zero, ret_acc)
        ep_len = torch.where(done, 0, ep_len)
        step_means[i] = state.reward.mean()
    ret_sum, ret_sq, per_step, dones, terms, len_sum = torch.cat(
        [sums.double(), step_means.mean()[None].double(), counts.double()]).tolist()
    dones, terms = int(dones), int(terms)
    n = max(dones, 1)
    mean = ret_sum / n
    return TaskEvalResult(
        episodes=dones,
        return_mean=mean,
        return_std=math.sqrt(max(ret_sq / n - mean**2, 0.0)),
        length_mean=len_sum / n,
        terminate_rate=terms / n,
        reward_per_step=per_step,
    )
