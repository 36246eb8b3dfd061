"""Downstream task envs (speed, reach, trajectory following), batched over
envs in PyTorch.

Counterpart of `pulse_tpu/env/humanoid_task.py` (PHC's HumanoidAMPTask
subclasses): reference-state-init resets from the motion store, the
physics control step (`physics_route` "kernel": kernel K3 on CUDA, its
plain version on the CPU; "plain", on a model outside K3's surface such as
a terrain model: the plain `physics_step`, no kernel), the max-coordinate
self obs v1 (358 wide), the generic contact-based fall check over the
non-foot bodies (on terrain, each body's height above the ground under
it), the AMP obs v1 (232 wide a step) for a discriminator's style reward,
and the branch-free auto-reset merge with fresh states. A subclass defines the task state (a dict of [B, ...]
tensors), its draws, its per-step update, its task obs and its reward.

One `step`: the PD targets of the actions, the physics (K3, or on the plain
route `physics_step`), progress + 1, the task's
update on the stepped state (with the switch draws), the reward of (pre-step
state, stepped state), the power penalty where `power_reward`, the fall
check, the AMP history roll, the observation of the stepped state, then
`torch.where` of fresh states (`reset`, observed at progress 0)
over the envs that reset. The returned reward, reward_raw, done and
terminate are the stepped ones.

Every random draw comes from the env's `torch.Generator` through
`_sample_reset` (clip, start time and the task's draws) and
`_sample_switch` (the task's per-step redraw), which a test can replace to
feed given draws. The strike and pedestrian-terrain tasks are
`env/humanoid_strike.py` and `env/humanoid_terrain.py`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pulse_tpu_torch._device import resolve_device
from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env import kernels
from pulse_tpu_torch.env.humanoid_im import DEFAULT_KEY_BODIES, _select
from pulse_tpu_torch.env.terrain import terrain_height
from pulse_tpu_torch.motion.motion_lib import MotionData, get_motion_state, sample_motions, sample_time
from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics import substep_cuda
from pulse_tpu_torch.physics.model import Model
from pulse_tpu_torch.physics.state import (
    PhysicsState, dof_pos_from_state, dof_vel_from_state, physics_state_from_numpy, state_from_kinematics,
)
from pulse_tpu_torch.physics.step import physics_step

DEFAULT_CONTACT_BODIES = ("R_Ankle", "L_Ankle", "R_Toe", "L_Toe")


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    episode_length: int = 300
    termination_height: float = 0.15
    enable_early_termination: bool = True
    local_root_obs: bool = True
    root_height_obs: bool = True
    state_init: str = "Random"
    num_amp_obs_steps: int = 10
    key_bodies: tuple = DEFAULT_KEY_BODIES
    contact_bodies: tuple = DEFAULT_CONTACT_BODIES
    power_reward: bool = False
    power_coefficient: float = 0.0005
    # speed task
    tar_speed_min: float = 0.0
    tar_speed_max: float = 5.0
    speed_change_steps_min: int = 100
    speed_change_steps_max: int = 200
    # reach task
    reach_body: str = "R_Hand"
    tar_reach_dist_max: float = 0.8
    tar_reach_height_min: float = 0.2
    tar_reach_height_max: float = 2.0
    reach_change_steps_min: int = 64
    reach_change_steps_max: int = 128
    # traj task
    num_traj_segments: int = 8
    traj_segment_duration: float = 2.0
    traj_num_samples: int = 10
    traj_sample_timestep: float = 0.5
    traj_speed_min: float = 0.0
    traj_speed_max: float = 3.0
    traj_sharp_turn_prob: float = 0.15


@dataclasses.dataclass
class TaskEnvState:
    """Batched task env state; every field has a leading env axis B."""

    physics: PhysicsState
    progress: torch.Tensor     # [B] int32
    task: dict                 # the subclass's [B, ...] tensors
    obs: torch.Tensor          # [B, obs_dim]
    reward: torch.Tensor       # [B]
    reward_raw: torch.Tensor   # [B, 1]
    done: torch.Tensor         # [B] bool
    terminate: torch.Tensor    # [B] bool
    amp_hist: torch.Tensor     # [B, S, A] newest first

    @property
    def amp_obs(self) -> torch.Tensor:
        return self.amp_hist.flatten(1)

    def replace(self, **kw) -> "TaskEnvState":
        return dataclasses.replace(self, **kw)


def _tensor(x, device=None) -> torch.Tensor:
    """A numpy leaf as a tensor: floats as float32, ints and bools kept."""
    t = torch.as_tensor(np.asarray(x), device=device)
    return t.float() if t.is_floating_point() else t


def task_env_state_from_numpy(d: dict, device=None) -> TaskEnvState:
    """A TaskEnvState from numpy arrays keyed by field name, with
    d["physics"] a dict of PhysicsState fields and d["task"] a dict of the
    task's leaves (e.g. a JAX TaskEnvState converted leaf by leaf; a JAX
    task "key" is dropped)."""
    return TaskEnvState(
        physics=physics_state_from_numpy(d["physics"], device=device),
        progress=_tensor(d["progress"], device).to(torch.int32),
        task={k: _tensor(v, device) for k, v in d["task"].items() if k != "key"},
        obs=_tensor(d["obs"], device),
        reward=_tensor(d["reward"], device),
        reward_raw=_tensor(d["reward_raw"], device),
        done=_tensor(d["done"], device).bool(),
        terminate=_tensor(d["terminate"], device).bool(),
        amp_hist=_tensor(d["amp_hist"], device),
    )


class HumanoidTaskEnv:
    """Base: subclasses set task_obs_dim and override the task hooks."""

    task_obs_dim: int = 0
    reward_raw_dim: int = 1
    kernel_step: bool = True   # the step may run K3 (`physics_route`); False where no kernel covers it

    def __init__(self, model: Model, motion: MotionData, config: TaskConfig | None = None, device=None,
                 seed: int = 0):
        self.device = resolve_device(device)
        if model.device != self.device or motion.gts.device != self.device:
            raise ValueError(f"model and motion must live on {self.device}")
        self.model = model
        self.motion = motion
        self.config = cfg = config or TaskConfig()
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.body_names = names = load_smpl_humanoid().skeleton.node_names
        self.key_body_ids = np.asarray([names.index(n) for n in cfg.key_bodies], np.int32)
        self._key_idx = torch.as_tensor(self.key_body_ids, dtype=torch.long, device=self.device)
        self.non_contact_body_ids = torch.as_tensor([i for i, n in enumerate(names) if n not in cfg.contact_bodies],
                                                    dtype=torch.long, device=self.device)
        J, D = model.num_bodies, model.num_dof
        self.self_obs_dim = (1 if cfg.root_height_obs else 0) + (J - 1) * 3 + J * 6 + J * 3 + J * 3
        self.obs_dim = self.self_obs_dim + self.task_obs_dim
        self.amp_obs_dim_single = ((1 if cfg.root_height_obs else 0) + 6 + 3 + 3 + 2 * D + D
                                   + 3 * len(self.key_body_ids))
        self.amp_obs_dim = cfg.num_amp_obs_steps * self.amp_obs_dim_single
        self.action_dim = D
        self.physics_route = substep_cuda.route(model, self.kernel_step)
        print(f"{type(self).__name__}: physics route {self.physics_route}", flush=True)

    def _ctor_kwargs(self) -> dict:
        """Constructor kwargs beyond (model, motion, config, device, seed); a
        subclass with more of them overrides this, so that with_config
        rebuilds it faithfully."""
        return {}

    def with_config(self, config: TaskConfig) -> "HumanoidTaskEnv":
        """This env rebuilt with another config, on the same model and motion
        store, with a fresh generator of the same seed."""
        return type(self)(self.model, self.motion, config, device=self.device, seed=self.seed, **self._ctor_kwargs())

    # ---- task hooks (override) ----------------------------------------- #

    def _sample_task(self, n: int) -> dict:
        """The draws a fresh task of n envs is built from."""
        return {}

    def _reset_task(self, draws: dict, physics: PhysicsState) -> dict:
        return {}

    def _sample_switch(self, n: int) -> dict:
        """The draws of a step's task update, for every env (used where the
        task switches)."""
        return {}

    def _update_task(self, state: TaskEnvState, draws: dict) -> dict:
        """The task after a step: `state` holds the stepped physics and the
        advanced progress."""
        return state.task

    def _task_obs(self, state: TaskEnvState) -> torch.Tensor:
        return torch.zeros(state.progress.shape[0], 0, device=self.device)

    def _task_reward(self, prev: TaskEnvState, state: TaskEnvState) -> tuple[torch.Tensor, torch.Tensor]:
        r = torch.zeros(state.progress.shape[0], device=self.device)
        return r, r[:, None]

    # ---- shared machinery ---------------------------------------------- #

    def _uniform(self, shape, low: float, high: float) -> torch.Tensor:
        return low + (high - low) * torch.rand(shape, generator=self.generator, device=self.device)

    def _randint(self, n: int, low: int, high: int) -> torch.Tensor:
        return torch.randint(low, high, (n,), generator=self.generator, device=self.device, dtype=torch.int32)

    def _observe(self, state: TaskEnvState) -> torch.Tensor:
        """[B, obs_dim]: the self obs v1, then the task obs."""
        ph, cfg = state.physics, self.config
        self_obs = kernels.compute_humanoid_self_obs_max(
            ph.body_pos, ph.body_rot, ph.body_vel, ph.body_ang_vel,
            local_root_obs=cfg.local_root_obs, root_height_obs=cfg.root_height_obs)
        return torch.cat([self_obs, self._task_obs(state)], dim=-1)

    def _amp_row(self, physics: PhysicsState) -> torch.Tensor:
        """The AMP row [B, A] of a stepped state, the root velocities taken
        from body 0's."""
        return kernels.build_amp_observations_smpl(
            physics.root_pos, physics.root_rot, physics.body_vel[:, 0], physics.body_ang_vel[:, 0],
            dof_pos_from_state(physics), dof_vel_from_state(physics), physics.body_pos[:, self._key_idx],
            local_root_obs=self.config.local_root_obs, root_height_obs=self.config.root_height_obs)

    def amp_obs_from_motion_state(self, st: dict, shape_obs=None) -> torch.Tensor:
        """Disc obs rows [n, A] of a `get_motion_state` dict over n samples
        (the AMP agent's demo fetch; task envs have no shape channels)."""
        return kernels.build_amp_observations_smpl(
            st["root_pos"], st["root_rot"], st["root_vel"], st["root_ang_vel"], st["dof_pos"], st["dof_vel"],
            st["rg_pos"][:, self._key_idx],
            local_root_obs=self.config.local_root_obs, root_height_obs=self.config.root_height_obs)

    def _init_amp_hist(self, motion_ids: torch.Tensor, start_times: torch.Tensor) -> torch.Tensor:
        """[B, S, A] the clip's disc obs at max(t0 - k dt, 0), k = 0..S-1."""
        B, S = motion_ids.shape[0], self.config.num_amp_obs_steps
        steps = torch.arange(S, dtype=torch.float32, device=self.device) * self.model.config.control_dt
        times = torch.clamp(start_times[:, None] - steps, min=0.0)
        st = get_motion_state(self.motion, motion_ids[:, None].expand(B, S).reshape(-1), times.reshape(-1))
        return self.amp_obs_from_motion_state(st).reshape(B, S, -1)

    def _sample_reset(self, n: int) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """(motion ids [n], start times [n], task draws) of n fresh episodes:
        a clip by the store's weights, its start (state init Start) or a
        uniform time in it."""
        ids = sample_motions(self.generator, self.motion, n)
        if self.config.state_init == "Start":
            t0 = torch.zeros(n, device=self.device)
        else:
            t0 = sample_time(self.generator, self.motion, ids)
        return ids, t0, self._sample_task(n)

    def _fresh(self, motion_ids: torch.Tensor, start_times: torch.Tensor, draws: dict) -> TaskEnvState:
        """Reference-state init (FK of the blended reference pose) onto
        (clip, time) pairs with a fresh task; obs left at zero."""
        B = motion_ids.shape[0]
        ref = get_motion_state(self.motion, motion_ids, start_times)
        physics = state_from_kinematics(self.model, ref["root_pos"], ref["root_rot"], ref["dof_pos"], ref["root_vel"],
                                        ref["root_ang_vel"], ref["dof_vel"])
        z = torch.zeros(B, device=self.device)
        no = torch.zeros(B, dtype=torch.bool, device=self.device)
        return TaskEnvState(
            physics=physics, progress=torch.zeros(B, dtype=torch.int32, device=self.device),
            task=self._reset_task(draws, physics), obs=torch.zeros(B, self.obs_dim, device=self.device), reward=z,
            reward_raw=torch.zeros(B, self.reward_raw_dim, device=self.device), done=no, terminate=no,
            amp_hist=self._init_amp_hist(motion_ids, start_times))

    def reset(self, num_envs: int) -> TaskEnvState:
        """num_envs fresh states, observed."""
        state = self._fresh(*self._sample_reset(num_envs))
        return state.replace(obs=self._observe(state))

    def action_to_pd_target(self, actions: torch.Tensor) -> torch.Tensor:
        return self.model.pd_action_offset + self.model.pd_action_scale * actions

    def _body_pos_above_ground(self, physics: PhysicsState) -> torch.Tensor:
        """The body positions the fall check reads: on terrain each body's
        height is taken above the ground under it."""
        m = self.model
        if not m.has_terrain:
            return physics.body_pos
        gz = terrain_height(m.terrain_heights, m.terrain_cell, m.terrain_origin, physics.body_pos[..., 0:2])
        return torch.cat([physics.body_pos[..., 0:2], (physics.body_pos[..., 2] - gz)[..., None]], dim=-1)

    def step(self, state: TaskEnvState, actions: torch.Tensor) -> TaskEnvState:
        cfg, B = self.config, actions.shape[0]
        pd_target = self.action_to_pd_target(actions)
        step = substep_cuda.physics_step_cuda if self.physics_route == "kernel" else physics_step
        physics = step(self.model, state.physics, pd_target)
        progress = state.progress + 1
        stepped = state.replace(physics=physics, progress=progress)
        stepped = stepped.replace(task=self._update_task(stepped, self._sample_switch(B)))
        reward, reward_raw = self._task_reward(state, stepped)
        if cfg.power_reward:
            m = self.model
            dof_vel = dof_vel_from_state(physics)
            tau = (m.joint_kp.repeat_interleave(3, dim=-1) * (pd_target - dof_pos_from_state(physics))
                   - m.joint_kd.repeat_interleave(3, dim=-1) * dof_vel)
            reward = reward + kernels.compute_power_penalty(tau, dof_vel, cfg.power_coefficient)
        reset, terminate = kernels.compute_humanoid_reset(
            progress, physics.contact_force, self._body_pos_above_ground(physics), self.non_contact_body_ids,
            cfg.termination_height, cfg.episode_length, enable_early_termination=cfg.enable_early_termination)
        stepped = stepped.replace(amp_hist=torch.cat([self._amp_row(physics)[:, None], state.amp_hist[:, :-1]], dim=1))
        stepped = stepped.replace(obs=self._observe(stepped))
        merged = _select(reset, self.reset(B), stepped)
        return merged.replace(reward=reward, reward_raw=reward_raw, done=reset, terminate=terminate)


# --------------------------------------------------------------------------- #
# Speed (PHC humanoid_speed.py)
# --------------------------------------------------------------------------- #

class HumanoidSpeedEnv(HumanoidTaskEnv):
    """Run along +x at a commanded speed, redrawn every 100-199 steps."""

    task_obs_dim = 3

    def _sample_task(self, n: int) -> dict:
        cfg = self.config
        return {"speed": self._uniform(n, cfg.tar_speed_min, cfg.tar_speed_max),
                "change": self._randint(n, cfg.speed_change_steps_min, cfg.speed_change_steps_max)}

    _sample_switch = _sample_task

    def _reset_task(self, draws: dict, physics: PhysicsState) -> dict:
        return {"tar_speed": draws["speed"], "change_step": draws["change"]}

    def _update_task(self, state: TaskEnvState, draws: dict) -> dict:
        task = state.task
        switch = state.progress >= task["change_step"]
        return {"tar_speed": torch.where(switch, draws["speed"], task["tar_speed"]),
                "change_step": torch.where(switch, state.progress + draws["change"], task["change_step"])}

    def _task_obs(self, state: TaskEnvState) -> torch.Tensor:
        """[heading-local +x (x, y), target speed]."""
        heading_inv = q.calc_heading_quat_inv(state.physics.root_rot)
        x = torch.zeros_like(state.physics.root_pos)
        x[:, 0] = 1.0
        tar_dir = q.quat_rotate(heading_inv, x)
        return torch.cat([tar_dir[:, 0:2], state.task["tar_speed"][:, None]], dim=-1)

    def _task_reward(self, prev: TaskEnvState, state: TaskEnvState) -> tuple[torch.Tensor, torch.Tensor]:
        """exp(-0.25 (err_x^2 + 0.1 v_y^2)) on the finite-difference root
        velocity against the pre-step target."""
        dt = self.model.config.control_dt
        root_vel = (state.physics.root_pos - prev.physics.root_pos) / dt
        tar_err = prev.task["tar_speed"] - root_vel[:, 0]
        tangent_err = root_vel[:, 1]
        r = torch.exp(-0.25 * (tar_err**2 + 0.1 * tangent_err**2))
        return r, r[:, None]


# --------------------------------------------------------------------------- #
# Reach (PHC humanoid_reach.py)
# --------------------------------------------------------------------------- #

class HumanoidReachEnv(HumanoidTaskEnv):
    """Touch a 3D point with a designated body (default R_Hand); the point
    is redrawn around the root every 64-127 steps."""

    task_obs_dim = 3

    def __init__(self, model, motion, config=None, device=None, seed: int = 0):
        super().__init__(model, motion, config, device=device, seed=seed)
        self.reach_body_id = self.body_names.index(self.config.reach_body)

    def _sample_task(self, n: int) -> dict:
        cfg = self.config
        return {"theta": self._uniform(n, -math.pi, math.pi), "r": self._uniform(n, 0.0, cfg.tar_reach_dist_max),
                "h": self._uniform(n, cfg.tar_reach_height_min, cfg.tar_reach_height_max),
                "change": self._randint(n, cfg.reach_change_steps_min, cfg.reach_change_steps_max)}

    _sample_switch = _sample_task

    @staticmethod
    def _target(draws: dict, root_pos: torch.Tensor) -> torch.Tensor:
        """[B, 3] the point at distance r, angle theta around the root, at
        height h."""
        r, th = draws["r"], draws["theta"]
        return torch.stack([root_pos[:, 0] + r * torch.cos(th), root_pos[:, 1] + r * torch.sin(th), draws["h"]], dim=-1)

    def _reset_task(self, draws: dict, physics: PhysicsState) -> dict:
        return {"tar_pos": self._target(draws, physics.root_pos), "change_step": draws["change"]}

    def _update_task(self, state: TaskEnvState, draws: dict) -> dict:
        task = state.task
        switch = state.progress >= task["change_step"]
        tar = self._target(draws, state.physics.root_pos)
        return {"tar_pos": torch.where(switch[:, None], tar, task["tar_pos"]),
                "change_step": torch.where(switch, state.progress + draws["change"], task["change_step"])}

    def _task_obs(self, state: TaskEnvState) -> torch.Tensor:
        heading_inv = q.calc_heading_quat_inv(state.physics.root_rot)
        return q.quat_rotate(heading_inv, state.task["tar_pos"] - state.physics.root_pos)

    def _task_reward(self, prev: TaskEnvState, state: TaskEnvState) -> tuple[torch.Tensor, torch.Tensor]:
        pos = state.physics.body_pos[:, self.reach_body_id]
        r = torch.exp(-4.0 * torch.sum((state.task["tar_pos"] - pos) ** 2, dim=-1))
        return r, r[:, None]


# --------------------------------------------------------------------------- #
# Trajectory following (PHC humanoid_traj.py, utils/traj_generator.py)
# --------------------------------------------------------------------------- #

class HumanoidTrajEnv(HumanoidTaskEnv):
    """Follow a random 2D waypoint path from the start root position:
    `num_traj_segments` segments of `traj_segment_duration` s, headings a
    random walk with sharp turns, positions piecewise linear in time. The
    task obs is the heading-local offsets of `traj_num_samples` future
    points."""

    def __init__(self, model, motion, config=None, device=None, seed: int = 0):
        super().__init__(model, motion, config, device=device, seed=seed)
        self.task_obs_dim = 2 * self.config.traj_num_samples
        self.obs_dim = self.self_obs_dim + self.task_obs_dim

    def _sample_task(self, n: int) -> dict:
        cfg, S = self.config, self.config.num_traj_segments
        return {"turn": self._uniform((n, S), -1.0, 1.0),
                "sharp": torch.rand(n, S, generator=self.generator, device=self.device) < cfg.traj_sharp_turn_prob,
                "sharp_turn": self._uniform((n, S), -math.pi, math.pi),
                "speed": self._uniform((n, S), cfg.traj_speed_min, cfg.traj_speed_max)}

    def _gen_traj(self, draws: dict, start_xy: torch.Tensor) -> torch.Tensor:
        """[B, S+1, 2] vertices: the start, then the cumulative segments."""
        d_theta = torch.where(draws["sharp"], draws["sharp_turn"], draws["turn"] * 0.7)
        theta = torch.cumsum(d_theta, dim=-1)
        seg_len = draws["speed"] * self.config.traj_segment_duration
        deltas = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1) * seg_len[..., None]
        return torch.cat([start_xy[:, None], start_xy[:, None] + torch.cumsum(deltas, dim=1)], dim=1)

    def _traj_pos(self, verts: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Positions [B, 2] at times t [B], or [B, N, 2] at t [B, N]."""
        cfg = self.config
        seg = torch.clamp(t / cfg.traj_segment_duration, 0.0, cfg.num_traj_segments - 1e-4)
        i0 = seg.to(torch.long)
        frac = seg - i0.to(seg.dtype)
        flat = t.dim() == 1
        if flat:
            i0, frac = i0[:, None], frac[:, None]
        idx = i0[..., None].expand(*i0.shape, 2)
        v0, v1 = torch.gather(verts, 1, idx), torch.gather(verts, 1, idx + 1)
        pos = v0 * (1 - frac[..., None]) + v1 * frac[..., None]
        return pos[:, 0] if flat else pos

    def _reset_task(self, draws: dict, physics: PhysicsState) -> dict:
        return {"verts": self._gen_traj(draws, physics.root_pos[:, 0:2])}

    def _time(self, state: TaskEnvState) -> torch.Tensor:
        return state.progress.to(torch.float32) * self.model.config.control_dt

    def _task_obs(self, state: TaskEnvState) -> torch.Tensor:
        cfg = self.config
        times = self._time(state)[:, None] + (torch.arange(cfg.traj_num_samples, device=self.device)
                                              * cfg.traj_sample_timestep)
        tar = self._traj_pos(state.task["verts"], times)                         # [B, N, 2]
        root = state.physics.root_pos.clone()
        root[:, 2] = 0.0
        heading_inv = q.calc_heading_quat_inv(state.physics.root_rot)
        tar3 = torch.cat([tar, torch.zeros_like(tar[..., :1])], dim=-1)
        local = q.quat_rotate(heading_inv[:, None].expand(-1, cfg.traj_num_samples, -1), tar3 - root[:, None])
        return local[..., 0:2].reshape(state.progress.shape[0], -1)

    def _task_reward(self, prev: TaskEnvState, state: TaskEnvState) -> tuple[torch.Tensor, torch.Tensor]:
        diff = self._traj_pos(state.task["verts"], self._time(state)) - state.physics.root_pos[:, 0:2]
        r = torch.exp(-2.0 * torch.sum(diff * diff, dim=-1))
        return r, r[:, None]
