"""HumanoidIm, the motion-imitation environment, batched over envs in
PyTorch.

Counterpart of `pulse_tpu/env/humanoid_im.py` on the surface of its Pallas
kernels (obs v6 with one future step, self obs v1, AMP obs v1/v2, isaac_pd
control, no far-goal, occlusion, obs noise or domain randomization), with
PHC's per-env body shapes and shape channels, the cycled reference
(`cycle_motion`: the clip time wraps, the reference is shifted by the clip's
root travel per cycle, and episodes end at `episode_length` steps) and the
power reward. A config off that surface raises NotImplementedError.

One `step`: gather the reference at the post-step time, then

  * on the fused path (`_fused_step_ok`: no subclass overrides termination
    or reset, no shape channels, one shared model) kernel K1: physics,
    reward, termination distances, AMP row;
  * with per-env body shapes (`enable_shape_variation`) kernel K3-rows (the
    physics under each env's own model) and kernel RA (reward, distances,
    AMP row on the stepped state);
  * else kernel K3 (physics) and kernel RA, which together compute what K1
    does;

then, with `power_reward`, the energy penalty of the stepped state added to
the kernel's imitation reward, termination (`_termination`), the AMP
history roll, the branch-free auto-reset merge with fresh states
(`_reset_states`), and kernel K2 (the observation of the merged state).
With shape channels, each env's shape row (gender, betas, limb weights;
zeros until shapes are enabled) is spliced into the observation after the
self obs and appended to every AMP row. Random draws come from the env's
`torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from pulse_tpu_torch._device import resolve_device
from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env import cuda_obs, kernels
from pulse_tpu_torch.motion.motion_lib import MotionData, get_motion_state, sample_motions, sample_time
from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics import shape_variation, substep_cuda
from pulse_tpu_torch.physics.model import Model, batched_model_from_numpy
from pulse_tpu_torch.physics.state import (
    PhysicsState, dof_pos_from_state, dof_vel_from_state, physics_state_from_numpy, state_from_kinematics,
    state_from_motion_ref,
)

DEFAULT_KEY_BODIES = ("R_Ankle", "L_Ankle", "R_Wrist", "L_Wrist")
DEFAULT_RESET_BODIES = (
    "Pelvis", "L_Hip", "L_Knee", "R_Hip", "R_Knee", "Torso", "Spine", "Chest",
    "Neck", "Head", "L_Thorax", "L_Shoulder", "L_Elbow", "L_Wrist", "L_Hand",
    "R_Thorax", "R_Shoulder", "R_Elbow", "R_Wrist", "R_Hand",
)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """The knobs of env_im that shape the step (defaults = configs/env/im.yaml)."""

    control_mode: str = "isaac_pd"
    termination_distance: float = 0.25
    enable_early_termination: bool = True
    use_mean_termination: bool = True
    num_traj_samples: int = 1
    local_root_obs: bool = True
    root_height_obs: bool = True
    state_init: str = "Random"         # reference-state init at a random clip time
    episode_length: int = 300          # steps an episode of a cycled reference lasts
    power_reward: bool = False
    power_coefficient: float = 0.0005
    cycle_motion: bool = False
    obs_v: int = 6
    self_obs_v: int = 1
    obs_noise_std: float = 0.0
    zero_out_far: bool = False
    occlusion_prob: float = 0.0
    num_amp_obs_steps: int = 10
    amp_obs_v: int = 1
    has_shape_obs: bool = False
    has_shape_obs_disc: bool = False
    has_limb_weight_obs: bool = False
    key_bodies: Sequence[str] = DEFAULT_KEY_BODIES
    reset_bodies: Sequence[str] = DEFAULT_RESET_BODIES
    track_bodies: Sequence[str] | None = None
    k_pos: float = 100.0
    k_rot: float = 10.0
    k_vel: float = 0.1
    k_ang_vel: float = 0.1
    w_pos: float = 0.5
    w_rot: float = 0.3
    w_vel: float = 0.1
    w_ang_vel: float = 0.1


@dataclasses.dataclass
class EnvState:
    """Batched env state; every field has a leading env axis B."""

    physics: PhysicsState
    motion_id: torch.Tensor    # [B] long
    start_time: torch.Tensor   # [B] f32
    progress: torch.Tensor     # [B] int32
    obs: torch.Tensor          # [B, obs_dim]
    reward: torch.Tensor       # [B]
    reward_raw: torch.Tensor   # [B, 4]
    done: torch.Tensor         # [B] bool
    terminate: torch.Tensor    # [B] bool
    amp_hist: torch.Tensor     # [B, S, A] newest first
    recovery_counter: torch.Tensor  # [B] int32: steps of termination grace (getup)

    @property
    def amp_obs(self) -> torch.Tensor:
        return self.amp_hist.flatten(1)

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


def env_state_from_numpy(d: dict, device=None) -> EnvState:
    """Build an EnvState from numpy arrays keyed by field name, with
    d["physics"] a dict of PhysicsState fields (e.g. a JAX EnvState
    converted leaf by leaf). A missing recovery_counter is zeros."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    B = np.asarray(d["progress"]).shape[0]

    return EnvState(
        physics=physics_state_from_numpy(d["physics"], device=device),
        motion_id=t(d["motion_id"], torch.long),
        start_time=t(d["start_time"], torch.float32),
        progress=t(d["progress"], torch.int32),
        obs=t(d["obs"], torch.float32),
        reward=t(d["reward"], torch.float32),
        reward_raw=t(d["reward_raw"], torch.float32),
        done=t(d["done"], torch.bool),
        terminate=t(d["terminate"], torch.bool),
        amp_hist=t(d["amp_hist"], torch.float32),
        recovery_counter=t(d.get("recovery_counter", np.zeros(B)), torch.int32),
    )


def _select(mask: torch.Tensor, a, b):
    """Field-wise where(mask, a, b) over (nested) state dataclasses."""
    if dataclasses.is_dataclass(a):
        return type(a)(**{f.name: _select(mask, getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)})
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


class HumanoidImEnv:
    """Bundles (physics model, motion data, config) with the env's random
    generator. `reset` and `step` take and return batched EnvStates."""

    def __init__(self, model: Model, motion: MotionData, config: EnvConfig | None = None,
                 device=None, seed: int = 0):
        self.device = resolve_device(device)
        if model.device != self.device or motion.gts.device != self.device:
            raise ValueError(f"model and motion must live on {self.device}")
        self.model = model
        self.motion = motion
        self.config = cfg = config or EnvConfig()
        if not self._surface_ok():
            raise NotImplementedError("only the imitation step surface of the kernels (pulse_tpu _fused_step_ok) is ported")
        if cfg.has_shape_obs_disc and not cfg.has_shape_obs:
            raise ValueError("has_shape_obs_disc requires has_shape_obs")
        if self.device.type == "cuda" and not substep_cuda.supported(model):
            raise NotImplementedError("model outside the CUDA kernel's surface")
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        self.body_names = names = load_smpl_humanoid().skeleton.node_names
        self.key_body_ids = np.asarray([names.index(n) for n in cfg.key_bodies], np.int32)
        self.reset_body_ids = np.asarray([names.index(n) for n in cfg.reset_bodies], np.int32)
        J = model.num_bodies
        self.num_bodies = J
        # shape channels: [gender 1, betas 10]? [limb weights 10]? in the obs,
        # [gender, betas]? [limb weights]? at the tail of each AMP row
        self.shape_obs_dim = 11 * cfg.has_shape_obs + 10 * cfg.has_limb_weight_obs
        self.shape_disc_dim = 11 * cfg.has_shape_obs_disc + 10 * cfg.has_limb_weight_obs
        self.batched_model: Model | None = None     # per-env body shapes
        self._shape_obs_table = None                # [N, shape_obs_dim]
        self._model_rows_cache = None               # (batched model, its K3-rows rows)
        self._shape_args = None                     # enable_shape_variation's, for resample_shapes
        self.obs_dim = cuda_obs.obs_dim(J, cfg.root_height_obs, self.shape_obs_dim)
        # the self obs and the shape row after it: what a PULSE prior reads
        self.self_obs_dim = cuda_obs.self_obs_dim(J, cfg.root_height_obs) + self.shape_obs_dim
        self.amp_obs_dim_single = cuda_obs.amp_obs_dim(J, len(self.key_body_ids), cfg.amp_obs_v, cfg.root_height_obs,
                                                       self.shape_disc_dim)
        self.amp_obs_dim = cfg.num_amp_obs_steps * self.amp_obs_dim_single
        self.action_dim = model.num_dof
        self.consts = cuda_obs.env_consts_from(self)
        self.amp_frame_table = self._build_amp_frame_table()

    def _ctor_kwargs(self) -> dict:
        """Constructor kwargs beyond (model, motion, config, device, seed).
        A subclass with more of them overrides this, so that with_config
        rebuilds it faithfully."""
        return {}

    def with_config(self, config: EnvConfig) -> "HumanoidImEnv":
        """This env rebuilt with another config (e.g. early termination off
        for im_eval), on the same model and motion store (so the same live
        PMCP weights), with the per-env body shapes carried over. The new
        env draws from a fresh generator of the same seed."""
        new = type(self)(self.model, self.motion, config, device=self.device, seed=self.seed, **self._ctor_kwargs())
        for attr in ("batched_model", "_shape_obs_table", "_model_rows_cache", "_shape_args"):
            setattr(new, attr, getattr(self, attr))
        if (new.obs_dim, new.amp_obs_dim) != (self.obs_dim, self.amp_obs_dim):
            raise ValueError("with_config must keep the obs and AMP obs widths")
        return new

    def _surface_ok(self) -> bool:
        """The config is one the kernels cover."""
        cfg = self.config
        return (
            cfg.control_mode == "isaac_pd"
            and cfg.state_init == "Random"
            and cfg.obs_v == 6
            and cfg.self_obs_v == 1
            and cfg.amp_obs_v in (1, 2)
            and cfg.num_traj_samples == 1
            and not cfg.zero_out_far
            and cfg.occlusion_prob == 0
            and cfg.obs_noise_std == 0
            and cfg.track_bodies is None
        )

    def _fused_step_ok(self) -> bool:
        """K1 may run the step (of a shared model): no shape channels, and no
        subclass replaces a stage it fuses."""
        t = type(self)
        return (
            self._surface_ok()
            and self.shape_obs_dim == 0
            and t._termination is HumanoidImEnv._termination
            and t._reset_states is HumanoidImEnv._reset_states
        )

    def _build_amp_frame_table(self) -> torch.Tensor:
        """AMP obs of every stored motion frame, [F, A]: resets gather their
        discriminator window from it."""
        m = self.motion
        F = m.gts.shape[0]
        args = (m.gts[:, 0], m.grs[:, 0], m.gvs[:, 0], m.gavs[:, 0],
                q.quat_to_exp_map(m.lrs[:, 1:]).reshape(F, -1), m.dvs, m.gts[:, self.key_body_ids])
        kw = dict(local_root_obs=self.config.local_root_obs, root_height_obs=self.config.root_height_obs)
        if self.config.amp_obs_v == 2:
            return kernels.build_amp_observations_smpl_v2(*args, m.gvs[:, self.key_body_ids], **kw)
        return kernels.build_amp_observations_smpl(*args, **kw)

    # ------------------------------------------------------------------ #
    # reset (reference state init)
    # ------------------------------------------------------------------ #

    def _motion_time(self, motion_id: torch.Tensor, start_time: torch.Tensor, progress: torch.Tensor) -> torch.Tensor:
        """In-clip time; with cycle_motion it wraps at the clip's length (and
        `_cycle_offset` carries the position on)."""
        t = start_time + progress.to(torch.float32) * self.model.config.control_dt
        if self.config.cycle_motion:
            t = torch.remainder(t, torch.clamp(self.motion.motion_lengths[motion_id], min=1e-6))
        return t

    def _cycle_offset(self, motion_id: torch.Tensor, start_time: torch.Tensor,
                      progress: torch.Tensor) -> torch.Tensor | None:
        """[B, 3] world shift of a cycled reference: the clip's root travel
        (last frame minus first, z zeroed) times the cycles completed by the
        unwrapped time, so that the reference goes on from where the clip
        ended instead of teleporting back to its start. None without
        cycle_motion."""
        if not self.config.cycle_motion:
            return None
        m = self.motion
        raw_t = start_time + progress.to(torch.float32) * self.model.config.control_dt
        cycles = torch.floor(raw_t / torch.clamp(m.motion_lengths[motion_id], min=1e-6))
        start = m.length_starts[motion_id]
        delta = m.gts[start + m.motion_num_frames[motion_id] - 1, 0] - m.gts[start, 0]
        delta[:, 2] = 0.0
        return cycles[:, None] * delta

    def _sample_reset(self, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(motion ids [n], start times [n]) for n fresh episodes."""
        motion_ids = sample_motions(self.generator, self.motion, n)
        return motion_ids, sample_time(self.generator, self.motion, motion_ids)

    def _init_amp_hist(self, motion_ids: torch.Tensor, start_times: torch.Tensor) -> torch.Tensor:
        """Discriminator window from the clip's past frames, each row ending
        with the env's shape columns: [B, S, A]."""
        m = self.motion
        S = self.config.num_amp_obs_steps
        steps = torch.arange(S, dtype=torch.float32, device=self.device) * self.model.config.control_dt
        times = torch.clamp(start_times[:, None] - steps, min=0.0)
        ids = motion_ids[:, None].expand(-1, S)
        f = torch.round(times / m.motion_dt[ids]).to(torch.long)
        f = torch.minimum(torch.clamp(f, min=0), m.motion_num_frames[ids] - 1)
        rows = self.amp_frame_table[m.length_starts[ids] + f]
        tails = [t for t in self._disc_parts(motion_ids.shape[0]) if t is not None]
        if not tails:
            return rows
        tail = torch.cat(tails, dim=-1)
        return torch.cat([rows, tail[:, None].expand(-1, S, -1)], dim=-1)

    def _fresh(self, motion_ids: torch.Tensor, start_times: torch.Tensor) -> EnvState:
        """Reference-state init onto (clip, time) pairs; obs left at zero.
        With per-env shapes the motion tables' bodies (the base skeleton's)
        do not fit, so each env's pose is FK'd through its own model."""
        B = motion_ids.shape[0]
        ref = get_motion_state(self.motion, motion_ids, start_times)
        z = torch.zeros(B, device=self.device)
        if self.batched_model is None:
            physics = state_from_motion_ref(self.model, ref)
        else:
            physics = state_from_kinematics(self.batched_model, ref["root_pos"], ref["root_rot"], ref["dof_pos"],
                                            ref["root_vel"], ref["root_ang_vel"], ref["dof_vel"])
        return EnvState(
            physics=physics,
            motion_id=motion_ids,
            start_time=start_times,
            progress=torch.zeros(B, dtype=torch.int32, device=self.device),
            obs=torch.zeros(B, self.obs_dim, device=self.device),
            reward=z,
            reward_raw=torch.zeros(B, 4, device=self.device),
            done=torch.zeros(B, dtype=torch.bool, device=self.device),
            terminate=torch.zeros(B, dtype=torch.bool, device=self.device),
            amp_hist=self._init_amp_hist(motion_ids, start_times),
            recovery_counter=torch.zeros(B, dtype=torch.int32, device=self.device),
        )

    def _reset_states(self, mask: torch.Tensor) -> EnvState:
        """Fresh states (obs left at zero) for all [B] envs, of which those
        in `mask` take them. A hook for subclasses; here the
        reference-state init at a random clip time."""
        return self._fresh(*self._sample_reset(mask.shape[0]))

    def reset_to(self, motion_ids: torch.Tensor, start_times: torch.Tensor) -> EnvState:
        state = self._fresh(motion_ids, start_times)
        return state.replace(obs=self._observe(state))

    def reset(self, num_envs: int) -> EnvState:
        state = self._reset_states(torch.ones(num_envs, dtype=torch.bool, device=self.device))
        return state.replace(obs=self._observe(state))

    def _observe(self, state: EnvState) -> torch.Tensor:
        """K2 against the reference at the next control step's time (with the
        cycle offset of the state's own time, as the JAX package's)."""
        t_next = self._motion_time(state.motion_id, state.start_time, state.progress) + self.model.config.control_dt
        ref = get_motion_state(self.motion, state.motion_id, t_next,
                               self._cycle_offset(state.motion_id, state.start_time, state.progress))
        return cuda_obs.observe(self.consts, state.physics, ref, self._shape_obs(state.motion_id.shape[0]))

    # ------------------------------------------------------------------ #
    # step
    # ------------------------------------------------------------------ #

    def action_to_pd_target(self, actions: torch.Tensor) -> torch.Tensor:
        m = self.model if self.batched_model is None else self.batched_model
        return m.pd_action_offset + m.pd_action_scale * actions

    def _termination(self, state: EnvState, dist_mean: torch.Tensor, dist_max: torch.Tensor,
                     pass_time: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(reset, terminate) [B] of the stepped state (progress already
        advanced) from the reset bodies' distances to the reference. A hook
        for subclasses (getup adds a grace window)."""
        cfg = self.config
        dist = dist_mean if cfg.use_mean_termination else dist_max
        terminate = (dist > cfg.termination_distance) & (state.progress > 1)
        if not cfg.enable_early_termination:
            terminate = torch.zeros_like(terminate)
        return pass_time | terminate, terminate

    def step(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        progress = state.progress + 1
        # the reference at the post-step time depends only on (clip,
        # progress), so it is gathered before physics and rides into K1
        t = self._motion_time(state.motion_id, state.start_time, progress)
        ref = get_motion_state(self.motion, state.motion_id, t,
                               self._cycle_offset(state.motion_id, state.start_time, progress))
        pd_target = self.action_to_pd_target(actions)
        if self.batched_model is None and self._fused_step_ok():
            physics, reward, reward_raw, dmean, dmax, amp_row = cuda_obs.step_reward_amp(
                self.model, self.consts, state.physics, pd_target, ref
            )
        else:
            B = actions.shape[0]
            rows = None if self.batched_model is None else self._model_rows(B)
            physics = substep_cuda.physics_step_cuda(self.model, state.physics, pd_target, model_rows=rows)
            reward, reward_raw, dmean, dmax, amp_row = cuda_obs.reward_amp(self.consts, physics, ref,
                                                                           *self._disc_parts(B))
        cfg = self.config
        if cfg.power_reward:
            # the PD torque proxy kp (target - dof) - kd dof_vel of the env's model
            m = self.model if self.batched_model is None else self.batched_model
            dof_vel = dof_vel_from_state(physics)
            tau = (m.joint_kp.repeat_interleave(3, dim=-1) * (pd_target - dof_pos_from_state(physics))
                   - m.joint_kd.repeat_interleave(3, dim=-1) * dof_vel)
            reward = reward + kernels.compute_power_penalty(tau, dof_vel, cfg.power_coefficient)

        stepped = state.replace(
            physics=physics,
            progress=progress,
            amp_hist=torch.cat([amp_row[:, None], state.amp_hist[:, :-1]], dim=1),
        )
        if cfg.cycle_motion:
            pass_time = progress >= cfg.episode_length
        else:
            pass_time = t >= self.motion.motion_lengths[state.motion_id]
        reset, terminate = self._termination(stepped, dmean, dmax, pass_time)
        merged = _select(reset, self._reset_states(reset), stepped)
        return merged.replace(
            obs=self._observe(merged), reward=reward, reward_raw=reward_raw, done=reset, terminate=terminate
        )

    # ------------------------------------------------------------------ #
    # per-env body shapes
    # ------------------------------------------------------------------ #

    def enable_shape_variation(self, num_envs: int, scale_range=(0.9, 1.1), smpl_model=None, beta_std: float = 1.0,
                               generator: torch.Generator | None = None) -> None:
        """Give every env its own body shape (PHC's has_shape_variation):
        with `smpl_model` (an `smpl.body_model.SMPLModel`) skeletons from
        betas drawn with std `beta_std`, else isotropic scales in
        `scale_range`, drawn from `generator` (default: the env's). Fills
        the per-env shape rows the shape channels read: gender 0, the betas
        (zeros for scales), the limb weights."""
        g = self.generator if generator is None else generator
        self._shape_args = dict(num_envs=num_envs, scale_range=scale_range, smpl_model=smpl_model, beta_std=beta_std,
                                generator=g)
        if smpl_model is None:
            bm = shape_variation.vary_model_scales(self.model, num_envs, scale_range, generator=g)
            betas = torch.zeros(num_envs, 10, device=self.device)
        else:
            betas = beta_std * torch.randn(num_envs, 10, generator=g, device=self.device)
            bm = shape_variation.models_from_betas(self.model, smpl_model, betas, self.body_names)
        parts = []
        if self.config.has_shape_obs:
            parts += [torch.zeros(num_envs, 1, device=self.device), betas]
        if self.config.has_limb_weight_obs:
            parts.append(shape_variation.limb_weight_params(bm.local_translation, bm.body_mass, self.body_names))
        self.batched_model = bm
        self._shape_obs_table = torch.cat(parts, dim=-1) if parts else None

    def resample_shapes(self) -> None:
        """Redraw every env's body shape in the mode enable_shape_variation
        was called with, from the generator it drew from."""
        if self._shape_args is None:
            raise RuntimeError("resample_shapes before enable_shape_variation")
        self.enable_shape_variation(**self._shape_args)

    def set_shapes_from_numpy(self, leaves: dict, shape_table=None) -> None:
        """Per-env body shapes from numpy arrays: a batched model's leaves
        keyed by field name and the [N, shape_obs_dim] shape rows (e.g. a
        JAX env's batched model and shape table, converted leaf by leaf)."""
        self.batched_model = batched_model_from_numpy(self.model, leaves)
        self._shape_obs_table = None if shape_table is None else torch.as_tensor(
            np.array(shape_table, np.float32), device=self.device)

    def _model_rows(self, B: int) -> torch.Tensor:
        """The batched model's K3-rows rows [B, n_model], built once per
        batched model (compared by identity: resample_shapes swaps it),
        contiguous as the kernel reads them."""
        bm = self.batched_model
        if self._model_rows_cache is None or self._model_rows_cache[0] is not bm:
            self._model_rows_cache = (bm, substep_cuda.build_model_rows(bm, B))
        return self._model_rows_cache[1]

    def _shape_obs(self, B: int) -> torch.Tensor | None:
        """[B, shape_obs_dim] shape rows (zeros before shapes are enabled),
        or None without shape channels."""
        if not self.shape_obs_dim:
            return None
        if self._shape_obs_table is None:
            return torch.zeros(B, self.shape_obs_dim, device=self.device)
        return self._shape_obs_table

    def _disc_parts(self, B: int) -> tuple:
        """The AMP row's shape tails: ([B, 11] gender+betas or None, [B, 10]
        limb weights or None)."""
        rows = self._shape_obs(B)
        cfg = self.config
        return (rows[:, :11] if cfg.has_shape_obs_disc else None,
                rows[:, -10:] if cfg.has_limb_weight_obs else None)
