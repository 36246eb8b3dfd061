"""HumanoidIm, the motion-imitation environment, batched over envs in
PyTorch.

Counterpart of `pulse_tpu/env/humanoid_im.py`: the isaac_pd, pd and force
control modes, domain randomization (`env/domain_rand.py`: scheduled
action and observation noise with held correlated draws, per-env friction,
mass and gain multipliers), task obs v6-v9 over all bodies or a tracked subset
(`track_bodies`, VR sparse tracking) with `num_traj_samples` future frames,
self obs v1, v2 (a history of `self_obs_hist_steps` frames) and v3 (the
ankles' contact forces), AMP obs v1/v2, the far-goal mode
(`zero_out_far`), occlusion, obs noise, state init Default / Start /
Random / Hybrid, PHC's per-env body shapes and shape channels, the cycled
reference (`cycle_motion`: the clip time wraps, the reference is shifted
by the clip's root travel per cycle, and episodes end at `episode_length`
steps) and the power reward.

One `step`: gather the reference at the post-step time; the action takes
the DR action noise and then the `motor_actions` hook (identity here; the
MCP envs blend frozen primitives there); then

  * on the kernels' surface (`_kernel_surface`: isaac_pd, obs v6 over all
    bodies with one future frame, self obs v1, no far-goal mode)
      - on the fused path (`_fused_step_ok`: no subclass overrides
        termination or reset, no shape channels, no domain randomization,
        one shared model) kernel K1: physics, reward, termination
        distances, AMP row;
      - with per-env models (body shapes, `enable_shape_variation`, or
        DR's physical props, `randomize_physical_props`) kernel K3-rows
        (the physics under each env's own model) and kernel RA (reward,
        distances, AMP row on the stepped state);
      - else kernel K3 (physics) and kernel RA, which together compute what
        K1 does;
  * otherwise `_step_general`: the physics (K3 or K3-rows under isaac_pd;
    the pd and force modes' plain PyTorch steps, `physics/step.py`), then
    the reward over the tracked bodies, the distances and the AMP row in
    plain PyTorch (the counterpart of the JAX package's per-env XLA
    `_finish_step`);

then, with `power_reward`, the energy penalty of the stepped state added to
the imitation reward; with `zero_out_far`, the location reward and no
termination for envs far from their reference; termination
(`_termination`), the AMP and self-obs history rolls, the branch-free
auto-reset merge with fresh states (`_reset_states`), the observation of
the merged state (kernel K2 on the kernels' surface, `_observe_general`
otherwise), then the refresh of DR's held draws every `frequency` steps
and DR's observation noise, and last obs noise and occlusion. With shape
channels, each
env's shape row (gender, betas, limb weights; zeros until shapes are
enabled) follows the self obs and is appended to every AMP row. Random
draws come from the env's `torch.Generator`. With `use_pallas_physics`
false each kernel's plain version runs in its place, also on the card (the
JAX package's XLA arm).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from pulse_tpu_torch._device import resolve_device
from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env import cuda_obs, kernels
from pulse_tpu_torch.env.domain_rand import DRConfig, apply_noise, draw_noise, randomize_model_props
from pulse_tpu_torch.motion.motion_lib import MotionData, get_motion_state, sample_motions, sample_time
from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics import shape_variation, substep_cuda
from pulse_tpu_torch.physics.model import Model, batched_model_from_numpy
from pulse_tpu_torch.physics.step import physics_step, physics_step_pd_explicit, physics_step_torque
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
SENSOR_BODIES = ("L_Ankle", "R_Ankle")     # self obs v3's force sensors
STATE_INITS = ("Default", "Start", "Random", "Hybrid")


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """The knobs of env_im that shape the step (defaults = configs/env/im.yaml)."""

    control_mode: str = "isaac_pd"    # isaac_pd | pd (explicit PD) | force (raw torques)
    use_pallas_physics: bool = True    # the CUDA kernels; False: their plain versions (the JAX package's XLA arm)
    power_scale: float = 1.0
    motor_effort: float = 500.0        # force: tau = action * motor_effort * power_scale
    termination_distance: float = 0.25
    enable_early_termination: bool = True
    use_mean_termination: bool = True
    num_traj_samples: int = 1          # future reference frames in the task obs
    traj_sample_timestep: float = 1.0 / 30.0
    local_root_obs: bool = True
    root_height_obs: bool = True
    state_init: str = "Random"         # Default | Start (time 0) | Random | Hybrid
    hybrid_init_prob: float = 0.5      # Hybrid: time 0 where a uniform draw exceeds it
    episode_length: int = 300          # steps an episode of a cycled reference lasts
    power_reward: bool = False
    power_coefficient: float = 0.0005
    cycle_motion: bool = False
    obs_v: int = 6
    self_obs_v: int = 1                # 1 plain / 2 + history / 3 + ankle force sensors
    self_obs_hist_steps: int = 5
    obs_noise_std: float = 0.0
    zero_out_far: bool = False         # far-goal mode beyond zero_out_far_distance (m, XY)
    zero_out_far_distance: float = 5.0
    occlusion_prob: float = 0.0        # per env and step: zero one chunk of the task obs
    occlusion_frac: float = 0.25       # the chunk's share of the task obs
    num_amp_obs_steps: int = 10
    amp_obs_v: int = 1
    has_shape_obs: bool = False
    has_shape_obs_disc: bool = False
    has_limb_weight_obs: bool = False
    key_bodies: Sequence[str] = DEFAULT_KEY_BODIES
    reset_bodies: Sequence[str] = DEFAULT_RESET_BODIES
    track_bodies: Sequence[str] | None = None   # the task obs' and reward's bodies; None: all
    dr: DRConfig | None = None         # domain randomization; None: off
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
    self_obs_hist: torch.Tensor | None = None  # [B, H, single] newest first (self obs v2)
    # domain randomization: the held correlated draws and the per-env step
    # counter of the schedules and refreshes (it counts across resets)
    dr_corr_obs: torch.Tensor | None = None    # [B, obs_dim]
    dr_corr_act: torch.Tensor | None = None    # [B, action_dim]
    dr_step: torch.Tensor | None = None        # [B] int32

    @property
    def amp_obs(self) -> torch.Tensor:
        return self.amp_hist.flatten(1)

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


def env_state_from_numpy(d: dict, device=None) -> EnvState:
    """Build an EnvState from numpy arrays keyed by field name, with
    d["physics"] a dict of PhysicsState fields (e.g. a JAX EnvState
    converted leaf by leaf). A missing recovery_counter is zeros, a missing
    self_obs_hist or DR field None."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    B = np.asarray(d["progress"]).shape[0]

    def opt(name, dtype):
        return None if d.get(name) is None else t(d[name], dtype)

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
        self_obs_hist=opt("self_obs_hist", torch.float32),
        dr_corr_obs=opt("dr_corr_obs", torch.float32),
        dr_corr_act=opt("dr_corr_act", torch.float32),
        dr_step=opt("dr_step", torch.int32),
    )


def _select(mask: torch.Tensor, a, b):
    """Field-wise where(mask, a, b) over (nested) state dataclasses and dicts
    of tensors; a field that is None in both stays None."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _select(mask, a[k], b[k]) for k in a}
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
        self._check_config()
        if cfg.has_shape_obs_disc and not cfg.has_shape_obs:
            raise ValueError("has_shape_obs_disc requires has_shape_obs")
        if self.device.type == "cuda" and cfg.use_pallas_physics and not substep_cuda.supported(model):
            raise NotImplementedError("model outside the CUDA kernel's surface")
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        self.body_names = names = load_smpl_humanoid().skeleton.node_names
        self.key_body_ids = np.asarray([names.index(n) for n in cfg.key_bodies], np.int32)
        self.reset_body_ids = np.asarray([names.index(n) for n in cfg.reset_bodies], np.int32)
        self.sensor_body_ids = np.asarray([names.index(n) for n in SENSOR_BODIES], np.int32)
        J = model.num_bodies
        self.num_bodies = J
        tracked = range(J) if cfg.track_bodies is None else [names.index(n) for n in cfg.track_bodies]
        self.track_body_ids = np.asarray(tracked, np.int32)
        self._all_tracked = np.array_equal(self.track_body_ids, np.arange(J))
        # the tracked bodies as an index: a slice when all are tracked
        self._track = slice(None) if self._all_tracked else torch.as_tensor(self.track_body_ids, dtype=torch.long,
                                                                            device=self.device)
        # shape channels: [gender 1, betas 10]? [limb weights 10]? in the obs,
        # [gender, betas]? [limb weights]? at the tail of each AMP row
        self.shape_obs_dim = 11 * cfg.has_shape_obs + 10 * cfg.has_limb_weight_obs
        self.shape_disc_dim = 11 * cfg.has_shape_obs_disc + 10 * cfg.has_limb_weight_obs
        self.batched_model: Model | None = None     # per-env body shapes
        self._shape_obs_table = None                # [N, shape_obs_dim]
        self._model_rows_cache = None               # (batched model, its K3-rows rows)
        self._shape_args = None                     # enable_shape_variation's, for resample_shapes
        self._prop_rand_base = None                 # the model DR's prop multipliers apply to
        self._prop_rand_args = None                 # randomize_physical_props', for the re-draws
        # one frame of self obs: [v1's, ankle forces 6 and 6 zeros (v3)?, shape row?]
        self.self_obs_dim_single = (cuda_obs.self_obs_dim(J, cfg.root_height_obs) + 12 * (cfg.self_obs_v == 3)
                                    + self.shape_obs_dim)
        # the self obs, all its frames: what a PULSE prior reads
        self.self_obs_dim = self.self_obs_dim_single * (cfg.self_obs_hist_steps if cfg.self_obs_v == 2 else 1)
        T, Jt = cfg.num_traj_samples, len(self.track_body_ids)
        self.task_obs_dim = {6: T * Jt * 24, 7: T * Jt * 9, 8: Jt * 15 + T * Jt * 15, 9: T * (Jt * 18 + 6)}[cfg.obs_v]
        self.obs_dim = self.self_obs_dim + self.task_obs_dim
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
        for attr in ("batched_model", "_shape_obs_table", "_model_rows_cache", "_shape_args", "_prop_rand_base",
                     "_prop_rand_args"):
            setattr(new, attr, getattr(self, attr))
        if (new.obs_dim, new.amp_obs_dim) != (self.obs_dim, self.amp_obs_dim):
            raise ValueError("with_config must keep the obs and AMP obs widths")
        return new

    def _check_config(self) -> None:
        """Raise on a config outside the env's options."""
        cfg = self.config
        for name, allowed in (("control_mode", ("isaac_pd", "pd", "force")), ("state_init", STATE_INITS),
                              ("obs_v", (6, 7, 8, 9)), ("self_obs_v", (1, 2, 3)), ("amp_obs_v", (1, 2))):
            if getattr(cfg, name) not in allowed:
                raise ValueError(f"unsupported {name} {getattr(cfg, name)!r}")

    def _kernel_surface(self) -> bool:
        """The step's physics is K1's or K3's and its reward and observation
        are K1's / RA's and K2's: isaac_pd, task obs v6 over all bodies with
        one future frame, self obs v1, no far-goal mode (the JAX package's
        `_fused_step_ok` surface). DR noise, obs noise and occlusion act on
        the action and the final observation, so they ride this path."""
        cfg = self.config
        return (cfg.control_mode == "isaac_pd" and cfg.obs_v == 6 and cfg.self_obs_v == 1
                and cfg.num_traj_samples == 1 and self._all_tracked and not cfg.zero_out_far)

    def _fused_step_ok(self) -> bool:
        """K1 may run the step (of a shared model): no shape channels, no
        domain randomization, and no subclass replaces a stage it fuses."""
        t = type(self)
        return (
            self._kernel_surface()
            and self.shape_obs_dim == 0
            and self.config.dr is None
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
        """(motion ids [n], start times [n]) for n fresh episodes: the clip's
        start (Default, Start), a uniform time in it (Random), or, per env,
        the start where a uniform draw exceeds `hybrid_init_prob` and a
        uniform time elsewhere (Hybrid)."""
        cfg, g = self.config, self.generator
        motion_ids = sample_motions(g, self.motion, n)
        if cfg.state_init in ("Default", "Start"):
            return motion_ids, torch.zeros(n, device=self.device)
        times = sample_time(g, self.motion, motion_ids)
        if cfg.state_init == "Hybrid":
            times = torch.where(torch.rand(n, generator=g, device=self.device) > cfg.hybrid_init_prob, 0.0, times)
        return motion_ids, times

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
        """Reference-state init onto (clip, time) pairs; obs left at zero,
        the self-obs history (v2) the state's own frame repeated. With
        per-env shapes the motion tables' bodies (the base skeleton's) do
        not fit, so each env's pose is FK'd through its own model."""
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
            self_obs_hist=(self._self_obs_single(physics)[:, None].expand(-1, self.config.self_obs_hist_steps, -1)
                           if self.config.self_obs_v == 2 else None),
        )

    def _reset_states(self, mask: torch.Tensor) -> EnvState:
        """Fresh states (obs left at zero) for all [B] envs, of which those
        in `mask` take them. A hook for subclasses; here the
        reference-state init at a random clip time."""
        return self._fresh(*self._sample_reset(mask.shape[0]))

    def reset_to(self, motion_ids: torch.Tensor, start_times: torch.Tensor) -> EnvState:
        state = self._with_dr(self._fresh(motion_ids, start_times))
        return state.replace(obs=self._observe(state))

    def reset(self, num_envs: int) -> EnvState:
        state = self._with_dr(self._reset_states(torch.ones(num_envs, dtype=torch.bool, device=self.device)))
        return state.replace(obs=self._observe(state))

    def _with_dr(self, state: EnvState) -> EnvState:
        """With domain randomization, the first held correlated draws and
        the step counters at 0. Later resets keep an env's (the step's
        refresh owns them)."""
        if self.config.dr is None:
            return state
        B = state.motion_id.shape[0]
        return state.replace(dr_corr_obs=self._dr_draw("corr_obs", (B, self.obs_dim)),
                             dr_corr_act=self._dr_draw("corr_act", (B, self.action_dim)),
                             dr_step=torch.zeros(B, dtype=torch.int32, device=self.device))

    def _dr_draw(self, name: str, shape, spec=None) -> torch.Tensor:
        """One DR draw from the env's generator: the fresh noise of `spec`
        (standard normal, or uniform for a uniform spec), or without `spec`
        a correlated standard-normal draw. `name` (corr_obs, corr_act, act,
        obs) says which; a test can replace this method to feed given
        draws."""
        if spec is None:
            return torch.randn(shape, generator=self.generator, device=self.device)
        return draw_noise(spec, shape, self.generator)

    def _observe(self, state: EnvState) -> torch.Tensor:
        """The observation of a state: K2 on the kernels' surface, else
        `_observe_general`."""
        if not self._kernel_surface():
            return self._observe_general(state)
        # K2 against the reference at the next control step's time (with the
        # cycle offset of the state's own time, as the JAX package's)
        t_next = self._motion_time(state.motion_id, state.start_time, state.progress) + self.model.config.control_dt
        ref = get_motion_state(self.motion, state.motion_id, t_next,
                               self._cycle_offset(state.motion_id, state.start_time, state.progress))
        observe = cuda_obs.observe if self.config.use_pallas_physics else cuda_obs.observe_plain
        return observe(self.consts, state.physics, ref, self._shape_obs(state.motion_id.shape[0]))

    def _self_obs_single(self, physics: PhysicsState) -> torch.Tensor:
        """One frame of self obs [B, self_obs_dim_single]: v1's, then (v3)
        the ankles' contact forces and as many zeros, then the shape row."""
        cfg = self.config
        B = physics.body_pos.shape[0]
        parts = [kernels.compute_humanoid_self_obs_max(
            physics.body_pos, physics.body_rot, physics.body_vel, physics.body_ang_vel,
            local_root_obs=cfg.local_root_obs, root_height_obs=cfg.root_height_obs)]
        if cfg.self_obs_v == 3:
            force = physics.contact_force[:, self.sensor_body_ids].reshape(B, -1)
            parts += [force, torch.zeros_like(force)]
        shape = self._shape_obs(B)
        return torch.cat(parts + ([] if shape is None else [shape]), dim=-1)

    def _observe_general(self, state: EnvState) -> torch.Tensor:
        """[B, obs_dim]: the self obs (the history, newest first, for v2),
        then the task obs of the tracked bodies against the reference's
        `num_traj_samples` frames from the next control step's time, every
        `traj_sample_timestep` (with the cycle offset of the state's own
        time). In the far-goal mode a far env's task obs is zeros but for
        the heading-local vector to its first frame's reference root."""
        cfg, ph = self.config, state.physics
        B, T = state.motion_id.shape[0], cfg.num_traj_samples
        if cfg.self_obs_v == 2:
            self_obs = state.self_obs_hist.flatten(1)
        else:
            self_obs = self._self_obs_single(ph)
        t_next = self._motion_time(state.motion_id, state.start_time, state.progress) + self.model.config.control_dt
        times = t_next[:, None] + torch.arange(T, dtype=torch.float32, device=self.device) * cfg.traj_sample_timestep
        offset = self._cycle_offset(state.motion_id, state.start_time, state.progress)
        ref = get_motion_state(self.motion, state.motion_id[:, None].expand(B, T), times,
                               None if offset is None else offset[:, None].expand(B, T, 3))
        tb = self._track
        body = (ph.body_pos[:, tb], ph.body_rot[:, tb], ph.body_vel[:, tb], ph.body_ang_vel[:, tb])
        ref_body = (ref["rg_pos"][:, :, tb], ref["rb_rot"][:, :, tb], ref["body_vel"][:, :, tb],
                    ref["body_ang_vel"][:, :, tb])
        if cfg.obs_v == 6:
            task = kernels.compute_imitation_observations_v6(ph.root_pos, ph.root_rot, *body, *ref_body)
        elif cfg.obs_v == 7:
            task = kernels.compute_imitation_observations_v7(ph.root_pos, ph.root_rot, body[0], body[2],
                                                             ref_body[0], ref_body[2])
        elif cfg.obs_v == 8:
            task = kernels.compute_imitation_observations_v8(ph.root_pos, ph.root_rot, *body, *ref_body)
        else:   # v9 reads the root's reference velocities only
            task = kernels.compute_imitation_observations_v9(ph.root_pos, ph.root_rot, *body, *ref_body[:2],
                                                             ref["body_vel"][:, :, 0], ref["body_ang_vel"][:, :, 0])
        if cfg.zero_out_far:
            far = self._far_from_ref(state)
            goal = q.quat_rotate(q.calc_heading_quat_inv(ph.root_rot), ref["rg_pos"][:, 0, 0] - ph.root_pos)
            point = torch.cat([goal, torch.zeros_like(task[:, 3:])], dim=-1)
            task = torch.where(far[:, None], point, task)
        return torch.cat([self_obs, task], dim=-1)

    def _far_distance(self, ref: dict, physics: PhysicsState) -> torch.Tensor:
        """[B] XY distance of the root to the reference root."""
        return torch.linalg.vector_norm(ref["root_pos"][:, :2] - physics.root_pos[:, :2], dim=-1)

    def _far_from_ref(self, state: EnvState) -> torch.Tensor:
        """[B] bool: the root lies beyond `zero_out_far_distance` of the
        reference root at the state's own time."""
        t = self._motion_time(state.motion_id, state.start_time, state.progress)
        ref = get_motion_state(self.motion, state.motion_id, t,
                               self._cycle_offset(state.motion_id, state.start_time, state.progress))
        return self._far_distance(ref, state.physics) > self.config.zero_out_far_distance

    def _dr_obs(self, state: EnvState, merged: EnvState, obs: torch.Tensor) -> tuple[EnvState, torch.Tensor]:
        """DR after the merge: the held correlated draws redrawn where the
        pre-step counter is a multiple of `frequency` (else the pre-step
        state's, whatever the merge picked), the counter advanced, and the
        observation noise at the pre-step counter on `obs`."""
        dr, B = self.config.dr, obs.shape[0]
        refresh = (state.dr_step % dr.frequency == 0)[:, None]
        corr_obs = torch.where(refresh, self._dr_draw("corr_obs", (B, self.obs_dim)), state.dr_corr_obs)
        corr_act = torch.where(refresh, self._dr_draw("corr_act", (B, self.action_dim)), state.dr_corr_act)
        merged = merged.replace(dr_corr_obs=corr_obs, dr_corr_act=corr_act, dr_step=state.dr_step + 1)
        if dr.observations is not None:
            obs = apply_noise(dr.observations, obs, corr_obs, self._dr_draw("obs", obs.shape, dr.observations),
                              state.dr_step)
        return merged, obs

    def _dr_action_noise(self, state: EnvState, actions: torch.Tensor) -> torch.Tensor:
        """DR's action noise, before the motor mapping."""
        dr = self.config.dr
        if dr is None or dr.actions is None:
            return actions
        return apply_noise(dr.actions, actions, state.dr_corr_act, self._dr_draw("act", actions.shape, dr.actions),
                           state.dr_step)

    def motor_actions(self, state: EnvState, actions: torch.Tensor) -> torch.Tensor:
        """The policy's action in the motor action space: identity here. The
        MCP envs blend their frozen primitives here; `step` and
        `_step_general` both call it, so K1 runs their step too."""
        return actions

    def _perturb_obs(self, obs: torch.Tensor) -> torch.Tensor:
        """A step's final observation with obs noise (std `obs_noise_std`),
        then occlusion: with probability `occlusion_prob` per env, a
        contiguous chunk of `max(int(task_obs_dim * occlusion_frac), 1)`
        task-obs columns at a uniform offset is zeroed."""
        cfg, g, dev = self.config, self.generator, self.device
        if cfg.obs_noise_std > 0:
            obs = obs + cfg.obs_noise_std * torch.randn(obs.shape, generator=g, device=dev)
        if cfg.occlusion_prob > 0:
            B = obs.shape[0]
            width = max(int(self.task_obs_dim * cfg.occlusion_frac), 1)
            start = self.self_obs_dim + torch.randint(0, max(self.task_obs_dim - width, 1), (B, 1), generator=g,
                                                      device=dev)
            occlude = torch.rand(B, 1, generator=g, device=dev) < cfg.occlusion_prob
            col = torch.arange(self.obs_dim, device=dev)
            obs = obs.masked_fill(occlude & (col >= start) & (col < start + width), 0.0)
        return obs

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

    def _post_step_ref(self, state: EnvState, progress: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """(in-clip time [B], reference) at the post-step time; it depends only
        on (clip, progress), so it is gathered before the physics."""
        t = self._motion_time(state.motion_id, state.start_time, progress)
        return t, get_motion_state(self.motion, state.motion_id, t,
                                   self._cycle_offset(state.motion_id, state.start_time, progress))

    def _physics_step(self, physics: PhysicsState, pd_target: torch.Tensor, actions: torch.Tensor) -> PhysicsState:
        """One control period of the env's control mode: isaac_pd K3, or
        K3-rows under each env's own model; pd and force the plain PyTorch
        steps (force: tau = action * motor_effort * power_scale)."""
        cfg = self.config
        m = self.model if self.batched_model is None else self.batched_model
        if cfg.control_mode == "force":
            return physics_step_torque(m, physics, actions * (cfg.motor_effort * cfg.power_scale))
        if cfg.control_mode == "pd":
            return physics_step_pd_explicit(m, physics, pd_target)
        if not cfg.use_pallas_physics:
            return physics_step(m, physics, pd_target)
        rows = None if self.batched_model is None else self._model_rows(pd_target.shape[0])
        return substep_cuda.physics_step_cuda(self.model, physics, pd_target, model_rows=rows)

    def _motor_pd_target(self, state: EnvState, actions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(motor actions, PD targets) of the policy's actions: DR's action
        noise, then `motor_actions`, then the PD map."""
        actions = self.motor_actions(state, self._dr_action_noise(state, actions))
        return actions, self.action_to_pd_target(actions)

    def step(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        if not self._kernel_surface():
            return self._step_general(state, actions)
        progress = state.progress + 1
        t, ref = self._post_step_ref(state, progress)
        actions, pd_target = self._motor_pd_target(state, actions)
        kernels_on = self.config.use_pallas_physics
        if self.batched_model is None and self._fused_step_ok():
            step_reward_amp = cuda_obs.step_reward_amp if kernels_on else cuda_obs.step_reward_amp_plain
            physics, *terms = step_reward_amp(self.model, self.consts, state.physics, pd_target, ref)
        else:
            physics = self._physics_step(state.physics, pd_target, actions)
            reward_amp = cuda_obs.reward_amp if kernels_on else cuda_obs.reward_amp_plain
            terms = reward_amp(self.consts, physics, ref, *self._disc_parts(actions.shape[0]))
        return self._finish_step(state, progress, t, ref, physics, pd_target, *terms, observe=self._observe)

    def _step_general(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        """The step off the kernels' surface, valid on it too: the control
        mode's physics (`_physics_step`), then `_finish_general`."""
        actions, pd_target = self._motor_pd_target(state, actions)
        physics = self._physics_step(state.physics, pd_target, actions)
        return self._finish_general(state, physics, pd_target)

    def _finish_general(self, state: EnvState, physics: PhysicsState, pd_target: torch.Tensor) -> EnvState:
        """Everything after the physics off the kernels' surface: the
        imitation reward over the tracked bodies, the reset bodies'
        distances and the AMP row in plain PyTorch, then `_finish_step`
        with `_observe_general` of the merged state."""
        progress = state.progress + 1
        t, ref = self._post_step_ref(state, progress)
        e, tb = self.consts, self._track
        reward, reward_raw = kernels.compute_imitation_reward(
            physics.body_pos[:, tb], physics.body_rot[:, tb], physics.body_vel[:, tb], physics.body_ang_vel[:, tb],
            ref["rg_pos"][:, tb], ref["rb_rot"][:, tb], ref["body_vel"][:, tb], ref["body_ang_vel"][:, tb],
            k_pos=e.k_pos, k_rot=e.k_rot, k_vel=e.k_vel, k_ang_vel=e.k_ang_vel,
            w_pos=e.w_pos, w_rot=e.w_rot, w_vel=e.w_vel, w_ang_vel=e.w_ang_vel,
        )
        rid = self.reset_body_ids
        dist = torch.linalg.vector_norm(physics.body_pos[:, rid] - ref["rg_pos"][:, rid], dim=-1)
        amp_row = cuda_obs.amp_row_plain(e, physics, *self._disc_parts(pd_target.shape[0]))
        return self._finish_step(state, progress, t, ref, physics, pd_target, reward, reward_raw, dist.mean(dim=-1),
                                 dist.amax(dim=-1), amp_row, observe=self._observe_general)

    def _finish_step(self, state: EnvState, progress: torch.Tensor, t: torch.Tensor, ref: dict,
                     physics: PhysicsState, pd_target: torch.Tensor, reward: torch.Tensor, reward_raw: torch.Tensor,
                     dmean: torch.Tensor, dmax: torch.Tensor, amp_row: torch.Tensor, observe) -> EnvState:
        """Everything after the reward terms: the power penalty, the far-goal
        mode, termination, the history rolls, the auto-reset merge, the
        observation (`observe` of the merged state), DR's refresh and noise,
        obs noise and occlusion."""
        cfg = self.config
        if cfg.power_reward:
            # the PD torque proxy kp (target - dof) - kd dof_vel of the env's model
            m = self.model if self.batched_model is None else self.batched_model
            dof_vel = dof_vel_from_state(physics)
            tau = (m.joint_kp.repeat_interleave(3, dim=-1) * (pd_target - dof_pos_from_state(physics))
                   - m.joint_kd.repeat_interleave(3, dim=-1) * dof_vel)
            reward = reward + kernels.compute_power_penalty(tau, dof_vel, cfg.power_coefficient)
        far = None
        if cfg.zero_out_far:
            # a far env is rewarded for closing in on the reference root
            d = self._far_distance(ref, physics)
            far = d > cfg.zero_out_far_distance
            reward = torch.where(far, torch.exp(-d * d), reward)

        hist = state.self_obs_hist
        if cfg.self_obs_v == 2:
            hist = torch.cat([self._self_obs_single(physics)[:, None], hist[:, :-1]], dim=1)
        stepped = state.replace(
            physics=physics,
            progress=progress,
            amp_hist=torch.cat([amp_row[:, None], state.amp_hist[:, :-1]], dim=1),
            self_obs_hist=hist,
        )
        if cfg.cycle_motion:
            pass_time = progress >= cfg.episode_length
        else:
            pass_time = t >= self.motion.motion_lengths[state.motion_id]
        reset, terminate = self._termination(stepped, dmean, dmax, pass_time)
        if far is not None:
            # the imitation termination is off in the far-goal mode
            terminate = terminate & ~far
            reset = pass_time | terminate
        merged = _select(reset, self._reset_states(reset), stepped)
        obs = observe(merged)
        if cfg.dr is not None:
            merged, obs = self._dr_obs(state, merged, obs)
        return merged.replace(obs=self._perturb_obs(obs), reward=reward, reward_raw=reward_raw,
                              done=reset, terminate=terminate)

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
        was called with, from the generator it drew from; DR's physical
        props are then re-drawn on the new shapes."""
        if self._shape_args is None:
            raise RuntimeError("resample_shapes before enable_shape_variation")
        self.enable_shape_variation(**self._shape_args)
        self._prop_rand_base = None
        if self._prop_rand_args is not None:
            self.randomize_physical_props(**self._prop_rand_args)

    def randomize_physical_props(self, num_envs: int, generator: torch.Generator | None = None) -> None:
        """DR's per-env physical props: multipliers in the config's friction,
        mass and gain ranges, drawn from `generator` (default: the env's),
        on the pre-DR model (the per-env shapes or the shared model), so
        that re-draws never compound. A no-op without prop ranges. The
        batched model is a new object, so the K3-rows rows are rebuilt."""
        dr = self.config.dr
        if dr is None or not dr.has_props:
            return
        g = self.generator if generator is None else generator
        if self._prop_rand_base is None:
            self._prop_rand_base = self.model if self.batched_model is None else self.batched_model
        self.batched_model = randomize_model_props(self._prop_rand_base, g, num_envs, dr.friction_range,
                                                   dr.mass_range, dr.gain_range)
        self._prop_rand_args = dict(num_envs=num_envs, generator=g)

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
        """The AMP row's shape tails of the env's own shape rows: ([B, 11]
        gender+betas or None, [B, 10] limb weights or None)."""
        return self._disc_extra_parts(self._shape_obs(B))

    def _disc_extra_parts(self, shape_obs) -> tuple:
        """The AMP row's shape tails sliced from shape rows laid out as the
        observation's ([gender, betas]? [limb weights]?): ([n, 11] or None,
        [n, 10] or None) from per-sample rows [n, E] or one row [E] (as
        [1, ...]); zeros for None."""
        cfg = self.config
        if not (cfg.has_shape_obs_disc or cfg.has_limb_weight_obs):
            return None, None
        rows = torch.zeros(self.shape_obs_dim, device=self.device) if shape_obs is None else shape_obs
        rows = rows if rows.ndim == 2 else rows[None]
        return (rows[:, :11] if cfg.has_shape_obs_disc else None,
                rows[:, -10:] if cfg.has_limb_weight_obs else None)

    def amp_obs_from_motion_state(self, st: dict, shape_obs=None) -> torch.Tensor:
        """AMP rows [n, A] of a `get_motion_state` dict over n samples (the
        demo fetch), their shape columns from `shape_obs`: per-sample rows
        [n, E] (each demo its own clip's), one row [E] for all, or zeros."""
        n = st["root_pos"].shape[0]
        shape_p, limb_p = self._disc_extra_parts(shape_obs)
        kw = dict(local_root_obs=self.config.local_root_obs, root_height_obs=self.config.root_height_obs,
                  shape_params=None if shape_p is None else shape_p.expand(n, -1),
                  limb_weight_params=None if limb_p is None else limb_p.expand(n, -1))
        args = (st["root_pos"], st["root_rot"], st["root_vel"], st["root_ang_vel"], st["dof_pos"], st["dof_vel"],
                st["rg_pos"][:, self.key_body_ids])
        if self.config.amp_obs_v == 2:
            return kernels.build_amp_observations_smpl_v2(*args, st["body_vel"][:, self.key_body_ids], **kw)
        return kernels.build_amp_observations_smpl(*args, **kw)
