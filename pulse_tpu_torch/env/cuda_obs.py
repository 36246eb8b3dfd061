"""The imitation env step's hand-written CUDA kernels, their wrappers and
their plain PyTorch versions.

Counterpart of `pulse_tpu/env/pallas_obs.py`:

  * K1 `step_reward_amp` — one launch for the pre-merge half of the step:
    the physics control step, the imitation reward and its raw terms, the
    termination distances and the AMP row of the stepped state
    (csrc/step_reward_amp.cu; replaces `pallas_step_reward_amp`).
  * RA `reward_amp` — K1's epilogue alone, on a state K3 or K3-rows
    stepped (csrc/reward_amp.cu; replaces `pallas_reward_amp`). The env
    runs K3 → RA where a subclass overrides termination or reset or the
    observation carries shape channels, and K3-rows → RA with per-env body
    shapes. The wrapper fills the env's shape columns of the AMP row.
  * K2 `observe` — self obs v1 ++ task obs v6 (T = 1) of the post-merge
    state (csrc/observe.cu + observe.cuh; replaces `pallas_observe`). The
    wrapper fills the env's shape columns between the two.

The shape columns are functions of the env's body shape alone, never of
the state, so they stay outside the kernels.

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel or raises; it never falls back. `_build.launches`
counts the kernel launches of each wrapper.

Kernel layouts. K1's records are env-major [B, rows] float32, as K3's (a
group of lanes steps one env and reads and writes its record
contiguously). RA (one warp an env) and K2 (one thread an (env, body)
pair) read the [B, ...] tensors in place, each through its pointer and env
stride (`substep_cuda.env_strided`), and write env-major outputs: RA
reward, raws, distances and the AMP row into their own tensors, K2 the
[B, obs_dim] observation.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from pulse_tpu_torch import _build
from pulse_tpu_torch.env import kernels
from pulse_tpu_torch.physics import substep_cuda
from pulse_tpu_torch.physics.model import Model
from pulse_tpu_torch.physics.state import PhysicsState, dof_pos_from_state, dof_vel_from_state
from pulse_tpu_torch.physics.step import physics_step
from pulse_tpu_torch.physics.substep_cuda import check_kernel_inputs, env_block, env_strided, physics_state_from_rows

MAX_KEY = 8           # csrc/reward_amp.cuh MAX_KEY
RA_ROWS = 7           # csrc/reward_amp.cuh kRaRows: reward, 4 raws, dist mean, dist max


@dataclasses.dataclass(frozen=True)
class EnvConsts:
    """Per-env constants both kernels need (key/reset bodies, obs flags,
    reward k/w)."""

    J: int
    key_ids: tuple
    reset_ids: tuple
    local_root_obs: bool
    root_height_obs: bool
    amp_v: int
    k_pos: float
    k_rot: float
    k_vel: float
    k_ang_vel: float
    w_pos: float
    w_rot: float
    w_vel: float
    w_ang_vel: float

    def table(self) -> bytes:
        """The bytes of csrc EnvConsts (4-byte fields, no padding)."""
        if len(self.key_ids) > MAX_KEY or len(self.reset_ids) > substep_cuda.MAX_J:
            raise NotImplementedError("too many key or reset bodies for the CUDA kernel")
        ints = np.zeros(8 + MAX_KEY + substep_cuda.MAX_J, np.int32)
        ints[:6] = [len(self.key_ids), len(self.reset_ids), self.local_root_obs, self.root_height_obs, self.amp_v,
                    self.J]
        ints[8 : 8 + len(self.key_ids)] = self.key_ids
        ints[8 + MAX_KEY : 8 + MAX_KEY + len(self.reset_ids)] = self.reset_ids
        floats = np.asarray(
            [self.k_pos, self.k_rot, self.k_vel, self.k_ang_vel, self.w_pos, self.w_rot, self.w_vel, self.w_ang_vel],
            np.float32,
        )
        return ints.tobytes() + floats.tobytes()


def env_consts_from(env) -> EnvConsts:
    cfg = env.config
    return EnvConsts(
        J=env.model.num_bodies,
        key_ids=tuple(int(b) for b in env.key_body_ids),
        reset_ids=tuple(int(b) for b in env.reset_body_ids),
        local_root_obs=bool(cfg.local_root_obs),
        root_height_obs=bool(cfg.root_height_obs),
        amp_v=int(cfg.amp_obs_v),
        k_pos=float(cfg.k_pos), k_rot=float(cfg.k_rot), k_vel=float(cfg.k_vel), k_ang_vel=float(cfg.k_ang_vel),
        w_pos=float(cfg.w_pos), w_rot=float(cfg.w_rot), w_vel=float(cfg.w_vel), w_ang_vel=float(cfg.w_ang_vel),
    )


def amp_obs_dim(J: int, num_key: int, amp_v: int, root_height: bool, shape_dim: int = 0) -> int:
    """AMP row width: RA's, then `shape_dim` shape columns."""
    D = 3 * (J - 1)
    return (1 if root_height else 0) + 6 + 3 + 3 + 2 * D + D + 3 * num_key + (3 * num_key if amp_v == 2 else 0) + shape_dim


def self_obs_dim(J: int, root_height: bool) -> int:
    return (1 if root_height else 0) + 3 * (J - 1) + 12 * J


def obs_dim(J: int, root_height: bool, shape_dim: int = 0) -> int:
    """Observation width: self obs, `shape_dim` shape columns, task obs."""
    return self_obs_dim(J, root_height) + shape_dim + 24 * J


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #

def amp_row_plain(e: EnvConsts, physics: PhysicsState, shape_params=None, limb_weight_params=None) -> torch.Tensor:
    """The AMP row [B, A] of a stepped state (RA's last output), ending with
    the given per-env shape columns ([B, 11] gender+betas, [B, 10] limb
    weights)."""
    kid = list(e.key_ids)
    args = (
        physics.root_pos, physics.root_rot, physics.body_vel[:, 0], physics.body_ang_vel[:, 0],
        dof_pos_from_state(physics), dof_vel_from_state(physics), physics.body_pos[:, kid],
    )
    kw = dict(local_root_obs=e.local_root_obs, root_height_obs=e.root_height_obs, shape_params=shape_params,
              limb_weight_params=limb_weight_params)
    if e.amp_v == 2:
        return kernels.build_amp_observations_smpl_v2(*args, physics.body_vel[:, kid], **kw)
    return kernels.build_amp_observations_smpl(*args, **kw)


def reward_amp_plain(e: EnvConsts, physics: PhysicsState, ref: dict, shape_params=None, limb_weight_params=None):
    """K1's epilogue on an already-stepped state: (reward [B], raw [B, 4],
    dist_mean [B], dist_max [B], amp row [B, A]); the AMP row ends with the
    given per-env shape columns."""
    reward, raw = kernels.compute_imitation_reward(
        physics.body_pos, physics.body_rot, physics.body_vel, physics.body_ang_vel,
        ref["rg_pos"], ref["rb_rot"], ref["body_vel"], ref["body_ang_vel"],
        k_pos=e.k_pos, k_rot=e.k_rot, k_vel=e.k_vel, k_ang_vel=e.k_ang_vel,
        w_pos=e.w_pos, w_rot=e.w_rot, w_vel=e.w_vel, w_ang_vel=e.w_ang_vel,
    )
    rid = list(e.reset_ids)
    dist = torch.linalg.vector_norm(physics.body_pos[:, rid] - ref["rg_pos"][:, rid], dim=-1)
    amp = amp_row_plain(e, physics, shape_params, limb_weight_params)
    return reward, raw, dist.mean(dim=-1), dist.amax(dim=-1), amp


def step_reward_amp_plain(model: Model, e: EnvConsts, state: PhysicsState, pd_target: torch.Tensor, ref: dict):
    """K1's plain version: physics_step, then the epilogue."""
    physics = physics_step(model, state, pd_target)
    return (physics,) + reward_amp_plain(e, physics, ref)


def observe_plain(e: EnvConsts, physics: PhysicsState, ref: dict, shape_obs=None) -> torch.Tensor:
    """K2's plain version: [B, obs_dim] self obs v1 ++ task obs v6 (T = 1),
    with body 0 as the root, and the per-env shape columns [B, S] spliced
    in between where given."""
    self_obs = kernels.compute_humanoid_self_obs_max(
        physics.body_pos, physics.body_rot, physics.body_vel, physics.body_ang_vel,
        local_root_obs=e.local_root_obs, root_height_obs=e.root_height_obs,
    )
    task_obs = kernels.compute_imitation_observations_v6(
        physics.body_pos[:, 0], physics.body_rot[:, 0],
        physics.body_pos, physics.body_rot, physics.body_vel, physics.body_ang_vel,
        ref["rg_pos"][:, None], ref["rb_rot"][:, None], ref["body_vel"][:, None], ref["body_ang_vel"][:, None],
    )
    return torch.cat([self_obs] + ([] if shape_obs is None else [shape_obs]) + [task_obs], dim=-1)


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #

def _bodies(ref: dict) -> list[torch.Tensor]:
    return [ref["rg_pos"], ref["rb_rot"], ref["body_vel"], ref["body_ang_vel"]]


def step_reward_amp(model: Model, e: EnvConsts, state: PhysicsState, pd_target: torch.Tensor, ref: dict):
    """K1. Returns (stepped PhysicsState, reward [B], raw [B, 4],
    dist_mean [B], dist_max [B], amp row [B, A])."""
    if state.root_pos.device.type == "cpu":
        return step_reward_amp_plain(model, e, state, pd_target, ref)
    if not substep_cuda.supported(model):
        raise NotImplementedError("model outside the CUDA kernel's surface")
    B, J = state.root_pos.shape[0], model.num_bodies
    Jm1 = J - 1
    parts = [state.root_pos, state.root_rot, state.joint_rot, state.root_vel6, state.joint_omega, pd_target]
    dev = check_kernel_inputs(parts + _bodies(ref), B)
    n_state = substep_cuda.state_rows(J)
    n_in = n_state + 3 * Jm1 + 13 * J
    n_out = n_state + 16 * J + RA_ROWS + amp_obs_dim(J, len(e.key_ids), e.amp_v, e.root_height_obs)
    lib = _build.load()
    with torch.cuda.device(dev):
        x = env_block(parts + _bodies(ref), B, n_in)
        out = torch.empty(B, n_out, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.upload_consts("step_reward_amp", (model, e),
                             lambda: (substep_cuda.model_const_table(model), e.table()), dev, stream)
        # K3's G, so that K3 -> RA gives K1's bits
        _build.check(lib.k1_step_reward_amp(x.data_ptr(), out.data_ptr(), B, n_out, substep_cuda.GROUP, stream),
                     "K1 launch")
    _build.launches["step_reward_amp"] += 1
    return (physics_state_from_rows(out, J),) + _split_reward_amp(out[:, n_state + 16 * J :])


def _split_reward_amp(ra: torch.Tensor):
    """[B, 7 + A] epilogue rows -> (reward, raw, dist_mean, dist_max, amp)."""
    return (
        ra[:, 0].contiguous(),
        ra[:, 1:5].contiguous(),
        ra[:, 5].contiguous(),
        ra[:, 6].contiguous(),
        ra[:, RA_ROWS:].contiguous(),
    )


def _pointers(tensors: list[torch.Tensor], strides: list[int]) -> tuple:
    """ctypes arrays of the tensors' addresses and their env strides."""
    return ((ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors]),
            (ctypes.c_longlong * len(strides))(*strides))


def ra_outputs(B: int, n_amp: int, dev) -> tuple:
    """RA's outputs, one allocation: reward [B], raw [B, 4], dist_mean [B],
    dist_max [B] and the AMP row [B, n_amp], each contiguous."""
    buf = torch.empty(B * (RA_ROWS + n_amp), device=dev)
    return (buf[:B], buf[B : 5 * B].view(B, 4), buf[5 * B : 6 * B], buf[6 * B : 7 * B],
            buf[7 * B :].view(B, n_amp))


def reward_amp_args(e: EnvConsts, physics: PhysicsState, ref: dict, outs: tuple) -> tuple[tuple, list]:
    """`lib.ra_reward_amp`'s arguments but the stream, after the layout
    checks, and the input tensors they point into (`env_strided` may have
    copied one: keep them while the arguments are in use)."""
    B, J = physics.body_pos.shape[0], e.J
    # csrc/reward_amp.cuh RaIn's order
    ins = [env_strided(t, n) for t, n in zip(
        [physics.body_pos, physics.body_rot, physics.body_vel, physics.body_ang_vel, physics.joint_rot,
         physics.joint_omega] + _bodies(ref),
        (3 * J, 4 * J, 3 * J, 3 * J, 4 * (J - 1), 3 * (J - 1), 3 * J, 4 * J, 3 * J, 3 * J))]
    check_kernel_inputs([t for t, _ in ins] + list(outs), B)
    reward, raw, dmean, dmax, amp = outs
    n_amp = amp_obs_dim(J, len(e.key_ids), e.amp_v, e.root_height_obs)
    if (any(t.dim() != 1 for t in (reward, dmean, dmax)) or raw.shape[1:] != (4,) or raw.stride(1) != 1
            or amp.dim() != 2 or amp.shape[1] < n_amp or amp.stride(1) != 1):
        raise ValueError(f"RA outputs {[tuple(t.shape) for t in outs]}: expected [B], [B, 4], [B], [B], "
                         f"[B, >= {n_amp}] with unit stride within a row")
    tensors = [t for t, _ in ins]
    return (*_pointers(tensors, [s for _, s in ins]), *_pointers(list(outs), [t.stride(0) for t in outs]), B), tensors


def launch_reward_amp(e: EnvConsts, physics: PhysicsState, ref: dict, outs: tuple) -> None:
    """RA's kernel on CUDA tensors into `outs` (`ra_outputs`, or any five
    tensors of B rows with unit stride within a row), its env constants
    uploaded; counted in `_build.launches`."""
    args, _ = reward_amp_args(e, physics, ref, outs)
    dev = outs[0].device
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.upload_consts("reward_amp", (e,), lambda: (e.table(),), dev, stream)
        _build.check(lib.ra_reward_amp(*args, stream), "RA launch")
    _build.launches["reward_amp"] += 1


def reward_amp(e: EnvConsts, physics: PhysicsState, ref: dict, shape_params=None, limb_weight_params=None):
    """RA. K1's epilogue on an already-stepped state against the reference
    at the post-step time: (reward [B], raw [B, 4], dist_mean [B],
    dist_max [B], amp row [B, A]); the AMP row ends with the given per-env
    shape columns."""
    if physics.body_pos.device.type == "cpu":
        return reward_amp_plain(e, physics, ref, shape_params, limb_weight_params)
    B = physics.body_pos.shape[0]
    n_amp = amp_obs_dim(e.J, len(e.key_ids), e.amp_v, e.root_height_obs)
    tails = [t for t in (shape_params, limb_weight_params) if t is not None]
    outs = ra_outputs(B, n_amp + sum(t.shape[1] for t in tails), physics.body_pos.device)
    launch_reward_amp(e, physics, ref, outs)
    amp, col = outs[4], n_amp
    for t in tails:
        amp[:, col : col + t.shape[1]] = t
        col += t.shape[1]
    return outs


def observe_args(e: EnvConsts, physics: PhysicsState, ref: dict, out: torch.Tensor,
                 task_col: int) -> tuple[tuple, list]:
    """`lib.k2_observe`'s arguments but the stream, after the layout checks,
    and the input tensors they point into (keep them while the arguments
    are in use)."""
    B, J = physics.body_pos.shape[0], e.J
    # csrc/observe.cuh ObsIn's order
    ins = [env_strided(t, k * J) for t, k in zip(
        [physics.body_pos, physics.body_rot, physics.body_vel, physics.body_ang_vel] + _bodies(ref),
        (3, 4, 3, 3, 3, 4, 3, 3))]
    check_kernel_inputs([t for t, _ in ins] + [out], B)
    if out.stride(1) != 1 or out.shape[1] < task_col + 24 * J:
        raise ValueError(f"observation buffer {tuple(out.shape)} {out.stride()}: expected [B, >= {task_col + 24 * J}]"
                         " with unit column stride")
    tensors = [t for t, _ in ins]
    return (*_pointers(tensors, [s for _, s in ins]), out.data_ptr(), out.stride(0), task_col, B, J,
            int(e.local_root_obs), int(e.root_height_obs)), tensors


def launch_observe(e: EnvConsts, physics: PhysicsState, ref: dict, out: torch.Tensor, task_col: int) -> None:
    """K2's kernel on CUDA tensors into `out` ([B, >= task_col + 24 J], unit
    stride within a row): the self obs to columns [0, self_obs_dim), the
    task obs from column `task_col`; counted in `_build.launches`."""
    args, _ = observe_args(e, physics, ref, out, task_col)
    lib = _build.load()
    with torch.cuda.device(out.device):
        _build.check(lib.k2_observe(*args, torch.cuda.current_stream(out.device).cuda_stream), "K2 launch")
    _build.launches["observe"] += 1


def observe(e: EnvConsts, physics: PhysicsState, ref: dict, shape_obs=None) -> torch.Tensor:
    """K2. [B, obs_dim] observation of the (post-merge) state against the
    reference bodies at the next control time, with the per-env shape
    columns [B, S] between self and task obs where given."""
    if physics.body_pos.device.type == "cpu":
        return observe_plain(e, physics, ref, shape_obs)
    B = physics.body_pos.shape[0]
    S = 0 if shape_obs is None else shape_obs.shape[1]
    n_self = self_obs_dim(e.J, e.root_height_obs)
    out = torch.empty(B, obs_dim(e.J, e.root_height_obs, S), device=physics.body_pos.device)
    launch_observe(e, physics, ref, out, n_self + S)
    if S:
        out[:, n_self : n_self + S] = shape_obs
    return out
