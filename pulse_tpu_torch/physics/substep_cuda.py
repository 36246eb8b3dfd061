"""Kernel K3, the physics control step, and what the physics kernels share.

Counterpart of `pulse_tpu/physics/substep_pallas.py`:

  * K3 `physics_step_cuda` — the control step of a batch of humanoids under
    one shared model, with no epilogue (csrc/physics_step.cu; replaces
    `pallas_physics_step` without its `model_rows`). Its plain version is
    `physics/step.py:physics_step`.
  * the model as the constant table K1 and K3 read from `__constant__`
    memory (`_extract_consts`): the TPU kernel baked the model into its
    trace. The table's layout is `ModelConsts` in `csrc/physics_step.cuh`:
    4-byte fields in declaration order, no padding.
  * the `[rows, B]` layout of the kernels' inputs and outputs, and
    `physics_state_from_rows`, which K1 and K3 share.

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from pulse_tpu_torch import _build
from pulse_tpu_torch.physics.model import Model
from pulse_tpu_torch.physics.state import PhysicsState
from pulse_tpu_torch.physics.step import physics_step

MAX_J = 24   # csrc/humanoid_math.cuh MAX_J
MAX_P = 72   # csrc/physics_step.cuh MAX_P
# K3 threads per block (at most its __launch_bounds__(64)): one warp a block,
# as K1, spreads the envs over the most SMs
K3_BLOCK = 32


def supported(model: Model) -> bool:
    """The kernel covers the flat-ground stable-PD step of one shared model
    with at most MAX_J bodies and MAX_P contact points."""
    return (
        model.num_bodies <= MAX_J
        and model.cp_body.shape[0] <= MAX_P
        and not model.config.self_collision
    )


def _padded(x, shape, dtype) -> np.ndarray:
    x = np.asarray(x, dtype)
    out = np.zeros(shape, dtype)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


def model_const_table(model: Model) -> bytes:
    """Pack the model into the bytes of csrc ModelConsts."""
    if not supported(model):
        raise NotImplementedError("model outside the CUDA kernel's surface")
    cfg = model.config
    J = model.num_bodies
    P = int(model.cp_body.shape[0])
    f32, i32 = np.float32, np.int32

    def host(t):
        return t.detach().cpu().numpy()

    I6 = host(model.spatial_inertia)
    order = [b for lvl, _ in model.levels for b in lvl]
    h = cfg.h
    parts = [
        np.asarray([J, P, cfg.steps_per_control, 0], i32),
        _padded(order, (MAX_J,), i32),
        _padded(np.maximum(np.asarray(model.parents), 0), (MAX_J,), i32),
        _padded(host(model.local_translation), (MAX_J, 3), f32),
        _padded(host(model.body_mass), (MAX_J,), f32),
        _padded(host(model.body_com), (MAX_J, 3), f32),
        _padded(I6[:, 0:3, 0:3].reshape(J, 9), (MAX_J, 9), f32),
        _padded(I6[:, 0:3, 3:6].reshape(J, 9), (MAX_J, 9), f32),
        _padded(I6[:, 3:6, 3:6].reshape(J, 9), (MAX_J, 9), f32),
        _padded(host(model.joint_kp), (MAX_J,), f32),
        _padded(host(model.joint_kd), (MAX_J,), f32),
        _padded(host(model.joint_armature), (MAX_J,), f32),
        _padded(host(model.dof_lower).reshape(J - 1, 3), (MAX_J, 3), f32),
        _padded(host(model.dof_upper).reshape(J - 1, 3), (MAX_J, 3), f32),
        _padded(host(model.cp_body), (MAX_P,), i32),
        _padded(host(model.cp_offset), (MAX_P, 3), f32),
        _padded(host(model.cp_radius), (MAX_P,), f32),
        _padded(host(model.cp_friction), (MAX_P,), f32),
        np.asarray(
            [h, cfg.gravity, cfg.contact_stiffness, cfg.contact_damping,
             cfg.friction_regularization, cfg.max_contact_force, cfg.max_angular_velocity,
             cfg.max_linear_velocity, cfg.limit_stiffness, cfg.limit_damping, cfg.torque_limit,
             h * (cfg.limit_damping + h * cfg.limit_stiffness)],
            f32,
        ),
    ]
    return b"".join(p.tobytes() for p in parts)


def state_rows(J: int) -> int:
    """Rows of the generalized-coordinate state: root pos 3 | root rot 4 |
    joint rot 4(J-1) | root vel6 6 | joint omega 3(J-1)."""
    return 13 + 7 * (J - 1)


def check_kernel_inputs(parts: list[torch.Tensor], B: int) -> torch.device:
    """The CUDA device of a kernel's inputs: float32, [B, ...], one device."""
    dev = parts[0].device
    for t in parts:
        if t.device != dev or t.dtype != torch.float32 or t.shape[0] != B:
            raise ValueError(f"kernel input on {t.device} {t.dtype} {tuple(t.shape)}: expected float32 [B={B}, ...] on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {dev}")
    return dev


def rows_block(parts: list[torch.Tensor], B: int, n_rows: int) -> torch.Tensor:
    """[B, ...] tensors -> one contiguous [n_rows, B] block."""
    x = torch.cat([t.reshape(B, -1) for t in parts], dim=1)
    if x.shape[1] != n_rows:
        raise ValueError(f"kernel input has {x.shape[1]} rows, expected {n_rows}")
    return x.t().contiguous()


def physics_state_from_rows(rows: torch.Tensor, J: int) -> PhysicsState:
    """[B, >= state_rows + 16 J] kernel output rows (state | contact 3J |
    bodies 13J, pos/rot/vel/ang per body) -> PhysicsState."""
    B, Jm1 = rows.shape[0], J - 1
    n_state = state_rows(J)
    body = rows[:, n_state + 3 * J : n_state + 16 * J].reshape(B, J, 13)
    return PhysicsState(
        root_pos=rows[:, 0:3].contiguous(),
        root_rot=rows[:, 3:7].contiguous(),
        joint_rot=rows[:, 7 : 7 + 4 * Jm1].reshape(B, Jm1, 4),
        root_vel6=rows[:, 7 + 4 * Jm1 : 13 + 4 * Jm1].contiguous(),
        joint_omega=rows[:, 13 + 4 * Jm1 : n_state].reshape(B, Jm1, 3),
        body_pos=body[..., 0:3].contiguous(),
        body_rot=body[..., 3:7].contiguous(),
        body_vel=body[..., 7:10].contiguous(),
        body_ang_vel=body[..., 10:13].contiguous(),
        contact_force=rows[:, n_state : n_state + 3 * J].reshape(B, J, 3),
    )


def physics_step_cuda(model: Model, state: PhysicsState, pd_target: torch.Tensor) -> PhysicsState:
    """K3. One control period of [B] humanoids under stable-PD position
    control: the stepped state with refreshed world bodies and the
    substep-mean contact force, as `physics_step` computes it."""
    if state.root_pos.device.type == "cpu":
        return physics_step(model, state, pd_target)
    if not supported(model):
        raise NotImplementedError("model outside the CUDA kernel's surface")
    B, J = state.root_pos.shape[0], model.num_bodies
    parts = [state.root_pos, state.root_rot, state.joint_rot, state.root_vel6, state.joint_omega, pd_target]
    dev = check_kernel_inputs(parts, B)
    n_state = state_rows(J)
    lib = _build.load()
    with torch.cuda.device(dev):
        x = rows_block(parts, B, n_state + 3 * (J - 1))
        out = torch.empty(n_state + 16 * J, B, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.upload_consts("physics_step", (model,), lambda: (model_const_table(model),), dev, stream)
        _build.check(lib.k3_physics_step(x.data_ptr(), out.data_ptr(), B, K3_BLOCK, stream), "K3 launch")
    _build.launches["physics_step"] += 1
    return physics_state_from_rows(out.t(), J)
