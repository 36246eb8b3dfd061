"""Kernels K3 and K3-rows, the physics control step, and what the physics
kernels share.

Counterpart of `pulse_tpu/physics/substep_pallas.py`:

  * K3 `physics_step_cuda` — the control step of a batch of humanoids under
    one shared model, with no epilogue (csrc/physics_step.cu; replaces
    `pallas_physics_step` without its `model_rows`). Its plain version is
    `physics/step.py:physics_step`.
  * K3-rows, `physics_step_cuda(..., model_rows=...)` — the same step with
    each env's own model, read from per-env model rows
    (`build_model_rows`, in `_model_rows_layout`'s order; replaces
    `pallas_physics_step` with `model_rows`). Its plain version is
    `physics_step` on the batched model the rows hold (`model_from_rows`).
  * the model as the constant table K1 and K3 read from `__constant__`
    memory (`_extract_consts`): the TPU kernel baked the model into its
    trace. The table's layout is `ModelConsts` in `csrc/physics_step.cuh`:
    4-byte fields in declaration order, no padding, with the topology the
    kernels' phases walk (level starts, each body's children and contact
    points). K3-rows reads only the topology and the config scalars from
    it, uploaded from the base model.
  * the env-major `[B, rows]` records of the physics kernels' inputs and
    outputs (`env_block`, `physics_state_from_rows`), which K1 and K3 share,
    and the layout check of the `[B, ...]` tensors RA and K2 read in place
    (`env_strided`).

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pulse_tpu_torch import _build
from pulse_tpu_torch.physics import spatial
from pulse_tpu_torch.physics.model import Model
from pulse_tpu_torch.physics.state import PhysicsState
from pulse_tpu_torch.physics.step import physics_step

MAX_J = 24   # csrc/humanoid_math.cuh MAX_J
MAX_P = 72   # csrc/physics_step.cuh MAX_P
MAX_J1 = 25  # csrc/physics_step.cuh MAX_J1 (MAX_J + 1)
# Lanes per env of K1, K3 and K3-rows (csrc/physics_step.cuh kGroup). The
# physics is bound by chains of dependent operations; G lanes step one env
# (a level's bodies, the joints and the contact points split over them)
# with its working set in shared memory, so that 3072 envs keep 3072 G
# lanes in flight. G = 8, four envs a warp, is the fastest of 4, 8, 16 and
# 32 at 3072 envs on the H100 (chip_smoke.py's group_sweep, PERF.md).
GROUP = 8
BUILT_GROUPS = (1, 4, 8, 16, 32)   # csrc/physics_step.cuh HM_GROUPS: G = 1 and the sweep beside GROUP


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
    """Pack a shared model into the bytes of csrc ModelConsts."""
    if not supported(model) or model.batched:
        raise NotImplementedError("model outside the CUDA kernel's surface")
    cfg = model.config
    J = model.num_bodies
    P = int(model.cp_body.shape[0])
    f32, i32 = np.float32, np.int32

    def host(t):
        return t.detach().cpu().numpy()

    I6 = host(model.spatial_inertia)
    order = [b for lvl, _ in model.levels for b in lvl]
    lev_start = np.cumsum([0] + [len(lvl) for lvl, _ in model.levels])
    # pass 2 adds a body's children in reverse level order
    pos = {b: k for k, b in enumerate(order)}
    children = [sorted((c for c in range(1, J) if model.parents[c] == b), key=lambda c: -pos[c]) for b in range(J)]
    cp_body = host(model.cp_body)
    points = [[i for i in range(P) if cp_body[i] == b] for b in range(J)]
    h = cfg.h
    parts = [
        np.asarray([J, P, cfg.steps_per_control, len(model.levels)], i32),
        _padded(order, (MAX_J,), i32),
        _padded(np.maximum(np.asarray(model.parents), 0), (MAX_J,), i32),
        _padded(lev_start, (MAX_J1,), i32),
        _padded(np.cumsum([0] + [len(c) for c in children]), (MAX_J1,), i32),
        _padded([c for ch in children for c in ch], (MAX_J,), i32),
        _padded(np.cumsum([0] + [len(p) for p in points]), (MAX_J1,), i32),
        _padded([i for p in points for i in p], (MAX_P,), i32),
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
        _padded(cp_body, (MAX_P,), i32),
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


def env_block(parts: list[torch.Tensor], B: int, n_rows: int) -> torch.Tensor:
    """[B, ...] tensors -> one contiguous env-major [B, n_rows] block."""
    x = torch.cat([t.reshape(B, -1) for t in parts], dim=1)
    if x.shape[1] != n_rows:
        raise ValueError(f"kernel input has {x.shape[1]} rows, expected {n_rows}")
    return x


def env_strided(t: torch.Tensor, n: int) -> tuple[torch.Tensor, int]:
    """A [B, ...] kernel input of n floats an env, as (tensor, env stride in
    floats) for a kernel that reads env e's block at data_ptr + e * stride:
    the tensor itself where each env's block is contiguous (a contiguous
    tensor, or a view into wider rows such as `physics_state_from_rows`'
    joint_rot), else a contiguous copy."""
    if math.prod(t.shape[1:]) != n:
        raise ValueError(f"kernel input {tuple(t.shape)}: expected {n} floats an env")
    expect = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expect:
            t = t.contiguous()
            break
        expect *= size
    return t, t.stride(0)


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


# --------------------------------------------------------------------------- #
# per-env model rows (K3-rows)
# --------------------------------------------------------------------------- #

def model_rows_layout(J: int, P: int) -> tuple[dict, int]:
    """{field: (first row, end row)} and the row count of the per-env model
    rows, in the TPU kernel's `_model_rows_layout` order. Per body, joint or
    contact point its values are consecutive (vec3 x, y, z); `Isym` holds
    the 6 unique entries (00, 01, 02, 11, 12, 22) of each body's A block."""
    Jm1 = J - 1
    rows, n = {}, 0
    for name, k in [("lt", 3 * J), ("mass", J), ("com", 3 * J), ("Isym", 6 * J), ("kp", Jm1), ("kd", Jm1),
                    ("armature", Jm1), ("dof_lower", 3 * Jm1), ("dof_upper", 3 * Jm1), ("cp_offset", 3 * P),
                    ("cp_radius", P), ("cp_friction", P)]:
        rows[name] = (n, n + k)
        n += k
    return rows, n


_ISYM_IDX = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def build_model_rows(model: Model, B: int) -> torch.Tensor:
    """[B, n_model] float32 per-env model rows of a batched model (a shared
    one is broadcast to B envs)."""
    J, P = model.num_bodies, int(model.cp_body.shape[0])

    def flat(x):
        x = model.env_axis(x).to(torch.float32)
        return x.expand(B, *x.shape[1:]).reshape(B, -1)

    A = model.spatial_inertia[..., :3, :3]
    Isym = torch.stack([A[..., i, k] for i, k in _ISYM_IDX], dim=-1)
    rows = torch.cat([flat(x) for x in (
        model.local_translation, model.body_mass, model.body_com, Isym, model.joint_kp, model.joint_kd,
        model.joint_armature, model.dof_lower, model.dof_upper, model.cp_offset, model.cp_radius,
        model.cp_friction)], dim=1)
    if rows.shape[1] != model_rows_layout(J, P)[1]:
        raise ValueError(f"model rows {rows.shape[1]}, layout {model_rows_layout(J, P)[1]}")
    return rows


def model_from_rows(base: Model, model_rows: torch.Tensor) -> Model:
    """The batched model that per-env model rows [B, n_model] describe, over
    the topology, config and PD maps of `base`. As the kernel does, each
    body's spatial inertia is rebuilt from its A block and, as
    `spatial.spatial_inertia` builds it, B = m [c]x and C = m 1."""
    B, J, P = model_rows.shape[0], base.num_bodies, int(base.cp_body.shape[0])
    lay, n = model_rows_layout(J, P)
    if model_rows.shape[1] != n:
        raise ValueError(f"model rows {model_rows.shape[1]}, layout {n}")

    def f(name, *shape):
        a, b = lay[name]
        return model_rows[:, a:b].reshape(B, *shape)

    mass, com, s = f("mass", J), f("com", J, 3), f("Isym", J, 6)
    A = torch.stack([s[..., [0, 1, 2]], s[..., [1, 3, 4]], s[..., [2, 4, 5]]], dim=-2)
    Bb = mass[..., None, None] * spatial.skew(com)
    C = mass[..., None, None] * torch.eye(3, dtype=mass.dtype, device=mass.device)
    I6 = torch.cat([torch.cat([A, Bb], -1), torch.cat([Bb.transpose(-1, -2), C], -1)], -2)
    return dataclasses.replace(
        base, local_translation=f("lt", J, 3), body_mass=mass, body_com=com, spatial_inertia=I6,
        total_mass=mass.sum(-1), joint_kp=f("kp", J - 1), joint_kd=f("kd", J - 1),
        joint_armature=f("armature", J - 1), dof_lower=f("dof_lower", 3 * (J - 1)),
        dof_upper=f("dof_upper", 3 * (J - 1)), pd_action_offset=base.pd_action_offset.expand(B, -1),
        pd_action_scale=base.pd_action_scale.expand(B, -1), cp_offset=f("cp_offset", P, 3),
        cp_radius=f("cp_radius", P), cp_friction=f("cp_friction", P),
    )


# --------------------------------------------------------------------------- #
# the wrapper
# --------------------------------------------------------------------------- #

def physics_step_cuda(model: Model, state: PhysicsState, pd_target: torch.Tensor,
                      model_rows: torch.Tensor | None = None) -> PhysicsState:
    """K3, or K3-rows with `model_rows`. One control period of [B] humanoids
    under stable-PD position control: the stepped state with refreshed world
    bodies and the substep-mean contact force, as `physics_step` computes
    it. `model` is shared; with `model_rows` ([B, n_model] from
    `build_model_rows`) each env steps under its own model, and `model`
    gives only the topology and the config. Contiguous rows are read in
    place."""
    if state.root_pos.device.type == "cpu":
        if model_rows is not None:
            model = model_from_rows(model, model_rows)
        return physics_step(model, state, pd_target)
    if not supported(model):
        raise NotImplementedError("model outside the CUDA kernel's surface")
    B, J = state.root_pos.shape[0], model.num_bodies
    parts = [state.root_pos, state.root_rot, state.joint_rot, state.root_vel6, state.joint_omega, pd_target]
    dev = check_kernel_inputs(parts + ([] if model_rows is None else [model_rows]), B)
    n_state = state_rows(J)
    lib = _build.load()
    with torch.cuda.device(dev):
        x = env_block(parts, B, n_state + 3 * (J - 1))
        out = torch.empty(B, n_state + 16 * J, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.upload_consts("physics_step", (model,), lambda: (model_const_table(model),), dev, stream)
        if model_rows is None:
            _build.check(lib.k3_physics_step(x.data_ptr(), out.data_ptr(), B, GROUP, stream), "K3 launch")
        else:
            n_model = model_rows_layout(J, int(model.cp_body.shape[0]))[1]
            if model_rows.shape != (B, n_model):
                raise ValueError(f"model rows {tuple(model_rows.shape)}, expected ({B}, {n_model})")
            m = model_rows.contiguous()
            _build.check(lib.k3_physics_step_rows(x.data_ptr(), m.data_ptr(), out.data_ptr(), B, GROUP, stream),
                         "K3-rows launch")
    _build.launches["physics_step_rows" if model_rows is not None else "physics_step"] += 1
    return physics_state_from_rows(out, J)
