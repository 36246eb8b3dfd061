"""The physics model as the CUDA kernels' constant table.

Counterpart of `pulse_tpu/physics/substep_pallas.py`'s `_extract_consts`
and `supported`: the TPU kernel baked the model into its trace as
constants; the CUDA kernels read it from `__constant__` memory, uploaded
once per model. The table's layout is `ModelConsts` in
`pulse_tpu_torch/csrc/physics_step.cuh`: 4-byte fields in declaration
order, no padding.
"""

from __future__ import annotations

import numpy as np

from pulse_tpu_torch.physics.model import Model

MAX_J = 24   # csrc/physics_step.cuh MAX_J
MAX_P = 72   # csrc/physics_step.cuh MAX_P


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
