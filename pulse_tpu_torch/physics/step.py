"""One control step = steps_per_control physics substeps, batched.

Counterpart of `physics_step` in `pulse_tpu/physics/step.py`; the plain
physics half of kernel K1 (`pulse_tpu_torch/env/cuda_obs.py`).
"""

from __future__ import annotations

import torch

from pulse_tpu_torch.physics.model import Model
from pulse_tpu_torch.physics.state import PhysicsState, refresh_kinematics
from pulse_tpu_torch.physics.substep_fused import fused_substep


def physics_step(model: Model, state: PhysicsState, pd_target_dof: torch.Tensor) -> PhysicsState:
    """Advance one control period under stable-PD position control. The
    reported contact force is the mean over the period's substeps."""
    cfg = model.config
    n = cfg.steps_per_control
    acc = torch.zeros_like(state.contact_force)
    for _ in range(n):
        state = fused_substep(model, state, pd_target_dof, cfg.h)
        acc = acc + state.contact_force
    state = refresh_kinematics(model, state)
    return state.replace(contact_force=acc / n)
