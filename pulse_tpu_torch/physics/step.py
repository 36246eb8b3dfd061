"""One control step = steps_per_control physics substeps, batched.

Counterpart of `pulse_tpu/physics/step.py`:
  * `physics_step`: stable-PD position control (isaac_pd), the plain
    physics half of kernel K1 (`pulse_tpu_torch/env/cuda_obs.py`) and the
    oracle of K3;
  * `physics_step_torque`: the force control mode, raw torques held over
    the period with the MJCF damping as passive damping;
  * `physics_step_pd_explicit`: the pd control mode, explicit PD at a
    quarter of the gains, recomputed every substep, |tau| <= 1000;
  * `physics_step_with_prop`: isaac_pd coupled with a free prop
    (`physics/prop.py`), two-way contact every substep.
The last three run the general substep `_substep` (FK refresh, contacts,
torques, `aba_fast`, integration) in plain PyTorch, as the JAX package
runs them in XLA outside its kernels. Every step reports the substep-mean
contact force.
"""

from __future__ import annotations

import torch

from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics.aba_fast import aba_fast
from pulse_tpu_torch.physics.contact import plane_contact_forces
from pulse_tpu_torch.physics.dynamics import explicit_joint_torques, spd_joint_torques
from pulse_tpu_torch.physics.model import Model
from pulse_tpu_torch.physics.prop import prop_step
from pulse_tpu_torch.physics.state import PhysicsState, refresh_kinematics
from pulse_tpu_torch.physics.substep_fused import fused_substep, integrate


def _substep(model: Model, state: PhysicsState, pd_target_dof: torch.Tensor | None, h: float,
             f_ext_extra: torch.Tensor | None = None, tau_dof: torch.Tensor | None = None,
             passive_kd: torch.Tensor | None = None) -> PhysicsState:
    """One substep: world kinematics, plane contacts plus `f_ext_extra`
    ([B, J, 6] world spatial forces, counted in the contact force), stable
    PD toward `pd_target_dof` or, with `tau_dof`, raw torques with
    `passive_kd` damping, then `aba_fast` and semi-implicit Euler."""
    state = refresh_kinematics(model, state)
    f_ext, net_contact = plane_contact_forces(model, state.body_pos, state.body_rot, state.body_vel,
                                              state.body_ang_vel)
    if f_ext_extra is not None:
        f_ext = f_ext + f_ext_extra
        net_contact = net_contact + f_ext_extra[..., 3:6]
    if tau_dof is not None:
        tau, d_extra = explicit_joint_torques(model, state, tau_dof, h, passive_kd=passive_kd)
    else:
        tau, d_extra = spd_joint_torques(model, state, pd_target_dof, h)
    a0, qdd = aba_fast(model, state, tau, f_ext, state.body_rot, h, d_extra)
    return integrate(model, state, a0, qdd, h, net_contact)


def _control_period(model: Model, state: PhysicsState, substep) -> PhysicsState:
    """`substep(state)` steps_per_control times, then the world bodies
    refreshed and the contact force averaged over the substeps."""
    n = model.config.steps_per_control
    acc = torch.zeros_like(state.contact_force)
    for _ in range(n):
        state = substep(state)
        acc = acc + state.contact_force
    state = refresh_kinematics(model, state)
    return state.replace(contact_force=acc / n)


def physics_step(model: Model, state: PhysicsState, pd_target_dof: torch.Tensor) -> PhysicsState:
    """Advance one control period under stable-PD position control."""
    return _control_period(model, state, lambda s: fused_substep(model, s, pd_target_dof, model.config.h))


def physics_step_torque(model: Model, state: PhysicsState, tau_dof: torch.Tensor) -> PhysicsState:
    """Advance one control period under direct torques `tau_dof` [B, D],
    already scaled by motor effort and power scale, held over the period."""
    h = model.config.h
    return _control_period(model, state, lambda s: _substep(model, s, None, h, tau_dof=tau_dof,
                                                            passive_kd=model.joint_kd))


def physics_step_pd_explicit(model: Model, state: PhysicsState, pd_target_dof: torch.Tensor) -> PhysicsState:
    """Advance one control period under explicit PD: every substep
    tau = kp/4 (target - dof) - kd/4 dof_vel, clamped to |tau| <= 1000."""
    h, B, Jm1 = model.config.h, pd_target_dof.shape[0], model.num_joints
    target = pd_target_dof.reshape(B, Jm1, 3)
    kp = model.joint_kp[..., None] / 4.0
    kd = model.joint_kd[..., None] / 4.0

    def substep(s):
        tau = kp * (target - q.quat_to_exp_map(s.joint_rot)) - kd * s.joint_omega
        return _substep(model, s, None, h, tau_dof=torch.clamp(tau, -1000.0, 1000.0))

    return _control_period(model, state, substep)


def physics_step_with_prop(model: Model, prop_spec, state: PhysicsState, prop, pd_target_dof: torch.Tensor):
    """One control period of [B] humanoids under stable PD, each coupled
    with its free prop: every substep refreshes the humanoid's kinematics,
    steps the prop against them (`prop.prop_step`) and the humanoid with
    the reaction forces. Returns (state, prop, the prop's substep-mean
    contact force [B, 3])."""
    h, n = model.config.h, model.config.steps_per_control
    acc = torch.zeros_like(state.contact_force)
    prop_acc = torch.zeros_like(prop.pos)
    for _ in range(n):
        state = refresh_kinematics(model, state)
        prop, f_ext_h, prop_contact = prop_step(model, prop_spec, prop, state.body_pos, state.body_rot,
                                                state.body_vel, state.body_ang_vel, h)
        state = _substep(model, state, pd_target_dof, h, f_ext_extra=f_ext_h)
        acc = acc + state.contact_force
        prop_acc = prop_acc + prop_contact
    state = refresh_kinematics(model, state)
    return state.replace(contact_force=acc / n), prop, prop_acc / n
