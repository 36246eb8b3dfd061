"""The port's plain physics control step (K1's physics half) against the JAX
package's jax.vmap(physics_step) at SMPL size: B = 16 humanoids, 2 substeps
of 1/120 s, states from reference-state inits with some feet pushed into the
ground so that contacts are active, random PD targets from a numpy seed.

Tolerances are those tests/test_pallas_substep.py holds the TPU kernel to
against the XLA step: float-add order in the articulated-body passes and
the stiff compliant contacts amplify rounding in velocities and forces.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics.state import PhysicsState as JaxPhysicsState
from pulse_tpu.physics.step import physics_step as jax_physics_step

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env.humanoid_im import HumanoidImEnv
from pulse_tpu_torch.motion.motion_lib import build_motion_data
from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model
from pulse_tpu_torch.physics.state import physics_state_from_numpy
from pulse_tpu_torch.physics.step import physics_step

B = 16
CFG = dict(substeps=2, control_freq_inv=1)   # steps_per_control = 2


@pytest.fixture(scope="module")
def stepped():
    spec = load_smpl_humanoid()
    model = build_model(spec, PhysicsConfig(**CFG), device="cpu")
    motion = build_motion_data(spec.skeleton, make_synthetic_clips(spec.skeleton, 4), device="cpu")
    env = HumanoidImEnv(model, motion, device="cpu")
    rng = np.random.default_rng(0)
    st = env.reset_to(torch.as_tensor(rng.integers(0, 4, B)),
                      torch.as_tensor(rng.uniform(0, 3.5, B).astype(np.float32)))
    ph = {f.name: getattr(st.physics, f.name).numpy().copy() for f in dataclasses.fields(st.physics)}
    sink = np.where(np.arange(B) % 2 == 0, -0.03, 0.0).astype(np.float32)   # feet into the ground
    ph["root_pos"][:, 2] += sink
    ph["body_pos"][:, :, 2] += sink[:, None]
    pd = env.action_to_pd_target(torch.as_tensor(rng.uniform(-0.5, 0.5, (B, 69)).astype(np.float32))).numpy()

    got = physics_step(model, physics_state_from_numpy(ph), torch.as_tensor(pd))
    jm = jax_build_model(jax_load_smpl(), JaxPhysicsConfig(**CFG))
    want = jax.jit(jax.vmap(lambda s, p: jax_physics_step(jm, s, p)))(
        JaxPhysicsState(**{k: jnp.asarray(v) for k, v in ph.items()}), jnp.asarray(pd)
    )
    return got, want


def _np(got, want, field):
    return getattr(got, field).numpy(), np.asarray(getattr(want, field))


@pytest.mark.parametrize("field,atol", [("root_pos", 2e-4), ("root_rot", 2e-4), ("body_pos", 3e-4)])
def test_positions_match_jax(stepped, field, atol):
    np.testing.assert_allclose(*_np(*stepped, field), atol=atol)


def test_joint_rotations_match_jax(stepped):
    got, want = _np(*stepped, "joint_rot")
    assert np.abs(np.sum(got * want, axis=-1)).min() > 1 - 1e-5


@pytest.mark.parametrize("field", ["root_vel6", "joint_omega", "body_vel", "body_ang_vel"])
def test_velocities_match_jax(stepped, field):
    np.testing.assert_allclose(*_np(*stepped, field), atol=5e-3)


def test_contact_forces_match_jax(stepped):
    got, want = _np(*stepped, "contact_force")
    assert np.abs(want).max() > 100.0, "no contact was exercised"
    np.testing.assert_allclose(got, want, atol=1.0)
