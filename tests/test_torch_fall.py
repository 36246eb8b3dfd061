"""The port's `state_from_kinematics` and two ragdoll physics steps (the getup
env's fall-state settle: joint_kp 0, joint_kd 5, zero PD target) against
the JAX package, on the CPU: B = 8 humanoids from a numpy seed, half of
them upright, half in random orientations, all
placed with their lowest contact point 5 mm in the ground; 2 substeps of
1/120 s per control step. Also: the port's fall-state
generator zeroes the velocities and refreshes the world bodies after its
drop. (Like the JAX package's, the drop does not bring every body to rest
on the ground at the default settings: ROADMAP queue 3.)

Tolerances: `state_from_kinematics` is FK of the same formulas, float32
rounding only: 1e-5. After two ragdoll steps, those the TPU kernel is held
to against the XLA step (tests/test_pallas_substep.py, as in
tests/test_torch_physics.py): the stiff compliant contacts amplify rounding
in velocities and forces.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics.state import state_from_kinematics as jax_state_from_kinematics
from pulse_tpu.physics.step import physics_step as jax_physics_step

from jax_reference import module_reference_compiles, reference_jit

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env.humanoid_im_getup import GetupConfig, HumanoidImGetupEnv, ragdoll
from pulse_tpu_torch.motion.motion_lib import build_motion_data
from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
from pulse_tpu_torch.ops import quat as tq
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model
from pulse_tpu_torch.physics.state import state_from_kinematics
from pulse_tpu_torch.physics.substep_cuda import physics_step_cuda

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

B = 8
STEPS = 2
CFG = dict(substeps=2, control_freq_inv=1)


def _inputs(model):
    """Half upright, half randomly oriented poses, each placed so that its
    lowest contact point is 5 mm in the ground (mild, active contacts)."""
    rng = np.random.default_rng(0)
    D = model.num_dof
    lo, hi = model.dof_lower.numpy(), model.dof_upper.numpy()
    upright = np.arange(B) < B // 2
    rot = rng.standard_normal((B, 4)).astype(np.float32)
    rot[upright] = [0.0, 0.0, 0.0, 1.0]
    rot[upright, :3] += 0.05 * rng.standard_normal((B // 2, 3))
    # strictly inside the joint limits: a dof on its limit switches the
    # limit spring on or off on float noise, a knife edge like contact
    dof = np.clip(np.where(upright[:, None], 0.1, 0.4) * rng.standard_normal((B, D)), 0.9 * lo, 0.9 * hi)
    dof = dof.astype(np.float32)
    root_pos = np.zeros((B, 3), np.float32)
    root_pos[:, :2] = rng.uniform(-1, 1, (B, 2))
    root_pos[:, 2] = 1.0
    vel = (0.1 * rng.standard_normal((B, 3))).astype(np.float32)
    ang = (0.1 * rng.standard_normal((B, 3))).astype(np.float32)
    dof_vel = (0.1 * rng.standard_normal((B, D))).astype(np.float32)
    st = state_from_kinematics(model, *map(torch.as_tensor, (root_pos, rot, dof, vel, ang, dof_vel)))
    cp = st.body_pos[:, model.cp_body] + tq.quat_rotate(st.body_rot[:, model.cp_body], model.cp_offset)
    lowest = (cp[..., 2] - model.cp_radius).amin(dim=1).numpy()
    root_pos[:, 2] += -0.005 - lowest
    return root_pos, rot, dof, vel, ang, dof_vel


@pytest.fixture(scope="module")
def fall():
    spec = load_smpl_humanoid()
    model = build_model(spec, PhysicsConfig(**CFG), device="cpu")
    rag = ragdoll(model)
    args = _inputs(model)
    init = state_from_kinematics(model, *map(torch.as_tensor, args))
    st, pd = init, torch.zeros(B, model.num_dof)
    for _ in range(STEPS):
        st = physics_step_cuda(rag, st, pd)

    jm = jax_build_model(jax_load_smpl(), JaxPhysicsConfig(**CFG))
    jrag = jm.replace(joint_kp=jnp.zeros_like(jm.joint_kp), joint_kd=jnp.full_like(jm.joint_kd, 5.0))

    @reference_jit
    def jax_side(*a):
        s0 = jax.vmap(lambda *x: jax_state_from_kinematics(jm, *x))(*a)
        step = jax.vmap(lambda s: jax_physics_step(jrag, s, jnp.zeros(jrag.num_dof)))
        return s0, jax.lax.fori_loop(0, STEPS, lambda _, s: step(s), s0)

    jinit, jst = jax_side(*map(jnp.asarray, args))
    return (init, jinit), (st, jst)


FIELDS = ("root_pos", "root_rot", "joint_rot", "root_vel6", "joint_omega", "body_pos", "body_rot", "body_vel",
          "body_ang_vel", "contact_force")


@pytest.mark.parametrize("field", FIELDS)
def test_state_from_kinematics_matches_jax(fall, field):
    got, want = fall[0]
    np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), atol=1e-5)


@pytest.mark.parametrize("field,atol", [
    ("root_pos", 2e-4), ("root_rot", 2e-4), ("joint_rot", 2e-4), ("body_pos", 3e-4), ("body_rot", 2e-4),
    ("root_vel6", 5e-3), ("joint_omega", 5e-3), ("body_vel", 5e-3), ("body_ang_vel", 5e-3), ("contact_force", 1.0),
])
def test_ragdoll_steps_match_jax(fall, field, atol):
    got, want = fall[1]
    if field == "contact_force":
        assert np.abs(np.asarray(want.contact_force)).max() > 100.0, "no contact was exercised"
    np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), atol=atol)


def test_fall_states_have_zeroed_velocities_and_refreshed_kinematics():
    spec = load_smpl_humanoid()
    model = build_model(spec, device="cpu")
    motion = build_motion_data(spec.skeleton, make_synthetic_clips(spec.skeleton, 1), device="cpu")
    env = HumanoidImGetupEnv(model, motion, GetupConfig(num_fall_states=4, fall_settle_steps=3), device="cpu")
    fs = env.fall_states
    assert fs.root_pos.shape == (4, 3)
    assert torch.all(fs.root_vel6 == 0) and torch.all(fs.joint_omega == 0)
    # at rest: the world body velocities are recomputed from the zeroed state
    assert torch.all(fs.body_vel == 0) and torch.all(fs.body_ang_vel == 0)
    assert torch.all(fs.root_pos[:, 2] < 1.0) and torch.all(torch.isfinite(fs.body_pos))
