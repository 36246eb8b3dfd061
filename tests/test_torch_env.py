"""One whole env step of the port's HumanoidImEnv against the JAX package's
HumanoidImEnv.step on the CPU (its XLA path, golden-tested equal to the
fused TPU kernels): B = 16 envs at 1 substep of 1/120 s, the same start
state and actions, and the port's reset sampler fed the clip ids and start
times the JAX side drew for its auto-resets. Some envs are placed where
they terminate (progress far ahead of the physics) or run out of clip.

Tolerances: the stepped physics as in tests/test_torch_physics.py; reset
envs read slerped motion tables, where arccos near 1 leaves ~1e-4 of
rounding (tests/test_torch_ops.py), and the reward's exp(-100 mse) and the
heading-local obs carry that to ~5e-4, so obs/reward/AMP are held to 1e-3.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env import EnvConfig as JaxEnvConfig, HumanoidImEnv as JaxEnv
from pulse_tpu.env.humanoid_im import EnvState as JaxEnvState
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics.state import PhysicsState as JaxPhysicsState

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env.humanoid_im import HumanoidImEnv, env_state_from_numpy
from pulse_tpu_torch.motion.motion_lib import build_motion_data
from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model

B = 16
CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)


@pytest.fixture(scope="module")
def stepped():
    spec = load_smpl_humanoid()
    model = build_model(spec, PhysicsConfig(**CFG), device="cpu")
    motion = build_motion_data(spec.skeleton, make_synthetic_clips(spec.skeleton, 4), device="cpu")
    env = HumanoidImEnv(model, motion, device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 4, B)
    st = env.reset_to(torch.as_tensor(ids), torch.as_tensor(rng.uniform(0, 3.5, B).astype(np.float32)))
    # envs 0-3: 25 steps ahead of their physics -> far from the reference
    # envs 4-6: at the clip's end -> pass_time
    progress = np.zeros(B, np.int32)
    progress[:4] = 25
    start = st.start_time.numpy().copy()
    start[4:7] = motion.motion_lengths[ids[4:7]].numpy() - 1e-3
    d = {f.name: getattr(st, f.name).numpy() for f in dataclasses.fields(st)
         if f.name != "physics" and getattr(st, f.name) is not None}
    d.update(physics={f.name: getattr(st.physics, f.name).numpy() for f in dataclasses.fields(st.physics)},
             progress=progress, start_time=start)
    actions = rng.uniform(-1, 1, (B, 69)).astype(np.float32)

    jspec = jax_load_smpl()
    jenv = JaxEnv(jax_build_model(jspec, JaxPhysicsConfig(**CFG)),
                  jax_build_motion_data(jspec.skeleton, jax_clips(jspec.skeleton, 4)), JaxEnvConfig())
    jstate = JaxEnvState(
        physics=JaxPhysicsState(**{k: jnp.asarray(v) for k, v in d["physics"].items()}),
        key=jax.random.split(jax.random.PRNGKey(1), B),
        **{k: jnp.asarray(v) for k, v in d.items() if k != "physics"},   # recovery_counter zeros
    )
    want = jax.jit(jenv.step)(jstate, jnp.asarray(actions))

    # auto-resets draw the clips/times the JAX side drew for the same envs
    env._sample_reset = lambda n: (torch.tensor(np.asarray(want.motion_id), dtype=torch.long),
                                   torch.tensor(np.asarray(want.start_time)))
    got = env.step(env_state_from_numpy(d), torch.as_tensor(actions))
    return got, want


def test_step_flags_and_resets_match_jax(stepped):
    got, want = stepped
    done = np.asarray(want.done)
    assert done[4:7].all() and not done.all(), "both reset kinds and some survivors expected"
    assert np.asarray(want.terminate).any()
    for f in ("done", "terminate", "motion_id", "progress"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.start_time.numpy(), np.asarray(want.start_time), atol=0)


@pytest.mark.parametrize("field", ["obs", "reward", "reward_raw", "amp_hist"])
def test_step_outputs_match_jax(stepped, field):
    got, want = stepped
    np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), atol=1e-3)


@pytest.mark.parametrize("field,atol", [
    ("root_pos", 2e-4), ("root_rot", 2e-4), ("body_pos", 3e-4), ("body_rot", 2e-4),
    ("root_vel6", 5e-3), ("joint_omega", 5e-3), ("body_vel", 5e-3), ("body_ang_vel", 5e-3),
    ("contact_force", 1.0),
])
def test_step_physics_matches_jax(stepped, field, atol):
    got, want = stepped
    np.testing.assert_allclose(getattr(got.physics, field).numpy(), np.asarray(getattr(want.physics, field)),
                               atol=atol)
