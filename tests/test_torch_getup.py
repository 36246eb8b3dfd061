"""One step of the port's HumanoidImGetupEnv against the JAX package's
HumanoidImGetupEnv.step on the CPU (its XLA `_finish_step` path, which the
port's K3 → RA → termination → merge → K2 surface computes): B = 16 envs at
1 substep of 1/120 s, the same start state and actions.

Both envs get the same small fall-state table, made from a numpy seed, in
a test-side subclass. The port's samplers are fed the JAX side's draws:
clip and start time from its output, and fall choice, fall index and
recovery grace recomputed from its per-env keys. Envs 0-1 are 0.5 m off
their reference inside a grace window (terminations held back), envs 2-3
and 7-9 are as far with no grace (terminate), envs 4-6 and 10 are at their
clip's end (10 in grace: a timeout still resets).

Tolerances are those of tests/test_torch_env.py: flags, clip ids,
progress, grace counters and start times exactly; the stepped physics as
in tests/test_torch_physics.py; obs, reward and AMP 1e-3 (reset envs read
slerped motion tables, where arccos near 1 leaves ~1e-4 of rounding).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env.humanoid_im import EnvState as JaxEnvState
from pulse_tpu.env.humanoid_im_getup import GetupConfig as JaxGetupConfig, HumanoidImGetupEnv as JaxGetupEnv
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics.state import PhysicsState as JaxPhysicsState

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env.humanoid_im import env_state_from_numpy
from pulse_tpu_torch.env.humanoid_im_getup import GetupConfig, HumanoidImGetupEnv
from pulse_tpu_torch.motion.motion_lib import build_motion_data
from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model
from pulse_tpu_torch.physics.state import physics_state_from_numpy, state_from_kinematics

B = 16
N_FALL = 4
CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
GETUP = dict(num_fall_states=N_FALL, fall_init_prob=0.5, recovery_episode_prob=0.5, recovery_steps=90)
KEY_SEED = 3     # per-env keys whose resets draw both fall and reference-state inits


def _fall_table(model) -> dict:
    """N_FALL humanoids lying near the ground at rest, as numpy arrays."""
    rng = np.random.default_rng(5)
    rot = rng.standard_normal((N_FALL, 4)).astype(np.float32)
    dof = (0.3 * rng.standard_normal((N_FALL, model.num_dof))).astype(np.float32)
    pos = np.asarray([[0.2 * i, -0.1 * i, 0.25] for i in range(N_FALL)], np.float32)
    z3 = torch.zeros(N_FALL, 3)
    st = state_from_kinematics(model, torch.as_tensor(pos), torch.as_tensor(rot), torch.as_tensor(dof), z3, z3,
                               torch.zeros(N_FALL, model.num_dof))
    return {f.name: getattr(st, f.name).numpy() for f in dataclasses.fields(st)}


@pytest.fixture(scope="module")
def stepped():
    spec = load_smpl_humanoid()
    model = build_model(spec, PhysicsConfig(**CFG), device="cpu")
    motion = build_motion_data(spec.skeleton, make_synthetic_clips(spec.skeleton, 4), device="cpu")
    table = _fall_table(model)

    class PortEnv(HumanoidImGetupEnv):
        def _generate_fall_states(self):
            return physics_state_from_numpy(table)

    class JaxEnv(JaxGetupEnv):
        def _generate_fall_states(self, key):
            return JaxPhysicsState(**{k: jnp.asarray(v) for k, v in table.items()})

    env = PortEnv(model, motion, GetupConfig(**GETUP), device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 4, B)
    st = env.reset_to(torch.as_tensor(ids), torch.as_tensor(rng.uniform(0, 3.5, B).astype(np.float32)))
    far = np.isin(np.arange(B), [0, 1, 2, 3, 7, 8, 9])
    at_end = np.isin(np.arange(B), [4, 5, 6, 10])
    progress = np.where(far, 5, 0).astype(np.int32)
    counter = np.where(np.isin(np.arange(B), [0, 1, 10]), 90, 0).astype(np.int32)
    start = st.start_time.numpy().copy()
    start[at_end] = motion.motion_lengths[ids[at_end]].numpy() - 1e-3
    d = {f.name: getattr(st, f.name).numpy() for f in dataclasses.fields(st)
         if f.name != "physics" and getattr(st, f.name) is not None}
    d.update(physics={f.name: getattr(st.physics, f.name).numpy().copy() for f in dataclasses.fields(st.physics)},
             progress=progress, start_time=start, recovery_counter=counter)
    d["physics"]["root_pos"][far, 0] += 0.5                      # 0.5 m off their reference
    d["physics"]["body_pos"][far, :, 0] += 0.5
    actions = rng.uniform(-1, 1, (B, 69)).astype(np.float32)

    jspec = jax_load_smpl()
    jenv = JaxEnv(jax_build_model(jspec, JaxPhysicsConfig(**CFG)),
                  jax_build_motion_data(jspec.skeleton, jax_clips(jspec.skeleton, 4)), JaxGetupConfig(**GETUP))
    keys = jax.random.split(jax.random.PRNGKey(KEY_SEED), B)
    jstate = JaxEnvState(
        physics=JaxPhysicsState(**{k: jnp.asarray(v) for k, v in d["physics"].items()}),
        key=keys,
        **{k: jnp.asarray(v) for k, v in d.items() if k != "physics"},
    )
    want = jax.jit(jenv.step)(jstate, jnp.asarray(actions))

    def getup_draws(key):     # humanoid_im_getup.py reset_one, on _finish_step's reset key
        k_choice, k_recover, k_fall, _ = jax.random.split(jax.random.split(key)[0], 4)
        return (jax.random.uniform(k_choice) < GETUP["fall_init_prob"],
                jax.random.randint(k_fall, (), 0, N_FALL),
                jax.random.uniform(k_recover) < GETUP["recovery_episode_prob"])

    use_fall, idx, recover = (np.asarray(x) for x in jax.vmap(getup_draws)(keys))
    env._sample_reset = lambda n: (torch.tensor(np.asarray(want.motion_id), dtype=torch.long),
                                   torch.tensor(np.asarray(want.start_time)))
    env._sample_getup = lambda n: (torch.tensor(use_fall), torch.tensor(idx, dtype=torch.long),
                                   torch.tensor(recover))
    got = env.step(env_state_from_numpy(d), torch.as_tensor(actions))
    return env, got, want, use_fall


def test_step_runs_k3_ra_surface(stepped):
    env = stepped[0]
    assert not env._fused_step_ok()


def test_step_flags_grace_and_resets_match_jax(stepped):
    env, got, want, use_fall = stepped
    done, term = np.asarray(want.done), np.asarray(want.terminate)
    assert done[[2, 3, 4, 5, 6, 7, 8, 9, 10]].all() and not done[[0, 1]].any(), "resets and grace holds expected"
    assert term[[2, 3, 7, 8, 9]].all() and not term[[0, 1, 10]].any()
    assert (use_fall & done).any() and (~use_fall & done).any(), "both kinds of reset expected"
    assert int(env.grace_holds) == 2 and int(env.fall_resets) == int((use_fall & done).sum())
    for f in ("done", "terminate", "motion_id", "progress", "recovery_counter"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.start_time.numpy(), np.asarray(want.start_time), atol=0)


@pytest.mark.parametrize("field", ["obs", "reward", "reward_raw", "amp_hist"])
def test_step_outputs_match_jax(stepped, field):
    _, got, want, _ = stepped
    np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), atol=1e-3)


@pytest.mark.parametrize("field,atol", [
    ("root_pos", 2e-4), ("root_rot", 2e-4), ("body_pos", 3e-4), ("body_rot", 2e-4),
    ("root_vel6", 5e-3), ("joint_omega", 5e-3), ("body_vel", 5e-3), ("body_ang_vel", 5e-3),
    ("contact_force", 1.0),
])
def test_step_physics_matches_jax(stepped, field, atol):
    _, got, want, _ = stepped
    np.testing.assert_allclose(getattr(got.physics, field).numpy(), np.asarray(getattr(want.physics, field)),
                               atol=atol)
