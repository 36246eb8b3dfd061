"""The cycled reference and the power reward of the port's HumanoidImEnv
against the JAX package's on the CPU: `get_motion_state` with an offset,
`compute_power_penalty`, and one whole env step with `cycle_motion`,
`episode_length` and `power_reward` (the distillation env's options), the
port on its kernel path (the plain version of K1, then K2) against JAX's
per-env `step` (its XLA `_finish_step`, where these options run).

The step: B = 7 envs at 1 substep of 1/120 s, the same start states and
actions, the port's reset sampler fed the JAX side's draws. Each env's
physics is the reference at its (wrapped) time, shifted by its cycle
offset, so that it tracks the cycled reference:
  env 0 wraps its clip inside the step (cycle 0 -> 1),
  env 1 wraps again (cycle 1 -> 2),
  env 2 stays in its second cycle,
  env 3 reaches episode_length (a timeout reset),
  env 4 is mid clip in its first cycle,
  env 5 is 0.5 m off its reference (terminates),
  env 6 ends the step half a step before its second cycle's end, so that
  the observation's reference time (one step ahead) lies past the clip's
  end while the offset stays that of the state's own cycle.

Both packages read the same motion tables, the JAX store's arrays: their
own builds of the clips' angular velocities (finite differences of
rotations) differ by up to 4e-3 rad/s, which the observation would carry.

Tolerances: the offset reference 1e-6 absolute (the same lerp in both);
the penalty 1e-6 relative; the step's flags, clip ids and progress exactly,
obs, reward (with the penalty) and AMP history 1e-3, as in
tests/test_torch_env.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env import EnvConfig as JaxEnvConfig, HumanoidImEnv as JaxEnv
from pulse_tpu.env import kernels as jax_kernels
from pulse_tpu.env.humanoid_im import EnvState as JaxEnvState
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.motion_lib import get_motion_state as jax_get_motion_state
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics.state import PhysicsState as JaxPhysicsState

from jax_reference import module_reference_compiles, reference_jit

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env import kernels
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv, env_state_from_numpy
from pulse_tpu_torch.motion.motion_lib import MotionData, get_motion_state
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

B = 7
CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
EPISODE = 40
ENV_CFG = dict(cycle_motion=True, episode_length=EPISODE, power_reward=True)


@pytest.fixture(scope="module")
def spec():
    return load_smpl_humanoid()


@pytest.fixture(scope="module")
def motions():
    """(the port's store, the JAX store) of the same 4 synthetic clips, the
    port's holding the JAX store's arrays."""
    jspec = jax_load_smpl()
    jm = jax_build_motion_data(jspec.skeleton, jax_clips(jspec.skeleton, 4))
    fields = {f.name: torch.float32 for f in dataclasses.fields(MotionData)}
    fields.update(length_starts=torch.long, motion_num_frames=torch.long)
    return MotionData(**{k: torch.tensor(np.asarray(getattr(jm, k)), dtype=dt) for k, dt in fields.items()}), jm


def test_get_motion_state_offset_matches_jax(motions):
    port, ref = motions
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 4, 12)
    times = rng.uniform(0, 4.5, 12).astype(np.float32)
    offset = rng.uniform(-6, 6, (12, 3)).astype(np.float32)
    want = reference_jit(jax_get_motion_state)(ref, jnp.asarray(ids), jnp.asarray(times), offset=jnp.asarray(offset))
    got = get_motion_state(port, torch.as_tensor(ids), torch.as_tensor(times), torch.as_tensor(offset))
    bare = get_motion_state(port, torch.as_tensor(ids), torch.as_tensor(times))
    for k in ("rg_pos", "root_pos"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["rg_pos"].numpy(), (bare["rg_pos"] + torch.as_tensor(offset)[:, None]).numpy())
    for k in set(got) - {"rg_pos", "root_pos"}:     # the offset moves the positions only
        assert torch.equal(got[k], bare[k]), k


def test_compute_power_penalty_matches_jax():
    rng = np.random.default_rng(1)
    tau = rng.uniform(-800, 800, (9, 69)).astype(np.float32)
    vel = rng.uniform(-6, 6, (9, 69)).astype(np.float32)
    want = np.asarray(jax_kernels.compute_power_penalty(jnp.asarray(tau), jnp.asarray(vel), 0.0005))
    got = kernels.compute_power_penalty(torch.as_tensor(tau), torch.as_tensor(vel), 0.0005).numpy()
    assert (want < 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.fixture(scope="module")
def stepped(spec, motions):
    motion, jmotion = motions
    model = build_model(spec, PhysicsConfig(**CFG), device="cpu")
    env = HumanoidImEnv(model, motion, EnvConfig(**ENV_CFG), device="cpu")
    dt = model.config.control_dt
    ids = np.array([0, 1, 2, 3, 0, 1, 2])
    L = motion.motion_lengths[torch.as_tensor(ids)].numpy().astype(np.float64)
    # (unwrapped time before the step, progress) per env; start = raw - progress dt
    raw = np.array([L[0] - 0.5 * dt, 2 * L[1] - 0.4 * dt, L[2] + 3.5 * dt, 0.6, 1.0, 2.0, 2 * L[6] - 1.5 * dt])
    progress = np.array([2, 5, 5, EPISODE - 1, 3, 4, 3], np.int32)
    start = (raw - progress * dt).astype(np.float32)
    pre_ids, pre_start, pre_prog = torch.as_tensor(ids), torch.as_tensor(start), torch.as_tensor(progress)
    st = env.reset_to(pre_ids, env._motion_time(pre_ids, pre_start, pre_prog))
    offset = env._cycle_offset(pre_ids, pre_start, pre_prog).numpy()
    offset[5, 0] += 0.5                                   # env 5 off its reference
    d = {f.name: getattr(st, f.name).numpy() for f in dataclasses.fields(st)
         if f.name != "physics" and getattr(st, f.name) is not None}
    d.update(physics={f.name: getattr(st.physics, f.name).numpy().copy() for f in dataclasses.fields(st.physics)},
             progress=progress, start_time=start)
    d["physics"]["root_pos"] += offset
    d["physics"]["body_pos"] += offset[:, None]
    actions = np.random.default_rng(2).uniform(-1, 1, (B, 69)).astype(np.float32)

    jspec = jax_load_smpl()
    jenv = JaxEnv(jax_build_model(jspec, JaxPhysicsConfig(**CFG)), jmotion, JaxEnvConfig(**ENV_CFG))
    jstate = JaxEnvState(
        physics=JaxPhysicsState(**{k: jnp.asarray(v) for k, v in d["physics"].items()}),
        key=jax.random.split(jax.random.PRNGKey(1), B),
        **{k: jnp.asarray(v) for k, v in d.items() if k != "physics"},
    )
    want = reference_jit(jenv.step)(jstate, jnp.asarray(actions))

    env._sample_reset = lambda n: (torch.tensor(np.asarray(want.motion_id), dtype=torch.long),
                                   torch.tensor(np.asarray(want.start_time)))
    got = env.step(env_state_from_numpy(d), torch.as_tensor(actions))
    return env, got, want, offset


def test_step_wraps_and_ends_episodes_as_jax(stepped):
    env, got, want, offset = stepped
    assert env._fused_step_ok(), "the port's kernel path (K1) runs the cycled, power-rewarded step"
    assert (offset[[1, 2, 6], :2] != 0).all() and not offset[[0, 3, 4], :2].any()
    done, term = np.asarray(want.done), np.asarray(want.terminate)
    assert done.tolist() == [False, False, False, True, False, True, False]
    assert term.tolist() == [False] * 5 + [True, False]
    for f in ("done", "terminate", "motion_id", "progress"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.start_time.numpy(), np.asarray(want.start_time), atol=0)


@pytest.mark.parametrize("field", ["obs", "reward", "reward_raw", "amp_hist"])
def test_step_outputs_match_jax(stepped, field):
    _, got, want, _ = stepped
    np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), atol=1e-3)


def test_step_reward_carries_the_power_penalty(stepped):
    """The penalty is what separates the reward from the imitation terms'
    weighted sum, and it is below zero in every env."""
    env, got, _, _ = stepped
    c = env.config
    imitation = got.reward_raw @ torch.tensor([c.w_pos, c.w_rot, c.w_vel, c.w_ang_vel])
    assert (got.reward < imitation - 1e-3).all()
