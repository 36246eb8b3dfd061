"""The shape-varied imitation env (PHC's has_shape_variation, `env=im_shape`)
in the port against the JAX package on the CPU.

One whole env step of 16 envs at 1 substep of 1/120 s with the shape, shape
disc and limb-weight channels on, against jax.jit(env.step) (its per-env XLA
path, which the TPU kernel with model rows is golden-tested against): the
JAX env's batched model and shape table carried across, the same start
state and actions, and the port's reset sampler fed the clip ids and start
times the JAX side drew. Some envs are placed where they terminate or run
out of clip, so that fresh states are FK'd through their own models.
Tolerances as in tests/test_torch_env.py; the shape columns exactly.

Also: the AMP builders' shape tails, the shape channels before shapes are
enabled, resample_shapes with the rows cache, and the CLI's in-process
`env=im_shape` training on the CPU.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env import EnvConfig as JaxEnvConfig, HumanoidImEnv as JaxEnv, kernels as jk
from pulse_tpu.env.humanoid_im import EnvState as JaxEnvState
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics.state import PhysicsState as JaxPhysicsState

from pulse_tpu_torch import _build, run
from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env import kernels
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv, env_state_from_numpy
from pulse_tpu_torch.motion.motion_lib import build_motion_data
from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
from pulse_tpu_torch.physics import substep_cuda
from pulse_tpu_torch.physics.model import BATCHED_LEAVES, PhysicsConfig, build_model

B = 16
CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
SHAPE = dict(has_shape_obs=True, has_shape_obs_disc=True, has_limb_weight_obs=True)
SELF_OBS = 358                 # the shape columns follow the self obs
AMP = 232                      # and the AMP row's motion channels
TINY = ["device=cpu", "num_envs=8", "learning.horizon_length=4", "learning.minibatch_size=16",
        "learning.mini_epochs=2", "learning.actor_units=[32,24]", "learning.critic_units=[32,24]", "log_frequency=1"]


def _port_env(**cfg):
    spec = load_smpl_humanoid()
    model = build_model(spec, PhysicsConfig(**CFG), device="cpu")
    motion = build_motion_data(spec.skeleton, make_synthetic_clips(spec.skeleton, 4), device="cpu")
    return HumanoidImEnv(model, motion, EnvConfig(**cfg), device="cpu")


@pytest.fixture(scope="module")
def stepped():
    jspec = jax_load_smpl()
    jenv = JaxEnv(jax_build_model(jspec, JaxPhysicsConfig(**CFG)),
                  jax_build_motion_data(jspec.skeleton, jax_clips(jspec.skeleton, 4)), JaxEnvConfig(**SHAPE))
    jenv.enable_shape_variation(jax.random.PRNGKey(3), B)
    table = np.asarray(jenv._shape_obs_table)

    env = _port_env(**SHAPE)
    env.set_shapes_from_numpy({k: np.asarray(getattr(jenv.batched_model, k)) for k in BATCHED_LEAVES + ("cp_body",)},
                              table)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 4, B)
    st = env.reset_to(torch.as_tensor(ids), torch.as_tensor(rng.uniform(0, 3.5, B).astype(np.float32)))
    # envs 0-3: 25 steps ahead of their physics -> far from the reference
    # envs 4-6: at the clip's end -> pass_time
    progress = np.zeros(B, np.int32)
    progress[:4] = 25
    start = st.start_time.numpy().copy()
    start[4:7] = env.motion.motion_lengths[ids[4:7]].numpy() - 1e-3
    d = {f.name: getattr(st, f.name).numpy() for f in dataclasses.fields(st)
         if f.name != "physics" and getattr(st, f.name) is not None}
    d.update(physics={f.name: getattr(st.physics, f.name).numpy() for f in dataclasses.fields(st.physics)},
             progress=progress, start_time=start)
    actions = rng.uniform(-1, 1, (B, 69)).astype(np.float32)

    jstate = JaxEnvState(
        physics=JaxPhysicsState(**{k: jnp.asarray(v) for k, v in d["physics"].items()}),
        key=jax.random.split(jax.random.PRNGKey(1), B),
        shape_obs=jnp.asarray(table),
        **{k: jnp.asarray(v) for k, v in d.items() if k != "physics"},
    )
    want = jax.jit(jenv.step)(jstate, jnp.asarray(actions))

    env._sample_reset = lambda n: (torch.tensor(np.asarray(want.motion_id), dtype=torch.long),
                                   torch.tensor(np.asarray(want.start_time)))
    got = env.step(env_state_from_numpy(d), torch.as_tensor(actions))
    return env, got, want, table


def test_shape_step_flags_and_resets_match_jax(stepped):
    env, got, want, _ = stepped
    done = np.asarray(want.done)
    assert done[4:7].all() and not done.all(), "both reset kinds and some survivors expected"
    assert np.asarray(want.terminate).any()
    assert env.obs_dim == 955 and env.amp_obs_dim_single == 253 and not env._fused_step_ok()
    for f in ("done", "terminate", "motion_id", "progress"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


def test_shape_columns_match_jax_exactly(stepped):
    _, got, want, table = stepped
    np.testing.assert_array_equal(got.obs[:, SELF_OBS:SELF_OBS + 21].numpy(), table)
    np.testing.assert_array_equal(got.obs[:, SELF_OBS:SELF_OBS + 21].numpy(),
                                  np.asarray(want.obs)[:, SELF_OBS:SELF_OBS + 21])
    np.testing.assert_array_equal(got.amp_hist[..., AMP:].numpy(), np.asarray(want.amp_hist)[..., AMP:])
    np.testing.assert_array_equal(got.amp_hist[:, 0, AMP:].numpy(), table)


@pytest.mark.parametrize("field", ["obs", "reward", "reward_raw", "amp_hist"])
def test_shape_step_outputs_match_jax(stepped, field):
    _, got, want, _ = stepped
    np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), atol=1e-3)


@pytest.mark.parametrize("field,atol", [
    ("root_pos", 2e-4), ("root_rot", 2e-4), ("body_pos", 3e-4), ("body_rot", 2e-4),
    ("root_vel6", 5e-3), ("joint_omega", 5e-3), ("body_vel", 5e-3), ("body_ang_vel", 5e-3),
    ("contact_force", 1.0),
])
def test_shape_step_physics_matches_jax(stepped, field, atol):
    _, got, want, _ = stepped
    np.testing.assert_allclose(getattr(got.physics, field).numpy(), np.asarray(getattr(want.physics, field)),
                               atol=atol)


@pytest.mark.parametrize("amp_v", [1, 2])
def test_amp_builders_shape_tails_match_jax(amp_v):
    rng = np.random.default_rng(amp_v)
    q = rng.standard_normal((B, 4)).astype(np.float32)
    args = [rng.standard_normal((B, 3)).astype(np.float32), q / np.linalg.norm(q, axis=-1, keepdims=True),
            rng.standard_normal((B, 3)).astype(np.float32), rng.standard_normal((B, 3)).astype(np.float32),
            rng.uniform(-1, 1, (B, 69)).astype(np.float32), rng.standard_normal((B, 69)).astype(np.float32),
            rng.standard_normal((B, 4, 3)).astype(np.float32)]
    if amp_v == 2:
        args.append(rng.standard_normal((B, 4, 3)).astype(np.float32))
    tails = dict(shape_params=rng.standard_normal((B, 11)).astype(np.float32),
                 limb_weight_params=rng.uniform(0, 40, (B, 10)).astype(np.float32))
    name = "build_amp_observations_smpl_v2" if amp_v == 2 else "build_amp_observations_smpl"
    got = getattr(kernels, name)(*map(torch.as_tensor, args), **{k: torch.as_tensor(v) for k, v in tails.items()})
    want = getattr(jk, name)(*map(jnp.asarray, args), **{k: jnp.asarray(v) for k, v in tails.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_shape_channels_before_shapes_are_zero_and_resample_swaps_the_rows():
    env = _port_env(**SHAPE)
    st = env.reset(8)
    assert st.obs.shape == (8, 955) and not env._fused_step_ok()
    assert float(st.obs[:, SELF_OBS:SELF_OBS + 21].abs().max()) == 0.0
    st = env.step(st, torch.zeros(8, 69))
    assert float(st.amp_hist[..., AMP:].abs().max()) == 0.0

    env.enable_shape_variation(8, generator=torch.Generator().manual_seed(5))
    bm0, rows0 = env.batched_model, env._model_rows(8)
    assert env._model_rows(8) is rows0
    assert rows0.is_contiguous()          # the kernel's env-major [B, n_model] layout
    env.resample_shapes()
    assert env.batched_model is not bm0
    rows1 = env._model_rows(8)
    np.testing.assert_array_equal(rows1.numpy(), substep_cuda.build_model_rows(env.batched_model, 8).numpy())
    assert not torch.equal(rows0, rows1)
    s = env.batched_model.total_mass / env.model.total_mass      # s^3 in [0.9^3, 1.1^3]
    assert float(s.min()) >= 0.9 ** 3 - 1e-5 and float(s.max()) <= 1.1 ** 3 + 1e-5
    st = env.reset(8)
    np.testing.assert_array_equal(st.obs[:, SELF_OBS:SELF_OBS + 21].numpy(), env._shape_obs_table.numpy())


def test_main_trains_env_im_shape_in_process(tmp_path):
    before = dict(_build.launches)
    res = run.main(["env=im_shape", "max_epochs=2", f"output_dir={tmp_path}", *TINY])
    assert _build.launches == before   # the CPU runs the plain versions: no kernel launched
    env, ts = res.agent.env, res.train_state
    assert len(res.metrics) == 2 and ts.epoch == 2
    assert env.batched_model is not None and env.batched_model.batched and env.obs_dim == 955
    assert ts.obs_rms.mean.shape == (955,)
    np.testing.assert_array_equal(ts.env_state.obs[:, SELF_OBS:SELF_OBS + 21].numpy(), env._shape_obs_table.numpy())
    assert float(ts.obs_rms.count) == pytest.approx(2 * 8 * 4, abs=1e-3)
    for m in res.metrics:
        assert all(np.isfinite(m[k]) for k in ("a_loss", "c_loss", "b_loss"))
