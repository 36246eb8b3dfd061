"""The port's latent-action wrapper (env/humanoid_z.py) against the JAX
package's on the CPU.

`ZActionWrapper.decode_z` on the same frozen PulseVAE (narrow widths: a
64-unit encoder, a 32-unit prior, a 64-unit decoder, a 32-unit critic,
latent 32, self obs 358 of a 934-wide distill obs; the port's weights
loaded from the flax tree by `frozen_z_model_from_jax`) and the same
frozen running stats, with the prior's shift on and off: 1e-5 (float32
GEMMs in both; measured 1.7e-6). One wrapped step of the speed env from
the same upright states (no env resets or switches its task) against the
JAX package's jitted wrapped step (the one SMPL-size jit of this file):
the reward 1e-5, the observation and AMP history 1e-4, the physics as in
tests/test_torch_physics.py. Then the port alone: the decode is float32
under a bf16 autocast and equal to it without; the PulseVAE is frozen; a
wrapped HumanoidImEnv reaches `reset_to` through the wrapper; `with_config`
re-wraps; widths that do not fit raise.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env.humanoid_task import (
    HumanoidSpeedEnv as JaxSpeedEnv, TaskConfig as JaxTaskConfig, TaskEnvState as JaxTaskEnvState,
)
from pulse_tpu.env.humanoid_z import FrozenZModel as JaxFrozenZModel, ZActionWrapper as JaxZActionWrapper
from pulse_tpu.learning.networks import PulseVAE as JaxPulseVAE
from pulse_tpu.learning.running_norm import RunningMeanStd as JaxRunningMeanStd
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics.state import PhysicsState as JaxPhysicsState

from jax_reference import module_reference_compiles, reference_jit
from torch_close import assert_close

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv
from pulse_tpu_torch.env.humanoid_task import HumanoidSpeedEnv, TaskConfig, task_env_state_from_numpy
from pulse_tpu_torch.env.humanoid_z import FrozenZModel, ZActionWrapper, frozen_z_model_from_jax
from pulse_tpu_torch.learning.networks import PulseVAE
from pulse_tpu_torch.learning.running_norm import RunningMeanStd
from pulse_tpu_torch.motion.motion_lib import MotionData
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

B = 6
CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
DISTILL_OBS = 934
WIDTHS = dict(encoder_units=(64,), prior_units=(32,), decoder_units=(64,), critic_units=(32,))


@pytest.fixture(scope="module")
def frozen():
    """(JAX PulseVAE, params, rms) and the port's FrozenZModel of them."""
    net = JaxPulseVAE(action_dim=69, latent_dim=32, self_obs_dim=358, **WIDTHS)
    params = net.init(jax.random.PRNGKey(2), jnp.zeros((1, DISTILL_OBS)), jnp.zeros((1, 32)))["params"]
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(1)
    rms = {"mean": rng.normal(0, 0.3, DISTILL_OBS).astype(np.float32),
           "var": rng.uniform(0.5, 2.0, DISTILL_OBS).astype(np.float32), "count": np.float32(100.0)}
    return net, params, rms


def _jax_frozen(params, rms, prior=True):
    return JaxFrozenZModel(params=params, obs_rms=JaxRunningMeanStd(**{k: jnp.asarray(v) for k, v in rms.items()}),
                           use_vae_prior=prior)


@pytest.fixture(scope="module")
def setup():
    jspec = jax_load_smpl()
    jm = jax_build_motion_data(jspec.skeleton, jax_clips(jspec.skeleton, 4))
    fields = {f.name: torch.float32 for f in dataclasses.fields(MotionData)}
    fields.update(length_starts=torch.long, motion_num_frames=torch.long)
    motion = MotionData(**{k: torch.tensor(np.asarray(getattr(jm, k)), dtype=dt) for k, dt in fields.items()})
    model = build_model(load_smpl_humanoid(), PhysicsConfig(**CFG), device="cpu")
    return model, motion, jax_build_model(jspec, JaxPhysicsConfig(**CFG)), jm


@pytest.mark.parametrize("prior", [True, False])
def test_decode_z_matches_jax(frozen, prior):
    net, params, rms = frozen
    stub = SimpleNamespace(obs_dim=361, amp_obs_dim=2320, self_obs_dim=358, motion=None, model=None, config=None,
                           key_body_ids=None)
    jw = JaxZActionWrapper(stub, net, _jax_frozen(params, rms, prior))
    rng = np.random.default_rng(3)
    self_obs = (2.0 * rng.standard_normal((16, 358))).astype(np.float32)   # some beyond the +-5 clip
    z = rng.uniform(-1, 1, (16, 32)).astype(np.float32)
    want = np.asarray(jw.decode_z(jnp.asarray(self_obs), jnp.asarray(z)))
    env = SimpleNamespace(self_obs_dim=358, action_dim=69)
    w = ZActionWrapper(env, frozen_z_model_from_jax(params, rms, use_vae_prior=prior, device="cpu"))
    got = w.decode_z(torch.as_tensor(self_obs), torch.as_tensor(z))
    assert got.dtype == torch.float32 and got.shape == (16, 69)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the prior's shift matters: with and without it the actions differ
    other = ZActionWrapper(env, frozen_z_model_from_jax(params, rms, use_vae_prior=not prior, device="cpu"))
    assert (other.decode_z(torch.as_tensor(self_obs), torch.as_tensor(z)) - got).abs().max() > 1e-3


def test_wrapped_step_matches_jax(frozen, setup):
    net, params, rms = frozen
    model, motion, jmodel, jmotion = setup
    env = HumanoidSpeedEnv(model, motion, TaskConfig(episode_length=20), device="cpu", seed=4)
    w = ZActionWrapper(env, frozen_z_model_from_jax(params, rms, device="cpu"))
    assert w.action_dim == 32 and w.obs_dim == 361 and w.amp_obs_dim == 2320
    st = w.reset(B)
    d = {"physics": {f.name: getattr(st.physics, f.name).numpy() for f in dataclasses.fields(st.physics)},
         "progress": np.full(B, 3, np.int32),
         "task": {"tar_speed": st.task["tar_speed"].numpy(), "change_step": np.full(B, 150, np.int32)},
         **{k: getattr(st, k).numpy() for k in ("obs", "reward", "reward_raw", "done", "terminate", "amp_hist")}}
    z = np.random.default_rng(5).uniform(-1, 1, (B, 32)).astype(np.float32)
    jenv = JaxSpeedEnv(jmodel, jmotion, JaxTaskConfig(episode_length=20))
    jw = JaxZActionWrapper(jenv, net, _jax_frozen(params, rms))
    jstate = JaxTaskEnvState(
        physics=JaxPhysicsState(**{k: jnp.asarray(v) for k, v in d["physics"].items()}),
        key=jax.random.split(jax.random.PRNGKey(0), B),
        task={**{k: jnp.asarray(v) for k, v in d["task"].items()}, "key": jax.random.split(jax.random.PRNGKey(1), B)},
        **{k: jnp.asarray(v) for k, v in d.items() if k not in ("physics", "task")})
    want = reference_jit(jw.step)(jstate, jnp.asarray(z))
    got = w.step(task_env_state_from_numpy(d), torch.as_tensor(z))
    assert not np.asarray(want.done).any() and not got.done.any()
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(want.reward), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.amp_hist.numpy(), np.asarray(want.amp_hist), rtol=0, atol=1e-4)
    for field, atol in (("root_pos", 2e-4), ("body_pos", 3e-4), ("body_rot", 2e-4), ("body_vel", 5e-3)):
        np.testing.assert_allclose(getattr(got.physics, field).numpy(), np.asarray(getattr(want.physics, field)),
                                   rtol=0, atol=atol, err_msg=field)
    # the wrapped step is the env's step on the clipped decode
    motor = torch.clamp(w.decode_z(task_env_state_from_numpy(d).obs[:, :358], torch.as_tensor(z)), -1.0, 1.0)
    env.generator.manual_seed(0)
    plain = env.step(task_env_state_from_numpy(d), motor)
    assert_close(plain.obs, got.obs, rtol=0, atol=0)


def test_decode_is_float32_and_frozen(frozen):
    _, params, rms = frozen
    fz = frozen_z_model_from_jax(params, rms, device="cpu")
    assert not any(p.requires_grad for p in fz.network.parameters()) and fz.obs_rms.frozen
    w = ZActionWrapper(SimpleNamespace(self_obs_dim=358, action_dim=69), fz)
    obs, z = torch.randn(8, 358), torch.rand(8, 32)
    plain = w.decode_z(obs, z)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        auto = w.decode_z(obs, z)
    assert auto.dtype == torch.float32
    assert_close(auto, plain, rtol=0, atol=0)
    # the self obs is normalized with the first 358 entries of the distill stats
    assert_close(w._self_rms.mean, fz.obs_rms.mean[:358], rtol=0, atol=0)


def test_wrapped_imitation_env_reaches_reset_to_and_rewraps(setup):
    model, motion = setup[:2]
    env = HumanoidImEnv(model, motion, EnvConfig(), device="cpu")
    net = PulseVAE(env.obs_dim, 69, self_obs_dim=358, device="cpu", seed=0, **WIDTHS)
    w = ZActionWrapper(env, FrozenZModel(net, RunningMeanStd.create(env.obs_dim)))
    assert hasattr(w, "reset_to") and w.reset_body_ids is env.reset_body_ids
    st = w.reset_to(torch.arange(3) % 4, torch.zeros(3))
    assert st.obs.shape == (3, 934)
    nxt = w.step(st, torch.zeros(3, 32))
    assert nxt.obs.shape == (3, 934) and torch.isfinite(nxt.obs).all()
    off = w.with_config(dataclasses.replace(env.config, enable_early_termination=False))
    assert isinstance(off, ZActionWrapper) and off.frozen is w.frozen and off.env is not env
    assert not off.config.enable_early_termination and env.config.enable_early_termination
    with pytest.raises(AttributeError):
        w._no_such_private
    task = HumanoidSpeedEnv(model, motion, device="cpu")
    assert not hasattr(ZActionWrapper(task, FrozenZModel(net, RunningMeanStd.create(934))), "reset_to")


def test_widths_that_do_not_fit_raise(setup):
    model, motion = setup[:2]
    env = HumanoidSpeedEnv(model, motion, device="cpu")
    net = PulseVAE(934, 69, self_obs_dim=300, device="cpu", **WIDTHS)
    with pytest.raises(ValueError, match="does not fit"):
        ZActionWrapper(env, FrozenZModel(net, RunningMeanStd.create(934)))
