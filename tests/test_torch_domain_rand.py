"""The port's domain randomization (`env/domain_rand.py` and the env's DR
hooks) against the JAX package's on the CPU, the JAX draws fed to the port.

(a) `apply_noise` for every spec (gaussian / uniform x additive / scaling x
    no, linear and constant schedules) on [5, 7] tensors at per-row steps
    before, inside and past the schedule, with the JAX side's standard
    draws (normal or uniform from each row's key) passed in: 1e-6.
(b) `dr_config_from_dict` on the env YAML's block and partial blocks, the
    specs' validation, and `randomize_model_props` / `scale_model_props`
    against the JAX package's on the shared and on a scale-varied model,
    the multipliers recomputed from the JAX key: every leaf 1e-6
    relative.
(c) One step of B = 4 envs under DR at 1 substep of 1/120 s (gaussian
    additive obs noise on a linear schedule, uniform scaling action noise
    on a constant one, refresh every 3 steps; friction, mass and gain
    multipliers), envs at DR steps 0, 1, 3 and 4 (so envs 0 and 2 refresh
    their held draws), the JAX env's batched model carried across and the
    JAX step's draws (action noise, refreshed correlated draws, obs noise)
    fed to the port. The JAX step runs in one jit. Tolerances: the held
    draws and DR steps exactly; the physics as chip_smoke.py's K1_TOL; obs
    3e-4 and reward 3.5e-4, about twice their measured maxima of 1.53e-4
    and 1.68e-4, as they read the stepped velocities, whose float
    rounding reaches 1e-4 here (a body's angular velocity in env 1; its
    positions agree to 3e-7), while the noise is 4e-3 to 2e-2 wide in
    envs 1-3 (none in env 0, at schedule step 0).
(d) Port-only: on the kernels' surface the step (plain K3-rows -> RA -> K2
    on the CPU, then the noise) equals the general step with the same
    draws: obs 1e-4, reward and AMP history 1e-5, DR fields exactly; K1
    never runs under DR; `randomize_physical_props` re-draws from the
    pre-DR model (no compounding) and swaps the batched model so the
    K3-rows rows are rebuilt; `resample_shapes` re-layers the props on new
    shapes; `AMPAgent.pre_epoch` re-draws a DR-only env's props.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env import EnvConfig as JaxEnvConfig, HumanoidImEnv as JaxEnv
from pulse_tpu.env import domain_rand as jdr
from pulse_tpu.env.humanoid_im import EnvState as JaxEnvState
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics.shape_variation import vary_model_scales as jax_vary_model_scales
from pulse_tpu.physics.state import PhysicsState as JaxPhysicsState

from jax_reference import module_reference_compiles
from torch_close import assert_close

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env import domain_rand as dr
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv, env_state_from_numpy
from pulse_tpu_torch.learning.amp import AMPConfig
from pulse_tpu_torch.learning.amp_agent import AMPAgent
from pulse_tpu_torch.learning.networks import ActorCritic
from pulse_tpu_torch.learning.ppo import PPOConfig
from pulse_tpu_torch.motion.motion_lib import MotionData
from pulse_tpu_torch.physics import substep_cuda
from pulse_tpu_torch.physics.model import BATCHED_LEAVES, PhysicsConfig, batched_model_from_numpy, build_model
from pulse_tpu_torch.utils.config import load_config

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

B = 4
CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
STATE_TOL = {"root_pos": 2e-4, "root_rot": 2e-4, "joint_rot": 2e-4, "root_vel6": 5e-3, "joint_omega": 5e-3,
             "body_pos": 3e-4, "body_rot": 2e-4, "body_vel": 5e-3, "body_ang_vel": 5e-3, "contact_force": 1.0}
SPECS = dict(
    observations=dict(distribution="gaussian", operation="additive", range=(0.01, 0.05),
                      range_correlated=(0.0, 0.02), schedule="linear", schedule_steps=10),
    actions=dict(distribution="uniform", operation="scaling", range=(0.9, 1.2), range_correlated=(0.95, 1.05),
                 schedule="constant", schedule_steps=2),
)
PROPS = dict(frequency=3, friction_range=(0.7, 1.3), mass_range=(0.9, 1.1), gain_range=(0.8, 1.2))


def _cfg(mod):
    return mod.DRConfig(**{k: mod.DRSpec(**v) for k, v in SPECS.items()}, **PROPS)


# --------------------------------------------------------------------------- #
# (a), (b) the functions
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("distribution", ["gaussian", "uniform"])
@pytest.mark.parametrize("operation", ["additive", "scaling"])
@pytest.mark.parametrize("schedule", [None, "linear", "constant"])
def test_apply_noise_matches_jax(distribution, operation, schedule):
    kw = dict(distribution=distribution, operation=operation, range=(0.9, 1.1) if operation == "scaling" else
              (-0.05, 0.1), range_correlated=(0.95, 1.02) if operation == "scaling" else (0.01, 0.03),
              schedule=schedule, schedule_steps=20)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (5, 7)).astype(np.float32)
    corr = rng.normal(0, 1, (5, 7)).astype(np.float32)
    steps = np.array([0, 7, 19, 20, 400], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(5), 5)
    jspec = jdr.DRSpec(**kw)
    want = jax.vmap(lambda t, c, k, s: jdr.apply_noise(jspec, t, c, k, s))(x, corr, keys, steps)
    sample = jax.random.normal if distribution == "gaussian" else jax.random.uniform
    draw = np.asarray(jax.vmap(lambda k: sample(k, (7,)))(keys))
    got = dr.apply_noise(dr.DRSpec(**kw), torch.tensor(x), torch.tensor(corr), torch.tensor(draw),
                         torch.tensor(steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    for s in steps:
        assert float(dr.schedule_scaling(dr.DRSpec(**kw), torch.tensor(s))) == pytest.approx(
            float(jdr.schedule_scaling(jspec, jnp.asarray(s))))


@pytest.mark.parametrize("bad", [dict(distribution="laplace"), dict(operation="mul"), dict(schedule="cosine")])
def test_dr_spec_rejects_unknown_names(bad):
    for mod in (dr, jdr):
        with pytest.raises(ValueError, match="unknown"):
            mod.DRSpec(**bad)


@pytest.mark.parametrize("block", [
    load_config(["env=im"])["env"]["randomization_params"],
    {"frequency": 7, "actions": {"range": [0.0, 0.1]}, "gain_range": [0.5, 1.5]},
    {},
])
def test_dr_config_from_dict_matches_jax(block):
    got, want = dr.dr_config_from_dict(block), jdr.dr_config_from_dict(block)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.fixture(scope="module")
def models():
    return build_model(load_smpl_humanoid(), PhysicsConfig(**CFG), device="cpu"), \
        jax_build_model(jax_load_smpl(), JaxPhysicsConfig(**CFG))


def _leaves(m) -> dict:
    return {k: np.asarray(getattr(m, k)) for k in BATCHED_LEAVES}


@pytest.mark.parametrize("scaled", [False, True])
def test_randomize_model_props_matches_jax(models, scaled):
    """The port's multipliers applied where the JAX package's are: the
    shared model is batched at scale 1 first; a scale-varied one is
    multiplied in place."""
    model, jmodel = models
    n, key = 5, jax.random.PRNGKey(11)
    ranges = dict(friction_range=(0.7, 1.3), mass_range=(0.8, 1.2), gain_range=(0.5, 1.5))
    if scaled:
        jmodel = jax_vary_model_scales(jmodel, jax.random.PRNGKey(2), n, (0.9, 1.1))
        model = batched_model_from_numpy(model, _leaves(jmodel))
    want = jdr.randomize_model_props(jmodel, key, n, **ranges)
    mults = [torch.tensor(np.asarray(jax.random.uniform(k, (n, 1), minval=r[0], maxval=r[1])))
             for k, r in zip(jax.random.split(key, 3), ranges.values())]
    got = dr.scale_model_props(model, *mults)
    for k, w in _leaves(want).items():
        np.testing.assert_allclose(getattr(got, k).numpy(), w, rtol=1e-6, atol=1e-7, err_msg=k)

    drawn = dr.randomize_model_props(model, torch.Generator().manual_seed(0), n, **ranges)
    fr = drawn.cp_friction / (model.cp_friction if model.batched else model.cp_friction[None])
    assert ((fr >= 0.7) & (fr <= 1.3)).all() and fr[:, 0].unique().numel() == n
    assert dr.randomize_model_props(model, torch.Generator(), n) is model


# --------------------------------------------------------------------------- #
# (c) one DR env step against JAX's
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def motions():
    jspec = jax_load_smpl()
    jm = jax_build_motion_data(jspec.skeleton, jax_clips(jspec.skeleton, 4))
    fields = {f.name: torch.float32 for f in dataclasses.fields(MotionData)}
    fields.update(length_starts=torch.long, motion_num_frames=torch.long)
    return MotionData(**{k: torch.tensor(np.asarray(getattr(jm, k)), dtype=dt) for k, dt in fields.items()}), jm


def _draw_feed(draws: dict):
    """A `_dr_draw` that returns the given draws by name."""
    return lambda name, shape, spec=None: draws[name].clone()


@pytest.fixture(scope="module")
def stepped(models, motions):
    model, jmodel = models
    motion, jmotion = motions
    jenv = JaxEnv(jmodel, jmotion, JaxEnvConfig(dr=_cfg(jdr)))
    jenv.randomize_physical_props(jax.random.PRNGKey(11), B)
    env = HumanoidImEnv(model, motion, EnvConfig(dr=_cfg(dr)), device="cpu")
    env.batched_model = batched_model_from_numpy(model, _leaves(jenv.batched_model))
    ids = np.arange(B)
    start = np.array([0.5, 1.0, 1.5, 0.8], np.float32)
    st = env.reset_to(torch.as_tensor(ids), torch.as_tensor(start))
    d = {f.name: getattr(st, f.name).numpy().copy() for f in dataclasses.fields(st)
         if f.name != "physics" and getattr(st, f.name) is not None}
    d["physics"] = {f.name: getattr(st.physics, f.name).numpy().copy() for f in dataclasses.fields(st.physics)}
    d["progress"] = np.array([2, 1, 3, 2], np.int32)
    d["start_time"] = (start - d["progress"] * model.config.control_dt).astype(np.float32)
    d["dr_step"] = np.array([0, 1, 3, 4], np.int32)
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1, 1, (B, 69)).astype(np.float32)

    keys = jax.random.split(jax.random.PRNGKey(1), B)
    js = JaxEnvState(physics=JaxPhysicsState(**{k: jnp.asarray(v) for k, v in d["physics"].items()}), key=keys,
                     **{k: jnp.asarray(v) for k, v in d.items() if k != "physics"})
    want = jax.jit(jenv.step)(js, jnp.asarray(actions))

    def one(k):   # humanoid_im.py step_one / _finish_step draws on the pre-step key
        fk = jax.random.fold_in
        return {"act": jax.random.uniform(fk(k, 41), (69,)), "corr_obs": jax.random.normal(fk(k, 43), (env.obs_dim,)),
                "corr_act": jax.random.normal(fk(k, 47), (69,)), "obs": jax.random.normal(fk(k, 37),
                                                                                        (env.obs_dim,))}
    draws = {k: torch.tensor(np.asarray(v)) for k, v in jax.vmap(one)(keys).items()}
    env._dr_draw = _draw_feed(draws)
    env._sample_reset = lambda n: (torch.tensor(np.asarray(want.motion_id), dtype=torch.long),
                                   torch.tensor(np.asarray(want.start_time)))
    got = env._step_general(env_state_from_numpy(d), torch.as_tensor(actions))
    return env, got, want, d, actions, draws


def test_dr_step_matches_jax(stepped):
    env, got, want, d, _, draws = stepped
    assert not np.asarray(want.done).any()
    np.testing.assert_array_equal(got.dr_step.numpy(), d["dr_step"] + 1)
    np.testing.assert_array_equal(got.dr_step.numpy(), np.asarray(want.dr_step))
    refresh = np.array([True, False, True, False])
    for f in ("dr_corr_obs", "dr_corr_act"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f).numpy()[refresh], draws[f[3:]].numpy()[refresh])
        np.testing.assert_array_equal(getattr(got, f).numpy()[~refresh], d[f][~refresh])
    # about twice the measured maxima: obs 1.53e-4, reward 1.68e-4
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs), atol=3e-4, rtol=0)
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(want.reward), atol=3.5e-4, rtol=0)
    for f, tol in STATE_TOL.items():
        np.testing.assert_allclose(getattr(got.physics, f).numpy(), np.asarray(getattr(want.physics, f)), atol=tol,
                                   rtol=0, err_msg=f)
    # the noise acted: the obs differ from the noise-free observation
    clean = env._observe_general(got).numpy()
    assert np.abs(got.obs.numpy() - clean).max() > 1e-3


def test_dr_kernel_surface_step_equals_general_step(stepped):
    """On the kernels' surface a DR env steps K3-rows -> RA -> K2 (plain on
    the CPU), never K1, and then takes the same noise as the general
    step."""
    env, got, _, d, actions, _ = stepped
    assert env._kernel_surface() and not env._fused_step_ok()
    kern = env.step(env_state_from_numpy(d), torch.as_tensor(actions))
    np.testing.assert_allclose(kern.obs.numpy(), got.obs.numpy(), atol=1e-4, rtol=0)
    for f in ("reward", "amp_hist"):
        np.testing.assert_allclose(getattr(kern, f).numpy(), getattr(got, f).numpy(), atol=1e-5, rtol=0, err_msg=f)
    for f in ("dr_corr_obs", "dr_corr_act", "dr_step", "done"):
        np.testing.assert_array_equal(getattr(kern, f).numpy(), getattr(got, f).numpy(), err_msg=f)


# --------------------------------------------------------------------------- #
# (d) the props' re-draws
# --------------------------------------------------------------------------- #

def _friction_mult(env) -> torch.Tensor:
    return env.batched_model.cp_friction[:, 0] / env.model.cp_friction[0]


def test_randomize_physical_props_redraws_without_compounding(models, motions):
    model, motion = models[0], motions[0]
    env = HumanoidImEnv(model, motion, EnvConfig(dr=_cfg(dr)), device="cpu")
    env.randomize_physical_props(6, generator=torch.Generator().manual_seed(1))
    first, rows = env.batched_model, env._model_rows(6)
    env.randomize_physical_props(6, generator=torch.Generator().manual_seed(2))
    assert env.batched_model is not first and env._prop_rand_base is model
    assert not torch.equal(env._model_rows(6), rows)
    lay = substep_cuda.model_rows_layout(24, int(model.cp_body.shape[0]))[0]["cp_friction"]
    assert_close(env._model_rows(6)[:, lay[0]:lay[1]], env.batched_model.cp_friction)
    for m in (_friction_mult(env), env.batched_model.body_mass[:, 0] / model.body_mass[0]):
        assert ((m >= 0.7) & (m <= 1.3)).all()
    # a config without prop ranges leaves the model shared
    plain = HumanoidImEnv(model, motion, EnvConfig(dr=dr.DRConfig(observations=dr.DRSpec())), device="cpu")
    plain.randomize_physical_props(6)
    assert plain.batched_model is None


def test_resample_shapes_relayers_the_props(models, motions):
    model, motion = models[0], motions[0]
    env = HumanoidImEnv(model, motion, EnvConfig(dr=_cfg(dr)), device="cpu")
    env.enable_shape_variation(5, generator=torch.Generator().manual_seed(0))
    env.randomize_physical_props(5, generator=torch.Generator().manual_seed(1))
    shapes = env._prop_rand_base
    env.resample_shapes()
    assert env._prop_rand_base is not shapes and env._prop_rand_base.batched
    base = env._prop_rand_base
    m = env.batched_model.cp_friction / base.cp_friction
    assert_close(env.batched_model.local_translation, base.local_translation)
    assert ((m >= 0.7) & (m <= 1.3)).all() and m[:, 0].unique().numel() == 5


def test_amp_pre_epoch_redraws_dr_props(models, motions):
    """Every shape_resampling_interval epochs (epoch % 2 == 1 past epoch 1)
    a DR-only env's props are re-drawn from the pre-DR model."""
    model, motion = models[0], motions[0]
    env = HumanoidImEnv(model, motion, EnvConfig(dr=_cfg(dr)), device="cpu")
    env.randomize_physical_props(8, generator=torch.Generator().manual_seed(11))
    net = ActorCritic(env.obs_dim, env.action_dim, actor_units=(16,), critic_units=(16,), device="cpu")
    agent = AMPAgent(env, PPOConfig(num_envs=8, horizon_length=2, minibatch_size=16),
                     AMPConfig(disc_units=(16,), amp_batch_size=8, amp_buffer_size=64), net,
                     shape_resampling_interval=2)
    first = _friction_mult(env)
    for epoch, redraw in ((1, False), (2, False), (3, True), (4, False), (5, True)):
        old = env.batched_model
        agent.pre_epoch(None, epoch)
        assert (env.batched_model is not old) == redraw, epoch
    m = _friction_mult(env)
    assert env._prop_rand_base is model and not torch.equal(m, first)
    assert ((m >= 0.7) & (m <= 1.3)).all()
