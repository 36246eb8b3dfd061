"""Shape variation under the getup envs (`env=im_getup env.shape_variation=true`)
in the port against the JAX package on the CPU.

B = 4 envs of HumanoidImGetupEnv with the shape, shape-disc and limb-weight
channels, 1 substep of 1/120 s, 4 fall states settled for 2 steps. One JAX
program (reference_jit) settles the JAX env's fall-state bank as its
constructor does (`_generate_fall_states`, PRNGKey(42)), resets the 4 envs
with their own body shapes (the bank's physics for a fall reset, the
reference-state init FK'd through the env's own model otherwise) and steps
them once from that reset, two envs placed at their clip's end so that the
step resets them too. The port builds its bank from the JAX drop's poses
(`fall_drop_poses` fed the JAX draws) with its own settle, takes the JAX
env's batched model and shape table, and its samplers are fed the JAX
side's draws (clip, start time, fall choice and index, recovery grace).

As in the JAX package, the bank is settled once under the shared model
and `enable_shape_variation` does not rebuild it: a fall reset takes the
bank's physics (the shared skeleton's body positions) until its first step.

A fall pose's dofs are clamped onto their joint limits, where the limit
spring switches on float noise (a knife edge, as contact is); the step
therefore starts from the reset state with every dof LIMIT_MARGIN inside
its limits, in both packages (on the limit one env's joint velocities moved
by 0.5 rad/s).

Tolerances: the bank, the reset's physics and the stepped physics at the
physics step's tolerances (tests/test_torch_getup.py: positions 2-3e-4,
velocities 5e-3, contact forces 1.0 N, held per element, so no env is an
outlier); flags, clip ids, progress, grace counters and start times
exactly; the shape columns exactly; obs and the AMP rows 1e-4, reward and
its terms 1e-6 (float32 rounding through the FK of reset envs and the
step).

The other three getup tasks (`env=amp_getup`, `env=im_mcp_getup` with a
fresh PNN, `env=im_vae`) build through `run.build_env_from_cfg` with shapes
and step once on the port alone.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env.humanoid_im_getup import GetupConfig as JaxGetupConfig, HumanoidImGetupEnv as JaxGetupEnv
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.ops import quat as jq
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model

from jax_reference import module_reference_compiles, reference_jit

from pulse_tpu_torch import _build, run
from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env import humanoid_im_getup
from pulse_tpu_torch.env.humanoid_amp_getup import HumanoidAMPGetupEnv
from pulse_tpu_torch.env.humanoid_im import env_state_from_numpy
from pulse_tpu_torch.env.humanoid_im_getup import GetupConfig, HumanoidImGetupEnv
from pulse_tpu_torch.env.humanoid_im_mcp import HumanoidImMCPGetupEnv
from pulse_tpu_torch.motion.motion_lib import build_motion_data
from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
from pulse_tpu_torch.physics.model import BATCHED_LEAVES, PhysicsConfig, build_model
from pulse_tpu_torch.utils.config import load_config

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

B = 4
N_FALL = 4
CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
SHAPE = dict(has_shape_obs=True, has_shape_obs_disc=True, has_limb_weight_obs=True)
GETUP = dict(num_fall_states=N_FALL, fall_settle_steps=2, fall_init_prob=0.5, recovery_episode_prob=0.5, **SHAPE)
AT_END = np.array([False, False, True, True])     # stepped at their clip's end: the step resets them
KEY_SEED = 11     # reset keys under which both kinds of reset occur at the reset and in the step
SHAPE_SEED = 7
LIMIT_MARGIN = 1e-3           # rad inside the joint limits at the step's start
SELF_OBS, AMP = 358, 232      # the shape columns follow the self obs and the AMP row's motion channels
PHYS_TOL = {"root_pos": 2e-4, "root_rot": 2e-4, "body_pos": 3e-4, "body_rot": 2e-4, "root_vel6": 5e-3,
            "joint_omega": 5e-3, "body_vel": 5e-3, "body_ang_vel": 5e-3, "contact_force": 1.0}
OUT_TOL = {"obs": 1e-4, "amp_hist": 1e-4, "reward": 1e-6, "reward_raw": 1e-6}


def _getup_draws(key):
    """humanoid_im_getup.py reset_one's draws on its reset key: (fall,
    fall index, recovery grace)."""
    k_choice, k_recover, k_fall, _ = jax.random.split(key, 4)
    return (jax.random.uniform(k_choice) < GETUP["fall_init_prob"], jax.random.randint(k_fall, (), 0, N_FALL),
            jax.random.uniform(k_recover) < GETUP["recovery_episode_prob"])


def _draws(keys):
    return tuple(np.asarray(x) for x in jax.vmap(_getup_draws)(keys))


def _numpy_state(st) -> dict:
    d = {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)
         if f.name not in ("physics", "key", "shape_obs") and getattr(st, f.name) is not None}
    d["physics"] = {f.name: np.asarray(getattr(st.physics, f.name)) for f in dataclasses.fields(st.physics)}
    return d


def _feed(env, st_or_draws, getup):
    """The port's samplers return the JAX side's clip, start time and getup
    draws."""
    ids, times = st_or_draws
    env._sample_reset = lambda n: (torch.tensor(ids, dtype=torch.long), torch.tensor(times))
    env._sample_getup = lambda n: (torch.tensor(getup[0]), torch.tensor(getup[1], dtype=torch.long),
                                   torch.tensor(getup[2]))


@pytest.fixture(scope="module")
def run_both():
    jspec = jax_load_smpl()
    jmodel = jax_build_model(jspec, JaxPhysicsConfig(**CFG))

    class JaxEnv(JaxGetupEnv):
        def _generate_fall_states(self, key):     # settled inside the reference program below
            return None

    jenv = JaxEnv(jmodel, jax_build_motion_data(jspec.skeleton, jax_clips(jspec.skeleton, 4)),
                  JaxGetupConfig(**GETUP))
    jenv.enable_shape_variation(jax.random.PRNGKey(SHAPE_SEED), B)
    reset_keys = jax.random.split(jax.random.PRNGKey(KEY_SEED), B)
    actions = np.random.default_rng(0).uniform(-1, 1, (B, 69)).astype(np.float32)

    def reference(keys, acts):
        bank = JaxGetupEnv._generate_fall_states(jenv, jax.random.PRNGKey(42))
        jenv.fall_states = bank
        st0 = jenv.reset(keys)
        end = jenv.motion.motion_lengths[st0.motion_id] - 1e-3
        # a fall pose's dofs are clamped onto their limits, where the limit
        # spring switches on float noise (a knife edge, as contact is:
        # tests/test_torch_fall.py); the step starts LIMIT_MARGIN inside them
        dof = jq.quat_to_exp_map(st0.physics.joint_rot)
        lo, hi = jmodel.dof_lower.reshape(-1, 3), jmodel.dof_upper.reshape(-1, 3)
        joint_rot = jq.exp_map_to_quat(jnp.clip(dof, lo + LIMIT_MARGIN, hi - LIMIT_MARGIN))
        st1_in = st0.replace(start_time=jnp.where(jnp.asarray(AT_END), end, st0.start_time),
                             physics=st0.physics.replace(joint_rot=joint_rot))
        return bank, st0, st1_in, jenv.step(st1_in, acts)

    bank, want0, want1_in, want1 = reference_jit(reference)(reset_keys, jnp.asarray(actions))
    jenv.fall_states = bank
    # the drop's poses, as `_generate_fall_states` draws them
    k_rot, k_dof = jax.random.split(jax.random.PRNGKey(42))
    rots = jax.vmap(lambda k: jq.quat_unit(jax.random.normal(k, (4,))))(jax.random.split(k_rot, N_FALL))
    dofs = jax.vmap(lambda k: jnp.clip(0.4 * jax.random.normal(k, (jmodel.num_dof,)), jmodel.dof_lower,
                                       jmodel.dof_upper))(jax.random.split(k_dof, N_FALL))

    spec = load_smpl_humanoid()
    model = build_model(spec, PhysicsConfig(**CFG), device="cpu")
    motion = build_motion_data(spec.skeleton, make_synthetic_clips(spec.skeleton, 4), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(humanoid_im_getup, "fall_drop_poses",
                   lambda m, n, device: (torch.tensor(np.asarray(rots)), torch.tensor(np.asarray(dofs))))
        env = HumanoidImGetupEnv(model, motion, GetupConfig(**GETUP), device="cpu")
    bank_before = env.fall_states
    bank_values = {f.name: getattr(bank_before, f.name).clone() for f in dataclasses.fields(bank_before)}
    env.enable_shape_variation(B, generator=torch.Generator().manual_seed(SHAPE_SEED))
    kept = env.fall_states is bank_before and all(
        torch.equal(getattr(env.fall_states, k), v) for k, v in bank_values.items())
    table = np.asarray(jenv._shape_obs_table)
    env.set_shapes_from_numpy({k: np.asarray(getattr(jenv.batched_model, k)) for k in BATCHED_LEAVES + ("cp_body",)},
                              table)

    reset_draws = _draws(reset_keys)
    _feed(env, (np.asarray(want0.motion_id), np.asarray(want0.start_time)), reset_draws)
    got0 = env.reset(B)
    step_draws = _draws(jax.vmap(lambda k: jax.random.split(k)[0])(want1_in.key))
    _feed(env, (np.asarray(want1.motion_id), np.asarray(want1.start_time)), step_draws)
    got1 = env.step(env_state_from_numpy(_numpy_state(want1_in)), torch.as_tensor(actions))
    return dict(env=env, bank=bank, kept=kept, table=table, got0=got0, want0=want0, got1=got1, want1=want1,
                reset_fall=reset_draws[0], reset_idx=reset_draws[1], step_fall=step_draws[0])


def test_fall_bank_matches_jax_and_is_not_rebuilt_by_shapes(run_both):
    r = run_both
    assert r["kept"], "enable_shape_variation rebuilt the fall-state bank"
    assert r["env"].batched_model is not None and r["env"].batched_model.batched
    for f, atol in PHYS_TOL.items():
        np.testing.assert_allclose(getattr(r["env"].fall_states, f).numpy(), np.asarray(getattr(r["bank"], f)),
                                   atol=atol, err_msg=f)


def test_reset_matches_jax(run_both):
    r = run_both
    got, want, fall = r["got0"], r["want0"], r["reset_fall"]
    assert fall.any() and not fall.all(), "both kinds of reset expected"
    for f in ("motion_id", "progress", "recovery_counter"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_array_equal(got.start_time.numpy(), np.asarray(want.start_time))
    for f, atol in PHYS_TOL.items():
        np.testing.assert_allclose(getattr(got.physics, f).numpy(), np.asarray(getattr(want.physics, f)),
                                   atol=atol, err_msg=f)
    # a fall reset takes the shared-model bank's bodies as they are
    idx = torch.as_tensor(r["reset_idx"][fall], dtype=torch.long)
    np.testing.assert_array_equal(got.physics.body_pos[torch.as_tensor(fall)].numpy(),
                                  r["env"].fall_states.body_pos[idx].numpy())
    np.testing.assert_array_equal(got.obs[:, SELF_OBS:SELF_OBS + 21].numpy(), r["table"])
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs), atol=OUT_TOL["obs"])
    np.testing.assert_allclose(got.amp_hist.numpy(), np.asarray(want.amp_hist), atol=OUT_TOL["amp_hist"])


def test_step_flags_and_resets_match_jax(run_both):
    r = run_both
    got, want = r["got1"], r["want1"]
    done = np.asarray(want.done)
    assert done[AT_END].all() and not done[~AT_END].any()
    assert (r["step_fall"] & done).any() and (~r["step_fall"] & done).any(), "both kinds of reset expected"
    assert not r["env"]._fused_step_ok()
    for f in ("done", "terminate", "motion_id", "progress", "recovery_counter"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_array_equal(got.start_time.numpy(), np.asarray(want.start_time))


@pytest.mark.parametrize("field", sorted(OUT_TOL))
def test_step_outputs_match_jax(run_both, field):
    r = run_both
    np.testing.assert_allclose(getattr(r["got1"], field).numpy(), np.asarray(getattr(r["want1"], field)),
                               atol=OUT_TOL[field])
    if field == "obs":
        np.testing.assert_array_equal(r["got1"].obs[:, SELF_OBS:SELF_OBS + 21].numpy(), r["table"])
    if field == "amp_hist":
        np.testing.assert_array_equal(r["got1"].amp_hist[:, 0, AMP:].numpy(), r["table"])


@pytest.mark.parametrize("field", sorted(PHYS_TOL))
def test_step_physics_matches_jax(run_both, field):
    r = run_both
    np.testing.assert_allclose(getattr(r["got1"].physics, field).numpy(),
                               np.asarray(getattr(r["want1"].physics, field)), atol=PHYS_TOL[field])


@pytest.mark.parametrize("args,cls", [
    (["env=amp_getup", "learning=im_amp"], HumanoidAMPGetupEnv),
    (["env=im_mcp_getup"], HumanoidImMCPGetupEnv),
    (["env=im_vae", "learning=im_z_fit"], HumanoidImGetupEnv),
])
def test_getup_tasks_build_with_shapes_and_step(args, cls):
    cfg = load_config([*args, "env.shape_variation=true", "num_envs=4", "env.num_fall_states=4",
                       "env.fall_settle_steps=1", "device=cpu"])
    spec, model = run.build_model_from_cfg(cfg, torch.device("cpu"))
    motion = run.build_motion_from_cfg(cfg, spec, torch.device("cpu"))
    before = dict(_build.launches)
    env = run.build_env_from_cfg(cfg, model, motion, torch.device("cpu"))
    assert type(env) is cls and env.batched_model is not None and env.batched_model.batched
    assert env._shape_args["num_envs"] == 4
    st = env.reset(4)
    st = env.step(st, torch.zeros(4, env.action_dim))
    assert _build.launches == before      # the CPU runs the plain versions
    assert torch.isfinite(st.obs).all() and torch.isfinite(st.physics.body_pos).all()
    assert env._model_rows(4).shape[0] == 4     # K3-rows' per-env rows on the card
