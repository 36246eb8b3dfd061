"""The port's pure-AMP envs (HumanoidAMPEnv, HumanoidAMPGetupEnv) against the
JAX package's on the CPU: the generic fall check `compute_humanoid_reset`,
and one step of each env (the port on its kernel path, the plain versions
of K3 → RA, then the self obs; JAX on its per-env XLA `_finish_step`),
both envs' steps in one jit on the JAX side.

The step: B = 10 envs at 1 substep of 1/120 s, episode_length 20, the same
start states and actions, the port's samplers fed the JAX side's draws
(clip and start time from its output; the getup env's fall choice, fall
index and recovery grace recomputed from its per-env keys). Both packages
read the JAX store's motion tables and share a small fall-state table:
  envs 0, 1 mid clip, upright (no reset),
  envs 2, 3, 7 lying at 0.12 m with bodies in ground contact, progress 5
    (a fall: terminate; env 3 in a grace window on the getup env: held),
  env 4 lying the same at progress 0 (no fall before the second step),
  env 5 at its clip's end (a timeout reset),
  env 6 at the episode's last step (progress 18 -> 19 = episode_length - 1),
  envs 8, 9 mid clip.
Tolerances: flags, clip ids, progress and grace counters exactly where no
non-foot body lies within 1e-4 m of the termination height or within 1e-3
of the contact threshold (none does here); reward and its raws exactly 1;
the observation (the self obs only, 358 wide) 1e-4 in the envs that did
not reset and 2e-4 in those that did (a fresh state read from slerped
motion tables: the JAX package's own jitted and eager observations of one
such state differ by 1.3e-4, tests/test_torch_general_env.py (b)); the
AMP history 1e-4 (its newest rows hold the stepped root velocities, which
carry the physics step's float rounding: up to 3.3e-5 here); the physics
as in tests/test_torch_physics.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env import EnvConfig as JaxEnvConfig
from pulse_tpu.env import kernels as jax_kernels
from pulse_tpu.env.humanoid_amp_getup import HumanoidAMPEnv as JaxAMPEnv, HumanoidAMPGetupEnv as JaxAMPGetupEnv
from pulse_tpu.env.humanoid_im import EnvState as JaxEnvState
from pulse_tpu.env.humanoid_im_getup import GetupConfig as JaxGetupConfig
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics.state import PhysicsState as JaxPhysicsState

from jax_reference import module_reference_compiles, reference_jit

from pulse_tpu_torch import _build
from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env import cuda_obs, kernels
from pulse_tpu_torch.env.humanoid_amp_getup import HumanoidAMPEnv, HumanoidAMPGetupEnv
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv, env_state_from_numpy
from pulse_tpu_torch.env.humanoid_im_getup import GetupConfig
from pulse_tpu_torch.motion.motion_lib import MotionData
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model
from pulse_tpu_torch.physics.state import physics_state_from_numpy, state_from_kinematics

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

B = 10
CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
EPISODE = 20
GETUP = dict(episode_length=EPISODE, num_fall_states=4, fall_init_prob=0.5, recovery_episode_prob=0.5)
LYING = [2, 3, 4, 7]
HEIGHT = 0.15


@pytest.fixture(scope="module")
def setup():
    jspec = jax_load_smpl()
    jm = jax_build_motion_data(jspec.skeleton, jax_clips(jspec.skeleton, 4))
    fields = {f.name: torch.float32 for f in dataclasses.fields(MotionData)}
    fields.update(length_starts=torch.long, motion_num_frames=torch.long)
    motion = MotionData(**{k: torch.tensor(np.asarray(getattr(jm, k)), dtype=dt) for k, dt in fields.items()})
    model = build_model(load_smpl_humanoid(), PhysicsConfig(**CFG), device="cpu")
    return model, motion, jax_build_model(jspec, JaxPhysicsConfig(**CFG)), jm


def _lying(model, n: int, rng) -> dict:
    """n humanoids on their backs at 0.12 m (some bodies in the ground), at
    rest, as numpy arrays."""
    rot = np.tile(np.array([np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4)], np.float32), (n, 1))
    pos = np.concatenate([rng.uniform(-1, 1, (n, 2)), np.full((n, 1), 0.12)], axis=1).astype(np.float32)
    dof = (0.2 * rng.standard_normal((n, model.num_dof))).astype(np.float32)
    z3 = torch.zeros(n, 3)
    st = state_from_kinematics(model, torch.as_tensor(pos), torch.as_tensor(rot), torch.as_tensor(dof), z3, z3,
                               torch.zeros(n, model.num_dof))
    return {f.name: getattr(st, f.name).numpy() for f in dataclasses.fields(st)}


def _jax_state(d: dict, keys) -> JaxEnvState:
    return JaxEnvState(physics=JaxPhysicsState(**{k: jnp.asarray(v) for k, v in d["physics"].items()}), key=keys,
                       **{k: jnp.asarray(v) for k, v in d.items() if k != "physics"})


@pytest.fixture(scope="module")
def stepped(setup):
    model, motion, jmodel, jmotion = setup
    rng = np.random.default_rng(0)
    table = _lying(model, 4, np.random.default_rng(5))

    class PortGetup(HumanoidAMPGetupEnv):
        def _generate_fall_states(self):
            return physics_state_from_numpy(table)

    class JaxGetup(JaxAMPGetupEnv):
        def _generate_fall_states(self, key):
            return JaxPhysicsState(**{k: jnp.asarray(v) for k, v in table.items()})

    env = HumanoidAMPEnv(model, motion, EnvConfig(episode_length=EPISODE), device="cpu", termination_height=HEIGHT)
    genv = PortGetup(model, motion, GetupConfig(**GETUP), device="cpu", termination_height=HEIGHT)
    ids = np.arange(B) % 4
    L = motion.motion_lengths[torch.as_tensor(ids)].numpy()
    start = rng.uniform(0.5, 2.5, B).astype(np.float32)
    start[5] = L[5] - 1e-3
    st = env.reset_to(torch.as_tensor(ids), torch.as_tensor(start))
    d = {f.name: getattr(st, f.name).numpy().copy() for f in dataclasses.fields(st)
         if f.name != "physics" and getattr(st, f.name) is not None}
    d["physics"] = {f.name: getattr(st.physics, f.name).numpy().copy() for f in dataclasses.fields(st.physics)}
    lying = _lying(model, len(LYING), rng)
    for k, v in lying.items():
        d["physics"][k][LYING] = v
    d["progress"] = np.array([3, 3, 5, 5, 0, 0, EPISODE - 2, 5, 4, 2], np.int32)
    d["recovery_counter"] = np.where(np.arange(B) == 3, 90, 0).astype(np.int32)
    actions = rng.uniform(-1, 1, (B, 69)).astype(np.float32)

    jenv = JaxAMPEnv(jmodel, jmotion, JaxEnvConfig(episode_length=EPISODE), termination_height=HEIGHT)
    jgenv = JaxGetup(jmodel, jmotion, JaxGetupConfig(**GETUP), termination_height=HEIGHT)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    js = _jax_state(d, keys)
    want, gwant = reference_jit(lambda s, a: (jenv.step(s, a), jgenv.step(s, a)))(js, jnp.asarray(actions))

    def getup_draws(key):     # humanoid_im_getup.py reset_one, on _finish_step's reset key
        k_choice, k_recover, k_fall, _ = jax.random.split(jax.random.split(key)[0], 4)
        return (jax.random.uniform(k_choice) < GETUP["fall_init_prob"],
                jax.random.randint(k_fall, (), 0, GETUP["num_fall_states"]),
                jax.random.uniform(k_recover) < GETUP["recovery_episode_prob"])

    use_fall, idx, recover = (np.asarray(x) for x in jax.vmap(getup_draws)(keys))
    for e, w in ((env, want), (genv, gwant)):
        e._sample_reset = lambda n, w=w: (torch.tensor(np.asarray(w.motion_id), dtype=torch.long),
                                          torch.tensor(np.asarray(w.start_time)))
    genv._sample_getup = lambda n: (torch.tensor(use_fall), torch.tensor(idx, dtype=torch.long),
                                    torch.tensor(recover))
    before = dict(_build.launches)
    got = env.step(env_state_from_numpy(d), torch.as_tensor(actions))
    ggot = genv.step(env_state_from_numpy(d), torch.as_tensor(actions))
    assert _build.launches == before    # the CPU runs the plain versions
    return {"amp": (env, got, want), "getup": (genv, ggot, gwant)}, d


def test_compute_humanoid_reset_matches_jax():
    rng = np.random.default_rng(1)
    n, J = 64, 24
    progress = rng.integers(0, 6, n).astype(np.int32)
    force = np.where(rng.uniform(size=(n, J, 3)) < 0.05, rng.normal(0, 1, (n, J, 3)), 0.0).astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (n, J, 3)).astype(np.float32)
    ids = np.array([i for i in range(J) if i not in (3, 4, 7, 8)])
    for early in (True, False):
        want = jax_kernels.compute_humanoid_reset(jnp.asarray(progress), jnp.asarray(force), jnp.asarray(pos),
                                                  jnp.asarray(ids), 0.15, 5, enable_early_termination=early)
        got = kernels.compute_humanoid_reset(torch.as_tensor(progress), torch.as_tensor(force), torch.as_tensor(pos),
                                             torch.as_tensor(ids), 0.15, 5, enable_early_termination=early)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[1].any() == early and got[0].any() and not got[0].all()


@pytest.mark.parametrize("name", ["amp", "getup"])
def test_surface_widths_and_path(stepped, setup, name):
    """Self obs only; the imitation env's AMP width and kernel constants; the
    step off K1 (termination overridden) but on the kernels' surface (K3 →
    RA, never K2)."""
    env = stepped[0][name][0]
    model, motion = setup[:2]
    im = HumanoidImEnv(model, motion, EnvConfig(episode_length=EPISODE), device="cpu")
    assert env.obs_dim == env.self_obs_dim == 358 and env.task_obs_dim == 0
    assert env.amp_obs_dim == im.amp_obs_dim == 2320 and env.consts == im.consts
    assert env._kernel_surface() and not env._fused_step_ok()
    foot = {env.body_names.index(n) for n in ("L_Ankle", "R_Ankle", "L_Toe", "R_Toe")}
    assert set(env.non_contact_body_ids.tolist()) == set(range(24)) - foot
    assert env.with_config(env.config).termination_height == HEIGHT


@pytest.mark.parametrize("name", ["amp", "getup"])
def test_step_flags_match_jax(stepped, name):
    (env, got, want), d = stepped[0][name], stepped[1]
    ph = np.asarray(want.physics.body_pos)[:, env.non_contact_body_ids.numpy(), 2]
    cf = np.abs(np.asarray(want.physics.contact_force)[:, env.non_contact_body_ids.numpy()])
    edge = (np.abs(ph - HEIGHT) < 1e-4).any(1) | (np.abs(cf - 0.1) < 1e-3).any((1, 2))
    assert not edge.any()
    term, done = np.asarray(want.terminate), np.asarray(want.done)
    held = name == "getup"
    assert term[[2, 7]].all() and term[3] != held and not term[[0, 1, 4, 5, 6, 8, 9]].any()
    assert done[[2, 5, 6, 7]].all() and done[3] != held and not done[[0, 1, 4, 8, 9]].any()
    if held:
        assert int(env.grace_holds) == 1
    for f in ("done", "terminate", "motion_id", "progress", "recovery_counter"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("name", ["amp", "getup"])
def test_step_outputs_match_jax(stepped, name):
    _, got, want = stepped[0][name]
    assert torch.equal(got.reward, torch.ones(B)) and torch.equal(got.reward_raw, torch.ones(B, 4))
    np.testing.assert_array_equal(np.asarray(want.reward), 1.0)
    assert got.obs.shape == (B, 358)
    done = np.asarray(want.done)
    np.testing.assert_allclose(got.obs.numpy()[~done], np.asarray(want.obs)[~done], atol=1e-4)
    np.testing.assert_allclose(got.obs.numpy()[done], np.asarray(want.obs)[done], atol=2e-4)
    np.testing.assert_allclose(got.amp_hist.numpy(), np.asarray(want.amp_hist), atol=1e-4)


@pytest.mark.parametrize("field,atol", [
    ("root_pos", 2e-4), ("root_rot", 2e-4), ("body_pos", 3e-4), ("body_rot", 2e-4),
    ("root_vel6", 5e-3), ("joint_omega", 5e-3), ("body_vel", 5e-3), ("body_ang_vel", 5e-3),
    ("contact_force", 1.0),
])
def test_step_physics_matches_jax(stepped, field, atol):
    for name in ("amp", "getup"):
        _, got, want = stepped[0][name]
        np.testing.assert_allclose(getattr(got.physics, field).numpy(), np.asarray(getattr(want.physics, field)),
                                   atol=atol, err_msg=name)


def test_reset_and_general_path_observe_self_obs_only(setup):
    """Neither the reset nor the general step (self obs v2, off the
    kernels' surface) reads the task obs: v2's observation is the history,
    newest first, and the general step's AMP row is RA's plain version."""
    model, motion = setup[:2]
    env = HumanoidAMPEnv(model, motion, EnvConfig(self_obs_v=2), device="cpu")
    st = env.reset(4)
    assert not env._kernel_surface() and env.obs_dim == 5 * 358
    torch.testing.assert_close(st.obs, st.self_obs_hist.flatten(1), rtol=0, atol=0)
    nxt = env.step(st, torch.zeros(4, env.action_dim))
    torch.testing.assert_close(nxt.obs, nxt.self_obs_hist.flatten(1), rtol=0, atol=0)
    assert torch.equal(nxt.reward, torch.ones(4))
    row = cuda_obs.amp_row_plain(env.consts, nxt.physics)
    torch.testing.assert_close(nxt.amp_hist[:, 0][~nxt.done], row[~nxt.done], rtol=0, atol=0)
