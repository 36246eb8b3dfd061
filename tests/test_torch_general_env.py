"""The port's general env step (`HumanoidImEnv._step_general`: K3, then the
reward, observation and bookkeeping off the kernels' surface in plain
PyTorch) against the JAX package's per-env `HumanoidImEnv.step` on the CPU.

(a) One step of B = 4 envs at 1 substep of 1/120 s under one combined
    config: VR sparse tracking (Head, L_Hand, R_Hand), task obs v8 with two
    future frames, self obs v2 (a 5-frame history, each frame distinct) and
    the far-goal mode:
      env 0 is moved 10 m (far: location reward, no termination),
      env 1 tracks its reference mid clip,
      env 2 ends its clip (a timeout reset),
      env 3 is 0.5 m off its reference (terminates).
    The port's reset sampler is fed the JAX side's draws. Both packages read
    the JAX store's motion tables, as tests/test_torch_cycle_env.py does.
    Tolerances: obs and the newest history frame 1e-4, reward 1e-5, its raw
    terms and the AMP history 1e-4 (the rotation term's arccos near 1
    turns float rounding of the stepped rotations into ~6e-5 in env 0's);
    flags, clip ids, progress and the history's older frames exactly.
(b) `_observe` of one fixed state, no physics, for task obs v6-v9 with one
    and three future frames and self obs v1 and v3 (the ankles' contact
    forces), against the JAX observations of every case in one jit: 2e-4.
    The JAX package's own jitted and eager observations of this state
    differ by 1.3e-4 (the reference's slerp, arccos near 1, rounded apart
    by XLA's fusion); the port agrees with the eager one to 1.2e-6.
(c) The v7-v9 task-obs functions on random inputs: 1e-5.
(d) Port-only checks where the draws differ from the JAX package's:
    occlusion, obs noise, the start times of each state init, and the
    general step against each kernel path (K1; K3-rows → RA with shape
    channels; the getup env's K3 → RA) on the kernels' surface.
(e) `run.main env=im_vr device=cpu` for one epoch at narrow widths.
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
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics.state import PhysicsState as JaxPhysicsState

from jax_reference import module_reference_compiles, reference_jit

from pulse_tpu_torch import run
from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env import kernels
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv, env_state_from_numpy
from pulse_tpu_torch.env.humanoid_im_getup import GetupConfig, HumanoidImGetupEnv
from pulse_tpu_torch.motion.motion_lib import MotionData
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

B = 4
CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
VR = dict(track_bodies=("Head", "L_Hand", "R_Hand"), obs_v=8, num_traj_samples=2, self_obs_v=2, zero_out_far=True)


@pytest.fixture(scope="module")
def motions():
    """(the port's store, the JAX store) of the same 4 synthetic clips, the
    port's holding the JAX store's arrays."""
    jspec = jax_load_smpl()
    jm = jax_build_motion_data(jspec.skeleton, jax_clips(jspec.skeleton, 4))
    fields = {f.name: torch.float32 for f in dataclasses.fields(MotionData)}
    fields.update(length_starts=torch.long, motion_num_frames=torch.long)
    return MotionData(**{k: torch.tensor(np.asarray(getattr(jm, k)), dtype=dt) for k, dt in fields.items()}), jm


@pytest.fixture(scope="module")
def models():
    return build_model(load_smpl_humanoid(), PhysicsConfig(**CFG), device="cpu"), \
        jax_build_model(jax_load_smpl(), JaxPhysicsConfig(**CFG))


def _numpy_state(st) -> dict:
    d = {f.name: getattr(st, f.name).numpy().copy() for f in dataclasses.fields(st)
         if f.name != "physics" and getattr(st, f.name) is not None}
    d["physics"] = {f.name: getattr(st.physics, f.name).numpy().copy() for f in dataclasses.fields(st.physics)}
    return d


def _jax_state(d: dict, n: int) -> JaxEnvState:
    return JaxEnvState(
        physics=JaxPhysicsState(**{k: jnp.asarray(v) for k, v in d["physics"].items()}),
        key=jax.random.split(jax.random.PRNGKey(1), n),
        **{k: jnp.asarray(v) for k, v in d.items() if k != "physics"},
    )


# --------------------------------------------------------------------------- #
# (a) one general step against JAX's
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def stepped(motions, models):
    motion, jmotion = motions
    model, jmodel = models
    env = HumanoidImEnv(model, motion, EnvConfig(**VR), device="cpu")
    ids = np.array([0, 1, 2, 3])
    L = motion.motion_lengths[torch.as_tensor(ids)].numpy()
    start = np.array([1.0, 0.5, L[2] - 2e-3, 1.5], np.float32)
    st = env.reset_to(torch.as_tensor(ids), torch.as_tensor(start))
    d = _numpy_state(st)
    d["progress"] = np.array([3, 2, 0, 4], np.int32)
    # the physics at each env's time: reset_to's at the start, so shift the
    # clock back by the progress (the reference moves little in 4 steps)
    d["start_time"] = (start - d["progress"] * model.config.control_dt).astype(np.float32)
    ph = d["physics"]
    ph["root_pos"][0, 0] += 10.0                          # env 0: far
    ph["body_pos"][0, :, 0] += 10.0
    ph["root_pos"][3, 1] += 0.5                           # env 3: off its reference
    ph["body_pos"][3, :, 1] += 0.5
    rng = np.random.default_rng(0)
    d["self_obs_hist"] = (d["self_obs_hist"] + rng.normal(0, 0.1, d["self_obs_hist"].shape)).astype(np.float32)
    actions = rng.uniform(-1, 1, (B, 69)).astype(np.float32)

    jenv = JaxEnv(jmodel, jmotion, JaxEnvConfig(**VR))
    want = reference_jit(jenv.step)(_jax_state(d, B), jnp.asarray(actions))

    env._sample_reset = lambda n: (torch.tensor(np.asarray(want.motion_id), dtype=torch.long),
                                   torch.tensor(np.asarray(want.start_time)))
    got = env._step_general(env_state_from_numpy(d), torch.as_tensor(actions))
    return env, got, want, d


def test_general_step_widths_match_jax(stepped, motions, models):
    env, got, want, _ = stepped
    jenv = JaxEnv(models[1], motions[1], JaxEnvConfig(**VR))
    for name in ("self_obs_dim_single", "self_obs_dim", "task_obs_dim", "obs_dim", "amp_obs_dim"):
        assert getattr(env, name) == getattr(jenv, name), name
    np.testing.assert_array_equal(env.track_body_ids, jenv.track_body_ids)
    assert got.obs.shape == want.obs.shape == (B, 5 * 358 + 3 * 15 + 2 * 3 * 15)
    assert not env._kernel_surface()


def test_general_step_flags_match_jax(stepped):
    _, got, want, _ = stepped
    assert np.asarray(want.done).tolist() == [False, False, True, True]
    assert np.asarray(want.terminate).tolist() == [False, False, False, True]
    for f in ("done", "terminate", "motion_id", "progress"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_array_equal(got.start_time.numpy(), np.asarray(want.start_time))


@pytest.mark.parametrize("field, tol", [("obs", 1e-4), ("reward", 1e-5), ("reward_raw", 1e-4), ("amp_hist", 1e-4)])
def test_general_step_outputs_match_jax(stepped, field, tol):
    _, got, want, _ = stepped
    np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), atol=tol, rtol=0)


def test_general_step_far_env_gets_the_location_reward_and_a_point_goal(stepped):
    env, got, want, _ = stepped
    assert float(got.reward[0]) < 1e-6 and float(np.asarray(want.reward)[0]) < 1e-6   # exp(-d^2) at ~10 m
    task = got.obs[0, env.self_obs_dim:]
    assert (task[3:] == 0).all() and task[:3].norm() > 9.0


def test_general_step_rolls_the_self_obs_history(stepped):
    """The kept envs' older frames are the input's, shifted, exactly; the
    reset envs' frames are their fresh state's frame repeated; the newest
    frames agree with JAX's to the obs tolerance."""
    _, got, want, d = stepped
    h, jh = got.self_obs_hist.numpy(), np.asarray(want.self_obs_hist)
    keep = [0, 1]
    np.testing.assert_array_equal(h[keep, 1:], d["self_obs_hist"][keep, :-1])
    np.testing.assert_array_equal(jh[keep, 1:], d["self_obs_hist"][keep, :-1])
    np.testing.assert_array_equal(h[2:], np.repeat(h[2:, :1], 5, axis=1))
    np.testing.assert_allclose(h, jh, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.obs[:, :5 * 358].numpy(), h.reshape(B, -1))


# --------------------------------------------------------------------------- #
# (b) the observation of one state, per obs and self-obs version
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def obs_state(motions, models):
    """A fixed state (numpy): reference poses perturbed, random contact forces."""
    motion, _ = motions
    env = HumanoidImEnv(models[0], motion, device="cpu")
    rng = np.random.default_rng(3)
    ids = np.array([0, 1, 2, 3, 1])
    st = env.reset_to(torch.as_tensor(ids), torch.as_tensor(rng.uniform(0.2, 3.0, 5).astype(np.float32)))
    d = _numpy_state(st)
    d["progress"] = rng.integers(0, 20, 5).astype(np.int32)
    for k in ("body_pos", "body_vel", "body_ang_vel"):
        d["physics"][k] += rng.normal(0, 0.05, d["physics"][k].shape).astype(np.float32)
    d["physics"]["contact_force"] = rng.normal(0, 200, d["physics"]["contact_force"].shape).astype(np.float32)
    return d


OBS_CASES = [dict(obs_v=v, num_traj_samples=T, self_obs_v=s) for v in (6, 7, 8, 9) for T in (1, 3) for s in (1, 3)]


@pytest.fixture(scope="module")
def jax_observations(motions, models, obs_state):
    """The JAX package's `_observe` of the fixed state under every case, in
    one jit (16 jits, or 16 eager runs, would each take seconds)."""
    envs = [JaxEnv(models[1], motions[1], JaxEnvConfig(**c)) for c in OBS_CASES]
    out = reference_jit(lambda s: [jax.vmap(e._observe)(s) for e in envs])(_jax_state(obs_state, 5))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("case", range(len(OBS_CASES)),
                         ids=["v{obs_v}-T{num_traj_samples}-self{self_obs_v}".format(**c) for c in OBS_CASES])
def test_observe_general_matches_jax(motions, models, obs_state, jax_observations, case):
    env = HumanoidImEnv(models[0], motions[0], EnvConfig(**OBS_CASES[case]), device="cpu")
    want = jax_observations[case]
    got = env._observe_general(env_state_from_numpy(obs_state)).numpy()
    assert got.shape == want.shape == (5, env.obs_dim)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


# --------------------------------------------------------------------------- #
# (c) the task-obs functions
# --------------------------------------------------------------------------- #

def _unit_quats(rng, shape):
    qs = rng.normal(size=shape + (4,)).astype(np.float32)
    return qs / np.linalg.norm(qs, axis=-1, keepdims=True)


@pytest.mark.parametrize("version", [7, 8, 9])
def test_task_obs_functions_match_jax(version):
    rng = np.random.default_rng(version)
    Bn, T, J = 6, 3, 5
    args = dict(
        root_pos=rng.normal(size=(Bn, 3)), root_rot=_unit_quats(rng, (Bn,)),
        body_pos=rng.normal(size=(Bn, J, 3)), body_rot=_unit_quats(rng, (Bn, J)),
        body_vel=rng.normal(size=(Bn, J, 3)), body_ang_vel=rng.normal(size=(Bn, J, 3)),
        ref_body_pos=rng.normal(size=(Bn, T, J, 3)), ref_body_rot=_unit_quats(rng, (Bn, T, J)),
        ref_body_vel=rng.normal(size=(Bn, T, J, 3)), ref_body_ang_vel=rng.normal(size=(Bn, T, J, 3)),
        ref_root_vel=rng.normal(size=(Bn, T, 3)), ref_root_ang_vel=rng.normal(size=(Bn, T, 3)),
    )
    names = {7: ("root_pos", "root_rot", "body_pos", "body_vel", "ref_body_pos", "ref_body_vel"),
             8: ("root_pos", "root_rot", "body_pos", "body_rot", "body_vel", "body_ang_vel", "ref_body_pos",
                 "ref_body_rot", "ref_body_vel", "ref_body_ang_vel"),
             9: ("root_pos", "root_rot", "body_pos", "body_rot", "body_vel", "body_ang_vel", "ref_body_pos",
                 "ref_body_rot", "ref_root_vel", "ref_root_ang_vel")}[version]
    xs = [np.asarray(args[n], np.float32) for n in names]
    fn = f"compute_imitation_observations_v{version}"
    want = np.asarray(reference_jit(getattr(jax_kernels, fn))(*map(jnp.asarray, xs)))
    got = getattr(kernels, fn)(*map(torch.as_tensor, xs)).numpy()
    width = {7: T * J * 9, 8: J * 15 + T * J * 15, 9: T * (J * 18 + 6)}[version]
    assert got.shape == want.shape == (Bn, width)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# --------------------------------------------------------------------------- #
# (d) the port's own draws
# --------------------------------------------------------------------------- #

def test_occlusion_zeroes_one_contiguous_task_chunk(motions, models):
    cfg = EnvConfig(track_bodies=("Head", "L_Hand", "R_Hand"), occlusion_prob=0.5, occlusion_frac=0.25)
    env = HumanoidImEnv(models[0], motions[0], cfg, device="cpu")
    width = max(int(env.task_obs_dim * 0.25), 1)
    obs = 1.0 + torch.rand(400, env.obs_dim)
    out = env._perturb_obs(obs)
    zero = out == 0
    occluded = zero.any(dim=1)
    assert 0.4 < occluded.float().mean() < 0.6
    assert torch.equal(out[~occluded], obs[~occluded])
    starts = []
    for row, z in zip(out[occluded], zero[occluded]):
        cols = torch.nonzero(z).flatten()
        assert len(cols) == width and int(cols[-1] - cols[0]) == width - 1
        assert env.self_obs_dim <= int(cols[0]) and int(cols[-1]) < env.obs_dim
        starts.append(int(cols[0]) - env.self_obs_dim)
    assert min(starts) == 0 and max(starts) == env.task_obs_dim - width - 1


def test_obs_noise_has_its_std_and_spares_the_reset(motions, models):
    """Noise rides the kernel path (K1 then K2's plain versions here): the
    step's obs differ from a noise-free env's of the same seed by draws of
    std 0.05; the reset's obs do not differ at all."""
    noisy = HumanoidImEnv(models[0], motions[0], EnvConfig(obs_noise_std=0.05), device="cpu")
    clean = HumanoidImEnv(models[0], motions[0], EnvConfig(), device="cpu")
    assert noisy._fused_step_ok()
    a, b = noisy.reset(8), clean.reset(8)
    assert torch.equal(a.obs, b.obs)
    actions = torch.zeros(8, 69)
    diff = noisy.step(a, actions).obs - clean.step(b, actions).obs
    assert abs(float(diff.std()) - 0.05) < 0.002 and abs(float(diff.mean())) < 0.002


@pytest.mark.parametrize("init", ["Default", "Start", "Random", "Hybrid"])
def test_state_init_start_times(motions, models, init):
    env = HumanoidImEnv(models[0], motions[0], EnvConfig(state_init=init, hybrid_init_prob=0.3), device="cpu")
    ids, times = env._sample_reset(4000)
    L = env.motion.motion_lengths[ids]
    at_start = (times == 0).float().mean()
    assert ((times >= 0) & (times < L)).all()
    if init in ("Default", "Start"):
        assert at_start == 1.0
    elif init == "Random":
        assert at_start == 0.0 and abs(float((times / L).mean()) - 0.5) < 0.02
    else:   # time 0 where a uniform draw exceeds hybrid_init_prob
        assert abs(float(at_start) - 0.7) < 0.03
        assert abs(float((times / L)[times > 0].mean()) - 0.5) < 0.03
    assert torch.equal(env.reset_to(ids[:3], times[:3]).start_time, times[:3])


@pytest.mark.parametrize("path", ["K1", "K3-rows+RA", "getup K3+RA"])
def test_general_step_equals_the_kernel_path_on_its_surface(motions, models, path):
    """On a kernel-path config `_step_general` (plain K3 or K3-rows, then
    torch) and `step` take one state to the same step, the generator
    re-seeded before each: env=im's config (plain K1, then K2's plain
    version); per-env body scales with the shape and limb channels (K3-rows
    → RA → K2: the AMP rows' and the observation's shape columns); the
    getup env (K3 → RA → K2: its termination grace and fall resets)."""
    model, motion = models[0], motions[0]
    if path == "getup K3+RA":
        env = HumanoidImGetupEnv(model, motion, GetupConfig(num_fall_states=4, fall_settle_steps=2,
                                                            fall_init_prob=0.5), device="cpu")
    elif path == "K3-rows+RA":
        env = HumanoidImEnv(model, motion, EnvConfig(has_shape_obs=True, has_shape_obs_disc=True,
                                                     has_limb_weight_obs=True), device="cpu")
        env.enable_shape_variation(6, generator=torch.Generator().manual_seed(3))
    else:
        env = HumanoidImEnv(model, motion, EnvConfig(), device="cpu")
    assert env._kernel_surface() and env._fused_step_ok() == (path == "K1")
    st = env.reset(6)
    # envs 1 and 3 0.4 m off their reference: 1 terminates, 3 is in grace
    st = st.replace(progress=torch.tensor([0, 3, 9, 2, 5, 1], dtype=torch.int32),
                    recovery_counter=torch.tensor([0, 0, 0, 90, 0, 0], dtype=torch.int32))
    for b in (1, 3):
        st.physics.body_pos[b] += 0.4
        st.physics.root_pos[b] += 0.4
    actions = torch.rand(6, 69, generator=torch.Generator().manual_seed(0)) - 0.5
    env.generator.manual_seed(5)
    kernel = env.step(st, actions)
    env.generator.manual_seed(5)
    general = env._step_general(st, actions)
    assert kernel.terminate[1] and kernel.terminate[3] == (path != "getup K3+RA")
    for f in ("done", "terminate", "motion_id", "start_time", "progress", "recovery_counter"):
        assert torch.equal(getattr(general, f), getattr(kernel, f)), f
    for f, tol in (("reward", 1e-6), ("reward_raw", 1e-6), ("amp_hist", 1e-5), ("obs", 1e-5)):
        torch.testing.assert_close(getattr(general, f), getattr(kernel, f), atol=tol, rtol=0, msg=f)


# --------------------------------------------------------------------------- #
# (e) env=im_vr through the CLI's entry point
# --------------------------------------------------------------------------- #

def test_main_trains_env_im_vr(tmp_path):
    res = run.main(["env=im_vr", "learning=im_ppo", "device=cpu", "num_envs=8", "max_epochs=1",
                    "learning.horizon_length=4", "learning.minibatch_size=16", "learning.actor_units=[32,24]",
                    "learning.critic_units=[32,24]", f"output_dir={tmp_path}"])
    env = res.agent.env
    assert env.config.track_bodies == ("Head", "L_Hand", "R_Hand") and not env._kernel_surface()
    assert env.obs_dim == 358 + 3 * 24 and res.train_state.env_state.obs.shape == (8, 430)
    assert all(np.isfinite(v) for v in res.metrics[0].values())
    assert (tmp_path / "default" / "ckpt" / "epoch_1.pt").exists()
