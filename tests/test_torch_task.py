"""The port's downstream task envs (HumanoidSpeedEnv, HumanoidReachEnv,
HumanoidTrajEnv) against the JAX package's on the CPU: one step of each
(the port on its kernel path, the plain physics step on the CPU; JAX on
its per-env vmap with the XLA physics step), the three steps in one jit on
the JAX side, and the traj env's vertices and positions on fed draws.

The step: B = 10 envs at 1 substep of 1/120 s, episode_length 20, the same
start states, tasks and actions, the port's samplers fed the JAX side's
draws (clip, start time and the fresh task from each env's reset key; the
speed and reach switch from each env's task key). Both packages read the
JAX store's motion tables:
  envs 0, 1, 8, 9 mid clip, upright (no reset),
  envs 2, 3, 7 lying at 0.12 m with bodies in ground contact, progress 5
    (a fall: terminate),
  env 4 lying the same at progress 0 (no fall before the second step),
  env 5 at progress 18 -> 19 = episode_length - 1 (a timeout reset),
  env 6 at its change_step (speed and reach redraw their target).
Tolerances: flags and progress exactly where no non-foot body lies within
1e-4 m of the termination height or within 1e-3 of the contact threshold
(none does here); the task state exactly where it is a draw, 1e-6 where
it is computed from the root and VERTS_TOL for the traj vertices; the
reward 1e-5 (measured: 7.3e-7, speed's finite-difference velocity); the
observation 1e-4 in the envs that did not reset and 2e-4 in those that did
(a fresh state read from slerped motion tables, as in
tests/test_torch_amp_env.py); the AMP history 1e-4; the physics as in
tests/test_torch_physics.py.
"""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env.humanoid_task import (
    HumanoidReachEnv as JaxReachEnv, HumanoidSpeedEnv as JaxSpeedEnv, HumanoidTrajEnv as JaxTrajEnv,
    TaskConfig as JaxTaskConfig, TaskEnvState as JaxTaskEnvState,
)
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.motion_lib import sample_motions as jax_sample_motions, sample_time as jax_sample_time
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics.state import PhysicsState as JaxPhysicsState

from pulse_tpu_torch import _build
from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env.humanoid_task import (
    HumanoidReachEnv, HumanoidSpeedEnv, HumanoidTrajEnv, TaskConfig, task_env_state_from_numpy,
)
from pulse_tpu_torch.motion.motion_lib import MotionData
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model
from pulse_tpu_torch.physics.state import state_from_kinematics

B = 10
CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
EPISODE = 20
LYING = [2, 3, 4, 7]
PROGRESS = np.array([3, 3, 5, 5, 0, EPISODE - 2, 6, 5, 4, 2], np.int32)
SWITCH_ENV = 6           # its change_step is its post-step progress
HEIGHT = 0.15
NAMES = ("speed", "reach", "traj")
# the traj vertices (m): twice the measured 1.9e-6; bitwise equality is out
# of reach, as XLA's float32 cumsum adds in another order and its sin / cos
# differ from torch's by one ulp on ~5% of arguments
VERTS_TOL = 4e-6


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


# --------------------------------------------------------------------------- #
# the JAX package's draws, as its envs make them from their keys
# --------------------------------------------------------------------------- #

def _speed_draws(jenv, key):
    speed, change = jenv._sample_speed(key)
    return {"speed": speed, "change": change}


def _reach_draws(cfg, key):        # humanoid_task.py HumanoidReachEnv._sample_target
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {"theta": jax.random.uniform(k1, (), minval=-jnp.pi, maxval=jnp.pi),
            "r": jax.random.uniform(k2, (), minval=0.0, maxval=cfg.tar_reach_dist_max),
            "h": jax.random.uniform(k3, (), minval=cfg.tar_reach_height_min, maxval=cfg.tar_reach_height_max),
            "change": jax.random.randint(k4, (), cfg.reach_change_steps_min, cfg.reach_change_steps_max)}


def _traj_draws(cfg, key):         # humanoid_task.py HumanoidTrajEnv._gen_traj
    S = cfg.num_traj_segments
    k1, k2, k3 = jax.random.split(key, 3)
    return {"turn": jax.random.uniform(k1, (S,), minval=-1.0, maxval=1.0),
            "sharp": jax.random.uniform(k2, (S,)) < cfg.traj_sharp_turn_prob,
            "sharp_turn": jax.random.uniform(k3, (S,), minval=-jnp.pi, maxval=jnp.pi),
            "speed": jax.random.uniform(jax.random.fold_in(key, 7), (S,), minval=cfg.traj_speed_min,
                                        maxval=cfg.traj_speed_max)}


def _task_draws(name, jenv, key):
    if name == "speed":
        return _speed_draws(jenv, key)
    return (_reach_draws if name == "reach" else _traj_draws)(jenv.config, key)


def _torch_tree(d: dict) -> dict:
    return {k: torch.as_tensor(np.array(v)) for k, v in d.items()}


@pytest.fixture(scope="module")
def stepped(setup):
    model, motion, jmodel, jmotion = setup
    rng = np.random.default_rng(0)
    cfg = TaskConfig(episode_length=EPISODE)
    jcfg = JaxTaskConfig(episode_length=EPISODE)
    envs = {"speed": HumanoidSpeedEnv(model, motion, cfg, device="cpu"),
            "reach": HumanoidReachEnv(model, motion, cfg, device="cpu"),
            "traj": HumanoidTrajEnv(model, motion, cfg, device="cpu")}
    jenvs = {"speed": JaxSpeedEnv(jmodel, jmotion, jcfg), "reach": JaxReachEnv(jmodel, jmotion, jcfg),
             "traj": JaxTrajEnv(jmodel, jmotion, jcfg)}

    # shared start physics and AMP history: reference-state inits mid clip,
    # then the lying bodies
    ids = np.arange(B) % 4
    start = rng.uniform(0.5, 2.5, B).astype(np.float32)
    base = envs["traj"]._fresh(torch.as_tensor(ids), torch.as_tensor(start), envs["traj"]._sample_task(B))
    physics = {f.name: getattr(base.physics, f.name).numpy().copy() for f in dataclasses.fields(base.physics)}
    for k, v in _lying(model, len(LYING), rng).items():
        physics[k][LYING] = v
    root = physics["root_pos"]
    change = np.where(np.arange(B) == SWITCH_ENV, PROGRESS + 1, 150).astype(np.int32)
    tasks = {
        "speed": {"tar_speed": rng.uniform(0, 5, B).astype(np.float32), "change_step": change},
        "reach": {"tar_pos": (root + rng.uniform(-0.8, 0.8, (B, 3))).astype(np.float32), "change_step": change},
        "traj": {"verts": envs["traj"]._gen_traj(envs["traj"]._sample_task(B),
                                                 torch.as_tensor(root[:, :2])).numpy()},
    }
    actions = rng.uniform(-1, 1, (B, 69)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    task_keys = jax.random.split(jax.random.PRNGKey(4), B)

    states, jstates = {}, {}
    for name, env in envs.items():
        d = {"physics": physics, "progress": PROGRESS, "task": tasks[name],
             "obs": np.zeros((B, env.obs_dim), np.float32), "reward": np.zeros(B, np.float32),
             "reward_raw": np.zeros((B, 1), np.float32), "done": np.zeros(B, bool), "terminate": np.zeros(B, bool),
             "amp_hist": base.amp_hist.numpy()}
        states[name] = d
        jtask = {k: jnp.asarray(v) for k, v in tasks[name].items()}
        if name != "traj":
            jtask["key"] = task_keys
        jstates[name] = JaxTaskEnvState(
            physics=JaxPhysicsState(**{k: jnp.asarray(v) for k, v in physics.items()}), key=keys,
            task=jtask, **{k: jnp.asarray(v) for k, v in d.items() if k not in ("physics", "task")})
    step = jax.jit(lambda s, a: {n: jenvs[n].step(s[n], a) for n in NAMES})
    want = step(jstates, jnp.asarray(actions))

    def reset_draws(key):          # humanoid_task.py step_one's k_reset, then reset_one's split
        k_motion, k_time, k_task, _ = jax.random.split(jax.random.split(key)[0], 4)
        mid = jax_sample_motions(k_motion, jmotion, 1)[0]
        return mid, jax_sample_time(k_time, jmotion, mid[None])[0], k_task

    mids, t0s, k_tasks = jax.vmap(reset_draws)(keys)
    # the reset envs' AMP window, computed eagerly (see test_step_outputs_match_jax)
    fresh_hist = np.asarray(jax.vmap(jenvs["speed"]._init_amp_hist)(mids, t0s))
    got = {}
    before = dict(_build.launches)
    for name, env in envs.items():
        jenv = jenvs[name]
        fresh = _torch_tree(jax.vmap(lambda k: _task_draws(name, jenv, k))(k_tasks))
        env._sample_reset = lambda n, fresh=fresh: (torch.as_tensor(np.array(mids), dtype=torch.long),
                                                    torch.as_tensor(np.array(t0s)), fresh)
        if name != "traj":
            switch = _torch_tree(jax.vmap(lambda k: _task_draws(name, jenv, jax.random.split(k)[0]))(task_keys))
            env._sample_switch = lambda n, switch=switch: switch
        got[name] = env.step(task_env_state_from_numpy(states[name]), torch.as_tensor(actions))
    assert _build.launches == before     # the CPU runs the plain versions
    return envs, jenvs, got, want, states, fresh_hist


def test_widths_and_config_defaults(stepped):
    envs = stepped[0]
    for name, env in envs.items():
        assert env.self_obs_dim == 358 and env.amp_obs_dim_single == 232 and env.amp_obs_dim == 2320
        assert env.action_dim == 69
    assert (envs["speed"].obs_dim, envs["reach"].obs_dim, envs["traj"].obs_dim) == (361, 361, 378)
    assert envs["reach"].reach_body_id == envs["reach"].body_names.index("R_Hand")
    port = dataclasses.asdict(TaskConfig())
    want = dataclasses.asdict(JaxTaskConfig())
    assert port.keys() == want.keys() and all(tuple(port[k]) == tuple(want[k]) if isinstance(port[k], tuple)
                                              else port[k] == want[k] for k in port)
    assert envs["speed"].with_config(TaskConfig(episode_length=7)).config.episode_length == 7


@pytest.mark.parametrize("name", NAMES)
def test_step_flags_match_jax(stepped, name):
    envs, _, got, want, _, _ = stepped
    g, w = got[name], want[name]
    nc = envs[name].non_contact_body_ids.numpy()
    ph = np.asarray(w.physics.body_pos)[:, nc, 2]
    cf = np.abs(np.asarray(w.physics.contact_force)[:, nc])
    assert not ((np.abs(ph - HEIGHT) < 1e-4).any(1) | (np.abs(cf - 0.1) < 1e-3).any((1, 2))).any()
    term, done = np.asarray(w.terminate), np.asarray(w.done)
    assert term[[2, 3, 7]].all() and not term[[0, 1, 4, 5, 6, 8, 9]].any()
    assert done[[2, 3, 5, 7]].all() and not done[[0, 1, 4, 6, 8, 9]].any()
    for f in ("done", "terminate", "progress"):
        np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)), err_msg=f)


@pytest.mark.parametrize("name", NAMES)
def test_step_task_state_matches_jax(stepped, name):
    """The switch fires in env 6 alone; reach redraws around the post-step
    root; the reset envs take the fresh task."""
    _, _, got, want, states, _ = stepped
    g, w, before = got[name].task, want[name].task, states[name]["task"]
    assert set(g) == set(w) - {"key"}
    for k in g:
        tol = {"tar_pos": 1e-6, "verts": VERTS_TOL}.get(k, 0)
        np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=0, atol=tol, err_msg=k)
    if name != "traj":
        done = np.asarray(want[name].done)
        changed = (g["change_step"].numpy() != before["change_step"]) & ~done
        assert changed.tolist() == [i == SWITCH_ENV for i in range(B)]


@pytest.mark.parametrize("name", NAMES)
def test_step_outputs_match_jax(stepped, name):
    """The reset envs' AMP window is held against the JAX package's eager
    `_init_amp_hist`: its jitted step reads one of them (env 3, the oldest
    row, both ankles) as a 0.0086 rad flexion where its eager run and the
    port read none. The slerped local rotation there has w = 1.000012 (the
    motion tables' quaternions have norm 1.00002), which quat_to_angle_axis
    clips to 1, angle 0; XLA's fused jit rounds w to 0.99999 instead."""
    _, _, got, want, _, fresh_hist = stepped
    g, w = got[name], want[name]
    np.testing.assert_allclose(g.reward.numpy(), np.asarray(w.reward), rtol=0, atol=1e-5)
    np.testing.assert_allclose(g.reward_raw.numpy(), np.asarray(w.reward_raw), rtol=0, atol=1e-5)
    assert ((g.reward >= 0) & (g.reward <= 1)).all()
    done = np.asarray(w.done)
    np.testing.assert_allclose(g.obs.numpy()[~done], np.asarray(w.obs)[~done], rtol=0, atol=1e-4)
    np.testing.assert_allclose(g.obs.numpy()[done], np.asarray(w.obs)[done], rtol=0, atol=2e-4)
    np.testing.assert_allclose(g.amp_hist.numpy()[~done], np.asarray(w.amp_hist)[~done], rtol=0, atol=1e-4)
    np.testing.assert_allclose(g.amp_hist.numpy()[done], fresh_hist[done], rtol=0, atol=1e-4)
    torch.testing.assert_close(g.amp_obs, g.amp_hist.flatten(1), rtol=0, atol=0)


@pytest.mark.parametrize("field,atol", [
    ("root_pos", 2e-4), ("root_rot", 2e-4), ("body_pos", 3e-4), ("body_rot", 2e-4),
    ("root_vel6", 5e-3), ("joint_omega", 5e-3), ("body_vel", 5e-3), ("body_ang_vel", 5e-3),
    ("contact_force", 1.0),
])
def test_step_physics_matches_jax(stepped, field, atol):
    _, _, got, want, _, _ = stepped
    for name in NAMES:
        np.testing.assert_allclose(getattr(got[name].physics, field).numpy(),
                                   np.asarray(getattr(want[name].physics, field)), rtol=0, atol=atol, err_msg=name)


def test_traj_vertices_and_positions_match_jax(setup):
    """On fed draws: the vertices, and positions inside, between and past the
    segments (clipped to the last), within VERTS_TOL."""
    model, motion, jmodel, jmotion = setup
    env = HumanoidTrajEnv(model, motion, TaskConfig(), device="cpu")
    jenv = JaxTrajEnv(jmodel, jmotion, JaxTaskConfig())
    keys = jax.random.split(jax.random.PRNGKey(9), 6)
    start = np.random.default_rng(2).uniform(-3, 3, (6, 2)).astype(np.float32)
    want = jax.vmap(jenv._gen_traj)(keys, jnp.asarray(start))
    draws = _torch_tree(jax.vmap(lambda k: _traj_draws(jenv.config, k))(keys))
    assert draws["sharp"].any() and not draws["sharp"].all()
    verts = env._gen_traj(draws, torch.as_tensor(start))
    np.testing.assert_allclose(verts.numpy(), np.asarray(want), rtol=0, atol=VERTS_TOL)
    t = np.array([[0.0, 0.7, 2.0, 5.3, 15.99, 40.0]] * 6, np.float32) + np.arange(6, dtype=np.float32)[:, None]
    want_pos = jax.vmap(jenv._traj_pos)(want, jnp.asarray(t))
    np.testing.assert_allclose(env._traj_pos(verts, torch.as_tensor(t)).numpy(), np.asarray(want_pos), rtol=0,
                               atol=VERTS_TOL)
    want_one = jax.vmap(jenv._traj_pos)(want, jnp.asarray(t[:, 1]))
    np.testing.assert_allclose(env._traj_pos(verts, torch.as_tensor(t[:, 1])).numpy(), np.asarray(want_one), rtol=0,
                               atol=VERTS_TOL)


def test_reset_amp_hist_and_obs(setup):
    """A reset draws its clips and times from the env's generator; the AMP
    window is the clip's disc obs at max(t0 - k dt, 0); the task obs at
    progress 0; the same seed gives the same reset."""
    model, motion = setup[:2]
    env = HumanoidSpeedEnv(model, motion, TaskConfig(), device="cpu", seed=5)
    st = env.reset(6)
    assert st.obs.shape == (6, 361) and st.amp_hist.shape == (6, 10, 232) and st.progress.dtype == torch.int32
    assert st.task["change_step"].dtype == torch.int32
    assert ((st.task["change_step"] >= 100) & (st.task["change_step"] < 200)).all()
    torch.testing.assert_close(st.obs[:, -1], st.task["tar_speed"], rtol=0, atol=0)
    again = HumanoidSpeedEnv(model, motion, TaskConfig(), device="cpu", seed=5).reset(6)
    torch.testing.assert_close(again.obs, st.obs, rtol=0, atol=0)
    ids, t0, draws = HumanoidSpeedEnv(model, motion, TaskConfig(), device="cpu", seed=5)._sample_reset(6)
    fresh = env._fresh(ids, t0, draws)
    torch.testing.assert_close(fresh.amp_hist, st.amp_hist, rtol=0, atol=0)
    t_first = torch.clamp(t0 - 9 * model.config.control_dt, min=0.0)
    from pulse_tpu_torch.motion.motion_lib import get_motion_state
    row = env.amp_obs_from_motion_state(get_motion_state(motion, ids, t_first))
    torch.testing.assert_close(st.amp_hist[:, -1], row, rtol=0, atol=0)


def test_power_reward_and_terrain(setup):
    """The power penalty (off by default, as run.py never sets it) lowers the
    reward by the PD torque proxy's energy; a terrain model takes the plain
    route (no kernel covers terrain), and on a flat heightfield it steps as
    the plane does."""
    model, motion = setup[:2]
    env = HumanoidReachEnv(model, motion, TaskConfig(), device="cpu", seed=1)
    penv = HumanoidReachEnv(model, motion, TaskConfig(power_reward=True), device="cpu", seed=1)
    act = torch.full((4, 69), 0.3)
    a, b = env.step(env.reset(4), act), penv.step(penv.reset(4), act)
    assert (b.reward < a.reward).all() and torch.equal(a.reward_raw, b.reward_raw)
    assert env.physics_route == "kernel"
    flat = model.with_terrain(np.zeros((8, 8), np.float32), 1.0, (-4.0, -4.0))
    tenv = HumanoidReachEnv(flat, motion, TaskConfig(), device="cpu", seed=1)
    assert tenv.physics_route == "plain" and flat.has_terrain and not model.has_terrain
    c = tenv.step(tenv.reset(4), act)
    torch.testing.assert_close(c.reward, a.reward, rtol=0, atol=1e-6)
    torch.testing.assert_close(c.obs, a.obs, rtol=0, atol=1e-5)


def test_speed_obs_reads_the_heading(setup):
    """The task obs is the heading-local +x and the target: a root turned by
    yaw a sees +x at -a."""
    model, motion = setup[:2]
    env = HumanoidSpeedEnv(model, motion, TaskConfig(), device="cpu")
    st = env.reset(3)
    yaw = torch.tensor([0.0, math.pi / 2, -0.6])
    rot = torch.stack([torch.zeros(3), torch.zeros(3), torch.sin(yaw / 2), torch.cos(yaw / 2)], dim=-1)
    st = st.replace(physics=st.physics.replace(root_rot=rot))
    obs = env._task_obs(st)
    torch.testing.assert_close(obs[:, :2], torch.stack([torch.cos(-yaw), torch.sin(-yaw)], dim=-1), rtol=0,
                               atol=1e-6)
