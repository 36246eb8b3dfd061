"""The envs whose physics take the plain route (no kernel covers them, as
no TPU kernel does), against the JAX package's on the CPU: terrain
(`env/terrain.py`), terrain contact, self collision, the pedestrian-terrain
env and the strike env.

(a) Host data, exactly: `generate_heightfield` bit for bit (three configs
    and seeds), the walkable maps and table, the grid sensor.
(b) Queries: `terrain_height` and `terrain_normal` at points inside, on
    and outside the field: 1e-6; `plane_contact_forces` on terrain with
    points in and out of contact: forces 1e-3 (N, of up to ~1e3),
    `self_collision_forces` on bent poses with touching limbs: 1e-3.
(c) One JAX jit holds the rest: one step of HumanoidPedestrianTerrainEnv
    on its generated field (8 x 8 tiles of 8 m at 0.25 m cells) over a
    self-collision model, and one step
    of HumanoidStrikeEnv. B = 6 envs each at 1 substep of 1/120 s,
    episode_length 20, from the port's resets, the port's draws for the
    steps' resets fed the JAX side's (clip, start time, spawn cell and
    trajectory, or the box's angle and distance, from each env's keys).
    Terrain:
      envs 0, 1 mid clip on the terrain (no reset),
      env 2 lying 0.12 m above the ground under it, on a walkable cell
        0.5 m or more above 0: a fall only on the terrain-relative check,
      env 3 lying the same at progress 0 (no fall before the second step),
      env 4 at progress 18 -> 19 = episode_length - 1 (a timeout reset),
      env 5 a strongly bent pose 1 m above flat ground (limbs touching: the
        self contacts, no ground contact).
    Strike:
      envs 0, 1 mid clip, the box 1.2-2.5 m away (the approach term),
      env 2 with the box against its right hand (two-way contact),
      env 3 with the box already tipped on its side (the reward is 1),
      env 4 lying at 0.12 m with bodies in ground contact, progress 5 (a fall),
      env 5 at progress 18 -> 19 = episode_length - 1 (a timeout reset).
    Tolerances: flags and progress exactly; the reset envs' spawn,
    trajectory and box 4e-6 (tests/test_torch_task.py's VERTS_TOL) and the
    spawn's body positions 1e-5 (the FK of a slerped pose, measured
    6.9e-6); the terrain reward 1e-5, the strike reward and its two terms
    1e-4 (the stepped box's pose enters them, and the approach speed
    divides the root's step by dt); the self and traj obs and the strike
    obs 4e-4, about twice the measured 1.69e-4 (the lying envs' body
    angular velocities, read as stepped, as in tests/test_torch_mcp.py),
    the height map the root height's 2e-4 (it reads the stepped root
    height as it is); the physics and the box's pose and velocities as
    tests/test_torch_task.py's in every env, the box's contact force 1.0 N;
    `flip_task_obs` 1e-6.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env import terrain as jterrain
from pulse_tpu.env.humanoid_strike import HumanoidStrikeEnv as JaxStrikeEnv
from pulse_tpu.env.humanoid_task import TaskConfig as JaxTaskConfig, TaskEnvState as JaxTaskEnvState
from pulse_tpu.env.humanoid_terrain import HumanoidPedestrianTerrainEnv as JaxTerrainEnv
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.motion_lib import sample_motions as jax_sample_motions, sample_time as jax_sample_time
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics.contact import plane_contact_forces as jax_contact
from pulse_tpu.physics.prop import PropState as JaxPropState
from pulse_tpu.physics.self_collision import self_collision_forces as jax_self_collision
from pulse_tpu.physics.state import PhysicsState as JaxPhysicsState

from test_torch_task import VERTS_TOL, _lying, _traj_draws

from jax_reference import module_reference_compiles, reference_jit
from torch_close import assert_close

from pulse_tpu_torch import _build
from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env import kernels, terrain
from pulse_tpu_torch.env.humanoid_strike import HumanoidStrikeEnv
from pulse_tpu_torch.env.humanoid_task import TaskConfig, task_env_state_from_numpy
from pulse_tpu_torch.env.humanoid_terrain import HumanoidPedestrianTerrainEnv
from pulse_tpu_torch.motion.motion_lib import MotionData
from pulse_tpu_torch.physics import substep_cuda
from pulse_tpu_torch.physics.contact import plane_contact_forces
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model
from pulse_tpu_torch.physics.prop import PropState
from pulse_tpu_torch.physics.self_collision import self_collision_forces
from pulse_tpu_torch.physics.state import physics_state_from_numpy, state_from_kinematics
from pulse_tpu_torch.physics.step import physics_step

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

B = 6
CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
EPISODE = 20
PROGRESS = np.array([3, 4, 5, 0, EPISODE - 2, 2], np.int32)
STRIKE_PROGRESS = np.array([3, 4, 2, 6, 5, EPISODE - 2], np.int32)
HEIGHT = 0.15
CELL, ORIGIN = 0.25, (-5.0, -5.0)
PHYS_TOL = {"root_pos": 2e-4, "root_rot": 2e-4, "body_pos": 3e-4, "body_rot": 2e-4, "root_vel6": 5e-3,
            "joint_omega": 5e-3, "body_vel": 5e-3, "body_ang_vel": 5e-3, "contact_force": 1.0}
PROP_TOL = {"pos": 2e-4, "rot": 2e-4, "lin_vel": 5e-3, "ang_vel": 5e-3}


def _heightmap() -> np.ndarray:
    i, j = np.meshgrid(np.arange(40), np.arange(40), indexing="ij")
    return (0.15 * (1 + np.sin(0.35 * i)) + 0.01 * j).astype(np.float32)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


@pytest.fixture(scope="module")
def setup():
    jspec = jax_load_smpl()
    jm = jax_build_motion_data(jspec.skeleton, jax_clips(jspec.skeleton, 4))
    fields = {f.name: torch.float32 for f in dataclasses.fields(MotionData)}
    fields.update(length_starts=torch.long, motion_num_frames=torch.long)
    motion = MotionData(**{k: torch.tensor(np.asarray(getattr(jm, k)), dtype=dt) for k, dt in fields.items()})
    spec = load_smpl_humanoid()
    return dict(spec=spec, jspec=jspec, motion=motion, jm=jm, model=build_model(spec, PhysicsConfig(**CFG), device="cpu"),
                jmodel=jax_build_model(jspec, JaxPhysicsConfig(**CFG)))


# --------------------------------------------------------------------------- #
# (a) host data
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("cfg, seed", [
    ({}, 0), ({"num_tiles_x": 3, "num_tiles_y": 5, "tile_size": 4.0}, 7),
    ({"num_tiles_x": 4, "num_tiles_y": 2, "cell_size": 0.5, "p_flat": 0.0}, 3),
])
def test_generate_heightfield_is_bit_equal(cfg, seed):
    got = terrain.generate_heightfield(terrain.TerrainConfig(**cfg), seed)
    want = jterrain.generate_heightfield(jterrain.TerrainConfig(**cfg), seed)
    assert got.dtype == want.dtype and np.array_equal(got, want) and np.ptp(got) > 0
    assert dataclasses.asdict(terrain.TerrainConfig(**cfg)) == dataclasses.asdict(jterrain.TerrainConfig(**cfg))


def test_grid_walkable_maps_and_table_equal_jax():
    assert np.array_equal(terrain.height_map_points(), jterrain.height_map_points())
    assert np.array_equal(terrain.height_map_points(5, 7, 0.3), jterrain.height_map_points(5, 7, 0.3))
    cfg = terrain.TerrainConfig(num_tiles_x=2, num_tiles_y=3)
    hm = terrain.generate_heightfield(cfg, 4)
    assert np.array_equal(terrain.walkable_map_from_heightfield(hm, 0.25, 0.2),
                          jterrain.walkable_map_from_heightfield(hm, 0.25, 0.2))
    got = terrain.GeneratedTerrain.generate(cfg, 4, device="cpu")
    want = jterrain.GeneratedTerrain.generate(jterrain.TerrainConfig(num_tiles_x=2, num_tiles_y=3), 4)
    for f in ("heights", "walkable_xy", "origin"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    idx = torch.tensor([0, 3, 3, len(got.walkable_xy) - 1])
    assert torch.equal(got.sample_valid_locations(4, idx=idx), got.walkable_xy[idx])
    drawn = got.sample_valid_locations(50, generator=torch.Generator().manual_seed(1))
    assert drawn.shape == (50, 2) and all((got.walkable_xy == p).all(-1).any() for p in drawn)


# --------------------------------------------------------------------------- #
# (b) queries and forces
# --------------------------------------------------------------------------- #

def test_height_and_normal_match_jax():
    hm = _heightmap()
    xy = np.random.default_rng(2).uniform(-7, 7, (3, 50, 2)).astype(np.float32)
    xy[0, :3] = [[-5.0, -5.0], [4.75, 4.75], [9.0, -9.0]]    # the corners, and outside
    args = (torch.as_tensor(hm), CELL, torch.tensor(ORIGIN), torch.as_tensor(xy))
    jargs = (jnp.asarray(hm), CELL, jnp.asarray(ORIGIN, jnp.float32), jnp.asarray(xy))
    np.testing.assert_allclose(terrain.terrain_height(*args).numpy(), np.asarray(jterrain.terrain_height(*jargs)),
                               rtol=0, atol=1e-6)
    n = terrain.terrain_normal(*args)
    np.testing.assert_allclose(n.numpy(), np.asarray(jterrain.terrain_normal(*jargs)), rtol=0, atol=1e-6)
    assert n[..., 2].min() < 0.99 and torch.allclose(torch.linalg.vector_norm(n, dim=-1), torch.ones(3, 50))


def _bent_states(setup, n, seed, z=None):
    """n reference-pose humanoids with strongly bent joints (limbs touching),
    velocities random, as numpy arrays and a port state."""
    model, rng = setup["model"], np.random.default_rng(seed)
    pos = np.concatenate([rng.uniform(-3, 3, (n, 2)), np.full((n, 1), 0.9 if z is None else z)], 1).astype(np.float32)
    rot = np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1))
    dof = (1.2 * rng.standard_normal((n, model.num_dof))).astype(np.float32)
    st = state_from_kinematics(model, torch.as_tensor(pos), torch.as_tensor(rot), torch.as_tensor(dof),
                               torch.as_tensor(rng.normal(0, 0.5, (n, 3)).astype(np.float32)),
                               torch.as_tensor(rng.normal(0, 0.5, (n, 3)).astype(np.float32)),
                               torch.as_tensor(rng.normal(0, 1.0, (n, model.num_dof)).astype(np.float32)))
    return st, {f.name: getattr(st, f.name).numpy() for f in dataclasses.fields(st)}


def test_terrain_contact_and_self_collision_forces_match_jax(setup):
    model = setup["model"].with_terrain(_heightmap(), CELL, ORIGIN)
    jmodel = setup["jmodel"].with_terrain(_heightmap(), CELL, ORIGIN)
    # lying 0.12 m above the ground under the root, moving
    lie = _lying(model, 4, np.random.default_rng(3))
    gz = terrain.terrain_height(model.terrain_heights, CELL, model.terrain_origin,
                                torch.as_tensor(lie["body_pos"][:, 0, :2])).numpy()
    lie["body_pos"][..., 2] += gz[:, None]
    lie["body_vel"] = np.random.default_rng(4).normal(0, 0.5, lie["body_vel"].shape).astype(np.float32)
    b = {k: torch.as_tensor(lie[k]) for k in ("body_pos", "body_rot", "body_vel", "body_ang_vel")}
    f, net = plane_contact_forces(model, b["body_pos"], b["body_rot"], b["body_vel"], b["body_ang_vel"])
    wf, wnet = jax.vmap(lambda p, r, v, w: jax_contact(jmodel, p, r, v, w))(
        *(jnp.asarray(lie[k]) for k in ("body_pos", "body_rot", "body_vel", "body_ang_vel")))
    assert (np.abs(np.asarray(wnet)).sum((1, 2)) > 1.0).all(), "an env out of ground contact"
    st, d = _bent_states(setup, 4, 3)
    np.testing.assert_allclose(f.numpy(), np.asarray(wf), rtol=0, atol=1e-3)
    np.testing.assert_allclose(net.numpy(), np.asarray(wnet), rtol=0, atol=1e-3)
    m = setup["model"]
    fs = self_collision_forces(m, m.cap_p0, m.cap_p1, m.cap_r, st.body_pos, st.body_rot, st.body_vel,
                               st.body_ang_vel)
    jm = setup["jmodel"]
    ws = jax.vmap(lambda p, r, v, w: jax_self_collision(jm, jm.cap_p0, jm.cap_p1, jm.cap_r, p, r, v, w))(
        *(jnp.asarray(d[k]) for k in ("body_pos", "body_rot", "body_vel", "body_ang_vel")))
    assert (np.abs(np.asarray(ws)).sum((1, 2)) > 1.0).all(), "a pose without self contact"
    np.testing.assert_allclose(fs.numpy(), np.asarray(ws), rtol=0, atol=1e-3)
    for k in ("cap_p0", "cap_p1", "cap_r"):
        assert np.array_equal(getattr(m, k).numpy(), np.asarray(getattr(jm, k))), k


# --------------------------------------------------------------------------- #
# (c) the env and the physics steps, one jit
# --------------------------------------------------------------------------- #

def _reset_draws(jenv, key):
    """The JAX terrain env's reset_one draws from `key`: clip, start time,
    spawn cell, trajectory."""
    k_motion, k_time, _, k_next = jax.random.split(key, 4)
    mid = jax_sample_motions(k_motion, jenv.motion, 1)[0]
    t0 = jax_sample_time(k_time, jenv.motion, mid[None])[0]
    k1, _ = jax.random.split(jax.random.fold_in(k_next, 3))
    spawn = jax.random.randint(k1, (1,), 0, jenv.terrain.walkable_xy.shape[0])[0]
    return mid, t0, spawn, _traj_draws(jenv.config, jax.random.fold_in(k_next, 4))


def _feed(env, draws):
    mid, t0, spawn, traj = draws
    fed = {k: torch.as_tensor(np.array(v)) for k, v in traj.items()}
    fed["spawn"] = torch.as_tensor(np.array(spawn), dtype=torch.long)
    env._sample_reset = lambda n: (torch.as_tensor(np.array(mid), dtype=torch.long), torch.as_tensor(np.array(t0)),
                                   fed)


def _strike_draws(jenv, key):
    """The JAX strike env's reset_one draws from `key`."""
    k_motion, k_time, k_task, _ = jax.random.split(key, 4)
    mid = jax_sample_motions(k_motion, jenv.motion, 1)[0]
    t0 = jax_sample_time(k_time, jenv.motion, mid[None])[0]
    k1, k2 = jax.random.split(k_task)
    return mid, t0, {"theta": jax.random.uniform(k1, (), minval=-jnp.pi, maxval=jnp.pi),
                     "dist": jax.random.uniform(k2, (), minval=1.2, maxval=2.5)}


def _feed_strike(env, draws):
    mid, t0, task = draws
    fed = {k: torch.as_tensor(np.array(v)) for k, v in task.items()}
    env._sample_reset = lambda n: (torch.as_tensor(np.array(mid), dtype=torch.long), torch.as_tensor(np.array(t0)),
                                   fed)


def _jax_task_state(d, task, keys):
    return JaxTaskEnvState(physics=JaxPhysicsState(**{k: jnp.asarray(v) for k, v in d["physics"].items()}), key=keys,
                           task=task, **{k: jnp.asarray(v) for k, v in d.items() if k not in ("physics", "task")})


def _terrain_case(setup, rng):
    """(port env, JAX env, start state, numpy state, JAX state, keys) of the
    terrain step."""
    model = build_model(setup["spec"], PhysicsConfig(self_collision=True, **CFG), device="cpu")
    jmodel = jax_build_model(setup["jspec"], JaxPhysicsConfig(self_collision=True, **CFG))
    env = HumanoidPedestrianTerrainEnv(model, setup["motion"], TaskConfig(episode_length=EPISODE), device="cpu")
    jenv = JaxTerrainEnv(jmodel, setup["jm"], JaxTaskConfig(episode_length=EPISODE))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    _feed(env, jax.vmap(lambda k: _reset_draws(jenv, k))(jax.random.split(jax.random.PRNGKey(5), B)))
    start = env.reset(B)
    physics = {f.name: getattr(start.physics, f.name).numpy().copy() for f in dataclasses.fields(start.physics)}
    # envs 2 and 3 lying 0.12 m above high walkable ground, env 5 bent in the air
    walk = env.terrain.walkable_xy
    high = walk[env._ground_z(walk) > 0.5].numpy()
    xy = high[rng.choice(len(high), 2, replace=False)]
    lie = _lying(model, 2, rng)
    gz = env._ground_z(torch.as_tensor(xy)).numpy()
    for k, v in lie.items():
        physics[k][[2, 3]] = v
    shift = np.concatenate([xy - lie["root_pos"][:, :2], gz[:, None]], 1)
    physics["root_pos"][[2, 3]] += shift
    physics["body_pos"][[2, 3]] += shift[:, None]
    # env 5 bent, 1 m above a walkable cell whose ground varies < 1 cm within 1.5 m
    offs = torch.stack(torch.meshgrid(torch.linspace(-1.5, 1.5, 7), torch.linspace(-1.5, 1.5, 7), indexing="ij"), -1)
    around = env._ground_z(walk[:, None] + offs.reshape(1, -1, 2))
    flat = walk[(around.amax(1) - around.amin(1)) < 0.01][0]
    _, bent = _bent_states(setup, 1, 8, z=1.0 + float(env._ground_z(flat[None])[0]))
    for k, v in bent.items():
        physics[k][5] = v[0]
    lift = np.concatenate([flat.numpy() - bent["root_pos"][0, :2], [0.0]]).astype(np.float32)
    physics["root_pos"][5] += lift
    physics["body_pos"][5] += lift
    d = {"physics": physics, "progress": PROGRESS, "task": {"verts": start.task["verts"].numpy()},
         "obs": np.zeros((B, env.obs_dim), np.float32), "reward": np.zeros(B, np.float32),
         "reward_raw": np.zeros((B, 1), np.float32), "done": np.zeros(B, bool), "terminate": np.zeros(B, bool),
         "amp_hist": start.amp_hist.numpy()}
    return env, jenv, start, d, _jax_task_state(d, {"verts": jnp.asarray(d["task"]["verts"])}, keys), keys


def _strike_case(setup, rng):
    """The same for the strike step, on the flat model."""
    env = HumanoidStrikeEnv(setup["model"], setup["motion"], TaskConfig(episode_length=EPISODE), device="cpu")
    jenv = JaxStrikeEnv(setup["jmodel"], setup["jm"], JaxTaskConfig(episode_length=EPISODE))
    keys = jax.random.split(jax.random.PRNGKey(13), B)
    _feed_strike(env, jax.vmap(lambda k: _strike_draws(jenv, k))(jax.random.split(jax.random.PRNGKey(15), B)))
    start = env.reset(B)
    physics = {f.name: getattr(start.physics, f.name).numpy().copy() for f in dataclasses.fields(start.physics)}
    for k, v in _lying(setup["model"], 1, rng).items():
        physics[k][4] = v[0]
    prop = {f.name: getattr(start.task["prop"], f.name).numpy().copy() for f in dataclasses.fields(PropState)}
    hand = env.body_names.index("R_Hand")
    prop["pos"][2] = physics["body_pos"][2, hand] + np.array([0.2, 0.0, 0.0], np.float32)
    prop["pos"][2, 2] = 0.9
    prop["rot"][3] = [np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4)]    # tipped on its side
    prop["pos"][3, 2] = 0.25
    prev = (physics["root_pos"] - rng.uniform(-0.03, 0.03, (B, 3))).astype(np.float32)
    d = {"physics": physics, "progress": STRIKE_PROGRESS, "task": {}, "obs": np.zeros((B, env.obs_dim), np.float32),
         "reward": np.zeros(B, np.float32), "reward_raw": np.zeros((B, 2), np.float32), "done": np.zeros(B, bool),
         "terminate": np.zeros(B, bool), "amp_hist": start.amp_hist.numpy()}
    state = task_env_state_from_numpy(d).replace(task={
        "prop": PropState(**{k: torch.as_tensor(v) for k, v in prop.items()}),
        "prop_contact": torch.zeros(B, 3), "prev_root_pos": torch.as_tensor(prev)})
    jtask = {"prop": JaxPropState(**{k: jnp.asarray(v) for k, v in prop.items()}), "prop_contact": jnp.zeros((B, 3)),
             "prev_root_pos": jnp.asarray(prev)}
    return env, jenv, start, state, _jax_task_state(d, jtask, keys), keys


@pytest.fixture(scope="module")
def stepped(setup):
    rng = np.random.default_rng(0)
    env, jenv, start, d, jstate, keys = _terrain_case(setup, rng)
    senv, sjenv, sstart, sstate, sjstate, skeys = _strike_case(setup, rng)
    actions = rng.uniform(-1, 1, (B, 69)).astype(np.float32)
    sactions = rng.uniform(-1, 1, (B, 69)).astype(np.float32)
    want, swant = _np_tree(reference_jit(lambda s, a, ss, sa: (jenv.step(s, a), sjenv.step(ss, sa)))(
        jstate, jnp.asarray(actions), sjstate, jnp.asarray(sactions)))
    _feed(env, jax.vmap(lambda k: _reset_draws(jenv, jax.random.split(k)[0]))(keys))
    _feed_strike(senv, jax.vmap(lambda k: _strike_draws(sjenv, jax.random.split(k)[0]))(skeys))
    before = dict(_build.launches)
    got = env.step(task_env_state_from_numpy(d), torch.as_tensor(actions))
    sgot = senv.step(sstate, torch.as_tensor(sactions))
    assert _build.launches == before
    return dict(env=env, jenv=jenv, start=start, got=got, want=want, d=d, actions=actions,
                strike=dict(env=senv, jenv=sjenv, start=sstart, got=sgot, want=swant))


def test_routes_widths_and_config(stepped):
    env = stepped["env"]
    assert env.physics_route == "plain" and not substep_cuda.supported(env.model)
    assert env.obs_dim == 358 + 20 + 256 == stepped["jenv"].obs_dim and env.height_map_dim == 256
    assert env.model.config.self_collision and env.model.has_terrain
    again = env.with_config(dataclasses.replace(env.config, enable_early_termination=False))
    assert again.obs_dim == env.obs_dim and torch.equal(again.model.terrain_heights, env.model.terrain_heights)


def test_reset_spawns_on_walkable_cells_on_the_ground(stepped):
    """The step's reset envs (2 and 4) are fresh states from the fed draws:
    spawn, lift, trajectory and observation as the JAX package's."""
    done = stepped["want"].done
    got, want = stepped["got"], stepped["want"]
    np.testing.assert_allclose(got.physics.root_pos.numpy()[done], want.physics.root_pos[done], rtol=0,
                               atol=VERTS_TOL)
    np.testing.assert_allclose(got.physics.body_pos.numpy()[done], want.physics.body_pos[done], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.task["verts"].numpy()[done], want.task["verts"][done], rtol=0, atol=VERTS_TOL)
    np.testing.assert_allclose(got.obs.numpy()[done], want.obs[done], rtol=0, atol=2e-4)
    assert (got.progress.numpy()[done] == 0).all()
    st = stepped["start"]
    walk = stepped["env"].terrain.walkable_xy
    assert all((walk == p).all(-1).any() for p in st.physics.root_pos[:, :2])
    # the pose is lifted by the ground height at the spawn: the lowest body
    # sits where a flat-ground reset would put it, above that height
    env = stepped["env"]
    gz = env._ground_z(st.physics.body_pos[..., :2])
    assert ((st.physics.body_pos[..., 2] - gz).amin(1) > -0.1).all()


def test_step_flags_and_terrain_relative_fall(stepped):
    got, want, d = stepped["got"], stepped["want"], stepped["d"]
    for f in ("done", "terminate", "progress"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
    assert want.terminate.tolist() == [False, False, True, False, False, False]
    assert want.done.tolist() == [False, False, True, False, True, False]
    # env 2's fall shows only on the heights above the ground under each body
    env = stepped["env"]
    st = physics_step(env.model, physics_state_from_numpy(d["physics"]),
                      env.action_to_pd_target(torch.as_tensor(stepped["actions"])))
    progress = torch.as_tensor(PROGRESS) + 1
    args = (env.non_contact_body_ids, HEIGHT, EPISODE)
    _, rel = kernels.compute_humanoid_reset(progress, st.contact_force, env._body_pos_above_ground(st), *args)
    _, flat = kernels.compute_humanoid_reset(progress, st.contact_force, st.body_pos, *args)
    assert rel.tolist() == want.terminate.tolist() and not flat[2]


def test_step_outputs_and_physics_match_jax(stepped):
    got, want = stepped["got"], stepped["want"]
    done = want.done
    np.testing.assert_allclose(got.reward.numpy(), want.reward, rtol=0, atol=1e-5)
    hm = stepped["env"].obs_dim - stepped["env"].height_map_dim
    np.testing.assert_allclose(got.obs.numpy()[:, :hm], want.obs[:, :hm], rtol=0, atol=4e-4)
    np.testing.assert_allclose(got.obs.numpy()[:, hm:], want.obs[:, hm:], rtol=0, atol=2e-4)
    np.testing.assert_allclose(got.task["verts"].numpy(), want.task["verts"], rtol=0, atol=VERTS_TOL)
    for f, tol in PHYS_TOL.items():
        np.testing.assert_allclose(getattr(got.physics, f).numpy(), getattr(want.physics, f), rtol=0, atol=tol,
                                   err_msg=f)
    assert np.abs(want.physics.contact_force).max() > 100.0, "no ground contact was exercised"


def test_physics_step_on_terrain_matches_the_envs(stepped):
    """physics_step on the terrain model itself, in the envs that did not
    reset, against the JAX step's physics."""
    env, d, want = stepped["env"], stepped["d"], stepped["want"]
    pd = env.action_to_pd_target(torch.as_tensor(stepped["actions"]))
    st = physics_step(env.model, physics_state_from_numpy(d["physics"]), pd)
    keep = ~want.done
    for f, tol in PHYS_TOL.items():
        np.testing.assert_allclose(getattr(st, f).numpy()[keep], getattr(want.physics, f)[keep], rtol=0, atol=tol,
                                   err_msg=f)


def test_self_collision_step_matches_jax(stepped):
    """Env 5's bent pose touches itself: its self contacts are on, its step
    matches the JAX package's (as every env's does), and without the self
    collision the step differs."""
    env, d, got, want = stepped["env"], stepped["d"], stepped["got"], stepped["want"]
    m, ph = env.model, physics_state_from_numpy(d["physics"])
    f = self_collision_forces(m, m.cap_p0, m.cap_p1, m.cap_r, ph.body_pos, ph.body_rot, ph.body_vel, ph.body_ang_vel)
    assert f[5].abs().sum() > 1.0 and not want.done[5]
    for name, tol in PHYS_TOL.items():
        np.testing.assert_allclose(getattr(got.physics, name).numpy()[5], getattr(want.physics, name)[5], rtol=0,
                                   atol=tol, err_msg=name)
    pd = env.action_to_pd_target(torch.as_tensor(stepped["actions"]))
    off = physics_step(dataclasses.replace(m, config=dataclasses.replace(m.config, self_collision=False)), ph, pd)
    assert (got.physics.joint_omega[5] - off.joint_omega[5]).abs().max() > 1e-2


def test_flip_task_obs_matches_jax(stepped):
    env, jenv = stepped["env"], stepped["jenv"]
    task = stepped["start"].obs[:, env.self_obs_dim:]
    got = env.flip_task_obs(task)
    np.testing.assert_allclose(got.numpy(), np.asarray(jenv.flip_task_obs(jnp.asarray(task.numpy()))), rtol=0,
                               atol=1e-6)
    assert_close(env.flip_task_obs(got), task, rtol=0, atol=0)   # the grid's mirror is an involution


def test_strike_route_widths_and_ctor(stepped):
    env = stepped["strike"]["env"]
    assert env.physics_route == "plain" and env.obs_dim == 358 + 15 and env.reward_raw_dim == 2
    assert env.strike_bodies == ("R_Hand", "L_Hand", "R_Wrist", "L_Wrist", "R_Elbow", "L_Elbow")
    again = env.with_config(dataclasses.replace(env.config, episode_length=7))
    assert again.config.episode_length == 7 and again.prop_spec is env.prop_spec
    assert again.strike_bodies == env.strike_bodies


def test_strike_reset_places_the_box_as_jax(stepped):
    """The step's reset envs (4 and 5) are fresh states from the fed draws:
    the box placed and at rest, as the JAX package places it."""
    got, want = stepped["strike"]["got"], stepped["strike"]["want"]
    done = want.done
    for f in ("pos", "rot", "lin_vel", "ang_vel"):
        np.testing.assert_allclose(getattr(got.task["prop"], f).numpy()[done], getattr(want.task["prop"], f)[done],
                                   rtol=0, atol=VERTS_TOL, err_msg=f)
    np.testing.assert_allclose(got.task["prev_root_pos"].numpy()[done], want.task["prev_root_pos"][done], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.obs.numpy()[done], want.obs[done], rtol=0, atol=2e-4)
    st = stepped["strike"]["start"]
    dist = torch.linalg.vector_norm(st.task["prop"].pos[:, :2] - st.physics.root_pos[:, :2], dim=-1)
    assert ((dist > 1.2 - 1e-4) & (dist < 2.5 + 1e-4)).all()


def test_strike_step_flags_reward_and_obs_match_jax(stepped):
    got, want = stepped["strike"]["got"], stepped["strike"]["want"]
    for f in ("done", "terminate", "progress"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
    assert want.terminate.tolist() == [False] * 4 + [True, False] and want.done[[4, 5]].all()
    np.testing.assert_allclose(got.reward.numpy(), want.reward, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.reward_raw.numpy(), want.reward_raw, rtol=0, atol=1e-4)
    assert want.reward[3] == 1.0 and ((got.reward >= 0) & (got.reward <= 1)).all()
    assert (want.reward_raw[:, 1] > 0).any(), "no env approached its box"
    np.testing.assert_allclose(got.obs.numpy(), want.obs, rtol=0, atol=4e-4)


def test_strike_step_box_and_physics_match_jax(stepped):
    got, want = stepped["strike"]["got"], stepped["strike"]["want"]
    for f, tol in PROP_TOL.items():
        np.testing.assert_allclose(getattr(got.task["prop"], f).numpy(), getattr(want.task["prop"], f), rtol=0,
                                   atol=tol, err_msg=f)
    np.testing.assert_allclose(got.task["prop_contact"].numpy(), want.task["prop_contact"], rtol=0, atol=1.0)
    assert np.abs(want.task["prop_contact"][2]).max() > 1.0, "the hand did not touch the box"
    np.testing.assert_allclose(got.task["prev_root_pos"].numpy(), want.task["prev_root_pos"], rtol=0, atol=2e-4)
    for f, tol in PHYS_TOL.items():
        np.testing.assert_allclose(getattr(got.physics, f).numpy(), getattr(want.physics, f), rtol=0, atol=tol,
                                   err_msg=f)
