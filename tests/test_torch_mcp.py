"""The port's MCP composer over PNN primitives (`learning/pnn.py`,
`env/humanoid_im_mcp.py`), and the env's force and pd control modes,
against the JAX package's on the CPU.

(a) `PNN` with and without lateral connections, with shared and with
    per-column inputs, loaded from a flax PNN's params (`pnn_from_jax`),
    on [2, 3, ...] inputs: 1e-5; the batched-GEMM path equals the
    column-by-column one; `MCPComposer` (softmax and relu heads) and
    `compose_actions`: 1e-6.
(b) One step each of HumanoidImMCPEnv and HumanoidImMCPGetupEnv (a small
    shared fall-state table), B = 4 at 1 substep of 1/120 s, both JAX
    steps (and the JAX blend) in one jit: a 32-32 PNN of 3 columns carried
    from flax, composer weights in [-1, 1], gate_temp 2; the port's plain
    versions of its kernel path (K1 -> K2, and K3 -> RA -> K2 on the getup
    env). No env resets. Tolerances: flags and progress exactly; the
    blended motor action 1e-5; obs 4e-4 and reward 8e-4, about twice
    their measured maxima of 2.04e-4 and 3.76e-4 (they read the stepped
    velocities' float rounding, as in tests/test_torch_domain_rand.py);
    the physics as chip_smoke.py's
    K1_TOL in every env. In the same jit, one step of the plain env in the
    force mode (power_scale 0.5, tau = action x 500 x 0.5, with the power
    reward, which still reads the PD-target convention), the same
    tolerances; the pd mode's env step against `physics_step_pd_explicit`
    of its PD targets (held against the JAX package in
    tests/test_torch_physics_modes.py) and the general finish.
(c) Port-only: the blend is float32 under a bf16 autocast; `with_config`
    keeps the frozen PNN; the MCP env's `step` (K1's path) equals its
    `_step_general`.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env import EnvConfig as JaxEnvConfig, HumanoidImEnv as JaxEnv
from pulse_tpu.env.humanoid_im import EnvState as JaxEnvState
from pulse_tpu.env.humanoid_im_getup import GetupConfig as JaxGetupConfig
from pulse_tpu.env.humanoid_im_mcp import HumanoidImMCPEnv as JaxMCPEnv, HumanoidImMCPGetupEnv as JaxMCPGetupEnv
from pulse_tpu.learning import pnn as jpnn
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics.state import PhysicsState as JaxPhysicsState

from jax_reference import module_reference_compiles, reference_jit
from torch_close import assert_close

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv, env_state_from_numpy
from pulse_tpu_torch.env.humanoid_im_getup import GetupConfig
from pulse_tpu_torch.env.humanoid_im_mcp import HumanoidImMCPEnv, HumanoidImMCPGetupEnv
from pulse_tpu_torch.learning import pnn
from pulse_tpu_torch.motion.motion_lib import MotionData
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model
from pulse_tpu_torch.physics.state import physics_state_from_numpy, state_from_kinematics
from pulse_tpu_torch.physics.step import physics_step_pd_explicit

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

B = 4
CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
STATE_TOL = {"root_pos": 2e-4, "root_rot": 2e-4, "joint_rot": 2e-4, "root_vel6": 5e-3, "joint_omega": 5e-3,
             "body_pos": 3e-4, "body_rot": 2e-4, "body_vel": 5e-3, "body_ang_vel": 5e-3, "contact_force": 1.0}
GETUP = dict(num_fall_states=4, fall_init_prob=0.5, recovery_episode_prob=0.5)
GATE = 2.0
FORCE = dict(control_mode="force", power_scale=0.5, power_reward=True)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------- #
# (a) the networks
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("lateral", [False, True])
@pytest.mark.parametrize("column_inputs", [False, True])
def test_pnn_matches_flax(lateral, column_inputs):
    N, obs, A = 3, 12, 5
    net = jpnn.PNN(action_dim=A, num_primitives=N, units=(16, 8), has_lateral=lateral, column_inputs=column_inputs)
    x = np.random.default_rng(0).normal(0, 1, (2, 3, N, obs) if column_inputs else (2, 3, obs)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    port = pnn.pnn_from_jax(_np_tree(params), column_inputs=column_inputs, device="cpu")
    assert port.has_lateral == lateral and port.units == (16, 8) and port.num_primitives == N
    got = port(torch.tensor(x))
    assert got.shape == (2, 3, N, A)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    if not lateral:   # the batched GEMMs against the column-by-column loop
        assert_close(got, port._columns(torch.tensor(x)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("final", ["softmax", "relu"])
def test_mcp_composer_and_compose_match_jax(final):
    comp = jpnn.MCPComposer(num_primitives=3, units=(16, 8), final=final)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (4, 10)).astype(np.float32)
    params = comp.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    port = pnn.mcp_composer_from_jax(_np_tree(params), final=final, device="cpu")
    w = port(torch.tensor(x))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(comp.apply({"params": params}, jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    prims = rng.normal(0, 1, (4, 3, 6)).astype(np.float32)
    np.testing.assert_allclose(pnn.compose_actions(w, torch.tensor(prims)).detach().numpy(),
                               np.asarray(jpnn.compose_actions(jnp.asarray(w.detach().numpy()), jnp.asarray(prims))),
                               atol=1e-6, rtol=0)


# --------------------------------------------------------------------------- #
# (b) one step of each env against JAX's
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def setup():
    jspec = jax_load_smpl()
    jm = jax_build_motion_data(jspec.skeleton, jax_clips(jspec.skeleton, 4))
    fields = {f.name: torch.float32 for f in dataclasses.fields(MotionData)}
    fields.update(length_starts=torch.long, motion_num_frames=torch.long)
    motion = MotionData(**{k: torch.tensor(np.asarray(getattr(jm, k)), dtype=dt) for k, dt in fields.items()})
    model = build_model(load_smpl_humanoid(), PhysicsConfig(**CFG), device="cpu")
    return model, motion, jax_build_model(jspec, JaxPhysicsConfig(**CFG)), jm


def _fall_table(model) -> dict:
    g = torch.Generator().manual_seed(5)
    rot = torch.tensor([[np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4)]]).expand(4, 4).float()
    pos = torch.tensor([[0.0, 0.0, 0.12]]).expand(4, 3)
    z3 = torch.zeros(4, 3)
    st = state_from_kinematics(model, pos, rot, 0.2 * torch.randn(4, 69, generator=g), z3, z3, torch.zeros(4, 69))
    return {f.name: getattr(st, f.name).numpy() for f in dataclasses.fields(st)}


@pytest.fixture(scope="module")
def stepped(setup):
    model, motion, jmodel, jmotion = setup
    table = _fall_table(model)
    net = jpnn.PNN(action_dim=69, num_primitives=3, units=(32, 32))

    class PortGetup(HumanoidImMCPGetupEnv):
        def _generate_fall_states(self):
            return physics_state_from_numpy(table)

    class JaxGetup(JaxMCPGetupEnv):
        def _generate_fall_states(self, key):
            return JaxPhysicsState(**{k: jnp.asarray(v) for k, v in table.items()})

    params = net.init(jax.random.PRNGKey(4), jnp.zeros((1, 934)))["params"]
    port_pnn = pnn.pnn_from_jax(_np_tree(params), device="cpu")
    env = HumanoidImMCPEnv(model, motion, EnvConfig(), device="cpu", pnn=port_pnn, gate_temp=GATE)
    genv = PortGetup(model, motion, GetupConfig(**GETUP), device="cpu", pnn=port_pnn, gate_temp=GATE)

    ids = np.arange(B)
    start = np.array([0.5, 1.0, 1.5, 0.8], np.float32)
    st = env.reset_to(torch.as_tensor(ids), torch.as_tensor(start))
    d = {f.name: getattr(st, f.name).numpy().copy() for f in dataclasses.fields(st)
         if f.name != "physics" and getattr(st, f.name) is not None}
    d["physics"] = {f.name: getattr(st.physics, f.name).numpy().copy() for f in dataclasses.fields(st.physics)}
    d["progress"] = np.array([1, 3, 7, 2], np.int32)
    d["start_time"] = (start - d["progress"] * model.config.control_dt).astype(np.float32)
    rng = np.random.default_rng(0)
    weights = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    actions = rng.uniform(-0.3, 0.3, (B, 69)).astype(np.float32)
    fenv = HumanoidImEnv(model, motion, EnvConfig(**FORCE), device="cpu")

    jenv = JaxMCPEnv(jmodel, jmotion, None, pnn=net, pnn_params=params, gate_temp=GATE)
    jgenv = JaxGetup(jmodel, jmotion, JaxGetupConfig(**GETUP), pnn=net, pnn_params=params, gate_temp=GATE)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    js = JaxEnvState(physics=JaxPhysicsState(**{k: jnp.asarray(v) for k, v in d["physics"].items()}), key=keys,
                     **{k: jnp.asarray(v) for k, v in d.items() if k != "physics"})
    jfenv = JaxEnv(jmodel, jmotion, JaxEnvConfig(**FORCE))
    blend = jax.vmap(jenv.motor_actions_one)
    want = reference_jit(lambda s, w, a: (jenv.step(s, w), jgenv.step(s, w), blend(s, w), jfenv.step(s, a)))(
        js, jnp.asarray(weights), jnp.asarray(actions))
    out = {}
    for name, e, w, a in (("mcp", env, want[0], weights), ("getup", genv, want[1], weights),
                          ("force", fenv, want[3], actions)):
        e._sample_reset = lambda n, w=w: (torch.tensor(np.asarray(w.motion_id), dtype=torch.long),
                                          torch.tensor(np.asarray(w.start_time)))
        out[name] = (e, e.step(env_state_from_numpy(d), torch.tensor(a)), w)
    out["blend"] = (env.motor_actions(env_state_from_numpy(d), torch.tensor(weights)), want[2])
    return out, d, weights, actions


def test_mcp_widths_and_paths(stepped, setup):
    out = stepped[0]
    env, genv = out["mcp"][0], out["getup"][0]
    assert env.action_dim == genv.action_dim == 3 and env.obs_dim == 934
    assert env._fused_step_ok() and genv._kernel_surface() and not genv._fused_step_ok()
    assert env.with_config(dataclasses.replace(env.config, enable_early_termination=False)).pnn is env.pnn


def test_mcp_blend_matches_jax(stepped):
    got, want = stepped[0]["blend"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert got.abs().max() <= 1.0 and got.abs().max() > 0.05


@pytest.mark.parametrize("name", ["mcp", "getup", "force"])
def test_env_step_matches_jax(stepped, name):
    env, got, want = stepped[0][name]
    assert not np.asarray(want.done).any()
    for f in ("done", "terminate", "progress", "motion_id"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    # about twice the measured maxima over the three envs: obs 2.04e-4, reward 3.76e-4 (force)
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs), atol=4e-4, rtol=0)
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(want.reward), atol=8e-4, rtol=0)
    for f, tol in STATE_TOL.items():
        np.testing.assert_allclose(getattr(got.physics, f).numpy(), np.asarray(getattr(want.physics, f)), atol=tol,
                                   rtol=0, err_msg=f)


def test_mcp_blend_is_float32_under_autocast(stepped):
    env = stepped[0]["mcp"][0]
    st = env_state_from_numpy(stepped[1])
    w = torch.tensor(stepped[2])
    plain = env.motor_actions(st, w)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        inside = env.motor_actions(st, w)
    assert inside.dtype == torch.float32 and torch.equal(inside, plain)


def test_mcp_kernel_path_equals_general_step(stepped):
    env = stepped[0]["mcp"][0]
    d, w = stepped[1], torch.tensor(stepped[2])
    a = env.step(env_state_from_numpy(d), w)
    b = env._step_general(env_state_from_numpy(d), w)
    assert_close(a.obs, b.obs, atol=1e-4, rtol=0)
    assert_close(a.reward, b.reward, atol=1e-5, rtol=0)
    assert torch.equal(a.done, b.done)


def test_pd_mode_env_step_is_the_explicit_pd_step(stepped, setup):
    """The pd mode: the env's physics is `physics_step_pd_explicit` of the
    PD targets (the JAX step's, held in tests/test_torch_physics_modes.py),
    off the kernels' surface, then the general finish."""
    model, motion = setup[:2]
    d, actions = stepped[1], torch.tensor(stepped[3])
    penv = HumanoidImEnv(model, motion, EnvConfig(control_mode="pd"), device="cpu")
    assert not penv._kernel_surface() and penv.action_dim == 69
    st = env_state_from_numpy(d)
    penv._sample_reset = lambda n: (st.motion_id, st.start_time)
    got = penv.step(st, actions)
    want = physics_step_pd_explicit(model, st.physics, penv.action_to_pd_target(actions))
    for f in STATE_TOL:
        assert_close(getattr(got.physics, f), getattr(want, f), atol=0, rtol=0)
