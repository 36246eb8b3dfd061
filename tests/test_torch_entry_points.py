"""The port's entry points against the JAX package's on the same inputs, on
the CPU (every entry point is called with the CPU named: on its own it
asks for the card).

- The pose server and client: the port's server with the JAX client and
  the JAX server with the port's client, frames and commands both ways.
- The demo loop (`scripts/demo_server.py`): its `motion` handler against
  the JAX env's `reset_to` on the same clip and time, its `pose` handler
  against the JAX `state_from_kinematics` (1e-6), the loop serving frames
  to a client and applying its commands, `demo_client` and both `main`s.
- `sample_pulse`: the prior, z and the decoded action of a PulseVAE carried
  across by `pulse_vae_from_jax`, with the noise fed from numpy, against the
  JAX apply (1e-5), then one env step on that action against the JAX step
  (the tolerances of tests/test_torch_env.py); its `main`'s .npz.
- `record_rollout`: the restored policy's action on `actor_critic_from_jax`
  weights against JAX's apply (1e-5), and the .npz layout of the JAX script.
- `play_motion`: the store's trace against the JAX `get_motion_state`
  (1e-5); `joint_monkey`: `print_asset`'s text equal to the JAX script's and
  `sweep_dofs` at 2 frames a DOF (1e-5 m); `parse_mjcf` on a small MJCF
  written here, every RobotSpec field equal to JAX's; `mjcf_to_urdf`'s text
  of the bundled humanoid and of that MJCF identical to the JAX script's.
- `render_smpl_mesh`: the batched skinning against the JAX `lbs` on a
  synthetic SMPL model (1e-5; V = 280 here, 6890 in chip_smoke.py), the
  PNGs written (matplotlib is here), and the ImportError that names
  matplotlib where it is missing.
- `legacy_cli.translate` equal to JAX's for every task name and the
  Isaac-only no-op flags (`legacy_cli.main` trains on the card in
  chip_smoke.py's `legacy_cli` phase; here it reaches `run.main`).
- `utils/benchmarking.Timer`'s totals, counts and report equal to JAX's on
  a fake clock; `device_trace` writes a trace.

The JAX side's SMPL-size computations (the reset, the pose's state, the
prior sample, the env step at 1 substep, the store's trace, the skinning)
are one jit, run once by a module fixture; every JAX compile of the module
is at -O0 (`tests/jax_reference.py`).
"""

import json
import os
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import joint_monkey as jax_joint_monkey  # noqa: E402
import mjcf_to_urdf as jax_mjcf_to_urdf  # noqa: E402

from jax_reference import module_reference_compiles, reference_jit  # noqa: E402

from pulse_tpu import legacy_cli as jax_legacy_cli  # noqa: E402
from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl, parse_mjcf as jax_parse_mjcf  # noqa: E402
from pulse_tpu.env import EnvConfig as JaxEnvConfig, HumanoidImEnv as JaxEnv  # noqa: E402
from pulse_tpu.kinematics import skeleton as jax_skeleton  # noqa: E402
from pulse_tpu.learning.networks import ActorCritic as JaxActorCritic, PulseVAE as JaxPulseVAE  # noqa: E402
from pulse_tpu.learning.running_norm import RunningMeanStd as JaxRMS  # noqa: E402
from pulse_tpu.motion import build_motion_data as jax_build_motion_data  # noqa: E402
from pulse_tpu.motion import get_motion_state as jax_get_motion_state  # noqa: E402
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips  # noqa: E402
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model  # noqa: E402
from pulse_tpu.physics.state import state_from_kinematics as jax_state_from_kinematics  # noqa: E402
from pulse_tpu.smpl import body_model as jax_body_model  # noqa: E402
from pulse_tpu.utils import benchmarking as jax_benchmarking  # noqa: E402
from pulse_tpu.utils import pose_server as jax_pose_server  # noqa: E402

from pulse_tpu_torch import legacy_cli, run  # noqa: E402
from pulse_tpu_torch.assets import load_smpl_humanoid, parse_mjcf  # noqa: E402
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv  # noqa: E402
from pulse_tpu_torch.learning.networks import ActorCritic, actor_critic_from_jax, pulse_vae_from_jax  # noqa: E402
from pulse_tpu_torch.learning.ppo import TrainState  # noqa: E402
from pulse_tpu_torch.learning.running_norm import RunningMeanStd  # noqa: E402
from pulse_tpu_torch.motion.motion_lib import build_motion_data  # noqa: E402
from pulse_tpu_torch.motion.synthetic import make_synthetic_clips  # noqa: E402
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model  # noqa: E402
from pulse_tpu_torch.scripts import (common, demo_client, demo_server, joint_monkey, mjcf_to_urdf,  # noqa: E402
                                     play_motion, record_rollout, render_smpl_mesh, sample_pulse)
from pulse_tpu_torch.smpl.body_model import SMPL_JOINT_NAMES, load_smpl_model  # noqa: E402
from pulse_tpu_torch.smpl.synthetic import write_smpl_pickle  # noqa: E402
from pulse_tpu_torch.utils import benchmarking, pose_server  # noqa: E402

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

ROOT = Path(__file__).resolve().parent.parent
SPEC = load_smpl_humanoid()
TREE = SPEC.skeleton
DEADLINE_S = 5.0          # every socket wait and poll below gives up after this
# one env step of the port against the JAX one (tests/test_torch_env.py)
STEP_TOL = {"root_pos": 2e-4, "root_rot": 2e-4, "body_pos": 3e-4, "body_rot": 2e-4, "root_vel6": 5e-3,
            "joint_omega": 5e-3, "body_vel": 5e-3, "body_ang_vel": 5e-3, "contact_force": 1.0}
# the sampler's env step at 1 substep of 1/120 s (as tests/test_torch_env.py):
# the JAX step's compile grows with the substeps it unrolls
ONE_SUBSTEP = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
MOTION_CMD = {"cmd": "motion", "id": 5, "time": 1.25}     # clip 5 mod 2 = 1
# A reset reads the motion store: positions and rotations agree to float
# rounding (1e-6), but the store's angular rates come from arccos of a
# cosine near 1 in both packages, where an ulp moves them (tests/
# test_torch_ops.py MOTION_ATOL: 5e-3); measured 1.7e-5 here, held to 1e-4,
# as are the obs and the AMP window that read them
RESET_TOL = {"root_vel6": 1e-4, "joint_omega": 1e-4, "body_vel": 1e-4, "body_ang_vel": 1e-4}
# a looked-up body rotation: slerp's arccos near 1 (MOTION_ATOL's rb_rot);
# the positions, the trace play_motion draws, hold 1e-5
SLERP_TOL = 5e-4
TEMPERATURE = 0.7
LBS_FRAMES = 3
PHYS_FIELDS = ("root_pos", "root_rot", "joint_rot", "root_vel6", "joint_omega", "body_pos", "body_rot", "body_vel",
               "body_ang_vel", "contact_force")


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _wait(cond, what: str):
    """Poll `cond()` until it holds or DEADLINE_S passes."""
    end = time.monotonic() + DEADLINE_S
    while not cond():
        if time.monotonic() > end:
            raise TimeoutError(f"no {what} within {DEADLINE_S} s")
        time.sleep(0.005)


def _random_params(module, rng, *inputs) -> dict:
    """A flax module's param tree (numpy) drawn at its init's shapes: each
    Dense kernel uniform in +-1/sqrt(fan in), each bias in +-0.1."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]

    def draw(leaf):
        bound = 1.0 / np.sqrt(leaf.shape[0]) if len(leaf.shape) == 2 else 0.1
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _pose_cmd(rng):
    q = rng.standard_normal(4)
    return {"cmd": "pose", "root_pos": [0.1, -0.2, 0.97], "root_rot": (q / np.linalg.norm(q)).tolist(),
            "dof_pos": rng.uniform(-0.5, 0.5, 69).tolist()}


# --------------------------------------------------------------------------- #
# the JAX side, one jit
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The port's sampler env and a narrow float32 PulseVAE carried across,
    the inputs, and the JAX package's outputs on them from one -O0 jit."""
    rng = np.random.default_rng(0)
    # the sampler's env (sample_pulse.make_sample_env) at ONE_SUBSTEP
    env = HumanoidImEnv(build_model(SPEC, PhysicsConfig(**ONE_SUBSTEP), device="cpu"),
                        build_motion_data(TREE, make_synthetic_clips(TREE, num_clips=2), device="cpu"),
                        EnvConfig(enable_early_termination=False, cycle_motion=True), device="cpu")
    jspec = jax_load_smpl()
    jenv = JaxEnv(jax_build_model(jspec, JaxPhysicsConfig(**ONE_SUBSTEP)), jax_build_motion_data(
        jspec.skeleton, jax_clips(jspec.skeleton, num_clips=2)), JaxEnvConfig(enable_early_termination=False,
                                                                                cycle_motion=True))

    L = 8
    vae = JaxPulseVAE(action_dim=69, latent_dim=L, self_obs_dim=env.self_obs_dim, encoder_units=(32,),
                      prior_units=(32,), decoder_units=(64,), critic_units=(32,))
    params = _random_params(vae, rng, jnp.zeros((1, env.obs_dim)), jnp.zeros((1, L)))
    params["decoder"]["Dense_0"]["bias"] = np.linspace(-2, 2, 69).astype(np.float32)   # some actions past the clip
    mean = (0.1 * rng.standard_normal(env.obs_dim)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, env.obs_dim).astype(np.float32)
    eps = rng.standard_normal((1, L)).astype(np.float32)
    pose = _pose_cmd(rng)

    smpl_path = str(tmp_path_factory.mktemp("smpl") / "smpl.pkl")
    write_smpl_pickle(smpl_path, TREE, seed=3)   # V = 280 (chip_smoke.py skins V = 6890 on the card)
    smpl, jsmpl = load_smpl_model(smpl_path), jax_body_model.load_smpl_model(smpl_path)
    T = 7
    motion_quat = rng.standard_normal((T, 24, 4)).astype(np.float32)
    motion_quat /= np.linalg.norm(motion_quat, axis=-1, keepdims=True)
    trans = rng.uniform(-0.5, 0.5, (T, 3)).astype(np.float32) + np.float32([0, 0, 0.9])
    betas = rng.uniform(-1, 1, 10).astype(np.float32)
    frames, _, _ = render_smpl_mesh.skin_frames(smpl, motion_quat, trans, betas, stride=2, max_frames=LBS_FRAMES,
                                                device="cpu")
    from pulse_tpu.motion.reference_format import MUJOCO_JOINT_NAMES

    perm = [MUJOCO_JOINT_NAMES.index(n) for n in SMPL_JOINT_NAMES]
    play_times = np.arange(0.0, float(jenv.motion.motion_lengths[1]), 1.0 / 30.0, dtype=np.float32)

    def reference(keys, mid, t0, params, rms, eps, root_pos, root_rot, dof, play_times, lbs_quat, lbs_trans):
        st = jenv.reset_to(keys, mid, t0)
        self_obs = rms.normalize(st.obs)[..., : vae.self_obs_dim]
        mu, logvar = vae.apply({"params": params}, self_obs, method=JaxPulseVAE.prior_params)
        z = mu + jnp.exp(0.5 * logvar) * (eps * TEMPERATURE)
        action = vae.apply({"params": params}, self_obs, z, method=JaxPulseVAE.decode)
        nxt = jenv.step(st, jnp.clip(action, -1.0, 1.0))
        z3 = jnp.zeros(3)
        ph = jax_state_from_kinematics(jenv.model, root_pos, root_rot, dof, z3, z3, jnp.zeros(69))
        play = jax_get_motion_state(jenv.motion, jnp.ones(play_times.shape, jnp.int32), play_times)
        verts, joints = jax.vmap(lambda p, t: jax_body_model.lbs(jsmpl, jnp.asarray(betas), p, t))(lbs_quat, lbs_trans)
        return {"reset": st, "prior_mu": mu, "prior_logvar": logvar, "z": z, "action": action, "step": nxt,
                "pose": ph, "play_pos": play["rg_pos"], "play_rot": play["rb_rot"], "verts": verts, "joints": joints}

    want = reference_jit(reference)(
        jax.random.split(jax.random.PRNGKey(1), 1), jnp.asarray([MOTION_CMD["id"] % 2]),
        jnp.asarray([MOTION_CMD["time"]], jnp.float32), params,
        JaxRMS(mean=jnp.asarray(mean), var=jnp.asarray(var), count=jnp.asarray(100.0)), jnp.asarray(eps),
        *(jnp.asarray(pose[k], jnp.float32) for k in ("root_pos", "root_rot", "dof_pos")), jnp.asarray(play_times),
        jnp.asarray(motion_quat[frames][:, perm]), jnp.asarray(trans[frames]))
    want = jax.tree_util.tree_map(np.asarray, want)
    net = pulse_vae_from_jax(params, full_precision=True, device="cpu")
    rms = RunningMeanStd(mean=torch.tensor(mean), var=torch.tensor(var), count=torch.tensor(100.0))
    return {"env": env, "net": net, "rms": rms, "eps": eps, "pose": pose, "want": want, "smpl": smpl,
            "smpl_path": smpl_path, "motion_quat": motion_quat, "trans": trans, "betas": betas, "frames": frames,
            "play_times": play_times}


# --------------------------------------------------------------------------- #
# pose server and client
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("server_mod,client_mod", [(pose_server, jax_pose_server), (jax_pose_server, pose_server)],
                         ids=["port_server-jax_client", "jax_server-port_client"])
def test_pose_server_and_client_talk_across_packages(server_mod, client_mod):
    srv = server_mod.PoseServer(port=0)
    client = client_mod.PoseClient(port=srv.port)
    client._sock.settimeout(DEADLINE_S)
    try:
        _wait(lambda: len(srv._clients) == 1, "connection")
        frames = [{"t": i / 30.0, "body_pos": [[0.5 * i, -1.0, 0.93]] * 24, "reward": 0.25 * i} for i in range(3)]
        for f in frames:
            srv.publish(f)
        assert [client.recv() for _ in frames] == frames
        cmds = [MOTION_CMD, _pose_cmd(np.random.default_rng(1))]
        got = []
        for c in cmds:
            client.send(c)
            _wait(lambda: got.append(srv.poll_command()) or got[-1] is not None, "command")
        assert [g for g in got if g is not None] == cmds
    finally:
        client.close()
        srv.close()


# --------------------------------------------------------------------------- #
# the demo server's handlers and loop
# --------------------------------------------------------------------------- #

def test_motion_and_pose_handlers_match_jax(ref):
    env, want = ref["env"], ref["want"]
    before = env.reset(1)
    st = demo_server.apply_command(env, before, MOTION_CMD)
    w = want["reset"]
    assert int(st.motion_id[0]) == 1 and float(st.start_time[0]) == MOTION_CMD["time"] and int(st.progress[0]) == 0
    for f in ("motion_id", "start_time", "progress"):
        np.testing.assert_array_equal(_np(getattr(st, f)), np.asarray(getattr(w, f)), err_msg=f)
    for f in PHYS_FIELDS:
        np.testing.assert_allclose(_np(getattr(st.physics, f)), getattr(w.physics, f), rtol=0, atol=RESET_TOL.get(f, 1e-6),
                                   err_msg=f)
    for f in ("obs", "amp_hist"):
        np.testing.assert_allclose(_np(getattr(st, f)), getattr(w, f), rtol=0, atol=1e-4, err_msg=f)

    posed = demo_server.apply_command(env, st, ref["pose"])
    for f in PHYS_FIELDS:
        np.testing.assert_allclose(_np(getattr(posed.physics, f)), getattr(want["pose"], f)[None], rtol=0, atol=1e-6,
                                   err_msg=f)
    for f in ("motion_id", "start_time", "progress", "obs", "amp_hist"):   # the rest of the state kept
        assert torch.equal(getattr(posed, f), getattr(st, f)), f
    assert demo_server.apply_command(env, st, None) is st and demo_server.apply_command(env, st, {"cmd": "x"}) is st


def test_demo_loop_serves_frames_and_applies_commands():
    env = common.make_env("cpu")
    policy = run.DeterministicPolicy(ActorCritic(env.obs_dim, 69, (32, 24), (32,), device="cpu"),
                                     RunningMeanStd.create(env.obs_dim))
    srv = pose_server.PoseServer(port=0)
    client = pose_server.PoseClient(port=srv.port, timeout=DEADLINE_S)
    applied = []
    try:
        _wait(lambda: srv.num_clients == 1, "connection")
        client.send(MOTION_CMD)
        _wait(lambda: not srv._inbox.empty(), "command")
        st = demo_server.demo_loop(env, policy, srv, 3,
                                   on_command=lambda i, c, s: applied.append((i, c["cmd"], int(s.motion_id[0]))))
        frames = [client.recv() for _ in range(3)]
    finally:
        client.close()
        srv.close()
    assert applied == [(0, "motion", 1)] and int(st.motion_id[0]) == 1 and int(st.progress[0]) == 3
    assert [f["t"] for f in frames] == [0.0, 1 / 30.0, 2 / 30.0]
    for f in frames:
        assert np.asarray(f["body_pos"]).shape == (24, 3) and np.isfinite(f["body_pos"]).all()
        assert 0.0 <= f["reward"] <= 1.0
    np.testing.assert_allclose(frames[-1]["body_pos"], _np(st.physics.body_pos[0]), rtol=0, atol=1e-6)


def test_demo_client_and_server_mains(policy_ckpt, capsys):
    # the client's main against a port server that publishes once it connects
    srv = pose_server.PoseServer(port=0)
    frames = [{"t": i / 30.0, "body_pos": [[0.0, 0.0, 0.9]] * 24, "reward": 0.5} for i in range(2)]

    def serve():
        _wait(lambda: srv.num_clients == 1, "connection")
        for f in frames:
            srv.publish(f)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    try:
        got = demo_client.main(["--port", str(srv.port), "--frames", "2", "--motion", "3", "--time", "0.5",
                                "--timeout", str(DEADLINE_S)])
        th.join(DEADLINE_S)
        cmd = []
        _wait(lambda: cmd.append(srv.poll_command()) or cmd[-1] is not None, "command")
    finally:
        srv.close()
    assert got == frames and cmd[-1] == {"cmd": "motion", "id": 3, "time": 0.5}
    demo_server.main(["--port", "0", "--steps", "2", "--ckpt", policy_ckpt[0], "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored" in out and "demo server on port" in out and "2 steps" in out


# --------------------------------------------------------------------------- #
# sample_pulse and record_rollout
# --------------------------------------------------------------------------- #

def test_sample_step_matches_jax(ref):
    env, want = ref["env"], ref["want"]
    st = demo_server.apply_command(env, env.reset(1), MOTION_CMD)
    got = sample_pulse.sample_action(ref["net"], ref["rms"], st.obs, torch.as_tensor(ref["eps"]), TEMPERATURE)
    for k in ("prior_mu", "prior_logvar", "z", "action"):
        np.testing.assert_allclose(_np(got[k]), want[k], rtol=0, atol=1e-5, err_msg=k)
    assert (np.abs(want["action"]) > 1.0).any() and (np.abs(want["action"]) < 1.0).any()
    nxt = env.step(st, torch.clamp(got["action"], -1.0, 1.0))
    w = want["step"]
    for f, tol in STEP_TOL.items():
        np.testing.assert_allclose(_np(getattr(nxt.physics, f)), getattr(w.physics, f), rtol=0, atol=tol, err_msg=f)
    for f in ("obs", "reward"):
        np.testing.assert_allclose(_np(getattr(nxt, f)), getattr(w, f), rtol=0, atol=1e-3, err_msg=f)
    assert not bool(nxt.done.any()) and not np.asarray(w.done).any()


def test_sample_pulse_main_writes_the_jax_layout(ref, tmp_path, capsys):
    # restored from a distillation run's ckpt/ (the narrow PulseVAE)
    net = ref["net"]
    run.save_checkpoint(str(tmp_path / "ckpt"), 0, types.SimpleNamespace(
        network=net, optimizer=torch.optim.Adam(net.parameters()), obs_rms=ref["rms"], epoch=0))
    out = str(tmp_path / "s.npz")
    res = sample_pulse.main(["--ckpt", str(tmp_path / "ckpt"), "--steps", "3", "--num_envs", "2", "--out", out,
                             "--device", "cpu"])
    assert "restored" in capsys.readouterr().out
    assert res["episodes_ended"] == 0 and res["terminations"] == 0
    with np.load(out) as d:
        assert sorted(d.files) == ["all_body_pos", "body_pos", "node_names", "parents"]
        assert d["all_body_pos"].shape == (3, 2, 24, 3) and np.isfinite(d["all_body_pos"]).all()
        np.testing.assert_array_equal(d["body_pos"], d["all_body_pos"][:, 0])
        assert list(d["node_names"]) == list(TREE.node_names)
        np.testing.assert_array_equal(d["parents"], TREE.parent_indices)


@pytest.fixture(scope="module")
def policy_ckpt(ref, tmp_path_factory):
    """(a port run's ckpt/ directory holding a narrow ActorCritic carried
    across from flax, the flax module, its params)."""
    jnet = JaxActorCritic(action_dim=69, actor_units=(64, 32), critic_units=(32,), dtype=jnp.float32)
    params = _random_params(jnet, np.random.default_rng(2), jnp.zeros((1, ref["env"].obs_dim)))
    params["Dense_0"]["bias"] = np.linspace(-2, 2, 69).astype(np.float32)
    net = actor_critic_from_jax(params, device="cpu")
    ts = TrainState(network=net, optimizer=torch.optim.Adam(net.parameters()), obs_rms=ref["rms"],
                    value_rms=RunningMeanStd.create(1), env_state=None, epoch=3)
    ckpt = str(tmp_path_factory.mktemp("run") / "ckpt")
    run.save_checkpoint(ckpt, 3, ts)
    return ckpt, jnet, params


def test_record_rollout_action_and_layout(ref, policy_ckpt, tmp_path):
    env, rms = ref["env"], ref["rms"]
    ckpt, jnet, params = policy_ckpt
    policy = common.load_policy(env, ckpt)
    obs = np.random.default_rng(4).standard_normal((4, env.obs_dim)).astype(np.float32)
    jrms = JaxRMS(mean=jnp.asarray(_np(rms.mean)), var=jnp.asarray(_np(rms.var)), count=jnp.asarray(100.0))
    mu, _, _ = jnet.apply({"params": params}, jrms.normalize(jnp.asarray(obs)))
    want = np.asarray(jnp.clip(mu, -1.0, 1.0))
    assert (np.abs(want) == 1.0).any() and (np.abs(want) < 1.0).any()
    np.testing.assert_allclose(_np(policy(torch.as_tensor(obs))), want, rtol=0, atol=1e-5)

    out = str(tmp_path / "r.npz")
    record_rollout.main(["--ckpt", ckpt, "--steps", "3", "--num_envs", "2", "--out", out,
                         "--device", "cpu"])
    with np.load(out) as d:
        shapes = {k: d[k].shape for k in d.files}
        assert shapes == {"body_pos": (3, 24, 3), "body_rot": (3, 24, 4), "all_body_pos": (3, 2, 24, 3),
                          "rewards": (3, 2), "node_names": (24,), "parents": (24,)}
        np.testing.assert_array_equal(d["body_pos"], d["all_body_pos"][:, 0])
        assert ((d["rewards"] >= 0) & (d["rewards"] <= 1)).all()
        assert list(d["node_names"]) == list(TREE.node_names)


# --------------------------------------------------------------------------- #
# play_motion, joint_monkey, mjcf, urdf
# --------------------------------------------------------------------------- #

def test_play_motion_matches_jax(ref, tmp_path):
    got = play_motion.playback(build_motion_data(TREE, play_motion.load_clips(TREE, "", 1), device="cpu"), 1)
    np.testing.assert_array_equal(got["times"], ref["play_times"])
    np.testing.assert_allclose(got["body_pos"], ref["want"]["play_pos"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["body_rot"], ref["want"]["play_rot"], rtol=0, atol=SLERP_TOL)
    out = str(tmp_path / "p.npz")
    play_motion.main(["--clip", "0", "--out", out, "--device", "cpu"])
    with np.load(out) as d:
        assert sorted(d.files) == ["body_pos", "body_rot", "node_names", "parents", "times"]
        assert d["body_pos"].shape == (120, 24, 3)


def test_print_asset_text_matches_jax(capsys):
    jax_joint_monkey.print_asset(jax_load_smpl())
    want = capsys.readouterr().out
    joint_monkey.print_asset(SPEC)
    assert capsys.readouterr().out == want and "dof: 69" in want


def test_sweep_dofs_matches_jax(tmp_path, monkeypatch):
    # the JAX script's FK as one -O0 program (it runs op by op otherwise)
    jspec = jax_load_smpl()
    real_fk = jax_skeleton.forward_kinematics
    fk = reference_jit(lambda local, root: real_fk(jspec.skeleton, local, root))
    monkeypatch.setattr(jax_skeleton, "forward_kinematics", lambda tree, local, root: fk(local, root))
    jax_joint_monkey.sweep_dofs(jspec, 2, str(tmp_path / "jax.npz"))
    got = joint_monkey.sweep_dofs(SPEC, 2, str(tmp_path / "port.npz"), device="cpu")
    with np.load(tmp_path / "jax.npz") as w, np.load(tmp_path / "port.npz") as g:
        assert sorted(g.files) == sorted(w.files)
        assert g["body_pos"].shape == (138, 24, 3)
        np.testing.assert_allclose(g["body_pos"], w["body_pos"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["body_rot"], w["body_rot"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(g["names"], w["names"])
    np.testing.assert_array_equal(got["body_pos"], np.load(tmp_path / "port.npz")["body_pos"])


_MJCF = """<mujoco model="tiny">
  <compiler angle="{angle}"/>
  <default><geom friction="0.8 0.1 0.1"/></default>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body name="Pelvis" pos="0 0 1">
      <freejoint name="root"/>
      <geom type="sphere" size="0.1" pos="0 0 0.02" density="985"/>
      <body name="Thigh" pos="0.1 0 -0.05">
        <joint name="h_x" type="hinge" axis="1 0 0" range="{r0}" stiffness="500" damping="50" armature="0.02"/>
        <joint name="h_y" type="hinge" axis="0 1 0" range="{r1}" stiffness="500" damping="50"/>
        <joint name="h_z" type="hinge" axis="0 0 1" range="{r2}" stiffness="500" damping="50"/>
        <geom type="capsule" fromto="0 0 0 0.01 0.02 -0.35" size="0.06" friction="0.9"/>
        <body name="Shin" pos="0 0 -0.4">
          <geom type="box" size="0.05 0.04 0.2" pos="0 0 -0.2" quat="0.9238795 0 0.3826834 0" density="1100"/>
        </body>
      </body>
      <body name="Spine" pos="0 0 0.1">
        <joint type="hinge" axis="1 0 0"/>
        <joint type="hinge" axis="0 1 0" range="-30 30"/>
        <joint type="hinge" axis="0 0 1"/>
        <geom type="capsule" fromto="0 0 0.2 0 0 0" size="0.07"/>
        <geom type="capsule" size="0.05 0.1" pos="0 0.05 0.1" quat="0.7071068 0.7071068 0 0"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""


@pytest.mark.parametrize("angle,ranges", [("degree", ("-60 90", "-45 45", "-30 30")),
                                          ("radian", ("-1.0 1.5", "-0.7 0.7", "-0.5 0.5"))])
def test_parse_mjcf_matches_jax(tmp_path, angle, ranges):
    path = tmp_path / "tiny.xml"
    path.write_text(_MJCF.format(angle=angle, r0=ranges[0], r1=ranges[1], r2=ranges[2]))
    got, want = parse_mjcf(str(path)), jax_parse_mjcf(str(path))
    assert got.skeleton.node_names == want.skeleton.node_names == ("Pelvis", "Thigh", "Shin", "Spine")
    np.testing.assert_array_equal(got.skeleton.parent_indices, want.skeleton.parent_indices)
    np.testing.assert_array_equal(got.skeleton.local_translation, want.skeleton.local_translation)
    for f in ("joint_stiffness", "joint_damping", "joint_armature", "dof_lower", "dof_upper", "geom_body",
              "geom_type", "geom_pos", "geom_quat", "geom_size", "geom_density", "geom_friction", "body_mass",
              "body_com", "body_inertia"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), f
    assert got.geom_body.tolist() == [0, 1, 2, 3, 3] and got.body_mass[2] > 0
    # and its URDF, through both scripts' command lines
    mjcf_to_urdf.main([str(path), str(tmp_path / "port.urdf")])
    jax_mjcf_to_urdf.main([str(path), str(tmp_path / "jax.urdf")])
    assert (tmp_path / "port.urdf").read_text() == (tmp_path / "jax.urdf").read_text()


def test_urdf_of_the_bundled_humanoid_matches_jax(tmp_path):
    got = mjcf_to_urdf.robot_spec_to_urdf(SPEC)
    assert got == jax_mjcf_to_urdf.robot_spec_to_urdf(jax_load_smpl())
    src = str(ROOT / "pulse_tpu_torch" / "assets" / "data" / "smpl_humanoid.json")
    assert mjcf_to_urdf.main([src, str(tmp_path / "h.urdf")]) == 0
    assert (tmp_path / "h.urdf").read_text() == got and got.count('type="revolute"') == 69


# --------------------------------------------------------------------------- #
# render_smpl_mesh
# --------------------------------------------------------------------------- #

def test_skinning_matches_jax_and_renders(ref, tmp_path):
    frames, verts, joints = render_smpl_mesh.skin_frames(ref["smpl"], ref["motion_quat"], ref["trans"], ref["betas"],
                                                         stride=2, max_frames=LBS_FRAMES, device="cpu")
    assert frames.tolist() == [0, 2, 4] and verts.shape == (LBS_FRAMES, 280, 3)
    np.testing.assert_allclose(_np(verts), ref["want"]["verts"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(joints), ref["want"]["joints"], rtol=0, atol=1e-5)
    paths = render_smpl_mesh.render_frames(ref["smpl"], ref["motion_quat"], ref["trans"], ref["betas"],
                                           str(tmp_path / "png"), stride=3, max_frames=1, device="cpu")
    assert [os.path.basename(p) for p in paths] == ["frame_0000.png"]
    for p in paths:
        assert open(p, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_render_without_matplotlib_names_it(ref, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        render_smpl_mesh.render_frames(ref["smpl"], ref["motion_quat"][:1], ref["trans"][:1], ref["betas"],
                                       str(tmp_path / "png"), device="cpu")
    assert not (tmp_path / "png").exists()


# --------------------------------------------------------------------------- #
# the legacy CLI
# --------------------------------------------------------------------------- #

_FLAGS = ["--num_envs", "64", "--episode_length", "120", "--seed", "3", "--max_iterations", "9",
          "--horizon_length", "16", "--minibatch_size", "512", "--test", "--epoch", "-1", "--experiment", "x",
          "--network_path", "out/", "--has_eval", "--randomize", "--motion_file", "m.pkl"]


@pytest.mark.parametrize("task", sorted(jax_legacy_cli._TASK_TO_ENV))
def test_translate_matches_jax(task, capsys):
    assert legacy_cli._TASK_TO_ENV == jax_legacy_cli._TASK_TO_ENV
    assert legacy_cli._ENV_TO_LEARNING == jax_legacy_cli._ENV_TO_LEARNING
    for extra in ([], ["--llc_checkpoint", "c.pth"], ["--cfg_env", "im_getup", "--cfg_train", "im_amp"]):
        argv = ["--task", task, *_FLAGS, *extra]
        got = legacy_cli.translate(legacy_cli.build_parser().parse_args(argv))
        assert got == jax_legacy_cli.translate(jax_legacy_cli.build_parser().parse_args(argv)), argv
        groups = {o.split("=", 1)[0]: o.split("=", 1)[1] for o in got[:2]}
        for g, name in groups.items():
            assert (ROOT / "pulse_tpu_torch" / "configs" / g / f"{name}.yaml").exists(), (g, name)
    capsys.readouterr()


def test_translate_no_op_flags_match_jax(capsys):
    argv = ["--task", "HumanoidIm", "--rl_device", "cuda:0", "--task_type", "x", "--metadata", "--resume_str", "r",
            "--num_proc", "2", "--checkpoint", "c", "--logdir", "l/", "--no_log", "--small_terrain", "--add_proj",
            "--server_mode", *(f"--{f}" for f in legacy_cli._NO_OP_SWITCHES)]
    got = legacy_cli.translate(legacy_cli.build_parser().parse_args(argv))
    assert got == jax_legacy_cli.translate(jax_legacy_cli.build_parser().parse_args(argv)) == [
        "env=im", "learning=im_ppo"]
    out = capsys.readouterr().out
    assert "rl_device" in out and "pulse_tpu_torch.scripts.demo_server" in out
    assert legacy_cli.translate(legacy_cli.build_parser().parse_args(["--device", "cpu"]))[-1] == "device=cpu"


# --------------------------------------------------------------------------- #
# benchmarking, and the card by default
# --------------------------------------------------------------------------- #

def test_timer_matches_jax_on_a_fake_clock(monkeypatch):
    ticks = [0.0, 0.25, 1.0, 1.125, 2.0, 2.5, 10.0, 10.001]
    timers = []
    for mod in (jax_benchmarking, benchmarking):
        it = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(it))
        t = mod.Timer()
        for name in ("step", "update", "step", "step"):
            with t(name, block=True, result={"x": (jnp.zeros(2) if mod is jax_benchmarking else torch.zeros(2))}):
                pass
        timers.append(t)
    want, got = timers
    assert dict(got.totals) == dict(want.totals) and dict(got.counts) == dict(want.counts)
    assert got.report() == want.report() and got.mean("step") == want.mean("step")
    assert "step: total 0.751s over 3 calls (avg 250.33 ms)" in got.report()


def test_device_trace_writes_a_trace(tmp_path):
    with benchmarking.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    (trace,) = (tmp_path / "trace").iterdir()
    assert trace.name.endswith(".pt.trace.json") and "traceEvents" in json.loads(trace.read_text())


@pytest.mark.parametrize("entry", ["make_env", "sweep_dofs", "play_motion", "skin_frames", "legacy_cli"])
def test_entry_points_ask_for_the_card(ref, entry):
    if torch.cuda.is_available():
        pytest.skip("checks the error without CUDA")
    calls = {
        "make_env": lambda: common.make_env(),
        "sweep_dofs": lambda: joint_monkey.sweep_dofs(SPEC, 2),
        "play_motion": lambda: play_motion.main(["--out", "/nonexistent/p.npz"]),
        "skin_frames": lambda: render_smpl_mesh.skin_frames(ref["smpl"], ref["motion_quat"], ref["trans"],
                                                            ref["betas"]),
        "legacy_cli": lambda: legacy_cli.main(["--num_envs", "8", "--network_path", "/nonexistent/out"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
