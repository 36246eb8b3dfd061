"""Parity of the PyTorch port's building blocks with the JAX package, on the
CPU: quaternion ops, the physics Model, the motion store query, the policy
network, and the plain versions of the CUDA kernels' stages (K1's reward /
termination / AMP epilogue, K2's observation). Inputs are made from a numpy
seed and handed to both packages as numpy arrays.

Also: the port imports no JAX, its entry points demand CUDA unless given
device="cpu", its asset file equals the JAX package's, the constant tables
the kernels read match the C structs' layout, the kernels' per-env math,
reward/AMP epilogue and observation headers, built for the host by g++,
agree with the plain functions, and the layout check of the tensors RA and
K2 read in place.
"""

import ast
import dataclasses
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env import EnvConfig as JaxEnvConfig, kernels as jk
from pulse_tpu.env import pallas_obs
from pulse_tpu.learning.networks import ActorCritic as JaxActorCritic
from pulse_tpu.learning.ppo import gaussian_neglogp as jax_neglogp
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.motion_lib import get_motion_state as jax_get_motion_state
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.ops import quat as jq
from pulse_tpu.physics import build_model as jax_build_model

from jax_reference import module_reference_compiles

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env import cuda_obs
from pulse_tpu_torch import run
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv
from pulse_tpu_torch.env.humanoid_im_getup import GetupConfig, HumanoidImGetupEnv
from pulse_tpu_torch.learning.networks import ActorCritic, actor_critic_from_jax
from pulse_tpu_torch.learning.ppo import gaussian_neglogp, policy_step
from pulse_tpu_torch.learning.running_norm import running_mean_std_from_jax
from pulse_tpu_torch.motion.motion_lib import build_motion_data, get_motion_state
from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
from pulse_tpu_torch.ops import quat as tq
from pulse_tpu_torch.physics import substep_cuda
from pulse_tpu_torch.physics.model import build_model

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

ROOT = Path(__file__).resolve().parent.parent
B = 16


@pytest.fixture(scope="module")
def port():
    spec = load_smpl_humanoid()
    model = build_model(spec, device="cpu")
    motion = build_motion_data(spec.skeleton, make_synthetic_clips(spec.skeleton, 4), device="cpu")
    env = HumanoidImEnv(model, motion, device="cpu")
    return spec, model, motion, env


@pytest.fixture(scope="module")
def jax_side():
    spec = jax_load_smpl()
    return jax_build_model(spec), jax_build_motion_data(spec.skeleton, jax_clips(spec.skeleton, 4))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


# --------------------------------------------------------------------------- #
# package hygiene
# --------------------------------------------------------------------------- #

def test_asset_json_identical():
    a = ROOT / "pulse_tpu" / "assets" / "data" / "smpl_humanoid.json"
    b = ROOT / "pulse_tpu_torch" / "assets" / "data" / "smpl_humanoid.json"
    assert a.read_bytes() == b.read_bytes()


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            mods.add(node.module)
    return mods


def test_port_imports_no_jax():
    files = sorted((ROOT / "pulse_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for m in _imported_modules(f):
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "pulse_tpu"), f"{f} imports {m}"


def test_entry_points_need_cuda_unless_cpu(monkeypatch, port):
    spec, model, motion, _ = port
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_motion_data(spec.skeleton, make_synthetic_clips(spec.skeleton, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        HumanoidImEnv(model, motion)
    with pytest.raises(RuntimeError, match="CUDA"):
        HumanoidImGetupEnv(model, motion, GetupConfig(num_fall_states=2, fall_settle_steps=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main([])          # the config's device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        ActorCritic(10, 3, actor_units=(8,), critic_units=(8,))
    ActorCritic(10, 3, actor_units=(8,), critic_units=(8,), device="cpu")


def test_unported_config_raises(port):
    """Shape variation with the getup env gives each env its own model and
    keeps the fall-state bank settled under the shared one (item 12, as the
    JAX package); an unknown control mode is refused."""
    _, model, motion, _ = port
    genv = HumanoidImGetupEnv(model, motion, GetupConfig(num_fall_states=2, fall_settle_steps=1), device="cpu")
    bank = genv.fall_states
    genv.enable_shape_variation(4)
    assert genv.fall_states is bank and genv.batched_model.batched
    with pytest.raises(ValueError, match="control_mode"):
        HumanoidImEnv(model, motion, EnvConfig(control_mode="torque"), device="cpu")


def _c_struct_words(src: str, name: str, consts: dict) -> int:
    """Number of 4-byte words in a C struct of int/float scalars and arrays."""
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    words = 0
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        typ, rest = decl.split(None, 1)
        assert typ in ("int", "float"), decl
        for var in rest.split(","):
            n = 1
            for dim in re.findall(r"\[(\w+)\]", var):
                n *= consts[dim] if dim in consts else int(dim)
            words += n
    return words


def test_constant_tables_match_c_structs(port):
    _, model, _, env = port
    consts = {"MAX_J": substep_cuda.MAX_J, "MAX_P": substep_cuda.MAX_P, "MAX_J1": substep_cuda.MAX_J1,
              "MAX_KEY": cuda_obs.MAX_KEY}
    csrc = ROOT / "pulse_tpu_torch" / "csrc"
    math_h, hdr, ra = ((csrc / f).read_text() for f in ("humanoid_math.cuh", "physics_step.cuh", "reward_amp.cuh"))
    for src, define in ((math_h, "MAX_J"), (hdr, "MAX_P"), (hdr, "MAX_J1"), (ra, "MAX_KEY")):
        assert int(re.search(r"#define %s (\d+)" % define, src).group(1)) == consts[define]
    assert consts["MAX_J1"] == consts["MAX_J"] + 1
    assert int(re.search(r"kRaRows = (\d+);", ra).group(1)) == cuda_obs.RA_ROWS
    assert int(re.search(r"constexpr int kGroup = (\d+);", hdr).group(1)) == substep_cuda.GROUP
    built = re.search(r"#define HM_GROUPS\(X\) (.*)", hdr).group(1)
    assert tuple(int(g) for g in re.findall(r"X\((\d+)\)", built)) == substep_cuda.BUILT_GROUPS
    assert substep_cuda.GROUP in substep_cuda.BUILT_GROUPS and 1 in substep_cuda.BUILT_GROUPS
    assert len(substep_cuda.model_const_table(model)) == 4 * _c_struct_words(hdr, "ModelConsts", consts)
    assert len(env.consts.table()) == 4 * _c_struct_words(ra, "EnvConsts", consts)


# --------------------------------------------------------------------------- #
# quaternion ops (atol 1e-5)
# --------------------------------------------------------------------------- #

def _quat_cases():
    rng = np.random.default_rng(0)
    q0 = _unit(rng.standard_normal((64, 4)))
    q1 = _unit(rng.standard_normal((64, 4)))
    q1[:4] = q0[:4]                      # slerp's |cos| >= 1 branch
    v = rng.standard_normal((64, 3)).astype(np.float32)
    em = (rng.standard_normal((64, 3)) * 1.5).astype(np.float32)
    em[:3] = 0.0                         # zero exp map -> identity
    t = rng.uniform(0, 1, 64).astype(np.float32)
    return {
        "quat_mul": (q0, q1),
        "quat_mul_norm": (q0, q1),
        "quat_rotate": (q0, v),
        "quat_rotate_inverse": (q0, v),
        "quat_to_exp_map": (q0,),
        "exp_map_to_quat": (em,),
        "quat_to_tan_norm": (q0,),
        "quat_angle": (q0,),
        "slerp": (q0, q1, t),
        "calc_heading_quat_inv": (q0,),
        "calc_heading_quat": (q0,),
        "normalize_angle": (rng.uniform(-10, 10, 64).astype(np.float32),),
    }


@pytest.mark.parametrize("name", sorted(_quat_cases()))
def test_quat_op_matches_jax(name):
    args = _quat_cases()[name]
    want = np.asarray(getattr(jq, name)(*map(jnp.asarray, args)))
    got = getattr(tq, name)(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# --------------------------------------------------------------------------- #
# model, motion store
# --------------------------------------------------------------------------- #

MODEL_FIELDS = (
    "local_translation", "body_mass", "body_com", "spatial_inertia", "joint_kp", "joint_kd",
    "joint_armature", "dof_lower", "dof_upper", "pd_action_offset", "pd_action_scale",
    "cp_body", "cp_offset", "cp_radius", "cp_friction",
)


def test_model_arrays_match(port, jax_side):
    _, model, _, _ = port
    jm, _ = jax_side
    assert model.levels == jm.levels and model.parents == jm.parents
    for f in MODEL_FIELDS:
        want = np.asarray(getattr(jm, f))
        got = getattr(model, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=f)


# positions agree to float rounding. Slerp and the angular-velocity tables
# take arccos of a cosine near 1 (consecutive frames barely rotate), where
# an ulp of the cosine moves the angle by ~1e-4 rad: rotations are held to
# 5e-4 and angular rates (x30 fps) to 5e-3
MOTION_ATOL = {"root_pos": 1e-5, "root_rot": 5e-4, "dof_pos": 5e-4, "root_vel": 1e-4, "root_ang_vel": 5e-3,
               "dof_vel": 5e-3, "rg_pos": 1e-5, "rb_rot": 5e-4, "body_vel": 1e-4, "body_ang_vel": 5e-3,
               "local_rot": 5e-4}


def test_get_motion_state_matches(port, jax_side):
    _, _, motion, _ = port
    _, jmd = jax_side
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 4, 64)
    times = rng.uniform(-0.1, 4.2, 64).astype(np.float32)   # both clamped ends
    # eager, op by op like the port: under jit XLA re-fuses the slerp, and
    # where an un-normalized slerp lands on w = 1.0 on one side and not the
    # other, exp-map dof_pos jumps by ~1e-2 (quat_to_exp_map's identity cut)
    want = jax_get_motion_state(jmd, jnp.asarray(ids, jnp.int32), jnp.asarray(times))
    got = get_motion_state(motion, torch.as_tensor(ids), torch.as_tensor(times))
    assert set(want) == set(got)
    for k, atol in MOTION_ATOL.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, err_msg=k)


# --------------------------------------------------------------------------- #
# policy
# --------------------------------------------------------------------------- #

def test_actor_critic_and_policy_step_match_jax():
    obs_dim, act_dim = 12, 5
    net = JaxActorCritic(action_dim=act_dim, actor_units=(32, 24), critic_units=(32, 16),
                         dtype=jnp.float32, learn_sigma=True)
    obs = np.random.default_rng(2).standard_normal((B, obs_dim)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(obs))["params"])
    params["log_sigma"] = np.linspace(-3, -1, act_dim).astype(np.float32)
    mu_j, ls_j, v_j = jax.jit(net.apply)({"params": params}, jnp.asarray(obs))

    tnet = actor_critic_from_jax(params, device="cpu")
    mu, ls, v = tnet(torch.as_tensor(obs))
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(mu_j), atol=1e-5)
    np.testing.assert_allclose(ls.detach().numpy(), np.asarray(ls_j), atol=1e-6)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(v_j), atol=1e-5)

    rms = {"mean": obs.mean(0), "var": obs.var(0) + 0.5, "count": np.float32(B)}
    obs_rms = running_mean_std_from_jax(rms)
    from pulse_tpu.learning.running_norm import RunningMeanStd as JaxRMS

    jrms = JaxRMS(**{k: jnp.asarray(x) for k, x in rms.items()})
    np.testing.assert_allclose(obs_rms.normalize(torch.as_tensor(obs)).numpy(),
                               np.asarray(jrms.normalize(jnp.asarray(obs))), atol=1e-6)

    g = torch.Generator().manual_seed(0)
    action, mu2, neglogp, value = policy_step(tnet, torch.as_tensor(obs), g, obs_rms=obs_rms)
    want = jax_neglogp(jnp.asarray(mu2.numpy()), jnp.asarray(ls.detach().numpy()), jnp.asarray(action.numpy()))
    np.testing.assert_allclose(neglogp.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(
        gaussian_neglogp(mu2, ls.detach(), mu2).numpy(),
        np.asarray(jax_neglogp(jnp.asarray(mu2.numpy()), jnp.asarray(ls.detach().numpy()), jnp.asarray(mu2.numpy()))),
        rtol=1e-5,
    )


# --------------------------------------------------------------------------- #
# plain versions of the kernels' stages
# --------------------------------------------------------------------------- #

def _stepped_like(port, seed):
    """A reset state whose bodies are jittered off the reference, and the
    reference at a later time: stands in for a stepped state."""
    _, _, motion, env = port
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(0, 4, B))
    t0 = torch.as_tensor(rng.uniform(0, 3.5, B).astype(np.float32))
    st = env.reset_to(ids, t0)
    ph = st.physics
    J = ph.body_pos.shape[1]
    jit = lambda shape, s: torch.as_tensor((s * rng.standard_normal(shape)).astype(np.float32))
    rot = tq.quat_unit(ph.body_rot + jit((B, J, 4), 0.05))
    ph = ph.replace(
        body_pos=ph.body_pos + jit((B, J, 3), 0.05), body_rot=rot, root_pos=ph.body_pos[:, 0] * 1.0,
        root_rot=rot[:, 0], body_vel=ph.body_vel + jit((B, J, 3), 0.3),
        body_ang_vel=ph.body_ang_vel + jit((B, J, 3), 0.3),
        joint_rot=tq.quat_unit(ph.joint_rot + jit((B, J - 1, 4), 0.05)),
        joint_omega=ph.joint_omega + jit((B, J - 1, 3), 0.3),
    )
    ph = ph.replace(root_pos=ph.body_pos[:, 0])
    ref = get_motion_state(motion, ids, t0 + 0.1)
    return ph, ref


def _jax_ref(ref):
    return {k: jnp.asarray(v.numpy()) for k, v in ref.items()}


@pytest.mark.parametrize("amp_v", [1, 2])
def test_k1_epilogue_plain_matches_jax(port, amp_v):
    ph, ref = _stepped_like(port, seed=3)
    e = dataclasses.replace(port[3].consts, amp_v=amp_v)
    reward, raw, dmean, dmax, amp = cuda_obs.reward_amp_plain(e, ph, ref)
    rid, kid = np.asarray(e.reset_ids), np.asarray(e.key_ids)
    cfg = JaxEnvConfig()

    @jax.jit
    def jax_epilogue(P, R):
        reward, raw = jk.compute_imitation_reward(
            P["body_pos"], P["body_rot"], P["body_vel"], P["body_ang_vel"],
            R["rg_pos"], R["rb_rot"], R["body_vel"], R["body_ang_vel"],
        )
        fallen = {
            (use_mean, thr): jk.compute_humanoid_im_reset(
                jnp.full(B, 5), P["body_pos"][:, rid], R["rg_pos"][:, rid], jnp.zeros(B, bool),
                termination_distance=thr, use_mean=use_mean,
            )[1]
            for use_mean in (True, False) for thr in (0.05, 0.1, 0.2)
        }
        args = (P["root_pos"], P["root_rot"], P["body_vel"][:, 0], P["body_ang_vel"][:, 0],
                jq.quat_to_exp_map(P["joint_rot"]).reshape(B, -1), P["joint_omega"].reshape(B, -1),
                P["body_pos"][:, kid])
        kw = dict(local_root_obs=cfg.local_root_obs, root_height_obs=cfg.root_height_obs)
        amp = (jk.build_amp_observations_smpl_v2(*args, P["body_vel"][:, kid], **kw) if amp_v == 2
               else jk.build_amp_observations_smpl(*args, **kw))
        return reward, raw, fallen, amp

    P = {f.name: jnp.asarray(getattr(ph, f.name).numpy()) for f in dataclasses.fields(ph)}
    jr, jraw, fallen, jamp = jax_epilogue(P, _jax_ref(ref))
    np.testing.assert_allclose(reward.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(raw.numpy(), np.asarray(jraw), atol=1e-5)
    for (use_mean, thr), want in fallen.items():
        dist = dmean if use_mean else dmax
        np.testing.assert_array_equal((dist > thr).numpy(), np.asarray(want))
    assert amp.shape[1] == cuda_obs.amp_obs_dim(24, 4, amp_v, True)
    np.testing.assert_allclose(amp.numpy(), np.asarray(jamp), atol=1e-5)


def test_k2_plain_matches_jax_kernels(port):
    ph, ref = _stepped_like(port, seed=4)
    got = cuda_obs.observe_plain(port[3].consts, ph, ref).numpy()
    @jax.jit
    def jax_obs(P, R):
        self_obs = jk.compute_humanoid_self_obs_max(P["body_pos"], P["body_rot"], P["body_vel"], P["body_ang_vel"])
        task = jk.compute_imitation_observations_v6(
            P["body_pos"][:, 0], P["body_rot"][:, 0], P["body_pos"], P["body_rot"], P["body_vel"],
            P["body_ang_vel"], R["rg_pos"][:, None], R["rb_rot"][:, None], R["body_vel"][:, None],
            R["body_ang_vel"][:, None],
        )
        return jnp.concatenate([self_obs, task], -1)

    P = {k: jnp.asarray(getattr(ph, k).numpy()) for k in ("body_pos", "body_rot", "body_vel", "body_ang_vel")}
    assert got.shape == (B, 934)
    np.testing.assert_allclose(got, np.asarray(jax_obs(P, _jax_ref(ref))), atol=1e-5)


def test_k2_plain_matches_pallas_kernel_body(port):
    """The TPU kernel's own body (pallas_obs._build_obs_kernel), called on
    plain [1, rows, B] arrays in place of its VMEM refs: the same arithmetic
    as pallas_observe(interpret=True) without the interpreter, which costs
    about a minute on the CPU. It computes the heading by half-angle
    identities where the plain version uses atan2: ~3e-5 apart
    (tests/test_pallas_obs.py), so 1e-3 here."""
    ph, ref = _stepped_like(port, seed=5)
    _, _, _, env = port
    e = dict(dataclasses.asdict(env.consts), key_ids=list(env.consts.key_ids), reset_ids=list(env.consts.reset_ids))
    kernel, n_in, n_out = pallas_obs._build_obs_kernel(e)
    rows = [ph.body_pos, ph.body_rot, ph.body_vel, ph.body_ang_vel,
            ref["rg_pos"], ref["rb_rot"], ref["body_vel"], ref["body_ang_vel"]]
    x = torch.cat([t.reshape(B, -1) for t in rows], dim=1).numpy().T[None].copy()
    assert x.shape == (1, n_in, B)
    want = np.zeros((1, n_out, B), np.float32)
    kernel(x, want)
    got = cuda_obs.observe_plain(env.consts, ph, ref).numpy()
    np.testing.assert_allclose(got, want[0].T, atol=1e-3)


# --------------------------------------------------------------------------- #
# the kernels' per-env math header, built for the host by g++
# --------------------------------------------------------------------------- #

_HOST_HARNESS = r"""
#include <cstdio>
#include <vector>
#include "humanoid_math.cuh"
using namespace hm;
static V3 v3at(const float* p) { return V3{p[0], p[1], p[2]}; }
static Q4 q4at(const float* p) { return Q4{p[0], p[1], p[2], p[3]}; }
static M3 m3at(const float* p) { M3 m; for (int k = 0; k < 9; ++k) m.m[k / 3][k % 3] = p[k]; return m; }
static S6 s6at(const float* p) { return S6{v3at(p), v3at(p + 3)}; }
static void put(std::vector<float>& o, V3 v) { o.push_back(v.x); o.push_back(v.y); o.push_back(v.z); }
static void put(std::vector<float>& o, Q4 q) { o.push_back(q.x); o.push_back(q.y); o.push_back(q.z); o.push_back(q.w); }
static void put(std::vector<float>& o, const M3& m) { for (int k = 0; k < 9; ++k) o.push_back(m.m[k / 3][k % 3]); }
static void put(std::vector<float>& o, const S6& s) { put(o, s.w); put(o, s.v); }
int main(int argc, char** argv) {
  FILE* f = std::fopen(argv[1], "rb");
  int n, width;
  if (std::fread(&n, 4, 1, f) != 1 || std::fread(&width, 4, 1, f) != 1) return 1;
  std::vector<float> in((size_t)n * width), out;
  if (std::fread(in.data(), 4, in.size(), f) != in.size()) return 1;
  std::fclose(f);
  for (int i = 0; i < n; ++i) {
    const float* p = in.data() + (size_t)i * width;
    const Q4 q0 = q4at(p), q1 = q4at(p + 4);
    const V3 v = v3at(p + 8), e = v3at(p + 11), r = v3at(p + 14);
    const S6 a = s6at(p + 17), b = s6at(p + 23);
    const M3 A = m3at(p + 29), B = m3at(p + 38), C = m3at(p + 47);
    float tn[6];
    put(out, qmul_norm(q0, q1));
    put(out, qrot(q0, v));
    put(out, expmap_to_quat(e));
    put(out, quat_to_expmap(q0));
    out.push_back(quat_angle(q0));
    tan_norm(q0, tn);
    for (float x : tn) out.push_back(x);
    put(out, zrot(-heading(q0)));
    put(out, inv3(A));
    put(out, solve6_sym(A, B, C, a));
    M3 oA, oB, oC;
    inertia_to_parent(q0, r, A, B, C, oA, oB, oC);
    put(out, oA); put(out, oB); put(out, oC);
    put(out, motion_to_child(q0, r, a));
    put(out, force_to_parent(q0, r, a));
    put(out, cross_motion(a, b));
    put(out, cross_force(a, b));
    put(out, mul_inertia(A, B, C, a));
  }
  f = std::fopen(argv[2], "wb");
  std::fwrite(out.data(), 4, out.size(), f);
  std::fclose(f);
  return 0;
}
"""


def test_kernel_math_header_matches_plain_functions(tmp_path):
    """csrc/humanoid_math.cuh is __host__ __device__: g++ builds it for the
    host, and each helper the kernels use must agree with the plain PyTorch
    function it mirrors (float32 rounding: atol 1e-5 on unit-scale values,
    relative 1e-4 on the inertia algebra)."""
    import shutil
    import subprocess

    from pulse_tpu_torch.physics import spatial as sp

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    src = tmp_path / "harness.cc"
    src.write_text(_HOST_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run([gxx, "-O2", "-std=c++17", "-I", str(ROOT / "pulse_tpu_torch" / "csrc"), str(src), "-o", str(exe)],
                   check=True, timeout=120)

    n = 256
    rng = np.random.default_rng(7)
    q0 = _unit(rng.standard_normal((n, 4)))
    q1 = _unit(rng.standard_normal((n, 4)))
    v, e, r = (rng.standard_normal((n, 3)).astype(np.float32) for _ in range(3))
    e[:4] = 0.0
    a6, b6 = (rng.standard_normal((n, 6)).astype(np.float32) for _ in range(2))
    # a symmetric positive-definite [[A, B], [B^T, C]] per sample
    L = rng.standard_normal((n, 6, 6)).astype(np.float32)
    I6 = (L @ L.transpose(0, 2, 1) + 6.0 * np.eye(6, dtype=np.float32)).astype(np.float32)
    A, B, C = I6[:, :3, :3], I6[:, :3, 3:], I6[:, 3:, 3:]
    x = np.concatenate([q0, q1, v, e, r, a6, b6, A.reshape(n, 9), B.reshape(n, 9), C.reshape(n, 9)], 1)
    (tmp_path / "in.bin").write_bytes(np.asarray([n, x.shape[1]], np.int32).tobytes() + x.tobytes())
    subprocess.run([str(exe), str(tmp_path / "in.bin"), str(tmp_path / "out.bin")], check=True, timeout=60)
    got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(n, -1)

    t = torch.as_tensor
    I6t, rt, at, bt = t(I6), t(r), t(a6), t(b6)
    Ip = sp.inertia_to_parent(t(q0), rt, I6t)
    want = [
        tq.quat_mul_norm(t(q0), t(q1)), tq.quat_rotate(t(q0), t(v)), tq.exp_map_to_quat(t(e)),
        tq.quat_to_exp_map(t(q0)), tq.quat_angle(t(q0))[:, None], tq.quat_to_tan_norm(t(q0)),
        tq.calc_heading_quat_inv(t(q0)), sp.inv3(t(A)).reshape(n, 9), sp.solve6_sym(I6t, at),
        Ip[:, :3, :3].reshape(n, 9), Ip[:, :3, 3:].reshape(n, 9), Ip[:, 3:, 3:].reshape(n, 9),
        sp.motion_to_child(t(q0), rt, at), sp.force_to_parent(t(q0), rt, at),
        sp.cross_motion(at, bt), sp.cross_force(at, bt), sp.mul_inertia(I6t, at),
    ]
    want = torch.cat(want, dim=1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


# --------------------------------------------------------------------------- #
# the reward/AMP epilogue header (K1's and RA's), built for the host by g++
# --------------------------------------------------------------------------- #

_EPILOGUE_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "observe.cuh"
#include "reward_amp.cuh"
using namespace hm;
// argv: mode, input file, output file. in: n, width (floats an env record,
// the env stride), n_out, then per mode:
//   k1 <lanes>: table bytes, EnvConsts, records bodies 13J | joint rot
//     4(J-1) | joint omega 3(J-1) | ref 13J (| pad); reward_amp over `lanes`
//     lanes (K1's group split), output records reward | raws | dists | AMP;
//   ra: the same input, read in place through RaIn (one pointer and env
//     stride per tensor), run as RA runs it (reward_amp_env, 32 lanes);
//   k2: J, local_root_obs, root_height_obs, task_col, records bodies 13J |
//     ref 13J (| pad); observe_body for every (env, body) pair.
static FILE* open_in(const char* path, int* n, int* width, int* n_out) {
  FILE* f = std::fopen(path, "rb");
  if (std::fread(n, 4, 1, f) != 1 || std::fread(width, 4, 1, f) != 1 || std::fread(n_out, 4, 1, f) != 1) std::exit(2);
  return f;
}
int main(int argc, char** argv) {
  const char* mode = argv[1];
  int n, width, n_out;
  FILE* f = open_in(argv[2], &n, &width, &n_out);
  std::vector<float> out;
  if (!std::strcmp(mode, "k2")) {
    int hdr[4];
    if (std::fread(hdr, 4, 4, f) != 4) return 2;
    const int J = hdr[0];
    std::vector<float> in((size_t)n * width);
    if (std::fread(in.data(), 4, in.size(), f) != in.size()) return 1;
    out.assign((size_t)n * n_out, -1e30f);
    const int offs[8] = {0, 3 * J, 7 * J, 10 * J, 13 * J, 16 * J, 20 * J, 23 * J};
    ObsIn x;
    for (int k = 0; k < kObsInputs; ++k) { x.p[k] = in.data() + offs[k]; x.stride[k] = width; }
    for (int e = 0; e < n; ++e)
      for (int b = 0; b < J; ++b)
        observe_body(x, e, b, J, hdr[1], hdr[2], RowsOut{out.data() + (size_t)e * n_out, 1}, hdr[3]);
  } else {
    int table_bytes;
    EnvConsts c;
    if (std::fread(&table_bytes, 4, 1, f) != 1 || table_bytes != (int)sizeof(EnvConsts) ||
        std::fread(&c, sizeof(EnvConsts), 1, f) != 1) return 2;
    std::vector<float> in((size_t)n * width);
    if (std::fread(in.data(), 4, in.size(), f) != in.size()) return 1;
    out.assign((size_t)n * n_out, -1e30f);
    const int J = c.J, Jm1 = J - 1;
    if (!std::strcmp(mode, "ra")) {
      const int offs[kRaInputs] = {0, 3 * J, 7 * J, 10 * J, 13 * J, 13 * J + 4 * Jm1, 13 * J + 7 * Jm1,
                                   16 * J + 7 * Jm1, 20 * J + 7 * Jm1, 23 * J + 7 * Jm1};
      RaIn x;
      for (int k = 0; k < kRaInputs; ++k) { x.p[k] = in.data() + offs[k]; x.stride[k] = width; }
      const int rows[5] = {0, 1, 5, 6, kRaRows};
      RaOut y;
      for (int k = 0; k < 5; ++k) { y.p[k] = out.data() + rows[k]; y.stride[k] = n_out; }
      RaEnv s;
      for (int e = 0; e < n; ++e) {
        std::memset(&s, 0xff, sizeof s);   // NaN: a read of a slot not staged shows
        reward_amp_env(Lanes<32>{0, 0u}, c, x, y, e, s);
      }
    } else {
      const int lanes = std::atoi(argv[4]);
      for (int i = 0; i < n; ++i) {
        const float* x = in.data() + (size_t)i * width;
        V3 pos[MAX_J], vel[MAX_J], ang[MAX_J], omega[MAX_J - 1];
        Q4 rot[MAX_J], jrot[MAX_J - 1];
        for (int b = 0; b < J; ++b) {
          pos[b] = V3{x[3 * b], x[3 * b + 1], x[3 * b + 2]};
          rot[b] = Q4{x[3 * J + 4 * b], x[3 * J + 4 * b + 1], x[3 * J + 4 * b + 2], x[3 * J + 4 * b + 3]};
          vel[b] = V3{x[7 * J + 3 * b], x[7 * J + 3 * b + 1], x[7 * J + 3 * b + 2]};
          ang[b] = V3{x[10 * J + 3 * b], x[10 * J + 3 * b + 1], x[10 * J + 3 * b + 2]};
        }
        const float* jr = x + 13 * J;
        const float* om = jr + 4 * Jm1;
        for (int j = 0; j < Jm1; ++j) {
          jrot[j] = Q4{jr[4 * j], jr[4 * j + 1], jr[4 * j + 2], jr[4 * j + 3]};
          omega[j] = V3{om[3 * j], om[3 * j + 1], om[3 * j + 2]};
        }
        for (int l = 0; l < lanes; ++l)
          reward_amp(c, pos, rot, vel, ang, jrot, omega, RowsIn{om + 3 * Jm1, 1},
                     RowsOut{out.data() + (size_t)i * n_out, 1}, l, lanes);
      }
    }
  }
  std::fclose(f);
  f = std::fopen(argv[3], "wb");
  std::fwrite(out.data(), 4, out.size(), f);
  std::fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def epilogue_harness(tmp_path_factory):
    import shutil
    import subprocess

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("epilogue")
    (d / "harness.cc").write_text(_EPILOGUE_HARNESS)
    subprocess.run([gxx, "-O2", "-std=c++17", "-I", str(ROOT / "pulse_tpu_torch" / "csrc"), str(d / "harness.cc"),
                    "-o", str(d / "harness")], check=True, timeout=120)
    return d


def _run_harness(d, mode: str, header: list, payload: bytes, n_out: int, *args) -> np.ndarray:
    """Run the host harness in `mode` on one input file; its [B, n_out]
    output."""
    import subprocess

    name = "_".join([mode, *map(str, header), *map(str, args)])
    (d / f"in_{name}.bin").write_bytes(np.asarray(header, np.int32).tobytes() + payload)
    out = d / f"out_{name}.bin"
    subprocess.run([str(d / "harness"), mode, str(d / f"in_{name}.bin"), str(out), *map(str, args)], check=True,
                   timeout=60)
    return np.fromfile(out, np.float32).reshape(B, n_out)


def _epilogue_case(port, epilogue_harness, amp_v: int, lanes: int, mode: str = "k1", pad: int = 0):
    """(the harness's [B, 7 + A] rows, reward_amp_plain's) on jittered
    stepped states: K1's epilogue over `lanes` lanes, or (mode "ra") RA's
    staged one-warp path; each env's input record followed by `pad` NaNs,
    so that the env stride exceeds the record."""
    ph, ref = _stepped_like(port, seed=6)
    e = dataclasses.replace(port[3].consts, amp_v=amp_v)
    want = torch.cat([t.reshape(B, -1) for t in cuda_obs.reward_amp_plain(e, ph, ref)], dim=1).numpy()
    x = torch.cat([t.reshape(B, -1) for t in [ph.body_pos, ph.body_rot, ph.body_vel, ph.body_ang_vel, ph.joint_rot,
                                               ph.joint_omega, ref["rg_pos"], ref["rb_rot"], ref["body_vel"],
                                               ref["body_ang_vel"]]], dim=1).numpy()
    x = np.concatenate([x, np.full((B, pad), np.nan, np.float32)], axis=1)
    table = e.table()
    got = _run_harness(epilogue_harness, mode, [B, x.shape[1], want.shape[1], len(table)], table + x.tobytes(),
                       want.shape[1], *([lanes] if mode == "k1" else []))
    return got, want


@pytest.mark.parametrize("amp_v", [1, 2])
def test_reward_amp_header_matches_plain(port, epilogue_harness, amp_v):
    """csrc/reward_amp.cuh, the epilogue K1 and RA run, against
    reward_amp_plain on jittered stepped states: float32 rounding in
    another order, 1e-5 (acosf and arccos of cosines near 1 in the rotation
    term are the widest)."""
    got, want = _epilogue_case(port, epilogue_harness, amp_v, 1)
    assert got.shape == (B, cuda_obs.RA_ROWS + cuda_obs.amp_obs_dim(24, 4, amp_v, True))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("amp_v, mode", [(1, "k1"), (2, "k1"), (1, "ra"), (2, "ra")],
                         ids=["1", "2", "ra-1", "ra-2"])
def test_reward_amp_header_lane_split_matches_one_lane(port, epilogue_harness, amp_v, mode):
    """K1 splits the epilogue's dof rows over its group's lanes; RA stages
    the env's inputs (read in place, with an env stride beyond the record,
    as K3's joint_rot has) and runs the per-body terms over a warp's 32
    lanes, then the ordered finish on lane 0. Both write every row, with
    the bits one lane writes."""
    one, _ = _epilogue_case(port, epilogue_harness, amp_v, 1)
    if mode == "k1":
        split, _ = _epilogue_case(port, epilogue_harness, amp_v, substep_cuda.GROUP)
    else:
        split, _ = _epilogue_case(port, epilogue_harness, amp_v, 32, mode="ra", pad=7)
    assert (split > -1e29).all()
    np.testing.assert_array_equal(split.view(np.uint32), one.view(np.uint32))


@pytest.mark.parametrize("flags", ["default", "global_root_no_height"])
def test_observe_header_matches_plain(port, epilogue_harness, flags):
    """csrc/observe.cuh, K2's per-(env, body) function, looped over (env,
    body) on the host against observe_plain at 1e-5 (float32 rounding in
    another order; the same atan2 heading). Its inputs are read with an env
    stride beyond the record, its task block starts past S = 21 shape
    columns, and it writes every column but those."""
    ph, ref = _stepped_like(port, seed=8)
    e = port[3].consts
    if flags != "default":
        e = dataclasses.replace(e, local_root_obs=False, root_height_obs=False)
    J, S = e.J, 21
    shape_obs = torch.full((B, S), -1e30)
    want = cuda_obs.observe_plain(e, ph, ref, shape_obs).numpy()
    x = torch.cat([t.reshape(B, -1) for t in [ph.body_pos, ph.body_rot, ph.body_vel, ph.body_ang_vel]
                   + cuda_obs._bodies(ref)], dim=1).numpy()
    x = np.concatenate([x, np.full((B, 5), np.nan, np.float32)], axis=1)
    n_self = cuda_obs.self_obs_dim(J, e.root_height_obs)
    header = [B, x.shape[1], want.shape[1], J, int(e.local_root_obs), int(e.root_height_obs), n_self + S]
    got = _run_harness(epilogue_harness, "k2", header, x.tobytes(), want.shape[1])
    assert want.shape[1] == cuda_obs.obs_dim(J, e.root_height_obs, S)
    np.testing.assert_array_equal(got[:, n_self : n_self + S], np.float32(-1e30))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_env_strided_reads_views_in_place_and_copies_permuted():
    """The layout check of RA's and K2's inputs: a contiguous tensor and a
    view into wider rows (physics_state_from_rows' joint_rot, the env
    stride the record width) are read in place; a tensor whose env block is
    not contiguous is copied once; a wrong width raises."""
    J = 5
    rows = torch.arange(7 * (174 + 16 * 24), dtype=torch.float32).reshape(7, -1)
    ph = substep_cuda.physics_state_from_rows(rows, 24)
    t, stride = substep_cuda.env_strided(ph.joint_rot, 4 * 23)
    assert t.data_ptr() == ph.joint_rot.data_ptr() and stride == rows.shape[1]
    assert torch.equal(rows[3, 7 : 7 + 4 * 23], t.flatten(1)[3])
    c = torch.randn(7, J, 3)
    t, stride = substep_cuda.env_strided(c, 3 * J)
    assert t is c and stride == 3 * J
    p = torch.randn(7, 3, J).transpose(1, 2)   # [7, J, 3], its env block strided
    t, stride = substep_cuda.env_strided(p, 3 * J)
    assert t.data_ptr() != p.data_ptr() and t.is_contiguous() and stride == 3 * J and torch.equal(t, p)
    with pytest.raises(ValueError):
        substep_cuda.env_strided(c, 4 * J)
