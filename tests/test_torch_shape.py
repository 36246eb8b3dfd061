"""Per-env body shapes in the port against the JAX package, on the CPU: the
batched model (isotropic scales and SMPL betas), the per-env model rows that
kernel K3-rows reads, and the batched plain physics step, which is K3-rows'
plain version; then the kernel's per-env code itself (csrc/physics_step.cuh
with its table and rows views), built for the host by g++, against that
plain step. Inputs are made from a numpy seed and handed to both packages as
numpy arrays.

Tolerances: model leaves 1e-6 relative (the same float32 products, powers of
s rounded apart by an ulp or two), SMPL joints and models 1e-5 (another
summation order), the physics those of tests/test_torch_physics.py.
"""

import dataclasses
import pickle
import shutil
import subprocess
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics import shape_variation as jsv
from pulse_tpu.physics.state import PhysicsState as JaxPhysicsState
from pulse_tpu.physics.step import physics_step as jax_physics_step
from pulse_tpu.physics.substep_pallas import _model_rows_layout, build_model_rows as jax_build_model_rows
from pulse_tpu.smpl import body_model as jbody
from pulse_tpu.smpl.synthetic import synthetic_smpl_data as jax_synthetic_smpl_data

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.ops import quat as tq
from pulse_tpu_torch.physics import shape_variation as sv
from pulse_tpu_torch.physics import substep_cuda
from pulse_tpu_torch.physics.model import BATCHED_LEAVES, PhysicsConfig, batched_model_from_numpy, build_model
from pulse_tpu_torch.physics.state import state_from_kinematics
from pulse_tpu_torch.physics.step import physics_step
from pulse_tpu_torch.smpl.body_model import load_smpl_model, shaped_joints
from pulse_tpu_torch.smpl.synthetic import write_smpl_pickle

ROOT = Path(__file__).resolve().parent.parent
N = 8
CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
PHYS_ATOL = {"root_pos": 2e-4, "root_rot": 2e-4, "body_pos": 3e-4, "body_rot": 2e-4, "root_vel6": 5e-3,
             "joint_omega": 5e-3, "body_vel": 5e-3, "body_ang_vel": 5e-3, "contact_force": 1.0}


def _leaves(jmodel) -> dict:
    return {k: np.asarray(getattr(jmodel, k)) for k in BATCHED_LEAVES + ("cp_body",)}


@pytest.fixture(scope="module")
def models():
    """(port shared model, JAX shared model, JAX scale-varied model of N envs)."""
    model = build_model(load_smpl_humanoid(), PhysicsConfig(**CFG), device="cpu")
    jm = jax_build_model(jax_load_smpl(), JaxPhysicsConfig(**CFG))
    return model, jm, jsv.vary_model_scales(jm, jax.random.PRNGKey(0), N)


def test_model_rows_equal_jax(models):
    model, jm, jbm = models
    assert substep_cuda.model_rows_layout(24, 68) == _model_rows_layout(24, 68)
    assert substep_cuda.model_rows_layout(24, 68)[1] == 859
    bm = batched_model_from_numpy(model, _leaves(jbm))
    np.testing.assert_array_equal(substep_cuda.build_model_rows(bm, N).numpy(),
                                  np.asarray(jax_build_model_rows(jbm, N)))
    # a shared model broadcasts (its spatial inertia taken from JAX's, which
    # rounds cx cx^T apart from the port's in an ulp of 9 entries)
    shared = dataclasses.replace(model, spatial_inertia=torch.as_tensor(np.array(jm.spatial_inertia)))
    np.testing.assert_array_equal(substep_cuda.build_model_rows(shared, 3).numpy(),
                                  np.asarray(jax_build_model_rows(jm, 3)))


def test_model_from_rows_rebuilds_the_batched_model(models):
    """The rows hold every per-env leaf the step reads; the spatial inertia's
    B and C blocks come back from mass and com."""
    model, _, jbm = models
    bm = batched_model_from_numpy(model, _leaves(jbm))
    back = substep_cuda.model_from_rows(model, substep_cuda.build_model_rows(bm, N))
    for f in BATCHED_LEAVES:
        np.testing.assert_allclose(getattr(back, f).numpy(), getattr(bm, f).numpy(), rtol=1e-6, atol=1e-9, err_msg=f)


def test_scale_model_matches_vary_model_scales(models):
    model, _, jbm = models
    # the scales as the JAX function draws them from its key
    s = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (N,), minval=0.9, maxval=1.1))
    got = sv.scale_model(model, torch.tensor(s))
    want = _leaves(jbm)
    assert got.batched and torch.equal(got.cp_body, model.cp_body)
    for f in BATCHED_LEAVES:
        assert getattr(got, f).shape == want[f].shape, f
        np.testing.assert_allclose(getattr(got, f).numpy(), want[f], rtol=1e-6, atol=0, err_msg=f)
    drawn = sv.draw_scales(torch.Generator().manual_seed(3), 4096, (0.9, 1.1))
    assert 0.9 <= float(drawn.min()) < 0.91 and 1.09 < float(drawn.max()) <= 1.1


def test_models_from_betas_match_jax(models, tmp_path):
    model, jm, _ = models
    spec = load_smpl_humanoid()
    path = write_smpl_pickle(str(tmp_path / "smpl.pkl"), spec.skeleton)
    want_data = jax_synthetic_smpl_data(jax_load_smpl().skeleton)
    with open(path, "rb") as fh:
        got_data = pickle.load(fh)
    assert set(got_data) == set(want_data)
    for k in want_data:
        np.testing.assert_array_equal(got_data[k], want_data[k], err_msg=k)

    betas = np.random.default_rng(0).standard_normal((N, 10)).astype(np.float32)
    betas[0] = 0.0
    smpl_t, smpl_j = load_smpl_model(path), jbody.load_smpl_model(path)
    np.testing.assert_allclose(shaped_joints(smpl_t, torch.as_tensor(betas)).numpy(),
                               np.asarray(jbody.shaped_joints(smpl_j, jnp.asarray(betas))), atol=1e-5)
    names = spec.skeleton.node_names
    got = sv.models_from_betas(model, smpl_t, torch.as_tensor(betas), names)
    want = _leaves(jsv.models_from_betas(jm, smpl_j, jnp.asarray(betas), names))
    for f in BATCHED_LEAVES:
        assert getattr(got, f).shape == want[f].shape, f
        np.testing.assert_allclose(getattr(got, f).numpy(), want[f], rtol=1e-5, atol=1e-5, err_msg=f)
    # betas = 0 gives back the skeleton the synthetic model was made from
    np.testing.assert_allclose(got.local_translation[0].numpy(), model.local_translation.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        sv.limb_weight_params(got.local_translation, got.body_mass, names).numpy(),
        np.asarray(jsv.limb_weight_params(jnp.asarray(want["local_translation"]), jnp.asarray(want["body_mass"]),
                                          names)),
        rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def stepped(models):
    """The batched plain step of N scale-varied humanoids, from states FK'd
    through each env's own model with half the envs' lowest contact point
    2 cm in the ground, against jax.jit(jax.vmap(physics_step))."""
    model, _, jbm = models
    bm = batched_model_from_numpy(model, _leaves(jbm))
    rng = np.random.default_rng(1)
    root_rot = tq.quat_unit(torch.as_tensor(
        np.concatenate([0.2 * rng.standard_normal((N, 3)), np.ones((N, 1))], 1).astype(np.float32)))
    dof = torch.as_tensor(np.clip(0.3 * rng.standard_normal((N, 69)), -1.5, 1.5).astype(np.float32))
    vel = lambda k: torch.as_tensor((0.3 * rng.standard_normal((N, k))).astype(np.float32))
    st = state_from_kinematics(bm, torch.zeros(N, 3), root_rot, dof, vel(3), vel(3), vel(69))
    cp = st.body_pos[:, bm.cp_body] + tq.quat_rotate(st.body_rot[:, bm.cp_body], bm.cp_offset)
    lowest = (cp[..., 2] - bm.cp_radius).amin(dim=1)
    lift = torch.zeros(N, 3)
    lift[:, 2] = torch.where(torch.arange(N) % 2 == 0, -0.02, 0.05) - lowest
    st = st.replace(root_pos=st.root_pos + lift, body_pos=st.body_pos + lift[:, None])
    pd = bm.pd_action_offset + bm.pd_action_scale * torch.as_tensor(rng.uniform(-0.5, 0.5, (N, 69)).astype(np.float32))

    ph = {f.name: getattr(st, f.name).numpy() for f in dataclasses.fields(st)}
    got = physics_step(bm, st, pd)
    want = jax.jit(jax.vmap(jax_physics_step))(
        jbm, JaxPhysicsState(**{k: jnp.asarray(v) for k, v in ph.items()}), jnp.asarray(pd.numpy()))
    return bm, st, pd, got, want


@pytest.mark.parametrize("field", sorted(PHYS_ATOL) + ["joint_rot"])
def test_batched_physics_step_matches_jax_vmap(stepped, field):
    _, _, _, got, want = stepped
    if field == "joint_rot":
        dots = np.sum(got.joint_rot.numpy() * np.asarray(want.joint_rot), axis=-1)
        assert np.abs(dots).min() > 1 - 1e-5
        return
    if field == "contact_force":
        assert np.abs(np.asarray(want.contact_force)).max() > 100.0, "no contact was exercised"
    np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), atol=PHYS_ATOL[field])


def test_k3_rows_wrapper_on_cpu_runs_the_rows_model(stepped):
    """physics_step_cuda with model rows on CPU tensors: the plain step of the
    batched model the rows hold."""
    bm, st, pd, got, _ = stepped
    base = dataclasses.replace(bm, **{f: getattr(bm, f)[0] for f in BATCHED_LEAVES})
    out = substep_cuda.physics_step_cuda(base, st, pd, model_rows=substep_cuda.build_model_rows(bm, N))
    for f, atol in PHYS_ATOL.items():
        np.testing.assert_allclose(getattr(out, f).numpy(), getattr(got, f).numpy(), atol=atol, err_msg=f)


# --------------------------------------------------------------------------- #
# the kernels' per-env physics (TableView for K1/K3, RowsView for K3-rows),
# built for the host by g++: the phase functions of csrc/physics_step.cuh,
# each run for every lane of a group of G in turn
# --------------------------------------------------------------------------- #

_STEP_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "physics_step.cuh"
using namespace hm;
static ModelConsts c;
static Work w;
static float hot[kHotRows];

// One env through step_env in a group of G lanes (on the host, Lanes runs
// each phase for lanes 0 .. G-1 in turn), K3-rows' hot rows staged as on
// the card.
template <int G>
static void step(const float* x, int n_in, int n_model, float* y) {
  const Lanes<G> run{0, 0u};
  const RowsIn in{x, 1};
  const RowsOut out{y, 1};
  if (n_model) {
    const RowsIn m{x + n_in, 1};
    run([&](int lane) { stage_hot_rows<G>(c.J, m, hot, lane); });
    step_env(run, RowsView(&c, &c, hot, m), w, in, out, true);
  } else {
    step_env(run, TableView{&c, &c}, w, in, out, true);
  }
}

// argv: input file, output file, G (1, 8 or kGroup). Input: n, n_in, n_out,
// n_model, table bytes, ModelConsts, then per env its step inputs [n_in]
// and its model rows [n_model] (n_model 0: TableView).
int main(int argc, char** argv) {
  if (argc != 4) return 2;
  FILE* f = std::fopen(argv[1], "rb");
  int n, n_in, n_out, n_model, table_bytes;
  if (std::fread(&n, 4, 1, f) != 1 || std::fread(&n_in, 4, 1, f) != 1 || std::fread(&n_out, 4, 1, f) != 1 ||
      std::fread(&n_model, 4, 1, f) != 1 || std::fread(&table_bytes, 4, 1, f) != 1 ||
      table_bytes != (int)sizeof(ModelConsts) || std::fread(&c, sizeof(ModelConsts), 1, f) != 1) return 2;
  const int width = n_in + n_model, G = std::atoi(argv[3]);
  std::vector<float> in((size_t)n * width), out((size_t)n * n_out, -1e30f);
  if (std::fread(in.data(), 4, in.size(), f) != in.size()) return 1;
  std::fclose(f);
  for (int i = 0; i < n; ++i) {
    const float* x = in.data() + (size_t)i * width;
    float* y = out.data() + (size_t)i * n_out;
    if (G == 1) step<1>(x, n_in, n_model, y);
    else if (G == 8) step<8>(x, n_in, n_model, y);
    else if (G == kGroup) step<kGroup>(x, n_in, n_model, y);
    else return 3;
  }
  f = std::fopen(argv[2], "wb");
  std::fwrite(out.data(), 4, out.size(), f);
  std::fclose(f);
  return 0;
}
"""
N_OUT = substep_cuda.state_rows(24) + 16 * 24


@pytest.fixture(scope="module")
def header_step(stepped, tmp_path_factory):
    """run(view, G) -> the [N, N_OUT] records control_step of
    csrc/physics_step.cuh writes on the host for the `stepped` inputs, in
    groups of G lanes: RowsView (K3-rows) on the scale-varied envs, TableView
    (K1, K3) on env 0's model shared by all. The harness is built once."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    bm, st, pd, _, _ = stepped
    d = tmp_path_factory.mktemp("harness")
    (d / "harness.cc").write_text(_STEP_HARNESS)
    subprocess.run([gxx, "-O2", "-std=c++17", "-I", str(ROOT / "pulse_tpu_torch" / "csrc"), str(d / "harness.cc"),
                    "-o", str(d / "harness")], check=True, timeout=240)
    base = dataclasses.replace(bm, **{f: getattr(bm, f)[0] for f in BATCHED_LEAVES})
    table = substep_cuda.model_const_table(base)
    x = torch.cat([t.reshape(N, -1) for t in (st.root_pos, st.root_rot, st.joint_rot, st.root_vel6,
                                              st.joint_omega, pd)], dim=1)
    for view, n_model in (("rows", 859), ("table", 0)):
        xv = torch.cat([x, substep_cuda.build_model_rows(bm, N)], dim=1) if n_model else x
        (d / f"{view}.bin").write_bytes(np.asarray([N, 243, N_OUT, n_model, len(table)], np.int32).tobytes() + table
                                        + xv.numpy().astype(np.float32).tobytes())
    outs = {}

    def run(view: str, G: int) -> np.ndarray:
        if (view, G) not in outs:
            out = d / f"{view}_{G}.out"
            subprocess.run([str(d / "harness"), str(d / f"{view}.bin"), str(out), str(G)], check=True, timeout=60)
            outs[view, G] = np.fromfile(out, np.float32).reshape(N, N_OUT)
        return outs[view, G]

    return run


@pytest.mark.parametrize("view", ["rows", "table"])
def test_kernel_physics_header_matches_plain_step(stepped, header_step, view):
    """control_step of csrc/physics_step.cuh on the host, in groups of the
    kernels' G lanes: RowsView (K3-rows) on the scale-varied envs against the
    batched plain step, TableView (K1, K3) on env 0's model shared by all
    against the shared plain step; to the physics tolerances K1 is held to
    on the card."""
    bm, st, pd, got, _ = stepped
    if view == "rows":
        want = got
    else:
        want = physics_step(dataclasses.replace(bm, **{f: getattr(bm, f)[0] for f in BATCHED_LEAVES}), st, pd)
    out = substep_cuda.physics_state_from_rows(torch.as_tensor(header_step(view, substep_cuda.GROUP)), 24)
    assert float(want.contact_force.abs().max()) > 100.0
    for f, atol in PHYS_ATOL.items():
        np.testing.assert_allclose(getattr(out, f).numpy(), getattr(want, f).numpy(), atol=atol, err_msg=f)


@pytest.mark.parametrize("G", sorted({8, substep_cuda.GROUP}))
@pytest.mark.parametrize("view", ["rows", "table"])
def test_kernel_physics_header_groups_match_one_lane_bitwise(header_step, view, G):
    """The phases split bodies, joints and contact points over a group's
    lanes but sum in the same order for every G: G lanes and one lane write
    the same bits, on envs in ground contact."""
    one, many = header_step(view, 1), header_step(view, G)
    contact = substep_cuda.physics_state_from_rows(torch.as_tensor(one), 24).contact_force
    assert int((contact.abs().amax(dim=(1, 2)) > 100.0).sum()) >= N // 2
    assert np.isfinite(one).all()
    np.testing.assert_array_equal(many.view(np.uint32), one.view(np.uint32))
