"""The port's quality gate against the JAX package's, on the CPU: im_eval,
the procrustes alignment, the eval clip suites, the PMCP sampling weights
and `with_config`.

(a) One JAX `im_eval` call (one jit of its scan, in a module fixture) and
the port's on the same 2 one-second walking clips under the same
zero-action policy, with early termination off and 2 AMP steps (as
tests/test_eval.py). The scored-step counts and the failed clips must be
equal; the clips are built so that the post-step clock meets a clip's
length exactly, where the strict `t < length` boundary decides. The
metrics are means over a free rollout, and free rollouts of two correct
float32 paths drift apart under contact (QUALITY.md:210-212: 1.3e-2 m
median between Pallas and XLA at 0.3 s), so they are held to 10%
(relative); MPJPE-pa, which takes out the drift of the whole body, to 2%.
(b) The batched torch procrustes error against the JAX one and the numpy
per-frame one at float32 tolerance, a reflection included.
(c) The hard suite bit for bit; the graded suite at 1e-5 (its crouch
family's foot grounding runs each package's own FK).
(d) The hard and soft PMCP weights exactly, the uniform fallbacks included.
(e) `with_config` keeps the obs widths, the per-env body shapes and the
K3-rows rows cache, and shares the motion store (the live PMCP weights).
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env import EnvConfig as JaxEnvConfig, HumanoidImEnv as JaxEnv
from pulse_tpu.eval import im_eval as jax_im_eval
from pulse_tpu.eval.im_eval import _procrustes_aligned_err as jax_pa_np, _procrustes_err_jnp
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion import motion_lib as jax_motion_lib
from pulse_tpu.motion import synthetic as jax_synthetic
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model

from jax_reference import reference_compiles
from torch_close import assert_close

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv
from pulse_tpu_torch.env.humanoid_im_getup import GetupConfig, HumanoidImGetupEnv
from pulse_tpu_torch.eval import im_eval
from pulse_tpu_torch.eval.im_eval import _procrustes_aligned_err, _procrustes_err
from pulse_tpu_torch.motion import motion_lib, synthetic
from pulse_tpu_torch.motion.motion_lib import build_motion_data
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model

EVAL_CFG = dict(enable_early_termination=False, num_amp_obs_steps=2)
METRICS = ("mpjpe_g", "mpjpe_l", "vel_dist", "accel_dist")


def _zero_policy(action_dim, zeros):
    return lambda obs: zeros((obs.shape[0], action_dim))


@pytest.fixture(scope="module")
def spec():
    return load_smpl_humanoid()


@pytest.fixture(scope="module")
def evals(spec):
    jspec = jax_load_smpl()
    jmodel = jax_build_model(jspec, JaxPhysicsConfig())
    jmotion = jax_build_motion_data(jspec.skeleton, jax_synthetic.make_synthetic_clips(jspec.skeleton, 2, 1.0))
    # the env's own tables (AMP frames, ids) at the reference compile options
    # (tests/jax_reference.py): the metrics come out equal to the bit; the
    # model and the store keep the default build, which the free rollout
    # reads (at -O0 its accel_dist moves 23%)
    with reference_compiles():
        jenv = JaxEnv(jmodel, jmotion, JaxEnvConfig(**EVAL_CFG))
    want = jax_im_eval(jenv, _zero_policy(jenv.action_dim, jnp.zeros), batch_size=2, collect_pa=True)

    clips = synthetic.make_synthetic_clips(spec.skeleton, 2, 1.0)
    env = HumanoidImEnv(build_model(spec, PhysicsConfig(), device="cpu"),
                        build_motion_data(spec.skeleton, clips, device="cpu"), EnvConfig(**EVAL_CFG), device="cpu")
    got = im_eval(env, _zero_policy(env.action_dim, torch.zeros), batch_size=2, collect_pa=True)
    return env, got, want


def test_im_eval_scores_the_same_steps_and_failures(evals):
    env, got, want = evals
    dt = np.float32(env.model.config.control_dt)
    lengths = env.motion.motion_lengths.numpy()
    steps = np.float32(np.arange(1, 31)) * dt
    assert (steps[None] == lengths[:, None]).any(), "the boundary step t == length must occur"
    np.testing.assert_array_equal(got.per_motion_steps, (steps[None] < lengths[:, None]).sum(1))
    np.testing.assert_array_equal(got.per_motion_steps, want.per_motion_steps)
    np.testing.assert_array_equal(got.failed_motions, want.failed_motions)
    assert got.success_rate == want.success_rate


@pytest.mark.parametrize("name", METRICS + ("mpjpe_pa",))
def test_im_eval_metrics_match_jax(evals, name):
    _, got, want = evals
    g, w = getattr(got, name), getattr(want, name)
    assert np.isfinite(g) and g > 0
    np.testing.assert_allclose(g, w, rtol=0.02 if name == "mpjpe_pa" else 0.1)


def test_im_eval_per_clip_means_match_jax(evals):
    _, got, want = evals
    np.testing.assert_allclose(got.per_motion_mpjpe_g, want.per_motion_mpjpe_g, rtol=0.1)
    np.testing.assert_allclose(got.per_motion_mpjpe_l, want.per_motion_mpjpe_l, rtol=0.1)


def test_im_eval_pads_the_last_batch(evals):
    """A batch of 3 over 2 clips pads with the last clip and scores each
    clip once, as the batch of 2 does."""
    env, got, _ = evals
    padded = im_eval(env, _zero_policy(env.action_dim, torch.zeros), batch_size=3, collect_pa=False)
    np.testing.assert_array_equal(padded.per_motion_steps, got.per_motion_steps)
    np.testing.assert_allclose(padded.mpjpe_g, got.mpjpe_g, rtol=1e-5)
    assert padded.mpjpe_pa == 0.0


@pytest.mark.parametrize("reflect", [False, True])
def test_procrustes_matches_jax_and_numpy(reflect):
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(16, 24, 3)).astype(np.float32)
    a = rng.normal(size=(3, 3))
    rot, _ = np.linalg.qr(a)
    rot *= np.sign(np.linalg.det(rot))
    if reflect:   # the best orthogonal fit is a reflection: the det-sign flip
        rot = rot @ np.diag([1.0, 1.0, -1.0])
    gt = (1.3 * pred @ rot.T + rng.normal(size=3) + 0.05 * rng.normal(size=pred.shape)).astype(np.float32)
    got = _procrustes_err(torch.as_tensor(pred), torch.as_tensor(gt)).numpy()
    want = np.asarray(jax.jit(_procrustes_err_jnp)(jnp.asarray(pred), jnp.asarray(gt)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert _procrustes_aligned_err(pred, gt) == jax_pa_np(pred, gt)
    np.testing.assert_allclose(got.mean(), _procrustes_aligned_err(pred, gt), rtol=1e-4)


def test_hard_clips_equal_jax_bit_for_bit(spec):
    clips, names = synthetic.make_hard_clips(spec.skeleton)
    jclips, jnames = jax_synthetic.make_hard_clips(jax_load_smpl().skeleton)
    assert names == jnames == ["fast_run", "spin", "jump", "getup_supine", "sharp_turns", "crouch_walk"]
    for c, j in zip(clips, jclips):
        assert c["fps"] == j["fps"]
        for k in ("local_rotation", "root_translation"):
            assert c[k].dtype == j[k].dtype and np.array_equal(c[k], j[k]), k


def test_graded_suite_matches_jax(spec):
    clips, names, fams = synthetic.make_graded_suite(spec.skeleton)
    with reference_compiles():     # its eager FK at the reference compile options (tests/jax_reference.py)
        jclips, jnames, jfams = jax_synthetic.make_graded_suite(jax_load_smpl().skeleton)
    assert names == jnames and fams == jfams and len(names) == 30
    for c, j in zip(clips, jclips):
        np.testing.assert_array_equal(c["local_rotation"], j["local_rotation"])
        np.testing.assert_allclose(c["root_translation"], j["root_translation"], atol=1e-5)


@pytest.mark.parametrize("failed", [[0, 0, 0, 0, 0, 0], [1, 0, 0, 1, 1, 0], [1, 1, 1, 1, 1, 1], [0, 0, 0, 0, 0, 1]])
def test_hard_sampling_weight_matches_jax(failed):
    M = len(failed)
    data = build_motion_data_stub(M)
    got = motion_lib.update_hard_sampling_weight(data, torch.tensor(failed, dtype=torch.bool)).sampling_prob
    want = jax_motion_lib.update_hard_sampling_weight(_jax_stub(M), jnp.asarray(failed, bool))["sampling_prob"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(data.sampling_prob, torch.full((M,), 1.0 / M))   # a new store; the old one untouched


@pytest.mark.parametrize("history", [[0, 0, 0, 0, 0, 0], [3, 0, 1, 0, 0, 7]])
def test_soft_sampling_weight_matches_jax(history):
    M = len(history)
    got = motion_lib.update_soft_sampling_weight(build_motion_data_stub(M), torch.tensor(history)).sampling_prob
    want = jax_motion_lib.update_soft_sampling_weight(_jax_stub(M), jnp.asarray(history, jnp.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want["sampling_prob"]))


def build_motion_data_stub(M: int):
    """A MotionData whose tables are empty: the PMCP updates read only the
    clip count and the weights."""
    e = torch.zeros(0)
    return motion_lib.MotionData(gts=e, grs=e, gvs=e, gavs=e, lrs=e, dvs=e, length_starts=torch.zeros(M),
                                 motion_lengths=torch.ones(M), motion_num_frames=torch.ones(M),
                                 motion_dt=torch.ones(M), sampling_prob=torch.full((M,), 1.0 / M))


def _jax_stub(M: int):
    """The two members of the JAX MotionData the PMCP updates read."""
    return types.SimpleNamespace(num_motions=M, replace=lambda **kw: kw)


def test_with_config_keeps_shapes_rows_and_the_motion_store(spec):
    model = build_model(spec, PhysicsConfig(), device="cpu")
    motion = build_motion_data(spec.skeleton, synthetic.make_synthetic_clips(spec.skeleton, 2, 1.0), device="cpu")
    cfg = EnvConfig(has_shape_obs=True, has_shape_obs_disc=True, has_limb_weight_obs=True, num_amp_obs_steps=2)
    env = HumanoidImEnv(model, motion, cfg, device="cpu", seed=5)
    env.enable_shape_variation(4, generator=torch.Generator().manual_seed(0))
    env._model_rows(4)
    new = env.with_config(dataclasses.replace(cfg, enable_early_termination=False))
    assert type(new) is HumanoidImEnv and not new.config.enable_early_termination
    assert (new.obs_dim, new.amp_obs_dim) == (env.obs_dim, env.amp_obs_dim) == (955, 2 * 253)
    assert new.batched_model is env.batched_model and new._shape_obs_table is env._shape_obs_table
    assert new._model_rows_cache is env._model_rows_cache and new._shape_args is env._shape_args
    assert new.motion is env.motion and new.seed == 5
    st = new.reset_to(torch.tensor([0, 1, 0, 1]), torch.zeros(4))
    np.testing.assert_array_equal(st.obs[:, 358:379].numpy(), env._shape_obs_table[:, :21].numpy())
    with pytest.raises(ValueError, match="widths"):
        env.with_config(dataclasses.replace(cfg, has_limb_weight_obs=False))


def test_with_config_rebuilds_the_getup_env(spec):
    model = build_model(spec, PhysicsConfig(), device="cpu")
    motion = build_motion_data(spec.skeleton, synthetic.make_synthetic_clips(spec.skeleton, 2, 1.0), device="cpu")
    cfg = GetupConfig(num_fall_states=4, fall_settle_steps=1, num_amp_obs_steps=2)
    env = HumanoidImGetupEnv(model, motion, cfg, device="cpu")
    new = env.with_config(dataclasses.replace(cfg, enable_early_termination=False))
    assert type(new) is HumanoidImGetupEnv and new.fall_states.root_pos.shape == (4, 3)
    assert_close(new.fall_states.root_pos, env.fall_states.root_pos, rtol=0, atol=0)
