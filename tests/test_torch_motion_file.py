"""The port's motion files against the JAX package's, on the CPU.

- The `.mtn` archive: the port's writer gives the JAX package's bytes
  (through its native codec and through its numpy path), each package
  reads the other's file, and a bad magic, a wrong version or a file
  shorter or longer than its table raises.
- The reference's pickles without joblib: a `joblib.dump` of float32,
  float64 and integer arrays, a 0-d, a Fortran-ordered and a big-endian
  array, a torch tensor, `bytes` and `str` genders in nested dicts reads
  as `joblib.load` reads it; the port's plain pickle reads back with
  `joblib.load`; a compressed dump, joblib's older array wrapper and an
  object array raise, naming what they are.
- `load_motion_file` on `.npz`, `.mtn` and `.pkl` gives the JAX loader's
  clips exactly: names, shape rows (short and absent betas, `bytes`
  genders), the 1-frame hold, the skipped entries.
- `build_motion_data` of the loaded clips (3 (T, fps) groups: a 2-frame
  60 fps clip, two of 7 frames, one of 12; the port's chunks forced to 7
  frames, so that the (7, 30) group runs as two chunks) against the JAX
  package's at float32 tolerance, and bit for bit against one clip at a
  time.
- Batched `lbs` against the JAX package's on a synthetic SMPL model (run
  op by op: cheaper here than one compile) and against its own one-pose
  calls, `ground_height_offset` against the JAX vertices' lowest z;
  `GenderedSMPL`'s loading and neutral fallback.
- The CLI trains from a file: `python -m pulse_tpu_torch.run` on a joblib
  dump in a process where jax, pulse_tpu and joblib cannot be imported
  (every module of the port is imported there first); `run`'s store of a
  `.npz`, a `.mtn` and that dump is the loader's (training reads only
  that store, so one format trains). A missing file and an unknown
  extension raise.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

from jax_reference import REFERENCE_COMPILER_OPTIONS
from test_format_fuzz import random_sequence
from test_reference_pkl import make_amass_like_sequence

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl_humanoid
from pulse_tpu.motion import archive as jax_archive
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.loader import load_motion_file as jax_load_motion_file, save_npz as jax_save_npz
from pulse_tpu.smpl import body_model as jb

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.motion.archive import read_archive, write_archive
from pulse_tpu_torch.motion.loader import load_motion_file
from pulse_tpu_torch.motion import motion_lib
from pulse_tpu_torch.motion.motion_lib import build_motion_data
from pulse_tpu_torch.motion.reference_format import (
    axis_angle_to_quat,
    convert_amass_entry,
    load_reference_pkl,
    save_reference_pkl,
)
from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
from pulse_tpu_torch.smpl import body_model as tb
from pulse_tpu_torch.smpl.synthetic import write_smpl_pickle

ROOT = Path(__file__).resolve().parent.parent
TREE = load_smpl_humanoid().skeleton
TINY = ["env=im", "device=cpu", "num_envs=8", "learning.horizon_length=4", "learning.minibatch_size=16",
        "learning.mini_epochs=1", "learning.actor_units=[32,24]", "learning.critic_units=[32,24]", "max_epochs=1",
        "save_frequency=0", "log_frequency=1"]
POS_TOL = 1e-5      # float32 FK, positions and rotations
VEL_TOL = 1e-4      # velocities, relative to the field's largest magnitude


def _clips():
    return make_synthetic_clips(TREE, 3, seconds=1.0, seed=3)


def _equal(a, b):
    """Deep equality of loaded pickles: same keys, types, dtypes, values."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert list(a.ravel()) == list(b.ravel()) if a.dtype == object else np.array_equal(a, b)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def _clips_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
            else:
                assert x[k] == y[k] and type(x[k]) is type(y[k]), k


# --------------------------------------------------------------------------- #
# the .mtn archive
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("jax_path", ["native", "numpy"])
def test_archive_bytes_match_jax(tmp_path, monkeypatch, jax_path):
    cs = _clips()
    cs[1]["fps"] = 59.94
    if jax_path == "numpy":
        monkeypatch.setattr(jax_archive, "_LIB", None)
    else:
        assert jax_archive.have_native()
    jax_archive.write_archive(str(tmp_path / "j.mtn"), cs)
    write_archive(str(tmp_path / "t.mtn"), cs)
    assert (tmp_path / "j.mtn").read_bytes() == (tmp_path / "t.mtn").read_bytes()


def test_archive_cross_read(tmp_path):
    cs = _clips()
    jax_archive.write_archive(str(tmp_path / "j.mtn"), cs)
    write_archive(str(tmp_path / "t.mtn"), cs)
    _clips_equal(read_archive(str(tmp_path / "j.mtn")), jax_archive.read_archive(str(tmp_path / "t.mtn")))
    _clips_equal(read_archive(str(tmp_path / "j.mtn")), [{k: c[k] for k in ("fps", "local_rotation",
                                                                          "root_translation")} for c in cs])


@pytest.mark.parametrize("damage", ["magic", "version", "truncated_payload", "truncated_table", "no_header",
                                    "trailing_bytes"])
def test_bad_archive_raises(tmp_path, damage):
    path = str(tmp_path / "a.mtn")
    write_archive(path, _clips())
    data = bytearray(Path(path).read_bytes())
    if damage == "magic":
        data[0:8] = b"PULSEMTX"
    elif damage == "version":
        data[8:12] = (2).to_bytes(4, "little")
    elif damage == "truncated_payload":
        data = data[:-4]
    elif damage == "truncated_table":
        data = data[:30]
    elif damage == "no_header":
        data = data[:10]
    else:
        data += b"\0" * 8
    Path(path).write_bytes(bytes(data))
    with pytest.raises(ValueError, match="truncated|not a motion archive|bytes where"):
        read_archive(path)


# --------------------------------------------------------------------------- #
# the reference's pickles, read without joblib
# --------------------------------------------------------------------------- #

def _nested(rng):
    return {
        "clip_a": {"pose_quat": rng.standard_normal((4, 24, 4)).astype(np.float32),
                   "trans": rng.standard_normal((4, 3)), "ids": np.arange(12).reshape(3, 4),
                   "small": np.arange(5, dtype=np.int8), "fps": np.asarray(30.0), "gender": b"female",
                   "root_trans_offset": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))},
        "clip_b": {"gender": "male", "beta": rng.standard_normal(16), "empty": np.zeros((0, 3)),
                   "fortran": np.asfortranarray(rng.standard_normal((3, 5))), "big_endian": np.arange(6, dtype=">f4"),
                   "nested": {"list": [np.ones(2), {"deep": np.float32(2.5)}], "tuple": (1, "x")}},
    }


@pytest.mark.parametrize("protocol", [2, 4, 5])
def test_joblib_dump_reads_without_joblib(tmp_path, protocol):
    db = _nested(np.random.default_rng(protocol))
    path = str(tmp_path / "db.pkl")
    joblib.dump(db, path, protocol=protocol)
    with pytest.raises(pickle.UnpicklingError):   # not a plain pickle
        with open(path, "rb") as fh:
            pickle.load(fh)
    _equal(load_reference_pkl(path), joblib.load(path))


def test_plain_pickle_reads_with_joblib(tmp_path):
    db = _nested(np.random.default_rng(7))
    path = save_reference_pkl(str(tmp_path / "db.pkl"), db)
    _equal(joblib.load(path), load_reference_pkl(path))
    _equal(load_reference_pkl(path)["clip_a"]["root_trans_offset"], db["clip_a"]["root_trans_offset"])


@pytest.mark.parametrize("compress", [("zlib", 3), ("gzip", 3), ("bz2", 3), ("lzma", 3), ("xz", 3)])
def test_compressed_dump_raises(tmp_path, compress):
    path = str(tmp_path / "db.pkl")
    joblib.dump(_nested(np.random.default_rng(0)), path, compress=compress)
    with pytest.raises(ValueError, match=f"a {compress[0]}-compressed joblib dump"):
        load_reference_pkl(path)


@pytest.mark.parametrize("case", ["old_wrapper", "object_array"])
def test_other_joblib_content_raises(tmp_path, case):
    path = str(tmp_path / "db.pkl")
    if case == "old_wrapper":
        from joblib.numpy_pickle_compat import NDArrayWrapper

        Path(path).write_bytes(pickle.dumps({"a": NDArrayWrapper("a.npy", np.ndarray)}))
    else:
        joblib.dump({"a": np.asarray(["x", 1, None], dtype=object)}, path)
    with pytest.raises(pickle.UnpicklingError, match="NDArrayWrapper is not supported|object array"):
        load_reference_pkl(path)


# --------------------------------------------------------------------------- #
# load_motion_file and the store
# --------------------------------------------------------------------------- #

def _entry(rng, T, fps, walk=False, **kw):
    """An entry of the reference's schema from tests/test_format_fuzz.py's
    rough random poses, or tests/test_reference_pkl.py's walk (converted by
    the port: convert_amass_entry's parity is tests/test_torch_amass_scripts.py's)."""
    pose_aa, trans = make_amass_like_sequence(B=T, seed=T) if walk else random_sequence(rng, T)
    e = convert_amass_entry(pose_aa, trans, TREE, fps=fps, beta=rng.standard_normal(10), device="cpu")
    e.update(kw)
    return e


@pytest.fixture(scope="module")
def ref_pkl(tmp_path_factory):
    """A joblib dump in the reference's schema: a 1-frame 60 fps clip with a
    bytes gender and 2 betas, two 7-frame clips (torch-tensor fields, a
    clip without betas), a 12-frame walk, and four entries to skip."""
    rng = np.random.default_rng(11)
    e1 = _entry(rng, 7, 30.0, gender="male")
    e1["pose_quat"], e1["root_trans_offset"] = (torch.from_numpy(e1[k]) for k in ("pose_quat", "root_trans_offset"))
    e2 = _entry(rng, 7, 30.0, walk=True)
    del e2["beta"]
    wrong_j = _entry(rng, 5, 30.0)
    wrong_j["pose_quat"] = wrong_j["pose_quat"][:, :23]
    empty = _entry(rng, 3, 30.0)
    empty["pose_quat"] = empty["pose_quat"][:0]
    db = {"0-static": _entry(rng, 1, 60.0, gender=b"female", beta=np.asarray([0.5, -0.3])),
          "0-seven_a": e1, "meta": "not a clip", "0-seven_b": e2, "0-no_quat": {"pose_aa": np.zeros((3, 72))},
          "0-wrong_joints": wrong_j, "0-empty": empty, "0-twelve": _entry(rng, 12, 30.0, walk=True, gender="female")}
    path = str(tmp_path_factory.mktemp("ref") / "amass_isaac_fuzz.pkl")
    joblib.dump(db, path)
    return path


def test_load_pkl_matches_jax(ref_pkl):
    clips = load_motion_file(ref_pkl, TREE)
    _clips_equal(clips, jax_load_motion_file(ref_pkl, jax_load_smpl_humanoid().skeleton))
    assert [c["name"] for c in clips] == ["0-static", "0-seven_a", "0-seven_b", "0-twelve"]
    assert clips[0]["local_rotation"].shape[0] == 2 and np.array_equal(*clips[0]["local_rotation"])
    np.testing.assert_allclose(clips[0]["shape_params"], [2.0, 0.5, -0.3] + [0.0] * 8)
    assert clips[1]["shape_params"][0] == 1.0 and "shape_params" not in clips[2]


@pytest.mark.parametrize("fmt", ["npz", "mtn"])
def test_load_npz_mtn_matches_jax(tmp_path, fmt):
    cs = _clips()
    path = str(tmp_path / f"clips.{fmt}")
    (jax_save_npz if fmt == "npz" else write_archive)(path, cs)
    _clips_equal(load_motion_file(path, TREE), jax_load_motion_file(path, jax_load_smpl_humanoid().skeleton))


def test_unknown_extension_and_missing_file_raise(tmp_path):
    with pytest.raises(ValueError, match="unsupported motion file"):
        load_motion_file(str(tmp_path / "clips.bvh"), TREE)
    with pytest.raises(FileNotFoundError):
        load_motion_file(str(tmp_path / "absent.mtn"), TREE)


def test_store_matches_jax(ref_pkl, monkeypatch):
    clips = load_motion_file(ref_pkl, TREE)
    monkeypatch.setattr(motion_lib, "CHUNK_FRAMES", 7)    # the (7, 30) group in two chunks
    # the JAX build jits one program a (T, fps) group: compiled as
    # tests/jax_reference.py compiles a reference that runs once
    jit = jax.jit
    monkeypatch.setattr(jax, "jit", lambda f, **kw: jit(f, compiler_options=REFERENCE_COMPILER_OPTIONS, **kw))
    got = build_motion_data(TREE, clips, device="cpu")
    want = jax_build_motion_data(jax_load_smpl_humanoid().skeleton, clips)
    for k in ("length_starts", "motion_num_frames", "motion_lengths", "motion_dt", "shape_params", "limb_weights"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k)
    for k in ("gts", "grs", "lrs"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)), rtol=0, atol=POS_TOL,
                                   err_msg=k)
    for k in ("gvs", "gavs", "dvs"):
        w = np.asarray(getattr(want, k))
        np.testing.assert_allclose(getattr(got, k).numpy(), w, rtol=0, atol=VEL_TOL * np.abs(w).max(), err_msg=k)
    # the batched build is the one-clip-at-a-time build, bit for bit
    starts = got.length_starts.tolist()
    for i, c in enumerate(clips):
        one = build_motion_data(TREE, [c], device="cpu")
        T = c["local_rotation"].shape[0]
        for k in ("gts", "grs", "gvs", "gavs", "lrs", "dvs"):
            assert torch.equal(getattr(got, k)[starts[i] : starts[i] + T], getattr(one, k)), (i, k)


# --------------------------------------------------------------------------- #
# skinning
# --------------------------------------------------------------------------- #

def test_lbs_ground_offset_gendered_match_jax(tmp_path):
    write_smpl_pickle(str(tmp_path / "SMPL_NEUTRAL.pkl"), TREE, num_surface_verts=64, seed=0)
    write_smpl_pickle(str(tmp_path / "SMPL_MALE.pkl"), TREE, num_surface_verts=64, seed=1)
    tg, jg = tb.GenderedSMPL.load(str(tmp_path)), jb.GenderedSMPL.load(str(tmp_path))
    for g in ("neutral", "male", "female", 0, 1, 2, "other"):
        m, jm = tg.for_gender(g), jg.for_gender(g)
        assert np.array_equal(m.v_template, jm.v_template) and np.array_equal(m.shapedirs, jm.shapedirs), g
    assert tg.female is None and tg.for_gender("female") is tg.neutral
    with pytest.raises(FileNotFoundError):
        tb.GenderedSMPL.load(str(tmp_path / "none"))

    rng = np.random.default_rng(5)
    B = 4
    quat = axis_angle_to_quat(rng.uniform(-0.7, 0.7, (B, 24, 3))).astype(np.float32)
    betas = rng.standard_normal((B, 10)).astype(np.float32)
    trans = rng.standard_normal((B, 3)).astype(np.float32)
    model, jmodel = tg.male, jg.male
    # (the JAX ground_height_offset is held through the scripts' ground fix,
    # tests/test_torch_amass_scripts.py)
    j_lbs = jax.vmap(lambda b, p, t: jb.lbs(jmodel, b, p, t))
    jv, jj = (np.asarray(x) for x in j_lbs(jnp.asarray(betas), jnp.asarray(quat), jnp.asarray(trans)))
    args = (torch.from_numpy(betas), torch.from_numpy(quat), torch.from_numpy(trans))
    v, j = tb.lbs(model, *args)
    assert v.shape == (B, model.v_template.shape[0], 3) and j.shape == (B, 24, 3) and v.dtype == torch.float32
    np.testing.assert_allclose(v.numpy(), jv, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(j.numpy(), jj, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(tb.ground_height_offset(model, *args).numpy(), -jv[..., 2].min(axis=1), rtol=0,
                               atol=POS_TOL)
    for b in range(B):   # the batch is its poses one at a time; [S] betas broadcast
        vb, jb_ = tb.lbs(model, args[0][b], args[1][b : b + 1], args[2][b : b + 1])
        np.testing.assert_allclose(vb[0].numpy(), v[b].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(jb_[0].numpy(), j[b].numpy(), rtol=0, atol=1e-6)
    v64, _ = tb.lbs(model, *(a.double() for a in args))
    assert v64.dtype == torch.float64
    np.testing.assert_allclose(v64.numpy(), v.numpy(), rtol=0, atol=POS_TOL)


# --------------------------------------------------------------------------- #
# training from a file
# --------------------------------------------------------------------------- #

_BLOCKED = '''
import importlib.abc, pkgutil, runpy, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "pulse_tpu", "joblib", "__graft_entry__", "scripts"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
import pulse_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(pulse_tpu_torch.__path__, "pulse_tpu_torch.")]
for m in mods:
    __import__(m)
assert not any(n.split(".")[0] in ("jax", "pulse_tpu", "joblib", "__graft_entry__", "scripts") for n in sys.modules), \
    "leaked"
print("imported", len(mods), "modules")
sys.argv = ["pulse_tpu_torch.run", *sys.argv[1:]]
runpy.run_module("pulse_tpu_torch.run", run_name="__main__")
'''


def test_cli_trains_from_joblib_dump_without_jax_or_joblib(ref_pkl, tmp_path):
    # python -m pulse_tpu_torch.run ... env.motion_file=<a joblib dump>, in a
    # process where every module of the port is imported first
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _BLOCKED, *TINY, f"output_dir={tmp_path}",
                          f"env.motion_file={ref_pkl}"], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "imported" in out.stdout and out.stdout.count("epoch=0") == 1
    assert "nan" not in out.stdout.lower()


@pytest.mark.parametrize("fmt", ["npz", "mtn", "pkl"])
def test_run_builds_store_from_motion_file(ref_pkl, tmp_path, fmt):
    # the store `run` trains on (.npz and .mtn as the CLI test's .pkl)
    from pulse_tpu_torch.run import build_motion_from_cfg

    path = ref_pkl if fmt == "pkl" else str(tmp_path / f"clips.{fmt}")
    if fmt != "pkl":
        (jax_save_npz if fmt == "npz" else write_archive)(path, _clips())
    got = build_motion_from_cfg({"env": {"motion_file": path}}, load_smpl_humanoid(), "cpu")
    want = build_motion_data(TREE, load_motion_file(path, TREE), device="cpu")
    for k in ("gts", "grs", "gvs", "gavs", "lrs", "dvs", "length_starts", "motion_lengths", "shape_params"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k

