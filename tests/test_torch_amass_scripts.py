"""The port's three AMASS scripts against the JAX package's scripts on the
same tiny generated inputs, output against output, on the CPU.

- `convert_amass`: AMASS-style `*_poses.npz` at 120, 60 and 24 fps, one
  too short and one without poses -> `.mtn`, without and with the
  ground-height fix (`--smpl`, a synthetic SMPL pickle; the port's fix is
  one batched LBS): the same clips, rotations exact, translations within
  1e-5.
- `process_amass`: raw (framerates 24, 59.94, 100 and 250, a `bytes`
  gender, 2 betas), then db on the JAX raw stage's joblib dump (read
  without joblib) with torch-tensor entries added, the occlusion bounds at
  the edges (cut at 10, dropped at 9, a bound past the end, an
  irrecoverable issue) and the gendered ground fix over a synthetic
  SMPL triple, then isaac (through its command line, `--device cpu`):
  the same entries at every stage, to 1e-5.
- `convert_pose_data` (through its command line, `--device cpu`): the
  `smpl` kind (a clip and a static pose) and the `mdm` kind.
- `convert_amass_entry`, upright on and off, within 1e-5 of the JAX one,
  and on the card unless the caller names the CPU.
Every clip here is 10 frames long at 30 fps but the static pose's 2: the
JAX FK runs eagerly and compiles each op once per length.
"""

import functools
import os
import sys
from pathlib import Path

import joblib
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import convert_amass as jax_convert_amass  # noqa: E402
import convert_pose_data as jax_convert_pose_data  # noqa: E402
import process_amass as jax_process_amass  # noqa: E402

from jax_reference import reference_jit  # noqa: E402

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl_humanoid  # noqa: E402
from pulse_tpu.motion import reference_format as jax_reference_format  # noqa: E402
from pulse_tpu.motion.reference_format import convert_amass_entry as jax_convert_amass_entry  # noqa: E402

from pulse_tpu_torch.assets import load_smpl_humanoid  # noqa: E402
from pulse_tpu_torch.motion.archive import read_archive  # noqa: E402
from pulse_tpu_torch.motion.reference_format import convert_amass_entry, load_reference_pkl  # noqa: E402
from pulse_tpu_torch.scripts import convert_amass, convert_pose_data, process_amass  # noqa: E402
from pulse_tpu_torch.smpl.synthetic import write_smpl_pickle  # noqa: E402

TREE = load_smpl_humanoid().skeleton
TOL = 1e-5
T30 = 10          # every clip's length at 30 fps


def _sequence(rng, T):
    """SMPL-order axis-angle [T, 156] (hands included) and y-up trans."""
    poses = rng.uniform(-0.5, 0.5, (T, 156))
    poses[:, :3] = np.asarray([np.pi / 2, 0, 0]) + 0.2 * rng.standard_normal((T, 3))
    trans = rng.uniform(-1, 1, (T, 3)) + np.asarray([0, 0.9, 0])
    return poses, trans


def _close(a, b, path="", tol=TOL):
    """Same structure; arrays and tensors within tol, the rest equal."""
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            _close(a[k], b[k], f"{path}/{k}", tol)
    elif isinstance(a, (np.ndarray, torch.Tensor)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.fixture(scope="module", autouse=True)
def jax_reference_compiles():
    """The JAX scripts run their FK and global_to_local op by op, so every
    op compiles once a clip length; here each compiles as one program a
    length, as tests/jax_reference.py compiles a reference (the JAX
    package's files are not touched). Each script call loads its own
    skeleton, so the programs are keyed by the skeleton's contents."""
    def jitted(name):
        fn, cache = getattr(jax_reference_format, name), {}

        def call(tree, *args):
            key = (tree.node_names, tree.parent_indices.tobytes(), np.asarray(tree.local_translation).tobytes())
            if key not in cache:
                cache[key] = reference_jit(functools.partial(fn, tree))
            return cache[key](*args)
        return call

    with pytest.MonkeyPatch.context() as mp:
        for name in ("forward_kinematics", "global_to_local"):
            mp.setattr(jax_reference_format, name, jitted(name))
        yield


@pytest.fixture(scope="module")
def smpl_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("smpl")
    for seed, g in enumerate(("NEUTRAL", "MALE", "FEMALE")):
        write_smpl_pickle(str(d / f"SMPL_{g}.pkl"), TREE, num_surface_verts=48, seed=seed)
    return d


@pytest.mark.parametrize("smpl", [False, True])
def test_convert_amass_matches_jax(tmp_path, monkeypatch, smpl_dir, smpl):
    rng = np.random.default_rng(0)
    seqs = []
    for i, (fps, T) in enumerate(((120.0, 4 * T30), (60.0, 2 * T30), (24.0, T30), (120.0, 4 * T30 - 8))):
        poses, trans = _sequence(rng, T)
        seqs.append(str(tmp_path / f"s{i}_poses.npz"))
        np.savez(seqs[-1], poses=poses, trans=trans, mocap_framerate=fps)
    seqs.append(str(tmp_path / "shape.npz"))
    np.savez(seqs[-1], betas=np.zeros(16))
    extra = ["--smpl", str(smpl_dir / "SMPL_NEUTRAL.pkl")] if smpl else []
    monkeypatch.setattr(sys, "argv", ["convert_amass.py", str(tmp_path / "j.mtn"), *seqs, *extra])
    jax_convert_amass.main()
    convert_amass.main([str(tmp_path / "t.mtn"), *seqs, *extra, "--device", "cpu"])
    got, want = read_archive(str(tmp_path / "t.mtn")), read_archive(str(tmp_path / "j.mtn"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["fps"] == w["fps"] == 30.0 and g["local_rotation"].shape == (T30, 24, 4)
        np.testing.assert_array_equal(g["local_rotation"], w["local_rotation"])
        np.testing.assert_allclose(g["root_translation"], w["root_translation"], rtol=0, atol=TOL)


def test_process_amass_matches_jax(tmp_path, smpl_dir):
    rng = np.random.default_rng(1)
    root = tmp_path / "amass" / "FUZZ" / "subj"
    root.mkdir(parents=True)
    # every int(fps / 30)-th frame: T30 frames each; the 24 fps one is kept as is
    for i, fps in enumerate((24.0, 59.94, 100.0, 250.0, 30.0, 30.0)):
        poses, trans = _sequence(rng, T30 * max(int(fps / 30), 1))
        gender = (np.bytes_(b"female"), "male", "neutral")[i % 3]
        np.savez(root / f"seq{i}_poses.npz", poses=poses, trans=trans,
                 betas=rng.standard_normal(2 if i == 1 else 16), gender=gender, mocap_framerate=fps)
    paths = {k: str(tmp_path / f"{k}.pkl") for k in ("raw_j", "raw_t", "raw_in", "occl", "db_j", "db_t", "isaac_j",
                                                     "isaac_t")}
    raw = jax_process_amass.process_raw(str(tmp_path / "amass"), paths["raw_j"])
    _close(process_amass.process_raw(str(tmp_path / "amass"), paths["raw_t"]), raw)
    _close(load_reference_pkl(paths["raw_t"]), joblib.load(paths["raw_j"]))
    assert load_reference_pkl(paths["raw_t"])["FUZZ_subj_seq0"]["gender"] == "female"

    # the db stage's input: the raw dump plus two entries of torch tensors
    for i, g in enumerate(("female", "male")):
        poses, trans = _sequence(rng, 2 * T30)
        raw[f"FUZZ_torch_{i}"] = {"poses": torch.from_numpy(poses), "trans": torch.from_numpy(trans),
                                  "betas": torch.from_numpy(rng.standard_normal(16)), "gender": g,
                                  "mocap_framerate": 60.0}
    joblib.dump(raw, paths["raw_in"])
    keys = sorted(raw)
    joblib.dump({"0-" + keys[0]: {"issue": "sitting", "idxes": [10]},     # cut at 10: kept
                 "0-" + keys[1]: {"issue": "airborne", "idxes": [9]},     # under 10: dropped
                 "0-" + keys[2]: {"issue": "sitting", "idxes": [999]},    # past the end: whole
                 "0-" + keys[3]: {"issue": "occluded"}}, paths["occl"])   # irrecoverable: dropped
    db = jax_process_amass.process_db(paths["raw_in"], paths["db_j"], paths["occl"], str(smpl_dir))
    got = process_amass.process_db(paths["raw_in"], paths["db_t"], paths["occl"], str(smpl_dir), device="cpu")
    assert "0-" + keys[1] not in got and "0-" + keys[3] not in got and len(got) == len(raw) - 2
    _close(got, db)
    _close(load_reference_pkl(paths["db_t"]), joblib.load(paths["db_j"]))
    assert {v["pose_aa"].shape[0] for v in got.values()} == {T30}

    isaac = jax_process_amass.process_isaac(paths["db_j"], paths["isaac_j"])
    process_amass.main(["isaac", paths["db_t"], paths["isaac_t"], "--device", "cpu"])
    _close(load_reference_pkl(paths["isaac_t"]), isaac)
    _close(joblib.load(paths["isaac_t"]), joblib.load(paths["isaac_j"]))


def test_convert_pose_data_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    poses, trans = _sequence(rng, T30)
    pose_aa = poses[:, :72]
    src = {"motionA": {"pose_aa": pose_aa, "trans": trans, "beta": rng.standard_normal(10), "gender": "male"},
           "poseB": {"pose_aa": pose_aa[0], "trans": trans[0]}}
    mdm = {"gen0": {"pose_euler": np.degrees(pose_aa.reshape(T30, 24, 3)), "root_translation": trans}}
    for kind, data in (("smpl", src), ("mdm", mdm)):
        in_pkl = str(tmp_path / f"{kind}_in.pkl")
        joblib.dump(data, in_pkl)
        want = jax_convert_pose_data.convert(in_pkl, str(tmp_path / f"{kind}_j.pkl"), kind)
        convert_pose_data.main([kind, in_pkl, str(tmp_path / f"{kind}_t.pkl"), "--device", "cpu"])
        got = load_reference_pkl(str(tmp_path / f"{kind}_t.pkl"))
        _close(got, want)
        _close(load_reference_pkl(str(tmp_path / f"{kind}_t.pkl")), joblib.load(str(tmp_path / f"{kind}_j.pkl")))
    assert got["gen0"]["pose_quat"].shape == (T30, 24, 4)
    assert convert_pose_data.convert(str(tmp_path / "smpl_in.pkl"), str(tmp_path / "o.pkl"), "smpl",
                                     device="cpu")["poseB"]["pose_quat"].shape == (2, 24, 4)


@pytest.mark.parametrize("upright", [True, False])
def test_convert_amass_entry_matches_jax(upright):
    rng = np.random.default_rng(3)
    poses, trans = _sequence(rng, T30)
    beta = rng.standard_normal(10)
    got = convert_amass_entry(poses[:, :72], trans, TREE, fps=24.0, beta=beta, gender="female",
                              upright_start=upright, device="cpu")
    want = jax_convert_amass_entry(poses[:, :72], trans, jax_load_smpl_humanoid().skeleton, fps=24.0, beta=beta,
                                   gender="female", upright_start=upright)
    _close(got, want)
    assert got["pose_quat"].dtype == np.float32 and got["pose_aa"].shape == (T30, 72)


def test_fk_defaults_to_the_card(monkeypatch):
    """Without a device named, the scripts' FK asks for CUDA (and so raises
    where there is none) rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    poses, trans = _sequence(np.random.default_rng(4), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert_amass_entry(poses[:, :72], trans, TREE)
