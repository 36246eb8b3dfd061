"""The reference's converted-AMASS pickle format, both directions.

Counterpart of `pulse_tpu/motion/reference_format.py` (≙ the reference's
scripts/data_process/convert_amass_isaac.py:26-143): SMPL-order axis-angle
poses -> per-joint xyzw quats, joint reorder to the MJCF humanoid's
depth-first order, the upright-start base rotation removed from the GLOBAL
rotations (global' = global * inv([.5, .5, .5, .5])), local rotations
recovered through the skeleton, the root translation offset by the
skeleton's root offset. An entry holds pose_quat_global / pose_quat /
trans_orig / root_trans_offset / beta / gender / pose_aa / fps.

The reference writes these files with `joblib.dump`, which is not a plain
pickle: each ndarray is pickled as a `joblib.numpy_pickle.NumpyArrayWrapper`
and its raw bytes follow the wrapper in the stream. `load_reference_pkl`
reads such a dump, and a plain pickle, without joblib; `save_reference_pkl`
writes a plain pickle, which `joblib.load` reads too.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from pulse_tpu_torch._device import resolve_device
from pulse_tpu_torch.kinematics.skeleton import SkeletonTree, forward_kinematics, global_to_local
from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.smpl.body_model import SMPL_JOINT_NAMES

# the reference's target joint order (convert_amass_isaac.py:48), which is
# the MJCF humanoid's depth-first order
MUJOCO_JOINT_NAMES = (
    "Pelvis", "L_Hip", "L_Knee", "L_Ankle", "L_Toe", "R_Hip", "R_Knee",
    "R_Ankle", "R_Toe", "Torso", "Spine", "Chest", "Neck", "Head",
    "L_Thorax", "L_Shoulder", "L_Elbow", "L_Wrist", "L_Hand", "R_Thorax",
    "R_Shoulder", "R_Elbow", "R_Wrist", "R_Hand",
)

UPRIGHT_BASE_ROT = np.asarray([0.5, 0.5, 0.5, 0.5], np.float32)


def smpl_to_mujoco_index() -> list[int]:
    """≙ smpl_2_mujoco (convert_amass_isaac.py:85)."""
    return [SMPL_JOINT_NAMES.index(n) for n in MUJOCO_JOINT_NAMES]


def axis_angle_to_quat(aa: np.ndarray) -> np.ndarray:
    """[..., 3] axis-angle -> [..., 4] xyzw, identity below 1e-8 rad."""
    angle = np.linalg.norm(aa, axis=-1, keepdims=True)
    safe = np.where(angle > 1e-8, angle, 1.0)
    half = 0.5 * angle
    xyzw = np.concatenate([aa / safe * np.sin(half), np.cos(half)], axis=-1)
    return np.where(angle > 1e-8, xyzw, np.asarray([0, 0, 0, 1.0]))


def convert_amass_entry(
    pose_aa: np.ndarray,     # [B, 72] SMPL-order axis-angle (hands zeroed)
    trans: np.ndarray,       # [B, 3]
    tree: SkeletonTree,
    fps: float = 30.0,
    beta: np.ndarray | None = None,
    gender: str = "neutral",
    upright_start: bool = True,
    device=None,
) -> dict:
    """One clip -> a reference-schema entry (convert_amass_isaac.py:93-140):
    `convert_amass_entries` of a single clip."""
    seq = {"pose_aa": pose_aa, "trans": trans, "fps": fps, "beta": beta, "gender": gender}
    return convert_amass_entries({0: seq}, tree, upright_start, device)[0]


# the most frames one FK program of `convert_amass_entries` takes
CHUNK_FRAMES = 1 << 18


def convert_amass_entries(seqs: dict, tree: SkeletonTree, upright_start: bool = True, device=None) -> dict:
    """{name: {"pose_aa" [T, 72], "trans" [T, 3], "fps"?, "beta"?,
    "gender"?}} -> {name: reference-schema entry}. FK is per frame, so the
    frames of all clips run as one batch on `device` (the card unless the
    caller names another), in chunks of at most CHUNK_FRAMES frames, in
    float32."""
    dev = resolve_device(device)
    names = list(seqs)
    pose_aa, quat, root = [], [], []
    for n in names:
        p = np.asarray(seqs[n]["pose_aa"])
        B = p.shape[0]
        p = np.concatenate([p[:, :66], np.zeros((B, 6), p.dtype)], axis=1)
        pose_aa.append(p)
        quat.append(axis_angle_to_quat(p.reshape(B, 24, 3)[:, smpl_to_mujoco_index()]).astype(np.float32))
        root.append(np.asarray(seqs[n]["trans"], np.float32) + np.asarray(tree.local_translation[0], np.float32))
    all_quat, all_root = np.concatenate(quat), np.concatenate(root)
    g_rot, l_rot = np.empty_like(all_quat), all_quat.copy()
    base_inv = q.quat_conjugate(torch.from_numpy(UPRIGHT_BASE_ROT).to(dev))
    for lo in range(0, all_quat.shape[0], CHUNK_FRAMES):
        hi = lo + CHUNK_FRAMES
        g, _ = forward_kinematics(tree, torch.from_numpy(all_quat[lo:hi]).to(dev),
                                  torch.from_numpy(all_root[lo:hi]).to(dev))
        if upright_start:
            # remove the y-up base rotation on the global frame
            # (convert_amass_isaac.py:113: global * inv(base))
            g = q.quat_mul(g, base_inv.expand_as(g))
            l_rot[lo:hi] = global_to_local(tree, g).cpu().numpy()
        g_rot[lo:hi] = g.cpu().numpy()
    out, lo = {}, 0
    for n, p, r in zip(names, pose_aa, root):
        s, hi = seqs[n], lo + p.shape[0]
        beta = s.get("beta")
        out[n] = {
            "pose_quat_global": g_rot[lo:hi],
            "pose_quat": l_rot[lo:hi],
            "trans_orig": np.asarray(s["trans"], np.float32),
            "root_trans_offset": r,
            "beta": np.zeros(10, np.float32) if beta is None else np.asarray(beta, np.float32),
            "gender": s.get("gender", "neutral"),
            "pose_aa": p,
            "fps": float(s.get("fps", 30.0)),
        }
        lo = hi
    return out


def save_reference_pkl(path: str, entries: dict) -> str:
    """Write a plain pickle (readable by `load_reference_pkl` and by
    `joblib.load`)."""
    with open(path, "wb") as fh:
        pickle.dump(entries, fh, protocol=pickle.HIGHEST_PROTOCOL)
    return path


# the magic numbers of joblib's compressed dumps (joblib/compressor.py)
_COMPRESSED = ((b"ZF", "zfile"), (b"\x78", "zlib"), (b"\x1f\x8b", "gzip"), (b"BZ", "bz2"),
               (b"\xfd\x37\x7a\x58\x5a", "xz"), (b"\x5d\x00", "lzma"), (b"\x04\x22\x4d\x18", "lz4"))


class _ArrayWrapper:
    """Stands in for joblib.numpy_pickle.NumpyArrayWrapper while its state
    (subclass, shape, order, dtype, allow_mmap, numpy_array_alignment_bytes)
    is built."""


class _JoblibUnpickler(pickle._Unpickler):
    """The pure-Python unpickler (the C one has no hook at BUILD) with
    joblib's array wrapper mapped to a reader of the bytes behind it: after
    the wrapper's BUILD come one byte giving a pad length, that many pad
    bytes (when the wrapper has an alignment), then the array's raw bytes in
    its order. Every other global resolves as in `pickle`, so torch tensors
    load through torch's own reducers."""

    dispatch = pickle._Unpickler.dispatch.copy()

    def __init__(self, fh, path: str):
        super().__init__(fh)
        self._path = path

    def find_class(self, module, name):
        if module.split(".")[0] == "joblib":
            if (module, name) == ("joblib.numpy_pickle", "NumpyArrayWrapper"):
                return _ArrayWrapper
            raise pickle.UnpicklingError(f"{self._path}: joblib's {module}.{name} is not supported (only "
                                         "uncompressed dumps of joblib >= 0.10, whose arrays are NumpyArrayWrapper)")
        return super().find_class(module, name)

    def _exact(self, n: int) -> bytearray:
        buf = bytearray(n)
        if n:
            self.readinto(buf)
        if len(buf) != n:
            raise pickle.UnpicklingError(f"{self._path}: truncated (an array's bytes end early)")
        return buf

    def _read_array(self, w: _ArrayWrapper) -> np.ndarray:
        dtype = np.dtype(w.dtype)
        if dtype.hasobject:
            raise pickle.UnpicklingError(f"{self._path}: an object array in a joblib dump is not supported")
        if getattr(w, "numpy_array_alignment_bytes", None) is not None:
            self._exact(self._exact(1)[0])
        shape = tuple(int(s) for s in w.shape)
        count = int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(self._exact(count * dtype.itemsize), dtype, count)
        arr = arr.reshape(shape[::-1]).T if w.order == "F" else arr.reshape(shape)
        return arr if dtype.isnative else arr.astype(dtype.newbyteorder("="))

    def load_build(self):
        super().load_build()
        if isinstance(self.stack[-1], _ArrayWrapper):
            self.stack.append(self._read_array(self.stack.pop()))

    dispatch[pickle.BUILD[0]] = load_build


def load_reference_pkl(path: str) -> dict:
    """Read a plain pickle or an uncompressed joblib dump, without joblib. A
    compressed dump, a joblib wrapper other than NumpyArrayWrapper, or an
    object array in a dump raises. Pickles can run code when loaded: load
    only files from a trusted source."""
    with open(path, "rb") as fh:
        head = fh.read(8)
        for prefix, name in _COMPRESSED:
            if head.startswith(prefix):
                raise ValueError(f"{path}: a {name}-compressed joblib dump; only plain pickles and uncompressed "
                                 "joblib dumps are read (re-dump it with compress=0)")
        fh.seek(0)
        return _JoblibUnpickler(fh, path).load()
