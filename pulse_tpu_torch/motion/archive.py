"""The packed motion archive (`.mtn`), written and read in numpy.

Counterpart of `pulse_tpu/motion/archive.py`, in the format of
`native/motion_codec.cc` (all little-endian):

    magic u64 "PULSEMTN", version u32 (1), num_clips u32, num_joints u32,
    reserved u32
    per clip: fps f32, num_frames u32
    payload, clip after clip: local_rotation [T, J, 4] f32 (xyzw), then
    root_translation [T, 3] f32

The writer gives the bytes the JAX package's writer gives. The reader maps
the file once and copies each clip's blocks out of the map in one pass.
"""

from __future__ import annotations

import mmap
import os
import struct

import numpy as np

MAGIC = 0x4E544D45534C5550   # "PULSEMTN" read as a little-endian u64
VERSION = 1
_HEADER = struct.Struct("<QIIII")
_META = np.dtype([("fps", "<f4"), ("num_frames", "<u4")])


def write_archive(path: str, clips: list[dict]) -> None:
    """clips: [{"fps", "local_rotation" [T, J, 4], "root_translation" [T, 3]}]."""
    J = int(np.shape(clips[0]["local_rotation"])[1])
    meta = np.empty(len(clips), _META)
    meta["fps"] = [float(c["fps"]) for c in clips]
    meta["num_frames"] = [int(np.shape(c["local_rotation"])[0]) for c in clips]
    with open(path, "wb") as fh:
        fh.write(_HEADER.pack(MAGIC, VERSION, len(clips), J, 0))
        fh.write(meta.tobytes())
        for c in clips:
            fh.write(np.ascontiguousarray(c["local_rotation"], "<f4").tobytes())
            fh.write(np.ascontiguousarray(c["root_translation"], "<f4").tobytes())


def read_archive(path: str) -> list[dict]:
    """The clips of an archive, each {"fps", "local_rotation" [T, J, 4],
    "root_translation" [T, 3]} in float32. A bad magic or version, or a file
    shorter or longer than its table says, raises ValueError."""
    size = os.path.getsize(path)
    if size < _HEADER.size:
        raise ValueError(f"{path}: truncated motion archive ({size} bytes, no header)")
    with open(path, "rb") as fh, mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        magic, version, n, J, _ = _HEADER.unpack_from(mm)
        if magic != MAGIC or version != VERSION:
            raise ValueError(f"{path}: not a motion archive of version {VERSION} (magic {magic:#x}, version {version})")
        table_end = _HEADER.size + n * _META.itemsize
        if size < table_end:
            raise ValueError(f"{path}: truncated motion archive (the clip table needs {table_end} bytes, "
                             f"the file has {size})")
        meta = np.frombuffer(mm, _META, n, _HEADER.size).copy()
        frames = meta["num_frames"].astype(np.int64)
        want = table_end + int(frames.sum()) * 4 * (4 * J + 3)
        if size != want:
            raise ValueError(f"{path}: {size} bytes where the clip table says {want}"
                             + (" (truncated)" if size < want else ""))
        clips, off = [], table_end
        for fps, T in zip(meta["fps"].tolist(), frames.tolist()):
            rot = np.frombuffer(mm, "<f4", T * J * 4, off).reshape(T, J, 4).astype(np.float32)
            off += rot.nbytes
            trans = np.frombuffer(mm, "<f4", T * 3, off).reshape(T, 3).astype(np.float32)
            off += trans.nbytes
            clips.append({"fps": fps, "local_rotation": rot, "root_translation": trans})
    return clips
