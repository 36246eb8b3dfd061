"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every `csrc/*.cu` file is compiled for Hopper (`sm_90a`) by its own nvcc
process, all started together, and the objects are linked into one shared
library with a plain C interface under `build/` beside the package. The
library's name carries a hash of the sources and flags, so a changed source
is rebuilt and an unchanged one is reused within a checkout. Nothing is
built until a kernel is first launched. Processes that build at once (the
ranks of a data-parallel run) take turns through a file lock in `build/`:
the first builds, the others find the library when their turn comes.

Also the state every kernel wrapper shares: the launch counts and the
cache of constant tables each translation unit holds on each device.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
# no --use_fast_math: parity with the plain float32 path relies on the
# accurate acosf / expf / sqrtf / atan2f
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_report: dict = {}

# kernel launches per wrapper; each wrapper adds one where it launches its
# kernel and nowhere else
launches = {"step_reward_amp": 0, "observe": 0, "physics_step": 0, "physics_step_rows": 0, "reward_amp": 0}

# translation unit -> (its C upload function, the C size functions of the
# tables it takes, in order); each unit has its own __constant__ copies
_CONST_UNITS = {
    "step_reward_amp": ("k1_set_consts", ("k1_model_consts_bytes", "k1_env_consts_bytes")),
    "physics_step": ("k3_set_consts", ("k3_model_consts_bytes",)),
    "reward_amp": ("ra_set_consts", ("ra_env_consts_bytes",)),
}
_uploaded: dict = {}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def kernel_label(mangled: str) -> str:
    """A template kernel's mangled name as `name<G,View>`, e.g.
    `_Z19physics_step_kernelILi8ELb1EEvPKfS1_Pfi` -> `physics_step_kernel<8,1>`."""
    m = re.match(r"_Z(\d+)(\w+)", mangled)
    if not m:
        return mangled
    n = int(m.group(1))
    name, rest = m.group(2)[:n], m.group(2)[n:]
    args = re.findall(r"L[ib](\d+)E", rest) if rest.startswith("I") else []
    return f"{name}<{','.join(args)}>" if args else name


def _parse_ptxas(text: str) -> dict:
    """Registers, spill stores/loads and stack frame per kernel from
    `-Xptxas -v` output, keyed by `kernel_label`."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_label(m.group(1))
            out[name] = {}
        elif name and "stack frame" in line:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[name].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                                 spill_load_bytes=int(m.group(3)))
        elif name and "Used" in line and "registers" in line:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name]["registers"] = int(m.group(1))
    return out


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on `build/.lock`, across processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> Path:
    """Compile and link the kernels if this checkout has not yet; return
    the library's path. Raises with nvcc's output of every source that
    fails to compile."""
    lib_path = BUILD_DIR / f"libpulse_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    with _build_lock():
        if not lib_path.exists():
            _compile_and_link(lib_path)
    return lib_path


def _compile_and_link(lib_path: Path) -> None:
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{_digest()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, logs, failed = [], [], []
    for src, obj, proc in procs:
        log, _ = proc.communicate()
        logs.append(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name}:\n{log}")
        objs.append(str(obj))
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    build_report.update(seconds=time.perf_counter() - t0, ptxas=_parse_ptxas("\n".join(logs)))


def load() -> ctypes.CDLL:
    """The kernel library, built at first use, with every entry point's
    argument and result types declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i, ll, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_size_t
            lib.k1_model_consts_bytes.argtypes, lib.k1_model_consts_bytes.restype = [], sz
            lib.k1_env_consts_bytes.argtypes, lib.k1_env_consts_bytes.restype = [], sz
            lib.k1_set_consts.argtypes, lib.k1_set_consts.restype = [vp, sz, vp, sz, vp], i
            lib.k1_step_reward_amp.argtypes, lib.k1_step_reward_amp.restype = [vp, vp, i, i, i, vp], i
            lib.k1_kernel_info.argtypes, lib.k1_kernel_info.restype = [i, ctypes.POINTER(i)], i
            ptrs, strides = ctypes.POINTER(vp), ctypes.POINTER(ll)
            lib.k2_observe.argtypes, lib.k2_observe.restype = [ptrs, strides, vp, ll, i, i, i, i, i, vp], i
            lib.k2_kernel_info.argtypes, lib.k2_kernel_info.restype = [i, i, ctypes.POINTER(i)], i
            lib.k3_model_consts_bytes.argtypes, lib.k3_model_consts_bytes.restype = [], sz
            lib.k3_set_consts.argtypes, lib.k3_set_consts.restype = [vp, sz, vp], i
            lib.k3_work_bytes.argtypes, lib.k3_work_bytes.restype = [], sz
            lib.k3_physics_step.argtypes, lib.k3_physics_step.restype = [vp, vp, i, i, vp], i
            lib.k3_physics_step_rows.argtypes, lib.k3_physics_step_rows.restype = [vp, vp, vp, i, i, vp], i
            lib.k3_kernel_info.argtypes, lib.k3_kernel_info.restype = [i, i, ctypes.POINTER(i)], i
            lib.ra_env_consts_bytes.argtypes, lib.ra_env_consts_bytes.restype = [], sz
            lib.ra_set_consts.argtypes, lib.ra_set_consts.restype = [vp, sz, vp], i
            lib.ra_reward_amp.argtypes, lib.ra_reward_amp.restype = [ptrs, strides, ptrs, strides, i, vp], i
            lib.ra_kernel_info.argtypes, lib.ra_kernel_info.restype = [i, ctypes.POINTER(i)], i
            lib.k_error_string.argtypes, lib.k_error_string.restype = [i], ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: {load().k_error_string(rc).decode()} ({rc})")


def upload_consts(unit: str, owners: tuple, tables, dev, stream: int) -> None:
    """Upload a translation unit's constant tables on `stream` unless its
    copy on `dev` already holds those of `owners` (the model and/or env
    constants the tables were packed from, compared by identity: the cache
    holds them, so an id cannot be reused by another object while cached).
    `tables()` packs the bytes, in the order the unit's upload takes them."""
    key = (unit, dev.index)
    held = _uploaded.get(key)
    if held is not None and all(a is b for a, b in zip(held, owners)):
        return
    lib = load()
    setter, sizers = _CONST_UNITS[unit]
    packed = tables()
    if [getattr(lib, f)() for f in sizers] != [len(t) for t in packed]:
        raise RuntimeError(f"constant table layout differs between Python and csrc/{unit}.cu")
    args = [x for t in packed for x in (t, len(t))]
    check(getattr(lib, setter)(*args, stream), f"{unit} constant upload")
    _uploaded[key] = owners
