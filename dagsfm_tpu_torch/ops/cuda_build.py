"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface, named by the hash of its source and of every header in
`csrc/` (so editing a shared header rebuilds every library), kept in
`build/` at the root of the checkout and loaded with ctypes. `load` builds
every missing library it is asked for at once, one nvcc process per source,
all started together, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

build_info: dict = {}   # name -> {"path", "rebuilt", "seconds", "ptxas"}
_libs: dict = {}


def _nvcc() -> str:
    for c in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def nvcc_command(src: Path, out: Path, defines=()) -> list:
    """nvcc for sm_90a into a shared library, with -D for each define."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", *(f"-D{d}" for d in defines), "-o", str(out),
            str(src)]


def _so_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def load(*names: str) -> dict:
    """name -> ctypes.CDLL for each csrc/<name>.cu, building those whose
    source and header hash has no library yet, in parallel."""
    todo = [n for n in names if n not in _libs]
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        so = _so_path(n)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(nvcc_command(CSRC / f"{n}.cu", tmp),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    tmp, so)
    failed = []
    for n, (p, tmp, so) in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"nvcc failed on {n}.cu ({p.returncode}):\n"
                          f"{out}\n{err}")
            continue
        os.replace(tmp, so)
        build_info[n] = {"ptxas": err.strip(),
                         "seconds": time.perf_counter() - t0}
    if failed:
        raise RuntimeError("\n".join(failed))
    for n in todo:
        so = _so_path(n)
        info = build_info.setdefault(
            n, {"seconds": time.perf_counter() - t0})
        info.update(path=str(so), rebuilt=n in procs)
        _libs[n] = ctypes.CDLL(str(so))
    return {n: _libs[n] for n in names}


def check_tensors(fn: str, tensors, dev) -> None:
    """Raise ValueError unless each (name, tensor, dtype, shape) is on
    `dev`, of that dtype and shape, contiguous, and, for the descriptor
    inputs (names starting with "d"), 16-byte aligned for vector loads."""
    for name, t, dt, shape in tensors:
        if t.device != dev:
            raise ValueError(f"{fn}: {name} on {t.device}, d1 on {dev}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must be {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if name.startswith("d") and t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned")


def set_signature(fn, n_ptrs_before: int, ints: list, n_ptrs_after: int):
    """argtypes = pointers, then the given ctypes scalars, then pointers;
    returns int (the CUDA error code, 0 = success). Set once per function:
    the wrappers call this on every launch."""
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs_before + list(ints)
                       + [ctypes.c_void_p] * n_ptrs_after)
        fn.restype = ctypes.c_int
    return fn
