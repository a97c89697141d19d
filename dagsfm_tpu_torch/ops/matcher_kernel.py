"""Fused ratio-test + mutual-check matcher: CUDA kernel and plain version.

Replaces `_fused_matcher_kernel` (dagsfm_tpu/ops/pallas_matcher.py, entry
`pallas_match_j_batch`). The kernel is `csrc/fused_matcher.cu`, compiled
with nvcc for sm_90a into a shared library with a plain C interface and
loaded with ctypes; see the .cu file for the design and its bound.

`fused_match_j` launches the kernel for CUDA tensors and runs the plain
PyTorch version (`fused_match_j_reference`) only for CPU tensors; for a
CUDA tensor it launches or raises, never falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fused_matcher.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

launches = 0          # kernel launches (one per fused_match_j on a GPU)
build_info: dict = {}  # {"path", "rebuilt", "seconds"} after the first load
_lib = None


def _nvcc() -> str:
    cand = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the fused matcher kernel needs the "
                       "CUDA toolkit to build")


def load_library():
    """Build (when the source hash changed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    src = _SRC.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    so = _BUILD_DIR / f"fused_matcher_{digest}.so"
    t0 = time.perf_counter()
    rebuilt = not so.exists()
    if rebuilt:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        build_info["ptxas"] = proc.stderr.strip()
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.fused_match_j_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    build_info.update(path=str(so), rebuilt=rebuilt,
                      seconds=time.perf_counter() - t0)
    _lib = lib
    return lib


def fused_match_j_reference(d1, d2, m1, m2, max_ratio: float = 0.8,
                            max_distance: float = 0.7,
                            cross_check: bool = True) -> torch.Tensor:
    """Plain PyTorch version: bf16-rounded inputs, f32 product, max /
    masked max / first-index argmax. d1, d2 (B, K, D); m1, m2 (B, K) bool.
    Returns j (B, K) int32, -1 = no match."""
    a = d1.to(torch.bfloat16).float()
    b = d2.to(torch.bfloat16).float()
    sim = a @ b.transpose(-1, -2)                             # (B, K, K)
    neg = torch.tensor(-torch.inf, dtype=sim.dtype, device=sim.device)
    sim = torch.where(m1[:, :, None] & m2[:, None, :], sim, neg)
    best, bidx = torch.max(sim, dim=-1)
    cols = torch.arange(sim.shape[-1], device=sim.device)
    second = torch.where(cols == bidx[..., None], neg, sim).amax(-1)
    d_best = torch.sqrt(torch.clamp(2.0 - 2.0 * best, min=0.0))
    d_second = torch.sqrt(torch.clamp(2.0 - 2.0 * second, min=1e-12))
    ok = (d_best < max_ratio * d_second) & (d_best < max_distance) & m1
    if cross_check:
        rev = torch.argmax(sim, dim=1)                        # (B, K)
        rows = torch.arange(sim.shape[1], device=sim.device)
        ok = ok & (torch.gather(rev, 1, bidx) == rows)
    return torch.where(ok, bidx, -1).to(torch.int32)


def fused_match_j(d1, d2, m1, m2, max_ratio: float = 0.8,
                  max_distance: float = 0.7,
                  cross_check: bool = True) -> torch.Tensor:
    """Fused matcher: (B, K) int32 j per row of d1, -1 = no match.

    CUDA tensors: d1, d2 (B, K, 128) bf16 contiguous, m1, m2 (B, K) bool
    contiguous, all on one device; anything else raises. CPU tensors run
    the plain version."""
    global launches
    if d1.device.type == "cpu":
        return fused_match_j_reference(d1, d2, m1, m2, max_ratio,
                                       max_distance, cross_check)
    if d1.device.type != "cuda":
        raise ValueError(f"fused_match_j: unsupported device {d1.device}")
    B, K, D = d1.shape
    for name, t, dt, shape in (("d1", d1, torch.bfloat16, (B, K, 128)),
                               ("d2", d2, torch.bfloat16, (B, K, 128)),
                               ("m1", m1, torch.bool, (B, K)),
                               ("m2", m2, torch.bool, (B, K))):
        if t.device != d1.device:
            raise ValueError(f"fused_match_j: {name} on {t.device}, "
                             f"d1 on {d1.device}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"fused_match_j: {name} must be {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_match_j: {name} must be contiguous")
    if d1.data_ptr() % 16 or d2.data_ptr() % 16:
        raise ValueError("fused_match_j: descriptors must be 16-byte aligned")
    lib = load_library()
    dev = d1.device
    best = torch.empty((B, K), dtype=torch.float32, device=dev)
    second = torch.empty((B, K), dtype=torch.float32, device=dev)
    idx = torch.empty((B, K), dtype=torch.int32, device=dev)
    col_key = torch.zeros((B, K) if cross_check else (1,), dtype=torch.int64,
                          device=dev)
    j = torch.empty((B, K), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_match_j_launch(
        d1.data_ptr(), d2.data_ptr(), m1.data_ptr(), m2.data_ptr(), B, K,
        float(max_ratio), float(max_distance), int(bool(cross_check)),
        best.data_ptr(), second.data_ptr(), idx.data_ptr(),
        col_key.data_ptr(), j.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_match_j: CUDA launch error {err}")
    launches += 1
    return j
