"""Split K3's device time into its stages, on the card.

    python -m dagsfm_tpu_torch.tools.k3_split [--reps N]

Builds csrc/top2_matcher.cu three times: with K3_SPLIT=1 (the product and
one max a thread), with K3_SPLIT=2 (+ each column tile's row top-2, no
fold) and as the port loads it (+ the fold of the column tiles), and
times each with `matcher_mfu.time_ms` on f32 |N(0,1)| unit rows at
1024 x 1024 and at 3,712 x 3,712 (the entry-point path's shape). The
analysis builds give wrong answers by design; only the full one is K3.
It prints ms, TFLOP/s and the share of the 67 TFLOP/s f32 FMA peak beside
the card's name and power limit, one JSON object on stdout. It needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from dagsfm_tpu_torch.ops import cuda_build
from dagsfm_tpu_torch.tools.matcher_mfu import card_line, time_ms

PEAK_F32_TFLOPS = 67.0         # H100 SXM, FMA outside the tensor cores
SHAPES = (1024, 3712)
STAGES = {"product + max": ["K3_SPLIT=1"], "+ tile top-2": ["K3_SPLIT=2"],
          "+ fold (K3)": []}


def _build(tmp: Path) -> dict:
    procs = {}
    for k, (name, defines) in enumerate(STAGES.items()):
        so = tmp / f"k3_split{k}.so"
        procs[name] = (so, subprocess.Popen(
            cuda_build.nvcc_command(cuda_build.CSRC / "top2_matcher.cu", so,
                                    defines),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(str(so))
        cuda_build.set_signature(lib.top2_f32_launch, 2, [ctypes.c_int] * 2,
                                 3)
        libs[name] = lib
    return libs


def run(reps: int = 50) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("k3_split: needs a CUDA card")
    dev = torch.device("cuda")
    card = card_line()
    rng = np.random.default_rng(0)
    out = {}
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as t:
        libs = _build(Path(t))
        for K in SHAPES:
            d = np.abs(rng.normal(size=(2, K, 128))).astype(np.float32)
            d /= np.linalg.norm(d, axis=-1, keepdims=True)
            a, b = (torch.as_tensor(x).to(dev).contiguous() for x in d)
            res = torch.empty(3 * K, device=dev)
            part = torch.empty(3 * K * (K // 128), device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            flops = 2.0 * K * K * 128
            for name, lib in libs.items():
                args = (a.data_ptr(), b.data_ptr(), K, K, res.data_ptr(),
                        part.data_ptr(), stream)

                def launch(f=lib.top2_f32_launch, args=args):
                    if f(*args):
                        raise RuntimeError("k3_split: launch failed")
                ms = time_ms(launch, reps)
                tflops = flops / ms / 1e9
                out[f"{name}, {K} x {K}"] = {
                    "ms": ms, "tflops": tflops,
                    "peak_share_pct": 100.0 * tflops / PEAK_F32_TFLOPS}
    return {"what": "K3 device-time split, f32, CUDA events over "
                    f"{reps} launches (dagsfm_tpu_torch/tools/k3_split.py)",
            "device": torch.cuda.get_device_name(0), "card": card,
            "stages": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    record = run(ap.parse_args(argv).reps)
    for name, r in record["stages"].items():
        print(f"{name}: {r['ms']:.4f} ms, {r['tflops']:.1f} TFLOP/s, "
              f"{r['peak_share_pct']:.1f} % of the f32 FMA peak on "
              f"{record['card']}", flush=True)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
