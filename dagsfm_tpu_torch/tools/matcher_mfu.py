"""Split the matcher's device time into its stages, on the card.

    python -m dagsfm_tpu_torch.tools.matcher_mfu [--out PATH] [--reps N]

Counterpart of tools/matcher_mfu.py. At B = 256 pairs, K = 1024, D = 128
bf16 it times K4 (`top2_matcher.mfu_variant`) in each of its four modes,
product + row max, + forward top-2, + reverse argmax, + masks (= K2), and
K1 (`matcher_kernel.fused_match_j`, ratio test and mutual check in the
kernel), each with CUDA events over `reps` launches after a warm-up. It
prints ms per call, pairs/s, TFLOP/s and the share of the H100's dense
bf16 peak, each beside the card's name and power limit, as one JSON
object on stdout, and writes it to PATH when one is given. It never
writes the JAX package's MATCHER_MFU_r05.json. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

B, K, D = 256, 1024, 128
PEAK_BF16_TFLOPS = 989.0       # H100 SXM, dense
NAMES = {0: "matmul+max only", 1: "+fwd top-2", 2: "+reverse argmax",
         3: "full (masking)"}


def card_line() -> str:
    """`name, power.limit` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Mean ms per call of `fn` over `reps` calls after one warm-up call,
    between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def inputs(dev, seed: int = 0):
    """The reference tool's inputs: |N(0,1)| rows, L2-normalised, every
    mask True."""
    rng = np.random.default_rng(seed)
    d = np.abs(rng.normal(size=(B, 2, K, D))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = torch.as_tensor(d).to(dev, torch.bfloat16)
    m = torch.ones((B, K), dtype=torch.bool, device=dev)
    return t[:, 0].contiguous(), t[:, 1].contiguous(), m


def run(reps: int = 20) -> dict:
    from dagsfm_tpu_torch.ops import matcher_kernel as mk
    from dagsfm_tpu_torch.ops import top2_matcher as tm

    if not torch.cuda.is_available():
        raise RuntimeError("matcher_mfu: needs a CUDA card")
    dev = torch.device("cuda")
    card = card_line()
    d1, d2, m = inputs(dev)
    tflop = B * 2.0 * K * K * D / 1e12

    def row(ms):
        return {"ms_per_call": ms, "pairs_per_s": B / (ms / 1e3),
                "achieved_tflops": tflop / (ms / 1e3),
                "peak_share_pct": 100.0 * tflop / (ms / 1e3)
                / PEAK_BF16_TFLOPS, "card": card}

    results = {}
    for mode in (0, 1, 2, 3):
        ms = time_ms(lambda: tm.mfu_variant(d1, d2, m, m, mode), reps)
        results[NAMES[mode]] = row(ms)
    ms = time_ms(lambda: mk.fused_match_j(d1, d2, m, m), reps)
    results["fused production kernel"] = row(ms)
    return {"what": f"matcher device-time split, B={B} K={K} D={D} bf16, "
                    f"CUDA events over {reps} launches "
                    "(dagsfm_tpu_torch/tools/matcher_mfu.py)",
            "device": torch.cuda.get_device_name(0), "card": card,
            "peak_bf16_tflops": PEAK_BF16_TFLOPS, "variants": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON record here")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    record = run(args.reps)
    for name, r in record["variants"].items():
        print(f"{name}: {r['ms_per_call']:.4f} ms, {r['pairs_per_s']:.0f} "
              f"pairs/s, {r['achieved_tflops']:.2f} TFLOP/s, "
              f"{r['peak_share_pct']:.3f} % of {PEAK_BF16_TFLOPS:.0f} "
              f"TFLOP/s on {record['card']}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
