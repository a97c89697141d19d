"""Time each statement of the iterative BA's Schur prologue alone.

    python -m dagsfm_tpu_torch.tools.prologue_probe [--smoke]
        [--out PATH] [--device cuda|cpu]

Counterpart of tools/prologue_probe.py, on ba_phase_profile's problem
(1,000 cameras, 50,000 points, tracks of up to 20, float32; `--smoke`:
200, 5,000, 8, the points not moved, as the reference probe leaves
them). After one pass of the prologue, each of its statements
(`ba_phase_profile.PROLOGUE`: the products, gathers, segment sums,
damping and inverses of `_solve_iterative` before its CG) is timed alone
on the outputs of the ones before it (device ms from CUDA events after a
warm-up), beside its bytes under ba_phase_profile's byte model, its
bound at 3.35 TB/s and its achieved GB/s (null off the card). Prints
one JSON object on stdout with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys

import torch

from dagsfm_tpu_torch.tools import ba_phase_profile as bpp
from dagsfm_tpu_torch.tools import common


def run(smoke: bool = False, device=None, dtype=torch.float32,
        reps: int = 5, sizes: tuple | None = None) -> dict:
    """Every prologue statement on `device` (the card unless told) at
    ba_phase_profile's FULL, SMOKE or `sizes`; returns the record."""
    dev = common.resolve(device)
    ncam, npts, mtl = sizes or (bpp.SMOKE if smoke else bpp.FULL)
    prob, opts = bpp.problem(ncam, npts, mtl, dev, dtype, perturb=False)
    env = bpp.prologue(bpp.environment(prob, opts, bpp.weighted(prob, opts)))
    on_card = dev.type == "cuda"
    steps = []
    for step in bpp.PROLOGUE:
        name, out, _, _, fn = step
        ms = common.call_ms(lambda: fn(env), dev, reps)
        b = bpp.step_bytes(env, step)
        steps.append({"statement": name, "output": out,
                      "shape": list(env[out].shape), "ms": ms,
                      "gb_moved": b / 1e9,
                      "bound_ms": b / common.HBM_BYTES_PER_S * 1e3
                      if on_card else None,
                      "achieved_gbps": b / 1e9 / (ms / 1e3)
                      if on_card else None})
        print(f"{name:32s}: {ms:9.4f} ms", file=sys.stderr, flush=True)
    return {"what": f"Schur prologue statements at {ncam} cameras, "
                    f"{prob.obs_xy.shape[0]} observations, "
                    f"{str(dtype).replace('torch.', '')} "
                    "(dagsfm_tpu_torch/tools/prologue_probe.py)",
            "shapes": {"I": ncam, "P": prob.points.shape[0],
                       "N": prob.obs_xy.shape[0], "max_track_len": mtl},
            "statements": steps,
            "sum_ms": sum(s["ms"] for s in steps),
            "timing": "CUDA events (device ms)" if on_card else "host clock",
            "device": dev.type, "card": common.card(dev)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None, help="also write the record here")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    common.emit(run(args.smoke, args.device), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
