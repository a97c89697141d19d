"""Run one cell of the benchmark once and print its result line.

    python3 -m sfmbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The last line of standard output is one
JSON object (correct, attempted, failed, metrics, device, with --trace 1
breakdown, and last the checks, each number compared beside its limit);
the checks are also the last lines of standard error. Exits non-zero
without a result when no CUDA card is present or fewer than the cell
asks for, or when jax, jaxlib, flax or dagsfm_tpu was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def few_threads() -> None:
    """One thread for the host's math libraries: the program's host work
    is small operations, which extra threads only make less steady."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def cache_dirs(root: Path) -> None:
    """Fixed cache directories inside the checkout for whatever builds or
    compiles (the port's own kernels build into build/ beside them)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(root / "build" / "sfmbench" / sub)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    few_threads()
    cache_dirs(ROOT)
    import torch

    from sfmbench import harness
    cell = harness.Cell(ROOT, args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}", file=sys.stderr)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), dev, T_START)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
