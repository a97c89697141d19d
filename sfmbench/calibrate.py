"""Readings that set a cell's limits: the program's numbers and the
control's, over many seeds in one process.

    python3 -m sfmbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--seconds S] [--control 0|1] [--fault NAME] \
        [--out PATH]

For each seed: one run of the cell through the benchmark's own path
(`harness.run_cell`) with a short window at the cell's own load
(`--seconds`, at least one unit of work), whose check gives the
program's reading, and, with `--control 1`, the same numbers on the
control's answers (the reference in the program's place, one precision
lower; see each runner's `control`), read before the program's state is
freed.
Prints one JSON line per seed and writes them all to PATH. The
benchmark's own runs never run the control. Needs a CUDA card unless
`--device cpu` is given.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from sfmbench import run as runmod  # noqa: E402


def readings(cell, seed: int, seconds: float, dev, control: bool) -> dict:
    """One run of the cell (harness.run_cell, untraced) and, with
    `control`, the control's numbers read before the program's state is
    freed."""
    import torch

    from sfmbench import harness
    held = {}

    def before_release(st):
        held["st"] = st
        if control:
            checks, _ = cell.runner.control(st, seed)
            held["control"] = {n: v for n, v, _ in checks}
            held["control_parts"] = getattr(st, "parts", None)

    out = harness.run_cell(cell, seed, seconds, False, dev,
                           time.perf_counter(), before_release=before_release)
    if out is None:
        raise SystemExit("forbidden modules loaded")
    row = dict(seed=seed, setup_s=out["metrics"]["setup_s"]["value"],
               work=out["attempted"], unit_seconds=out["unit_seconds"],
               memory_peak_bytes=out["device"]["memory_peak_bytes"],
               program={n: c["value"] for n, c in out["checks"].items()},
               program_parts=getattr(held["st"], "parts", None),
               failed=out["failed"], correct=out["correct"])
    for k in ("control", "control_parts"):
        if k in held:
            row[k] = held[k]
    held.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default="",
                   help="a fault of sfmbench/faults.py planted under the "
                        "program (its readings only)")
    p.add_argument("--out")
    args = p.parse_args(argv)
    runmod.few_threads()
    runmod.cache_dirs(runmod.ROOT)
    import torch

    from sfmbench import harness
    cell = harness.Cell(runmod.ROOT, args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(f"card: {runmod.card_line()}", file=sys.stderr)
    rows = []
    for s in args.seeds.split(","):
        if args.fault:
            from sfmbench import faults
            with getattr(faults, args.fault)():
                row = readings(cell, int(s), args.seconds, dev, False)
            row["fault"] = args.fault
        else:
            row = readings(cell, int(s), args.seconds, dev,
                           bool(args.control))
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
