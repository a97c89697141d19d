"""Readings that set the limits of the sharded bundle adjustment cell, in
one set-up of its ranks:

    python3 -m sfmbench.calibrate_sharded --workload ba.final13682x4 \\
        [--passes 2] [--control N] [--faults 0|1] \\
        [--trace 0|1] [--device cpu] [--out PATH]

The cell's problem and starts are the same in every run (its traffic's
`pool_seed`); a run's seed only orders the pool and draws which of the
window's solves is judged. So one set-up (the runner's own `setup` and
`warmup`) serves every reading:

* the program: `--passes` whole passes over the pool, every solve
  judged as the runner's `check` judges one (its rank gap read by the
  MAX and MIN reduce), and whether the solves of one start repeat to the
  bit on rank 0;
* `--control N`: the reference's run of the rule in float32 from the
  first N starts, judged by the float64 reference;
* `--faults 1`: each fault of `faults_sharded`, planted on every rank,
  one solve of each start of the pool, judged;
* `--trace 1`: every rank traced over one solve (its card's busy
  seconds, NCCL's kernels' seconds, the solve's seconds), and each
  rank's memory peak.

The ranks solve first and then stop; rank 0 judges alone. Prints one
JSON line per reading and appends each to PATH as it comes. Needs
`sharding.ranks` CUDA cards unless `--device cpu` is given.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from sfmbench import run as runmod  # noqa: E402

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="ba.final13682x4")
    p.add_argument("--seed", type=int, default=1,
                   help="the set-up's seed (orders the pool)")
    p.add_argument("--passes", type=int, default=2)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--faults", type=int, default=1)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--overrides", default="{}",
                   help="JSON {config: {...}, traffic: {...}} over the cell")
    p.add_argument("--out")
    args = p.parse_args(argv)
    runmod.few_threads()
    runmod.cache_dirs(runmod.ROOT)
    import torch

    from sfmbench import faults_sharded, harness
    from sfmbench import sharded_ranks as sr
    cell = harness.Cell(runmod.ROOT, args.workload,
                        json.loads(args.overrides))
    dev = torch.device(args.device)
    if dev.type == "cuda" and (not torch.cuda.is_available() or
                               torch.cuda.device_count() <
                               cell.entry["chips"]):
        print("too few CUDA cards", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(f"card: {runmod.card_line()}", file=sys.stderr)
    def emit(**row):
        row["t_s"] = round(time.perf_counter() - T_START, 3)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")

    run = cell.runner
    t0 = time.perf_counter()
    st = run.setup(cell.config, cell.mix, args.seed, dev)
    node = st.node

    def sync():
        if st.dev.type == "cuda":
            torch.cuda.synchronize(st.dev)

    def solve(k):
        sync()
        t = time.perf_counter()
        out, stats = node.command(sr.SOLVE, k)
        sync()
        return out, stats, time.perf_counter() - t

    judged = []         # (reading, start, output, stats, seconds, rank gap)
    try:
        t1 = time.perf_counter()
        run.warmup(st)
        sync()
        emit(reading="setup", setup_s=t1 - t0,
             warmup_s=time.perf_counter() - t1,
             local_counts=node.local_counts)
        node.command(sr.CLEAR)
        for _ in range(args.passes):
            for k in st.order:
                out, stats, sec = solve(k)
                judged.append(("program", k, out, stats, sec,
                               node.command(sr.GAP,
                                            len(node.outputs) - 1)))
                emit(reading="solve", start=k, solve_s=sec,
                     iterations=stats.num_iterations,
                     cg_iterations=stats.cg_iterations)
        if args.faults:
            for f, fault in enumerate(faults_sharded.FAULTS):
                node.command(sr.FAULT, f + 1)
                for k in st.order:
                    out, stats, sec = solve(k)
                    judged.append((fault.__name__, k, out, stats, sec,
                                   node.command(sr.GAP,
                                                len(node.outputs) - 1)))
                node.command(sr.FAULT, 0)
        if args.trace:
            emit(reading="ranks", traced=node.command(sr.TRACE, st.order[0]),
                 memory_peak_bytes=node.command(sr.MEMORY))
    finally:
        import torch.distributed as tdist
        node.command(sr.STOP)
        tdist.destroy_process_group()
        emit(reading="stopped", exit_codes=sr.stop_workers(st.workers))
    node.problems = []
    # the judge, on rank 0 alone
    first = {}
    for what, k, out, stats, sec, gap in judged:
        t = time.perf_counter()
        ref_run = run.reference_run(st, k, torch.float64)
        found = run.numbers(st, run._solution(node, out),
                            stats.initial_cost, stats.final_cost,
                            ref_run[1:])
        row = dict(reading="program" if what == "program" else "fault",
                   start=k, solve_s=sec, iterations=stats.num_iterations,
                   cg_iterations=stats.cg_iterations,
                   initial_cost=stats.initial_cost,
                   final_cost=stats.final_cost,
                   reference_cost=[ref_run[1], ref_run[2]],
                   judge_s=time.perf_counter() - t, rank_gap=gap, **found)
        if what == "program":
            if k in first:
                row["repeats_bits"] = bool(
                    torch.equal(out.points, first[k].points) and
                    torch.equal(out.cam_params, first[k].cam_params) and
                    torch.equal(out.image_qvec, first[k].image_qvec))
            first.setdefault(k, out)
        else:
            row["fault"] = what
        emit(**row)
    if args.control:
        for k in sorted(set(st.order))[:args.control]:
            t = time.perf_counter()
            found = run.control_numbers(st, k)
            emit(reading="control", start=k,
                 seconds=time.perf_counter() - t, **found)
    return 0


if __name__ == "__main__":
    sys.exit(main())
