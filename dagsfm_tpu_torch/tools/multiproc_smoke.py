"""Two processes in one torch.distributed group: a collective, then one
lease queue drained by both.

    python -m dagsfm_tpu_torch.tools.multiproc_smoke [--out PATH]
        [--device cuda|cpu]

Counterpart of tools/multiproc_smoke.py. Two processes of this module
join one process group through `parallel.distributed.init_multihost` on
localhost, with gloo (NCCL refuses two ranks on one GPU), and each runs
an `all_reduce` of its rank + 1 on a tensor on the device, which must
give 3.0. Both then drain one queue of 8 jobs on shared storage through
`ClusterJobRunner.claim` and `verify_lease`, each job taking 50 ms, and
publish each result with an atomic rename. A won claim is checked
against the published results once more before the job runs, because
`claim` reads them before it takes the lease. The record passes when both
exit 0, both reduce to 3.0, every job is done exactly once and each
process did at least one. The queue lives in a temporary directory that
is removed after the run. Prints one JSON object on stdout; exits 1 when
the record does not pass.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import dagsfm_tpu_torch
from dagsfm_tpu_torch.parallel.distributed import ClusterJobRunner
from dagsfm_tpu_torch.tools import common

JOBS = 8
WORLD = 2


class JobRunner(ClusterJobRunner):
    """The lease queue with one JSON file per job as its output."""

    def _out_path(self, k: int) -> str:
        return os.path.join(self.work_dir, f"out{k}.json")

    def is_done(self, k: int) -> bool:
        return os.path.exists(self._out_path(k))

    def publish(self, k: int) -> None:
        """Write job k's output with an atomic rename, then release it."""
        tmp = f"{self._out_path(k)}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"job": k, "host": self.host_id, "pid": os.getpid()}, f)
        os.replace(tmp, self._out_path(k))
        self._release(k)


def worker(rank: int, port: int, work: str, device: str) -> dict:
    """One process: join the group, reduce, then claim what it can of the
    queue. Returns what it did."""
    import torch
    import torch.distributed as tdist

    from dagsfm_tpu_torch.parallel import mesh
    from dagsfm_tpu_torch.parallel.distributed import init_multihost

    dev = common.resolve(device)
    idx, count = init_multihost(f"127.0.0.1:{port}", WORLD, rank,
                                device=dev, backend="gloo")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.full((1,), float(idx + 1), dtype=torch.float64, device=dev)
    value = float(mesh.all_reduce(x)[0])
    tdist.barrier()                   # both start the queue together

    runner = JobRunner(work, host_id=rank)
    done = []
    for k in range(JOBS):
        if not runner.claim(k):
            continue
        if runner.is_done(k):
            # claim() reads is_done before it takes the lease: a job the
            # other process published and released in between is won
            # again here, and would run twice
            runner._release(k)
            continue
        time.sleep(0.05)              # the job; keeps the two contending
        if runner.verify_lease(k) or not runner.is_done(k):
            runner.publish(k)
            done.append(k)
    tdist.destroy_process_group()
    return {"rank": idx, "world": count, "all_reduce": value, "done": done,
            "device": str(dev)}


def run(device=None, timeout: float = 300.0) -> dict:
    """Both processes on `device` (the card unless told); returns the
    record."""
    dev = common.resolve(device)
    work = tempfile.mkdtemp(prefix="multiproc_smoke_")
    port = common.free_port()
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(dagsfm_tpu_torch.__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dagsfm_tpu_torch.tools.multiproc_smoke",
         "--rank", str(r), "--port", str(port), "--work", work,
         "--device", dev.type], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    elapsed = time.perf_counter() - t0
    try:
        owners = {}
        for k in range(JOBS):
            path = os.path.join(work, f"out{k}.json")
            if os.path.exists(path):
                with open(path) as f:
                    owners[k] = json.load(f)["host"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    reports = []
    for o in outs:
        lines = [ln for ln in o.splitlines() if ln.startswith("{")]
        reports.append(json.loads(lines[-1]) if lines else None)
    by_host = {h: sorted(k for k, v in owners.items() if v == h)
               for h in range(WORLD)}
    rc = [p.returncode for p in procs]
    ok = (all(c == 0 for c in rc) and all(r is not None and
                                          r["all_reduce"] == 3.0
                                          for r in reports)
          and sorted(owners) == list(range(JOBS))
          and sum(len(r["done"]) for r in reports if r) == JOBS
          and all(by_host[h] for h in by_host))
    return {"what": "2-process torch.distributed all_reduce (gloo) + "
                    "cross-process lease job handoff "
                    "(dagsfm_tpu_torch/tools/multiproc_smoke.py)",
            "returncodes": rc, "elapsed_s": elapsed,
            "jobs_by_host": by_host, "processes": reports,
            "process_output": [o.strip().splitlines()[-2:] for o in outs],
            "pass": ok, "device": dev.type, "card": common.card(dev)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the record here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None,
                    help="run as this rank of the two (started by run)")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--work", default=None)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.rank is not None:
        print(json.dumps(worker(args.rank, args.port, args.work,
                                args.device)), flush=True)
        return 0
    record = run(args.device)
    common.emit(record, args.out)
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
