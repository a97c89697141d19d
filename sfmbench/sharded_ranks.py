"""The ranks of the sharded bundle adjustment cell (`runners/ba_sharded.py`):
one process per card; rank 0 is the harness's own process, and it starts
the others as

    python3 -m sfmbench.sharded_ranks --rank R --world W \\
        --address tcp://localhost:PORT --config JSON --traffic JSON \\
        [--device cpu] [--timeout S]

from the root of a checkout. Each rank joins the process group through
the port's `parallel.mesh.init_ranks` (NCCL on cards, gloo on the CPU),
draws the same problem and the same starts on its own device from the
traffic's `pool_seed` (`scenes.bal_truth`, `scenes.bal_start`), and cuts
each start into the configuration's shards (`ba_sharded.shard_problem`).
Then every rank follows rank 0's commands, broadcast over the group
(`Node.command` on rank 0, `Node.serve` on the others): solve a start,
read the gap between the ranks' results, forget the results, plant or
lift a fault of `faults_sharded`, read each rank's memory peak, count
each rank's forbidden modules (`harness.FORBIDDEN`), trace a solve on
every rank, stop. A rank whose parent process is gone exits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from sfmbench import scenes
from sfmbench.runners.ba import _padded as padded
from sfmbench.runners.ba import make_truth

STOP, SOLVE, GAP, CLEAR, FAULT, MEMORY, TRACE, MODULES = range(8)


def solver_options(cfg: dict):
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
    sv, rf = cfg["solver"], cfg["refine"]
    return ba.BAOptions(
        max_iterations=sv["max_iterations"], loss=sv["loss"],
        loss_scale=sv["loss_scale"], init_lambda=sv["init_lambda"],
        refine_focal=rf["focal"], refine_principal=rf["principal"],
        refine_extra=rf["extra"], point_damping=sv["point_damping"],
        solver=sv["solver"],
        max_linear_iterations=sv["max_linear_iterations"],
        linear_rtol=sv["linear_rtol"])


class Node:
    """One rank's problem, starts, shards and results."""

    def __init__(self, cfg: dict, mix: dict, dev, keep_truth: bool):
        from dagsfm_tpu_torch.parallel import ba_sharded
        from dagsfm_tpu_torch.parallel import mesh
        from dagsfm_tpu_torch.scene import cameras as cm
        from dagsfm_tpu_torch.scene.reconstruction import SceneArrays

        self.dev = dev
        self.group, self.rank, self.world = mesh.process_group()
        self.opts = solver_options(cfg)
        sv, rf, sh = cfg["solver"], cfg["refine"], cfg["sharding"]
        pool = mix["pool_seed"]
        t = make_truth(cfg, pool, dev)
        I = t["qvec"].shape[0]
        P, N = t["points"].shape[0], t["obs_point"].shape[0]
        mids = np.full(I, cm.CAMERA_MODEL_IDS[cfg["camera_model"]])
        self.const_image = np.zeros(I, bool)
        self.const_image[:sv["held_images"]] = True
        self.cam_refine = cm.intrinsics_refine_mask(
            mids, rf["focal"], rf["principal"], rf["extra"])
        self.starts = [scenes.bal_start(t, cfg["start"], sv["held_images"],
                                        pool, k)
                       for k in range(mix["starts"])]
        i32 = dict(dtype=torch.int32, device=dev)
        arrays = SceneArrays(
            cam_model_id=torch.as_tensor(mids, **i32),
            cam_params=padded(t["intr"]), image_qvec=t["qvec"],
            image_tvec=t["tvec"], image_camidx=torch.arange(I, **i32),
            image_mask=torch.ones(I, dtype=torch.bool, device=dev),
            points_xyz=t["points"],
            points_mask=torch.ones(P, dtype=torch.bool, device=dev),
            obs_image=t["obs_image"].int(), obs_point=t["obs_point"].int(),
            obs_xy=t["obs_xy"],
            obs_mask=torch.ones(N, dtype=torch.bool, device=dev))
        self.problems = []
        for s in self.starts:
            prob, self.shard_pts = ba_sharded.shard_problem(
                arrays._replace(image_qvec=s["qvec"], image_tvec=s["tvec"],
                                cam_params=padded(s["intr"]),
                                points_xyz=s["points"]),
                sh["shards"], cfg["solver"]["max_track_len"],
                const_image=self.const_image, cam_refine=self.cam_refine,
                device=dev)
            self.problems.append(prob)
        own = mesh.own_shards(sh["shards"])
        p0 = self.problems[0]
        self.local_counts = dict(
            N=int(p0.obs_mask[own].sum()), P=int(p0.points_mask[own].sum()),
            I=I, C=I)
        self.truth = t if keep_truth else None
        if not keep_truth:
            self.starts = None
        self.outputs = []          # (start, output problem, BAStats)
        self.fault = None
        self._solve = ba_sharded.solve_sharded

    # the command channel ------------------------------------------------

    def _channel(self, op=0, a=0, b=0) -> tuple:
        msg = torch.tensor([op, a, b], dtype=torch.int64, device=self.dev)
        if self.group is not None:
            import torch.distributed as tdist
            tdist.broadcast(msg, src=0, group=self.group)
        return tuple(int(v) for v in msg.cpu())

    def command(self, op: int, a: int = 0, b: int = 0):
        """Rank 0: send a command to every rank and run it here too."""
        return self.execute(*self._channel(op, a, b))

    def serve(self) -> None:
        """Ranks 1..: run rank 0's commands until STOP."""
        while True:
            op, a, b = self._channel()
            if op == STOP:
                return
            self.execute(op, a, b)

    def execute(self, op: int, a: int, b: int):
        if op == SOLVE:
            opts = self.opts if b == 0 else self.opts._replace(
                max_iterations=b)
            out, stats = self._solve(self.problems[a], opts)
            self.outputs.append((a, out, stats))
            return out, stats
        if op == GAP:
            return self.rank_gap(*self.outputs[a][1:])
        if op == CLEAR:
            self.outputs.clear()
            return None
        if op == FAULT:
            self.set_fault(a - 1)
            return None
        if op == MEMORY:
            return self._per_rank([float(torch.cuda.max_memory_allocated(
                self.dev)) if self.dev.type == "cuda" else 0.0])
        if op == TRACE:
            return self.traced_solve(a)
        if op == MODULES:
            return self.forbidden()
        if op == STOP:
            return None
        raise ValueError(f"unknown command {op}")

    # what the commands do ------------------------------------------------

    def _per_rank(self, values: list) -> list:
        """Every rank's `values`, on every rank: [[rank 0's], ...]."""
        table = torch.zeros((self.world, len(values)), dtype=torch.float64,
                            device=self.dev)
        table[self.rank] = torch.tensor(values, dtype=torch.float64)
        if self.group is not None:
            import torch.distributed as tdist
            tdist.all_reduce(table, group=self.group)
        return table.cpu().tolist()

    def forbidden(self) -> list:
        """Every rank's count of loaded forbidden modules, [[rank 0's],
        ...]; a rank that has any names them on its standard error."""
        from sfmbench import harness
        bad = harness.forbidden_modules()
        if bad:
            print(f"rank {self.rank}: forbidden modules loaded: "
                  f"{', '.join(bad)}", file=sys.stderr, flush=True)
        return self._per_rank([float(len(bad))])

    def rank_gap(self, out, stats) -> float:
        """The largest difference between the ranks' results, over every
        returned pose, camera and point and the statistics each rank
        reports (its costs, lambda and iterations): a MAX and a MIN
        reduce."""
        v = torch.cat([out.image_qvec.reshape(-1), out.image_tvec.reshape(-1),
                       out.cam_params.reshape(-1), out.points.reshape(-1),
                       torch.tensor([float(x) for x in stats],
                                    dtype=out.points.dtype,
                                    device=out.points.device)])
        if self.group is None:
            return 0.0
        import torch.distributed as tdist
        hi, lo = v.clone(), v.clone()
        tdist.all_reduce(hi, op=tdist.ReduceOp.MAX, group=self.group)
        tdist.all_reduce(lo, op=tdist.ReduceOp.MIN, group=self.group)
        return float(torch.max(torch.abs(hi - lo)))

    def set_fault(self, index: int) -> None:
        """Lift the planted fault, then plant fault `index` of
        faults_sharded.FAULTS (none for -1)."""
        from sfmbench import faults_sharded
        if self.fault is not None:
            self.fault.__exit__(None, None, None)
            self.fault = None
        if index >= 0:
            self.fault = faults_sharded.FAULTS[index]()
            self.fault.__enter__()

    def traced_solve(self, k: int) -> list:
        """Every rank solves start k under the profiler (device activity):
        per rank [busy s, NCCL kernels' s, the solve's s]."""
        from sfmbench import trace
        acts = [torch.profiler.ProfilerActivity.CUDA
                if self.dev.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU]
        prof = torch.profiler.profile(activities=acts)
        self._sync()
        prof.start()
        t0 = time.perf_counter()
        self.execute(SOLVE, k, 0)
        self._sync()
        seconds = time.perf_counter() - t0
        prof.stop()
        self.outputs.pop()
        if self.dev.type != "cuda":
            return self._per_rank([0.0, 0.0, seconds])
        s = trace.summarize(prof)
        nccl = sum(v for n, v in s["kernel_s"].items()
                   if "nccl" in n.lower())
        return self._per_rank([s["busy_s"], nccl, seconds])

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


def start_workers(cfg: dict, mix: dict, world: int, address: str, dev,
                  timeout_s: float) -> list:
    """Ranks 1..world-1 as child processes of this one (rank 0), their
    output on this one's standard error."""
    import subprocess
    args = ["--world", str(world), "--address", address,
            "--config", json.dumps(cfg), "--traffic", json.dumps(mix),
            "--timeout", str(timeout_s), "--parent", str(os.getpid())]
    if dev.type != "cuda":
        args += ["--device", str(dev)]
    return [subprocess.Popen([sys.executable, "-m", "sfmbench.sharded_ranks",
                              "--rank", str(r)] + args, stdout=2)
            for r in range(1, world)]


def stop_workers(procs: list, timeout_s: float = 60.0) -> list:
    """Join the workers (killed after timeout_s); their exit codes."""
    deadline = time.monotonic() + timeout_s
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except Exception:       # noqa: BLE001  (TimeoutExpired)
            p.kill()
            p.wait()
    return [p.returncode for p in procs]


def _exit_with_parent(parent: int) -> None:
    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(3)
    threading.Thread(target=watch, daemon=True).start()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--address", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--device", default=None)
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--parent", type=int, default=0)
    args = p.parse_args(argv)
    if args.parent:
        _exit_with_parent(args.parent)
    torch.set_num_threads(1)
    import torch.distributed as tdist

    from dagsfm_tpu_torch.parallel import mesh
    dev = mesh.init_ranks(args.rank, args.world, args.address,
                          timeout_s=args.timeout, device=args.device)
    try:
        node = Node(json.loads(args.config), json.loads(args.traffic), dev,
                    keep_truth=False)
        node.serve()
        node.set_fault(-1)
    finally:
        tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
