"""Runner `ba_sharded`: repeated sharded bundle adjustment solves of one
problem (`parallel/ba_sharded.solve_sharded`) on `sharding.ranks`
processes, one card each, over the port's process group
(`parallel/mesh.init_ranks`: NCCL on cards).

Rank 0 is this process, on the harness's device; set-up starts ranks
1.. on the next cards (`sharded_ranks`), and every rank draws the same
problem and the same starts from `pool_seed` on its own card and cuts
each start into shards. One unit of work is one solve on every rank at
once (rank 0 sends the start to solve); its work is 1.

Traffic keys: `pool_seed` and `starts` (the problem and its pool of
starts, the same in every run), `rank_timeout_s` (the process group's
timeout, so that a lost rank ends the run), `limits`. The run's seed
orders the pool (the window cycles over it and ends only on a whole
pass: `cycle`) and draws the judged solve.

The check (after the window; the other ranks stopped): the judged
solve's returned poses, cameras, points and reported statistics read
alike on every rank (`rank_gap`, a MAX and a MIN reduce before the
ranks stop); its
reported final cost against the plain reference's cost of what it
returned, over the observations the rule keeps (`cost_gap`); and the
share of its start's cost it removed against the share the reference's
run of the same rule from the same start removes (`descent_gap`;
`reference/ba_blocked.py`).
"""

from __future__ import annotations

import atexit
import socket
import sys
import time

import numpy as np
import torch

from sfmbench import sharded_ranks as sr
from sfmbench.reference import ba_blocked as ref


class State:
    pass


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def setup(cfg: dict, mix: dict, seed: int, dev) -> State:
    # the port's launcher of a rank (a port without it fails here, at once)
    from dagsfm_tpu_torch.parallel.mesh import init_ranks

    st = State()
    st.cfg, st.mix, st.seed, st.limits = cfg, mix, seed, mix["limits"]
    world = cfg["sharding"]["ranks"]
    address = f"tcp://localhost:{_free_port()}"
    timeout = mix["rank_timeout_s"]
    st.workers = sr.start_workers(cfg, mix, world, address, dev, timeout)
    atexit.register(sr.stop_workers, st.workers, 1.0)
    try:
        st.dev = init_ranks(0, world, address, timeout_s=timeout,
                            device=dev)
        st.node = sr.Node(cfg, mix, st.dev, keep_truth=True)
    except BaseException:
        sr.stop_workers(st.workers, 1.0)
        raise
    st.order = [int(k) for k in np.random.default_rng(
        [int(seed), 13]).permutation(mix["starts"])]
    st.next = 0
    st.solves = []                  # (start, BAStats), as node.outputs
    st.counters = dict(solves=0, iterations=0, cg_iterations=0,
                       solve_s=0.0)
    return st


def warmup(st) -> None:
    st.node.command(sr.SOLVE, st.order[0], 1)


def cycle(st) -> int:
    return len(st.order)


def reset(st) -> None:
    st.node.command(sr.CLEAR)
    st.solves.clear()
    for k in st.counters:
        st.counters[k] = type(st.counters[k])(0)


def _sync(st) -> None:
    if st.dev.type == "cuda":
        torch.cuda.synchronize(st.dev)


def unit(st) -> int:
    k = st.order[st.next]
    st.next = (st.next + 1) % len(st.order)
    _sync(st)
    t0 = time.perf_counter()
    _, stats = st.node.command(sr.SOLVE, k)
    _sync(st)
    c = st.counters
    c["solve_s"] += time.perf_counter() - t0
    c["solves"] += 1
    c["iterations"] += stats.num_iterations
    c["cg_iterations"] += stats.cg_iterations
    st.solves.append((k, stats))
    return 1


def e2e(st, seconds: float) -> dict:
    return {"ba_solve_s": seconds / max(st.counters["solves"], 1)}


def counters(st) -> dict:
    """The window's solves, and rank 0's own share of the problem: its
    kept observations N and points P, with every image I and camera C."""
    return dict(st.counters, **st.node.local_counts)


def judged(st, seed: int) -> int:
    """The index of the judged solve among the window's."""
    rng = np.random.default_rng([int(seed), 11])
    return int(rng.choice(len(st.solves)))


def release(st) -> None:
    """The judged solve's gap between the ranks, each rank's memory peak
    and each rank's forbidden modules, read before the other ranks stop;
    then the ranks stopped, the process group closed and the ranks joined
    (killed after a minute; the work they did is read already); the
    judged solve kept on this rank for the check, the rest freed. Raises,
    so that the run gives no result, where any rank loaded a forbidden
    module (the harness inspects only this process)."""
    import torch.distributed as tdist

    node = st.node
    j = judged(st, st.seed)
    st.rank_gap = node.command(sr.GAP, j)
    memory = node.command(sr.MEMORY)
    print("ranks: memory_peak_bytes "
          f"{[int(m[0]) for m in memory]}", file=sys.stderr)
    bad = [r for r, (n,) in enumerate(node.command(sr.MODULES)) if n]
    k, out, stats = node.outputs[j]
    st.judged = (k, _solution(node, out), stats)
    node.command(sr.STOP)
    # every rank closes the group together (NCCL finalises with its peers)
    tdist.destroy_process_group()
    print(f"ranks: exit codes {sr.stop_workers(st.workers)}",
          file=sys.stderr)
    node.outputs, node.problems = [], []
    if bad:
        raise RuntimeError(f"forbidden modules loaded on ranks {bad}")


def _solution(node, out) -> dict:
    """A solve's output with every point back at its global index."""
    P = node.truth["points"].shape[0]
    points = out.points.new_zeros((P, 3))
    for d, ids in enumerate(node.shard_pts):
        points[torch.as_tensor(ids, device=points.device)] = \
            out.points[d, :len(ids)]
    return dict(qvec=out.image_qvec, tvec=out.image_tvec,
                intr=out.cam_params[:, :5], points=points)


def _observations(st, dtype) -> dict:
    cache = st.__dict__.setdefault("observations", {})
    if dtype not in cache:
        t = st.node.truth
        cache[dtype] = ref.prepare(
            t["obs_image"], t["obs_point"], t["obs_xy"],
            torch.arange(t["qvec"].shape[0], device=st.dev),
            t["points"].shape[0], st.cfg["solver"]["max_track_len"], dtype)
    return cache[dtype]


def reference_run(st, k: int, dtype) -> tuple:
    """The reference's run of the rule from start k in `dtype`:
    (solution, initial cost, final cost), kept for the state's life."""
    cache = st.__dict__.setdefault("reference_runs", {})
    if (k, dtype) not in cache:
        cache[k, dtype] = _reference_run(st, k, dtype)
    return cache[k, dtype]


# which of the reference's log f, k1, k2 a camera model can move, by the
# configuration's `refine` keys
FREE_INTRINSICS = {"RADIAL": ("focal", "extra", "extra"),
                   "SIMPLE_RADIAL": ("focal", "extra", None),
                   "SIMPLE_PINHOLE": ("focal", None, None)}


def _held_and_free(cfg: dict, I: int, dev) -> tuple:
    """(I,) held images and (I, 3) free log f, k1, k2 (one camera per
    image), from the configuration alone: none of the program's masks
    reach the reference."""
    rf = cfg["refine"]
    free = [bool(rf[key]) if key else False
            for key in FREE_INTRINSICS[cfg["camera_model"]]]
    held = torch.arange(I, device=dev) < cfg["solver"]["held_images"]
    return held, torch.tensor(free, device=dev).expand(I, 3)


def _reference_run(st, k: int, dtype) -> tuple:
    sv = st.cfg["solver"]
    s = st.node.starts[k]
    I = s["qvec"].shape[0]
    sol, c0, c1, _ = ref.lm(
        ref.solution(s["qvec"], s["tvec"], s["intr"], s["points"],
                     torch.arange(I, device=st.dev), dtype),
        _observations(st, dtype), *_held_and_free(st.cfg, I, st.dev),
        sv["max_iterations"], sv["loss_scale"], sv["linear_rtol"],
        sv["max_linear_iterations"], sv["init_lambda"], sv["point_damping"])
    return sol, c0, c1


def numbers(st, solution: dict, initial: float, final: float,
            reference: tuple) -> dict:
    """cost_gap and descent_gap of a solve that returned `solution` with
    the costs it reported, against the float64 reference's run of the
    rule from the same start (its costs c0, c1)."""
    c0, c1 = reference
    obs = _observations(st, torch.float64)
    sol = ref.solution(solution["qvec"], solution["tvec"], solution["intr"],
                       solution["points"],
                       torch.arange(solution["qvec"].shape[0],
                                    device=st.dev))
    c = float(ref.cost(sol, obs, st.cfg["solver"]["loss_scale"]))
    removed, removed_ref = (initial - final) / initial, (c0 - c1) / c0
    return dict(cost_gap=abs(final - c) / c,
                descent_gap=abs(removed - removed_ref) / removed_ref)


def _verdict(st, found: dict) -> tuple:
    st.parts = {n: [v] for n, v in found.items()}
    L = st.limits
    checks = [(n, found[n], L[n]) for n in ("cost_gap", "descent_gap",
                                           "rank_gap")]
    return checks, int(any(v > lim or v != v for _, v, lim in checks))


def check(st, seed: int) -> tuple:
    k, sol, stats = st.judged
    _, c0, c1 = reference_run(st, k, torch.float64)
    found = numbers(st, sol, stats.initial_cost, stats.final_cost, (c0, c1))
    found["rank_gap"] = st.rank_gap
    return _verdict(st, found)


def control(st, seed: int) -> tuple:
    """The control's numbers: the reference's run of the rule in float32
    in the program's place, from the judged solve's start, judged as
    `check` judges the program (one process: no rank gap)."""
    return _verdict(st, control_numbers(st, st.judged[0]))


def control_numbers(st, k: int) -> dict:
    sol32, c0, c1 = reference_run(st, k, torch.float32)
    _, r0, r1 = reference_run(st, k, torch.float64)
    out = dict(qvec=_quaternions(sol32["R"].double()),
               tvec=sol32["tvec"].double(), intr=sol32["intr"].double(),
               points=sol32["points"].double())
    return dict(numbers(st, out, c0, c1, (r0, r1)), rank_gap=0.0)


def _quaternions(R: torch.Tensor) -> torch.Tensor:
    from sfmbench import scenes
    return torch.as_tensor(scenes.rotmat_to_quat_np(R.cpu().numpy()),
                           device=R.device)
