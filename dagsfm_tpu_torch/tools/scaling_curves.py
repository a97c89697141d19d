"""The sharded solves at D = 1, 2, 4, 8 shards, each beside a twin whose
reduce is the identity.

    python -m dagsfm_tpu_torch.tools.scaling_curves [--smoke]
        [--out PATH] [--device cuda|cpu]

Counterpart of tools/scaling_curves.py, on its problems:
  * the sharded iterative BA (`parallel.ba_sharded.solve_sharded`): 200
    cameras, 10,000 points, tracks of up to 12 (about 100k observations),
    points moved by N(0, 0.01), the first image held, 3 LM iterations,
    float64;
  * rotation averaging over sharded edges
    (`estimate_rotations_sharded`): 1,000 images, each linked to i + 1,
    i + 7 and i + 41 and about 6,000 random edges, 2 degrees of noise,
    3 L1 and 10 IRLS iterations, 20 CG iterations;
  * sharded matching (`parallel.matching_sharded.match_pairs_sharded`):
    512 pairs of 48 images of 256 random descriptors; it has no reduce.
`--smoke` cuts these to 50 cameras and 1,000 points, 200 images, and 64
pairs of 16 images of 128 descriptors.

The shards' reduces (`parallel.mesh.all_reduce`, `all_reduce_many`) run
in a process group: the caller's, or one of one rank set up here (NCCL
on the card, gloo on the CPU) and torn down after. Each BA and rotation
averaging run has a twin in which those reduces are swapped for the
identity: the same per-shard work without the collective, whose outputs
are not used. The difference of the two is what the reduces cost. In
one process the D shards share one device (on the card, one H100) and
run one after the other, so total time does not fall with D here: the
split shows only the cost of the reduce. The real runs must agree
across D (BA points to rel 1e-9 of the largest coordinate, the
rotations within 1e-9, the matches equal), or `run` raises. Prints one
JSON object on stdout with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np
import torch

from dagsfm_tpu_torch.tools import common

FULL = {"ba_cameras": 200, "ba_points": 10000, "ra_images": 1000,
        "ra_random_edges": 6000, "match_images": 48, "match_pairs": 512,
        "K": 256}
SMOKE = {"ba_cameras": 50, "ba_points": 1000, "ra_images": 200,
         "ra_random_edges": 1200, "match_images": 16, "match_pairs": 64,
         "K": 128}
BA_ITERS = 3
ONE_IN = 1e-9            # agreement across D


@contextlib.contextmanager
def reduce_ablated():
    """Swap the shards' reduces for the identity where the solvers call
    them, for the duration of the block."""
    from dagsfm_tpu_torch.estimation import rotation_averaging as ra
    from dagsfm_tpu_torch.parallel import ba_sharded as bas

    def same(x):
        return x

    def same_many(*xs):
        return xs

    saved = (bas.all_reduce, bas.all_reduce_many, ra.all_reduce)
    bas.all_reduce, bas.all_reduce_many, ra.all_reduce = same, same_many, same
    try:
        yield
    finally:
        bas.all_reduce, bas.all_reduce_many, ra.all_reduce = saved


@contextlib.contextmanager
def process_group(dev):
    """The caller's process group, or one of one rank for the block."""
    import torch.distributed as tdist

    from dagsfm_tpu_torch.parallel.distributed import init_multihost
    if tdist.is_initialized():
        yield
        return
    init_multihost(f"127.0.0.1:{common.free_port()}", 1, 0, device=dev)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def _seconds(fn, dev) -> tuple:
    """(host seconds of one call after a warm-up, ended by a sync; its
    result)."""
    ms, out = common.host_ms(fn, dev)
    return ms / 1e3, out


def ba_arrays(sizes: dict, dev):
    from dagsfm_tpu_torch.scene import synthetic
    sc = synthetic.generate(synthetic.SyntheticSceneSpec(
        num_cameras=sizes["ba_cameras"], num_points=sizes["ba_points"],
        pixel_noise=0.5, seed=0, max_track_length=12))
    arrays = synthetic.to_scene_arrays(sc, dev)
    rng = np.random.default_rng(1)
    return arrays._replace(points_xyz=arrays.points_xyz + torch.as_tensor(
        rng.normal(0, 0.01, tuple(arrays.points_xyz.shape)), device=dev))


def bench_ba(D: int, arrays, dev, ref=None) -> tuple:
    from dagsfm_tpu_torch.parallel import ba_sharded as bas
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
    I = int(arrays.image_qvec.shape[0])
    const = np.zeros(I, bool)
    const[:1] = True
    opts = ba.BAOptions(max_iterations=BA_ITERS, solver="iterative",
                        ftol=0.0)
    prob, shard_pts = bas.shard_problem(arrays, D, max_track_len=12,
                                        const_image=const, device=dev)
    dt, (out, stats) = _seconds(lambda: bas.solve_sharded(prob, opts), dev)
    with reduce_ablated():
        dt_abl, _ = _seconds(lambda: bas.solve_sharded(prob, opts), dev)
    pts = bas.gather_points(out, shard_pts, arrays.points_xyz.shape[0])
    rec = {"devices": D, "lm_step_s": dt / BA_ITERS,
           "lm_step_compute_s": dt_abl / BA_ITERS,
           "lm_step_collective_s": max(dt - dt_abl, 0.0) / BA_ITERS,
           "obs_per_device": int(prob.obs_mask.shape[1]),
           "reduce_bytes_per_lm_iter": 8 * (I * 36 * 2 + I * 6 * 2 + (
               stats.cg_iterations // BA_ITERS) * I * 6),
           "cg_iterations": stats.cg_iterations,
           "final_cost": stats.final_cost}
    if ref is not None:
        rec["max_point_dev_vs_D1"] = float(np.abs(pts - ref).max())
        if rec["max_point_dev_vs_D1"] > ONE_IN * np.abs(ref).max():
            raise AssertionError(f"sharded BA at D = {D} differs from D = 1")
    return rec, pts


def ra_problem(sizes: dict) -> tuple:
    """The reference tool's graph: (num images, edges, relative rotations);
    draws from default_rng(0) in its order, then returns the generator
    for the matching problem."""
    from dagsfm_tpu_torch.ops import rotations as rops
    n = sizes["ra_images"]
    rng = np.random.default_rng(0)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R_gt = np.asarray(rops.quat_to_rotmat_np(q))
    edges = []
    for i in range(n):
        for j in (i + 1, i + 7, i + 41):
            if j < n:
                edges.append((i, j))
    for _ in range(sizes["ra_random_edges"]):
        i, j = sorted(rng.integers(0, n, 2))
        if i != j:
            edges.append((i, j))
    edges = np.array(sorted(set(map(tuple, edges))))
    Rn = _rotvec_to_matrix(rng.normal(0, np.radians(2.0), (len(edges), 3)))
    rel = np.einsum("eab,ecb->eac", R_gt[edges[:, 1]], R_gt[edges[:, 0]])
    rel = np.einsum("eab,ebc->eac", rel, Rn)
    return n, edges, rel, rng


def _rotvec_to_matrix(v: np.ndarray) -> np.ndarray:
    """Rodrigues' formula for rows of rotation vectors."""
    th = np.linalg.norm(v, axis=1)
    k = v / np.maximum(th, 1e-300)[:, None]
    Kx = np.zeros((len(v), 3, 3))
    Kx[:, 0, 1], Kx[:, 0, 2] = -k[:, 2], k[:, 1]
    Kx[:, 1, 0], Kx[:, 1, 2] = k[:, 2], -k[:, 0]
    Kx[:, 2, 0], Kx[:, 2, 1] = -k[:, 1], k[:, 0]
    s, c = np.sin(th)[:, None, None], np.cos(th)[:, None, None]
    return np.eye(3) + s * Kx + (1 - c) * Kx @ Kx


def bench_ra(D: int, n: int, edges, rel, dev, ref=None) -> tuple:
    from dagsfm_tpu_torch.estimation import rotation_averaging as ra
    opts = ra.RAOptions(l1_iterations=3, irls_iterations=10,
                        cg_iterations=20)

    def solve():
        return ra.estimate_rotations_sharded(n, edges, rel, opts,
                                             num_shards=D, device=dev)
    dt, R = _seconds(solve, dev)
    with reduce_ablated():
        dt_abl, _ = _seconds(solve, dev)
    rec = {"devices": D, "solve_s": dt, "solve_compute_s": dt_abl,
           "solve_collective_s": max(dt - dt_abl, 0.0),
           "edges_per_device": int(-(-len(edges) // D)),
           "reduce_bytes_per_cg_iter": 8 * n * 3,
           "num_images": n, "num_edges": int(len(edges))}
    if ref is not None:
        rec["max_rotation_dev_vs_D1"] = float(np.abs(R - ref).max())
        if rec["max_rotation_dev_vs_D1"] > ONE_IN:
            raise AssertionError(f"sharded rotation averaging at D = {D} "
                                 "differs from D = 1")
    return rec, R


def match_problem(sizes: dict, rng) -> tuple:
    descs, masks = {}, {}
    for i in range(sizes["match_images"]):
        d = np.abs(rng.normal(size=(sizes["K"], 128)))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        descs[i] = d
        masks[i] = np.ones(sizes["K"], bool)
    n = sizes["match_images"]
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    return descs, masks, pairs[: sizes["match_pairs"]]


def bench_matching(D: int, descs, masks, pairs, dev, ref=None) -> tuple:
    from dagsfm_tpu_torch.parallel.matching_sharded import \
        match_pairs_sharded
    dt, out = _seconds(lambda: match_pairs_sharded(
        descs, masks, pairs, num_shards=D, device=dev), dev)
    rec = {"devices": D, "match_s": dt,
           "pairs_per_device": int(-(-len(pairs) // D)),
           "collective_s": 0.0, "note": "pair-sharded, no reduce"}
    if ref is not None:
        rec["equal_vs_D1"] = all(np.array_equal(out[p], ref[p])
                                 for p in pairs)
        if not rec["equal_vs_D1"]:
            raise AssertionError(f"sharded matching at D = {D} differs")
    return rec, out


def run(smoke: bool = False, devices=(1, 2, 4, 8), device=None,
        log=sys.stderr, sizes: dict | None = None) -> dict:
    """The three curves on `device` (the card unless told) at FULL, SMOKE
    or `sizes` (FULL's keys); returns the record, raising if the real
    runs disagree across D."""
    dev = common.resolve(device)
    sizes = sizes or (SMOKE if smoke else FULL)
    t_start = time.perf_counter()
    curves = {"ba_iterative_sharded": [], "rotation_averaging_sharded": [],
              "matching_sharded": []}
    with process_group(dev):
        arrays = ba_arrays(sizes, dev)
        ref = None
        for D in devices:
            rec, pts = bench_ba(D, arrays, dev, ref)
            ref = pts if ref is None else ref
            curves["ba_iterative_sharded"].append(rec)
            print(f"  BA {rec}", file=log, flush=True)
        n, edges, rel, rng = ra_problem(sizes)
        ref = None
        for D in devices:
            rec, R = bench_ra(D, n, edges, rel, dev, ref)
            ref = R if ref is None else ref
            curves["rotation_averaging_sharded"].append(rec)
            print(f"  RA {rec}", file=log, flush=True)
        descs, masks, pairs = match_problem(sizes, rng)
        ref = None
        for D in devices:
            rec, out = bench_matching(D, descs, masks, pairs, dev, ref)
            ref = out if ref is None else ref
            curves["matching_sharded"].append(rec)
            print(f"  MATCH {rec}", file=log, flush=True)
    return {"what": "sharded solves at D shards in one process, each beside "
                    "its twin with the reduce swapped for the identity "
                    "(dagsfm_tpu_torch/tools/scaling_curves.py)",
            "sizes": sizes, "num_obs": int(arrays.obs_xy.shape[0]),
            "curves": curves,
            "caveat": "one process: the D shards share one device and run "
                      "one after the other, so the time does not fall with "
                      "D; the split shows only what the reduce costs",
            "elapsed_s": time.perf_counter() - t_start,
            "device": dev.type, "card": common.card(dev)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None, help="also write the record here")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    common.emit(run(args.smoke, device=args.device), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
