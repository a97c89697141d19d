"""Time bundle adjustment with its segment sums in chunks or in one pass.

    python -m dagsfm_tpu_torch.tools.segment_sums [--lm N]

`sfm/bundle_adjustment.py` adds every per-image, per-point, per-camera
and per-Schur-block sum in a fixed order with `torch.segment_reduce`,
whose CUDA kernel gives each output element one thread that loops over
its whole run. This tool times `ba.solve` (N LM iterations, ftol 0) with
the runs cut into chunks of 256 rows (`SEGMENT_CHUNK`) and with chunks
longer than any run (each run in one pass), on two problems:

  * dense joint: 100 images of one shared SIMPLE_RADIAL camera (focal
    +10 %, k1 = 0.05; focal and k1 refined, Cauchy loss), 28,220 points
    seen by at most 9 images each: a stand-in for the distorted path's
    last global bundle adjustment (its 28,220 points; its 1.1M inlier
    matches over them are about 9 views a track);
  * the BA path's (1,000 cameras, 50,000 points, max_track_length 20,
    1M observations): the joint PCG from the same perturbed camera,
    then the plain pinhole PCG.

After a warm-up solve, each problem runs chunked, one pass, one pass,
chunked; the two must give the same final cost to rel 1e-9. Beside the
seconds per LM iteration it times one `_segment_sum` over each grouping
the solve sums by (device ms, `matcher_mfu.time_ms`). Prints the card's
name and power limit and the times, one JSON object on stdout. It needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from dagsfm_tpu_torch.scene import cameras as cm
from dagsfm_tpu_torch.scene import synthetic
from dagsfm_tpu_torch.sfm import bundle_adjustment as ba

CHUNKED = 256
ONE_PASS = 1 << 62


def problems(dev, dense_images: int = 100, dense_points: int = 28220,
             ba_cameras: int = 1000, ba_points: int = 50000) -> dict:
    """name -> (scene arrays, BAOptions, max_track_len)."""
    out = {}

    def scene(spec):
        arrays = synthetic.to_scene_arrays(synthetic.generate(spec), dev)
        rng = np.random.default_rng(1)
        return arrays._replace(points_xyz=arrays.points_xyz + torch.as_tensor(
            rng.normal(0, 0.02, tuple(arrays.points_xyz.shape)), device=dev))

    def perturbed(arrays):
        cp = arrays.cam_params.clone()
        cp[0, 0] *= 1.10
        cp[0, 3] = 0.05
        return arrays._replace(cam_params=cp)

    joint = (lambda solver, loss: ba.BAOptions(
        loss=loss, refine_focal=True, refine_extra=True, solver=solver,
        ftol=0.0))
    out["dense joint"] = (perturbed(scene(synthetic.SyntheticSceneSpec(
        num_cameras=dense_images, num_points=dense_points, pixel_noise=0.5,
        seed=4, ring_radius=9.0, point_cloud_extent=3.5,
        ring_height_jitter=0.3, max_track_length=9,
        camera_model="SIMPLE_RADIAL"))), joint("dense", "cauchy"), 16)
    base = scene(synthetic.SyntheticSceneSpec(
        num_cameras=ba_cameras, num_points=ba_points, pixel_noise=0.5,
        seed=0, max_track_length=20, camera_model="SIMPLE_RADIAL"))
    out["iterative joint"] = (perturbed(base), joint("iterative", "trivial"),
                              20)
    # the true k1 is 0: the unperturbed scene is the pinhole problem
    out["iterative plain"] = (base._replace(cam_model_id=torch.full_like(
        base.cam_model_id, cm.SIMPLE_PINHOLE)), ba.BAOptions(
            solver="iterative", ftol=0.0), 20)
    return out


def _problem(arrays, opts, track, chunk: int):
    ba.SEGMENT_CHUNK = chunk
    const = np.zeros(arrays.image_qvec.shape[0], bool)
    const[:2] = True
    refine = None
    if opts.refine_focal:
        refine = cm.intrinsics_refine_mask(
            arrays.cam_model_id.cpu().numpy(), True, False, True)
    return ba.make_problem(arrays, max_track_len=track, const_image=const,
                           cam_refine=refine)


def _sums_ms(prob, opts) -> dict:
    """Device ms of `_segment_sum` over each grouping the solve sums by,
    on rows of the width the solve gives it."""
    groups = {"by_image": (prob.by_image, (6, 6)),
              "by_point": (prob.by_point, (3, 3))}
    if opts.solver == "dense":
        pairs = ba._pairs(prob, True)
        groups.update(pairs_pp=(pairs.by_pp, (6, 6)),
                      pairs_pg=(pairs.by_pg, (6, 8)),
                      pairs_gg=(pairs.by_gg, (8, 8)))
    gen = torch.Generator(device=prob.points.device).manual_seed(0)
    out = {}
    for name, (seg, shape) in groups.items():
        n = int(seg.lengths.sum())
        x = torch.randn((n,) + shape, generator=gen, dtype=torch.float64,
                        device=prob.points.device)
        fn = (lambda x=x, seg=seg: ba._segment_sum(x, seg))
        if x.is_cuda:
            from dagsfm_tpu_torch.tools.matcher_mfu import time_ms
            ms = time_ms(fn, reps=10)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        out[name] = {"rows": n, "longest_run": int(seg.lengths.max()),
                     "ms": ms}
    return out


def run(dev, lm: int = 3, **sizes) -> dict:
    sync = (torch.cuda.synchronize if dev.type == "cuda" else (lambda: None))
    saved = ba.SEGMENT_CHUNK
    res = {}
    try:
        for name, (arrays, opts, track) in problems(dev, **sizes).items():
            secs = {"chunked": [], "one pass": []}
            costs, sums = {}, {}
            ba.solve(_problem(arrays, opts, track, CHUNKED), opts,
                     max_iters=1)                         # warm-up
            for mode in ("chunked", "one pass", "one pass", "chunked"):
                prob = _problem(arrays, opts, track,
                                CHUNKED if mode == "chunked" else ONE_PASS)
                sync()
                t0 = time.perf_counter()
                _, st = ba.solve(prob, opts, max_iters=lm)
                sync()
                secs[mode].append((time.perf_counter() - t0)
                                  / st.num_iterations)
                costs.setdefault(mode, st.final_cost)
                if mode not in sums:
                    sums[mode] = _sums_ms(prob, opts)
            a, b = costs["chunked"], costs["one pass"]
            if not abs(a - b) <= 1e-9 * abs(a):
                raise AssertionError(f"{name}: costs {a} and {b} differ")
            res[name] = {"observations": int(prob.obs_xy.shape[0]),
                         "lm_iterations": lm, "s_per_lm_iteration": secs,
                         "final_cost": a, "segment_sum_ms": sums}
            print(f"  {name}: {res[name]}", file=sys.stderr, flush=True)
    finally:
        ba.SEGMENT_CHUNK = saved
    return res


def main() -> int:
    from dagsfm_tpu_torch.tools.matcher_mfu import card_line
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lm", type=int, default=3, help="LM iterations a solve")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("segment_sums: needs a CUDA card", file=sys.stderr)
        return 2
    out = {"card": card_line(), "chunk": CHUNKED,
           "problems": run(torch.device("cuda"), args.lm)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
