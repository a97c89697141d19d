#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (dagsfm_tpu_torch) on one GPU.

    python3 chip_smoke.py [--num-images 100]

Phases, each of which fails the run (non-zero exit, no result line) on
any error:
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. the build: every kernel of the path compiled from csrc/ with nvcc
     for sm_90a (build time, rebuilt or cached);
  3. the kernels: each kernel against its plain PyTorch version on the
     card at the main path's shapes (and ragged / masked variants),
     timed with CUDA events beside its bound and a PyTorch yardstick;
  4. the main path: a 100-image planted scene (one DAGSfM cluster)
     through FeaturePipeline.match_and_verify -> to_mapper_inputs ->
     IncrementalMapper.reconstruct -> write_model_bin, with every kernel
     launch counter zeroed just before and read just after, and the
     model scored against ground truth.
It prints a `kernels` JSON line, the card line and, last, the result.

The planted features (`plant_features`) are this script's test data:
SIFT is not ported yet, so each image's keypoints are its visible scene
points (in point order, as synthetic.to_matching_problem numbers them),
then distractors at random pixels with random descriptors, then a
masked-out tail. The CPU tests import them from here.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

K_SLOTS = 1024           # keypoint slots per image on the main path
DESC_NOISE = 0.02        # per-dimension descriptor noise of an observation
MATCH_BATCH = 128        # pairs per matcher launch on the main path

# H100 SXM published peaks (dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def plant_features(scene, K: int = K_SLOTS, noise: float = DESC_NOISE,
                   seed: int = 0):
    """SIFT-like features planted on a synthetic scene.

    Each 3D point gets a base descriptor |N(0,1)|^128, L2-normalised; an
    observation is the base plus N(0, noise) per dimension, clipped at 0
    and renormalised. Slots per image: the visible points in point order,
    then distractors (half the free slots) at random pixels with random
    descriptors, then a tail with mask False.
    Returns (keypoints, descriptors, masks): image_id (1-based) -> (K, 2)
    float64, (K, 128) float32, (K,) bool."""
    rng = np.random.default_rng(seed)
    I, P = scene.visible.shape
    W, H = scene.spec.image_width, scene.spec.image_height
    base = _unit(np.abs(rng.normal(size=(P, 128))))
    kps, descs, masks = {}, {}, {}
    for i in range(I):
        vis = np.nonzero(scene.visible[i])[0]
        n = len(vis)
        if n > K:
            raise ValueError(f"image {i + 1}: {n} visible points > K={K}")
        nd = (K - n) // 2
        kp = np.zeros((K, 2))
        desc = np.zeros((K, 128), np.float32)
        mask = np.zeros(K, bool)
        kp[:n] = scene.pixels[i, vis]
        obs = base[vis] + rng.normal(0.0, noise, (n, 128))
        desc[:n] = _unit(np.clip(obs, 0.0, None))
        kp[n:n + nd] = rng.uniform([0.0, 0.0], [W, H], (nd, 2))
        desc[n:n + nd] = _unit(np.abs(rng.normal(size=(nd, 128))))
        mask[:n + nd] = True
        kps[i + 1], descs[i + 1], masks[i + 1] = kp, desc, mask
    return kps, descs, masks


def planted_pairs(B: int, K: int, seed: int, device):
    """Matcher inputs with planted matches, distractors and masked rows /
    columns: d1, d2 (B, K, 128) bf16, m1, m2 (B, K) bool."""
    rng = np.random.default_rng(seed)
    common = K // 3
    d1 = _unit(np.abs(rng.normal(size=(B, K, 128))))
    d2 = _unit(np.abs(rng.normal(size=(B, K, 128))))
    perm = np.stack([rng.permutation(K)[:common] for _ in range(B)])
    for b in range(B):
        src = d1[b, :common]
        d2[b, perm[b]] = _unit(np.clip(
            src + rng.normal(0.0, DESC_NOISE, src.shape), 0.0, None))
    m1 = rng.random((B, K)) > 0.1
    m2 = rng.random((B, K)) > 0.1
    m1[:, K - K // 8:] = False         # masked tail as on the main path
    m2[0, :] = False                   # one pair with every column masked
    t = (lambda a, dt: torch.as_tensor(a).to(device=device, dtype=dt)
         .contiguous())
    return (t(d1, torch.bfloat16), t(d2, torch.bfloat16),
            t(m1, torch.bool), t(m2, torch.bool))


def _time_ms(fn, reps: int = 20) -> float:
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


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_phase(mk, dev, card: str) -> dict:
    """K1 against its plain version; returns the kernels-line entry."""
    print("== kernel phase: fused matcher vs plain version (tolerance: "
          "none, the j arrays must be equal)", flush=True)
    for K in (1024, 2048, 1000):
        d1, d2, m1, m2 = planted_pairs(64, K, seed=K, device=dev)
        for cross in (True, False):
            j = mk.fused_match_j(d1, d2, m1, m2, cross_check=cross)
            ref = mk.fused_match_j_reference(d1, d2, m1, m2,
                                             cross_check=cross)
            torch.cuda.synchronize()
            diff = int((j != ref).sum())
            nmatch = int((ref >= 0).sum())
            print(f"  B=64 K={K} cross_check={cross}: differing rows {diff}"
                  f" of {64 * K}, matches {nmatch}", flush=True)
            if diff:
                raise AssertionError(f"fused matcher disagrees at K={K}")
    # timing at the main path's shape: one launch per 128-pair batch
    B, K = MATCH_BATCH, K_SLOTS
    d1, d2, m1, m2 = planted_pairs(B, K, seed=7, device=dev)
    j = mk.fused_match_j(d1, d2, m1, m2)
    ref = mk.fused_match_j_reference(d1, d2, m1, m2)
    max_abs_err = float((j.long() - ref.long()).abs().max())
    ms = _time_ms(lambda: mk.fused_match_j(d1, d2, m1, m2))
    plain_ms = _time_ms(lambda: mk.fused_match_j_reference(d1, d2, m1, m2))
    lib_ms = _time_ms(lambda: torch.bmm(d1, d2.transpose(1, 2)))
    flops = 2.0 * B * K * K * 128
    nbytes = 2 * B * K * 128 * 2 + 2 * B * K + 4 * B * K
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    print(f"  B={B} K={K} on {card}: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms, torch.bmm bf16 yardstick {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'})"
          f", {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return {"name": "fused_matcher", "status": "ported", "route": "cuda",
            "source": "dagsfm_tpu_torch/csrc/fused_matcher.cu",
            "replaces": "dagsfm_tpu/ops/pallas_matcher.py:246",
            "launches": None, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms}


# Functions whose inclusive time `--breakdown` reports, in call order.
BREAKDOWN = (
    ("ops.two_view_classify", "_e_batched"),
    ("ops.ransac", "sample_indices"),
    ("ops.ransac", "ransac"),
    ("ops.epipolar", "essential_5pt"),
    ("ops.epipolar", "_nullspace_k"),
    ("ops.polynomials", "real_roots_sturm"),
    ("ops.epipolar", "sampson_error"),
    ("ops.epipolar", "essential_8pt"),
    ("ops.epipolar", "pose_from_essential"),
    ("sfm.incremental_mapper", "IncrementalMapper.find_initial_pair"),
    ("sfm.incremental_mapper", "IncrementalMapper.find_next_images"),
    ("sfm.incremental_mapper", "IncrementalMapper.register_next_image"),
    ("ops.absolute_pose", "p3p"),
    ("ops.absolute_pose", "refine_pose"),
    ("sfm.incremental_mapper", "IncrementalMapper.triangulate_image"),
    ("sfm.incremental_mapper", "IncrementalMapper.complete_tracks"),
    ("sfm.incremental_mapper", "IncrementalMapper.merge_tracks"),
    ("sfm.incremental_mapper", "IncrementalMapper.retriangulate"),
    ("sfm.incremental_mapper", "IncrementalMapper._run_ba"),
    ("sfm.bundle_adjustment", "make_problem"),
    ("sfm.bundle_adjustment", "solve"),
    ("sfm.incremental_mapper", "IncrementalMapper.filter_points"),
)


def _install_timers() -> dict:
    """Wrap every BREAKDOWN function with a timer that synchronises the
    card before and after the call; returns name -> [calls, seconds]."""
    import importlib
    stats = {}
    for mod, attr in BREAKDOWN:
        owner = importlib.import_module(f"dagsfm_tpu_torch.{mod}")
        *cls, name = attr.split(".")
        if cls:
            owner = getattr(owner, cls[0])
        fn = getattr(owner, name)
        stats[attr] = [0, 0.0]

        def timed(*a, _fn=fn, _s=stats[attr], **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            _s[0] += 1
            _s[1] += time.perf_counter() - t0
            return out
        setattr(owner, name, timed)
    return stats


def _profile_5pt(dev, card: str) -> None:
    """One 5-point solve of 4 x 256 samples under torch.profiler: its
    kernel launches and the ops that take its host time."""
    from torch.profiler import ProfilerActivity, profile

    from dagsfm_tpu_torch.ops import epipolar as epi
    g = torch.Generator(device=dev).manual_seed(0)
    x1 = torch.rand((4, 256, 5, 2), generator=g, device=dev,
                    dtype=torch.float64) - 0.5
    x2 = x1 + 0.01 * torch.rand(x1.shape, generator=g, device=dev,
                                dtype=x1.dtype)
    epi.essential_5pt(x1, x2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epi.essential_5pt(x1, x2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    launches = sum(e.count for e in avg
                   if e.key.startswith("cudaLaunchKernel"))
    print(f"  essential_5pt on 4 x 256 samples on {card}: {wall * 1e3:.3f} "
          f"ms under the profiler, {launches} kernel launches; ops by self "
          f"host time:", flush=True)
    top = sorted((e for e in avg if e.key.startswith("aten::")),
                 key=lambda e: -e.self_cpu_time_total)[:8]
    for e in top:
        print(f"    {e.key}: {e.count} calls, "
              f"{e.self_cpu_time_total / 1e3:.3f} ms", flush=True)


def main_path(mk, dev, card: str, num_images: int,
              breakdown: bool = False) -> int:
    """The slice end to end; returns the matcher launch count. With
    `breakdown`, the BREAKDOWN functions are timed on the way."""
    from dagsfm_tpu_torch.features import matching as fm
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        FeaturePipeline, FeaturePipelineOptions)
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.scene import synthetic
    from dagsfm_tpu_torch.sfm.incremental_mapper import (IncrementalMapper,
                                                         MapperOptions)

    print(f"== main path: {num_images} images, K={K_SLOTS}", flush=True)
    spec = synthetic.SyntheticSceneSpec(
        num_cameras=num_images, num_points=40 * num_images, pixel_noise=0.3,
        seed=2, max_track_length=12)
    sc = synthetic.generate(spec)
    kps, descs, masks = plant_features(sc)
    ids = sorted(kps)
    cams = {i: sc.camera for i in ids}
    fp = FeaturePipeline({i: None for i in ids}, cams,
                         FeaturePipelineOptions(two_view_essential_only=True),
                         device=dev)
    fp.keypoints, fp.descriptors, fp.masks = kps, descs, masks
    fp.bank = fm.make_bank(descs, masks, ids, device=dev)
    n_pairs = len(ids) * (len(ids) - 1) // 2
    n_batches = math.ceil(n_pairs / MATCH_BATCH)

    torch.cuda.synchronize()
    mk.launches = 0                                   # counts zeroed
    stats = _install_timers() if breakdown else {}
    t0 = time.perf_counter()
    fp.match_and_verify()
    cams2, imgs2, graph = fp.to_mapper_inputs()
    t1 = time.perf_counter()
    rec = IncrementalMapper(cams2, imgs2, graph, MapperOptions(seed=0),
                            device=dev).reconstruct()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        scene_io.write_model_bin(rec, tmp)
        back = scene_io.read_model_bin(tmp)
    launches = mk.launches                            # counts read
    t3 = time.perf_counter()

    err = synthetic.pose_errors(rec, sc)
    tm = fp.timings
    print(f"  pairs {n_pairs}, matcher batches {n_batches}, kernel launches "
          f"{launches}; verified pairs {len(fp.two_view)}", flush=True)
    print(f"  registered {err['num_reg']}/{num_images}, points "
          f"{rec.num_points3D()}, ATE {err['ate']:.6f}, rotation error mean "
          f"{err['rot_err_deg_mean']:.6f} deg, max "
          f"{err['rot_err_deg_max']:.6f} deg", flush=True)
    print(f"  on {card}: matching {tm['matching']:.3f} s "
          f"({n_pairs / tm['matching']:.1f} pairs/s), verification "
          f"{tm['verification']:.3f} s ({len(fp.two_view)} pairs verified, "
          f"{len(fp.two_view) / tm['verification']:.1f} pairs/s), mapping "
          f"{t2 - t1:.3f} s ({err['num_reg'] / (t2 - t1):.3f} images/s), "
          f"model write+read {t3 - t2:.3f} s, end to end {t3 - t0:.3f} s",
          flush=True)
    for name, (calls, secs) in stats.items():
        print(f"  breakdown on {card} (synchronised timers): {name}: "
              f"{calls} calls, {secs:.3f} s", flush=True)
    if launches != n_batches:
        raise AssertionError(f"matcher launches {launches} != batches "
                             f"{n_batches}")
    if err["num_reg"] != num_images or err["ate"] >= 0.05 \
            or err["rot_err_deg_mean"] >= 0.2:
        raise AssertionError(f"reconstruction out of limits: {err}")
    if back.num_reg_images() != num_images or \
            len(back.points3D) != rec.num_points3D():
        raise AssertionError("COLMAP model did not read back whole")
    for p in back.points3D.values():
        if not np.all(np.isfinite(p.xyz)):
            raise AssertionError("non-finite point in the written model")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-images", type=int, default=100)
    ap.add_argument("--breakdown", action="store_true",
                    help="time the main path's inner functions (with a "
                         "sync around each) and profile one 5-point solve")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from dagsfm_tpu_torch.ops import matcher_kernel as mk

    dev = torch.device("cuda")
    card = _card_line()
    print(f"== card: {card}; torch device {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    mk.load_library()
    print(f"== build: fused_matcher {'rebuilt' if mk.build_info['rebuilt'] else 'cached'}"
          f" in {time.perf_counter() - t0:.2f} s -> {mk.build_info['path']}",
          flush=True)
    if mk.build_info.get("ptxas"):
        print("  " + mk.build_info["ptxas"].replace("\n", "\n  "), flush=True)

    entry = kernel_phase(mk, dev, card)
    if args.num_images != 100:
        print(f"== main path cut to {args.num_images} images (default 100)",
              flush=True)
    if args.breakdown:
        _profile_5pt(dev, card)
    entry["launches"] = main_path(mk, dev, card, args.num_images,
                                  args.breakdown)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
