#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (dagsfm_tpu_torch) on one GPU.

    python3 chip_smoke.py [--num-images 100] [--max-features 8192]
                          [--breakdown]

Phases, each of which fails the run (non-zero exit, no result line) on
any error:
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. the build: every kernel library compiled from csrc/ with nvcc for
     sm_90a, one nvcc per source, all started together (build seconds,
     rebuilt or cached);
  3. the kernels: K1 (fused matcher), K2 (top2_batch), K3 (top2 and
     match_one_pair) and K4 (mfu_variant, every mode) against their
     plain PyTorch versions on the card, with ragged and masked inputs:
     K1, K2 and K4 (bf16 tensor cores) under the borderline rule, K3
     (ordered f32 FMA chains) exactly; two launches of K1, of K2 and of
     K3 on the same inputs must agree bit for bit; each timed with CUDA
     events (device time, the launches queued behind a spin kernel)
     beside its bound and one PyTorch call, K1 also at the pixel path's
     shape (B = 128, K = 3,712) and K3 at 3,712 x 3,712;
  4. the tool path: dagsfm_tpu_torch.tools.matcher_mfu (K4's four modes
     and K1 at B = 256, K = 1024);
  5. the pixel path, cut to 50 images (1,225 pairs; 100 until the
     distorted path joined): rendered 1024 x 768 images -> SIFT (8192
     features) -> exhaustive matching -> full E/F/H verification with
     guided matching -> mapping -> COLMAP model, scored against ground
     truth;
  6. the distorted path, cut to 80 images (3,160 pairs; 100 until the
     distributed path joined): images rendered through a SIMPLE_RADIAL
     camera (f 1097, k1 = -0.12) -> SIFT -> exhaustive matching ->
     uncalibrated F/H verification with guided matching -> mapping from
     one blind SIMPLE_RADIAL camera (f = 1.2 max(W, H), k1 = 0, no prior;
     BA refines f and k1) -> COLMAP model, held to
     tests/test_e2e_distorted.py's limits carried to 80 images;
  7. the entry-point path: top2_batch and match_one_pair on the
     distorted path's descriptors; then they, K3's forward and reverse
     top2 on the pair (3,712 x 3,712, to the bit), and K1 on the
     distorted path's first 128-pair batch, against their plain versions
     on the same inputs;
  8. the planted path, cut to 40 images (100 until the distributed
     path joined): a planted scene through
     FeaturePipeline.match_and_verify -> to_mapper_inputs ->
     IncrementalMapper.reconstruct -> write_model_bin, scored against
     ground truth;
  9. the distributed path: a 200-image ring whose points each lie in 16
     consecutive views, planted features -> FeaturePipeline (19,900
     pairs, 156 K1 launches, essential-only) -> 20 of the pose edges
     turned by 30 degrees -> DistributedMapperController (the view-graph
     filters must drop every turned edge; two clusters of at most 100
     images before expansion, merge, final BA with track selection) ->
     write_model_bin, held to tests/test_pipeline.py's limits carried
     to 200 images;
  10. the database path: COLMAP's workflow at one cluster's size, two
     disconnected planted scenes of 50 images (the second's ids from
     1001) in one database: FeaturePipeline writes it (4,950 pairs, 39
     K1 launches), a fresh FeaturePipeline.run resumes from it (no
     launch), MapperController maps it into two models with snapshots,
     the models are written as .bin, .txt and .ply and read back, the
     pose edges are read back from it, and run_matcher_on_database
     matches 470 ring pairs on a second database that holds features
     only (4 K1 launches); K1 is then held against its plain version at
     that database's K;
  11. the BA path: bundle adjustment with the iterative PCG solver at
     bench_suite.py's 1,000 cameras and 50,000 points, first refining a
     perturbed SIMPLE_RADIAL camera's f and k1 (joint PCG), then 5 LM
     iterations of the plain pinhole solve, timed.
Every kernel launch counter is zeroed just before each path and read
just after it. It prints a `kernels` JSON line (K1's launches are the
distorted path's), the card line and, last, the result.

`plant_features` makes the planted path's data: each image's keypoints
are its visible scene points (in point order, as
synthetic.to_matching_problem numbers them), then distractors at random
pixels with random descriptors, then a masked-out tail. SIFT is ported
now; the planted path stays as the fast path that isolates matching,
verification and mapping from extraction. The CPU tests import it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import tempfile
import time

import numpy as np
import torch

K_SLOTS = 1024           # keypoint slots per image on the main path
DESC_NOISE = 0.02        # per-dimension descriptor noise of an observation
MATCH_BATCH = 128        # pairs per matcher launch on the main path
PIXEL_SLOTS = 3712       # keypoint slots per image on the pixel path
K1_TRUE = -0.12          # the distorted path's true radial distortion
PIXEL_IMAGES = 50        # the pixel path, cut to make room for the
                         # distorted path within the run's time limit
DISTORTED_IMAGES = 80    # the distorted and planted paths, cut to make
PLANTED_IMAGES = 40      # room for the distributed path, which maps
                         # clusters of the planted path's kind
DIST_IMAGES = 200        # the distributed path's ring of cameras
DIST_POINTS = 6000
DIST_WINDOW = 16         # ring cameras that see each of its points
DIST_MAX_KEYPOINTS = 480  # per image, as on the planted path
DIST_TURNED = 20         # distributed-path pose edges turned by 30 degrees
DB_IMAGES = 50           # the database path: images per scene (two scenes,
DB_POINTS = 2000         # one cluster of 100 images together)
DB_OFFSET = 1000         # the second scene's image ids start past this
DB_RING = 5              # database matching: each image and its next 5

# H100 SXM published peaks (dense): bf16 tensor cores, f32 FMA outside
# the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
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


def distort_keypoints(scene, images: dict, camera, noise: float = 0.0,
                      seed: int = 0) -> dict:
    """The keypoints of synthetic.to_matching_problem's images, projected
    again through `camera` (any model; e.g. SIMPLE_RADIAL with k1 != 0)
    plus N(0, noise) pixels: the images' records with xys replaced."""
    from dagsfm_tpu_torch.scene import cameras
    rng = np.random.default_rng(seed)
    params = torch.as_tensor(camera.padded_params())
    for i, rec in images.items():
        vis = np.nonzero(scene.visible[i - 1])[0]
        Xc = scene.points[vis] @ scene.R[i - 1].T + scene.t[i - 1]
        rec.xys = cameras.img_from_cam(
            camera.model_id, params, torch.as_tensor(Xc)).numpy() + \
            rng.normal(0.0, noise, (len(vis), 2))
    return images


def window_visibility(scene, window: int = DIST_WINDOW, seed: int = 0):
    """The scene with each point kept only in the views of `window`
    consecutive ring cameras from a random start (and only where it was
    visible), and points left in fewer than 2 views dropped: a match
    graph with the locality of a walk around a site."""
    rng = np.random.default_rng(seed)
    I, P = scene.visible.shape
    start = rng.integers(0, I, P)
    near = (np.arange(I)[:, None] - start[None, :]) % I < window
    vis = scene.visible & near
    vis &= (vis.sum(axis=0) >= 2)[None, :]
    return dataclasses.replace(scene, visible=vis,
                               is_outlier=scene.is_outlier & vis)


def turn_edges(edges: dict, n: int, min_inliers: int, degrees: float = 30.0,
               seed: int = 0):
    """`edges` ({(i, j): (R, t, num_inliers, config)}) with the rotations
    of n of them, drawn among those with at least min_inliers inliers,
    turned by `degrees` about random axes: (new edges, the turned
    pairs)."""
    rng = np.random.default_rng(seed)
    cand = [k for k, e in edges.items() if e[0] is not None
            and e[2] >= min_inliers]
    turned = [cand[k] for k in rng.choice(len(cand), n, replace=False)]
    out = dict(edges)
    for k in turned:
        axis = _unit(rng.normal(size=3))
        Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                       [-axis[1], axis[0], 0]])
        th = math.radians(degrees)
        Rx = np.eye(3) + math.sin(th) * Kx + (1 - math.cos(th)) * Kx @ Kx
        R, t, ninl, config = edges[k]
        out[k] = (Rx @ R, t, ninl, config)
    return out, set(turned)


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


def _counts() -> dict:
    """Every kernel's launch counter."""
    from dagsfm_tpu_torch.ops import matcher_kernel as mk
    from dagsfm_tpu_torch.ops import top2_matcher as tm
    return {"fused_matcher": mk.launches,
            "top2_batch": tm.top2_batch_launches,
            "top2": tm.top2_launches, "mfu_variant": tm.mfu_launches}


def _zero_counts() -> None:
    from dagsfm_tpu_torch.ops import matcher_kernel as mk
    from dagsfm_tpu_torch.ops import top2_matcher as tm
    mk.launches = 0
    tm.top2_batch_launches = tm.top2_launches = tm.mfu_launches = 0


def _bound(flops: float, nbytes: float, peak_flops: float):
    """(bound ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _entry(name, source, replaces, max_abs_err, ms, plain_ms, bound,
           library_ms, **extra) -> dict:
    return {"name": name, "status": "ported", "route": "cuda",
            "source": source, "replaces": replaces, "launches": None,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms, **extra}


def _hold_j(name: str, j, ref, flag) -> float:
    """K1's j against the plain version's under the borderline rule: they
    may differ only at the rows `flag` marks (mk.borderline_rows).
    Returns the largest |j - plain j| outside them."""
    diff = j != ref
    outside = int((diff & ~flag).sum())
    err = float((j.long() - ref.long()).abs()[~flag].max()) \
        if bool((~flag).any()) else 0.0
    print(f"  {name}: borderline rows {int(flag.sum())}, differing rows "
          f"{int(diff.sum())}, differing outside the borderline {outside}, "
          f"matches {int((ref >= 0).sum())}", flush=True)
    if outside:
        raise AssertionError(f"{name}: j differs outside the borderline")
    return err


def _time_k1(mk, dev, card: str, B: int, K: int, plain: bool):
    """K1's time at (B, K) beside its bound and torch.bmm of the same bf16
    product (and the plain version when `plain`): (ms, plain ms, bound,
    bmm ms)."""
    from dagsfm_tpu_torch.tools.matcher_mfu import time_ms
    d1, d2, m1, m2 = planted_pairs(B, K, seed=7, device=dev)
    ms = time_ms(lambda: mk.fused_match_j(d1, d2, m1, m2))
    plain_ms = (time_ms(lambda: mk.fused_match_j_reference(d1, d2, m1, m2), 3)
                if plain else None)
    lib_ms = time_ms(lambda: torch.bmm(d1, d2.transpose(1, 2)))
    flops = 2.0 * B * K * K * 128
    bound = _bound(flops, 2 * B * K * 128 * 2 + 2 * B * K + 4 * B * K,
                   PEAK_BF16_FLOPS)
    plain_txt = f"plain {plain_ms:.4f} ms, " if plain else ""
    print(f"  K1 B={B} K={K} on {card}: kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), {plain_txt}torch.bmm bf16 "
          f"yardstick {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), "
          f"bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
    return ms, plain_ms, bound, lib_ms


def kernel_phase(mk, dev, card: str) -> dict:
    """K1 against its plain version; returns the kernels-line entry."""
    print("== kernel phase K1: fused matcher vs plain version (borderline "
          f"rule, eps = {mk.EPS:.3g}: j may differ only at borderline rows)",
          flush=True)
    err = 0.0
    for B, K in ((64, 1024), (64, 2048), (64, 1000)):
        d1, d2, m1, m2 = planted_pairs(B, K, seed=K, device=dev)
        for cross in (True, False):
            j = mk.fused_match_j(d1, d2, m1, m2, cross_check=cross)
            j2 = mk.fused_match_j(d1, d2, m1, m2, cross_check=cross)
            ref = mk.fused_match_j_reference(d1, d2, m1, m2,
                                             cross_check=cross)
            flag = mk.borderline_rows(d1, d2, m1, m2, cross_check=cross)
            torch.cuda.synchronize()
            err = max(err, _hold_j(f"B={B} K={K} cross_check={cross}", j,
                                   ref, flag))
            if not torch.equal(j, j2):
                raise AssertionError("two K1 launches on the same inputs "
                                     "differ")
        del d1, d2, m1, m2, j, j2, ref, flag
    # timing at the planted path's shape (one launch per 128-pair batch),
    # then at the pixel path's (K = 3,712 slots)
    ms, plain_ms, bound, lib_ms = _time_k1(mk, dev, card, MATCH_BATCH,
                                           K_SLOTS, plain=True)
    ms2, _, bound2, lib2 = _time_k1(mk, dev, card, MATCH_BATCH, PIXEL_SLOTS,
                                    plain=False)
    return _entry("fused_matcher", "dagsfm_tpu_torch/csrc/fused_matcher.cu",
                  "dagsfm_tpu/ops/pallas_matcher.py:246", err, ms,
                  plain_ms, bound, lib_ms,
                  pixel_shape={"B": MATCH_BATCH, "K": PIXEL_SLOTS, "ms": ms2,
                               "bound_ms": bound2[0], "bound_by": bound2[1],
                               "library_ms": lib2})


def _hold(name: str, out, ref, border=None) -> float:
    """Kernel outputs (best, second, idx[, rev]) against the plain
    version's. With `border` = (rows, cols) from the borderline rule
    (bf16 kernels): best and second within EPS, idx and rev equal outside
    the flagged rows and columns. Without it (K3): equal to the bit.
    Prints the counts; returns the largest score error."""
    from dagsfm_tpu_torch.ops.top2_matcher import EPS
    err = 0.0
    for what, a, b in zip(("best", "second"), out[:2], ref[:2]):
        fin = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), fin) or \
                not torch.equal(a[~fin], b[~fin]):
            raise AssertionError(f"{name}: {what} infinities differ")
        if bool(fin.any()):
            err = max(err, float((a[fin] - b[fin]).abs().max()))
    rows, cols = border if border is not None else (None, None)
    outside = 0
    msg = []
    for what, a, b, flag in zip(("idx", "rev"), out[2:], ref[2:],
                                (rows, cols)):
        diff = a != b
        msg.append(f"differing {what} {int(diff.sum())}")
        if flag is not None:
            n_out = int((diff & ~flag).sum())
            msg.append(f"borderline {'rows' if what == 'idx' else 'columns'}"
                       f" {int(flag.sum())}, differing {what} outside them "
                       f"{n_out}")
            outside += n_out
        else:
            outside += int(diff.sum())
    print(f"  {name}: {', '.join(msg)}, max |best or second - plain| "
          f"{err:.3g}", flush=True)
    if outside or err > (EPS if border is not None else 0.0):
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def top2_phase(tm, dev, card: str) -> list:
    """K2 and K4 (every mode) at B = 64, K in {1024, 2048, 1000}; K3 and
    match_one_pair at (1024, 1024) and (1024, 2048); then each timed at
    its timing shape (K3 also at the pixel path's). Returns the
    kernels-line entries of K2, K4, K3."""
    from dagsfm_tpu_torch.tools.matcher_mfu import time_ms
    print("== kernel phase K2 / K4: top2_batch and mfu_variant vs plain "
          f"versions (borderline rule, eps = {tm.EPS:.3g}: best / second "
          "within eps, idx / rev equal outside borderline rows / columns; "
          "mode 3 equal to K2)", flush=True)
    err2 = err4 = err3 = 0.0
    for K in (1024, 2048, 1000):
        d1, d2, m1, m2 = planted_pairs(64, K, seed=K + 1, device=dev)
        out = tm.top2_batch(d1, d2, m1, m2)
        again = tm.top2_batch(d1, d2, m1, m2)
        ref = tm.top2_batch_reference(d1, d2, m1, m2)
        torch.cuda.synchronize()
        scores = tm.ordered_scores(d1.to(torch.bfloat16),
                                   d2.to(torch.bfloat16))
        masked = torch.where(m1[:, :, None] & m2[:, None, :], scores,
                             -torch.inf)
        border = {True: tm.borderline_of_scores(masked),
                  False: tm.borderline_of_scores(scores)}
        print(f" B=64 K={K}:", flush=True)
        err2 = max(err2, _hold("top2_batch", out, ref, border[True]))
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError("two K2 launches on the same inputs differ")
        for mode in range(4):
            v = tm.mfu_variant(d1, d2, m1, m2, mode)
            vref = tm.mfu_variant_reference(d1, d2, m1, m2, mode)
            err4 = max(err4, _hold(f"mfu_variant mode {mode}", v, vref,
                                   border[mode == 3]))
            if mode == 3 and not all(torch.equal(a, b)
                                     for a, b in zip(v, out)):
                raise AssertionError("mfu_variant mode 3 != top2_batch")
        del d1, d2, m1, m2, out, again, ref, scores, masked, border
    print("== kernel phase K3: top2 and match_one_pair vs plain versions "
          "(ordered f32 FMAs; equal to the bit; matches equal; two launches "
          "equal)", flush=True)
    for K1, K2 in ((1024, 1024), (1024, 2048)):
        # pair 1: planted_pairs masks every column of pair 0
        d1, d2, m1, m2 = planted_pairs(2, K2, seed=K1 + K2, device=dev)
        a = d1[1, :K1].float().contiguous()
        b = d2[1].float().contiguous()
        out = tm.top2(a, b)
        again = tm.top2(a, b)
        ref = tm.top2_reference(a, b)
        print(f" K1={K1} K2={K2}:", flush=True)
        err3 = max(err3, _hold("top2", out, ref))
        if not all(torch.equal(x, y) for x, y in zip(out, again)):
            raise AssertionError("two K3 launches on the same inputs differ")
        mm, n = tm.match_one_pair(a, b, m1[1, :K1], m2[1])
        rm, rn = tm.match_one_pair_reference(a, b, m1[1, :K1], m2[1])
        diff = int((mm != rm).any(-1).sum())
        print(f"  match_one_pair: {int(n)} matches, differing rows {diff}",
              flush=True)
        if diff or int(n) != int(rn) or int(n) == 0:
            raise AssertionError("match_one_pair disagrees")

    entries = []
    B, K = 256, 1024                   # the reference tool's shape
    d1, d2, m1, m2 = planted_pairs(B, K, seed=11, device=dev)
    flops = 2.0 * B * K * K * 128
    desc_b, mask_b, out_b = 2 * B * K * 128 * 2, 2 * B * K, 4 * B * K * 4
    lib_ms = time_ms(lambda: torch.bmm(d1, d2.transpose(1, 2)))
    ms2 = time_ms(lambda: tm.top2_batch(d1, d2, m1, m2))
    plain2 = time_ms(lambda: tm.top2_batch_reference(d1, d2, m1, m2), 3)
    bound2 = _bound(flops, desc_b + mask_b + out_b, PEAK_BF16_FLOPS)
    print(f"  top2_batch B={B} K={K} on {card}: kernel {ms2:.4f} ms "
          f"({flops / ms2 / 1e9:.1f} TFLOP/s), plain {plain2:.4f} ms, "
          f"torch.bmm bf16 yardstick {lib_ms:.4f} ms "
          f"({flops / lib_ms / 1e9:.1f} TFLOP/s), bound {bound2[0]:.4f} ms "
          f"({bound2[1]})", flush=True)
    entries.append(_entry(
        "top2_batch", "dagsfm_tpu_torch/csrc/top2_matcher.cu",
        "dagsfm_tpu/ops/pallas_matcher.py:157", err2, ms2, plain2, bound2,
        lib_ms))
    by_mode = {}
    for mode in range(4):
        ms = time_ms(lambda: tm.mfu_variant(d1, d2, m1, m2, mode))
        pl = time_ms(lambda: tm.mfu_variant_reference(d1, d2, m1, m2,
                                                       mode), 3)
        bd = _bound(flops, desc_b + (mask_b if mode == 3 else 0) + out_b,
                    PEAK_BF16_FLOPS)
        by_mode[mode] = (ms, pl, bd)
        print(f"  mfu_variant mode {mode} B={B} K={K} on {card}: kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {pl:.4f} "
              f"ms, bound {bd[0]:.4f} ms ({bd[1]})", flush=True)
    ms4, plain4, bound4 = by_mode[3]
    entries.append(_entry(
        "mfu_variant", "dagsfm_tpu_torch/csrc/top2_matcher.cu",
        "tools/matcher_mfu.py:30", err4, ms4, plain4, bound4, lib_ms,
        ms_by_mode={str(m): v[0] for m, v in by_mode.items()}))
    del d1, d2, m1, m2
    # K3 at its timing shape, then at the pixel path's (3,712 slots)
    ms3, plain3, bound3, lib3 = _time_k3(tm, dev, card, 1024)
    ms3p, plain3p, bound3p, lib3p = _time_k3(tm, dev, card, PIXEL_SLOTS)
    entries.append(_entry(
        "top2", "dagsfm_tpu_torch/csrc/top2_matcher.cu",
        "dagsfm_tpu/ops/pallas_matcher.py:28", err3, ms3, plain3, bound3,
        lib3, pixel_shape={"K1": PIXEL_SLOTS, "K2": PIXEL_SLOTS, "ms": ms3p,
                           "plain_ms": plain3p, "bound_ms": bound3p[0],
                           "bound_by": bound3p[1], "library_ms": lib3p}))
    return entries


def _time_k3(tm, dev, card: str, K: int):
    """K3 at K x K f32 beside its bound, its plain version and torch.mm of
    the same product with TF32 off (the setting is put back after): (ms,
    plain ms, bound, mm ms)."""
    from dagsfm_tpu_torch.tools.matcher_mfu import time_ms
    d1, d2, _, _ = planted_pairs(1, max(K, 2048), seed=13, device=dev)
    a = d1[0, :K].float().contiguous()
    b = d2[0, :K].float().contiguous()
    ms = time_ms(lambda: tm.top2(a, b))
    plain_ms = time_ms(lambda: tm.top2_reference(a, b), 3)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib_ms = time_ms(lambda: torch.mm(a, b.T))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    flops = 2.0 * K * K * 128
    bound = _bound(flops, 2 * K * 128 * 4 + 3 * K * 4, PEAK_F32_FLOPS)
    print(f"  top2 {K} x {K} f32 on {card}: kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
          f"torch.mm f32 yardstick (run with TF32 off) {lib_ms:.4f} ms "
          f"({flops / lib_ms / 1e9:.1f} TFLOP/s), bound {bound[0]:.4f} ms "
          f"({bound[1]}, f32 FMA peak)", flush=True)
    return ms, plain_ms, bound, lib_ms


def tool_path(card: str) -> dict:
    """The port of tools/matcher_mfu.py as a user runs it; returns the
    launch counts of its run."""
    from dagsfm_tpu_torch.tools import matcher_mfu
    print("== tool path: python -m dagsfm_tpu_torch.tools.matcher_mfu",
          flush=True)
    _zero_counts()                                    # counts zeroed
    record = matcher_mfu.run()
    counts = _counts()                                # counts read
    for name, r in record["variants"].items():
        print(f"  {name}: {r['ms_per_call']:.4f} ms, "
              f"{r['pairs_per_s']:.0f} pairs/s, "
              f"{r['achieved_tflops']:.2f} TFLOP/s, "
              f"{r['peak_share_pct']:.3f} % of the bf16 peak, on {card}",
              flush=True)
    print(f"  launches: {counts}", flush=True)
    if counts["mfu_variant"] == 0 or counts["fused_matcher"] == 0:
        raise AssertionError("the tool path launched no K4 / K1")
    return counts


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


def _write_and_gate(rec, sc, n: int, ate_max: float, rot_max: float,
                    min_reg: int | None = None):
    """Write the COLMAP model and read it back, then hold the
    reconstruction to its gate: at least min_reg (default n) of n
    registered, ATE < ate_max, mean rotation error < rot_max degrees,
    the model read back whole and finite. Returns (pose errors, write +
    read seconds)."""
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.scene import synthetic
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        scene_io.write_model_bin(rec, tmp)
        back = scene_io.read_model_bin(tmp)
    secs = time.perf_counter() - t0
    err = synthetic.pose_errors(rec, sc)
    print(f"  registered {err['num_reg']}/{n}, points {rec.num_points3D()}, "
          f"ATE {err['ate']:.6f}, rotation error mean "
          f"{err['rot_err_deg_mean']:.6f} deg, max "
          f"{err['rot_err_deg_max']:.6f} deg", flush=True)
    if err["num_reg"] < (n if min_reg is None else min_reg) \
            or err["ate"] >= ate_max or err["rot_err_deg_mean"] >= rot_max:
        raise AssertionError(f"reconstruction out of limits: {err}")
    if back.num_reg_images() != err["num_reg"] or \
            len(back.points3D) != rec.num_points3D() or \
            {c: (x.model_id, x.params) for c, x in back.cameras.items()} != \
            {c: (x.model_id, x.params) for c, x in rec.cameras.items()}:
        raise AssertionError("COLMAP model did not read back whole")
    for p in back.points3D.values():
        if not np.all(np.isfinite(p.xyz)):
            raise AssertionError("non-finite point in the written model")
    return err, secs


def main_path(dev, card: str, num_images: int,
              breakdown: bool = False) -> dict:
    """The planted path end to end; returns its launch counts. With
    `breakdown`, the BREAKDOWN functions are timed on the way."""
    from dagsfm_tpu_torch.features import matching as fm
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        FeaturePipeline, FeaturePipelineOptions)
    from dagsfm_tpu_torch.scene import synthetic
    from dagsfm_tpu_torch.sfm.incremental_mapper import (IncrementalMapper,
                                                         MapperOptions)

    print(f"== planted path: {num_images} images, K={K_SLOTS}", flush=True)
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
    _zero_counts()                                    # counts zeroed
    stats = _install_timers() if breakdown else {}
    t0 = time.perf_counter()
    fp.match_and_verify()
    cams2, imgs2, graph = fp.to_mapper_inputs()
    t1 = time.perf_counter()
    rec = IncrementalMapper(cams2, imgs2, graph, MapperOptions(seed=0),
                            device=dev).reconstruct()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"  pairs {n_pairs}, matcher batches {n_batches}; verified pairs "
          f"{len(fp.two_view)}", flush=True)
    err, t_model = _write_and_gate(rec, sc, num_images, 0.05, 0.2)
    counts = _counts()                                # counts read
    launches = counts["fused_matcher"]
    tm = fp.timings
    print(f"  kernel launches {launches}; on {card}: matching "
          f"{tm['matching']:.3f} s ({n_pairs / tm['matching']:.1f} "
          f"pairs/s), verification {tm['verification']:.3f} s ({len(fp.two_view)} pairs verified, "
          f"{len(fp.two_view) / tm['verification']:.1f} pairs/s), mapping "
          f"{t2 - t1:.3f} s ({err['num_reg'] / (t2 - t1):.3f} images/s), "
          f"model write+read {t_model:.3f} s, end to end "
          f"{t2 - t0 + t_model:.3f} s", flush=True)
    for name, (calls, secs) in stats.items():
        print(f"  breakdown on {card} (synchronised timers): {name}: "
              f"{calls} calls, {secs:.3f} s", flush=True)
    if launches != n_batches:
        raise AssertionError(f"matcher launches {launches} != batches "
                             f"{n_batches}")
    return counts


def distributed_path(dev, card: str) -> dict:
    """DAGSfM in process: a 200-camera ring whose points each lie in a
    window of 16 consecutive views, planted features -> exhaustive
    matching and essential-only verification -> DistributedMapperController
    with the reference's defaults (clusters of at most 100 images,
    SPECTRAL, final BA with track selection) -> COLMAP model. Held to
    tests/test_pipeline.py's limits carried to 200 images. Returns the
    launch counts."""
    from dagsfm_tpu_torch.features import matching as fm
    from dagsfm_tpu_torch.pipeline.distributed_mapper import (
        DistributedMapperController, DistributedMapperOptions)
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        FeaturePipeline, FeaturePipelineOptions)
    from dagsfm_tpu_torch.scene import synthetic

    print(f"== distributed path: {DIST_IMAGES} images, {DIST_POINTS} points, "
          f"each in a window of {DIST_WINDOW} ring views, K={K_SLOTS}; "
          f"{DIST_TURNED} pose edges turned by 30 deg", flush=True)
    t0 = time.perf_counter()
    sc = window_visibility(synthetic.generate(synthetic.SyntheticSceneSpec(
        num_cameras=DIST_IMAGES, num_points=DIST_POINTS, pixel_noise=0.3,
        seed=2)), seed=2)
    per_image = sc.visible.sum(axis=1)
    if per_image.max() > DIST_MAX_KEYPOINTS:
        raise AssertionError(f"an image sees {per_image.max()} points > "
                             f"{DIST_MAX_KEYPOINTS}")
    kps, descs, masks = plant_features(sc)
    ids = sorted(kps)
    fp = FeaturePipeline({i: None for i in ids}, {i: sc.camera for i in ids},
                         FeaturePipelineOptions(two_view_essential_only=True),
                         device=dev)
    fp.keypoints, fp.descriptors, fp.masks = kps, descs, masks
    fp.bank = fm.make_bank(descs, masks, ids, device=dev)
    n_pairs = len(ids) * (len(ids) - 1) // 2
    n_batches = math.ceil(n_pairs / MATCH_BATCH)
    print(f"  set-up: scene and planted features "
          f"{time.perf_counter() - t0:.3f} s; keypoints per image mean "
          f"{per_image.mean():.1f}, min {per_image.min()}, max "
          f"{per_image.max()}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()                                    # counts zeroed
    t0 = time.perf_counter()
    fp.match_and_verify()
    cams, imgs, graph = fp.to_mapper_inputs()
    min_matches = DistributedMapperOptions().min_num_matches
    edges, turned = turn_edges(fp.two_view_edges(), DIST_TURNED,
                               min_matches, seed=2)
    ctrl = DistributedMapperController(
        cams, imgs, graph, two_view_geometries=edges, device=dev)
    rec = ctrl.run()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    err, t_model = _write_and_gate(rec, sc, DIST_IMAGES, 0.05, 0.3,
                                   min_reg=math.ceil(DIST_IMAGES * 22 / 24))
    counts = _counts()                                # counts read
    tm = fp.timings
    sizes = [len(c.image_ids) for c in ctrl.clusters]
    rmse = ctrl.separator_rmse(rec)
    st = ctrl.ba_stats
    print(f"  on {card}: pairs {n_pairs}, K1 launches "
          f"{counts['fused_matcher']} "
          f"(batches {n_batches}); pairs classified {fp.num_classified}, "
          f"verified {len(fp.two_view)}; view-graph edges "
          f"{ctrl.view_graph_edges}; clusters {len(sizes)}, sizes {sizes} "
          f"({ctrl.clustering_summary}); registered per local model "
          f"{ctrl.local_reg_images}; separators "
          f"{len(ctrl.separators)}, separator RMSE {rmse:.6f} px; final BA "
          f"{st.num_iterations} LM iterations, cost {st.initial_cost:.6g} -> "
          f"{st.final_cost:.6g}", flush=True)
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in ctrl.timings.items())
    rate = fp.num_classified / tm["verification"]
    print(f"  on {card}: matching {tm['matching']:.3f} s, verification "
          f"{tm['verification']:.3f} s ({rate:.2f} pairs/s); controller "
          f"stages: {stages}; model write+read "
          f"{t_model:.3f} s; end to end {t1 - t0 + t_model:.3f} s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          "GiB", flush=True)
    vg = ctrl.view_graph_edges
    steps = list(vg)
    built = {k for k, e in edges.items()
             if e[0] is not None and e[2] >= min_matches}
    removed = built - set(ctrl.view_graph.edges)
    print(f"  view-graph filters on the turned edges: "
          + ", ".join(f"{b} {vg[a] - vg[b]}" for a, b in zip(steps,
                                                            steps[1:]))
          + f" edges dropped; turned {len(turned)}, of them dropped "
          f"{len(turned & removed)}; dropped in all {len(removed)}",
          flush=True)
    if not (vg["built"] > vg["final"] and turned <= removed):
        raise AssertionError("the view-graph filters kept a turned edge")
    if counts["fused_matcher"] != n_batches:
        raise AssertionError(f"K1 launches {counts['fused_matcher']} != "
                             f"batches {n_batches}")
    if not (len(sizes) >= 2 and len(ctrl.local_recons) >= 2
            and len(ctrl.separators) >= 2 and max(sizes) >= 100
            and rmse < 2.0):
        raise AssertionError("distributed path out of limits")
    return counts


def _same_models(a, b) -> bool:
    """Two ReconstructionManagers hold the same cameras, registered poses
    and keypoints, points and tracks, to the bit."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if {c: (v.model_id, v.params) for c, v in x.cameras.items()} != \
                {c: (v.model_id, v.params) for c, v in y.cameras.items()}:
            return False
        if sorted(x.reg_image_ids) != sorted(y.reg_image_ids):
            return False
        for i in x.reg_image_ids:
            p, q = x.images[i], y.images[i]
            if not all(np.array_equal(getattr(p, f), getattr(q, f))
                       for f in ("qvec", "tvec", "xys", "point3D_ids")):
                return False
        if sorted(x.points3D) != sorted(y.points3D):
            return False
        for k, p in x.points3D.items():
            q = y.points3D[k]
            if not (np.array_equal(p.xyz, q.xyz) and p.track == q.track):
                return False
    return True


def database_path(dev, card: str) -> dict:
    """COLMAP's own workflow on one database at one cluster's size: two
    disconnected planted scenes of DB_IMAGES images (the second's image
    ids offset by DB_OFFSET) -> FeaturePipeline writes the database ->
    a fresh FeaturePipeline.run resumes from it -> MapperController
    (one model per scene, snapshots) -> the models as .bin, .txt and
    .ply, read back -> the pose edges read back from the database ->
    run_matcher_on_database on ring pairs of a second database that
    holds features only. Held to the planted path's limits per model.
    Returns the launch counts; then holds K1 against its plain version
    at the database's K."""
    import os

    from dagsfm_tpu_torch.features import matching as fm
    from dagsfm_tpu_torch.ops import matcher_kernel as mk
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        FeaturePipeline, FeaturePipelineOptions, load_features_from_database,
        load_two_view_geometries_from_database, run_matcher_on_database)
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.scene import synthetic
    from dagsfm_tpu_torch.scene.reconstruction import Reconstruction
    from dagsfm_tpu_torch.scene.reconstruction_manager import \
        ReconstructionManager
    from dagsfm_tpu_torch.sfm.incremental_mapper import MapperOptions
    from dagsfm_tpu_torch.sfm.mapper_controller import (ControllerOptions,
                                                        MapperController)

    print(f"== database path: two planted scenes of {DB_IMAGES} images "
          f"({DB_POINTS} points each; the second's ids from "
          f"{DB_OFFSET + 1}) in one COLMAP database, K={K_SLOTS}", flush=True)
    t0 = time.perf_counter()
    scenes, kps, descs, masks = {}, {}, {}, {}
    for seed, off in ((2, 0), (3, DB_OFFSET)):
        sc = synthetic.generate(synthetic.SyntheticSceneSpec(
            num_cameras=DB_IMAGES, num_points=DB_POINTS, pixel_noise=0.3,
            seed=seed, max_track_length=12))
        scenes[off] = sc
        k, d, m = plant_features(sc, seed=seed)
        for i in k:
            kps[i + off], descs[i + off], masks[i + off] = k[i], d[i], m[i]
    if scenes[0].camera != scenes[DB_OFFSET].camera:
        raise AssertionError("the two scenes' cameras differ")
    ids = sorted(kps)
    opts = FeaturePipelineOptions(two_view_essential_only=True)
    n_pairs = len(ids) * (len(ids) - 1) // 2
    ring = [(s[k], s[k + d]) for s in (ids[:DB_IMAGES], ids[DB_IMAGES:])
            for k in range(len(s)) for d in range(1, DB_RING + 1)
            if k + d < len(s)]
    batches = {"write": math.ceil(n_pairs / MATCH_BATCH),
               "database matching": math.ceil(len(ring) / MATCH_BATCH)}
    print(f"  set-up: scenes and planted features "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        db, db2 = os.path.join(tmp, "database.db"), \
            os.path.join(tmp, "features.db")
        snap = os.path.join(tmp, "snapshots")
        fp = FeaturePipeline({i: None for i in ids},
                             {i: scenes[0].camera for i in ids}, opts,
                             device=dev, database_path=db)
        fp.keypoints, fp.descriptors, fp.masks = kps, descs, masks
        fp.bank = fm.make_bank(descs, masks, ids, device=dev)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()                                # counts zeroed
        # 1. write: the features alone (what feature_extractor leaves) to
        # db2, then match, verify and write the whole database
        t0 = time.perf_counter()
        fp.write_database(db2)
        fp.match_and_verify()
        fp.write_database()
        secs["write"] = time.perf_counter() - t0
        k1 = {"write": _counts()["fused_matcher"]}
        # 2. resume: nothing is computed
        t0 = time.perf_counter()
        resume = FeaturePipeline({}, {}, database_path=db)
        cams, images, graph = resume.run()
        secs["resume"] = time.perf_counter() - t0
        k1["resume"] = _counts()["fused_matcher"] - k1["write"]
        _, mem_images, mem_graph = fp.to_mapper_inputs()
        same_pairs = set(graph.pair_matches) == set(mem_graph.pair_matches)
        same_matches = same_pairs and all(
            np.array_equal(graph.matches_between(i, j), m)
            for (i, j), m in mem_graph.pair_matches.items())
        # 3. map
        t0 = time.perf_counter()
        mgr = MapperController(cams, images, graph, ControllerOptions(
            mapper=MapperOptions(seed=0, snapshot_path=snap,
                                 snapshot_images_freq=10)),
            device=dev).run()
        torch.cuda.synchronize()
        secs["map"] = time.perf_counter() - t0
        # 4. the models as .bin, .txt and .ply, read back
        t0 = time.perf_counter()
        read_back = {}
        for layout, binary in (("bin", True), ("txt", False)):
            out = os.path.join(tmp, f"sparse_{layout}")
            mgr.write(out, binary=binary)
            read_back[layout] = ReconstructionManager.read(out)
        ply = []
        for k, rec in enumerate(mgr):
            path = os.path.join(tmp, f"model{k}.ply")
            scene_io.write_model_ply(rec, path)
            ply.append(os.path.getsize(path))
        secs["model I/O"] = time.perf_counter() - t0
        snaps = sorted(os.listdir(snap)) if os.path.isdir(snap) else []
        last_snap = scene_io.read_model_bin(os.path.join(snap, snaps[-1])) \
            if snaps else None
        # 5. the pose edges read back
        t0 = time.perf_counter()
        edges = load_two_view_geometries_from_database(db, device=dev)
        secs["pose edges"] = time.perf_counter() - t0
        mem_edges = {k: e for k, e in fp.two_view_edges().items()
                     if e[2] >= 5}
        rot_gap = max((_angle_deg(edges[k][0], e[0])
                       for k, e in mem_edges.items() if k in edges),
                      default=0.0)
        # 6. matching and verification on the database of features
        t0 = time.perf_counter()
        n_db = run_matcher_on_database(db2, ring, opts, device=dev)
        torch.cuda.synchronize()
        secs["database matching"] = time.perf_counter() - t0
        counts = _counts()                            # counts read
        k1["database matching"] = counts["fused_matcher"] - k1["write"] \
            - k1["resume"]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with scene_io.ColmapDatabase(db2) as d:
            n_db_rows = d.num_two_view_geometries()
            db2_pairs = {tuple(g[:2]) for g in
                         d.read_all_two_view_geometries()}
        with scene_io.ColmapDatabase(db) as d:
            n_geoms = d.num_two_view_geometries()
        db_bytes = os.path.getsize(db)
        # K1 held against its plain version at the database's K, on the
        # first batch of ring pairs (outside the counted run)
        _, _, ddesc, dmask, *_ = load_features_from_database(db2)
        bank = fm.make_bank(ddesc, dmask, sorted(ddesc), device=dev)
        first = ring[:MATCH_BATCH]
        i1 = torch.tensor([bank.slot[a] for a, _ in first], device=dev)
        i2 = torch.tensor([bank.slot[b] for _, b in first], device=dev)
        d1, d2, m1, m2 = (bank.desc[i1], bank.desc[i2], bank.mask[i1],
                          bank.mask[i2])
        _hold_j(f"fused matcher, the database's first ring batch "
                f"(B={len(first)}, K={d1.shape[1]})",
                mk.fused_match_j(d1, d2, m1, m2),
                mk.fused_match_j_reference(d1, d2, m1, m2),
                mk.borderline_rows(d1, d2, m1, m2))

    tm = fp.timings
    print(f"  on {card}: K1 launches {k1} (batches {batches}); write "
          f"{secs['write']:.3f} s (matching {tm['matching']:.3f} s, "
          f"verification {tm['verification']:.3f} s: {fp.num_classified} "
          f"pairs classified, {fp.num_classified / tm['verification']:.2f} "
          f"pairs/s; {len(fp.two_view)} verified); database "
          f"{db_bytes / 2 ** 20:.2f} MiB on disk, {n_geoms} two-view "
          f"geometries", flush=True)
    print(f"  on {card}: resume {secs['resume']:.3f} s (timings "
          f"{resume.timings}, {len(images)} images, "
          f"{len(graph.pair_matches)} pairs, the same correspondences as "
          f"in memory: {same_matches})", flush=True)
    errs = []
    for k, rec in enumerate(mgr):
        off = DB_OFFSET if min(rec.reg_image_ids) > DB_OFFSET else 0
        view = Reconstruction()
        view.images = {i - off: im for i, im in rec.images.items()}
        err = synthetic.pose_errors(view, scenes[off])
        errs.append(err)
        print(f"  model {k} (scene from id {off + 1}): registered "
              f"{err['num_reg']}/{DB_IMAGES}, points {rec.num_points3D()}, "
              f"PLY {ply[k]} bytes, ATE {err['ate']:.6f}, rotation error "
              f"mean {err['rot_err_deg_mean']:.6f} deg, max "
              f"{err['rot_err_deg_max']:.6f} deg", flush=True)
    print(f"  on {card}: map {secs['map']:.3f} s "
          f"({sum(e['num_reg'] for e in errs) / secs['map']:.3f} images/s), "
          f"{len(mgr)} models; snapshots {len(snaps)} ({snaps}); model "
          f"I/O (.bin, .txt, .ply, read back) {secs['model I/O']:.3f} s; "
          f"pose edges {secs['pose edges']:.3f} s ({len(edges)} edges, "
          f"{len(mem_edges)} in memory, largest rotation gap "
          f"{rot_gap:.3g} deg); database matching "
          f"{secs['database matching']:.3f} s ({len(ring)} ring pairs, "
          f"{n_db} verified, {n_db_rows} rows); database path "
          f"{sum(secs.values()):.3f} s; peak device memory {peak:.2f} GiB",
          flush=True)

    if k1 != {"write": batches["write"], "resume": 0,
              "database matching": batches["database matching"]}:
        raise AssertionError(f"database path: K1 launches {k1}")
    if resume.timings != {} or set(images) != set(mem_images) \
            or not same_matches:
        raise AssertionError("database path: the resume is not the run")
    if len(mgr) != 2 or any(e["num_reg"] != DB_IMAGES or e["ate"] >= 0.05
                            or e["rot_err_deg_mean"] >= 0.2 for e in errs):
        raise AssertionError(f"database path: models out of limits {errs}")
    if not all(_same_models(read_back[x], mgr) for x in read_back):
        raise AssertionError("database path: models did not read back")
    if len(snaps) < 4 or last_snap.num_reg_images() != \
            int(snaps[-1].split("_")[1]):
        raise AssertionError(f"database path: snapshots {snaps}")
    if set(edges) != set(mem_edges) or rot_gap >= 1e-3:
        raise AssertionError("database path: pose edges differ")
    if not (n_db == n_db_rows >= 0.95 * len(ring)
            and db2_pairs <= set(fp.two_view)):
        raise AssertionError(f"database path: database matching verified "
                             f"{n_db} of {len(ring)}")
    return counts


def _angle_deg(R1, R2) -> float:
    cos = (np.trace(np.asarray(R1).T @ np.asarray(R2)) - 1) / 2
    return math.degrees(math.acos(min(1.0, max(-1.0, cos))))


def pixel_path(dev, card: str, num_images: int, max_features: int,
               W: int = 1024, H: int = 768, distorted: bool = False):
    """Rendered pixels to a COLMAP model: returns (launch counts, the
    FeaturePipeline). `distorted`: the images are rendered through a
    SIMPLE_RADIAL camera (k1 = K1_TRUE) and mapped from one blind
    SIMPLE_RADIAL camera shared by every image (f = 1.2 max(W, H),
    k1 = 0, no prior), as tests/test_e2e_distorted.py's variant B;
    otherwise each image has a SIMPLE_PINHOLE camera with the true focal
    as its prior."""
    from dagsfm_tpu_torch.features import sift
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        FeaturePipeline, FeaturePipelineOptions)
    from dagsfm_tpu_torch.scene import cameras
    from dagsfm_tpu_torch.scene import synthetic
    from dagsfm_tpu_torch.ops import two_view_classify as tvc
    from dagsfm_tpu_torch.sfm.incremental_mapper import (IncrementalMapper,
                                                         MapperOptions)

    f = 480.0 * W / 448                               # 1097 at W = 1024
    name = "distorted path" if distorted else "pixel path"
    verif = "uncalibrated F/H" if distorted else "full E/F/H"
    print(f"== {name}: {num_images} rendered {W} x {H} images, SIFT "
          f"max_num_features={max_features}, {verif}, guided matching",
          flush=True)
    # tests/test_e2e_pixels.py's scene at one cluster of images and a
    # 1024 x 768 camera (1097 = 480 * 1024 / 448 keeps its field of view)
    spec = synthetic.SyntheticSceneSpec(
        num_cameras=num_images, num_points=50, image_width=W,
        image_height=H, focal=f, seed=4, ring_radius=9.0,
        point_cloud_extent=3.5, ring_height_jitter=0.3)
    sc = synthetic.generate(spec)
    t0 = time.perf_counter()
    if distorted:
        truth = cameras.Camera(1, cameras.SIMPLE_RADIAL, W, H,
                               (f, W / 2.0, H / 2.0, K1_TRUE))
        images = synthetic.render_images(sc, camera=truth, device=dev)
        blind = cameras.make_simple_camera(1, W, H, model="SIMPLE_RADIAL")
        cams = {i: blind for i in images}
    else:
        images = synthetic.render_images(sc, device=dev)
        cams = {i: cameras.make_simple_camera(i, W, H, focal=f)
                for i in images}
    torch.cuda.synchronize()
    print(f"  set-up: rendering {time.perf_counter() - t0:.3f} s on {card}",
          flush=True)
    opts = FeaturePipelineOptions(guided_matching=True,
                                  two_view_essential_only=False)
    opts.sift = sift.SiftOptions(max_num_features=max_features)
    fp = FeaturePipeline(images, cams, opts, device=dev)
    ids = sorted(images)
    n_pairs = len(ids) * (len(ids) - 1) // 2

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()                                    # counts zeroed
    t0 = time.perf_counter()
    fp.extract_features()
    fp.match_and_verify()
    cams2, imgs2, graph = fp.to_mapper_inputs()
    t1 = time.perf_counter()
    tm_ = fp.timings
    kp = [int(fp.masks[i].sum()) for i in ids]
    configs = {}
    for r in fp.two_view.values():
        cname = tvc.CONFIG_NAMES[r.config]
        configs[cname] = configs.get(cname, 0) + 1
    print(f"  keypoints per image: mean {np.mean(kp):.1f}, min {min(kp)}, "
          f"max {max(kp)}, slots {fp.bank.desc.shape[1]}; pairs {n_pairs}, "
          f"K1 launches {_counts()['fused_matcher']}; verified pairs "
          f"{len(fp.two_view)} {configs}; inlier matches after guided "
          f"matching {sum(r.num_inliers for r in fp.two_view.values())}",
          flush=True)
    print(f"  on {card}: extraction {tm_['extraction']:.3f} s "
          f"({num_images / tm_['extraction']:.2f} images/s), matching "
          f"{tm_['matching']:.3f} s ({n_pairs / tm_['matching']:.1f} "
          f"pairs/s), verification with guided matching "
          f"{tm_['verification']:.3f} s ({fp.num_classified} pairs "
          f"classified, {fp.num_classified / tm_['verification']:.2f}"
          f" pairs/s; guided matching {tm_['guided_matching']:.3f} s of it)",
          flush=True)
    mapper = IncrementalMapper(cams2, imgs2, graph, MapperOptions(seed=0),
                               device=dev)
    rec = mapper.reconstruct()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if distorted:
        # the test's limits at this size: its 10 of 12 registered
        err, t_model = _write_and_gate(rec, sc, num_images, 0.15, 1.5,
                                       min_reg=math.ceil(num_images * 10
                                                         / 12))
        cam = rec.cameras[1]
        print(f"  camera: {cam.model_name}, refined f {cam.params[0]:.4f} "
              f"(truth {f:.4f}, start {blind.params[0]:.4f}), k1 "
              f"{cam.params[3]:.6f} (truth {K1_TRUE}); focal-grid factors "
              f"picked {mapper.focal_grid_factors} (the grid runs on a "
              "camera's first registration only; this shared camera's is "
              "the initial pair)", flush=True)
        if cam.model_name != "SIMPLE_RADIAL" or \
                not cam.params[3] < 0.3 * K1_TRUE:
            raise AssertionError(f"distorted path: camera {cam}")
    else:
        err, t_model = _write_and_gate(rec, sc, num_images, 0.1, 1.0)
    counts = _counts()                                # counts read
    print(f"  on {card}: mapping {t2 - t1:.3f} s "
          f"({err['num_reg'] / (t2 - t1):.3f} images/s), model write+read "
          f"{t_model:.3f} s, end to end {t2 - t0 + t_model:.3f} s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          "GiB", flush=True)
    if counts["fused_matcher"] != math.ceil(n_pairs / MATCH_BATCH):
        raise AssertionError(f"{name}: K1 launches {counts}")
    return counts, fp


def ba_path(dev, card: str, num_cameras: int = 1000,
            num_points: int = 50000) -> dict:
    """Bundle adjustment in the reference's ITERATIVE_SCHUR regime at
    bench_suite.py's size: first intrinsics refinement (PCG on the joint
    system) from a SIMPLE_RADIAL camera with focal +10 % and k1 = 0.05,
    held to tests/test_bundle_adjustment.py's
    test_recovers_focal_and_k1_iterative limits; then 5 LM iterations
    of the plain pinhole solve on the same scene, timed as bench_suite
    times them. Returns the launch counts."""
    from dagsfm_tpu_torch.scene import cameras
    from dagsfm_tpu_torch.scene import synthetic
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba

    print(f"== BA path: {num_cameras} cameras, {num_points} points, "
          "max_track_length 20, pixel noise 0.5, iterative PCG", flush=True)
    const = np.zeros(num_cameras, bool)
    const[:2] = True
    _zero_counts()                                    # counts zeroed
    t0 = time.perf_counter()
    sc = synthetic.generate(synthetic.SyntheticSceneSpec(
        num_cameras=num_cameras, num_points=num_points, pixel_noise=0.5,
        seed=0, max_track_length=20, camera_model="SIMPLE_RADIAL"))
    f_gt = sc.camera.params[0]
    base = synthetic.to_scene_arrays(sc, dev)
    del sc
    rng = np.random.default_rng(1)
    base = base._replace(points_xyz=base.points_xyz + torch.as_tensor(
        rng.normal(0, 0.02, tuple(base.points_xyz.shape)), device=dev))
    cp = base.cam_params.clone()
    cp[0, 0] *= 1.10
    cp[0, 3] = 0.05
    prob = ba.make_problem(
        base._replace(cam_params=cp), max_track_len=20, const_image=const,
        cam_refine=cameras.intrinsics_refine_mask(
            base.cam_model_id.cpu().numpy(), True, False, True))
    n_obs = prob.obs_xy.shape[0]
    print(f"  set-up: scene and problem {time.perf_counter() - t0:.3f} s; "
          f"{n_obs} observations", flush=True)
    opts = ba.BAOptions(max_iterations=30, loss="trivial", refine_focal=True,
                        refine_extra=True, solver="iterative")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, st = ba.solve(prob, opts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    f_rec = float(out.cam_params[0, 0])
    k_rec = float(out.cam_params[0, 3])
    print(f"  joint iterative on {card}: {st.num_iterations} LM iterations, "
          f"{st.cg_iterations} CG iterations, {secs:.3f} s "
          f"({st.num_iterations / secs:.3f} LM iterations/s); cost "
          f"{st.initial_cost:.6g} -> {st.final_cost:.6g}; f {f_rec:.4f} "
          f"(truth {f_gt:.4f}, start {1.1 * f_gt:.4f}), k1 {k_rec:.3g} "
          "(truth 0, start 0.05)", flush=True)
    if not (abs(f_rec - f_gt) / f_gt < 0.01 and abs(k_rec) < 0.01
            and st.final_cost < 0.2 * st.initial_cost):
        raise AssertionError("BA path: intrinsics not recovered")
    del prob, out
    # the scene's true k1 is 0: its unperturbed arrays are the pinhole
    # problem
    t0 = time.perf_counter()
    prob = ba.make_problem(base._replace(cam_model_id=torch.full_like(
        base.cam_model_id, cameras.SIMPLE_PINHOLE)), max_track_len=20,
        const_image=const)
    del base
    print(f"  set-up: pinhole problem {time.perf_counter() - t0:.3f} s",
          flush=True)
    iters = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st = ba.solve(prob, ba.BAOptions(max_iterations=iters, ftol=0.0,
                                        solver="iterative"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"  plain iterative on {card}: {iters} LM iterations in "
          f"{secs:.3f} s, {iters / secs:.3f} LM iterations/s, "
          f"{st.cg_iterations / iters:.1f} CG iterations per LM step, "
          f"{prob.obs_xy.shape[0]} observations; cost "
          f"{st.initial_cost:.6g} -> {st.final_cost:.6g}", flush=True)
    if not st.final_cost < st.initial_cost:
        raise AssertionError("BA path: the plain solve did not descend")
    return _counts()                                  # counts read


def entry_path(fp, dev, card: str) -> dict:
    """top2_batch (K2) on 64 ring-neighbour pairs of a pixel path's bank
    (the distorted path's) and match_one_pair (K3) on its first pair, as
    a user calls them; then each, and K1 on the first 128-pair batch that
    path matched, held against its plain version on the same inputs."""
    from dagsfm_tpu_torch.ops import matcher_kernel as mk
    from dagsfm_tpu_torch.ops import top2_matcher as tm

    bank = fp.bank

    def batch(pairs):
        i1 = torch.tensor([bank.slot[a] for a, _ in pairs], device=dev)
        i2 = torch.tensor([bank.slot[b] for _, b in pairs], device=dev)
        return bank.desc[i1], bank.desc[i2], bank.mask[i1], bank.mask[i2]

    ids = sorted(fp.images)
    ring = [(ids[k], ids[k + 1]) for k in range(min(64, len(ids) - 1))]
    d1, d2, m1, m2 = batch(ring)
    a, b = ring[0]
    fa, fb, ma, mb = (torch.as_tensor(x, device=dev) for x in (
        fp.descriptors[a], fp.descriptors[b], fp.masks[a], fp.masks[b]))
    print(f"== entry-point path: top2_batch on {len(ring)} pairs, "
          f"match_one_pair on {ring[0]}, K={d1.shape[1]}", flush=True)
    torch.cuda.synchronize()
    _zero_counts()                                    # counts zeroed
    t0 = time.perf_counter()
    out = tm.top2_batch(d1, d2, m1, m2)
    matches, n = tm.match_one_pair(fa, fb, ma, mb)
    torch.cuda.synchronize()
    counts = _counts()                                # counts read
    print(f"  {time.perf_counter() - t0:.3f} s on {card}; match_one_pair "
          f"{int(n)} matches; launches {counts}", flush=True)

    print("  held against the plain versions on the same inputs (K2 and K1: "
          "borderline rule; match_one_pair: matches equal; K3: equal to the "
          "bit):", flush=True)
    sim = torch.where(m1[:, :, None] & m2[:, None, :],
                      tm.ordered_scores(d1, d2), -torch.inf)
    border = tm.borderline_of_scores(sim)
    del sim
    _hold("top2_batch", out, tm.top2_batch_reference(d1, d2, m1, m2), border)
    del out, border
    rm, rn = tm.match_one_pair_reference(fa, fb, ma, mb)
    diff = int((matches != rm).any(-1).sum())
    print(f"  match_one_pair: differing rows {diff}", flush=True)
    if diff or int(n) != int(rn) or int(n) == 0:
        raise AssertionError("match_one_pair disagrees on the pixel path")
    pa, pb = tm.masked_pair(fa, fb, ma, mb)
    for name, x, y in (("forward", pa, pb), ("reverse", pb, pa)):
        _hold(f"top2 {name}, {x.shape[0]} x {y.shape[0]}, the pair's masked "
              "descriptors (equal to the bit)", tm.top2(x, y),
              tm.top2_reference(x, y))
    del pa, pb
    first = fp.select_pairs()[:MATCH_BATCH]
    d1, d2, m1, m2 = batch(first)
    j = mk.fused_match_j(d1, d2, m1, m2)
    ref = mk.fused_match_j_reference(d1, d2, m1, m2)
    flag = mk.borderline_rows(d1, d2, m1, m2)
    _hold_j(f"fused matcher, the distorted path's first batch (B={len(first)}, "
            f"K={d1.shape[1]})", j, ref, flag)
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-images", type=int, default=PLANTED_IMAGES,
                    help="images of the planted path")
    ap.add_argument("--max-features", type=int, default=8192,
                    help="SIFT max_num_features on the pixel and distorted "
                         "paths")
    ap.add_argument("--breakdown", action="store_true",
                    help="time the planted path's inner functions (with a "
                         "sync around each) and profile one 5-point solve")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from dagsfm_tpu_torch.ops import cuda_build
    from dagsfm_tpu_torch.ops import matcher_kernel as mk
    from dagsfm_tpu_torch.ops import top2_matcher as tm
    from dagsfm_tpu_torch.tools.matcher_mfu import card_line

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(f"== card: {card}; torch device {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    cuda_build.load("fused_matcher", "top2_matcher")  # both nvcc at once
    mk.load_library()
    tm.load_library()
    print(f"== build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, info in cuda_build.build_info.items():
        print(f"  {name}: {'rebuilt' if info['rebuilt'] else 'cached'} in "
              f"{info['seconds']:.2f} s -> {info['path']}", flush=True)
        if info.get("ptxas"):
            print("  " + info["ptxas"].replace("\n", "\n  "), flush=True)

    k1 = kernel_phase(mk, dev, card)
    k2, k4, k3 = top2_phase(tm, dev, card)
    tool = tool_path(card)
    if args.max_features != 8192:
        print(f"== pixel and distorted paths cut to max_num_features "
              f"{args.max_features} (default 8192)", flush=True)
    print(f"== pixel path cut to {PIXEL_IMAGES} images (100 before the "
          "distorted path joined)", flush=True)
    pixel, _ = pixel_path(dev, card, PIXEL_IMAGES, args.max_features)
    print(f"== distorted path cut to {DISTORTED_IMAGES} images (100 until "
          "the distributed path joined)", flush=True)
    distorted, fp = pixel_path(dev, card, DISTORTED_IMAGES,
                               args.max_features, distorted=True)
    entry = entry_path(fp, dev, card)
    del fp
    print(f"== planted path cut to {args.num_images} images (100 until the "
          "distributed path joined)", flush=True)
    if args.breakdown:
        _profile_5pt(dev, card)
    planted = main_path(dev, card, args.num_images, args.breakdown)
    dist = distributed_path(dev, card)
    database = database_path(dev, card)
    bapath = ba_path(dev, card)
    paths = {"tool": tool, "planted": planted, "pixel": pixel,
             "distorted": distorted, "entry": entry, "distributed": dist,
             "database": database, "ba": bapath}
    for e, path in ((k1, "distorted"), (k2, "entry"), (k3, "entry"),
                    (k4, "tool")):
        e["launches"] = paths[path][e["name"]]
        e["launches_by_path"] = {p: c[e["name"]] for p, c in paths.items()}
        if not e["launches"]:
            raise AssertionError(f"{e['name']} never launched on its path")
    print(f"== whole run {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [k1, k2, k3, k4]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
