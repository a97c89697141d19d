#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (dagsfm_tpu_torch) on one GPU.

    python3 chip_smoke.py [--num-images 100] [--max-features 8192]

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
     shape (B = 128, K = 3,712) and the tools path's (B = 128, K = 512)
     and K3 at 3,712 x 3,712; then verification's minimal_nullspace
     (5-, 7- and 8-row systems, 16,384 a call) against its plain
     version in float64 and float32, timed beside its bound, the plain
     version and torch.linalg.qr (its launches are the planted path's);
     then bundle adjustment's Schur product (schur_matvec, K6) against
     its plain version at BAL Dubrovnik-356's shape, with and without
     the intrinsics, timed beside its bound and the plain version (its
     launches are the BA path's);
  4. the tool path: dagsfm_tpu_torch.tools.matcher_mfu (K4's four modes
     and K1 at B = 256, K = 1024);
  5. the pixel path, cut to 12 images (66 pairs), the number of
     tests/test_e2e_pixels.py (30 until the commands and rig paths
     joined, 50 until the parallel path did, 100 until the distorted path
     did): rendered 1024 x 768 images -> SIFT (8192 features) ->
     exhaustive matching -> full E/F/H verification with guided matching
     -> mapping -> COLMAP model, scored against ground truth;
  6. the distorted path, cut to 70 images (2,415 pairs; 80 until the
     retrieval path joined, 100 until the distributed path did): images
     rendered through a SIMPLE_RADIAL
     camera (f 1097, k1 = -0.12) -> SIFT -> exhaustive matching ->
     uncalibrated F/H verification with guided matching -> mapping from
     one blind SIMPLE_RADIAL camera (f = 1.2 max(W, H), k1 = 0, no prior;
     BA refines f and k1) -> COLMAP model, held to
     tests/test_e2e_distorted.py's limits carried to 70 images (at
     least 59 registered);
  7. the dense path, on the distorted path's model and images:
     undistort_reconstruction and undistort_image on every registered
     image (undistorted keypoints taken back through the camera must
     land on the originals); `python -m dagsfm_tpu_torch
     image_undistorter` in two processes, COLMAP and PMVS (the same
     model and files as in this process); dense_reconstruct at the
     default DenseOptions (64 depths, window radius 2, 5 iterations,
     top-2 of 4 sources) with every registered image a reference view,
     depth and normal maps and fused.ply in a workspace, the fusion
     voxel set from the sparse points for 10^5-10^6 fused points;
     `poisson_mesher` and `delaunay_mesher` in two processes on
     fused.ply, and Poisson twice in this process (bit for bit, and
     equal to the command's file); gated on the rendered sphere: the
     depth maps against the ray-sphere depth, the fused points and the
     Poisson vertices by |r - R| / R after synthetic.pose_errors'
     Sim(3), and peak device memory (no kernel launches here);
  8. the entry-point path: top2_batch and match_one_pair on the
     distorted path's descriptors; then they, K3's forward and reverse
     top2 on the pair (3,712 x 3,712, to the bit), and K1 on the
     distorted path's first 128-pair batch, against their plain versions
     on the same inputs;
  9. the planted path, cut to 40 images (100 until the distributed
     path joined): a planted scene through
     FeaturePipeline.match_and_verify -> to_mapper_inputs ->
     IncrementalMapper.reconstruct -> write_model_bin, scored against
     ground truth;
  10. the distributed path: a 200-image ring whose points each lie in 16
     consecutive views, planted features -> FeaturePipeline (19,900
     pairs, 156 K1 launches, essential-only) -> 20 of the pose edges
     turned by 30 degrees -> DistributedMapperController (the view-graph
     filters must drop every turned edge; two clusters of at most 100
     images before expansion, merge, final BA with track selection) ->
     write_model_bin, held to tests/test_pipeline.py's limits carried
     to 200 images;
  11. the database path: COLMAP's workflow at one cluster's size, two
     disconnected planted scenes of 50 images (the second's ids from
     1001) in one database: FeaturePipeline writes it (4,950 pairs, 39
     K1 launches), a fresh FeaturePipeline.run resumes from it (no
     launch), MapperController maps it into two models with snapshots,
     the models are written as .bin, .txt and .ply and read back, the
     pose edges are read back from it, and run_matcher_on_database
     matches 470 ring pairs on a second database that holds features
     only (4 K1 launches); K1 is then held against its plain version at
     that database's K. The database is kept: `python -m
     dagsfm_tpu_torch mapper` starts on it as a process as soon as it is
     written and runs beside the paths that follow; before the last
     line its models must equal the in-process MapperController's to
     the bit and meet the same limits;
  11b. the commands path, in this process through cli.main, on that
     database and its first scene's model: image_deleter (two copies
     without images 41-50 and 1-10), model_merger and sfm_aligner on
     them (all 50 registered, the two to the bit), image_registrator
     (41-50 back from the database), point_triangulator on the model
     with its points stripped, bundle_adjuster, model_aligner onto the
     true centres, model_analyzer; no kernel launches;
  12. the retrieval path: tests/test_e2e_scale.py at its 100 rendered
     images of 256 x 192 (SIFT 512, sequential pairs with BoW loop
     closure, essential-only verification, DistributedMapperController
     in clusters of at most 30), held to that test's gates (at least 90
     registered, ATE < 0.1, separator RMSE < 2 px, more than 300
     verified pairs, a seam edge), K1 then held against its plain
     version on its first batch (K = 512); then on a database of its
     features with ground-truth location priors, in this process,
     vocab_tree_builder, vocab_tree_retriever, spatial_matcher (its rows
     the verified spatial pairs of the priors) and transitive_matcher;
  13. the BA path: bundle adjustment with the iterative PCG solver at
     bench_suite.py's 1,000 cameras and 50,000 points, first refining a
     perturbed SIMPLE_RADIAL camera's f and k1 (joint PCG), then 5 LM
     iterations of the plain pinhole solve, timed;
  14. the parallel path: the distributed path's clusters as mapping jobs
     for two `python -m dagsfm_tpu_torch local_sfm_worker` processes on
     the one card, then a fresh controller that resumes from their
     partitions and runs the sharded final BA over NCCL (one rank, one
     shard), held to the distributed path's gates; a rendered ring of 24
     images in two matching jobs, one in this process (its K1 launches
     counted), one in a `local_matching_worker` process, merged and
     mapped; solve_sharded on the BA path's 1M observations, D = 8
     against D = 1 and two spawned ranks on the card (to rel 1e-9), and
     estimate_rotations_sharded on the distributed path's edges;
  15. the rig path: a four-camera rig at 50 snapshots (200 images of 640
     x 480, 1,500 points each in 8-16 snapshots, 0.5 px noise, rig
     poses, mounts and points perturbed) written with its rig config;
     `rig_bundle_adjuster` in this process at its defaults (50 LM
     iterations, mounts refined; the dense float64 J of 3.7 GiB) against
     an in-process solve (to the bit), gated on the cost, the RMS
     reprojection error and the mounts; gpnp under RANSAC (1,024
     hypotheses of 8) on snapshot 0's rays with a quarter of them
     outliers, and the 17-point solver on 17 exact ray pairs and on a
     batch of 1,024 (the batched SVD timed); no kernel launches.
  16. the photos path, right after the pixel path, on its 12 rendered
     images quantised to 8 bits (as a PNG round trip leaves them), each
     with the camera image_reader.camera_from_exif builds from an
     explicit SIMPLE_PINHOLE calibration at the true focal: the bodies
     of feature_extractor and automatic_reconstructor (exhaustive
     pairs, 1 K1 launch, mapping; the pixel path's gate, and
     feature_extractor's keypoint rows equal to automatic_reconstructor's
     database's), color_extractor (every point coloured) and
     image_rectifier on one registered pair (its shared points on one
     row); which image decoders the machine has is printed, and where
     it has PIL `python -m dagsfm_tpu_torch automatic_reconstructor`
     runs as a process on the images as PNGs, alone after the last path
     (the same gate);
  17. the orientation path: model_orientation_aligner's body with
     IMAGE-ORIENTATION on the photos path's model (gravity onto +y
     within 1e-9, the ATE unchanged within 1e-9) and MANHATTAN-WORLD on
     its images and on line_images of the same model (lines through each
     camera's vanishing points), each against the same on the CPU (the
     frames within 1e-4 rad; each accumulator within 1e-5 of its largest
     bin plus the weight of the votes rounding may move, and the peak
     bins the same but where those votes decide, `_card_against_cpu`;
     on the lines at most 8 bins off, the same bins, at least 4 lines
     per image and a down axis within 8 degrees of +y);
  18. the solvers path, right after the distributed path:
     estimate_rotations_lagrange_dual (the block SDP, 50 sweeps) and
     estimate_rotations_nonlinear on its final view graph, each within
     0.1 degree of the controller's L1-IRLS rotations; l1_regression,
     constrained_l1 and box_qp on planted problems; robust_estimate with
     each sampler and both scorings on a planted line with a quarter
     outliers;
  19. the tools path, after the rig path: the seven ported tools/ programs
     in this process through their `run` at their smoke sizes: e2e_1000
     at 101 rendered images (two clusters of at most 100; at least 90 %
     registered and ATE < 0.15; its K1 launches counted under "tools"),
     mapper_profile at 20 images (reads counted by caller) with
     multiproc_smoke's two processes (gloo) beside it, profile_two_view
     at 4 pairs, ba_phase_profile, prologue_probe and scaling_curves at
     --smoke.
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
import io
import json
import math
import sys
import tempfile
import threading
import time

import numpy as np
import torch

K_SLOTS = 1024           # keypoint slots per image on the main path
DESC_NOISE = 0.02        # per-dimension descriptor noise of an observation
MATCH_BATCH = 128        # pairs per matcher launch on the main path
PIXEL_SLOTS = 3712       # keypoint slots per image on the pixel path
K1_TRUE = -0.12          # the distorted path's true radial distortion
PIXEL_IMAGES = 12        # the pixel path, cut to its test's own 12 images
                         # to make room for the distorted, parallel,
                         # commands and rig paths within the run's time
                         # limit
DISTORTED_IMAGES = 70    # the distorted path: 100 until the distributed
                         # path joined, 80 until the retrieval path did
PLANTED_IMAGES = 40      # the planted path, cut to make room for the
                         # distributed path, which maps clusters of its kind
DIST_IMAGES = 200        # the distributed path's ring of cameras
DIST_POINTS = 6000
DIST_WINDOW = 16         # ring cameras that see each of its points
DIST_MAX_KEYPOINTS = 480  # per image, as on the planted path
DIST_TURNED = 20         # distributed-path pose edges turned by 30 degrees
DB_IMAGES = 50           # the database path: images per scene (two scenes,
DB_POINTS = 2000         # one cluster of 100 images together)
DB_OFFSET = 1000         # the second scene's image ids start past this
DB_RING = 5              # database matching: each image and its next 5
CMD_DROP = 10            # the commands path: images image_deleter drops
PAR_IMAGES = 24          # the parallel path's matching jobs: a rendered
PAR_W, PAR_H = 640, 480  # ring of 24 images, each with its next 3, at
PAR_FOCAL = 680.0        # tests/test_distributed_matching.py's field of
PAR_RING = 3             # view
PAR_FEATURES = 1024      # local_matching_worker's default
SCALE_IMAGES = 100       # the retrieval path: tests/test_e2e_scale.py's ring
SCALE_SPATIAL_NEIGHBORS = 4  # spatial_matcher's --max_num_neighbors there
MODE_NEIGHBORS = 10      # num_neighbors of the retrieval path's step (b)
DENSE_VOXELS = 120       # the dense path's fusion voxel: the sparse points'
#                          median radius over this many, for a fused
DENSE_POINTS = (1e5, 1e6)  # cloud of this many points
# the dense path's gates, their limits written before its first run on
# the card: depth maps on the pixels that see the sphere at a ray-normal
# cosine above DENSE_MIN_COS and sample inside the source image; fused
# points and Poisson vertices by |r - R| / R in the truth's frame, over
# the fused points from pixels that see the sphere and the Poisson mesh
# of those points (a fused point of a background pixel has no true
# position; PERF.md section 6 has the first run, which counted them):
# (tolerance, the median's limit, the least share within the tolerance)
DENSE_MIN_COS = 0.3
DENSE_BACKGROUND = 0.15   # render_images' background (its default)
DENSE_DEPTH_TOL, DENSE_DEPTH_MEDIAN, DENSE_DEPTH_SHARE = 0.02, 0.01, 0.6
DENSE_POINTS_TOL, DENSE_POINTS_MEDIAN, DENSE_POINTS_SHARE = 0.02, 0.015, 0.6
DENSE_POISSON_TOL, DENSE_POISSON_MEDIAN, DENSE_POISSON_SHARE = 0.02, 0.01, 0.8
DENSE_PEAK_GIB = 40.0


# H100 SXM published peaks (dense): bf16 tensor cores, f32 FMA outside
# the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SOLVER_SWEEPS = 50       # the solvers path: estimate_rotations_lagrange_dual's
#                          default sweeps of the block SDP
TOOLS_E2E_IMAGES = 101   # the tools path's e2e_1000: two clusters of <= 100
TOOLS_MAPPER_IMAGES = 20  # the tools path's mapper_profile
TOOLS_PAIRS = 4          # the tools path's profile_two_view, one call each
TOOLS_SLOTS = 512        # keypoint slots per image on the tools path
RIG_SNAPSHOTS = 50       # the rig path: a four-camera rig (ETH3D's rig
RIG_POINTS = 1500        # datasets use four cameras) on a ring of 50
RIG_TRACK = (8, 16)      # snapshots; each point seen by 8-16 of them
RIG_NOISE = 0.5          # pixels
RIG_W, RIG_H, RIG_FOCAL = 640, 480, 500.0
RIG_YAW_DEG = (-36.0, -12.0, 12.0, 36.0)   # each camera's yaw in the rig
RIG_CENTRES = ((-0.3, 0.0, 0.0), (-0.1, -0.1, 0.05), (0.1, 0.1, 0.05),
               (0.3, 0.0, 0.0))   # each camera's centre in the rig frame:
RIG_BASELINE = 0.6       # not on one line (an axial rig leaves the
#                          17-point system a second null vector)
RIG_OUTLIERS = 0.25      # gpnp's share of outlier rays
RIG_HYPS, RIG_SAMPLE = 1024, 8


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


def _yaw(deg: float) -> np.ndarray:
    a = math.radians(deg)
    return np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                     [-math.sin(a), 0.0, math.cos(a)]])


def _small_rotation(rng, sigma: float) -> np.ndarray:
    w = rng.normal(0.0, sigma, 3)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(th) * Kx + (1 - math.cos(th)) * Kx @ Kx


def rig_scene(num_snapshots: int = RIG_SNAPSHOTS,
              num_points: int = RIG_POINTS, noise: float = RIG_NOISE,
              seed: int = 0):
    """A rig of four pinhole cameras (RIG_W x RIG_H, focal RIG_FOCAL,
    yawed by RIG_YAW_DEG, centred at RIG_CENTRES in the rig frame) at
    `num_snapshots` poses on a ring of radius 10 around a cloud of points
    in [-3, 3]^3, each point kept in a random 8-16 of the snapshots that
    see it, observed by every camera there that sees it, plus N(0, noise)
    pixels.

    Returns (rec, truth). rec is a port Reconstruction with cameras 1-4,
    image s * 4 + k + 1 named `cam{k}/{s:04d}.png`, and the poses and
    points perturbed: rig poses past snapshot 0 by N(0, 0.01 rad) and
    N(0, 0.05), mounts past camera 0 by N(0, 0.01 rad) and N(0, 0.01),
    points by N(0, 0.05), so snapshot 0 and mount 0 (the gauge) are
    true. truth: rig_R (S, 3, 3), rig_t (S, 3), mount_R (4, 3, 3),
    mount_t (4, 3), points (P, 3), clean pixels (S, 4, P, 2), seen (S, 4,
    P) bool."""
    from dagsfm_tpu_torch.scene import cameras
    from dagsfm_tpu_torch.scene.reconstruction import (ImageRecord,
                                                       Reconstruction)
    from dagsfm_tpu_torch.scene.synthetic import _look_at
    from dagsfm_tpu_torch.ops import rotations as rops
    rng = np.random.default_rng(seed)
    S, P, C = num_snapshots, num_points, len(RIG_YAW_DEG)
    pts = rng.uniform(-3.0, 3.0, (P, 3))
    poses = [_look_at(np.array([10 * math.cos(2 * math.pi * s / S),
                                10 * math.sin(2 * math.pi * s / S),
                                rng.uniform(-1, 1)]),
                      rng.uniform(-0.5, 0.5, 3)) for s in range(S)]
    rig_R = np.stack([R for R, _ in poses])
    rig_t = np.stack([t for _, t in poses])
    mount_R = np.stack([_yaw(d) for d in RIG_YAW_DEG])
    mount_t = -np.einsum("cij,cj->ci", mount_R, np.array(RIG_CENTRES))
    Xr = np.einsum("sij,pj->spi", rig_R, pts) + rig_t[:, None]
    Xc = np.einsum("cij,spj->scpi", mount_R, Xr) + mount_t[None, :, None]
    z = Xc[..., 2]
    pix = Xc[..., :2] / np.where(np.abs(z) < 1e-9, 1e-9, z)[..., None] \
        * RIG_FOCAL + np.array([RIG_W / 2, RIG_H / 2])
    vis = (z > 0.2) & (pix[..., 0] >= 0) & (pix[..., 0] < RIG_W) \
        & (pix[..., 1] >= 0) & (pix[..., 1] < RIG_H)
    snap_seen = vis.any(1)                                  # (S, P)
    score = rng.random((S, P))
    score[~snap_seen] = np.inf
    rank = np.argsort(np.argsort(score, axis=0), axis=0)
    keep = snap_seen & (rank < rng.integers(RIG_TRACK[0], RIG_TRACK[1] + 1,
                                            P)[None, :])
    if keep.sum(0).min() < RIG_TRACK[0]:
        raise AssertionError("rig scene: a point seen by too few snapshots")
    seen = vis & keep[:, None, :]
    noisy = pix + rng.normal(0.0, noise, pix.shape)

    def perturb(R, t, sig_r, sig_t):
        return _small_rotation(rng, sig_r) @ R, t + rng.normal(0, sig_t, 3)
    rR, rt = rig_R.copy(), rig_t.copy()
    for s in range(1, S):
        rR[s], rt[s] = perturb(rig_R[s], rig_t[s], 0.01, 0.05)
    mR, mt = mount_R.copy(), mount_t.copy()
    for c in range(1, C):
        mR[c], mt[c] = perturb(mount_R[c], mount_t[c], 0.01, 0.01)
    pts_n = pts + rng.normal(0.0, 0.05, pts.shape)

    rec = Reconstruction()
    for c in range(C):
        rec.add_camera(cameras.Camera(
            c + 1, cameras.PINHOLE, RIG_W, RIG_H,
            (RIG_FOCAL, RIG_FOCAL, RIG_W / 2, RIG_H / 2)))
    kp_of = np.full((S, C, P), -1, np.int64)
    for s in range(S):
        for c in range(C):
            idx = np.nonzero(seen[s, c])[0]
            kp_of[s, c, idx] = np.arange(len(idx))
            R = mR[c] @ rR[s]
            rec.add_image(ImageRecord(
                image_id=s * C + c + 1, name=f"cam{c}/{s:04d}.png",
                camera_id=c + 1, qvec=rops.rotmat_to_quat_np(R),
                tvec=mR[c] @ rt[s] + mt[c], xys=noisy[s, c, idx],
                point3D_ids=np.full(len(idx), -1, np.int64),
                registered=True))
    for p in range(P):
        ss, cc = np.nonzero(seen[:, :, p])
        rec.add_point3D(pts_n[p], [(int(s * C + c + 1), int(kp_of[s, c, p]))
                                   for s, c in zip(ss, cc)])
    return rec, dict(rig_R=rig_R, rig_t=rig_t, mount_R=mount_R,
                     mount_t=mount_t, points=pts, pixels=pix, seen=seen)


def rig_config(num_cameras: int = len(RIG_YAW_DEG)) -> list:
    """rig_scene's rig in COLMAP's JSON rig config (camera 1 the
    reference)."""
    return [{"ref_camera_id": 1,
             "cameras": [{"camera_id": c + 1, "image_prefix": f"cam{c}/"}
                         for c in range(num_cameras)]}]


def rig_rays(truth: dict, s: int, p_idx=None):
    """Snapshot s's rays in its true rig frame, one per (camera, point)
    seen there (of the points p_idx, all where None), from the clean
    pixels: (points (n, 3), origins (n, 3), unit directions (n, 3),
    point index (n,), camera index (n,))."""
    seen = truth["seen"][s].copy()
    if p_idx is not None:
        keep = np.zeros(seen.shape[1], bool)
        keep[p_idx] = True
        seen &= keep[None, :]
    cc, pp = np.nonzero(seen)
    uv = (truth["pixels"][s, cc, pp] - np.array([RIG_W / 2, RIG_H / 2])) \
        / RIG_FOCAL
    Rm, tm = truth["mount_R"][cc], truth["mount_t"][cc]
    d = np.einsum("nji,nj->ni", Rm, np.concatenate(
        [uv, np.ones((len(uv), 1))], 1))
    o = -np.einsum("nji,nj->ni", Rm, tm)
    return truth["points"][pp], o, _unit(d), pp, cc


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
    from dagsfm_tpu_torch.ops import schur_matvec as sxm
    from dagsfm_tpu_torch.ops import top2_matcher as tm
    return {"fused_matcher": mk.launches,
            "top2_batch": tm.top2_batch_launches,
            "top2": tm.top2_launches, "mfu_variant": tm.mfu_launches,
            "schur_matvec": sxm.launches}


def _zero_counts() -> None:
    from dagsfm_tpu_torch.ops import matcher_kernel as mk
    from dagsfm_tpu_torch.ops import nullspace_kernel as nk
    from dagsfm_tpu_torch.ops import schur_matvec as sxm
    from dagsfm_tpu_torch.ops import top2_matcher as tm
    mk.launches = nk.launches = sxm.launches = 0
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
    # and at the tools path's (e2e_1000's 512 SIFT features)
    ms3, _, bound3, lib3 = _time_k1(mk, dev, card, MATCH_BATCH, TOOLS_SLOTS,
                                    plain=False)
    return _entry("fused_matcher", "dagsfm_tpu_torch/csrc/fused_matcher.cu",
                  "dagsfm_tpu/ops/pallas_matcher.py:246", err, ms,
                  plain_ms, bound, lib_ms,
                  pixel_shape={"B": MATCH_BATCH, "K": PIXEL_SLOTS, "ms": ms2,
                               "bound_ms": bound2[0], "bound_by": bound2[1],
                               "library_ms": lib2},
                  tools_shape={"B": MATCH_BATCH, "K": TOOLS_SLOTS, "ms": ms3,
                               "bound_ms": bound3[0], "bound_by": bound3[1],
                               "library_ms": lib3})


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


NULLSPACE_SYSTEMS = 16384   # one batch of 64 pairs x 256 hypotheses
PEAK_F64_FLOPS = 34e12      # H100 SXM float64 outside the tensor cores


def nullspace_flops(r: int) -> float:
    """Operations of one r x 9 system in the minimal-nullspace kernel:
    dgeqr2's norms, scalings and reflections, then dorg2r's reflections
    of the 9 - r unit columns."""
    qr = sum(3 * (8 - j) + (r - 1 - j) * (4 * (8 - j) + 2) for j in range(r))
    return qr + (9 - r) * sum(4 * (8 - j) + 2 for j in range(r))


def nullspace_phase(dev, card: str) -> dict:
    """The minimal-nullspace kernel against its plain version at the
    verification batch's 16,384 systems per r (float64 to 1e-12, float32
    to 1e-4; two launches equal to the bit), then timed per r beside its
    bound, the plain version and torch.linalg.qr's complete QR (what
    `_nullspace_k` called before). Returns the kernels-line entry."""
    from dagsfm_tpu_torch.ops import nullspace_kernel as nk
    from dagsfm_tpu_torch.tools.matcher_mfu import time_ms
    print("== kernel phase: minimal_nullspace vs plain version (float64 to "
          "1e-12, float32 to 1e-4; two launches equal)", flush=True)
    S = NULLSPACE_SYSTEMS
    err, by_r = 0.0, {}
    for r in nk.ROWS:
        rng = np.random.default_rng(r)
        A64 = torch.as_tensor(rng.normal(size=(S, r, 9)), device=dev)
        for A, tol in ((A64, 1e-12), (A64.float(), 1e-4)):
            N = nk.minimal_nullspace(A)
            again = nk.minimal_nullspace(A)
            gap = float((N - nk.minimal_nullspace_reference(A)).abs().max())
            print(f"  r={r} {A.dtype}: max |N - plain| {gap:.3g}", flush=True)
            if gap > tol or not torch.equal(N, again):
                raise AssertionError(f"minimal_nullspace r={r} {A.dtype} "
                                     "disagrees with its plain version")
            if A.dtype == torch.float64:
                err = max(err, gap)
        ms = time_ms(lambda: nk.minimal_nullspace(A64))
        plain_ms = time_ms(lambda: nk.minimal_nullspace_reference(A64), 3)
        lib_ms = time_ms(lambda: torch.linalg.qr(A64.mT, mode="complete"), 3)
        bound = _bound(S * nullspace_flops(r), S * 8 * 81, PEAK_F64_FLOPS)
        by_r[r] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound[0], bound_by=bound[1])
        print(f"  minimal_nullspace r={r} S={S} float64 on {card}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.linalg.qr "
              f"complete {lib_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]})", flush=True)
        del A64
    e = by_r[5]
    return _entry("minimal_nullspace",
                  "dagsfm_tpu_torch/csrc/minimal_nullspace.cu",
                  "none (XLA's jnp.linalg.qr, dagsfm_tpu/ops/epipolar.py:65)",
                  err, e["ms"], e["plain_ms"],
                  (e["bound_ms"], e["bound_by"]), e["library_ms"],
                  by_r={str(r): v for r, v in by_r.items()})


def schur_case(dev, num_images: int, num_points: int, joint: bool,
               num_cameras: int = 3, long_image: int = 600,
               num_obs: int | None = None, seed: int = 0):
    """A random Schur system of bundle adjustment's PCG (K6's input) and
    an x on `dev`, float64, on a layout that holds every edge the kernel
    takes: image 0 sees nothing, images 1 and 2 are pinned, tracks are
    runs of 2 or more ring neighbours but every seventh point is seen
    once and every eleventh is held (its W rows zero, as the solver's
    weights leave them), image 3 makes `long_image` more observations
    of random points (runs longer than SEGMENT_CHUNK), num_obs in all
    (5.5 a point by default), camera 0 is shared by every image but the
    last num_cameras - 1 (a fold longer than a warp; num_cameras =
    num_images gives one camera each), and with the intrinsics camera
    0's last three slots are held. Returns (SchurSystem, x)."""
    from dagsfm_tpu_torch.ops import schur_matvec as sxm
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
    rng = np.random.default_rng(seed)
    I, P, C = num_images, num_points, num_cameras
    size = np.where(np.arange(P) % 7 == 0, 1, 2)
    extra = (int(5.5 * P) if num_obs is None else num_obs) - long_image \
        - int(size.sum())
    more = size == 2
    size[more] += rng.multinomial(max(extra, 0),
                                  np.full(int(more.sum()), 1 / more.sum()))
    size = np.minimum(size, I - 1)
    first = rng.integers(1, I, P)
    op = np.repeat(np.arange(P), size)
    ring = np.arange(len(op)) - np.repeat(np.cumsum(size) - size, size)
    oi = 1 + (np.repeat(first, size) - 1 + ring) % (I - 1)
    oi = np.concatenate([oi, np.full(long_image, 3)])
    op = np.concatenate([op, rng.integers(0, P, long_image)])
    N = len(oi)
    camidx = np.zeros(I, np.int64)
    if C == I:
        camidx = np.arange(I)
    elif C > 1:
        camidx[I - C + 1:] = np.arange(1, C)
    const = np.zeros(I, bool)
    const[1:3] = True
    held = np.zeros(P, bool)
    held[::11] = True
    refine = np.ones((C, 8))
    refine[0, 5:] = 0.0
    prob = ba.problem_from_observations(
        np.tile([1.0, 0, 0, 0], (I, 1)), np.zeros((I, 3)), camidx,
        np.full(C, 2), np.zeros((C, 12)), np.zeros((P, 3)), oi, op,
        np.zeros((N, 2)), const_image=const, const_points=held,
        cam_refine=refine, device=dev)

    def normal(*shape):
        return torch.as_tensor(rng.normal(size=shape), device=dev)

    live = torch.as_tensor(~held[op], device=dev)[:, None, None].double()
    Wc = normal(N, 6, 3) * live
    free = (~prob.const_image).double()[:, None]
    if not joint:
        return (sxm.system(prob, Wc, None, normal(P, 3, 3), normal(I, 6, 6),
                           None, None, free, None), (normal(I, 6),))
    S = sxm.system(prob, Wc, normal(N, 8, 3) * live, normal(P, 3, 3),
                   normal(I, 6, 6), normal(I, 6, 8), normal(C, 8, 8), free,
                   (prob.cam_refine > 0).double())
    return S, (normal(I, 6), normal(C, 8))


def schur_phase(dev, card: str) -> dict:
    """K6, the Schur product of bundle adjustment's PCG, against its
    plain version at BAL Dubrovnik-356's shape (356 images and cameras,
    226,730 points, 1,255,268 observations), with and without the
    intrinsics: within 1e-12 of the largest entry, two launches equal to
    the bit, and `point_sums` likewise; timed beside its bound (the
    benchmark's CG bytes at 3.35 TB/s) and the plain version. Returns
    the kernels-line entry."""
    from dagsfm_tpu_torch.ops import schur_matvec as sxm
    from dagsfm_tpu_torch.tools.matcher_mfu import time_ms
    print("== kernel phase: schur_matvec vs plain version (float64 to 1e-12 "
          "of the largest entry; two launches equal)", flush=True)
    I, P, N = 356, 226730, 1255268
    err, by_g = 0.0, {}
    for joint in (True, False):
        S, x = schur_case(dev, I, P, joint, num_cameras=I, num_obs=N)
        G = 8 if joint else 0
        got, again = sxm.schur_mv(S, x), sxm.schur_mv(S, x)
        ref = sxm.schur_mv_reference(S, x)
        gap = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got, ref))
        t = sxm.point_sums(S, *x)
        t_ref = sxm.point_sums_reference(S, *x)
        gap = max(gap, float((t - t_ref).abs().max() / t_ref.abs().max()))
        print(f"  G={G} N={N}: max |S·x - plain| / max |plain| {gap:.3g}",
              flush=True)
        if gap > 1e-12 or not all(torch.equal(a, b)
                                  for a, b in zip(got, again)):
            raise AssertionError(f"schur_matvec G={G} disagrees with its "
                                 "plain version")
        err = max(err, gap)
        ms = time_ms(lambda: sxm.schur_mv(S, x))
        plain_ms = time_ms(lambda: sxm.schur_mv_reference(S, x), 5)
        # the benchmark's CG bytes (sfmbench/counts.py): W, V⁻¹ and the
        # int64 indices read once, the product out
        nbytes = 8 * (N * (6 + G) * 3 + P * 9 + N * (2 + joint)
                      + I * (6 + G) * 2)
        bound = _bound(0.0, nbytes, PEAK_F64_FLOPS)
        by_g[G] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                       bound_by=bound[1], observations=N)
        print(f"  schur_mv G={G} on {card}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
              "W read once)", flush=True)
        del S, x, got, again, ref
    e = by_g[8]
    return _entry("schur_matvec", "dagsfm_tpu_torch/csrc/schur_matvec.cu",
                  "none (XLA, S_mv of dagsfm_tpu/sfm/bundle_adjustment.py:"
                  "779, :959)", err, e["ms"], e["plain_ms"],
                  (e["bound_ms"], e["bound_by"]), None,
                  by_g={str(g): v for g, v in by_g.items()})


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


def main_path(dev, card: str, num_images: int) -> dict:
    """The planted path end to end; returns its launch counts."""
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
    from dagsfm_tpu_torch.ops import nullspace_kernel as nk
    counts = _counts()                                # counts read
    counts["minimal_nullspace"] = nk.launches
    launches = counts["fused_matcher"]
    tm = fp.timings
    print(f"  kernel launches {launches}; on {card}: matching "
          f"{tm['matching']:.3f} s ({n_pairs / tm['matching']:.1f} "
          f"pairs/s), verification {tm['verification']:.3f} s ({len(fp.two_view)} pairs verified, "
          f"{len(fp.two_view) / tm['verification']:.1f} pairs/s), mapping "
          f"{t2 - t1:.3f} s ({err['num_reg'] / (t2 - t1):.3f} images/s), "
          f"model write+read {t_model:.3f} s, end to end "
          f"{t2 - t0 + t_model:.3f} s", flush=True)
    if launches != n_batches:
        raise AssertionError(f"matcher launches {launches} != batches "
                             f"{n_batches}")
    if not counts["minimal_nullspace"]:
        raise AssertionError("verification launched no minimal_nullspace")
    return counts


def distributed_path(dev, card: str) -> dict:
    """DAGSfM in process: a 200-camera ring whose points each lie in a
    window of 16 consecutive views, planted features -> exhaustive
    matching and essential-only verification -> DistributedMapperController
    with the reference's defaults (clusters of at most 100 images,
    SPECTRAL, final BA with track selection) -> COLMAP model. Held to
    tests/test_pipeline.py's limits carried to 200 images. Returns the
    launch counts and what the parallel path starts from: the feature
    pipeline, the controller, the scene and the local models as mapped
    (size-sorted)."""
    from dagsfm_tpu_torch.features import matching as fm
    from dagsfm_tpu_torch.pipeline.distributed_mapper import (
        DistributedMapperController, DistributedMapperOptions)
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        FeaturePipeline, FeaturePipelineOptions)
    from dagsfm_tpu_torch.scene import io as scene_io
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
    with tempfile.TemporaryDirectory() as tmp:
        # the local models as mapped, before the merge grows the anchor's
        rec = ctrl.run(checkpoint_path=tmp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        local = [scene_io.read_model_bin(f"{tmp}/partition{k}")
                 for k in range(len(ctrl.local_recons))]
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
            and len(ctrl.separators) >= 2 and max(sizes) >= DIST_IMAGES // 2
            and rmse < 2.0):
        raise AssertionError("distributed path out of limits")
    return counts, {"fp": fp, "ctrl": ctrl, "scene": sc, "local": local}


def _same_models(a, b) -> bool:
    """Two ReconstructionManagers (or lists of models) hold the same
    cameras, registered poses and keypoints, points and tracks, to the
    bit."""
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


def database_path(dev, card: str, work: str) -> tuple:
    """COLMAP's own workflow on one database at one cluster's size: two
    disconnected planted scenes of DB_IMAGES images (the second's image
    ids offset by DB_OFFSET) -> FeaturePipeline writes the database
    (work/database.db, kept for the commands path; `python -m
    dagsfm_tpu_torch mapper` starts on it as a process right then and
    runs beside the paths that follow) -> a fresh FeaturePipeline.run
    resumes from it -> MapperController (one model per scene,
    snapshots) -> the models as .bin, .txt and .ply, read back -> the
    pose edges read back from the database -> run_matcher_on_database
    on ring pairs of a second database that holds features only. Held
    to the planted path's limits per model. Returns (the launch counts,
    the state the commands path and `finish_mapper` take); then holds
    K1 against its plain version at the database's K."""
    import os

    from dagsfm_tpu_torch.features import matching as fm
    from dagsfm_tpu_torch.ops import matcher_kernel as mk
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        FeaturePipeline, FeaturePipelineOptions, load_features_from_database,
        load_two_view_geometries_from_database, run_matcher_on_database)
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.scene import synthetic
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
    db = os.path.join(work, "database.db")
    with tempfile.TemporaryDirectory() as tmp:
        db2 = os.path.join(tmp, "features.db")
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
        mapper = _start_cli(["mapper", "--database_path", db,
                             "--output_path", os.path.join(work, "mapper")],
                            os.path.join(work, "mapper.log"))
        mapper.started = time.perf_counter()
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
        off, err = _db_model_errors(rec, scenes)
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
    return counts, {"work": work, "db": db, "mgr": mgr, "scenes": scenes,
                    "mapper": mapper}


def tools_path(dev, card: str) -> dict:
    """The ported tools/ programs in this process at their smoke sizes,
    through each one's `run`: e2e_1000 at TOOLS_E2E_IMAGES (at least two
    clusters; its own gates, K1 must launch), mapper_profile at
    TOOLS_MAPPER_IMAGES (90 % registered, reads counted) with
    multiproc_smoke (two processes, gloo) beside it, profile_two_view at
    TOOLS_PAIRS pairs, ba_phase_profile and prologue_probe at --smoke
    and scaling_curves at --smoke (D = 1, 2, 4, 8). Returns the launch
    counts of the phase."""
    from dagsfm_tpu_torch.tools import (ba_phase_profile, e2e_1000,
                                        mapper_profile, multiproc_smoke,
                                        profile_two_view, prologue_probe,
                                        scaling_curves)
    print(f"== tools path: the seven ported tools/ programs in process at "
          f"their smoke sizes (e2e_1000 at {TOOLS_E2E_IMAGES} images, "
          f"mapper_profile at {TOOLS_MAPPER_IMAGES})", flush=True)
    secs = {}
    _zero_counts()                                    # counts zeroed
    t0 = time.perf_counter()
    e2e = e2e_1000.run(TOOLS_E2E_IMAGES, device=dev, log=sys.stdout)
    secs["e2e_1000"] = time.perf_counter() - t0
    k1_e2e = _counts()["fused_matcher"]
    print(f"  e2e_1000 on {card}: {e2e['registered']}/{e2e['num_images']} "
          f"registered, ATE {e2e['ate']:.6f}, rotation error "
          f"{e2e['rot_err_deg_mean']:.6f} deg, separator RMSE "
          f"{e2e['separator_rmse_px']:.6f} px, {e2e['num_clusters']} "
          f"clusters {e2e['clustering']['sizes']}, {e2e['k1_launches']} K1 "
          f"launches, peak {e2e['peak_device_memory_gib']:.2f} GiB, stages "
          f"{ {k: round(v, 3) for k, v in e2e['stage_seconds'].items()} }",
          flush=True)
    if e2e["num_clusters"] < 2 or not e2e["k1_launches"] or not k1_e2e:
        raise AssertionError("tools path: e2e_1000 made fewer than two "
                             "clusters or launched no K1")

    # multiproc_smoke's two processes start while mapper_profile maps
    # (they hold the card for one all_reduce)
    multi = {}
    t0 = time.perf_counter()
    side = threading.Thread(target=lambda: multi.update(
        record=multiproc_smoke.run(device=dev)))
    side.start()
    mp = mapper_profile.run(TOOLS_MAPPER_IMAGES, device=dev,
                            log=io.StringIO())
    secs["mapper_profile"] = time.perf_counter() - t0
    print(f"  mapper_profile: {mp['registered']}/{mp['num_images']} in "
          f"{mp['mapping_seconds']:.3f} s ({mp['images_per_s']:.3f} "
          f"images/s), {mp['reads']['total']} device-to-host reads "
          f"({mp['reads']['per_registered_image']:.1f} per image; by kind "
          f"{mp['reads']['by_kind']}), top callers " + "; ".join(
              f"{c['count']} {c['kind']} {c['caller']}"
              for c in mp["reads"]["top_callers"][:5]), flush=True)
    if mp["registered"] < 0.9 * TOOLS_MAPPER_IMAGES or \
            not mp["reads"]["top_callers"]:
        raise AssertionError("tools path: mapper_profile out of limits")
    side.join()
    secs["multiproc_smoke, beside mapper_profile"] = \
        time.perf_counter() - t0
    ms = multi.get("record")
    if not ms or not ms["pass"]:
        raise AssertionError(f"tools path: multiproc_smoke failed {ms}")
    print(f"  multiproc_smoke: pass {ms['pass']} in {ms['elapsed_s']:.3f} "
          f"s, jobs by process {ms['jobs_by_host']}, all_reduce "
          f"{[r['all_reduce'] for r in ms['processes']]}", flush=True)

    t0 = time.perf_counter()
    tv = profile_two_view.run(TOOLS_PAIRS, device=dev, reps=1)
    secs["profile_two_view"] = time.perf_counter() - t0
    print("  profile_two_view (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in tv["ms"].items()), flush=True)

    t0 = time.perf_counter()
    bp = ba_phase_profile.run(smoke=True, device=dev)
    secs["ba_phase_profile"] = time.perf_counter() - t0
    print("  ba_phase_profile --smoke (ms; GB/s): " + ", ".join(
        f"{k} {v:.3f}" + (f" ({bp['roofline'][k]['achieved_gbps']:.1f})"
                          if k in bp["roofline"] else "")
        for k, v in bp["ms"].items()), flush=True)
    t0 = time.perf_counter()
    pp = prologue_probe.run(smoke=True, device=dev)
    secs["prologue_probe"] = time.perf_counter() - t0
    print(f"  prologue_probe --smoke: {len(pp['statements'])} statements, "
          f"{pp['sum_ms']:.3f} ms in all, the longest " + ", ".join(
              f"{s['statement']} {s['ms']:.3f}" for s in sorted(
                  pp["statements"], key=lambda s: -s["ms"])[:3]), flush=True)

    t0 = time.perf_counter()
    sc = scaling_curves.run(smoke=True, device=dev, log=io.StringIO())
    secs["scaling_curves"] = time.perf_counter() - t0
    for name, curve in sc["curves"].items():
        print(f"  scaling_curves {name}: " + "; ".join(
            "D={devices} ".format(**r) + ", ".join(
                f"{k} {v:.4f}" for k, v in r.items()
                if k.endswith("_s") and v) for r in curve), flush=True)
    counts = _counts()                                # counts read
    print(f"  seconds per tool: { {k: round(v, 3) for k, v in secs.items()} }"
          f"; launches {counts}", flush=True)
    return counts


def finish_mapper(card: str, state: dict) -> None:
    """Wait for the database path's `mapper` process: its models must
    equal the in-process MapperController's to the bit (both seed 0;
    snapshots change no model) and meet the database path's limits."""
    import os

    from dagsfm_tpu_torch.scene.reconstruction_manager import \
        ReconstructionManager
    p = state["mapper"]
    out = _finish_cli(p, 900, "mapper")
    wall = time.perf_counter() - p.started
    mgr = ReconstructionManager.read(os.path.join(state["work"], "mapper"))
    same = _same_models(mgr, state["mgr"])
    errs = [_db_model_errors(rec, state["scenes"])[1] for rec in mgr]
    print(f"== mapper process (started after the database path's write): "
          f"{wall:.3f} s wall on {card}; {len(mgr)} models, "
          f"{[e['num_reg'] for e in errs]} registered, ATE "
          f"{[round(e['ate'], 6) for e in errs]}, the in-process models "
          f"to the bit: {same}; its last line: "
          f"{out.strip().splitlines()[-1]}", flush=True)
    if not same:
        raise AssertionError("mapper process: models differ from the "
                             "in-process MapperController's")
    if len(mgr) != 2 or any(e["num_reg"] != DB_IMAGES or e["ate"] >= 0.05
                            or e["rot_err_deg_mean"] >= 0.2 for e in errs):
        raise AssertionError(f"mapper process: models out of limits {errs}")


def _db_model_errors(rec, scenes: dict) -> tuple:
    """(the scene offset, synthetic.pose_errors) of a database-path model
    against the scene its image ids come from."""
    from dagsfm_tpu_torch.scene import synthetic
    from dagsfm_tpu_torch.scene.reconstruction import Reconstruction
    off = DB_OFFSET if min(rec.reg_image_ids) > DB_OFFSET else 0
    view = Reconstruction()
    view.images = {i - off: im for i, im in rec.images.items()}
    return off, synthetic.pose_errors(view, scenes[off])


def _angle_deg(R1, R2) -> float:
    cos = (np.trace(np.asarray(R1).T @ np.asarray(R2)) - 1) / 2
    return math.degrees(math.acos(min(1.0, max(-1.0, cos))))


def pixel_path(dev, card: str, num_images: int, max_features: int,
               W: int = 1024, H: int = 768, distorted: bool = False):
    """Rendered pixels to a COLMAP model: returns (launch counts, the
    FeaturePipeline, the reconstruction, the rendered images, the
    synthetic scene). `distorted`: the images are rendered through a
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
    return counts, fp, rec, images, sc


def _round_trip_px(rec, und, dev) -> float:
    """Largest pixel distance between a keypoint of `rec` and its
    undistorted keypoint in `und` taken back through rec's camera: the
    undistorted pinhole ray projected with the original model."""
    from dagsfm_tpu_torch.scene import cameras as cm
    worst = 0.0
    for i, im in rec.images.items():
        cam = rec.cameras[im.camera_id]
        K = und.cameras[im.camera_id].calibration_matrix()
        uv = (und.images[i].xys - K[:2, 2]) / np.diag(K)[:2]
        back = cm.img_from_cam(cam.model_id, cm.pad_params(
            cam.params, cam.model_id).to(dev), torch.as_tensor(np.concatenate(
                [uv, np.ones((len(uv), 1))], 1), device=dev))
        worst = max(worst, float(torch.linalg.norm(back - torch.as_tensor(
            im.xys, device=dev), dim=1).max()))
    return worst


def _sphere_depth(K, R, t, center, radius, H: int, W: int, dev):
    """(H, W) camera-frame depth of the first ray-sphere hit of each pixel
    of the pinhole camera (K, R, t) and the cosine between the ray and the
    surface normal there (0 where the ray misses), float64 on `dev`."""
    T = (lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev))
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                            torch.arange(W, dtype=torch.float64, device=dev),
                            indexing="ij")
    d_cam = torch.stack([xs, ys, torch.ones_like(xs)], -1) @ T(
        np.linalg.inv(K)).T
    d = d_cam @ T(R)                                  # world directions
    oc = T(-R.T @ t - center)
    a = torch.sum(d * d, -1)
    b = 2.0 * (d @ oc)
    c = oc @ oc - radius ** 2
    disc = b * b - 4 * a * c
    lam = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a)
    hit = (disc > 0) & (lam > 0)
    nrm = (oc + lam[..., None] * d) / radius
    cos = -torch.sum(nrm * d, -1) / torch.sqrt(a)
    return torch.where(hit, lam, 0.0), torch.where(hit, cos, 0.0)


def _radius_errors(xyz: np.ndarray, sim: tuple, radius: float) -> np.ndarray:
    """|‖X‖ - r| / r of points moved into the truth's frame by the Sim(3)
    (s, R, t): the synthetic sphere is centred at the origin."""
    s, R, t = sim
    return np.abs(np.linalg.norm(s * xyz @ R.T + t, axis=1) - radius) / radius


def dense_path(dev, card: str, rec, images: dict, sc) -> dict:
    """Dense reconstruction of the distorted path's model and images: the
    undistorted model and images; `image_undistorter` in processes (COLMAP
    and PMVS), beside the in-process steps; `dense_reconstruct` at the
    default DenseOptions with every registered image as a reference view,
    its fusion voxel DENSE_VOXELS times smaller than the sparse points'
    median radius; `poisson_mesher` and `delaunay_mesher` in processes on
    the fused cloud, and Poisson twice in this process on it (bit for bit,
    and equal to poisson_mesher's file) and once on its points from pixels
    that see the sphere. Gated on the rendered sphere (the depth maps on
    the pixels that see it; the fused points from such pixels and the
    Poisson vertices of those points against its radius, after the Sim(3)
    of synthetic.pose_errors) and on peak device memory. Returns the
    launch counts (no kernel runs here)."""
    import os
    from dagsfm_tpu_torch.mvs import controller as mvs_ctl
    from dagsfm_tpu_torch.mvs import fusion
    from dagsfm_tpu_torch.mvs import io as mvs_io
    from dagsfm_tpu_torch.mvs import meshing
    from dagsfm_tpu_torch.mvs.poisson import poisson_mesh
    from dagsfm_tpu_torch.ops import rotations as rops
    from dagsfm_tpu_torch.scene import exporters
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.scene import synthetic
    from dagsfm_tpu_torch.scene.undistortion import (undistort_image,
                                                     undistort_reconstruction)

    reg = rec.reg_image_ids
    H, W = next(iter(images.values())).shape
    radius = sc.spec.point_cloud_extent      # render_images' sphere
    opts0 = mvs_ctl.DenseOptions()
    print(f"== dense path: the distorted path's model, {len(reg)} registered "
          f"images of {W} x {H}, DenseOptions() ({opts0.patch_match.num_depths}"
          f" depths, window radius {opts0.patch_match.window_radius}, "
          f"{opts0.patch_match.num_iterations} iterations, top-"
          f"{opts0.patch_match.top_k} of {opts0.max_src_images} sources), "
          "every registered image a reference view", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()                                    # counts zeroed
    secs = {}

    def step(name, t0):
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "sparse")
        os.makedirs(model)
        scene_io.write_model_bin(rec, model)
        t_cli = time.perf_counter()
        procs = {kind: _start_cli(
            ["image_undistorter", "--input_path", model, "--output_path",
             os.path.join(tmp, kind), "--output_type", kind],
            os.path.join(tmp, f"{kind}.log")) for kind in ("COLMAP", "PMVS")}

        t0 = time.perf_counter()
        und = undistort_reconstruction(rec, device=dev)
        und_images = {i: undistort_image(
            images[i], rec.cameras[rec.images[i].camera_id],
            und.cameras[rec.images[i].camera_id], device=dev) for i in reg}
        step("undistortion", t0)
        # the undistorted pixels that sample inside the source image
        covered = {cid: undistort_image(np.ones((H, W), np.float32), cam,
                                        und.cameras[cid], device=dev) > 0.999
                   for cid, cam in rec.cameras.items()}
        trip = _round_trip_px(rec, und, dev)
        print(f"  on {card}: undistortion of the model and {len(reg)} images "
              f"{secs['undistortion']:.3f} s; undistorted keypoints back "
              f"through {next(iter(rec.cameras.values())).model_name}: at "
              f"most {trip:.3e} px from the originals", flush=True)
        if not trip < 1e-6:
            raise AssertionError(f"dense path: undistorted keypoints {trip} "
                                 "px off the originals")

        pts = np.stack([p.xyz for p in und.points3D.values()])
        voxel = float(np.median(np.linalg.norm(pts - pts.mean(0), axis=1))
                      / DENSE_VOXELS)
        opts = opts0._replace(fusion=fusion.FusionOptions(voxel_size=voxel))
        ws = os.path.join(tmp, "dense")
        fuse_secs = []
        fuse = fusion.fuse

        def timed_fuse(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fuse(*a, **k)
            fuse_secs.append(time.perf_counter() - t)
            return out
        fusion.fuse = timed_fuse
        try:
            t0 = time.perf_counter()
            fused = mvs_ctl.dense_reconstruct(und, und_images, ws, opts,
                                              seed=0, device=dev)
            step("dense_reconstruct", t0)
        finally:
            fusion.fuse = fuse
        secs["fusion"] = fuse_secs[0]
        maps_s = secs["dense_reconstruct"] - secs["fusion"]
        n_pts = len(fused["xyz"])
        print(f"  on {card}: dense_reconstruct {secs['dense_reconstruct']:.3f}"
              f" s: depth and normal maps {maps_s:.3f} s ({len(reg) / maps_s:.3f}"
              f" views/s), fusion {secs['fusion']:.3f} s ({len(reg)} x "
              f"{len(reg) - 1} consistency checks); voxel_size {voxel:.6f} "
              f"-> {n_pts} fused points", flush=True)
        if not DENSE_POINTS[0] <= n_pts <= DENSE_POINTS[1]:
            raise AssertionError(f"dense path: {n_pts} fused points")

        for kind, p in procs.items():
            print("  " + _finish_cli(p, 600, f"image_undistorter {kind}")
                  .strip().splitlines()[-1], flush=True)
        secs["image_undistorter"] = time.perf_counter() - t_cli
        back = scene_io.read_model_bin(os.path.join(tmp, "COLMAP", "sparse"))
        if back.cameras != und.cameras or any(
                not np.array_equal(back.images[i].xys, und.images[i].xys)
                for i in und.images):
            raise AssertionError("image_undistorter's COLMAP model differs "
                                 "from undistort_reconstruction's")
        exporters.write_pmvs_workspace(und, os.path.join(tmp, "pmvs_ref"))
        for f in ["vis.dat", "option-all"] + [
                os.path.join("txt", f"{k:08d}.txt") for k in range(len(reg))]:
            with open(os.path.join(tmp, "PMVS", f), "rb") as a, \
                    open(os.path.join(tmp, "pmvs_ref", f), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"image_undistorter PMVS: {f}")
        print(f"  on {card}: image_undistorter COLMAP and PMVS, two "
              f"processes started before the undistortion, "
              f"{secs['image_undistorter']:.3f} s wall; the sparse model and "
              "the PMVS files equal this process's", flush=True)

        ply = os.path.join(ws, "fused.ply")
        t_mesh = time.perf_counter()
        procs = {name: _start_cli(
            [name, "--input_path", ply, "--output_path",
             os.path.join(tmp, f"{name}.ply")], os.path.join(tmp, name + ".log"))
            for name in ("poisson_mesher", "delaunay_mesher")}

        # the gates: depth maps on the pixels that see the sphere
        sim = synthetic.align_to_truth(und, sc)
        s_, R_, t_ = sim
        center = R_.T @ (-t_) / s_
        rel = []
        for i in reg:
            im = und.images[i]
            K = und.cameras[im.camera_id].calibration_matrix()
            truth, cos = _sphere_depth(K, rops.quat_to_rotmat_np(im.qvec),
                                       im.tvec, center, radius / s_, H, W,
                                       dev)
            depth = torch.as_tensor(mvs_io.read_map_bin(mvs_io.depth_map_path(
                ws, im.name)), dtype=torch.float64, device=dev)
            sel = (cos > DENSE_MIN_COS) & torch.as_tensor(
                covered[im.camera_id], device=dev)
            rel.append((torch.abs(depth - truth) / truth)[sel])
        rel = torch.cat(rel).cpu().numpy()
        # fused points from pixels that see the sphere: the renderer paints
        # every other pixel DENSE_BACKGROUND, the undistortion fills what
        # the source image does not cover with 0 (the bilinear warp keeps
        # a flat region's value to within an ulp or two)
        col = fused["color"]
        seen = (np.abs(col - DENSE_BACKGROUND) > 1e-6) & (col > 1e-6)
        pts_rel = _radius_errors(fused["xyz"], sim, radius)
        gates = {
            "depth: median relative error": (np.median(rel), DENSE_DEPTH_MEDIAN),
            f"depth: share within {DENSE_DEPTH_TOL}": (
                np.mean(rel < DENSE_DEPTH_TOL), DENSE_DEPTH_SHARE),
            "fused points of the sphere: median |r - R| / R": (
                np.median(pts_rel[seen]), DENSE_POINTS_MEDIAN),
            f"fused points of the sphere: share within {DENSE_POINTS_TOL}": (
                np.mean(pts_rel[seen] < DENSE_POINTS_TOL), DENSE_POINTS_SHARE)}

        xyz, nrm = mvs_io.read_ply_points(ply)
        meshes = []
        for _ in range(2):
            t0 = time.perf_counter()
            meshes.append(poisson_mesh(xyz, nrm, device=dev))
            step("poisson_mesh", t0)
        (v1, f1), (v2, f2) = meshes
        if not (np.array_equal(v1, v2) and np.array_equal(f1, f2)):
            raise AssertionError("dense path: two Poisson meshes of one "
                                 "cloud differ")
        v_seen, _ = poisson_mesh(xyz[seen], nrm[seen], device=dev)
        for name, p in procs.items():
            print("  " + _finish_cli(p, 600, name).strip().splitlines()[-1],
                  flush=True)
        secs["meshers"] = time.perf_counter() - t_mesh
        meshing.write_ply_mesh(os.path.join(tmp, "poisson_ref.ply"), v1, f1)
        with open(os.path.join(tmp, "poisson_mesher.ply"), "rb") as a, \
                open(os.path.join(tmp, "poisson_ref.ply"), "rb") as b:
            if a.read() != b.read():
                raise AssertionError("dense path: poisson_mesher's mesh "
                                     "differs from this process's")
        with open(os.path.join(tmp, "delaunay_mesher.ply"), "rb") as f:
            head = f.read(400).split(b"end_header")[0].decode()
        n_tris = int(head.split("element face ")[1].split()[0])
        if f"element vertex {n_pts}\n" not in head:
            raise AssertionError(f"delaunay_mesher's mesh: {head}")
    v_rel = _radius_errors(v_seen, sim, radius)
    gates["Poisson vertices of the sphere's points: median |r - R| / R"] = (
        np.median(v_rel), DENSE_POISSON_MEDIAN)
    gates["Poisson vertices of the sphere's points: share within "
          f"{DENSE_POISSON_TOL}"] = (np.mean(v_rel < DENSE_POISSON_TOL),
                                     DENSE_POISSON_SHARE)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gates["peak device memory, GiB"] = (peak, DENSE_PEAK_GIB)
    counts = _counts()                                # counts read
    all_rel = _radius_errors(v1, sim, radius)
    print(f"  on {card}: meshers (poisson_mesher and delaunay_mesher, two "
          f"processes started after the fusion) {secs['meshers']:.3f} s "
          f"wall; Poisson in this process {secs['poisson_mesh']:.3f} s (the "
          f"second of two runs), {len(v1)} vertices, {len(f1)} triangles, "
          "equal bit for bit over two runs and to poisson_mesher's file; "
          f"Delaunay {n_tris} triangles on {n_pts} points", flush=True)
    print(f"  fused points from background pixels {np.mean(~seen):.4f} of "
          f"{n_pts}; over all fused points |r - R| / R median "
          f"{np.median(pts_rel):.6f}, share within {DENSE_POINTS_TOL} "
          f"{np.mean(pts_rel < DENSE_POINTS_TOL):.6f}; over the vertices of "
          f"the whole cloud's Poisson mesh median {np.median(all_rel):.6f}, "
          f"share within {DENSE_POISSON_TOL} "
          f"{np.mean(all_rel < DENSE_POISSON_TOL):.6f}", flush=True)
    failed = []
    for name, (value, limit) in gates.items():
        share = "share" in name
        ok = value >= limit if share else value < limit
        print(f"  gate {name}: {value:.6f} ({'>=' if share else '<'} "
              f"{limit}) {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            failed.append(name)
    print(f"  on {card}: dense path {time.perf_counter() - t_cli:.3f} s "
          "(steps " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"); kernel launches {counts}", flush=True)
    if failed:
        raise AssertionError(f"dense path: gates failed {failed}")
    return counts

def ba_path(dev, card: str, num_cameras: int = 1000,
            num_points: int = 50000) -> dict:
    """Bundle adjustment in the reference's ITERATIVE_SCHUR regime at
    bench_suite.py's size: first intrinsics refinement (PCG on the joint
    system) from a SIMPLE_RADIAL camera with focal +10 % and k1 = 0.05,
    held to tests/test_bundle_adjustment.py's
    test_recovers_focal_and_k1_iterative limits; then 5 LM iterations
    of the plain pinhole solve on the same scene, timed as bench_suite
    times them. Returns the launch counts and (the pinhole scene, the
    plain solve's LM iterations per second)."""
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
    pinhole = base._replace(cam_model_id=torch.full_like(
        base.cam_model_id, cameras.SIMPLE_PINHOLE))
    del base
    prob = ba.make_problem(pinhole, max_track_len=20, const_image=const)
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
    return _counts(), (pinhole, iters / secs)         # counts read


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_STARTED: list = []      # every CLI process, stopped when main() ends


def _start_cli(args: list, log: str):
    """`python -m dagsfm_tpu_torch <args>` from the checkout's root, its
    output to the file `log`."""
    import os
    import subprocess
    f = open(log, "w")
    p = subprocess.Popen([sys.executable, "-m", "dagsfm_tpu_torch", *args],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         stdout=f, stderr=subprocess.STDOUT,
                         env=dict(os.environ, PYTHONUNBUFFERED="1"))
    p.log_file = f
    _STARTED.append(p)
    return p


def _finish_cli(p, timeout: float, what: str) -> str:
    """Wait for a CLI process (killed past `timeout`); its output, or an
    AssertionError if it failed."""
    import subprocess
    try:
        p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
    p.log_file.close()
    with open(p.log_file.name) as f:
        out = f.read()
    if p.returncode != 0:
        raise AssertionError(f"{what} exited {p.returncode}:\n{out[-3000:]}")
    return out


def _pose_gap(a, b):
    """(the same registered images with the same poses, to the bit; the
    largest rotation gap in degrees and translation gap over the images
    both registered)."""
    from dagsfm_tpu_torch.ops import rotations as rops
    common = sorted(set(a.reg_image_ids) & set(b.reg_image_ids))
    same = sorted(a.reg_image_ids) == sorted(b.reg_image_ids) and all(
        np.array_equal(a.images[i].qvec, b.images[i].qvec)
        and np.array_equal(a.images[i].tvec, b.images[i].tvec)
        for i in common)
    deg = max((_angle_deg(rops.quat_to_rotmat_np(a.images[i].qvec),
                          rops.quat_to_rotmat_np(b.images[i].qvec))
               for i in common), default=0.0)
    dt = max((float(np.abs(a.images[i].tvec - b.images[i].tvec).max())
              for i in common), default=0.0)
    return same, deg, dt


def _rank_solve(rank: int, world: int, coordinator: str, device: str,
                arrays: dict, D: int, opts: dict, q) -> None:
    """One rank of the sharded BA on `device`, over gloo: puts (rank,
    "ok", (qvec, tvec, points, costs)) or (rank, "error", message) on
    q."""
    import torch.distributed as tdist
    try:
        from dagsfm_tpu_torch.parallel import ba_sharded
        from dagsfm_tpu_torch.parallel.distributed import init_multihost
        from dagsfm_tpu_torch.scene.reconstruction import \
            scene_arrays_from_numpy
        from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
        init_multihost(coordinator, world, rank, device=device,
                       backend="gloo")
        dev = torch.device(device)
        prob, pts = ba_sharded.shard_problem(
            scene_arrays_from_numpy(arrays, dev), D, device=dev)
        out, st = ba_sharded.solve_sharded(prob, ba.BAOptions(**opts))
        q.put((rank, "ok", (out.image_qvec.cpu().numpy(),
                            out.image_tvec.cpu().numpy(),
                            ba_sharded.gather_points(
                                out, pts, arrays["points_xyz"].shape[0]),
                            np.array([st.initial_cost, st.final_cost]))))
    except Exception as exc:  # noqa: BLE001 — reported to the parent
        q.put((rank, "error", f"{type(exc).__name__}: {exc}"))
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def _two_ranks(dev, arrays: dict, D: int, opts: dict,
               timeout: float = 180.0):
    """The sharded solve on two spawned ranks of one card: (results by
    rank, or None; the first error message)."""
    import queue

    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    q = ctx.Queue()
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_solve, args=(
        r, 2, coordinator, str(dev), arrays, D, opts, q))
        for r in range(2)]
    for p in procs:
        p.start()
    got, error = {}, None
    deadline = time.perf_counter() + timeout
    while len(got) < 2 and error is None:
        try:
            r, status, val = q.get(timeout=max(
                1.0, deadline - time.perf_counter()))
        except queue.Empty:
            error = f"no result within {timeout:.0f} s"
            break
        if status == "ok":
            got[r] = val
        else:
            error = val
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.terminate()
            p.join()
    return (got if error is None else None), error


def _rel_err(got: tuple, ref: tuple) -> float:
    return max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
               for a, b in zip(got, ref))


def parallel_path(dev, card: str, dist_state: dict, ba_state) -> dict:
    """The parallel layer on the card, in one process group (NCCL, one
    rank): the mapping jobs (`_mapping_jobs`), the matching jobs
    (`_matching_jobs`) and the sharded solves (`_sharded_solves`).
    Returns the launch counts."""
    import torch.distributed as tdist

    from dagsfm_tpu_torch.parallel.distributed import init_multihost

    clusters = dist_state["ctrl"].clusters
    print(f"== parallel path: {len(clusters)} mapping jobs of the "
          f"distributed path ({[len(c.image_ids) for c in clusters]} "
          f"images) in two worker processes; {PAR_IMAGES} rendered "
          f"{PAR_W} x {PAR_H} images in two matching jobs; sharded solves",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()                                    # counts zeroed
    world = init_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                           device=dev)[1]
    secs = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            _mapping_jobs(dev, card, dist_state, tmp, world, secs)
            _matching_jobs(dev, card, tmp, secs)
        _sharded_solves(dev, card, dist_state["ctrl"], ba_state, world, secs)
        counts = _counts()                            # counts read
    finally:
        tdist.destroy_process_group()
    print(f"  parallel path on {card}: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
          + f"; K1 launches {counts['fused_matcher']}; peak device memory "
          f"(this process) "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    return counts


def _mapping_jobs(dev, card: str, dist_state: dict, tmp: str, world: int,
                  secs: dict) -> None:
    """DAGSfM's master and workers on the distributed path's clusters: its
    features and matches in a database, clusters.json, two `python -m
    dagsfm_tpu_torch local_sfm_worker` processes on the one card, then a
    fresh controller that resumes from their partitions and runs the
    sharded final BA (one rank, one shard), held to the distributed
    path's gates."""
    import json
    import os

    import torch.distributed as tdist

    from dagsfm_tpu_torch.pipeline.distributed_mapper import (
        DistributedMapperController, DistributedMapperOptions)
    from dagsfm_tpu_torch.pipeline.feature_pipeline import FeaturePipeline
    from dagsfm_tpu_torch.scene import io as scene_io

    fp, ctrl, sc = dist_state["fp"], dist_state["ctrl"], dist_state["scene"]
    clusters = ctrl.clusters
    wd, db = os.path.join(tmp, "work"), os.path.join(tmp, "database.db")
    t0 = time.perf_counter()
    fp.write_database(db)
    ctrl.export_cluster_jobs(wd)
    secs["master: database and jobs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    workers = [_start_cli(["local_sfm_worker", "--database_path", db,
                           "--work_dir", wd, "--host_id", str(h)],
                          os.path.join(tmp, f"worker{h}.log"))
               for h in (0, 1)]
    outs, worker_secs = [], []
    try:
        for h, p in enumerate(workers):
            outs.append(_finish_cli(p, 900, f"local_sfm_worker {h}"))
            worker_secs.append(time.perf_counter() - t0)
    finally:
        _stop(workers)
    secs["workers"] = max(worker_secs)
    done = []
    for out in outs:
        line = [ln for ln in out.splitlines()
                if "completed clusters" in ln][-1]
        done.append(set(json.loads(line.split("completed clusters")[1])))
        peak = [ln for ln in out.splitlines() if "peak" in ln]
        print(f"  {line}; {peak}", flush=True)
    leftovers = [d for d in os.listdir(wd) if ".tmp." in d]
    parts = [scene_io.read_model_bin(os.path.join(wd, f"partition{k}"))
             for k in range(len(clusters))]
    order = sorted(range(len(clusters)),
                   key=lambda c: -len(clusters[c].image_ids))
    in_process = [ctrl.local_reg_images[order.index(k)]
                  for k in range(len(clusters))]
    gaps = [_pose_gap(parts[k], dist_state["local"][order.index(k)])
            for k in range(len(clusters))]
    print(f"  workers on {card}: wall {secs['workers']:.3f} s (each "
          f"{[round(x, 3) for x in worker_secs]}; the in-process "
          f"reconstruction stage {ctrl.timings['reconstruction']:.3f} s); "
          f"completed {[sorted(d) for d in done]}; registered per partition "
          f"{[p.num_reg_images() for p in parts]} (in process {in_process});"
          f" against the in-process models (poses to the bit, largest "
          f"rotation gap deg, largest translation gap): {gaps}", flush=True)
    if done[0] & done[1] or done[0] | done[1] != set(range(len(clusters))) \
            or leftovers \
            or [p.num_reg_images() for p in parts] != in_process:
        raise AssertionError(f"parallel path: mapping jobs {done}, "
                             f"leftovers {leftovers}")
    # the master: a fresh controller resumes from the partitions
    t0 = time.perf_counter()
    cams, images, graph = FeaturePipeline(
        {}, {}, device=dev).load_from_database(db)
    master = DistributedMapperController(
        cams, images, graph, DistributedMapperOptions(
            distributed_final_ba=True), device=dev)
    merged = master.run(checkpoint_path=wd)
    torch.cuda.synchronize()
    secs["master: merge and sharded final BA"] = time.perf_counter() - t0
    _write_and_gate(merged, sc, DIST_IMAGES, 0.05, 0.3,
                    min_reg=math.ceil(DIST_IMAGES * 22 / 24))
    rmse = master.separator_rmse(merged)
    st = master.ba_stats
    print(f"  master on {card}: world size {world}, backend "
          f"{tdist.get_backend()}, shards 1; stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in master.timings.items())
          + f"; sharded final BA {st.num_iterations} LM iterations, cost "
          f"{st.initial_cost:.6g} -> {st.final_cost:.6g}; separator RMSE "
          f"{rmse:.6f} px", flush=True)
    if not (rmse < 2.0 and len(master.separators) >= 2):
        raise AssertionError("parallel path: master out of limits")


def _matching_jobs(dev, card: str, tmp: str, secs: dict) -> None:
    """A rendered ring's candidate pairs cut into two matching jobs: the
    first run in this process through run_matching_worker (its K1
    launches counted), the second in a `local_matching_worker` process;
    the job databases merged and mapped by MapperController."""
    import json
    import os

    from dagsfm_tpu_torch.features import sift
    from dagsfm_tpu_torch.parallel.distributed import (
        make_matching_jobs, merge_matching_databases, run_matching_worker)
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        FeaturePipeline, FeaturePipelineOptions)
    from dagsfm_tpu_torch.scene import cameras
    from dagsfm_tpu_torch.scene import synthetic
    from dagsfm_tpu_torch.sfm.mapper_controller import (ControllerOptions,
                                                        MapperController)

    sc = synthetic.generate(synthetic.SyntheticSceneSpec(
        num_cameras=PAR_IMAGES, num_points=40, image_width=PAR_W,
        image_height=PAR_H, focal=PAR_FOCAL, seed=5, ring_radius=9.0,
        point_cloud_extent=3.5))
    t0 = time.perf_counter()
    images = synthetic.render_images(sc, device=dev)
    ids = sorted(images)
    pairs = sorted({(min(ids[a], ids[(a + d) % len(ids)]),
                     max(ids[a], ids[(a + d) % len(ids)]))
                    for a in range(len(ids)) for d in range(1, PAR_RING + 1)})
    jobs = make_matching_jobs([(i, j, 1.0) for (i, j) in pairs], 2,
                              device=dev)
    wd, img_dir = os.path.join(tmp, "match"), os.path.join(tmp, "images")
    os.makedirs(wd)
    os.makedirs(img_dir)
    for i, im in images.items():
        np.save(os.path.join(img_dir, f"image{i}.npy"), im)
    with open(os.path.join(wd, "matching_jobs.json"), "w") as f:
        json.dump(jobs, f)
    secs["matching: set-up"] = time.perf_counter() - t0
    covered = sorted(tuple(p) for j in jobs for p in j["pairs"])
    t0 = time.perf_counter()
    worker = _start_cli(
        ["local_matching_worker", "--image_path", img_dir, "--work_dir", wd,
         "--host_id", "1", "--focal", str(PAR_FOCAL), "--max_num_features",
         str(PAR_FEATURES), "--guided_matching"],
        os.path.join(tmp, "match1.log"))
    try:
        # local_matching_worker's options, in this process
        opts = FeaturePipelineOptions(batch_size=4, guided_matching=True)
        opts.sift = sift.SiftOptions(max_num_features=PAR_FEATURES,
                                     candidates_per_octave=min(
                                         512, PAR_FEATURES), num_octaves=3)
        cams = {i: cameras.make_simple_camera(i, PAR_W, PAR_H,
                                              focal=PAR_FOCAL) for i in ids}
        k1_before = _counts()["fused_matcher"]
        mine = run_matching_worker(images, cams, jobs[:1], wd, host_id=0,
                                   pipeline_options=opts, device=dev)
        torch.cuda.synchronize()
        k1_job = _counts()["fused_matcher"] - k1_before
        secs["matching: in-process job"] = time.perf_counter() - t0
        out = _finish_cli(worker, 600, "local_matching_worker 1")
    finally:
        _stop([worker])
    secs["matching: both jobs"] = time.perf_counter() - t0
    line = [ln for ln in out.splitlines() if "completed jobs" in ln][-1]
    theirs = json.loads(line.split("completed jobs")[1])
    t0 = time.perf_counter()
    merged_db = os.path.join(tmp, "merged.db")
    n_tvg = merge_matching_databases(wd, [j["job_id"] for j in jobs],
                                     merged_db)
    mcams, mimages, mgraph = FeaturePipeline(
        {}, {}, device=dev).load_from_database(merged_db)
    mgr = MapperController(mcams, mimages, mgraph, ControllerOptions(),
                           device=dev).run()
    torch.cuda.synchronize()
    secs["matching: merge and map"] = time.perf_counter() - t0
    best = max(mgr, key=lambda r: r.num_reg_images())
    err = synthetic.pose_errors(best, sc)
    print(f"  matching jobs on {card}: {len(pairs)} ring pairs (width "
          f"{PAR_RING}) in jobs of {[len(j['pairs']) for j in jobs]} pairs; "
          f"in process {mine} ({k1_job} K1 launches), {line}; "
          f"{[ln for ln in out.splitlines() if 'peak' in ln]} (its K1 "
          f"launches are not counted here); merged {len(mimages)} images, "
          f"{n_tvg} two-view geometries; {len(mgr)} model(s), registered "
          f"{err['num_reg']}/{PAR_IMAGES}, ATE {err['ate']:.6f}, rotation "
          f"error mean {err['rot_err_deg_mean']:.6f} deg", flush=True)
    if covered != pairs or len(mimages) != PAR_IMAGES \
            or mine != [jobs[0]["job_id"]] \
            or theirs != [j["job_id"] for j in jobs[1:]] \
            or k1_job != math.ceil(len(jobs[0]["pairs"]) / MATCH_BATCH) \
            or err["num_reg"] != PAR_IMAGES or err["ate"] >= 0.1:
        raise AssertionError("parallel path: matching jobs out of limits")


def _sharded_solves(dev, card: str, ctrl, ba_state, world: int,
                    secs: dict) -> None:
    """solve_sharded on the BA path's problem (1M observations, one
    shard), D = 8 against D = 1 and two spawned ranks on the card at 12
    cameras (rel 1e-9), and estimate_rotations_sharded on the distributed
    path's final edges against estimate_rotations (0.05 deg)."""
    from dagsfm_tpu_torch.estimation import rotation_averaging as ra
    from dagsfm_tpu_torch.parallel import ba_sharded
    from dagsfm_tpu_torch.scene import synthetic
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba

    pinhole, plain_its = ba_state
    const = np.zeros(pinhole.image_qvec.shape[0], bool)
    const[:2] = True
    t0 = time.perf_counter()
    prob, _ = ba_sharded.shard_problem(pinhole, 1, max_track_len=20,
                                       const_image=const, device=dev)
    torch.cuda.synchronize()
    t_shard = time.perf_counter() - t0
    iters = 5
    t0 = time.perf_counter()
    _, st = ba_sharded.solve_sharded(prob, ba.BAOptions(
        max_iterations=iters, solver="iterative"))
    torch.cuda.synchronize()
    secs["sharded BA, 1M observations"] = t_solve = time.perf_counter() - t0
    n_obs = int(prob.obs_mask.sum())
    del prob
    print(f"  sharded BA on {card}: {n_obs} observations kept (uniform "
          f"decimation, T = 20), shard_problem {t_shard:.3f} s; {iters} LM "
          f"iterations in {t_solve:.3f} s, {iters / t_solve:.3f} LM "
          f"iterations/s (the plain PCG: {plain_its:.3f}), "
          f"{st.cg_iterations / iters:.1f} CG iterations per LM step; cost "
          f"{st.initial_cost:.6g} -> {st.final_cost:.6g}", flush=True)
    if not st.final_cost < 0.2 * st.initial_cost:
        raise AssertionError("parallel path: the sharded BA did not descend")

    small = synthetic.to_scene_arrays(synthetic.generate(
        synthetic.SyntheticSceneSpec(num_cameras=12, num_points=250,
                                     pixel_noise=0.5, seed=3)), "cpu")
    rng = np.random.default_rng(4)
    small = small._replace(points_xyz=small.points_xyz + torch.as_tensor(
        rng.normal(0, 0.05, tuple(small.points_xyz.shape))))
    host = {k: v.numpy() for k, v in small._asdict().items()}
    sopts = dict(max_iterations=5, solver="iterative")
    t0 = time.perf_counter()
    runs = {}
    for D in (1, 8):
        p_, pts = ba_sharded.shard_problem(small, D, device=dev)
        o_, s_ = ba_sharded.solve_sharded(p_, ba.BAOptions(**sopts))
        runs[D] = (o_.image_qvec.cpu().numpy(), o_.image_tvec.cpu().numpy(),
                   ba_sharded.gather_points(o_, pts, len(host["points_xyz"])),
                   np.array([s_.initial_cost, s_.final_cost]))
    rel8 = _rel_err(runs[8], runs[1])
    # NCCL refuses two ranks on one GPU ("invalid usage" at the first
    # collective), so the two ranks on the one card name gloo, which takes
    # CUDA tensors
    print("  two ranks on one card: backend gloo on CUDA tensors (NCCL "
          "refuses two ranks on one GPU)", flush=True)
    two, error = _two_ranks(dev, host, 8, sopts)
    if two is None:
        raise AssertionError(f"parallel path: two gloo ranks: {error}")
    rel2 = max(_rel_err(two[r], runs[1]) for r in (0, 1))
    secs["sharded BA, 12 cameras, D = 1, 8 and two ranks"] = \
        time.perf_counter() - t0
    print(f"  sharded BA at 12 cameras on {card}: D = 8 on one rank against "
          f"D = 1: largest relative difference {rel8:.3g}; two ranks "
          f"(backend gloo, D = 8): {rel2:.3g}; cost "
          f"{runs[1][3][0]:.6g} -> {runs[1][3][1]:.6g}", flush=True)
    if not (rel8 < 1e-9 and rel2 < 1e-9):
        raise AssertionError("parallel path: sharded solves disagree")

    vg = ctrl.view_graph
    vids = sorted(vg.nodes)
    index = {v: k for k, v in enumerate(vids)}
    edges = np.array([(index[i], index[j]) for (i, j) in vg.edges])
    rels = np.stack([e.rotation for e in vg.edges.values()])
    t0 = time.perf_counter()
    R1 = ra.estimate_rotations(len(vids), edges, rels, device=dev)
    t_ra1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    R2 = ra.estimate_rotations_sharded(len(vids), edges, rels, device=dev)
    secs["sharded rotation averaging"] = t_ra2 = time.perf_counter() - t0
    gap = max(_angle_deg(a, b) for a, b in zip(R1, R2))
    print(f"  rotation averaging on {card}: {len(vids)} images, {len(edges)} "
          f"edges; sharded (world size {world}, 1 shard) {t_ra2:.3f} s, "
          f"one process {t_ra1:.3f} s; largest gap {gap:.3g} deg", flush=True)
    if gap >= 0.05:
        raise AssertionError("parallel path: sharded rotation averaging")


def _stop(procs) -> None:
    """Kill what is still running of `procs` (after a failure)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        p.log_file.close()


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


def scale_inputs(dev, n: int = SCALE_IMAGES):
    """tests/test_e2e_scale.py's scene and options: n ring cameras of 256 x
    192 (focal 280, seed 12), rendered on `dev`; SIFT at 512 features;
    sequential pairs (overlap 4) with BoW loop detection every 10 images
    (6 per query); essential-only verification with 128 hypotheses; the
    distributed mapper in clusters of at most 30 images. Returns (scene,
    images, cameras, FeaturePipelineOptions, DistributedMapperOptions)."""
    from dagsfm_tpu_torch.clustering.image_clustering import \
        ClusteringOptions
    from dagsfm_tpu_torch.features import sift
    from dagsfm_tpu_torch.pipeline.distributed_mapper import \
        DistributedMapperOptions
    from dagsfm_tpu_torch.pipeline.feature_pipeline import \
        FeaturePipelineOptions
    from dagsfm_tpu_torch.scene import cameras, synthetic
    from dagsfm_tpu_torch.sfm.incremental_mapper import MapperOptions

    spec = synthetic.SyntheticSceneSpec(
        num_cameras=n, num_points=60, image_width=256, image_height=192,
        focal=280.0, seed=12, ring_radius=10.0, point_cloud_extent=4.0,
        ring_height_jitter=0.2)
    sc = synthetic.generate(spec)
    images = synthetic.render_images(sc, device=dev)
    cams = {i: cameras.make_simple_camera(i, 256, 192, focal=280.0)
            for i in images}
    opts = FeaturePipelineOptions(
        pair_mode="sequential", sequential_overlap=4,
        loop_detection_period=10, loop_detection_num_images=6,
        num_ransac_hypotheses=128, two_view_essential_only=True,
        batch_size=4)
    opts.sift = sift.SiftOptions(max_num_features=512,
                                 candidates_per_octave=512, num_octaves=3)
    dm_opts = DistributedMapperOptions(
        clustering=ClusteringOptions(num_images_ub=30, image_overlap=10,
                                     completeness_ratio=0.5),
        mapper=MapperOptions(seed=0, init_min_tri_angle_deg=2.0))
    return sc, images, cams, opts, dm_opts


def _check_pairs(name: str, pairs: list, ordered: bool) -> None:
    """i < j, no duplicate, and sorted where the mode sorts its list."""
    if any(i >= j for i, j in pairs) or len(set(pairs)) != len(pairs) or \
            (ordered and pairs != sorted(pairs)):
        raise AssertionError(f"{name}: malformed pair list")


def pair_modes_step(fp, dev, card: str) -> dict:
    """The retrieval path's step (b): every pair mode on a pixel path's
    features (the distorted path's: all its images, up to 3,712 slots
    each), through FeaturePipeline.select_pairs with MODE_NEIGHBORS
    neighbours per image (COLMAP's sequential overlap; the default 50
    would select most of 80 images' pairs); each list's candidates,
    seconds and recall of that path's verified pairs, which must beat
    chance (candidates / all pairs). Then the Gabor fallback of `global`
    on the same images (a pipeline without features). Returns the
    launch counts (select_pairs launches no kernel) and a summary."""
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        FeaturePipeline, FeaturePipelineOptions)

    ids = sorted(fp.images)
    total = len(ids) * (len(ids) - 1) // 2
    verified = set(fp.two_view)
    K = max(len(m) for m in fp.masks.values())
    print(f"== retrieval path (b): every pair mode on the distorted path's "
          f"{len(ids)} images (K = {K} slots; {len(verified)} of {total} "
          "pairs verified there)", flush=True)
    modes = [
        ("sequential (overlap 10, loop detection every 10)",
         dict(pair_mode="sequential", sequential_overlap=10,
              loop_detection_period=10), False),
        ("retrieval (BoW)", dict(pair_mode="retrieval"), False),
        ("vocab_tree", dict(pair_mode="vocab_tree"), True),
        ("vocab_tree, rerank 20 + spatial verification",
         dict(pair_mode="vocab_tree", vocab_tree_rerank=20,
              spatial_verification=True), True),
        ("global (VLAD)", dict(pair_mode="global"), True),
    ]
    saved = fp.opts
    nn = saved.retrieval._replace(num_neighbors=MODE_NEIGHBORS)
    out = {}
    torch.cuda.synchronize()
    _zero_counts()                                    # counts zeroed
    for name, kw, ordered in modes + [("global, Gabor fallback",
                                       None, True)]:
        t0 = time.perf_counter()
        if kw is None:
            pairs = FeaturePipeline(
                fp.images, fp.cameras, FeaturePipelineOptions(
                    pair_mode="global", retrieval=nn),
                device=dev).select_pairs()
        else:
            fp.opts = dataclasses.replace(saved, retrieval=nn, **kw)
            pairs = fp.select_pairs()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _check_pairs(name, pairs, ordered)
        recall = len(verified & set(pairs)) / max(len(verified), 1)
        chance = len(pairs) / total
        out[name] = {"candidates": len(pairs), "seconds": secs,
                     "recall": recall, "chance": chance}
        print(f"  {name}: {len(pairs)} candidates in {secs:.3f} s on "
              f"{card}; recall of the verified pairs {recall:.4f} "
              f"(chance {chance:.4f})", flush=True)
        if not recall > chance:
            raise AssertionError(f"{name}: recall {recall} <= chance")
    fp.opts = saved
    return _counts(), out                             # counts read


def _features_database(fp, sc, path: str) -> None:
    """A COLMAP database of the pipeline's features only (cameras, images
    with their ground-truth centres as location priors, keypoints and
    uint8 descriptors of the valid slots), through the port's
    ColmapDatabase."""
    from dagsfm_tpu_torch.features import sift
    from dagsfm_tpu_torch.scene import io as scene_io
    centers = sc.centers()
    with scene_io.ColmapDatabase(path) as db:
        for i in sorted(fp.images):
            cam = fp.cameras[i]
            db.add_camera(cam)
            db.add_image(f"image{i:05d}.jpg", cam.camera_id, image_id=i,
                         prior_tvec=centers[i - 1])
            db.add_keypoints(i, fp.keypoints[i][fp.masks[i]])
            db.add_descriptors(i, sift.descriptors_to_uint8(
                fp.descriptors[i][fp.masks[i]]))


def _cli(argv: list) -> str:
    """`python -m dagsfm_tpu_torch <argv>` in this process (its stdout
    returned and echoed); fails unless it returns or exits with 0."""
    import contextlib
    import io
    from dagsfm_tpu_torch.pipeline import cli
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
    except SystemExit as e:
        if e.code not in (0, None):
            raise AssertionError(f"{argv[0]} exited {e.code}") from e
    return buf.getvalue()


def _two_view_pairs(path: str) -> set:
    from dagsfm_tpu_torch.scene import io as scene_io
    with scene_io.ColmapDatabase(path) as db:
        return {(i, j) for (i, j, m, *_) in db.read_all_two_view_geometries()
                if len(m)}


def database_commands(fp, sc, dev, card: str) -> None:
    """The retrieval path's step (c): a database of the pipeline's
    features with the scene's ground-truth centres as location priors,
    then `python -m dagsfm_tpu_torch`'s vocab_tree_builder,
    vocab_tree_retriever, spatial_matcher (its new rows must be verified
    spatial pairs of those priors, as many as it reports) and
    transitive_matcher (each new row closes a triangle of the spatial
    rows), each in this process on its default device, the card."""
    from dagsfm_tpu_torch.features import retrieval as rt
    from dagsfm_tpu_torch.features import visual_index as vi

    n = len(fp.images)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        db, tree = f"{tmp}/database.db", f"{tmp}/tree.npz"
        _features_database(fp, sc, db)
        t_db = time.perf_counter() - t0
        steps = {}
        t = time.perf_counter()
        line = _cli(["vocab_tree_builder", "--database_path", db,
                     "--vocab_tree_path", tree])
        steps["vocab_tree_builder"] = time.perf_counter() - t
        print("  " + line.strip(), flush=True)
        if vi.load_tree(tree, device=dev).num_words != 64:
            raise AssertionError("vocab_tree_builder: no 64-word tree")
        t = time.perf_counter()
        lines = _cli(["vocab_tree_retriever", "--database_path", db,
                      "--vocab_tree_path", tree]).strip().splitlines()
        steps["vocab_tree_retriever"] = time.perf_counter() - t
        scores = {float(x.split("(")[1].rstrip(")")) for ln in lines
                  for x in ln.split(": ")[1].split(", ")}
        print(f"  vocab_tree_retriever: {len(lines)} lines, e.g. "
              f"{lines[0]}; distinct printed scores {sorted(scores)[:8]}",
              flush=True)
        if len(lines) != n or any(ln.count("(") != 10 for ln in lines):
            raise AssertionError("vocab_tree_retriever: not 10 per image")

        nn = SCALE_SPATIAL_NEIGHBORS
        t = time.perf_counter()
        line = _cli(["spatial_matcher", "--database_path", db,
                     "--max_num_neighbors", str(nn)])
        steps["spatial_matcher"] = time.perf_counter() - t
        rows = _two_view_pairs(db)
        ids = sorted(fp.images)
        want = {(i, j) for (i, j, _) in rt.spatial_pairs(
            ids, sc.centers(), max_num_neighbors=nn)}
        print(f"  {line.strip()}; rows {len(rows)}", flush=True)
        if not (rows <= want and line.startswith(
                f"spatial matching: {len(rows)}/{len(want)} ") and rows):
            raise AssertionError("spatial_matcher: rows are not the "
                                 "verified spatial pairs")
        t = time.perf_counter()
        line = _cli(["transitive_matcher", "--database_path", db,
                     "--num_iterations", "1"])
        steps["transitive_matcher"] = time.perf_counter() - t
        new = _two_view_pairs(db) - rows
        closes = all(any((min(a, k), max(a, k)) in rows
                         and (min(b, k), max(b, k)) in rows for k in ids)
                     for a, b in new)
        print(f"  {line.strip()}; new rows {len(new)}, each closing a "
              f"triangle of the spatial rows: {closes}", flush=True)
        if not (closes and new and line.strip() ==
                f"transitive matching: {len(new)} new pairs verified"):
            raise AssertionError("transitive_matcher out of limits")
    print(f"  on {card}: database {t_db:.3f} s; " + ", ".join(
        f"{k} {v:.3f} s" for k, v in steps.items())
        + f"; K1 launches {_counts()['fused_matcher']}", flush=True)


def retrieval_path(dev, card: str, modes: tuple) -> dict:
    """The retrieval path: (a) tests/test_e2e_scale.py at its own size,
    100 rendered images -> SIFT -> sequential pairs with BoW loop
    closure -> essential-only verification -> DistributedMapperController
    (clusters of at most 30), held to the test's gates; K1 then held
    against its plain version on the path's first batch (K = 512); (b)
    `modes`, pair_modes_step's counts and summary (it ran earlier, on the
    distorted path's features); (c) the database commands on a database
    of (a)'s features with ground-truth location priors:
    vocab_tree_builder, vocab_tree_retriever, spatial_matcher (its new
    rows must be verified spatial pairs of those priors, as many as it
    reports) and transitive_matcher. Returns the launch counts of (a),
    (b) and (c) together."""
    from dagsfm_tpu_torch.ops import matcher_kernel as mk
    from dagsfm_tpu_torch.pipeline.distributed_mapper import \
        DistributedMapperController
    from dagsfm_tpu_torch.pipeline.feature_pipeline import FeaturePipeline

    n = SCALE_IMAGES
    print(f"== retrieval path (a): tests/test_e2e_scale.py, {n} rendered "
          "256 x 192 images, SIFT 512, sequential pairs (overlap 4) with "
          "BoW loop detection every 10 images, essential-only, "
          "DistributedMapperController (clusters <= 30)", flush=True)
    t0 = time.perf_counter()
    sc, images, cams, opts, dm_opts = scale_inputs(dev, n)
    torch.cuda.synchronize()
    print(f"  set-up: scene and rendering {time.perf_counter() - t0:.3f} s",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()                                    # counts zeroed
    t0 = time.perf_counter()
    fp = FeaturePipeline(images, cams, opts, device=dev)
    fp.extract_features()
    t1 = time.perf_counter()
    pairs = fp.select_pairs()
    torch.cuda.synchronize()
    t_sel = time.perf_counter() - t1
    fp.match_and_verify(pairs)
    k1_match = _counts()["fused_matcher"]
    cams2, imgs2, graph = fp.to_mapper_inputs()
    ctrl = DistributedMapperController(
        cams2, imgs2, graph, dm_opts,
        two_view_geometries=fp.two_view_edges(), device=dev)
    merged = ctrl.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    err, t_model = _write_and_gate(merged, sc, n, 0.1, math.inf, min_reg=90)
    sep = ctrl.separator_rmse(merged)
    loops = [(i, j) for i, j in pairs if j - i > opts.sequential_overlap]
    seam = [(i, j) for i, j in fp.two_view if j - i > 80]
    tm_ = fp.timings
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in ctrl.timings.items())
    sizes = [len(c.image_ids) for c in ctrl.clusters]
    print(f"  on {card}: extraction {tm_['extraction']:.3f} s, pair "
          f"selection {t_sel:.3f} s ({len(pairs)} candidates, {len(loops)} "
          f"loop pairs), matching {tm_['matching']:.3f} s (K1 launches "
          f"{k1_match}), verification {tm_['verification']:.3f} s "
          f"({fp.num_classified} classified, {len(fp.two_view)} verified, "
          f"{len(seam)} seam edges with j - i > 80); controller stages: "
          f"{stages}; clusters {len(sizes)}, sizes {sizes}; separator RMSE "
          f"{sep:.6f} px; model write+read {t_model:.3f} s; end to end "
          f"{t2 - t0 + t_model:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    if not (len(fp.two_view) > 300 and seam and sep < 2.0 and k1_match):
        raise AssertionError("retrieval path (a) out of limits")

    first = pairs[:MATCH_BATCH]
    slot = fp.bank.slot
    i1 = torch.tensor([slot[a] for a, _ in first], device=dev)
    i2 = torch.tensor([slot[b] for _, b in first], device=dev)
    d1, d2 = fp.bank.desc[i1], fp.bank.desc[i2]
    m1, m2 = fp.bank.mask[i1], fp.bank.mask[i2]
    counts_a = _counts()
    _hold_j(f"fused matcher, the retrieval path's first batch "
            f"(B={len(first)}, K={d1.shape[1]})",
            mk.fused_match_j(d1, d2, m1, m2),
            mk.fused_match_j_reference(d1, d2, m1, m2),
            mk.borderline_rows(d1, d2, m1, m2))

    mode_counts, summary = modes
    print("  (b), run after the entry-point path: " + "; ".join(
        f"{k} {v['candidates']} in {v['seconds']:.3f} s, recall "
        f"{v['recall']:.4f} > {v['chance']:.4f}" for k, v in summary.items()),
        flush=True)

    print("== retrieval path (c): the database commands on a database of "
          f"(a)'s features with ground-truth location priors", flush=True)
    _zero_counts()                                    # counts zeroed
    database_commands(fp, sc, dev, card)
    counts = _counts()                                # counts read
    return {k: counts_a[k] + counts[k] + mode_counts[k] for k in counts}


def _reproj_px(rec) -> np.ndarray:
    """The reprojection error in pixels of every observation of every
    point (a model's own cameras, any model)."""
    from dagsfm_tpu_torch.ops import projection
    from dagsfm_tpu_torch.scene import cameras
    q, t, X, xy, mid, par = [], [], [], [], [], []
    for pt in rec.points3D.values():
        for i, k in pt.track:
            im = rec.images[i]
            cam = rec.cameras[im.camera_id]
            q.append(im.qvec)
            t.append(im.tvec)
            X.append(pt.xyz)
            xy.append(im.xys[k])
            mid.append(cam.model_id)
            par.append(cam.padded_params())
    T = (lambda a: torch.as_tensor(np.asarray(a)))
    proj, _ = projection.project_full(T(mid), T(par), T(q), T(t), T(X))
    return torch.linalg.norm(proj - T(xy), dim=-1).numpy()


def commands_path(dev, card: str, state: dict) -> dict:
    """The model commands in this process (`_cli`, as `python -m
    dagsfm_tpu_torch` runs them) on the database path's database and its
    scene-1 model: image_deleter makes copy A without its last
    CMD_DROP images (41-50) and copy B without its first CMD_DROP (1-10);
    model_merger merges A and B, sfm_aligner a directory of A and B (the
    two to the bit, all registered, the planted limits);
    image_registrator puts A's dropped images back from the database;
    point_triangulator re-triangulates the model with its points
    stripped (>= 90 % of its points, median error < 1 px);
    bundle_adjuster (its cost must not rise); model_aligner onto the true
    centres (within the planted ATE without a further Sim(3));
    model_analyzer (its JSON the model's own counts). Returns the launch
    counts (none expected)."""
    import os

    from dagsfm_tpu_torch.ops import rotations as rops
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.scene import synthetic

    work, sc = state["work"], state["scenes"][0]
    model = next(r for r in state["mgr"]
                 if _db_model_errors(r, state["scenes"])[0] == 0)
    print(f"== commands path: the model commands in this process on the "
          f"database path's database and its scene-1 model "
          f"({model.num_reg_images()} images, {model.num_points3D()} "
          f"points)", flush=True)
    d = (lambda *a: os.path.join(work, "cmd", *a))
    os.makedirs(d("pair"), exist_ok=True)
    scene_io.write_model_bin(model, d("model"))
    tail = range(DB_IMAGES - CMD_DROP + 1, DB_IMAGES + 1)
    head = range(1, CMD_DROP + 1)
    with open(d("drop_a.txt"), "w") as f:
        f.write("".join(f"{i}\n" for i in tail))
    with open(d("drop_b.txt"), "w") as f:
        f.write("".join(f"image{i:05d}.jpg\n" for i in head))
    stripped = scene_io.read_model_bin(d("model"))
    for pid in list(stripped.points3D):
        stripped.delete_point3D(pid)
    scene_io.write_model_bin(stripped, d("stripped"))
    centres = sc.centers()
    with open(d("centres.txt"), "w") as f:
        f.write("".join(f"image{i:05d}.jpg {float(c[0])!r} {float(c[1])!r} "
                        f"{float(c[2])!r}\n"
                        for i, c in enumerate(centres, 1)))
    torch.cuda.synchronize()
    _zero_counts()                                    # counts zeroed
    secs, outs = {}, {}

    def run(name, *argv):
        t0 = time.perf_counter()
        outs[name] = _cli([name, *argv])
        secs[name] = time.perf_counter() - t0
    run("image_deleter", "--input_path", d("model"), "--output_path",
        d("pair", "A"), "--image_ids_path", d("drop_a.txt"))
    run("image_deleter", "--input_path", d("model"), "--output_path",
        d("pair", "B"), "--image_names_path", d("drop_b.txt"))
    run("model_merger", "--input_path1", d("pair", "A"), "--input_path2",
        d("pair", "B"), "--output_path", d("merged"))
    run("sfm_aligner", "--input_path", d("pair"), "--output_path",
        d("aligned"))
    run("image_registrator", "--database_path", state["db"],
        "--input_path", d("pair", "A"), "--output_path", d("registered"))
    run("point_triangulator", "--database_path", state["db"],
        "--input_path", d("stripped"), "--output_path", d("triangulated"))
    run("bundle_adjuster", "--input_path", d("model"), "--output_path",
        d("adjusted"))
    run("model_aligner", "--input_path", d("model"), "--ref_images_path",
        d("centres.txt"), "--output_path", d("true_frame"))
    run("model_analyzer", "--input_path", d("model"))
    torch.cuda.synchronize()
    counts = _counts()                                # counts read

    read = (lambda *a: scene_io.read_model_bin(d(*a)))
    a, b = read("pair", "A"), read("pair", "B")
    merged, aligned = read("merged"), read("aligned")
    registered, tri = read("registered"), read("triangulated")
    err = {k: synthetic.pose_errors(r, sc) for k, r in (
        ("merged", merged), ("aligned", aligned),
        ("registered", registered))}
    back = [registered.images[i] for i in tail]
    R_true = [sc.R[i - 1] for i in tail]
    sim = synthetic.align_to_truth(registered, sc)
    rereg_deg = max(_angle_deg(rops.quat_to_rotmat_np(im.qvec) @ sim[1].T,
                               R) for im, R in zip(back, R_true))
    tri_px, model_px = _reproj_px(tri), _reproj_px(model)
    tri_med = float(np.median(tri_px))
    costs = [float(x) for x in outs["bundle_adjuster"].split("BA cost")[1]
             .split("->")]
    true_frame = synthetic.pose_errors(read("true_frame"), sc, align=False)
    stats = json.loads(outs["model_analyzer"].strip().splitlines()[-1])
    tracks = [len(p.track) for p in model.points3D.values()]
    own = {"num_cameras": len(model.cameras), "num_images": len(model.images),
           "num_reg_images": model.num_reg_images(),
           "num_points3D": model.num_points3D(),
           "num_observations": int(sum(tracks)),
           "mean_track_length": round(float(np.mean(tracks)), 3),
           "mean_observations_per_image": round(
               sum(tracks) / model.num_reg_images(), 3),
           "mean_reprojection_error_px": round(
               model.compute_mean_reprojection_error(), 4)}
    print(f"  on {card}: " + ", ".join(f"{k} {v:.3f} s"
                                       for k, v in secs.items())
          + f"; commands path {sum(secs.values()):.3f} s; K1-K4 launches "
          f"{counts}", flush=True)
    print(f"  copies A, B: {a.num_reg_images()}, {b.num_reg_images()} "
          f"registered; model_merger and sfm_aligner: "
          f"{merged.num_reg_images()}, {aligned.num_reg_images()} "
          f"registered, ATE {err['merged']['ate']:.6f}, "
          f"{err['aligned']['ate']:.6f}, the same to the bit: "
          f"{_same_models([merged], [aligned])}", flush=True)
    print(f"  image_registrator: {registered.num_reg_images()} registered, "
          f"ATE {err['registered']['ate']:.6f}, rotation error mean "
          f"{err['registered']['rot_err_deg_mean']:.6f} deg, largest of "
          f"the re-registered {rereg_deg:.6f} deg; point_triangulator: "
          f"{tri.num_points3D()} points (the mapped model's "
          f"{model.num_points3D()}), reprojection error median "
          f"{tri_med:.4f} px, mean {tri_px.mean():.4f} px (the mapped "
          f"model's {np.median(model_px):.4f}, {model_px.mean():.4f}); "
          f"bundle_adjuster cost "
          f"{costs[0]:.2f} -> {costs[1]:.2f}; model_aligner ATE "
          f"{true_frame['ate']:.6f} with no further alignment; "
          f"model_analyzer {stats}", flush=True)

    if any(counts.values()):
        raise AssertionError(f"commands path: kernel launches {counts}")
    if (a.num_reg_images(), b.num_reg_images()) != \
            (DB_IMAGES - CMD_DROP,) * 2 or set(a.reg_image_ids) & set(tail) \
            or set(b.reg_image_ids) & set(head):
        raise AssertionError("commands path: image_deleter")
    for k in ("merged", "aligned", "registered"):
        e = err[k]
        if e["num_reg"] != DB_IMAGES or e["ate"] >= 0.05 \
                or e["rot_err_deg_mean"] >= 0.2:
            raise AssertionError(f"commands path: {k} out of limits {e}")
    if not _same_models([merged], [aligned]):
        raise AssertionError("commands path: model_merger and sfm_aligner "
                             "differ")
    if rereg_deg >= 0.2:
        raise AssertionError("commands path: re-registered poses off by "
                             f"{rereg_deg} deg")
    # the median: the command keeps its two-view points unrefined (no BA
    # and no filter, as the reference's), so a tail of them carries the
    # mean past 1 px in both packages (PERF.md section 2)
    if tri.num_points3D() < 0.9 * model.num_points3D() or tri_med >= 1.0:
        raise AssertionError("commands path: point_triangulator gave "
                             f"{tri.num_points3D()} points at a median "
                             f"{tri_med} px")
    if costs[1] > costs[0]:
        raise AssertionError(f"commands path: BA cost rose {costs}")
    if true_frame["ate"] >= 0.05:
        raise AssertionError(f"commands path: model_aligner {true_frame}")
    if stats != own:
        raise AssertionError(f"commands path: model_analyzer {stats} != "
                             f"{own}")
    return counts


def _rig_mount_errors(out, truth: dict, rig_frame_centres) -> tuple:
    """(rotation errors in degrees, translation errors) of a RigBAResult's
    mounts against the true mounts relative to camera 0 (the solver's
    rig frame), translations at the scale that aligns the solved rig
    centres (camera 0's) to the true ones."""
    from dagsfm_tpu_torch.ops import rotations as rops
    from dagsfm_tpu_torch.ops.umeyama import umeyama_np
    rq, rt = out.rig_q.cpu().numpy(), out.rig_t.cpu().numpy()
    Rr = rops.quat_to_rotmat_np(rq)
    centres = -np.einsum("sji,sj->si", Rr, rt)
    s, _, _ = umeyama_np(centres, rig_frame_centres)
    R0, t0 = truth["mount_R"][0], truth["mount_t"][0]
    mq, mt = out.mount_q.cpu().numpy(), out.mount_t.cpu().numpy()
    rot, trans = [], []
    for c in range(len(mq)):
        R_rel = truth["mount_R"][c] @ R0.T
        rot.append(_angle_deg(rops.quat_to_rotmat_np(mq[c]), R_rel))
        trans.append(float(np.linalg.norm(
            s * mt[c] - (truth["mount_t"][c] - R_rel @ t0))))
    return rot, trans


def rig_path(dev, card: str) -> dict:
    """The rig group on the card: rig_scene's 200 images written with
    their rig config, `rig_bundle_adjuster` (through `_cli`, at its
    defaults: 50 iterations, the relative poses refined) against an
    in-process `solve` on the same input (to the bit), gated on the
    cost, the RMS reprojection error and the mounts against the truth;
    then gpnp under RANSAC on snapshot 0's rays with RIG_OUTLIERS of them
    turned random, and the 17-point solver on 17 exact ray pairs between
    snapshots 0 and 1, and over a batch of RIG_HYPS such systems (the
    batched SVD, timed; how many of them give R within 1e-5 is
    printed). Returns the launch counts (none expected)."""
    import os

    from dagsfm_tpu_torch.ops import generalized_pose as gp
    from dagsfm_tpu_torch.ops import ransac as rnsc
    from dagsfm_tpu_torch.scene import camera_rig as crig
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.sfm import rig_bundle_adjustment as rba

    C = len(RIG_YAW_DEG)
    print(f"== rig path: {C} cameras x {RIG_SNAPSHOTS} snapshots "
          f"({C * RIG_SNAPSHOTS} images of {RIG_W} x {RIG_H}), "
          f"{RIG_POINTS} points each in {RIG_TRACK[0]}-{RIG_TRACK[1]} "
          f"snapshots, pixel noise {RIG_NOISE}", flush=True)
    t0 = time.perf_counter()
    rec, truth = rig_scene(RIG_SNAPSHOTS, RIG_POINTS)
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        model, out_dir = os.path.join(tmp, "model"), os.path.join(tmp, "out")
        cfg = os.path.join(tmp, "rig.json")
        scene_io.write_model_bin(rec, model)
        with open(cfg, "w") as f:
            json.dump(rig_config(), f)
        print(f"  set-up: scene, model and rig config "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()                                # counts zeroed
        t0 = time.perf_counter()
        printed = _cli(["rig_bundle_adjuster", "--input_path", model,
                        "--output_path", out_dir, "--rig_config_path", cfg])
        secs["rig_bundle_adjuster"] = time.perf_counter() - t0
        cli_rec = scene_io.read_model_bin(out_dir)
        # the same solve in this process
        t0 = time.perf_counter()
        mine = scene_io.read_model_bin(model)
        rigs = crig.read_rig_config(cfg, mine)
        prob, meta = crig.make_rig_ba_problem(mine, rigs, device=dev)
        torch.cuda.synchronize()
        secs["set-up"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = rba.solve(prob, rba.RigBAOptions(max_iterations=50))
        torch.cuda.synchronize()
        secs["solve"] = time.perf_counter() - t0
        crig.apply_rig_ba_result(mine, rigs, out, meta)
    N = prob.obs_xy.shape[0]
    n_par = 6 * prob.rig_q.shape[0] + 6 * C + 3 * prob.points.shape[0]
    j_bytes = 2 * N * n_par * 8
    c0, c1 = float(out.initial_cost), float(out.final_cost)
    rms = math.sqrt(2 * c1 / N)
    R0, t0m = truth["mount_R"][0], truth["mount_t"][0]
    cam0_R = np.einsum("ij,sjk->sik", R0, truth["rig_R"])
    cam0_t = truth["rig_t"] @ R0.T + t0m
    rot_err, t_err = _rig_mount_errors(
        out, truth, -np.einsum("sji,sj->si", cam0_R, cam0_t))
    same = _same_models([cli_rec], [mine])

    # gpnp under RANSAC on snapshot 0's rays, a share of them turned
    rng = np.random.default_rng(5)
    X, o, dirs, _, _ = rig_rays(truth, 0)
    n = len(X)
    bad = rng.choice(n, int(RIG_OUTLIERS * n), replace=False)
    dirs = dirs.copy()
    dirs[bad] = _unit(rng.normal(size=(len(bad), 3)))
    T = (lambda a: torch.as_tensor(np.asarray(a), device=dev)[None])
    mask = torch.ones((1, n), dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    idx = rnsc.sample_indices(gen, mask, RIG_HYPS, RIG_SAMPLE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rnsc.ransac(gp.gpnp, lambda M, a, b, c: gp.gpnp_ray_residual(
        M, a[:, None], b[:, None], c[:, None]), (T(X), T(o), T(dirs)), mask,
        idx, 1e-6)
    torch.cuda.synchronize()
    secs["gpnp RANSAC"] = time.perf_counter() - t0
    M = res.model[0].cpu().numpy()
    gpnp_err = max(np.abs(M[:, :3] - truth["rig_R"][0]).max(),
                   np.abs(M[:, 3] - truth["rig_t"][0]).max())
    # the 17-point solver: one ray per point seen in snapshots 0 and 1,
    # the cameras taken in turn so that no one camera pair holds them all
    q1, c1_, q2, c2 = _rig_ray_pairs(truth, 0, 1)
    R_true = truth["rig_R"][1] @ truth["rig_R"][0].T
    t0 = time.perf_counter()
    M17, v17 = gp.generalized_relative_pose_17pt(
        *(T(a[:17]) for a in (q1, c1_, q2, c2)))
    torch.cuda.synchronize()
    secs["17-point"] = time.perf_counter() - t0
    r17_err = float(np.abs(M17[0, 0, :, :3].cpu().numpy() - R_true).max())
    # a batch of windows of 17 consecutive pairs (cyclic), timed
    pick = torch.as_tensor((np.arange(RIG_HYPS)[:, None] + np.arange(17))
                           % len(q1), device=dev)
    batch = [torch.as_tensor(a, device=dev)[pick] for a in (q1, c1_, q2, c2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Mb, vb = gp.generalized_relative_pose_17pt(*batch)
    torch.cuda.synchronize()
    secs[f"17-point x {RIG_HYPS}"] = time.perf_counter() - t0
    rb_ok = int(((Mb[..., 0, :, :3] - torch.as_tensor(R_true, device=dev))
                 .abs().amax(dim=(-1, -2)) < 1e-5).sum())
    counts = _counts()                                # counts read
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    print(f"  on {card}: " + ", ".join(f"{k} {v:.3f} s"
                                       for k, v in secs.items())
          + f"; {printed.strip().splitlines()[-1]}; {N} observations, "
          f"{n_par} parameters, J {j_bytes / 2 ** 30:.3f} GiB "
          f"({j_bytes} bytes), {50 / secs['solve']:.3f} LM iterations/s; "
          f"peak device memory {peak:.2f} GiB; K1-K4 launches {counts}",
          flush=True)
    print(f"  cost {c0:.6g} -> {c1:.6g} ({c1 / c0:.3g}), RMS reprojection "
          f"error {rms:.4f} px; mounts: rotation error "
          f"{[round(e, 5) for e in rot_err]} deg, translation error "
          f"{[round(e, 5) for e in t_err]} (baseline {RIG_BASELINE}); the "
          f"command's model and the in-process solve to the bit: {same}",
          flush=True)
    print(f"  gpnp: {n} rays, {len(bad)} outliers, {RIG_HYPS} hypotheses "
          f"of {RIG_SAMPLE}: {int(res.num_inliers[0])} inliers, pose error "
          f"{gpnp_err:.3g}; 17-point: R error {r17_err:.3g} (valid "
          f"{bool(v17[0, 0])}), over the batch of {RIG_HYPS} windows: "
          f"{rb_ok} with R within 1e-5, {int(vb.sum())} valid",
          flush=True)

    if any(counts.values()):
        raise AssertionError(f"rig path: kernel launches {counts}")
    if not same:
        raise AssertionError("rig path: rig_bundle_adjuster's model differs "
                             "from the in-process solve")
    if not (c1 < 0.2 * c0 and rms < 0.75):
        raise AssertionError(f"rig path: cost {c0} -> {c1}, RMS {rms}")
    if max(rot_err) >= 0.1 or max(t_err) >= 0.02 * RIG_BASELINE:
        raise AssertionError(f"rig path: mounts off {rot_err} {t_err}")
    if not (bool(res.valid[0]) and gpnp_err < 1e-4):
        raise AssertionError(f"rig path: gpnp pose error {gpnp_err}")
    if not (bool(v17[0, 0]) and r17_err < 1e-5):
        raise AssertionError(f"rig path: 17-point R error {r17_err}")
    if peak >= 40.0:
        raise AssertionError(f"rig path: peak device memory {peak} GiB")
    return counts


def _rig_ray_pairs(truth: dict, s1: int, s2: int) -> tuple:
    """One ray pair per point seen in snapshots s1 and s2 (true rig
    frames, clean pixels): its k-th point takes the k-th of the cameras
    that see it in s1 and the (k + 1)-th in s2, cyclically. Returns (q1,
    c1, q2, c2), each (n, 3)."""
    common = np.nonzero(truth["seen"][s1].any(0)
                        & truth["seen"][s2].any(0))[0]
    rays = []
    for s in (s1, s2):
        _, o, d, pp, _ = rig_rays(truth, s, common)
        by_point = {}
        for k in range(len(pp)):
            by_point.setdefault(int(pp[k]), []).append((o[k], d[k]))
        rays.append(by_point)
    q1, c1, q2, c2 = [], [], [], []
    for k, p in enumerate(common):
        a = rays[0][int(p)][k % len(rays[0][int(p)])]
        b = rays[1][int(p)][(k + 1) % len(rays[1][int(p)])]
        c1.append(a[0])
        q1.append(a[1])
        c2.append(b[0])
        q2.append(b[1])
    return tuple(np.stack(x) for x in (q1, c1, q2, c2))


def decoders() -> dict:
    """Which image decoders this machine has (looked up, never used to
    read: the photo commands read with PIL alone)."""
    import importlib.util
    out = {}
    for name, mod in (("PIL", "PIL"), ("imageio", "imageio"),
                      ("cv2", "cv2"), ("torchvision.io", "torchvision")):
        out[name] = importlib.util.find_spec(mod) is not None
    if out["torchvision.io"]:
        try:
            import torchvision.io  # noqa: F401
        except Exception:  # noqa: BLE001 — a broken install is "absent"
            out["torchvision.io"] = False
    return out


def photos_path(dev, card: str, images: dict, sc, work: str) -> tuple:
    """The photo commands' bodies on the card, on the pixel path's
    rendered images quantised to 8 bits (as a PNG round trip leaves
    them), each with the camera `camera_from_exif` builds from an
    explicit calibration (SIMPLE_PINHOLE at the true focal, as the pixel
    path's cameras): `feature_extractor` into one database, then
    `automatic_reconstructor` (exhaustive extraction, matching and
    verification into its own database, mapping, the model written),
    gated as the pixel path (all registered, ATE < 0.1, mean rotation
    error < 1 degree) and on feature_extractor's keypoint rows equal to
    automatic_reconstructor's; `color_extractor` on the model (every
    point coloured); `image_rectifier` on one registered pair (the
    pair's shared points on one row: median |dy| < 1 px). Prints which
    decoders the machine has; with PIL, `automatic_reconstructor` also
    runs as a process on PNGs (`photos_process`, after the last path).
    Returns (launch counts, the model, the grey images by image
    id, what the process needs or None)."""
    import os

    from dagsfm_tpu_torch.features import sift
    from dagsfm_tpu_torch.ops import rotations as rops
    from dagsfm_tpu_torch.pipeline import cli
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.scene import undistortion
    from dagsfm_tpu_torch.scene.image_reader import (ImageReaderOptions,
                                                     camera_from_exif)

    have = decoders()
    ids = sorted(images)
    H, W = images[ids[0]].shape
    f = float(sc.camera.params[0])
    print(f"== photos path: the photo commands' bodies on the pixel path's "
          f"{len(ids)} images of {W} x {H} at 8 bits; decoders on this "
          f"machine: {have}", flush=True)
    photos = {i: (np.round(np.clip(images[i], 0, 1) * 255).astype(np.uint8)
                  .astype(np.float32) / 255.0) for i in ids}
    opts = ImageReaderOptions(camera_model="SIMPLE_PINHOLE",
                              camera_params=f"{f!r},{W / 2.0!r},{H / 2.0!r}")
    cams = {i: camera_from_exif(i, W, H, None, opts) for i in ids}
    d = (lambda *a: os.path.join(work, "photos", *a))
    os.makedirs(d(), exist_ok=True)
    n_pairs = len(ids) * (len(ids) - 1) // 2
    secs = {}

    torch.cuda.synchronize()
    _zero_counts()                                    # counts zeroed
    t0 = time.perf_counter()
    cli.feature_extractor(photos, cams, d("features.db"), sift.SiftOptions(),
                          device=dev)
    torch.cuda.synchronize()
    secs["feature_extractor"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec, out, fp = cli.automatic_reconstructor(photos, cams, d("ws"),
                                               device=dev)
    torch.cuda.synchronize()
    secs["automatic_reconstructor"] = time.perf_counter() - t0
    counts = _counts()                                # counts read
    err, _ = _write_and_gate(rec, sc, len(ids), 0.1, 1.0)
    with scene_io.ColmapDatabase(d("features.db")) as a, \
            scene_io.ColmapDatabase(d("ws", "database.db")) as b:
        same_rows = all(np.array_equal(a.read_keypoints(i),
                                       b.read_keypoints(i)) for i in ids)
        rows = sum(len(a.read_keypoints(i)) for i in ids)

    grey = {i: photos[i] for i in ids}
    by_name = {rec.images[i].name: np.repeat(photos[i][:, :, None], 3, 2)
               for i in ids}
    t0 = time.perf_counter()
    colored = cli.color_extractor(rec, by_name)
    secs["color_extractor"] = time.perf_counter() - t0
    i1, i2 = [i for i in ids if rec.images[i].registered][:2]
    im1, im2 = rec.images[i1], rec.images[i2]
    t0 = time.perf_counter()
    n_rect = cli.image_rectifier(rec, by_name, [(im1.name, im2.name)],
                                 d("rect"), device=dev)
    torch.cuda.synchronize()
    secs["image_rectifier"] = time.perf_counter() - t0
    stem = f"{os.path.splitext(im1.name)[0]}-{os.path.splitext(im2.name)[0]}"
    npz = np.load(d("rect", stem + ".npz"))
    R1, R2 = rops.quat_to_rotmat_np(im1.qvec), rops.quat_to_rotmat_np(im2.qvec)
    R12 = R2 @ R1.T
    H1, H2, _ = undistortion.rectify_stereo_cameras(
        *(undistortion.undistorted_camera(rec.cameras[im.camera_id])
          for im in (im1, im2)),
        rops.rotmat_to_quat_np(R12), im2.tvec - R12 @ im1.tvec)
    shared = [(k1, k2) for k1, p in enumerate(im1.point3D_ids) if p >= 0
              for k2 in np.nonzero(im2.point3D_ids == p)[0]]
    x1 = np.c_[im1.xys[[a for a, _ in shared]], np.ones(len(shared))] @ H1.T
    x2 = np.c_[im2.xys[[b for _, b in shared]], np.ones(len(shared))] @ H2.T
    dy = np.abs(x1[:, 1] / x1[:, 2] - x2[:, 1] / x2[:, 2])
    print(f"  on {card}: feature_extractor {secs['feature_extractor']:.3f} s "
          f"({rows} keypoint rows, automatic_reconstructor's the same: "
          f"{same_rows}); automatic_reconstructor "
          f"{secs['automatic_reconstructor']:.3f} s ({n_pairs} pairs, "
          f"{len(fp.two_view)} verified, K1 launches "
          f"{counts['fused_matcher']}); color_extractor "
          f"{secs['color_extractor']:.3f} s ({colored}/"
          f"{rec.num_points3D()} points coloured); image_rectifier "
          f"{secs['image_rectifier']:.3f} s (pair {i1}-{i2}: {len(shared)} "
          f"shared points, median |dy| {np.median(dy):.4f} px, rectified "
          f"{npz['left'].shape})", flush=True)
    if not same_rows:
        raise AssertionError("photos path: feature_extractor's keypoint "
                             "rows differ from automatic_reconstructor's")
    if colored != rec.num_points3D() or colored == 0:
        raise AssertionError(f"photos path: {colored} of "
                             f"{rec.num_points3D()} points coloured")
    if not (n_rect == 1 and len(shared) >= 8 and np.median(dy) < 1.0
            and all(np.isfinite(npz[k]).all() for k in ("left", "right", "Q"))
            and np.ptp(npz["left"]) > 0):
        raise AssertionError("photos path: image_rectifier's pair is not "
                             "rectified")
    if counts["fused_matcher"] != math.ceil(n_pairs / MATCH_BATCH):
        raise AssertionError(f"photos path: K1 launches {counts}")
    process = None
    if have["PIL"]:
        process = (photos, f, d)
        print("  PIL is here: automatic_reconstructor runs as a process on "
              "the photos as PNGs after the last path",
              flush=True)
    else:
        print("  no PIL on this machine: the photo commands exit here as "
              "the JAX package's do; they run as processes in the CPU "
              "tests only", flush=True)
    return counts, rec, grey, process


def photos_process(card: str, photos: dict, f: float, d, sc) -> None:
    """Where PIL is: the photos written as PNGs, then `python -m
    dagsfm_tpu_torch automatic_reconstructor` on them as a process of
    its own, after the last path (so that it shares the card with no
    timed path), its wall time printed, and its model held to the pixel
    path's limits (all registered, ATE < 0.1, mean rotation error < 1
    degree)."""
    import os

    from PIL import Image

    from dagsfm_tpu_torch.scene import io as scene_io
    os.makedirs(d("png"), exist_ok=True)
    for i, img in photos.items():
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(
            d("png", f"image{i:05d}.png"))
    H, W = next(iter(photos.values())).shape
    t0 = time.perf_counter()
    p = _start_cli(["automatic_reconstructor", "--image_path", d("png"),
                    "--workspace_path", d("ws_process"), "--camera_model",
                    "SIMPLE_PINHOLE", "--camera_params",
                    f"{f!r},{W / 2.0!r},{H / 2.0!r}"], d("process.log"))
    out = _finish_cli(p, 600, "automatic_reconstructor")
    print(f"== automatic_reconstructor process on the photos path's PNGs, "
          f"alone after the last path: {time.perf_counter() - t0:.3f} s "
          f"wall on {card}; its line: {out.strip().splitlines()[-1]}",
          flush=True)
    _write_and_gate(scene_io.read_model_bin(
        os.path.join(d("ws_process"), "sparse", "0")), sc, len(photos),
        0.1, 1.0)


def line_images(rec, W: int | None = None, H: int | None = None,
                lines: int = 6, seed: int = 0) -> dict:
    """Grey images (float32, image id -> (H, W)) of a Manhattan scene's
    edges as each registered image sees them: anti-aliased lines
    (Gaussian profile, sigma 0.8 px) through the vanishing points of the
    world's x and y axes, on a flat background. W and H default to the
    camera's; the principal point is the image centre."""
    from dagsfm_tpu_torch.ops import rotations as rops
    rng = np.random.default_rng(seed)
    out = {}
    for iid in rec.reg_image_ids:
        im = rec.images[iid]
        cam = rec.cameras[im.camera_id]
        w, h = W or cam.width, H or cam.height
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        K = np.array([[cam.focal(), 0, w / 2], [0, cam.focal(), h / 2],
                      [0, 0, 1.0]])
        R = rops.quat_to_rotmat_np(im.qvec)
        img = np.full((h, w), 0.2)
        for axis in (0, 1):
            vp = K @ R[:, axis]
            for _ in range(lines):
                p = np.array([rng.uniform(10, w - 10),
                              rng.uniform(10, h - 10), 1.0])
                ln = np.cross(vp, p)
                ln /= np.linalg.norm(ln[:2])
                d = ln[0] * xs + ln[1] * ys + ln[2]
                img += rng.uniform(0.3, 0.6) * np.exp(-0.5 * (d / 0.8) ** 2)
        out[iid] = np.clip(img, 0, 1).astype(np.float32)
    return out


def peak_bins(lines: tuple, rho_max: float, num_theta: int = 60,
              num_rho: int = 128) -> list:
    """The (theta, rho) accumulator bins of detect_lines' lines, in its
    order."""
    _, _, theta = lines
    rho = -lines[0][:, 2]
    t = np.round(theta / np.pi * num_theta - 0.5).astype(int)
    r = np.round((rho + rho_max) / (2 * rho_max) * num_rho - 0.5)
    return list(zip(t.tolist(), r.astype(int).tolist()))


def _captured_accumulators(cf, run) -> list:
    """run() with every Hough accumulator it computes recorded, in call
    order, as (acc on the host, rho_max, the image on the host): the
    frames' own accumulators, so the comparison computes none again."""
    inner, seen = cf._hough_accumulate, []

    def record(img, *a, **k):
        acc, rho_max = inner(img, *a, **k)
        seen.append((acc.cpu().numpy(), rho_max, img.cpu().numpy()))
        return acc, rho_max

    cf._hough_accumulate = record
    try:
        run()
    finally:
        cf._hough_accumulate = inner
    return seen


HOUGH_EDGE = 1e-4        # bin units: a vote this close to a bin's edge
HOUGH_MAG_EDGE = 1e-6    # rel: |grad| this close to the vote threshold


def rounding_slack(img, num_theta: int = 60, num_rho: int = 128) -> tuple:
    """The Hough votes that rounding decides and where they may land.
    From the port's gradients on the CPU (the same bits as the card's and
    the JAX package's, `coordinate_frame._sobel`), in float64: a voter
    within HOUGH_EDGE of a theta or a rho bin's edge, or with |grad|
    within HOUGH_MAG_EDGE of the vote threshold. atan2, cos and sin round
    differently from one library to the next, by a few ulp (about 5e-6
    of a bin), so such a vote lands in one of the bins its angle and rho
    reach within HOUGH_EDGE (theta wraps at pi, where rho changes sign),
    or nowhere. Returns (the number of such votes, per (theta, rho) bin
    the weight of those that may land in it): two accumulators of the
    image differ at a bin by rounding by at most that weight, and by the
    float32 sum's own rounding."""
    from dagsfm_tpu_torch.estimation import coordinate_frame as cf
    x = torch.as_tensor(np.asarray(img, np.float32))
    h, w = x.shape
    gx, gy = cf._sobel(x)
    mag = torch.sqrt(gx * gx + gy * gy).reshape(-1)
    thr = float(torch.quantile(mag, 0.9))
    mag = mag.double().numpy()
    gx, gy = (g.double().numpy().reshape(-1) for g in (gx, gy))
    ys, xs = (v.reshape(-1).astype(np.float64) for v in np.mgrid[0:h, 0:w])
    rho_max = float(np.sqrt(float(h * h + w * w)))
    theta = np.mod(np.arctan2(gy, gx), np.pi)
    rho = xs * np.cos(theta) + ys * np.sin(theta)

    def bins(theta, rho, step):
        return (theta / np.pi * num_theta + step[0],
                (rho + rho_max) / (2 * rho_max) * num_rho + step[1])

    t, r = bins(theta, rho, (0, 0))
    near = ((np.abs(t - np.round(t)) < HOUGH_EDGE)
            | (np.abs(r - np.round(r)) < HOUGH_EDGE)
            | (np.abs(mag - thr) <= HOUGH_MAG_EDGE * thr))
    sel = near & (mag > thr * (1 - HOUGH_MAG_EDGE))      # may vote
    theta, rho = theta[sel], rho[sel]
    keys = []
    for dt in (-HOUGH_EDGE, 0.0, HOUGH_EDGE):
        for dr in (-HOUGH_EDGE, 0.0, HOUGH_EDGE):
            t, r = bins(theta, rho, (dt, dr))
            # past either end theta wraps and rho changes sign
            wrap = (t < 0) | (t >= num_theta)
            t = np.where(wrap, np.mod(t, num_theta), t)
            r = np.where(wrap, num_rho - r, r)
            keys.append(np.clip(t.astype(np.int64), 0, num_theta - 1)
                        * num_rho
                        + np.clip(r.astype(np.int64), 0, num_rho - 1))
    keys = np.sort(np.stack(keys, 1), 1)                 # (N, 9)
    first = np.ones(keys.shape, bool)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]           # each bin once
    slack = np.zeros(num_theta * num_rho)
    np.add.at(slack, keys[first],
              np.broadcast_to(mag[sel][:, None], keys.shape)[first])
    return int(sel.sum()), slack.reshape(num_theta, num_rho)


def _card_against_cpu(cf, on_card: tuple, on_cpu: tuple, opts) -> tuple:
    """One image's Hough accumulator and peaks on the card against the
    CPU's (each (acc, rho_max, image) from `_captured_accumulators`; the
    images equal). Each bin within 1e-5 of the largest (tol) plus the
    weight of the votes rounding may move into it (`rounding_slack`);
    each bin in one top K and not the other moved there by rounding: its
    support,
    on either device, within 2 tol and the two bins' slack of the
    smaller K-th support, of the least support a line needs, or of a
    3 x 3 neighbour's (both axes wrap, as in the non-max suppression).
    Returns (the votes rounding decides, the bins off by more than tol,
    the bins in one top K only, the card's line count, whether all
    held)."""
    if not np.array_equal(on_card[2], on_cpu[2]):
        raise AssertionError("orientation path: the card saw other pixels")
    n_edge, slack = rounding_slack(on_cpu[2], opts.num_theta_bins,
                                   opts.num_rho_bins)
    out = [(acc, cf._lines_from_accumulator(acc, rho_max, opts), rho_max)
           for acc, rho_max, _ in (on_card, on_cpu)]
    (a, la, rm), (b, lb, _) = out
    tol = 1e-5 * float(np.abs(b).max())
    gap = np.abs(a - b)
    bounded = bool((gap <= tol + slack).all())
    T, R = a.shape

    def bins(lines) -> list:
        return peak_bins(lines, rm, T, R)

    moved = set(bins(la)) ^ set(bins(lb))
    # where a bin enters one device's lines: its K-th support, or the
    # least support a line needs while it has fewer than K
    cuts = [(float(x[1][-1]), slack[bins(x)[-1]])
            if len(x[1]) == opts.num_lines else (opts.min_line_support, 0.0)
            for x in (la, lb)]

    def decided(k) -> bool:
        t, r = k
        near = [((t + dt) % T, (r + dr) % R) for dt in (-1, 0, 1)
                for dr in (-1, 0, 1) if dt or dr]
        return any(abs(x[k] - c) <= 2 * tol + slack[k] + s_c
                   for x in (a, b) for c, s_c in cuts) or any(
            abs(x[k] - x[n]) <= 2 * tol + slack[k] + slack[n]
            for x in (a, b) for n in near)

    bad = [(k, float(a[k]), float(b[k]), float(slack[k])) for k in moved
           if not decided(k)]
    if bad or not bounded:
        worst = np.unravel_index(np.argmax(gap - slack), gap.shape)
        print(f"    apart from the rounding rule: peaks {bad}, cut-offs "
              f"{[c for c, _ in cuts]}; largest gap over its slack at "
              f"{worst}: {gap[worst]:.6g} against {tol:.3g} + "
              f"{slack[worst]:.6g}", flush=True)
    return (n_edge, int((gap > tol).sum()), len(moved), len(la[0]),
            bounded and not bad)


def orientation_path(dev, card: str, rec, grey: dict, sc) -> dict:
    """model_orientation_aligner's body on the card: IMAGE-ORIENTATION
    on the photos path's model (the consensus down axis mapped onto
    +y within 1e-9; a rigid motion: ATE against the truth unchanged
    within 1e-9); MANHATTAN-WORLD on its images, and on `line_images`
    of the same model (lines through each camera's vanishing points of
    the world's axes, 1024 x 768), each then on the CPU from the same
    images (`_card_against_cpu`): each image's accumulator within 1e-5
    of its largest bin plus the weight of the votes that rounding may
    move (`rounding_slack`), each peak bin the CPU's but where such votes
    move it across the top K's cut-off or the non-max suppression, and
    the frames within 1e-4 rad; on the images of lines besides at most 8
    bins per image off by more than 1e-5 of the largest (as the card
    test), the same peak bins, at least 4 lines per image and the
    frame's down axis within 8 degrees of the world's y. Returns the
    launch counts (none expected)."""
    import copy

    from dagsfm_tpu_torch.estimation import coordinate_frame as cf
    from dagsfm_tpu_torch.pipeline import cli
    from dagsfm_tpu_torch.scene import synthetic

    t_path = time.perf_counter()
    print(f"== orientation path: model_orientation_aligner on the photos "
          f"path's model ({rec.num_reg_images()} images) and images",
          flush=True)
    torch.cuda.synchronize()
    _zero_counts()                                    # counts zeroed
    before = synthetic.pose_errors(rec, sc)
    aligned = copy.deepcopy(rec)
    t0 = time.perf_counter()
    tform, _ = cli.model_orientation_aligner(aligned, "image-orientation")
    t_io = time.perf_counter() - t0
    g = cf.estimate_gravity_vector_from_image_orientation(aligned)
    g_err = float(np.linalg.norm(g / np.linalg.norm(g) - [0.0, 1.0, 0.0]))
    after = synthetic.pose_errors(aligned, sc)
    ate_gap = abs(after["ate"] - before["ate"])

    secs, frames, peaks = {}, {}, {}
    opts = cf.ManhattanOptions()
    for kind, imgs in (("photos", grey), ("lines", line_images(rec))):
        manhattan, got = copy.deepcopy(rec), {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = _captured_accumulators(cf, lambda: got.update(
            frame=cli.model_orientation_aligner(
                manhattan, "manhattan-world", imgs, device=dev)[1]))
        secs[kind] = time.perf_counter() - t0
        frame = got["frame"]
        on_cpu = _captured_accumulators(cf, lambda: got.update(
            cpu=cf.estimate_manhattan_world_frame(rec, imgs, device="cpu")))
        frame_cpu = got["cpu"]
        if not len(on_card) == len(on_cpu) == len(rec.reg_image_ids):
            raise AssertionError("orientation path: an image went unseen")
        frames[kind] = (frame, _frame_angle(frame, frame_cpu))
        peaks[kind] = [_card_against_cpu(cf, a, b, opts)
                       for a, b in zip(on_card, on_cpu)]
    counts = _counts()                                # counts read
    print(f"  on {card}: orientation path {time.perf_counter() - t_path:.3f}"
          f" s; IMAGE-ORIENTATION {t_io:.3f} s, gravity onto +y within "
          f"{g_err:.3e}, ATE {before['ate']:.9f} -> {after['ate']:.9f}",
          flush=True)
    for kind in frames:
        edge, off, moved, lines, ok = zip(*peaks[kind])
        print(f"  on {card}: MANHATTAN-WORLD on the {kind} {secs[kind]:.3f} "
              f"s; per image: lines {list(lines)}, votes rounding decides "
              f"{list(edge)}, accumulator bins off by more than 1e-5 of the "
              f"largest {list(off)}, peak bins not the CPU's {list(moved)}; "
              f"all within the rounding rule: {all(ok)}; frame "
              f"{frames[kind][0].round(6).tolist()}, card against CPU "
              f"{frames[kind][1]:.3e} rad", flush=True)
    if not (g_err < 1e-9 and ate_gap < 1e-9):
        raise AssertionError(f"orientation path: gravity {g_err}, ATE gap "
                             f"{ate_gap}")
    if not all(p[-1] for kind in peaks for p in peaks[kind]) or not all(
            gap < 1e-4 for _, gap in frames.values()):
        raise AssertionError("orientation path: the card's Manhattan frame "
                             "is not the CPU's")
    _, off, moved, lines, _ = zip(*peaks["lines"])
    down = frames["lines"][0][:, 1]
    if max(off) > 8 or any(moved) or min(lines) < 4 \
            or abs(down @ [0.0, 1.0, 0.0]) < 0.99:
        raise AssertionError("orientation path: no Manhattan frame from the "
                             "images of lines")
    return counts


def _frame_angle(a: np.ndarray, b: np.ndarray) -> float:
    """The largest angle in rad between the frames' matching axes (an
    axis left empty must be empty in both)."""
    worst = 0.0
    for k in range(3):
        na, nb = np.linalg.norm(a[:, k]), np.linalg.norm(b[:, k])
        if (na == 0) != (nb == 0):
            return math.inf
        if na:
            c = float(np.clip(a[:, k] @ b[:, k] / (na * nb), -1, 1))
            worst = max(worst, math.acos(c))
    return worst


def solvers_path(dev, card: str, dist_state: dict) -> dict:
    """The solvers on the card. Rotation averaging on the distributed
    path's final view graph (the turned edges already dropped):
    estimate_rotations_lagrange_dual (the block SDP, SOLVER_SWEEPS sweeps
    of one update per image, timed) and estimate_rotations_nonlinear,
    each within 0.1 degree of the controller's L1-IRLS rotations; the
    SDP's rank-3 residual printed. Then l1_regression,
    constrained_l1 and box_qp on planted problems (the planted solution
    recovered), and robust_estimate with each sampler and both scorings
    on a planted line with a quarter outliers (the line and its inliers
    found). Returns the launch counts (none expected)."""
    from dagsfm_tpu_torch.estimation import lagrange_dual as ld
    from dagsfm_tpu_torch.ops import ransac_variants as rv

    ctrl = dist_state["ctrl"]
    vg = ctrl.view_graph
    ids = sorted(vg.nodes)
    print(f"== solvers path: SDP and nonlinear rotation averaging on the "
          f"distributed path's final view graph ({len(ids)} images, "
          f"{vg.num_edges()} edges), ADMM and the RANSAC variants on "
          f"planted problems", flush=True)
    torch.cuda.synchronize()
    _zero_counts()                                    # counts zeroed
    t_path = time.perf_counter()
    index = {v: k for k, v in enumerate(ids)}
    edges = np.array([(index[i], index[j]) for (i, j) in vg.edges])
    rels = np.stack([e.rotation for e in vg.edges.values()])
    R_l1 = np.stack([ctrl.global_rotations[v] for v in ids])
    R_l1 = np.einsum("nij,kj->nik", R_l1, R_l1[0])
    t0 = time.perf_counter()
    R_sdp, cert = ld.estimate_rotations_lagrange_dual(
        len(ids), edges, rels, sweeps=SOLVER_SWEEPS, device=dev)
    t_sdp = time.perf_counter() - t0
    t0 = time.perf_counter()
    R_nl = ld.estimate_rotations_nonlinear(len(ids), edges, rels,
                                           device=dev)
    torch.cuda.synchronize()
    t_nl = time.perf_counter() - t0
    gap_sdp = max(_angle_deg(a, b) for a, b in zip(R_sdp, R_l1))
    gap_nl = max(_angle_deg(a, b) for a, b in zip(R_nl, R_l1))
    print(f"  on {card}: SDP {SOLVER_SWEEPS} sweeps x {len(ids)} block "
          f"updates {t_sdp:.3f} s, rank-3 residual {cert:.6g}, max gap to "
          f"L1-IRLS {gap_sdp:.6f} deg; nonlinear {t_nl:.3f} s, max gap "
          f"{gap_nl:.6f} deg", flush=True)
    if not (gap_sdp < 0.1 and gap_nl < 0.1 and np.isfinite(cert)):
        raise AssertionError("solvers path: SDP or nonlinear rotations off "
                             "the L1-IRLS ones")
    _admm_step(dev, card)
    _ransac_variants_step(dev, card, rv)
    print(f"  on {card}: solvers path {time.perf_counter() - t_path:.3f} s",
          flush=True)
    return _counts()                                  # counts read


def _admm_step(dev, card: str) -> None:
    """l1_regression, constrained_l1 and box_qp on planted problems."""
    from dagsfm_tpu_torch.solvers import admm
    rng = np.random.default_rng(12)
    T = (lambda a: torch.as_tensor(a, device=dev))
    N, M = 50, 2000
    x_true = rng.normal(0, 1, N)
    A = rng.normal(0, 1, (M, N))
    b = A @ x_true
    out = rng.random(M) < 0.2
    b[out] += rng.uniform(5, 10, out.sum()) * rng.choice([-1, 1], out.sum())
    opts = admm.ADMMOptions(max_iterations=300)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, primal, dual = admm.l1_regression(T(A), T(b), opts)
    x = x.cpu().numpy()
    t_l1 = time.perf_counter() - t0
    x_ls = np.linalg.lstsq(A, b, rcond=None)[0]
    xc_true = np.abs(rng.normal(0, 1, N)) + 0.5
    bc = A @ xc_true
    t0 = time.perf_counter()
    xc = admm.constrained_l1(T(A), T(bc), T(np.eye(N)), T(np.full(N, 0.5)),
                             opts).cpu().numpy()
    t_c = time.perf_counter() - t0
    NQ = 15                  # tests/test_solvers.py's box QP
    Q = rng.normal(0, 1, (NQ, NQ))
    P = Q.T @ Q + np.eye(NQ)
    x_unc = rng.normal(0, 2, NQ)
    q = -P @ x_unc
    t0 = time.perf_counter()
    xq = admm.box_qp(T(P), T(q), T(np.full(NQ, -1.0)), T(np.full(NQ, 1.0)),
                     admm.ADMMOptions(max_iterations=400)).cpu().numpy()
    t_q = time.perf_counter() - t0
    g = P @ xq + q
    inside = (xq > -1 + 1e-3) & (xq < 1 - 1e-3)
    kkt = float(np.abs(g[inside]).max()) if inside.any() else 0.0
    # at a bound the gradient points out of the box (or is ~0)
    sign_ok = bool(np.all(g[xq <= -1 + 1e-3] > -0.05)
                   and np.all(g[xq >= 1 - 1e-3] < 0.05))
    print(f"  on {card}: l1_regression {M} x {N}, 20 % outliers, 300 "
          f"iterations {t_l1:.3f} s, error {np.abs(x - x_true).max():.2e} "
          f"(least squares {np.abs(x_ls - x_true).max():.2e}), residuals "
          f"{float(primal):.2e} / {float(dual):.2e}; constrained_l1 "
          f"{t_c:.3f} s, error {np.abs(xc - xc_true).max():.2e}; box_qp "
          f"{NQ} variables {t_q:.3f} s, KKT inside {kkt:.2e}, "
          f"{int((~inside).sum())} at a bound", flush=True)
    if not (np.abs(x - x_true).max() < 1e-2 and np.abs(xc - xc_true).max()
            < 1e-2 and (xc >= 0.5 - 1e-6).all() and kkt < 0.05 and sign_ok
            and (np.abs(xq) <= 1.0).all()):
        raise AssertionError("solvers path: an ADMM solve missed its "
                             "planted solution")


def _ransac_variants_step(dev, card: str, rv) -> None:
    """robust_estimate with each sampler and both scorings on y = 2x + 1
    with a quarter outliers (exhaustive on 16 points)."""
    def solver(xs, ys):
        a, b = ys[1] - ys[0], xs[0] - xs[1]
        c = -(a * xs[0] + b * ys[0])
        n = torch.sqrt(a * a + b * b)
        ok = n > 1e-9
        n = torch.clamp(n, min=1e-9)
        return torch.stack([a / n, b / n, c / n])[None], ok[None]

    def residual(m, xs, ys):
        return (m[0] * xs + m[1] * ys + m[2]) ** 2

    worst, t0 = [], time.perf_counter()
    for sampler in ("uniform", "prosac", "weighted", "exhaustive"):
        for scoring in ("msac", "lmeds"):
            n = 16 if sampler == "exhaustive" else 1000
            rng = np.random.default_rng(len(worst))
            x = rng.uniform(-5, 5, n)
            y = 2 * x + 1 + rng.normal(0, 0.01, n)
            out = rng.choice(n, n // 4, replace=False)
            y[out] += rng.uniform(2, 10, n // 4) * rng.choice([-1, 1], n // 4)
            inl = np.ones(n, bool)
            inl[out] = False
            quality = inl + rng.uniform(0, 0.3, n)
            res = rv.robust_estimate(
                solver, residual, (torch.as_tensor(x, device=dev),
                                   torch.as_tensor(y, device=dev)),
                torch.ones(n, dtype=torch.bool, device=dev), sample_size=2,
                threshold=0.01 if scoring == "msac" else 0.0,
                num_hypotheses=512, sampler=sampler, scoring=scoring,
                quality=torch.as_tensor(quality, device=dev),
                generator=torch.Generator(device=dev).manual_seed(7))
            m = res.model.cpu().numpy()
            slope, icpt = m[0] / -m[1], m[2] / -m[1]
            found = res.inliers.cpu().numpy()[inl].mean()
            worst.append(max(abs(slope - 2), abs(icpt - 1), 1 - found))
    torch.cuda.synchronize()
    print(f"  on {card}: robust_estimate, 4 samplers x 2 scorings, "
          f"{time.perf_counter() - t0:.3f} s; worst of |slope - 2|, "
          f"|intercept - 1|, inliers missed: {max(worst):.4f}", flush=True)
    if max(worst) >= 0.05:
        raise AssertionError(f"solvers path: robust_estimate missed the "
                             f"planted line ({worst})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-images", type=int, default=PLANTED_IMAGES,
                    help="images of the planted path")
    ap.add_argument("--max-features", type=int, default=8192,
                    help="SIFT max_num_features on the pixel and distorted "
                         "paths")
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
    cuda_build.load("fused_matcher", "top2_matcher", "minimal_nullspace",
                    "schur_matvec")                   # every nvcc at once
    mk.load_library()
    tm.load_library()
    print(f"== build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, info in cuda_build.build_info.items():
        print(f"  {name}: {'rebuilt' if info['rebuilt'] else 'cached'} in "
              f"{info['seconds']:.2f} s -> {info['path']}", flush=True)
        if info.get("ptxas"):
            print("  " + info["ptxas"].replace("\n", "\n  "), flush=True)

    work = tempfile.TemporaryDirectory()
    try:
        return _run(args, dev, card, mk, tm, t_start, work.name)
    finally:
        _stop(_STARTED)
        work.cleanup()


def _run(args, dev, card: str, mk, tm, t_start: float, work: str) -> int:
    """main()'s phases after the build; `work` outlives the database
    path for the commands path and the mapper process. Prints each
    phase's seconds on the host clock before the kernels' line."""
    secs, last = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        secs[name] = round(now - last[0], 3)
        last[0] = now

    k1 = kernel_phase(mk, dev, card)
    k2, k4, k3 = top2_phase(tm, dev, card)
    k5 = nullspace_phase(dev, card)
    k6 = schur_phase(dev, card)
    lap("kernel phases")
    tool = tool_path(card)
    lap("tool")
    if args.max_features != 8192:
        print(f"== pixel and distorted paths cut to max_num_features "
              f"{args.max_features} (default 8192)", flush=True)
    print(f"== pixel path cut to {PIXEL_IMAGES} images (30 until the "
          "commands and rig paths joined, 50 until the parallel path did, "
          "100 before the distorted path)", flush=True)
    pixel, _, _, px_images, px_sc = pixel_path(dev, card, PIXEL_IMAGES,
                                               args.max_features)
    lap("pixel")
    photos, photo_rec, photo_grey, photo_proc = photos_path(
        dev, card, px_images, px_sc, work)
    lap("photos")
    orientation = orientation_path(dev, card, photo_rec, photo_grey, px_sc)
    lap("orientation")
    del px_images, photo_rec, photo_grey
    print(f"== distorted path cut to {DISTORTED_IMAGES} images (80 until "
          "the retrieval path joined, 100 until the distributed path did)",
          flush=True)
    distorted, fp, rec, images, sc = pixel_path(
        dev, card, DISTORTED_IMAGES, args.max_features, distorted=True)
    lap("distorted")
    dense = dense_path(dev, card, rec, images, sc)
    lap("dense")
    del rec, images, sc
    entry = entry_path(fp, dev, card)
    lap("entry")
    modes = pair_modes_step(fp, dev, card)
    lap("retrieval (b)")
    del fp
    print(f"== planted path cut to {args.num_images} images (100 until the "
          "distributed path joined)", flush=True)
    planted = main_path(dev, card, args.num_images)
    lap("planted")
    dist, dist_state = distributed_path(dev, card)
    lap("distributed")
    solvers = solvers_path(dev, card, dist_state)
    lap("solvers")
    database, db_state = database_path(dev, card, work)
    lap("database")
    commands = commands_path(dev, card, db_state)
    lap("commands")
    retrieval = retrieval_path(dev, card, modes)
    lap("retrieval (a), (c)")
    bapath, ba_state = ba_path(dev, card)
    lap("ba")
    parallel = parallel_path(dev, card, dist_state, ba_state)
    lap("parallel")
    del dist_state, ba_state
    rig = rig_path(dev, card)
    lap("rig")
    tools = tools_path(dev, card)
    lap("tools")
    finish_mapper(card, db_state)
    lap("mapper process, the rest")
    if photo_proc:
        photos_process(card, *photo_proc, px_sc)
        lap("photos process")
    print(f"== seconds per phase, in order: {secs}", flush=True)
    paths = {"tool": tool, "planted": planted, "pixel": pixel,
             "photos": photos, "orientation": orientation,
             "distorted": distorted, "dense": dense, "entry": entry,
             "distributed": dist, "solvers": solvers, "database": database,
             "commands": commands, "retrieval": retrieval, "ba": bapath,
             "parallel": parallel, "rig": rig, "tools": tools}
    for e, path in ((k1, "distorted"), (k2, "entry"), (k3, "entry"),
                    (k4, "tool")):
        e["launches"] = paths[path][e["name"]]
        e["launches_by_path"] = {p: c[e["name"]] for p, c in paths.items()}
        if not e["launches"]:
            raise AssertionError(f"{e['name']} never launched on its path")
    for path in ("retrieval", "photos", "tools"):
        if not paths[path]["fused_matcher"]:
            raise AssertionError(f"K1 never launched on the {path} path")
    k5["launches"] = planted["minimal_nullspace"]
    k5["launches_by_path"] = {"planted": k5["launches"]}
    k6["launches"] = bapath["schur_matvec"]
    k6["launches_by_path"] = {"ba": k6["launches"]}
    if not k6["launches"]:
        raise AssertionError("the BA path launched no schur_matvec")
    print(f"== whole run {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
