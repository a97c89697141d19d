"""dagsfm_tpu_torch — the PyTorch / CUDA port of dagsfm_tpu for NVIDIA Hopper.

The JAX package `dagsfm_tpu` is the reference; this package mirrors its
subpackages and module names so each counterpart sits at the same path.
It imports `torch` and numpy only — never `jax`, never `dagsfm_tpu`.

Ported so far (the per-cluster reconstruction from rendered pixels, the
distributed mapper around it, COLMAP's database workflow, the parallel
layer, pair selection, the dense path, the model and database commands,
and camera rigs):
  ops/       — rotations, polynomials, triangulation, epipolar (E, F, H),
               RANSAC with injectable sampling, Umeyama, P3P, EPnP,
               pose refinement, projection, E/F/H two-view classification,
               generalized (rig) absolute and relative pose,
               NaN-on-failure solves, and every TPU kernel as CUDA
               (csrc/): the fused matcher K1 and the top-2 matchers
               K2-K4, built by ops/cuda_build.py
  scene/     — all eleven camera models (distortion, Newton
               undistortion, the BA intrinsics increment),
               reconstruction containers, COLMAP .bin
               I/O, synthetic scenes and rendered images, camera rigs
  features/  — SIFT, descriptor bank, exhaustive pair matching, guided
               matching
  sfm/       — correspondence graph, bundle adjustment (dense Schur and
               iterative PCG, each also joint with the intrinsics),
               incremental mapper (focal grid for cameras without a
               prior), Sim(3) cluster merge (aligner), track selection,
               rig bundle adjustment
  graph/     — view graph (components, spanning tree, rotation-cycle
               filter) and ctypes bindings of native/build/libgraphcore.so
  clustering/ — spectral clustering on the device, community detection,
               cut-and-expand ImageClustering
  estimation/ — global rotation averaging (L1 + IRLS over a matrix-free
               CG)
  pipeline/  — FeaturePipeline (extract + match + verify + mapper inputs),
               DistributedMapperController, and the CLI
               (`python -m dagsfm_tpu_torch <command>`, cli.py)
  parallel/  — torch.distributed process groups (NCCL on the card, gloo
               on the CPU), lease-coordinated mapping and matching jobs
               for worker processes, clusters on threads, and the sharded
               final BA and pair matching
  tools/     — matcher_mfu, the matcher's stage split on the card
  utils/     — GPS conversions, project options (.ini files, presets)
  interop.py — turns the JAX package's state (numpy / dicts) into the
               port's containers

Entry points run on `cuda` unless the caller passes `device="cpu"`; with
no GPU and no explicit CPU request they raise (see `device.resolve`).
"""

import torch

# TF32 keeps ~3 decimal digits: every f32 product in the port is full f32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
