"""dagsfm_tpu_torch — the PyTorch / CUDA port of dagsfm_tpu for NVIDIA Hopper.

The JAX package `dagsfm_tpu` is the reference; this package mirrors its
subpackages and module names so each counterpart sits at the same path.
It imports `torch` and numpy only — never `jax`, never `dagsfm_tpu`.

Ported so far (the per-cluster reconstruction from extracted features):
  ops/       — rotations, polynomials, triangulation, epipolar (E only),
               RANSAC with injectable sampling, Umeyama, P3P + pose
               refinement, projection, essential-only two-view
               classification, and the fused matcher kernel (CUDA, csrc/)
  scene/     — pinhole cameras, reconstruction containers, COLMAP .bin
               I/O, synthetic scenes
  features/  — descriptor bank + exhaustive pair matching
  sfm/       — correspondence graph, dense-Schur bundle adjustment,
               incremental mapper
  pipeline/  — FeaturePipeline (match + verify + mapper inputs)
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
