"""Essential-matrix verification of many pairs at once.

Port of dagsfm_tpu/sfm/two_view.py::verify_pairs: per pair, 5-point
LO-RANSAC (8-point refit) on normalised correspondences, then the pose
with the most points in front of both cameras. The reference runs the
pairs one by one, each padded to a power-of-two bucket of at least 64 (a
TPU shape workaround); here pairs of similar length run together on the
device, each padded to the longest in its batch, with padding masked.

Sampling is split from solving: `verify_pairs` takes each pair's (H, 5)
sample indices, or draws them from one `torch.Generator` seeded with
`seed`, pair by pair in list order (`_draw_samples`).
"""

from __future__ import annotations

import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.ops import ransac as rnsc
from dagsfm_tpu_torch.ops import two_view_classify as tvc

SAMPLE_SIZE = 5


def _draw_samples(generator: torch.Generator, pair_data: list,
                  num_hyps: int) -> list:
    """(H, 5) sample indices per pair, drawn in list order over the pair's
    max(n, 5) rows (rows past n are padding)."""
    dev = generator.device
    out = []
    for (_, a, _, _) in pair_data:
        n = len(a)
        mask = torch.zeros((1, max(n, SAMPLE_SIZE)), dtype=torch.bool,
                           device=dev)
        mask[0, :n] = True
        out.append(rnsc.sample_indices(generator, mask, num_hyps,
                                       SAMPLE_SIZE)[0])
    return out


def verify_pairs(pair_data: list, num_hyps: int = 256, seed: int = 0,
                 sample_idx: list | None = None, device=None) -> dict:
    """Verify many pairs with the essential matrix.

    pair_data: list of (pair_key, x1 (M, 2), x2 (M, 2), thr): normalised
    coordinates and the squared Sampson threshold. sample_idx: one (H, 5)
    index array per pair (indices below max(M, 5)), or None to draw them.
    Returns pair_key -> (R (3, 3), t (3,), num_inliers, num_in_front,
    inlier_mask (M,), valid), numpy and Python values."""
    dev = devmod.resolve(device)
    if sample_idx is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        sample_idx = _draw_samples(gen, pair_data, num_hyps)
    if len(sample_idx) != len(pair_data):
        raise ValueError("verify_pairs: one sample_idx per pair")
    out = {}
    for chunk in tvc.length_batches([max(len(pd[1]), SAMPLE_SIZE)
                                     for pd in pair_data], tvc.BATCH_ELEMS):
        for k, res in zip(chunk, _verify_chunk(
                [pair_data[k] for k in chunk], [sample_idx[k] for k in chunk],
                dev)):
            out[pair_data[k][0]] = res
    return {pd[0]: out[pd[0]] for pd in pair_data}


def _verify_chunk(chunk: list, samples: list, dev) -> list:
    (x1, x2), mask = tvc.pad_pairs([(a, b) for (_, a, b, _) in chunk], dev,
                                   SAMPLE_SIZE)
    idx = torch.stack([torch.as_tensor(si, dtype=torch.int64, device=dev)
                       for si in samples])
    if int(idx.max()) >= mask.shape[1]:
        raise ValueError("verify_pairs: a sample index past its pair")
    thr = devmod.as_tensor([float(t) for (_, _, _, t) in chunk], dev)
    res, R, t, nf = tvc._e_batched(x1, x2, mask, thr, {"E": idx})
    R, t, nf, ninl, inl, valid = (v.cpu().numpy() for v in (
        R, t, nf, res.num_inliers, res.inliers, res.valid))
    return [(R[k], t[k], int(ninl[k]), int(nf[k]), inl[k, :len(a)],
             bool(valid[k])) for k, (_, a, _, _) in enumerate(chunk)]
