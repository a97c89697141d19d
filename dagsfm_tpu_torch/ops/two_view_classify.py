"""Two-view verification, essential-matrix path.

Port of the calibrated, essential-only path of
dagsfm_tpu/ops/two_view_classify.py: config values (COLMAP
two_view_geometry.h), `TwoViewOptions`, `TwoViewResult`,
`classify_pairs` over the essential RANSAC batch (`_e_batched`, the pair
batch written out as a dimension) and `_select_model` for calibrated
pairs. Full E/F/H classification and watermark detection wait: a pair
that would need them raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.ops import epipolar as epi
from dagsfm_tpu_torch.ops import ransac as rnsc

DEGENERATE = 1
CALIBRATED = 2
UNCALIBRATED = 3
PLANAR = 4
PANORAMIC = 5
PLANAR_OR_PANORAMIC = 6
WATERMARK = 7

_BATCH_ELEMS = 1 << 16   # correspondences per verification batch


@dataclasses.dataclass
class TwoViewOptions:
    min_num_inliers: int = 15
    max_error_px: float = 4.0
    num_hypotheses: int = 256
    essential_only: bool = False


class TwoViewResult(NamedTuple):
    config: int
    E: np.ndarray | None
    F: np.ndarray | None
    H: np.ndarray | None
    R: np.ndarray | None
    t: np.ndarray | None
    inlier_mask: np.ndarray
    num_inliers: int


def ransac_essential(x1, x2, mask, thr, sample_idx):
    """5-point LO-RANSAC for a batch of pairs: x1, x2 (B, N, 2), mask
    (B, N), thr (B,) squared Sampson threshold, sample_idx (B, H, 5)."""
    return rnsc.ransac(
        solver=epi.essential_5pt,
        residual_fn=lambda E, a, b: epi.sampson_error(E, a[:, None],
                                                      b[:, None]),
        data=(x1, x2), mask=mask, sample_idx=sample_idx, threshold=thr,
        refit=lambda a, b, inl: epi.essential_8pt(a, b, mask=inl)[0][:, 0])


def _e_batched(generator, x1, x2, mask, thr_n, num_hyps):
    """Essential-only RANSAC + pose for a batch of pairs."""
    idx = rnsc.sample_indices(generator, mask, num_hyps, 5)
    res = ransac_essential(x1, x2, mask, thr_n, idx)
    R, t, nf = epi.pose_from_essential(res.model, x1, x2, res.inliers)
    return res.model, res.num_inliers, res.inliers, R, t, nf


def classify_pairs(pair_data: list, options: TwoViewOptions = TwoViewOptions(),
                   seed: int = 0, device=None) -> dict:
    """Verify many pairs. pair_data rows: (pair_key, pix1 (M,2), pix2 (M,2),
    K1, K2, image_size1, image_size2, calibrated). Returns pair_key ->
    TwoViewResult. Pairs run in batches of about _BATCH_ELEMS
    correspondences (pairs x longest pair in the batch)."""
    dev = devmod.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out, rows = {}, []
    for (pk, pix1, pix2, K1, K2, sz1, sz2, calibrated) in pair_data:
        n = len(pix1)
        if n < max(options.min_num_inliers, 8):
            out[pk] = TwoViewResult(DEGENERATE, None, None, None, None,
                                    None, np.zeros(n, bool), 0)
            continue
        if not (options.essential_only and calibrated):
            raise NotImplementedError(
                "only the calibrated essential-only path is ported")
        x1 = (pix1 - K1[:2, 2]) / np.array([K1[0, 0], K1[1, 1]])
        x2 = (pix2 - K2[:2, 2]) / np.array([K2[0, 0], K2[1, 1]])
        f_mean = (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) / 4.0
        rows.append((pk, x1, x2, (options.max_error_px / f_mean) ** 2, K1, K2))

    rows.sort(key=lambda r: len(r[1]))        # similar lengths batch together
    s = 0
    while s < len(rows):
        e = s + 1
        while e < len(rows) and (e - s + 1) * len(rows[e][1]) <= _BATCH_ELEMS:
            e += 1
        chunk = rows[s:e]
        s = e
        N = max(len(r[1]) for r in chunk)
        B = len(chunk)
        x1b = np.zeros((B, N, 2))
        x2b = np.zeros((B, N, 2))
        mb = np.zeros((B, N), bool)
        for k, r in enumerate(chunk):
            n = len(r[1])
            x1b[k, :n], x2b[k, :n], mb[k, :n] = r[1], r[2], True
        thr = devmod.as_tensor([r[3] for r in chunk], dev)
        E, nE, inlE, R, t, _nf = _e_batched(
            gen, devmod.as_tensor(x1b, dev), devmod.as_tensor(x2b, dev),
            torch.as_tensor(mb, device=dev), thr, options.num_hypotheses)
        E, nE, inlE = E.cpu().numpy(), nE.cpu().numpy(), inlE.cpu().numpy()
        R, t = R.cpu().numpy(), t.cpu().numpy()
        for k, (pk, x1, x2, _thr, K1, K2) in enumerate(chunk):
            out[pk] = _select_model(K1, K2, options, E=E[k], nE=int(nE[k]),
                                    inlE=inlE[k][: len(x1)], R_E=R[k],
                                    t_E=t[k])
    return out


def _select_model(K1, K2, options: TwoViewOptions, *, E, nE, inlE, R_E,
                  t_E) -> TwoViewResult:
    """The reference's model selection for a calibrated pair whose F and
    H RANSACs did not run (nF = nH = 0): CALIBRATED when E has enough
    inliers, else DEGENERATE."""
    if nE < options.min_num_inliers:
        return TwoViewResult(DEGENERATE, None, None, None, None, None,
                             np.zeros(len(inlE), bool), 0)
    F = np.linalg.inv(np.asarray(K2)).T @ np.asarray(E) @ \
        np.linalg.inv(np.asarray(K1))
    return TwoViewResult(CALIBRATED, np.asarray(E), F, None, np.asarray(R_E),
                         np.asarray(t_E), np.asarray(inlE, bool), nE)
