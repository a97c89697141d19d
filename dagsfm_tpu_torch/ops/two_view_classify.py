"""Two-view geometry classification: E/F/H model selection + degeneracy.

Port of dagsfm_tpu/ops/two_view_classify.py: the config values (COLMAP
two_view_geometry.h), `TwoViewOptions`, `TwoViewResult`, `classify_pairs`
over batched E, F and H RANSACs (`_efh_batched`, the pair batch written
out as a dimension) or the essential-only batch (`_e_batched`), the host
model selection `_select_model` (calibrated / uncalibrated / planar /
panoramic / watermark), `classify_two_view` and `pose_from_homography`.

RANSAC sampling is split from solving (ops/ransac.py): the batch functions
take their minimal-sample indices, and `classify_pairs` draws them from a
`torch.Generator`.
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

CONFIG_NAMES = {
    DEGENERATE: "DEGENERATE", CALIBRATED: "CALIBRATED",
    UNCALIBRATED: "UNCALIBRATED", PLANAR: "PLANAR",
    PANORAMIC: "PANORAMIC", PLANAR_OR_PANORAMIC: "PLANAR_OR_PANORAMIC",
    WATERMARK: "WATERMARK",
}

_BATCH_ELEMS = 1 << 16   # correspondences per verification batch
SAMPLE_SIZES = {"E": 5, "F": 7, "H": 4}


@dataclasses.dataclass
class TwoViewOptions:
    min_num_inliers: int = 15
    max_error_px: float = 4.0
    max_h_inlier_ratio: float = 0.8      # H/E ratio for the planar flag
    watermark_min_inlier_ratio: float = 0.7
    watermark_border_size: float = 0.1
    detect_watermark: bool = True
    num_hypotheses: int = 256
    compute_relative_pose: bool = True
    # calibrated pairs run only the essential-matrix RANSAC
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


def _sampson(models, a, b):
    return epi.sampson_error(models, a[:, None], b[:, None])


def ransac_essential(x1, x2, mask, thr, sample_idx):
    """5-point LO-RANSAC for a batch of pairs: x1, x2 (B, N, 2), mask
    (B, N), thr (B,) squared Sampson threshold, sample_idx (B, H, 5)."""
    return rnsc.ransac(
        solver=epi.essential_5pt, residual_fn=_sampson, data=(x1, x2),
        mask=mask, sample_idx=sample_idx, threshold=thr,
        refit=lambda a, b, inl: epi.essential_8pt(a, b, mask=inl)[0][:, 0])


def ransac_fundamental(p1, p2, mask, thr, sample_idx):
    """7-point LO-RANSAC on pixels, 8-point refit; sample_idx (B, H, 7)."""
    return rnsc.ransac(
        solver=epi.fundamental_7pt, residual_fn=_sampson, data=(p1, p2),
        mask=mask, sample_idx=sample_idx, threshold=thr,
        refit=lambda a, b, inl: epi.fundamental_8pt(a, b, mask=inl)[0][:, 0])


def ransac_homography(p1, p2, mask, thr, sample_idx):
    """4-point DLT LO-RANSAC on pixels; sample_idx (B, H, 4)."""
    return rnsc.ransac(
        solver=epi.homography_dlt,
        residual_fn=lambda Hs, a, b: epi.homography_error(Hs, a[:, None],
                                                          b[:, None]),
        data=(p1, p2), mask=mask, sample_idx=sample_idx, threshold=thr,
        refit=lambda a, b, inl: epi.homography_dlt(a, b, mask=inl)[0][:, 0])


def draw_samples(generator, mask, num_hyps: int, kinds: str = "EFH") -> dict:
    """{kind: (B, H, S) sample indices} for each RANSAC of `kinds`."""
    return {k: rnsc.sample_indices(generator, mask, num_hyps,
                                   SAMPLE_SIZES[k]) for k in kinds}


def _efh_batched(x1, x2, p1, p2, mask, thr_n, thr_p, K1b, K2b, samples):
    """E + F + H RANSAC for a batch of pairs, with both pose recoveries
    (from E, and from F upgraded to E with the intrinsics).

    x1, x2 (B, N, 2) normalized; p1, p2 (B, N, 2) pixels; mask (B, N);
    thr_n, thr_p (B,) squared thresholds; K1b, K2b (B, 3, 3); samples
    {"E": (B, H, 5), "F": (B, H, 7), "H": (B, H, 4)} indices. Returns the
    reference's 14 outputs: E, nE, inlE, R, t, nf, F, nF, inlF, H, nH,
    inlH, R_F, t_F."""
    resE = ransac_essential(x1, x2, mask, thr_n, samples["E"])
    resF = ransac_fundamental(p1, p2, mask, thr_p, samples["F"])
    resH = ransac_homography(p1, p2, mask, thr_p, samples["H"])
    R, t, nf = epi.pose_from_essential(resE.model, x1, x2, resE.inliers)
    E_up = K2b.transpose(-1, -2) @ resF.model @ K1b
    R_F, t_F, _ = epi.pose_from_essential(E_up, x1, x2, resF.inliers)
    return (resE.model, resE.num_inliers, resE.inliers, R, t, nf,
            resF.model, resF.num_inliers, resF.inliers,
            resH.model, resH.num_inliers, resH.inliers, R_F, t_F)


def _e_batched(x1, x2, mask, thr_n, samples):
    """Essential-only RANSAC + pose for a batch of pairs."""
    res = ransac_essential(x1, x2, mask, thr_n, samples["E"])
    R, t, nf = epi.pose_from_essential(res.model, x1, x2, res.inliers)
    return res.model, res.num_inliers, res.inliers, R, t, nf


def classify_pairs(pair_data: list, options: TwoViewOptions = TwoViewOptions(),
                   seed: int = 0, device=None) -> dict:
    """Full E/F/H model-selected verification of many pairs.

    pair_data rows: (pair_key, pix1 (M,2), pix2 (M,2), K1, K2,
    image_size1, image_size2, calibrated). Returns pair_key ->
    TwoViewResult. With `essential_only`, calibrated pairs run the
    essential RANSAC alone. Pairs run in batches of about _BATCH_ELEMS
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
        x1 = (pix1 - K1[:2, 2]) / np.array([K1[0, 0], K1[1, 1]])
        x2 = (pix2 - K2[:2, 2]) / np.array([K2[0, 0], K2[1, 1]])
        f_mean = (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) / 4.0
        kind = "e" if (options.essential_only and calibrated) else "efh"
        rows.append((kind, pk, (pix1, pix2, x1, x2,
                                (options.max_error_px / f_mean) ** 2,
                                options.max_error_px ** 2, K1, K2, sz1, sz2,
                                calibrated)))

    for kind in ("e", "efh"):
        group = sorted((r for r in rows if r[0] == kind),
                       key=lambda r: len(r[2][0]))
        s = 0
        while s < len(group):
            e = s + 1
            while e < len(group) and \
                    (e - s + 1) * len(group[e][2][0]) <= _BATCH_ELEMS:
                e += 1
            chunk = group[s:e]
            s = e
            for pk, res in _run_chunk(kind, chunk, options, gen, dev):
                out[pk] = res
    return out


def _run_chunk(kind, chunk, options, gen, dev):
    N = max(len(r[2][0]) for r in chunk)
    B = len(chunk)
    arr = {k: np.zeros((B, N, 2)) for k in ("x1", "x2", "p1", "p2")}
    mb = np.zeros((B, N), bool)
    for k, (_, _, p) in enumerate(chunk):
        n = len(p[0])
        arr["p1"][k, :n], arr["p2"][k, :n] = p[0], p[1]
        arr["x1"][k, :n], arr["x2"][k, :n] = p[2], p[3]
        mb[k, :n] = True
    T = {k: devmod.as_tensor(v, dev) for k, v in arr.items()}
    mask = torch.as_tensor(mb, device=dev)
    thr_n = devmod.as_tensor([r[2][4] for r in chunk], dev)
    if kind == "e":
        samples = draw_samples(gen, mask, options.num_hypotheses, "E")
        res = _e_batched(T["x1"], T["x2"], mask, thr_n, samples)
        # F and H did not run: with nF = nH = 0 neither can be selected
        z = (lambda *s: torch.zeros((B,) + s))
        res = res + (z(3, 3), z(), z(N).bool(), z(3, 3), z(), z(N).bool(),
                     z(3, 3), z(3))
    else:
        thr_p = devmod.as_tensor([r[2][5] for r in chunk], dev)
        K1b = devmod.as_tensor(np.stack([r[2][6] for r in chunk]), dev)
        K2b = devmod.as_tensor(np.stack([r[2][7] for r in chunk]), dev)
        samples = draw_samples(gen, mask, options.num_hypotheses)
        res = _efh_batched(T["x1"], T["x2"], T["p1"], T["p2"], mask, thr_n,
                           thr_p, K1b, K2b, samples)
    res = [r.cpu().numpy() for r in res]
    results = []
    for k, (_, pk, p) in enumerate(chunk):
        n = len(p[0])
        results.append((pk, _select_model(
            *p[:4], *p[6:11], options, E=res[0][k], nE=int(res[1][k]),
            inlE=res[2][k][:n], R_E=res[3][k], t_E=res[4][k],
            nf=int(res[5][k]), F=res[6][k], nF=int(res[7][k]),
            inlF=res[8][k][:n], H=res[9][k], nH=int(res[10][k]),
            inlH=res[11][k][:n], R_F=res[12][k], t_F=res[13][k])))
    return results


def _select_model(pix1, pix2, x1, x2, K1, K2, image_size1, image_size2,
                  calibrated, options, *, E, nE, inlE, R_E, t_E, nf,
                  F, nF, inlF, H, nH, inlH, R_F, t_F) -> TwoViewResult:
    """Model selection from the E/F/H RANSAC results (host; COLMAP's
    two_view_geometry flow with planar / panoramic / watermark)."""
    n = len(pix1)
    if calibrated and nE >= options.min_num_inliers and nE >= nF:
        config, num_inl, inliers = CALIBRATED, nE, inlE
    elif nF >= options.min_num_inliers:
        config, num_inl, inliers = UNCALIBRATED, nF, inlF
    elif nH >= options.min_num_inliers:
        config, num_inl, inliers = PLANAR_OR_PANORAMIC, nH, inlH
    else:
        return TwoViewResult(DEGENERATE, None, None, None, None, None,
                             np.zeros(n, bool), 0)

    if config in (CALIBRATED, UNCALIBRATED) and \
            nH > options.max_h_inlier_ratio * num_inl:
        config, num_inl, inliers = PLANAR_OR_PANORAMIC, nH, inlH

    inliers = np.asarray(inliers, bool)

    # watermark: a homography that is a pure translation in the border
    if options.detect_watermark and config == PLANAR_OR_PANORAMIC:
        d = pix2[inliers] - pix1[inliers]
        if len(d) >= options.min_num_inliers:
            spread = np.abs(d - d.mean(0)).mean()
            w1, h1 = image_size1
            bx = options.watermark_border_size * w1
            by = options.watermark_border_size * h1
            pin = pix1[inliers]
            in_border = ((pin[:, 0] < bx) | (pin[:, 0] > w1 - bx)
                         | (pin[:, 1] < by) | (pin[:, 1] > h1 - by))
            if spread < 1.0 and in_border.mean() > \
                    options.watermark_min_inlier_ratio:
                config = WATERMARK

    R = t = None
    E_out = F_out = H_out = None
    if config == CALIBRATED:
        E_out = np.asarray(E)
        if options.compute_relative_pose:
            R, t = np.asarray(R_E), np.asarray(t_E)
        F_out = np.linalg.inv(np.asarray(K2)).T @ np.asarray(E) @ \
            np.linalg.inv(np.asarray(K1))
    elif config == UNCALIBRATED:
        F_out = np.asarray(F)
        if options.compute_relative_pose:
            R, t = np.asarray(R_F), np.asarray(t_F)
    elif config in (PLANAR_OR_PANORAMIC, PLANAR, PANORAMIC, WATERMARK):
        H_out = np.asarray(H)
        if options.compute_relative_pose and config != WATERMARK:
            Hn = np.linalg.inv(K2) @ H_out @ K1
            R, t, _ = pose_from_homography(Hn, x1[inliers], x2[inliers])
            config = PANORAMIC if np.linalg.norm(t) < 1e-4 else PLANAR

    return TwoViewResult(config, E_out, F_out, H_out, R, t, inliers, num_inl)


def classify_two_view(pix1, pix2, K1, K2, image_size1: tuple,
                      image_size2: tuple,
                      options: TwoViewOptions = TwoViewOptions(),
                      calibrated: bool = True, seed: int = 0,
                      device=None) -> TwoViewResult:
    """Full two-view estimation with model selection for ONE pair: pix1,
    pix2 (N, 2) pixels; image_size = (width, height)."""
    return classify_pairs(
        [(0, np.asarray(pix1, float), np.asarray(pix2, float), K1, K2,
          image_size1, image_size2, calibrated)],
        options=options, seed=seed, device=device)[0]


def pose_from_homography(Hn: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """(R, t, count) from a calibrated homography: the SVD decomposition's
    eight candidates, the one with the most points in front of both
    cameras (closed-form two-view depths). Host numpy."""
    U, S, Vt = np.linalg.svd(Hn)
    H = Hn / S[1]
    s = np.linalg.det(U) * np.linalg.det(Vt)
    d1, d2, d3 = S / S[1]
    if abs(d1 - d3) < 1e-9:   # pure rotation
        return H * np.sign(np.linalg.det(H)), np.zeros(3), len(x1)
    x1_ = np.sqrt(max((d1 ** 2 - 1.0), 0) / max(d1 ** 2 - d3 ** 2, 1e-12))
    x3_ = np.sqrt(max((1.0 - d3 ** 2), 0) / max(d1 ** 2 - d3 ** 2, 1e-12))
    sin_t = np.sqrt(max((d1 ** 2 - 1.0) * (1.0 - d3 ** 2), 0)) \
        / max(d1 * d3, 1e-12) if d1 * d3 > 0 else 0.0
    cos_t = (d1 * d3 + 1.0) / max(d1 + d3, 1e-12) \
        if (d1 + d3) > 0 else 1.0
    cands = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            Rp = np.array([[cos_t, 0, -e1 * e3 * sin_t],
                           [0, 1, 0],
                           [e1 * e3 * sin_t, 0, cos_t]])
            tp = (d1 - d3) * np.array([e1 * x1_, 0.0, -e3 * x3_])
            R = s * U @ Rp @ Vt
            t = U @ tp
            cands.append((R, t))
            cands.append((R, -t))
    h1 = np.concatenate([x1, np.ones((len(x1), 1))], axis=1)
    h2 = np.concatenate([x2, np.ones((len(x2), 1))], axis=1)
    best = None
    best_count = -1
    for (R, t) in cands:
        if len(x1) == 0:
            best = (R, t)
            break
        a = h1 @ R.T
        b = -h2
        aa = np.sum(a * a, axis=1)
        ab = np.sum(a * b, axis=1)
        bb = np.sum(b * b, axis=1)
        at = a @ (-t)
        bt = b @ (-t)
        det = aa * bb - ab * ab
        det = np.where(np.abs(det) < 1e-12, 1e-12, det)
        z1 = (at * bb - ab * bt) / det
        z2 = (aa * bt - ab * at) / det
        count = int(((z1 > 0) & (z2 > 0)).sum())
        if count > best_count:
            best_count = count
            best = (R, t)
    R, t = best
    nt = np.linalg.norm(t)
    if nt > 1e-12:
        t = t / nt
    return R, t, best_count
