"""Split full two-view classification into its parts, on the card.

    python -m dagsfm_tpu_torch.tools.profile_two_view [--out PATH]
        [--device cuda|cpu]

Counterpart of tools/profile_two_view.py, on its 64 planted pairs of 256
correspondences (`make_pairs`, the reference's numpy draws, so the pairs
are its own bit for bit) at the default TwoViewOptions (256
hypotheses). It times, each as a mean over 3 calls after a warm-up:

  * `classify_pairs` whole (host clock, sample draws, RANSACs, fetch and
    model selection);
  * the device batches `_efh_batched` (E, F and H RANSAC with both pose
    recoveries) and `_e_batched` (E alone), and `ransac_essential`,
    `ransac_fundamental` and `ransac_homography` each alone, on samples
    from `draw_samples` (device ms from CUDA events on the card);
  * `draw_samples` itself, and the 5-point solver's nullspace alone
    (`epipolar._nullspace_k` on the E samples' 5 x 9 systems, one
    launch of ops/nullspace_kernel on the card);
  * the host `_select_model` loop over the batch's fetched results;
  * `_efh_batched` with the fetch of its 14 outputs (host clock).

Prints one JSON object on stdout, the card's name and power limit in it.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from dagsfm_tpu_torch.tools import common

REPS = 3


def make_pairs(n_pairs: int = 64, npts: int = 256, seed: int = 3) -> list:
    """The reference tool's pairs: points in a box in front of camera 1, a
    small random rotation and translation for camera 2, 0.5 px noise;
    rows as classify_pairs takes them."""
    rng = np.random.default_rng(seed)
    K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    pair_data = []
    for k in range(n_pairs):
        X = rng.uniform([-2, -2, 4], [2, 2, 8], (npts, 3))
        aa = rng.normal(0, 0.1, 3)
        th = np.linalg.norm(aa)
        ax = aa / max(th, 1e-9)
        ct, st = np.cos(th), np.sin(th)
        R = (ct * np.eye(3) + st * np.cross(np.eye(3), ax)
             + (1 - ct) * np.outer(ax, ax))
        t = rng.normal(0, 0.3, 3)
        x1 = X @ K.T
        x1 = x1[:, :2] / x1[:, 2:]
        x2 = (X @ R.T + t) @ K.T
        x2 = x2[:, :2] / x2[:, 2:]
        x1 += rng.normal(0, 0.5, x1.shape)
        x2 += rng.normal(0, 0.5, x2.shape)
        pair_data.append(((k, k + 1000), x1, x2, K, K,
                          (640, 480), (640, 480), True))
    return pair_data


def batch(pair_data: list, opts, dev) -> dict:
    """classify_pairs' device inputs for one batch of the pairs."""
    from dagsfm_tpu_torch import device as devmod
    from dagsfm_tpu_torch.ops import two_view_classify as tvc
    rows = []
    for (_pk, pix1, pix2, K1, K2, _s1, _s2, _c) in pair_data:
        x1 = (pix1 - K1[:2, 2]) / np.array([K1[0, 0], K1[1, 1]])
        x2 = (pix2 - K2[:2, 2]) / np.array([K2[0, 0], K2[1, 1]])
        rows.append((pix1, pix2, x1, x2))
    (p1, p2, x1, x2), mask = tvc.pad_pairs(rows, dev)
    f = np.array([r[3][0, 0] for r in pair_data])
    K = devmod.as_tensor(np.stack([r[3] for r in pair_data]), dev)
    return {"x1": x1, "x2": x2, "p1": p1, "p2": p2, "mask": mask,
            "thr_n": devmod.as_tensor((opts.max_error_px / f) ** 2, dev),
            "thr_p": devmod.as_tensor(np.full(len(f), opts.max_error_px ** 2),
                                      dev), "K": K, "hosts": rows}


def run(n_pairs: int = 64, device=None, reps: int = REPS) -> dict:
    """Every phase of the reference tool on `device` (the card unless
    told); returns the record."""
    from dagsfm_tpu_torch.ops import epipolar as epi
    from dagsfm_tpu_torch.ops import ransac as rnsc
    from dagsfm_tpu_torch.ops import two_view_classify as tvc

    dev = common.resolve(device)
    pair_data = make_pairs(n_pairs)
    opts = tvc.TwoViewOptions()
    ms = {}
    ms["classify_pairs"] = common.host_ms(
        lambda: tvc.classify_pairs(pair_data, opts, seed=1, device=dev), dev,
        reps)[0]

    b = batch(pair_data, opts, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    H = opts.num_hypotheses
    ms["draw_samples"] = common.call_ms(
        lambda: tvc.draw_samples(gen, b["mask"], H), dev, reps)
    gen.manual_seed(0)
    s = tvc.draw_samples(gen, b["mask"], H)
    x1, x2, p1, p2, m = b["x1"], b["x2"], b["p1"], b["p2"], b["mask"]

    def efh():
        return tvc._efh_batched(x1, x2, p1, p2, m, b["thr_n"], b["thr_p"],
                                b["K"], b["K"], s)

    ms["efh_batched"] = common.call_ms(efh, dev, reps)
    ms["e_batched"] = common.call_ms(
        lambda: tvc._e_batched(x1, x2, m, b["thr_n"], s), dev, reps)
    ms["e_ransac"] = common.call_ms(
        lambda: tvc.ransac_essential(x1, x2, m, b["thr_n"], s["E"]), dev,
        reps)
    ms["f_ransac"] = common.call_ms(
        lambda: tvc.ransac_fundamental(p1, p2, m, b["thr_p"], s["F"]), dev,
        reps)
    ms["h_ransac"] = common.call_ms(
        lambda: tvc.ransac_homography(p1, p2, m, b["thr_p"], s["H"]), dev,
        reps)
    A = epi._epipolar_rows(*(rnsc._take(v, s["E"]) for v in (x1, x2)))
    ms["e_nullspace"] = common.call_ms(lambda: epi._nullspace_k(A, 4), dev,
                                       reps)
    ms["efh_and_fetch"], res = common.host_ms(
        lambda: [r.cpu().numpy() for r in efh()], dev, reps)

    def select():
        out = []
        for k, row in enumerate(pair_data):
            (_pk, pix1, pix2, K1, K2, s1, s2, calibrated) = row
            n = len(pix1)
            out.append(tvc._select_model(
                pix1, pix2, b["hosts"][k][2], b["hosts"][k][3], K1, K2, s1,
                s2, calibrated, opts, E=res[0][k], nE=int(res[1][k]),
                inlE=res[2][k][:n], R_E=res[3][k], t_E=res[4][k],
                nf=int(res[5][k]), F=res[6][k], nF=int(res[7][k]),
                inlF=res[8][k][:n], H=res[9][k], nH=int(res[10][k]),
                inlH=res[11][k][:n], R_F=res[12][k], t_F=res[13][k]))
        return out

    ms["select_model_host"], chosen = common.host_ms(select, dev, reps)
    configs = [r.config for r in chosen]
    return {"what": f"two-view classification split, {n_pairs} pairs of "
                    f"{b['mask'].shape[1]} correspondences, {H} hypotheses "
                    "(dagsfm_tpu_torch/tools/profile_two_view.py)",
            "num_pairs": n_pairs, "num_hypotheses": H, "ms": ms,
            "timing": {"classify_pairs": "host clock",
                       "select_model_host": "host clock",
                       "efh_and_fetch": "host clock",
                       "others": "CUDA events (device ms)"
                       if dev.type == "cuda" else "host clock"},
            "pairs_per_s": n_pairs / (ms["classify_pairs"] / 1e3),
            "configs": {str(c): configs.count(c)
                        for c in sorted(set(configs))},
            "device": dev.type, "card": common.card(dev)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the record here")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    record = run(device=args.device)
    for k, v in record["ms"].items():
        print(f"{k:20s}: {v:10.3f} ms", file=sys.stderr, flush=True)
    common.emit(record, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
