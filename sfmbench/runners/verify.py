"""Runner `verify`: candidate pairs of one cluster through matching and
full two-view verification (`FeaturePipeline.match_and_verify`), in
consecutive jobs of `job_pairs` pairs that cycle over the cluster.

Traffic keys: `pool_seed` (the cluster's scene and features: every run
verifies the same cluster), `pairs` ("sequential": each image with its
next `overlap` images, COLMAP's sequential matching without loop
detection), `job_pairs`, `control_pairs` (the pairs the control
answers) and `control_hypotheses` (its RANSAC's: the reference's
eight-point samples are far noisier than the program's five-point ones
at these fields of view, so it draws more), `judge` (the bounds of an answer against the true pose) and
`limits`. The run's seed orders the cluster's pairs (jobs take them in
that order, cycling), seeds the RANSAC draws and draws the control's
pairs. The configuration gives the scene, the features and the matching
and verification options.

One unit of work is one job; its work is its number of pairs. The check
judges every answer of the window.
"""

from __future__ import annotations

import numpy as np
import torch

from sfmbench import scenes
from sfmbench.reference import matcher as ref_matcher
from sfmbench.reference import two_view as ref_tv

class State:
    pass


def sequential_pairs(num_images: int, overlap: int) -> list:
    return [(i, j) for i in range(1, num_images + 1)
            for j in range(i + 1, min(i + overlap, num_images) + 1)]


def make_inputs(cfg: dict, seed: int, dev) -> dict:
    """The scene, its planted features and the cameras (host numbers)."""
    sc, ft = cfg["scene"], cfg["features"]
    focal = sc["focal_factor"] * sc["width"]
    scene = scenes.ring_scene(
        sc["num_cameras"], sc["num_points"], sc["width"], sc["height"],
        focal, sc["ring_radius"], sc["ring_height_jitter"],
        sc["point_cloud_extent"], sc["pixel_noise"], seed=seed,
        panorama_every=sc["panorama_every"],
        panorama_yaw_deg=sc["panorama_yaw_deg"])
    feats = scenes.plant_features(scene, ft["max_num_features"],
                                  ft["descriptor_noise"], seed, dev,
                                  ft["displaced_share"])
    K = np.array([[focal, 0, sc["width"] / 2.0],
                  [0, focal, sc["height"] / 2.0], [0, 0, 1.0]])
    return dict(scene=scene, feats=feats, K=K, focal=focal)


def setup(cfg: dict, mix: dict, seed: int, dev) -> State:
    from dagsfm_tpu_torch.features import matching as fm
    from dagsfm_tpu_torch.pipeline import feature_pipeline as fpm
    from dagsfm_tpu_torch.scene import cameras as cm

    st = State()
    st.cfg, st.mix, st.seed, st.dev = cfg, mix, seed, dev
    st.limits = mix["limits"]
    st.inputs = make_inputs(cfg, mix["pool_seed"], dev)
    sc, mt, tv = cfg["scene"], cfg["matching"], cfg["two_view"]
    I = sc["num_cameras"]
    ids = list(range(1, I + 1))
    cams = {i: cm.make_simple_camera(i, sc["width"], sc["height"],
                                     focal=st.inputs["focal"]) for i in ids}
    opts = fpm.FeaturePipelineOptions(
        matching=fm.MatchingOptions(
            max_ratio=mt["max_ratio"], max_distance=mt["max_distance"],
            cross_check=mt["cross_check"],
            max_num_matches=mt["max_num_matches"]),
        min_num_inliers=tv["min_num_inliers"],
        max_error_px=tv["max_error_px"],
        num_ransac_hypotheses=tv["num_ransac_hypotheses"],
        two_view_essential_only=tv["essential_only"],
        guided_matching=tv["guided_matching"], seed=seed)
    fp = fpm.FeaturePipeline({}, cams, opts, device=dev)
    feats = st.inputs["feats"]
    fp.keypoints = {i: feats["kp"][i - 1] for i in ids}
    fp.bank = fm.make_bank_from_device(ids, feats["desc"], feats["mask"])
    st.fp = fp
    if mix["pairs"] != "sequential":
        raise ValueError(f"unknown pair selection {mix['pairs']!r}")
    pairs = sequential_pairs(I, mt["sequential_overlap"])
    st.pairs = [pairs[k] for k in np.random.default_rng(
        [int(seed), 17]).permutation(len(pairs))]
    st.next = 0
    st.answers = []            # (pair, matches, answer) per job and pair
    st.counters = dict(pairs=0, classified=0, matching_s=0.0,
                       verification_s=0.0)
    return st


def _job(st) -> list:
    n = st.mix["job_pairs"]
    out = [st.pairs[(st.next + k) % len(st.pairs)] for k in range(n)]
    st.next = (st.next + n) % len(st.pairs)
    return out


def _run(st, pairs):
    fp = st.fp
    fp.matches, fp.two_view = {}, {}
    fp.match_and_verify(pairs)
    return fp


def warmup(st) -> None:
    _run(st, _job(st))
    st.next = 0


def reset(st) -> None:
    st.answers.clear()
    for k in st.counters:
        st.counters[k] = type(st.counters[k])(0)


def unit(st) -> int:
    pairs = _job(st)
    fp = _run(st, pairs)
    c = st.counters
    c["pairs"] += len(pairs)
    c["classified"] += fp.num_classified
    c["matching_s"] += fp.timings["matching"]
    c["verification_s"] += fp.timings["verification"]
    for pk in pairs:
        rec = fp.two_view.get(pk)
        if rec is None:
            st.answers.append((pk, None, None))
            continue
        m = fp.matches[pk]
        flags = np.isin(m[:, 0], rec.inlier_matches[:, 0])
        st.answers.append((pk, m, dict(
            config=rec.config, E=rec.E, F=rec.F, H=rec.H, R=rec.R, t=rec.t,
            flags=flags, num_inliers=int(rec.num_inliers))))
    return len(pairs)


def e2e(st, seconds: float) -> dict:
    return {"pairs_verified_per_s": st.counters["pairs"] / seconds}


def counters(st) -> dict:
    c = dict(st.counters)
    c["K"] = st.cfg["features"]["max_num_features"]
    c["D"] = st.cfg["features"]["descriptor_dim"]
    return c


def release(st) -> None:
    st.fp = None


def rows_off(m, j_ref, border, max_num_matches: int):
    """(rows whose match differs outside the borderline rows, rows
    compared): the rows up to where both lists are cut."""
    K = len(j_ref)
    j_p = np.full(K, -1, np.int64)
    if m is not None and len(m):
        j_p[m[:, 0].astype(np.int64)] = m[:, 1]
    cut = K - 1
    if m is not None and len(m) >= max_num_matches:
        cut = int(m[-1, 0])
    ref_rows = np.nonzero(j_ref >= 0)[0]
    if len(ref_rows) >= max_num_matches:
        cut = min(cut, int(ref_rows[max_num_matches - 1]))
    rows = slice(0, cut + 1)
    off = (j_p[rows] != j_ref[rows]) & ~border[rows]
    return int(off.sum()), cut + 1


def judge(st, answers) -> tuple:
    """([(name, value, limit)], failed answers, parts) over (pair,
    matches, answer) rows.

    `answers_off`: the share of the answers that are wrong, an exact
    comparison. An answer is wrong where one of its compared rows has
    another match than the reference's outside the borderline rows,
    where it is no answer or an inlier flag disagrees with its own model
    (reference/two_view.judge_parts), where its essential or fundamental
    matrix is farther than the mix's `judge` `max_model_gap` from its
    kind, or where it departs from the scene's true relative pose by
    more than the `judge` bounds (reference/two_view.truth_readings).
    `rotation_gap`: the worst orthonormality and determinant gap of the
    rotations recovered from essential or fundamental matrices, a
    rounding reading. parts holds the worst of each part apart."""
    feats, K, sc = st.inputs["feats"], st.inputs["K"], st.inputs["scene"]
    mt, tv, jb = st.cfg["matching"], st.cfg["two_view"], st.mix["judge"]
    L = st.limits
    wrong, failed, rot_gap = 0, 0, 0.0
    parts = dict(pairs=0, rotation_pairs=0, wrong=0, match_rows_off=0.0,
                 class_off=0, rotation_deg=0.0, translation_deg=0.0,
                 inlier_share=float("inf"), gap_by={})
    for (a, b), m, ans in answers:
        j_ref, border = ref_matcher.match_rows(
            feats["desc"][a - 1], feats["desc"][b - 1],
            feats["mask"][a - 1], feats["mask"][b - 1], mt["max_ratio"],
            mt["max_distance"], mt["cross_check"])
        j_ref, border = j_ref.cpu().numpy(), border.cpu().numpy()
        o, n = rows_off(m, j_ref, border, mt["max_num_matches"])
        parts["pairs"] += 1
        parts["match_rows_off"] = max(parts["match_rows_off"], o / max(n, 1))
        jp = dict(answer=1.0)
        if m is not None:
            mi = m.astype(np.int64)
            p1, p2 = feats["kp"][a - 1][mi[:, 0]], feats["kp"][b - 1][mi[:, 1]]
            jp = ref_tv.judge_parts(p1, p2, K, K, ans, tv["max_error_px"],
                                    tv["min_num_inliers"])
        for k, v in jp.items():
            parts["gap_by"][k] = max(parts["gap_by"].get(k, 0.0), v)
        bad = o > 0 or jp.get("answer", 0.0) > 0 or jp.get("flags", 0.0) > 0 \
            or max(jp.get(k, 0.0) for k in ("E_rank", "E_equal", "F_rank")) \
            > jb["max_model_gap"]
        if "answer" not in jp:
            R, t, rot = ref_tv.relative_pose(sc["R"][a - 1], sc["t"][a - 1],
                                             sc["R"][b - 1], sc["t"][b - 1])
            tr = ref_tv.truth_readings(p1, p2, K, K, ans, R, t, rot,
                                       tv["max_error_px"])
            parts["rotation_pairs"] += int(rot)
            parts["class_off"] += tr["class_off"]
            for k in ("rotation_deg", "translation_deg"):
                parts[k] = max(parts[k], tr[k])
            parts["inlier_share"] = min(parts["inlier_share"],
                                        tr["inlier_share"])
            bad = bad or tr["class_off"] > 0 \
                or tr["rotation_deg"] > jb["max_rotation_deg"] \
                or tr["translation_deg"] > jb["max_translation_deg"] \
                or tr["inlier_share"] < jb["min_inlier_share"]
        r = jp.get("R", 0.0)
        rot_gap = max(rot_gap, r)
        wrong += int(bad)
        failed += int(bad or r > L["rotation_gap"])
    parts["wrong"] = wrong
    off = wrong / max(len(answers), 1)
    return ([("answers_off", off, L["answers_off"]),
             ("rotation_gap", rot_gap, L["rotation_gap"])], failed, parts)


def check(st, seed: int) -> tuple:
    """([(name, value, limit)], failed): every answer of the window
    against the plain reference and the scene's truth."""
    checks, failed, st.parts = judge(st, st.answers)
    return checks, failed


def control(st, seed: int) -> tuple:
    """The control's numbers: the reference in the program's place,
    matching on fp8 descriptors and verifying in float32, on
    `control_pairs` pairs of distinct centres drawn from the seed (the
    reference's estimator is the calibrated one; the pure rotations are
    the configuration class's to hold, see judge)."""
    feats, K, sc = st.inputs["feats"], st.inputs["K"], st.inputs["scene"]
    mt, tv = st.cfg["matching"], st.cfg["two_view"]
    rng = np.random.default_rng([int(seed), 7])
    general = [pk for pk in st.pairs if not ref_tv.relative_pose(
        sc["R"][pk[0] - 1], sc["t"][pk[0] - 1], sc["R"][pk[1] - 1],
        sc["t"][pk[1] - 1])[2]]
    pairs = [general[i] for i in sorted(rng.choice(
        len(general), min(st.mix["control_pairs"], len(general)),
        replace=False))]
    answers = []
    for (a, b) in pairs:
        j, _ = ref_matcher.match_rows(
            feats["desc"][a - 1], feats["desc"][b - 1],
            feats["mask"][a - 1], feats["mask"][b - 1], mt["max_ratio"],
            mt["max_distance"], mt["cross_check"],
            dtype=torch.float8_e4m3fn)
        m = ref_matcher.truncate(j, mt["max_num_matches"]).cpu().numpy()
        ans = ref_tv.estimate_calibrated(
            feats["kp"][a - 1][m[:, 0]], feats["kp"][b - 1][m[:, 1]], K, K,
            tv["max_error_px"], st.mix["control_hypotheses"], seed,
            torch.float32, st.dev)
        answers.append(((a, b), m, ans))
    checks, failed, st.parts = judge(st, answers)
    return checks, failed
