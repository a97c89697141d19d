"""Each plain reference against a tiny run of the port on the CPU."""

import numpy as np
import torch

from sfmbench.runners import ba as ba_run
from sfmbench.harness import Cell
from sfmbench.reference import ba as ref_ba
from sfmbench.reference import matcher as ref_matcher
from sfmbench.reference import two_view as ref_tv
from sfmbench.tests.conftest import ROOT, TINY


def _descriptors(seed, K=300, near=150):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((K, 128), generator=g).abs()
    b = torch.randn((K, 128), generator=g).abs()
    b[:near] = a[:near] + 0.05 * torch.randn((near, 128), generator=g)
    a, b = (x / x.norm(dim=-1, keepdim=True) for x in (a, b))
    m1 = torch.rand(K, generator=g) > 0.1
    m2 = torch.rand(K, generator=g) > 0.1
    return a.to(torch.bfloat16), b.to(torch.bfloat16), m1, m2


def test_matcher_equals_the_ports_plain_matcher():
    from dagsfm_tpu_torch.ops import matcher_kernel as mk
    for seed in range(3):
        a, b, m1, m2 = _descriptors(seed)
        j_port = mk.fused_match_j_reference(a[None], b[None], m1[None],
                                            m2[None])[0].long()
        j, border = ref_matcher.match_rows(a, b, m1, m2)
        assert (j >= 0).sum() > 100
        assert torch.equal(j[~border], j_port[~border])
        assert int(border.sum()) < 10


def test_fp8_moves_the_scores():
    a, b, m1, m2 = _descriptors(1)
    s16 = ref_matcher._scores(a, b, m1, m2, torch.bfloat16)
    s8 = ref_matcher._scores(a, b, m1, m2, torch.float8_e4m3fn)
    fin = torch.isfinite(s16)
    assert float((s16 - s8)[fin].abs().max()) > 100 * ref_matcher.EPS


def _gap(*args):
    return max(ref_tv.judge_parts(*args).values())


def _pair(seed):
    from dagsfm_tpu_torch.scene import synthetic
    sc = synthetic.generate(synthetic.SyntheticSceneSpec(
        num_cameras=6, num_points=200, pixel_noise=0.5, seed=seed))
    common = sc.visible[0] & sc.visible[1]
    K = np.array([[1000.0, 0, 512], [0, 1000.0, 384], [0, 0, 1]])
    return sc.pixels[0, common], sc.pixels[1, common], K


def test_two_view_judge_of_the_ports_answer():
    from dagsfm_tpu_torch.ops import two_view_classify as tvc
    p1, p2, K = _pair(3)
    res = tvc.classify_two_view(p1, p2, K, K, (1024, 768), (1024, 768),
                                device="cpu")
    ans = dict(config=res.config, E=res.E, F=res.F, H=res.H, R=res.R,
               t=res.t, flags=res.inlier_mask, num_inliers=res.num_inliers)
    assert res.config == ref_tv.CALIBRATED
    assert _gap(p1, p2, K, K, ans, 4.0, 15) < 1e-9
    flipped = dict(ans, flags=ans["flags"].copy())
    flipped["flags"][0] = ~flipped["flags"][0]
    flipped["num_inliers"] = int(flipped["flags"].sum())
    assert _gap(p1, p2, K, K, flipped, 4.0, 15) >= 1 / len(p1)
    bent = dict(ans, E=ans["E"] + np.diag([0.0, 0.0, 1e-3]))
    assert _gap(p1, p2, K, K, bent, 4.0, 15) > 1e-6
    assert _gap(p1, p2, K, K, None, 4.0, 15) == 1.0
    ctl = ref_tv.estimate_calibrated(p1, p2, K, K, 4.0, 64, 1,
                                     torch.float64, torch.device("cpu"))
    assert _gap(p1, p2, K, K, ctl, 4.0, 15) < 1e-9
    assert ctl["num_inliers"] >= 0.9 * res.num_inliers


def test_ba_reference_cost_and_steps_against_the_port():
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
    cell = Cell(ROOT, "ba.dubrovnik356", TINY["ba.dubrovnik356"])
    st = ba_run.setup(cell.config, cell.mix, 9, torch.device("cpu"))
    prob = ba_run._problem(st, 1)
    obs = ba_run._observations(st, torch.float64)
    sol = ref_ba.from_program(prob.image_qvec, prob.image_tvec,
                              prob.cam_params[:, :5], prob.points)
    c_ref = float(ref_ba.cost(sol, obs))
    c_port = float(ba.compute_cost(prob, st.opts))
    assert abs(c_ref - c_port) <= 1e-12 * c_port
    out, stats = ba.solve(prob, st.opts)
    assert stats.final_cost < 0.1 * stats.initial_cost
    _, c_lm, _ = ref_ba.lm(sol, obs, 2, 50, 1e-6)
    assert abs(c_lm - stats.final_cost) <= 1e-3 * stats.final_cost
    gap, left = ba_run.judge(st, dict(
        qvec=out.image_qvec, tvec=out.image_tvec,
        intr=out.cam_params[:, :5], points=out.points),
        stats.final_cost, obs)
    assert gap < 1e-12 and 0 <= left < 1e-4


def test_reference_estimator_agrees_with_the_truth_in_float64():
    """The control's estimator in float64 answers every general pair of
    the test-size cluster within the judge's bounds and to rounding in
    the model's kind: its control fails by precision, not by design."""
    from sfmbench.runners import verify as v_run
    cell = Cell(ROOT, "verify.cluster100", TINY["verify.cluster100"])
    st = v_run.setup(cell.config, cell.mix, 3, torch.device("cpu"))
    feats, K, sc = st.inputs["feats"], st.inputs["K"], st.inputs["scene"]
    jb, n = cell.mix["judge"], 0
    for a, b in st.pairs:
        R, t, rot = ref_tv.relative_pose(sc["R"][a - 1], sc["t"][a - 1],
                                         sc["R"][b - 1], sc["t"][b - 1])
        if rot:
            continue
        j, _ = ref_matcher.match_rows(feats["desc"][a - 1],
                                      feats["desc"][b - 1],
                                      feats["mask"][a - 1],
                                      feats["mask"][b - 1])
        m = ref_matcher.truncate(j, 1024).numpy()
        p1, p2 = feats["kp"][a - 1][m[:, 0]], feats["kp"][b - 1][m[:, 1]]
        ans = ref_tv.estimate_calibrated(p1, p2, K, K, 4.0,
                                         cell.mix["control_hypotheses"], 3,
                                         torch.float64, torch.device("cpu"))
        assert _gap(p1, p2, K, K, ans, 4.0, 15) < 1e-9
        tr = ref_tv.truth_readings(p1, p2, K, K, ans, R, t, rot, 4.0)
        assert tr["class_off"] == 0
        assert tr["rotation_deg"] <= jb["max_rotation_deg"]
        assert tr["translation_deg"] <= jb["max_translation_deg"]
        assert tr["inlier_share"] >= jb["min_inlier_share"]
        n += 1
    assert n >= 10


def test_truth_readings_of_a_rotation_pair():
    """A pure rotation's truth is a homography: an essential answer is of
    the wrong class, and the true homography takes the clean matches."""
    g = np.random.default_rng(5)
    K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    a = np.radians(10.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    X = np.c_[g.uniform(-1, 1, (60, 2)), g.uniform(4, 8, 60)]
    p1 = (X @ K.T)[:, :2] / X[:, 2:]
    Y = X @ R.T
    p2 = (Y @ K.T)[:, :2] / Y[:, 2:]
    p2[:10] += 50.0
    assert ref_tv.true_inliers(p1, p2, K, K, R, np.zeros(3), True, 4.0) == 50
    ans = dict(config=ref_tv.CALIBRATED, R=R, t=np.array([1.0, 0, 0]),
               num_inliers=50)
    assert ref_tv.truth_readings(p1, p2, K, K, ans, R, np.zeros(3), True,
                                 4.0)["class_off"] == 1
    ans["config"] = ref_tv.PANORAMIC
    tr = ref_tv.truth_readings(p1, p2, K, K, ans, R, np.zeros(3), True, 4.0)
    assert tr["class_off"] == 0 and tr["rotation_deg"] < 1e-6
    assert tr["inlier_share"] == 1.0
