"""The input generators repeat from the seed, differ between seeds, take
seeds past 32 bits, and keep the program's conventions."""

import numpy as np
import torch

from sfmbench import scenes
from sfmbench.runners import ba as ba_run
from sfmbench.runners import verify as v_run
from sfmbench.harness import Cell, load_json
from sfmbench.tests.conftest import ROOT, TINY

BIG = 2 ** 31 + 12345


def _verify_cfg():
    return Cell(ROOT, "verify.cluster100", TINY["verify.cluster100"]).config


def _ba_cfg():
    return Cell(ROOT, "ba.dubrovnik356", TINY["ba.dubrovnik356"]).config


def test_ring_scene_and_features_repeat():
    cfg, dev = _verify_cfg(), torch.device("cpu")
    a = v_run.make_inputs(cfg, BIG, dev)
    b = v_run.make_inputs(cfg, BIG, dev)
    c = v_run.make_inputs(cfg, BIG + 1, dev)
    assert np.array_equal(a["scene"]["pixels"], b["scene"]["pixels"])
    assert np.array_equal(a["feats"]["kp"], b["feats"]["kp"])
    assert torch.equal(a["feats"]["desc"], b["feats"]["desc"])
    assert not np.array_equal(a["feats"]["kp"], c["feats"]["kp"])
    f = a["feats"]
    K = cfg["features"]["max_num_features"]
    assert f["desc"].shape == (8, K, 128) and f["desc"].dtype == torch.bfloat16
    # each visible point's slot holds its pixel; the rest are distractors
    vis = a["scene"]["visible"]
    assert (f["point_of_slot"] >= 0).sum() == vis.sum()
    i, k = np.nonzero(f["point_of_slot"] >= 0)
    p = f["point_of_slot"][i, k]
    moved = f["displaced"][i, k]
    assert np.array_equal(f["kp"][i, k][~moved],
                          a["scene"]["pixels"][i, p][~moved])
    # a share of the visible points' keypoints lie at a random pixel
    share = cfg["features"]["displaced_share"]
    assert abs(moved.mean() - share) < 0.05
    assert not np.any(np.all(f["kp"][i, k][moved]
                             == a["scene"]["pixels"][i, p][moved], -1))


def test_ring_scene_is_the_programs():
    from dagsfm_tpu_torch.scene import synthetic
    sc = scenes.ring_scene(12, 300, 1024, 768, 1000.0, pixel_noise=0.5,
                           seed=7)
    ref = synthetic.generate(synthetic.SyntheticSceneSpec(
        num_cameras=12, num_points=300, image_width=1024, image_height=768,
        focal=1000.0, pixel_noise=0.5, seed=7))
    assert np.array_equal(sc["visible"], ref.visible)
    assert np.array_equal(sc["pixels"], ref.pixels)
    assert np.array_equal(sc["R"], ref.R)


def test_bal_problem_repeats_with_exact_counts():
    cfg, dev = _ba_cfg(), torch.device("cpu")
    a = ba_run.make_truth(cfg, BIG, dev)
    b = ba_run.make_truth(cfg, BIG, dev)
    c = ba_run.make_truth(cfg, BIG + 1, dev)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["obs_xy"], c["obs_xy"])
    pr = cfg["problem"]
    assert len(a["obs_image"]) == pr["num_observations"]
    counts = torch.bincount(a["obs_point"], minlength=pr["num_points"])
    assert int(counts.min()) >= 2
    # distinct cameras in each track
    pairs = a["obs_point"] * pr["num_cameras"] + a["obs_image"]
    assert len(torch.unique(pairs)) == len(pairs)
    s1 = scenes.bal_start(a, cfg["start"], 2, BIG, 3)
    s2 = scenes.bal_start(a, cfg["start"], 2, BIG, 3)
    s3 = scenes.bal_start(a, cfg["start"], 2, BIG, 4)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert not torch.equal(s1["points"], s3["points"])
    assert torch.equal(s1["qvec"][:2], a["qvec"][:2])


def test_quaternions_follow_the_programs_convention():
    from dagsfm_tpu_torch.ops import rotations as rops
    from sfmbench.reference import ba as ref_ba
    g = torch.Generator().manual_seed(3)
    q = torch.randn((20, 4), generator=g, dtype=torch.float64)
    q = q / q.norm(dim=-1, keepdim=True)
    q = torch.where(q[:, :1] < 0, -q, q)
    R = rops.quat_to_rotmat(q)
    assert torch.allclose(ref_ba.quat_to_rotmat(q), R, atol=1e-14)
    assert np.allclose(scenes.rotmat_to_quat_np(R.numpy()), q.numpy(),
                       atol=1e-12)
    w = torch.randn((20, 3), generator=g, dtype=torch.float64)
    assert torch.allclose(scenes.axis_angle_quat(w),
                          rops.angleaxis_to_quat(w), atol=1e-14)


def test_configs_list_source_reduced_and_assumed():
    spec = load_json(ROOT / "BENCHMARK.json")
    for c in spec["configs"]:
        f = load_json(ROOT / c["file"])
        assert f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        assert f["assumed"]
