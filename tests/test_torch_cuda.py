"""The CUDA kernels on the card: the fused matcher (K1) and the top-2
matchers (K2, K3, K4) against their plain versions, their input checks
and launch counts, the matcher path through K1, and that the kernels,
mapping and SIFT repeat bit for bit on the card. K1, K2 and K4 multiply
on the bf16 tensor cores and are held to the borderline rule (scores
within EPS; an index may differ only where the plain scores put it
within 2 EPS of a tie or a threshold); K3 (one ordered FMA chain per
score) and match_one_pair equal their plain versions to the bit. Also:
the camera models' undistortion on the card against the CPU, and that
bundle adjustment with intrinsics (dense joint and iterative PCG), a
mapping from a blind distorted camera and one through the focal grid
(a blind camera per image) repeat bit for bit; the multi-model
controller repeats bit for bit, and essential verification and the pose
edges read from a database agree with the CPU; pair selection's k-means,
tree descent and BoW histograms (borderline rule, and bit for bit
between two runs), the Gabor embedding and VLAD, and SIFT with
domain-size pooling and affine shape agree with the CPU port; the
1000-image tool (tools/e2e_1000) at 20 images repeats bit for bit; the
program's spans are on the profiler's clock (K1's launch inside the
`match` span) and profiler_trace writes them beside the kernels; the
minimal-nullspace kernel equals its plain version, launches once per
estimator in a verification batch, and leaves no cuSOLVER QR kernel in
its trace; bundle adjustment's Schur-product kernel equals its plain
version, repeats to the bit, syncs nothing with the host and refuses
what it does not take; the sharded BA over NCCL on four ranks, one card
each, holds the same bits on every rank and the CPU's result (skips
below four cards). Every test here needs a CUDA card and skips without
one.

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:xdist \
        -p no:cacheprovider -o addopts=""
"""
import os

import numpy as np
import pytest
import torch

from chip_smoke import distort_keypoints, plant_features, planted_pairs
from dagsfm_tpu_torch.features import matching as t_fm
from dagsfm_tpu_torch.ops import matcher_kernel as mk
from dagsfm_tpu_torch.ops import top2_matcher as tm
from dagsfm_tpu_torch.scene import synthetic as t_syn

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


@pytest.mark.parametrize("K", [1024, 1000, 2048, 64, 1])
@pytest.mark.parametrize("cross_check", [True, False])
def test_kernel_equals_plain_version(cuda, K, cross_check):
    d1, d2, m1, m2 = planted_pairs(8, K, seed=K, device=cuda)
    before = mk.launches
    j = mk.fused_match_j(d1, d2, m1, m2, cross_check=cross_check)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    ref = mk.fused_match_j_reference(d1, d2, m1, m2,
                                     cross_check=cross_check)
    flag = mk.borderline_rows(d1, d2, m1, m2, cross_check=cross_check)
    assert j.dtype == torch.int32 and j.shape == (8, K)
    assert not bool(((j != ref) & ~flag).any())
    assert int(flag.sum()) <= 8 * K // 20
    assert bool((j[0] == -1).all())          # every column masked


def test_masked_slots_may_hold_anything(cuda):
    """A masked descriptor slot (NaN from a degenerate keypoint, say) must
    not reach a score: K1 and K2 give what they give with zeros there."""
    d1, d2, m1, m2 = planted_pairs(4, 300, seed=8, device=cuda)
    junk1, junk2 = d1.clone(), d2.clone()
    junk1[~m1] = torch.nan
    junk2[~m2] = torch.inf
    z1 = torch.where(m1[..., None], d1, 0.0).contiguous()
    z2 = torch.where(m2[..., None], d2, 0.0).contiguous()
    assert torch.equal(mk.fused_match_j(junk1, junk2, m1, m2),
                       mk.fused_match_j(z1, z2, m1, m2))
    for x, y in zip(tm.top2_batch(junk1, junk2, m1, m2),
                    tm.top2_batch(z1, z2, m1, m2)):
        assert torch.equal(x, y)


def test_kernel_ties_take_the_first_index(cuda):
    rng = np.random.default_rng(3)
    d = np.abs(rng.normal(size=(1, 128, 128)))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d2 = d.copy()
    d2[0, 5] = d2[0, 2]
    d2[0, 100] = d2[0, 7]                     # duplicate in another tile
    d1 = d.copy()
    d1[0, 6] = d1[0, 3]
    d1[0, 90] = d1[0, 8]                      # duplicate row in another tile
    T = (lambda a: torch.as_tensor(a).to(cuda, torch.bfloat16))
    m = torch.ones((1, 128), dtype=torch.bool, device=cuda)
    for cross in (True, False):
        j = mk.fused_match_j(T(d1), T(d2), m, m, max_ratio=1.01,
                             cross_check=cross)
        ref = mk.fused_match_j_reference(T(d1), T(d2), m, m, max_ratio=1.01,
                                         cross_check=cross)
        assert torch.equal(j, ref)


def test_kernel_refuses_what_it_does_not_take(cuda):
    d1, d2, m1, m2 = planted_pairs(2, 128, seed=0, device=cuda)
    before = mk.launches
    with pytest.raises(ValueError):
        mk.fused_match_j(d1.float(), d2, m1, m2)
    with pytest.raises(ValueError):
        mk.fused_match_j(d1, d2[:, :64], m1, m2)
    with pytest.raises(ValueError):
        mk.fused_match_j(d1[..., :64], d2[..., :64], m1, m2)
    with pytest.raises(ValueError):
        mk.fused_match_j(d1.transpose(0, 1).contiguous().transpose(0, 1),
                         d2, m1, m2)
    with pytest.raises(ValueError):
        mk.fused_match_j(d1, d2.cpu(), m1, m2)
    assert mk.launches == before


def test_match_pairs_on_the_card_equals_the_cpu(cuda):
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=6, num_points=150, seed=3, max_track_length=4))
    _, descs, masks = plant_features(sc, K=256, seed=3)
    ids = sorted(descs)
    pairs = [(i, j) for i in ids for j in ids if i < j]
    before = mk.launches
    gpu = t_fm.match_pairs(descs, masks, pairs, batch_size=4, device=cuda)
    assert mk.launches == before + -(-len(pairs) // 4)
    cpu = t_fm.match_pairs(descs, masks, pairs, batch_size=4, device="cpu")
    assert gpu.keys() == cpu.keys()
    T = (lambda a: torch.as_tensor(a)[None])
    for pk in cpu:
        a, b = pk
        flag = mk.borderline_rows(T(descs[a]), T(descs[b]), T(masks[a]),
                                  T(masks[b]))[0].numpy()
        keep = (lambda m: {(int(r), int(c)) for r, c in m if not flag[r]})
        assert keep(gpu[pk]) == keep(cpu[pk])
    assert sum(len(m) for m in cpu.values()) > 100


# --------------------------------------------------------------- K2, K3, K4

def _same(out, ref, border=None):
    """Kernel outputs against the plain version's: with `border` = (rows,
    cols) the borderline rule (bf16 kernels), else equal to the bit
    (K3)."""
    if border is None:
        for a, b in zip(out, ref):
            assert a.dtype == b.dtype and torch.equal(a, b)
        return
    for a, b in zip(out[:2], ref[:2]):
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        assert torch.equal(a[~fin], b[~fin])
        assert bool(((a[fin] - b[fin]).abs() <= tm.EPS).all())
    for a, b, flag in zip(out[2:], ref[2:], border):
        assert not bool(((a != b) & ~flag).any())


@pytest.mark.parametrize("K", [1024, 1000, 64, 1])
def test_top2_batch_and_mfu_variant_equal_plain_versions(cuda, K):
    d1, d2, m1, m2 = planted_pairs(8, K, seed=K, device=cuda)
    before = (tm.top2_batch_launches, tm.mfu_launches)
    out = tm.top2_batch(d1, d2, m1, m2)
    torch.cuda.synchronize()
    assert tm.top2_batch_launches == before[0] + 1
    _same(out, tm.top2_batch_reference(d1, d2, m1, m2),
          tm.borderline(d1, d2, m1, m2))
    assert bool(torch.isneginf(out[0][0]).all())      # every column masked
    for mode in range(4):
        v = tm.mfu_variant(d1, d2, m1, m2, mode)
        _same(v, tm.mfu_variant_reference(d1, d2, m1, m2, mode),
              tm.borderline(d1, d2, m1, m2, mode))
        if mode == 3:
            for a, b in zip(v, out):
                assert torch.equal(a, b)
    assert tm.mfu_launches == before[1] + 4


@pytest.mark.parametrize("K1,K2", [(1024, 1024), (128, 384)])
def test_top2_and_match_one_pair_equal_plain_versions(cuda, K1, K2):
    # pair 1: planted_pairs masks every column of pair 0
    d1, d2, m1, m2 = planted_pairs(2, max(K1, K2), seed=K1 + K2, device=cuda)
    d1, d2, m1, m2 = d1[1:], d2[1:], m1[1:], m2[1:]
    a, b = d1[0, :K1].float().contiguous(), d2[0, :K2].float().contiguous()
    before = tm.top2_launches
    out = tm.top2(a, b)
    torch.cuda.synchronize()
    assert tm.top2_launches == before + 1
    _same(out, tm.top2_reference(a, b))
    m, n = tm.match_one_pair(a, b, m1[0, :K1], m2[0, :K2])
    assert tm.top2_launches == before + 3
    rm, rn = tm.match_one_pair_reference(a, b, m1[0, :K1], m2[0, :K2])
    assert torch.equal(m, rm) and int(n) == int(rn) > 0


def _k3_inputs(K1, K2, seed, device):
    """f32 (K1, 128) and (K2, 128) planted descriptors (pair 1 of
    planted_pairs, whose pair 0 has every column masked)."""
    d1, d2, _, _ = planted_pairs(2, max(K1, K2), seed=seed, device=device)
    return d1[1, :K1].float().contiguous(), d2[1, :K2].float().contiguous()


@pytest.mark.parametrize("K1,K2", [(128, 3712), (3712, 128), (3712, 3712)])
def test_top2_equals_plain_version_to_the_bit(cuda, K1, K2):
    """K3 at the pixel path's 3,712 slots, as row and as column count: one
    ordered FMA chain per score, so every bit agrees however the grid
    splits the columns."""
    a, b = _k3_inputs(K1, K2, seed=K1 + 2 * K2, device=cuda)
    _same(tm.top2(a, b), tm.top2_reference(a, b))


def test_top2_ties_zero_rows_and_sunk_columns(cuda):
    """A duplicate column in another column tile than its twin (so another
    CTA) keeps the first index and gives second = best; an all-zero d1 row scores 0
    everywhere (idx 0); d2 rows at -1e6, as match_one_pair sinks invalid
    ones."""
    a, b = _k3_inputs(1024, 2048, seed=21, device=cuda)
    b[1500] = b[40]          # column tile 11 against tile 0: the fold merges
    a[7] = b[40]
    a[9] = 0.0
    b[3] = -1e6
    b[1800:1900] = -1e6
    out = tm.top2(a, b)
    _same(out, tm.top2_reference(a, b))
    best, second, idx = out
    assert int(idx[7]) == 40 and float(second[7]) == float(best[7])
    assert int(idx[9]) == 0 and float(best[9]) == float(second[9]) == 0.0
    assert bool((idx != 3).all()) and bool(((idx < 1800) | (idx >= 1900)).all())


def test_top2_kernels_refuse_what_they_do_not_take(cuda):
    d1, d2, m1, m2 = planted_pairs(2, 128, seed=0, device=cuda)
    before = (tm.top2_batch_launches, tm.top2_launches, tm.mfu_launches)
    with pytest.raises(ValueError):
        tm.top2_batch(d1.float(), d2, m1, m2)
    with pytest.raises(ValueError):
        tm.top2_batch(d1, d2[:, :64], m1, m2)
    with pytest.raises(ValueError):
        tm.mfu_variant(d1, d2, m1.to(torch.uint8), m2, 3)
    with pytest.raises(ValueError):
        tm.top2(d1[0], d2[0].float())                 # bf16, not f32
    with pytest.raises(ValueError):
        tm.top2(d1[0].float(), d2[0, :100].float())
    with pytest.raises(ValueError):
        tm.top2(d1[0].float(), d2[0].float().cpu())
    assert (tm.top2_batch_launches, tm.top2_launches, tm.mfu_launches) \
        == before


# ------------------------------------------------------------ repeatability

@pytest.mark.parametrize("K", [1000, 3712])
def test_two_launches_give_the_same_bits(cuda, K):
    """K1, K2 and K3 on the same inputs twice: no float atomics, so the
    outputs agree to the bit (the column keys' atomicMax is order-free;
    K3 folds its column tiles in column order)."""
    d1, d2, m1, m2 = planted_pairs(16, K, seed=K + 5, device=cuda)
    a = mk.fused_match_j(d1, d2, m1, m2)
    b = mk.fused_match_j(d1, d2, m1, m2)
    assert torch.equal(a, b) and int((a >= 0).sum()) > 0
    for x, y in zip(tm.top2_batch(d1, d2, m1, m2),
                    tm.top2_batch(d1, d2, m1, m2)):
        assert torch.equal(x, y)
    n = K // 128 * 128
    f1, f2 = (d[1, :n].float().contiguous() for d in (d1, d2))
    for x, y in zip(tm.top2(f1, f2), tm.top2(f1, f2)):
        assert torch.equal(x, y)


def test_mapping_repeats_bit_for_bit_on_the_card(cuda):
    """Two mappings of one matching problem give the same bits: every
    sum in bundle adjustment adds its terms in a fixed order."""
    from dagsfm_tpu_torch.sfm import incremental_mapper as t_im
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=20, num_points=1500, pixel_noise=0.3, seed=9))
    problem = t_syn.to_matching_problem(sc, match_outlier_fraction=0.1,
                                        seed=2)
    recs = [t_im.IncrementalMapper(*problem, t_im.MapperOptions(seed=3),
                                   device=cuda).reconstruct()
            for _ in range(2)]
    a, b = recs
    assert a.reg_image_ids == b.reg_image_ids and a.num_reg_images() == 20
    for i in a.reg_image_ids:
        np.testing.assert_array_equal(a.images[i].qvec, b.images[i].qvec)
        np.testing.assert_array_equal(a.images[i].tvec, b.images[i].tvec)
    assert a.points3D.keys() == b.points3D.keys()
    for p in a.points3D:
        np.testing.assert_array_equal(a.points3D[p].xyz, b.points3D[p].xyz)


def test_sift_repeats_bit_for_bit_on_the_card(cuda):
    """Two extractions of the same images give the same bits: the
    orientation histogram sums each bin in a fixed order."""
    from dagsfm_tpu_torch.features import sift as t_sift
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=4, num_points=50, image_width=320, image_height=240,
        focal=343.0, seed=4, ring_radius=9.0, point_cloud_extent=3.5))
    images = t_syn.render_images(sc, device=cuda)
    batch = torch.as_tensor(np.stack([images[i] for i in sorted(images)]),
                            device=cuda)
    a, b = (t_sift.extract(batch) for _ in range(2))
    assert int(a.mask.sum()) > 100
    for name, x in a._asdict().items():
        assert torch.equal(x, getattr(b, name)), name


def test_cam_from_img_on_the_card_equals_the_cpu(cuda):
    """The 25 Newton steps of every model's undistortion on the card
    give the CPU's coordinates to 1e-12."""
    from dagsfm_tpu_torch.scene import cameras as t_cm
    rng = np.random.default_rng(0)
    xy = rng.uniform([40, 30], [600, 450], (4096, 2))
    for mid in range(11):
        single = mid in t_cm._SINGLE_FOCAL
        n = t_cm.CAMERA_MODEL_NUM_PARAMS[mid]
        p = np.zeros(12)
        base = [500.0, 320.0, 240.0] if single else [500.0, 520.0, 320.0,
                                                      240.0]
        p[:len(base)] = base
        p[len(base):n] = rng.normal(0.0, 0.05, n - len(base))
        if mid == t_cm.FOV:
            p[4] = 0.9
        cpu = t_cm.cam_from_img(mid, torch.as_tensor(p), torch.as_tensor(xy))
        card = t_cm.cam_from_img(mid, torch.as_tensor(p, device=cuda),
                                 torch.as_tensor(xy, device=cuda))
        np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0,
                                   atol=1e-12, err_msg=str(mid))


def _perturbed_radial_problem(device):
    from dagsfm_tpu_torch.scene import cameras as t_cm
    from dagsfm_tpu_torch.sfm import bundle_adjustment as t_ba
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=30, num_points=1500, pixel_noise=0.3, seed=5,
        camera_model="SIMPLE_RADIAL"))
    arrays = t_syn.to_scene_arrays(sc, device)
    cp = arrays.cam_params.clone()
    cp[0, 0] *= 1.1
    cp[0, 3] = 0.05
    arrays = arrays._replace(cam_params=cp)
    const = np.zeros(30, bool)
    const[:2] = True
    return t_ba.make_problem(arrays, const_image=const,
                             cam_refine=t_cm.intrinsics_refine_mask(
                                 [t_cm.SIMPLE_RADIAL], True, False, True))


@pytest.mark.parametrize("solver", ["dense", "iterative"])
def test_joint_ba_repeats_bit_for_bit_on_the_card(cuda, solver):
    """Two solves of one problem give the same bits: the joint system's
    pose-intrinsics and intrinsics-intrinsics blocks are segment sums in
    a fixed order, and so are the PCG's dot products. The card agrees
    with the CPU to the rounding of the sums' order."""
    from dagsfm_tpu_torch.sfm import bundle_adjustment as t_ba
    opts = t_ba.BAOptions(max_iterations=10, loss="cauchy", refine_focal=True,
                          refine_extra=True, solver=solver)
    runs = [t_ba.solve(_perturbed_radial_problem(cuda), opts)
            for _ in range(2)]
    (a, sa), (b, sb) = runs
    assert sa == sb
    for name in ("image_qvec", "image_tvec", "points", "cam_params"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    cpu, sc = t_ba.solve(_perturbed_radial_problem(torch.device("cpu")),
                         opts)
    assert sc.final_cost == pytest.approx(sa.final_cost, rel=1e-6)
    np.testing.assert_allclose(a.cam_params.cpu().numpy(),
                               cpu.cam_params.numpy(), rtol=1e-7)


def _same_bits(a, b):
    assert a.reg_image_ids == b.reg_image_ids
    for c in a.cameras:
        assert a.cameras[c].params == b.cameras[c].params, c
    for i in a.reg_image_ids:
        np.testing.assert_array_equal(a.images[i].qvec, b.images[i].qvec)
        np.testing.assert_array_equal(a.images[i].tvec, b.images[i].tvec)
    assert a.points3D.keys() == b.points3D.keys()
    for p in a.points3D:
        np.testing.assert_array_equal(a.points3D[p].xyz, b.points3D[p].xyz)


def _distorted_mapping(device, num_cameras, one_camera_each):
    """to_matching_problem's keypoints seen through SIMPLE_RADIAL (f 900,
    k1 = -0.1, 0.3 px noise), mapped from blind SIMPLE_RADIAL cameras:
    one shared, or one per image. Returns (reconstruction, mapper)."""
    from dagsfm_tpu_torch.scene import cameras as t_cm
    from dagsfm_tpu_torch.sfm import incremental_mapper as t_im
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=num_cameras, num_points=60 * num_cameras, seed=3,
        image_width=1024, image_height=768, focal=900.0))
    truth = t_cm.Camera(1, t_cm.SIMPLE_RADIAL, 1024, 768,
                        (900.0, 512.0, 384.0, -0.1))
    _, images, graph = t_syn.to_matching_problem(sc)
    images = distort_keypoints(sc, images, truth, noise=0.3)
    if one_camera_each:
        for i, im in images.items():
            im.camera_id = i
    cams = {c: t_cm.make_simple_camera(c, 1024, 768, model="SIMPLE_RADIAL")
            for c in {im.camera_id for im in images.values()}}
    mapper = t_im.IncrementalMapper(cams, images, graph,
                                    t_im.MapperOptions(seed=0), device=device)
    return mapper.reconstruct(), mapper


def test_distorted_mapping_repeats_bit_for_bit_on_the_card(cuda):
    """Two mappings of keypoints seen through SIMPLE_RADIAL (k1 = -0.1),
    from one blind camera, give the same bits, the refined camera too."""
    (a, _), (b, _) = (_distorted_mapping(cuda, 12, False) for _ in range(2))
    assert a.num_reg_images() == 12
    assert abs(a.cameras[1].params[0] - 900.0) < 9.0
    assert a.cameras[1].params[3] < -0.05
    _same_bits(a, b)


def test_focal_grid_repeats_bit_for_bit_on_the_card(cuda):
    """One blind camera per image: on the card the focal grid (15
    factors of one batched P3P RANSAC with the EPnP refit) runs on each
    camera's first registration and picks grid points, the nearest to
    900 / 1228.8 most often, as tests/test_torch_distorted_mapping.py
    asks on the CPU; two mappings give the same picks and the same
    bits. The card draws other RANSAC samples than the CPU, so an image
    whose registration fails after its grid run goes through the grid
    again when it is retried, as in the reference."""
    n = 8
    (a, ma), (b, mb) = (_distorted_mapping(cuda, n, True) for _ in range(2))
    assert a.num_reg_images() == n
    picks = ma.focal_grid_factors
    assert picks == mb.focal_grid_factors and len(picks) >= n - 2, picks
    assert len(picks) - (n - 2) <= sum(ma._failed_regs.values()), picks
    grid = np.exp(np.linspace(np.log(0.2), np.log(5.0), 15))
    assert all(np.isclose(grid, p, rtol=1e-12, atol=0).any() for p in picks)
    assert max(picks, key=picks.count) == grid[6], picks
    for c in a.cameras.values():
        assert abs(c.params[0] - 900.0) < 18.0 and c.params[3] < 0, c
    _same_bits(a, b)


def _distributed_problem():
    """tests/test_pipeline.py's fixture: 24 cameras, 5 % outlier matches."""
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=24, num_points=600, pixel_noise=0.3, seed=17))
    return sc, t_syn.to_matching_problem(sc, match_outlier_fraction=0.05,
                                         seed=2)


def test_distributed_mapper_repeats_bit_for_bit_on_the_card(cuda):
    """The whole controller on the card (E/F/H view graph, rotation
    averaging, spectral clusters of at most 10, per-cluster mapping, the
    Sim(3) merge, separator retriangulation, final BA) twice: the same
    clusters and the same bits in the merged model, within
    tests/test_pipeline.py's limits."""
    from dagsfm_tpu_torch.clustering.image_clustering import \
        ClusteringOptions
    from dagsfm_tpu_torch.pipeline import distributed_mapper as t_dm
    from dagsfm_tpu_torch.sfm.incremental_mapper import MapperOptions
    sc, problem = _distributed_problem()
    runs = []
    for _ in range(2):
        opts = t_dm.DistributedMapperOptions(
            clustering=ClusteringOptions(num_images_ub=10, image_overlap=6),
            mapper=MapperOptions(init_min_num_inliers=30,
                                 num_ransac_hypotheses=256, seed=11),
            final_ba_iterations=25, retriangulate=True, seed=5)
        ctrl = t_dm.DistributedMapperController(*problem, opts, device=cuda)
        runs.append((ctrl, ctrl.run()))
    (ca, a), (cb, b) = runs
    assert [c.image_ids for c in ca.clusters] == \
        [c.image_ids for c in cb.clusters]
    assert len(ca.clusters) >= 2 and len(ca.separators) >= 2
    assert a.num_reg_images() >= 22
    err = t_syn.pose_errors(a, sc)
    assert err["ate"] < 0.05 and err["rot_err_deg_mean"] < 0.3, err
    assert ca.separator_rmse(a) < 2.0
    _same_bits(a, b)
    for p in a.points3D:
        assert a.points3D[p].track == b.points3D[p].track


def _ra_problem(n: int, seed: int):
    """A chain plus random edges over n random rotations, each relative
    rotation with 1 deg of noise and 15 % of them replaced by outliers."""
    from dagsfm_tpu_torch.ops import rotations as t_rops
    rng = np.random.default_rng(seed)
    rot = (lambda aa: t_rops.angleaxis_to_rotmat(torch.as_tensor(aa))
           .numpy())
    R = rot(rng.normal(0, 0.8, (n, 3)))
    edges, rels = [], []
    for i in range(n):
        for j in range(i + 1, n):
            if j != i + 1 and rng.random() > 0.3:
                continue
            Rij = rot(rng.normal(0, np.radians(1.0), 3)) @ R[j] @ R[i].T
            if rng.random() < 0.15:
                Rij = rot(rng.normal(0, 1.0, 3))
            edges.append((i, j))
            rels.append(Rij)
    return np.array(edges), np.stack(rels)


def test_rotation_averaging_on_the_card_equals_the_cpu(cuda):
    """The L1 + IRLS loops (110 x 50 CG steps over segment sums) on the
    card and on the CPU agree to rel 1e-9, and the orientation filter
    keeps the same pairs."""
    from dagsfm_tpu_torch.estimation import rotation_averaging as t_ra
    edges, rels = _ra_problem(40, 3)
    a = t_ra.estimate_rotations(40, edges, rels, device=cuda)
    b = t_ra.estimate_rotations(40, edges, rels, device="cpu")
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(
        t_ra.filter_pairs_from_orientation(edges, rels, a, device=cuda),
        t_ra.filter_pairs_from_orientation(edges, rels, a, device="cpu"))
    assert np.array_equal(a, t_ra.estimate_rotations(40, edges, rels,
                                                     device=cuda))


def test_ransac_umeyama_on_the_card_equals_the_cpu(cuda):
    """RANSAC Sim(3) on the same samples: s, R, t to rel 1e-9, the same
    inliers."""
    from dagsfm_tpu_torch.ops import umeyama as t_um
    rng = np.random.default_rng(0)
    x = rng.normal(size=(500, 3))
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.linalg.det(R)
    y = 1.7 * x @ R.T + np.array([1.0, 2.0, 3.0]) \
        + rng.normal(0, 0.01, (500, 3))
    y[:100] += rng.normal(0, 1.0, (100, 3))
    mask = np.ones(500, bool)
    mask[-20:] = False
    gen = torch.Generator()
    gen.manual_seed(1)
    idx = t_um.sample_triplets(gen, torch.as_tensor(mask), 256)
    outs = [t_um.ransac_umeyama(*(torch.as_tensor(v, device=d)
                                  for v in (x, y, mask, idx)), 0.05)
            for d in (cuda, "cpu")]
    for u, v in zip(*outs):
        u, v = u.cpu().numpy(), v.numpy()
        if u.dtype == bool:
            np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_allclose(u, v, rtol=1e-9, atol=1e-12)
    assert int(outs[0][4]) >= 380


def _two_view_pairs(n_pairs: int, seed: int):
    """verify_pairs inputs: n_pairs random two-view problems of 40-300
    normalised correspondences, 30 % outliers, 4 px at f = 800."""
    from dagsfm_tpu_torch.ops import rotations as t_rops
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_pairs):
        n = int(rng.integers(40, 300))
        X = rng.uniform(-2, 2, (n, 3)) + [0, 0, 8]
        R = t_rops.angleaxis_to_rotmat(
            torch.as_tensor(rng.normal(size=3) * 0.1)).numpy()
        t = np.array([1.0, 0.2, 0.1]) + rng.normal(size=3) * 0.1
        x1 = X[:, :2] / X[:, 2:] + rng.normal(size=(n, 2)) * 0.5 / 800
        X2 = X @ R.T + t
        x2 = X2[:, :2] / X2[:, 2:] + rng.normal(size=(n, 2)) * 0.5 / 800
        bad = rng.random(n) < 0.3
        x2[bad] = rng.uniform(-0.4, 0.4, (bad.sum(), 2))
        out.append(((k, k + 1), x1, x2, (4.0 / 800) ** 2))
    return out


def test_verify_pairs_on_the_card_equals_the_cpu(cuda):
    """Essential verification of 24 pairs on the same samples: the same
    counts and inlier sets, R and t to 1e-9 (rel and abs, as rotation
    averaging; the 5-point roots move by up to 1.5e-10 in t between the
    card and the CPU)."""
    from dagsfm_tpu_torch.sfm import two_view as t_tv
    pairs = _two_view_pairs(24, 0)
    gen = torch.Generator()
    gen.manual_seed(0)
    idx = t_tv._draw_samples(gen, pairs, 256)
    a = t_tv.verify_pairs(pairs, sample_idx=idx, device=cuda)
    b = t_tv.verify_pairs(pairs, sample_idx=idx, device="cpu")
    assert list(a) == list(b)
    for k, (R, t, n, nf, inl, valid) in b.items():
        gR, gt, gn, gf, ginl, gv = a[k]
        np.testing.assert_allclose(gR, R, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(gt, t, rtol=1e-9, atol=1e-9)
        assert (gn, gf, gv) == (n, nf, valid) and valid
        np.testing.assert_array_equal(ginl, inl)


@pytest.mark.parametrize("r", [5, 7, 8])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)])
def test_nullspace_kernel_equals_plain_version(cuda, r, dtype, tol):
    """The minimal-nullspace kernel at the cell's 16,384 systems per call
    (and a ragged 1,000), one launch a call, against the plain version on
    the card; a zero row (tau = 0) stays finite and orthonormal."""
    from dagsfm_tpu_torch.ops import nullspace_kernel as nk
    rng = np.random.default_rng(r)
    for S in (16384, 1000):
        A = rng.normal(size=(S, r, 9))
        A[: S // 8, r // 2] = 0.0
        A = torch.as_tensor(A, dtype=dtype, device=cuda)
        before = nk.launches
        N = nk.minimal_nullspace(A)
        torch.cuda.synchronize()
        assert nk.launches == before + 1
        assert N.shape == (S, 9, 9 - r) and N.dtype == dtype
        ref = nk.minimal_nullspace_reference(A)
        assert float((N - ref).abs().max()) <= tol
        assert bool(torch.isfinite(N).all())
        eye = torch.eye(9 - r, dtype=dtype, device=cuda)
        assert float((N.mT @ N - eye).abs().max()) <= 10 * tol


def test_nullspace_kernel_refuses_what_it_does_not_take(cuda):
    from dagsfm_tpu_torch.ops import nullspace_kernel as nk
    A = torch.zeros((16, 5, 9), dtype=torch.float64, device=cuda)
    for bad in (torch.zeros((16, 6, 3), dtype=torch.float64, device=cuda),
                torch.zeros((16, 6, 9), dtype=torch.float64, device=cuda),
                A.to(torch.float16), A.mT.contiguous().mT):
        with pytest.raises(ValueError):
            nk.minimal_nullspace(bad)


@pytest.mark.parametrize("joint,cameras,dtype,tol", [
    (False, 5, torch.float64, 1e-12), (True, 1, torch.float64, 1e-12),
    (True, 5, torch.float64, 1e-12), (True, 5, torch.float32, 1e-4)])
def test_schur_kernel_equals_plain_version(cuda, joint, cameras, dtype,
                                           tol):
    """Bundle adjustment's Schur product (K6) and its point sums against
    the plain version on the card, to `tol` of the largest entry (another
    summation order; float32 as the tools run BA), on
    chip_smoke.schur_case's layout: pinned images and intrinsic slots,
    held points, points seen once, an image seen by none and one by more
    than SEGMENT_CHUNK, a camera shared by every image (cameras = 1) or
    by all but four. Four launches a product; two launches give the same
    bits."""
    from chip_smoke import schur_case
    from dagsfm_tpu_torch.ops import schur_matvec as sxm
    S, x = schur_case(cuda, 60, 2000, joint, num_cameras=cameras)
    if dtype != torch.float64:
        S = sxm.system(S.prob, *(t if t is None else t.to(dtype)
                                 for t in S[1:-1]))
        x = tuple(t.to(dtype) for t in x)
    before = sxm.launches
    got = sxm.schur_mv(S, x)
    torch.cuda.synchronize()
    assert sxm.launches == before + 4
    again = sxm.schur_mv(S, x)
    for a, b, c in zip(got, again, sxm.schur_mv_reference(S, x)):
        assert torch.equal(a, b) and a.dtype == dtype
        assert float((a - c).abs().max()) <= tol * float(c.abs().max())
    t = sxm.point_sums(S, *x)
    ref = sxm.point_sums_reference(S, *x)
    assert torch.equal(t, sxm.point_sums(S, *x))
    assert float((t - ref).abs().max()) <= tol * float(ref.abs().max())


def test_schur_kernel_syncs_nothing(cuda):
    """S·x and the point sums run with no host synchronisation: the PCG's
    only read is its own stopping test."""
    from chip_smoke import schur_case
    from dagsfm_tpu_torch.ops import schur_matvec as sxm
    for joint in (False, True):
        S, x = schur_case(cuda, 60, 2000, joint)
        sxm.schur_mv(S, x)                        # builds and loads
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sxm.schur_mv(S, x)
            sxm.point_sums(S, *x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def test_schur_kernel_refuses_what_it_does_not_take(cuda):
    from chip_smoke import schur_case
    from dagsfm_tpu_torch.ops import schur_matvec as sxm
    S, (xp, xg) = schur_case(cuda, 20, 300, True)
    for bad in ((xp.float(), xg), (xp, xg[:-1]), (xp[:-1], xg),
                (xp.T.contiguous().T, xg)):
        with pytest.raises(ValueError):
            sxm.schur_mv(S, bad)
    blocks = S[1:-1]                      # Wc ... gfree
    for k, bad in ((0, S.Wc.float()), (0, S.Wc.half()),
                   (0, S.Wc.mT.contiguous().mT), (2, S.Vinv[:-1]),
                   (7, None)):
        args = list(blocks)
        args[k] = bad
        with pytest.raises(ValueError):
            sxm.system(S.prob, *args)


def test_mapper_controller_repeats_bit_for_bit_on_the_card(cuda):
    """Two disconnected 8-camera scenes through MapperController twice on
    the card: two models of 8, the same bits in both runs."""
    import dataclasses

    from dagsfm_tpu_torch.sfm.correspondence_graph import \
        CorrespondenceGraph
    from dagsfm_tpu_torch.sfm.mapper_controller import MapperController
    images, graph = {}, CorrespondenceGraph()
    for seed, off in ((2, 0), (3, 100)):
        sc = t_syn.generate(t_syn.SyntheticSceneSpec(
            num_cameras=8, num_points=250, pixel_noise=0.3, seed=seed))
        cams, ims, g = t_syn.to_matching_problem(sc)
        for i, im in ims.items():
            images[i + off] = dataclasses.replace(im, image_id=i + off)
            graph.add_image(i + off, len(im.xys))
        for (i, j), m in g.pair_matches.items():
            graph.add_matches(i + off, j + off, m)
    a, b = (MapperController(cams, images, graph, device=cuda).run()
            for _ in range(2))
    assert len(a) == len(b) == 2
    assert sorted(r.num_reg_images() for r in a) == [8, 8]
    for x, y in zip(a, b):
        _same_bits(x, y)


def _geometry_db(path: str):
    """A database of a planted 8-camera scene whose verified pairs cycle
    CALIBRATED (E), UNCALIBRATED (F) and PLANAR (H) rows."""
    from dagsfm_tpu_torch.ops import two_view_classify as t_tvc
    from dagsfm_tpu_torch.scene import io as t_io
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=8, num_points=300, pixel_noise=0.3, seed=6))
    K = sc.camera.calibration_matrix()
    Kinv = np.linalg.inv(K)
    configs = (t_tvc.CALIBRATED, t_tvc.UNCALIBRATED, t_tvc.PLANAR)
    with t_io.ColmapDatabase(path) as db:
        db.add_camera(sc.camera)
        slot = np.cumsum(sc.visible, axis=1) - 1
        for i in range(8):
            db.add_image(f"image{i + 1:05d}.jpg", sc.camera.camera_id,
                         image_id=i + 1)
            db.add_keypoints(i + 1, sc.pixels[i, sc.visible[i]])
        n = 0
        for i in range(8):
            for j in range(i + 1, 8):
                common = np.nonzero(sc.visible[i] & sc.visible[j])[0]
                if len(common) < 15:
                    continue
                R = sc.R[j] @ sc.R[i].T
                t = sc.t[j] - R @ sc.t[i]
                E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                              [-t[1], t[0], 0]]) @ R
                config = configs[n % 3]
                n += 1
                db.add_two_view_geometry(
                    i + 1, j + 1,
                    np.stack([slot[i, common], slot[j, common]], 1),
                    config=config,
                    E=E if config == t_tvc.CALIBRATED else None,
                    F=Kinv.T @ E @ Kinv
                    if config == t_tvc.UNCALIBRATED else None,
                    H=K @ (R + 0.1 * np.outer(t, [0, 0, 1])) @ Kinv
                    if config == t_tvc.PLANAR else None)
    return n


def test_pose_edges_from_a_database_on_the_card_equal_the_cpu(cuda,
                                                              tmp_path):
    from dagsfm_tpu_torch.pipeline.feature_pipeline import \
        load_two_view_geometries_from_database
    path = str(tmp_path / "database.db")
    n = _geometry_db(path)
    a = load_two_view_geometries_from_database(path, device=cuda)
    b = load_two_view_geometries_from_database(path, device="cpu")
    assert list(a) == list(b) and len(a) == n >= 9
    assert {v[3] for v in a.values()} == {2, 3, 4}
    for k, (R, t, ninl, config) in b.items():
        assert a[k][2:] == (ninl, config)
        np.testing.assert_allclose(a[k][0], R, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a[k][1], t, rtol=1e-9, atol=1e-12)


def test_threaded_clusters_equal_sequential_on_the_card(cuda):
    """The controller's clusters mapped on two threads on the card (one
    default stream, a torch.Generator per mapper) give the sequential
    run's local models to the bit."""
    from dagsfm_tpu_torch.clustering.image_clustering import \
        ClusteringOptions
    from dagsfm_tpu_torch.pipeline import distributed_mapper as t_dm
    from dagsfm_tpu_torch.sfm.incremental_mapper import MapperOptions
    sc, problem = _distributed_problem()
    opts = t_dm.DistributedMapperOptions(
        clustering=ClusteringOptions(num_images_ub=10, image_overlap=6),
        mapper=MapperOptions(init_min_num_inliers=30,
                             num_ransac_hypotheses=256, seed=11), seed=5)
    ctrl = t_dm.DistributedMapperController(*problem, opts, device=cuda)
    ctrl.build_view_graph()
    ctrl.filter_and_average_rotations()
    ctrl.cluster_scenes()
    seq = ctrl.reconstruct_partitions()
    thr = ctrl.reconstruct_partitions(num_threads=2)
    assert len(seq) == len(thr) >= 2
    for a, b in zip(seq, thr):
        _same_bits(a, b)


def _sharded_scene(cuda):
    from dagsfm_tpu_torch.ops import rotations as t_rops
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=12, num_points=250, pixel_noise=0.5, seed=3))
    arrays = t_syn.to_scene_arrays(sc, cuda)
    rng = np.random.default_rng(4)
    dq = t_rops.angleaxis_to_quat(torch.as_tensor(
        rng.normal(0, 0.01, (12, 3)), device=cuda))
    q = t_rops.quat_multiply(dq, arrays.image_qvec)
    q[:2] = arrays.image_qvec[:2]
    return arrays._replace(image_qvec=q, points_xyz=arrays.points_xyz
                           + torch.as_tensor(rng.normal(0, 0.05, tuple(
                               arrays.points_xyz.shape)), device=cuda))


@pytest.mark.parametrize("solver", ["dense", "iterative"])
def test_sharded_ba_eight_shards_equal_one_on_the_card(cuda, solver):
    """solve_sharded on one rank with D = 8 against D = 1 on the card,
    and against the CPU, to rel 1e-9."""
    from dagsfm_tpu_torch.parallel import ba_sharded as t_bs
    from dagsfm_tpu_torch.sfm import bundle_adjustment as t_ba
    arrays = _sharded_scene(cuda)
    opts = t_ba.BAOptions(max_iterations=4, solver=solver)
    runs = []
    for D, dev in ((1, cuda), (8, cuda), (8, "cpu")):
        prob, pts = t_bs.shard_problem(arrays, D, device=dev)
        out, st = t_bs.solve_sharded(prob, opts)
        runs.append((out.image_qvec.cpu().numpy(),
                     out.image_tvec.cpu().numpy(),
                     t_bs.gather_points(out, pts, arrays.points_xyz.shape[0]),
                     np.array([st.initial_cost, st.final_cost])))
    assert runs[0][3][1] < 0.5 * runs[0][3][0]
    for other in runs[1:]:
        for a, b in zip(other, runs[0]):
            np.testing.assert_allclose(a, b, rtol=1e-9,
                                       atol=1e-9 * np.abs(b).max())


@pytest.fixture
def four_cards(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: one NCCL rank a card")
    return 4


def test_sharded_ba_over_nccl_on_four_cards(four_cards, tmp_path):
    """solve_sharded with the intrinsics (joint PCG, D = 8) on four NCCL
    ranks, one card each (parallel.mesh.init_ranks): every rank on its
    own card holds the same result to the bit, equal to one process on
    the CPU to rel 1e-9; the ranks reduce over NCCL, 2 + 2 x 4 + the CG
    iterations times."""
    import multiprocessing as mp
    import socket

    import torch_ranks
    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=torch_ranks.nccl_rank,
                         args=(r, four_cards, address, str(tmp_path)))
             for r in range(four_cards)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz"))
             for r in range(four_cards)]
    assert [str(r["device"]) for r in ranks] == [f"cuda:{r}" for r in
                                                 range(four_cards)]
    assert all(str(r["backend"]) == "nccl" for r in ranks)
    for out in ranks[1:]:
        for k in ("qvec", "tvec", "cam_params", "points", "cost"):
            np.testing.assert_array_equal(out[k], ranks[0][k], err_msg=k)
    cpu = torch_ranks.sharded_solve("cpu")
    for k in ("qvec", "tvec", "cam_params", "points", "cost"):
        np.testing.assert_allclose(ranks[0][k], cpu[k], rtol=1e-9,
                                   atol=1e-9 * np.abs(cpu[k]).max(),
                                   err_msg=k)
    steps = torch_ranks.SHARDED_OPTIONS["max_iterations"]
    assert int(ranks[0]["allreduce"]) == 2 + 2 * steps + int(ranks[0]["cg"])
    assert ranks[0]["cost"][1] < 0.5 * ranks[0]["cost"][0]


def test_sharded_rotation_averaging_on_the_card(cuda):
    """estimate_rotations_sharded on the card with D = 8 and D = 1 equals
    the CPU's and the one-process solve to rel 1e-9."""
    from dagsfm_tpu_torch.estimation import rotation_averaging as t_ra
    edges, rels = _ra_problem(40, 3)
    whole = t_ra.estimate_rotations(40, edges, rels, device="cpu")
    for D in (1, 8):
        a = t_ra.estimate_rotations_sharded(40, edges, rels, num_shards=D,
                                            device=cuda)
        b = t_ra.estimate_rotations_sharded(40, edges, rels, num_shards=D,
                                            device="cpu")
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(a, whole, rtol=1e-9, atol=1e-9)


def test_parallel_entry_points_default_to_the_card(cuda, tmp_path):
    """The parallel layer's entry points run on the card when no device is
    named: their tensors and their results come from it."""
    from dagsfm_tpu_torch import interop
    from dagsfm_tpu_torch.estimation import rotation_averaging as t_ra
    from dagsfm_tpu_torch.parallel import ba_sharded as t_bs
    from dagsfm_tpu_torch.parallel import distributed as t_dist
    from dagsfm_tpu_torch.parallel import matching_sharded as t_ms
    arrays = _sharded_scene(cuda)
    prob, _ = t_bs.shard_problem(arrays, 2)
    assert all(getattr(prob, f).is_cuda for f in prob._fields)
    back = interop.sharded_problem({f: getattr(prob, f).cpu().numpy()
                                    for f in prob._fields})
    assert all(torch.equal(getattr(back, f), getattr(prob, f))
               for f in prob._fields)
    edges, rels = _ra_problem(12, 5)
    np.testing.assert_allclose(
        t_ra.estimate_rotations_sharded(12, edges, rels),
        t_ra.estimate_rotations_sharded(12, edges, rels, device="cpu"),
        rtol=1e-9, atol=1e-9)
    d1, _, m1, _ = planted_pairs(4, 64, seed=1, device="cpu")
    descs = {i: d1[i].float().numpy() for i in range(4)}
    masks = {i: m1[i].numpy() for i in range(4)}
    pairs = [(0, 1), (1, 2), (2, 3)]
    a = t_ms.match_pairs_sharded(descs, masks, pairs, num_shards=2)
    b = t_ms.match_pairs_sharded(descs, masks, pairs, num_shards=2,
                                 device="cpu")
    assert all(np.array_equal(a[p], b[p]) for p in pairs)
    ring = sorted((min(i, i % 12 + 1), max(i, i % 12 + 1))
                  for i in range(1, 13))
    jobs = t_dist.make_matching_jobs(ring, 2)
    assert len(jobs) == 2 and sorted(tuple(p) for j in jobs
                                     for p in j["pairs"]) == ring
    assert t_dist.init_multihost() == (0, 1)


def _clustered(n=3000, dim=64, centers=24, noise=0.15, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, dim))
    x = c[rng.integers(0, centers, n)] + noise * rng.normal(size=(n, dim))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _near_tie(x, cents, rel=1e-5):
    """Rows whose two nearest centroids tie within rel (f64 distances)."""
    d2 = ((x[:, None, :].astype(np.float64) - cents[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) <= rel * max(d2.max(), 1.0)


def test_kmeans_quantize_and_bow_on_the_card_equal_the_cpu(cuda):
    """k-means (the same generator draw: it is drawn on the CPU), tree
    descent and BoW histograms on the card against the CPU port, under
    the borderline rule; two runs on the card give the same bits (a
    one-hot product, no atomics)."""
    from dagsfm_tpu_torch.features import retrieval as t_rt
    from dagsfm_tpu_torch.features import visual_index as t_vi
    x = _clustered()
    cpu = t_rt.kmeans_fit(torch.as_tensor(x), t_rt.generator(5), 32, 10)
    runs = [t_rt.kmeans_fit(torch.as_tensor(x, device=cuda),
                            t_rt.generator(5), 32, 10) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    np.testing.assert_allclose(runs[0].cpu().numpy(), cpu.numpy(),
                               rtol=1e-5, atol=1e-6)
    flag = _near_tie(x, cpu.numpy())
    d2 = lambda c: (-2.0 * x.astype(np.float64) @ c.T  # noqa: E731
                    + (c.astype(np.float64) ** 2).sum(-1)).argmin(1)
    diff = d2(runs[0].cpu().numpy()) != d2(cpu.numpy())
    assert not (diff & ~flag).any(), int(diff.sum())

    tree = t_vi.build_vocab_tree(x, t_vi.VocabTreeOptions(), seed=1,
                                 device="cpu")
    tree_c = t_vi.VocabTree(tuple(lv.to(cuda) for lv in tree.levels),
                            tree.proj.to(cuda), tree.thresholds.to(cuda))
    w_cpu = t_vi.quantize(tree, torch.as_tensor(x)).numpy()
    w_gpu = [t_vi.quantize(tree_c, torch.as_tensor(x, device=cuda))
             for _ in range(2)]
    assert torch.equal(w_gpu[0], w_gpu[1])
    assert (w_gpu[0].cpu().numpy() != w_cpu).mean() < 1e-3

    desc = torch.as_tensor(x.reshape(30, 100, -1))
    mask = torch.ones(30, 100)
    mask[:, ::9] = 0
    h_cpu = t_rt.bow_histograms(desc, mask, cpu, 32)
    h_gpu = [t_rt.bow_histograms(desc.to(cuda), mask.to(cuda),
                                 cpu.to(cuda), 32) for _ in range(2)]
    assert torch.equal(h_gpu[0], h_gpu[1])
    moved = float((h_gpu[0].cpu() - h_cpu).abs().sum())
    assert moved <= 2 * int(_near_tie(x, cpu.numpy()).sum()), moved


def test_gabor_and_vlad_on_the_card_equal_the_cpu(cuda):
    from dagsfm_tpu_torch.features import global_descriptor as t_gd
    rng = np.random.default_rng(2)
    images = {i: rng.random((192, 256)).astype(np.float32)
              for i in range(1, 6)}
    images[6] = rng.random((90, 130)).astype(np.float32)
    a = t_gd.global_descriptors(images, device=cuda)
    b = t_gd.global_descriptors(images, device="cpu")
    for i in images:
        np.testing.assert_allclose(a[i], b[i], rtol=1e-5,
                                   atol=1e-5 * np.abs(b[i]).max())
    x = _clustered(n=1200, dim=128, seed=3)
    descs = {i: x[i * 200:(i + 1) * 200] for i in range(6)}
    masks = {i: np.arange(200) % 7 != 0 for i in range(6)}
    a = t_gd.vlad_descriptors(descs, masks, k=16, device=cuda)
    b = t_gd.vlad_descriptors(descs, masks, k=16, device="cpu")
    for i in descs:
        np.testing.assert_allclose(np.sign(a[i]) * a[i] ** 2,
                                   np.sign(b[i]) * b[i] ** 2, rtol=0,
                                   atol=1e-7)


def test_sift_dsp_and_affine_on_the_card_equal_the_cpu(cuda):
    """domain_size_pooling and estimate_affine_shape on the card against
    the CPU port: the same valid slots; positions within 1e-3 px;
    descriptors (squared, as tests/test_torch_sift.py holds them) within
    1e-5 where the orientations agree and the keypoint moved by at most
    1e-4 px; then two runs on the card give the same bits."""
    from dagsfm_tpu_torch.features import sift as t_sift
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=2, num_points=50, image_width=320, image_height=240,
        focal=343.0, seed=4, ring_radius=9.0, point_cloud_extent=3.5))
    images = t_syn.render_images(sc, device="cpu")
    batch = torch.as_tensor(np.stack([images[i] for i in sorted(images)]))
    opts = t_sift.SiftOptions(max_num_features=512, domain_size_pooling=True,
                              estimate_affine_shape=True)
    c = t_sift.extract(batch, opts)
    g, g2 = (t_sift.extract(batch.to(cuda), opts) for _ in range(2))
    for name, v in g._asdict().items():
        assert torch.equal(v, getattr(g2, name)), name
    m = c.mask.numpy()
    assert m.sum() > 100
    np.testing.assert_array_equal(g.mask.cpu().numpy(), m)
    dxy = np.abs(g.xy.cpu().numpy() - c.xy.numpy()).max(-1)
    assert dxy[m].max() < 1e-3
    dori = np.abs(np.angle(np.exp(1j * (g.orientation.cpu().numpy()
                                        - c.orientation.numpy()))))
    keep = m & (dori < 1e-6) & (dxy <= 1e-4)
    assert keep.sum() >= 0.95 * m.sum()
    np.testing.assert_allclose(g.descriptor.cpu().numpy()[keep] ** 2,
                               c.descriptor.numpy()[keep] ** 2, rtol=0,
                               atol=1e-5)


# ------------------------------------------------------------ the dense path

def _plane_scene(H=48, W=64, focal=60.0):
    """A textured plane z = 5 seen by a reference camera and three sources
    turned and moved a little (no image row or column maps exactly onto
    another's): (images, K, Rs, ts, true depth of the reference)."""
    from dagsfm_tpu_torch.ops import rotations as t_rops
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]])
    Rs = [np.eye(3)] + [t_rops.angleaxis_to_rotmat(torch.as_tensor(a)).numpy()
                        for a in ([0.01, -0.02, 0.015], [-0.015, 0.01, 0.02],
                                  [0.02, 0.01, -0.01])]
    ts = [np.zeros(3), np.array([-0.37, 0.02, 0.01]),
          np.array([0.03, -0.31, 0.02]), np.array([0.29, 0.21, -0.02])]
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)]).reshape(3, -1).astype(float)
    imgs, depth0 = [], None
    for R, t in zip(Rs, ts):
        d = R.T @ (np.linalg.inv(K) @ pix)
        o = -R.T @ t
        P = o[:, None] + d * (5.0 - o[2]) / d[2]
        u, v = P[0], P[1]
        tex = (np.sin(3.0 * u) * np.cos(2.0 * v)
               + 0.5 * np.sin(7.1 * u + 1.3) * np.sin(5.3 * v + 0.7)
               + 0.25 * np.sin(13.7 * u * v / 5.0))
        imgs.append(tex.reshape(H, W))
        if depth0 is None:
            depth0 = (R @ P + t[:, None])[2].reshape(H, W)
    return imgs, K, Rs, ts, depth0


def _sweep_args(imgs, K, Rs, ts, device, dtype):
    T = (lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device))
    R_rel = np.stack([R @ Rs[0].T for R in Rs[1:]])
    t_rel = np.stack([t - Rr @ ts[0] for Rr, t in zip(R_rel, ts[1:])])
    return (T(imgs[0]), T(np.stack(imgs[1:])), T(K),
            T(np.stack([K] * (len(imgs) - 1))), T(R_rel), T(t_rel))


def test_patch_match_on_the_card_equals_the_cpu(cuda):
    """Plane sweep, refinement (the same seeded draws) and normals in
    float64 on the card against the CPU port: depths to rel 1e-9 except
    where the CPU's best and second-best sweep costs tie within 1e-9 (and
    what the refinement carries from there); in float32, the plane."""
    from dagsfm_tpu_torch.mvs import patch_match as t_pm
    imgs, K, Rs, ts, truth = _plane_scene()
    opts = t_pm.PatchMatchOptions(num_depths=32, num_iterations=3)
    out = {}
    for dev in ("cpu", cuda):
        a = _sweep_args(imgs, K, Rs, ts, dev, torch.float64)
        sweep = t_pm.plane_sweep(*a, 3.0, 8.0, opts)
        d, n, c = t_pm.estimate_depth_map(torch.Generator().manual_seed(1),
                                          *a, 3.0, 8.0, opts)
        out[str(dev)] = [x.cpu().numpy() for x in (*sweep, d, n, c)]
    cpu, gpu = out["cpu"], out[str(cuda)]
    a = _sweep_args(imgs, K, Rs, ts, "cpu", torch.float64)
    vol = t_pm._multi_view_cost(
        a[0], a[1], torch.linalg.inv(a[2]), *a[3:],
        (1.0 / t_pm.depth_hypotheses(3.0, 8.0, 32))[:, None, None].expand(
            32, *a[0].shape), opts).numpy()
    srt = np.sort(vol, 0)
    ties = srt[1] - srt[0] < 1e-9
    differ = np.abs(gpu[0] - cpu[0]) > 1e-9 * cpu[0]
    assert not (differ & ~ties).any()
    refined = np.abs(gpu[2] - cpu[2]) > 1e-9 * cpu[2]
    assert refined.mean() <= 0.01 + ties.mean() * 25
    np.testing.assert_allclose(gpu[3][~refined], cpu[3][~refined], rtol=0,
                               atol=1e-6)
    a32 = _sweep_args(imgs, K, Rs, ts, cuda, torch.float32)
    d32, _, _ = t_pm.estimate_depth_map(torch.Generator().manual_seed(1),
                                        *a32, 3.0, 8.0, opts)
    assert d32.dtype == torch.float32
    err = np.abs(d32.cpu().numpy() - truth)[8:-8, 8:-8] / 5.0
    assert np.median(err) < 0.02


def test_fusion_on_the_card_equals_the_cpu(cuda):
    """Consistency masks and the fused cloud of the true depth maps (one
    view corrupted), float64, on the card against the CPU."""
    from dagsfm_tpu_torch.mvs import fusion as t_fus
    imgs, K, Rs, ts, _ = _plane_scene()
    depths = []
    for R, t in zip(Rs, ts):
        H, W = imgs[0].shape
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        d = R.T @ (np.linalg.inv(K) @ np.stack(
            [xs, ys, np.ones_like(xs)]).reshape(3, -1))
        o = -R.T @ t
        P = o[:, None] + d * (5.0 - o[2]) / d[2]
        depths.append((R @ P + t[:, None])[2].reshape(H, W))
    depths[2] = depths[2] * 1.3
    a = t_fus.fuse(depths, [None] * 4, imgs, [K] * 4, Rs, ts,
                   device="cpu")
    b = t_fus.fuse(depths, [None] * 4, imgs, [K] * 4, Rs, ts, device=cuda)
    assert len(a["xyz"]) == len(b["xyz"]) > 3000
    np.testing.assert_allclose(b["xyz"], a["xyz"], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(b["num_consistent"], a["num_consistent"])


def test_poisson_splat_repeats_bit_for_bit_on_the_card(cuda):
    """The splat sums each cell in a fixed order (no atomics): two runs on
    the card give the same grid and the same mesh, within rel 1e-12 of
    the CPU's grid and with the CPU's triangles."""
    from dagsfm_tpu_torch.mvs import poisson as t_po
    rng = np.random.default_rng(4)
    v = rng.normal(size=(20000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    xyz = v + rng.normal(0, 0.005, v.shape)
    G = 64
    pts = (xyz - xyz.min(0)) / (np.ptp(xyz, 0).max() / (G - 1))
    vals = np.concatenate([v, np.ones((len(v), 1))], 1)
    grids = [t_po._trilinear_scatter(
        (G, G, G, 4), torch.as_tensor(pts, device=cuda),
        torch.as_tensor(vals, device=cuda)) for _ in range(2)]
    assert torch.equal(grids[0], grids[1])
    cpu = t_po._trilinear_scatter((G, G, G, 4), torch.as_tensor(pts),
                                  torch.as_tensor(vals))
    assert float((grids[0].cpu() - cpu).abs().max()) <= \
        1e-12 * float(cpu.abs().max())
    opts = t_po.PoissonOptions(grid=G)
    m1, m2 = (t_po.poisson_mesh(xyz, v, opts, device=cuda) for _ in range(2))
    assert np.array_equal(m1[0], m2[0]) and np.array_equal(m1[1], m2[1])
    mc = t_po.poisson_mesh(xyz, v, opts, device="cpu")
    assert np.array_equal(m1[1], mc[1])
    np.testing.assert_allclose(m1[0], mc[0], rtol=0, atol=1e-9)


def test_undistortion_on_the_card_equals_the_cpu(cuda):
    """undistort_image (every pixel off the in-bounds limits, rel 1e-9)
    and undistort_reconstruction's keypoints on the card against the CPU,
    for a radial, a fisheye and an OpenCV camera."""
    from dagsfm_tpu_torch.scene import cameras as t_cm
    from dagsfm_tpu_torch.scene import undistortion as t_und
    from dagsfm_tpu_torch.scene.reconstruction import (ImageRecord,
                                                       Reconstruction)
    rng = np.random.default_rng(5)
    img = rng.random((96, 128)).astype(np.float32)
    for mid, params in ((t_cm.SIMPLE_RADIAL, (110.0, 64.3, 47.9, -0.12)),
                        (t_cm.OPENCV_FISHEYE, (110.0, 111.0, 64.2, 48.1,
                                               0.05, -0.01, 0.002, 0.0)),
                        (t_cm.OPENCV, (110.0, 111.0, 64.2, 48.1, -0.08,
                                       0.01, 0.002, -0.001))):
        cam = t_cm.Camera(1, mid, 128, 96, params)
        a = t_und.undistort_image(img, cam, device="cpu")
        b = t_und.undistort_image(img, cam, device=cuda)
        both = (a != 0) & (b != 0)
        assert (a != b).sum() - (both & (a != b)).sum() <= 2 * (96 + 128)
        np.testing.assert_allclose(b[both], a[both], rtol=1e-9, atol=0)
        rec = Reconstruction()
        rec.add_camera(cam)
        for i in range(3):
            rec.add_image(ImageRecord(i, f"im{i}", 1, np.array([1.0, 0, 0, 0]),
                                      np.zeros(3), rng.uniform(0, 1, (40, 2))
                                      * [128, 96], np.full(40, -1)))
        ra = t_und.undistort_reconstruction(rec, device="cpu")
        rb = t_und.undistort_reconstruction(rec, device=cuda)
        for i in rec.images:
            np.testing.assert_allclose(rb.images[i].xys, ra.images[i].xys,
                                       rtol=1e-9, atol=1e-9)


def test_dense_reconstruct_defaults_to_the_card(cuda, tmp_path):
    """dense_reconstruct with no device runs on the card (float32) and
    finds the plane; its maps and fused.ply are written."""
    from dagsfm_tpu_torch.mvs import controller as t_ctl
    from dagsfm_tpu_torch.mvs import patch_match as t_pm
    from dagsfm_tpu_torch.ops import rotations as t_rops
    from dagsfm_tpu_torch.scene import cameras as t_cm
    from dagsfm_tpu_torch.scene.reconstruction import (ImageRecord,
                                                       Reconstruction)
    imgs, K, Rs, ts, _ = _plane_scene()
    H, W = imgs[0].shape
    rec = Reconstruction()
    rec.add_camera(t_cm.Camera(0, t_cm.PINHOLE, W, H,
                               (K[0, 0], K[1, 1], K[0, 2], K[1, 2])))
    rng = np.random.default_rng(0)
    Pw = np.column_stack([rng.uniform(-2, 2, 30), rng.uniform(-1.5, 1.5, 30),
                          np.full(30, 5.0)])
    for iid, (R, t) in enumerate(zip(Rs, ts)):
        Pc = Pw @ R.T + t
        xy = Pc[:, :2] / Pc[:, 2:] * K[0, 0] + K[:2, 2]
        rec.add_image(ImageRecord(iid, f"im{iid}.png", 0,
                                  t_rops.rotmat_to_quat_np(R), t, xy,
                                  np.full(30, -1, np.int64)))
        rec.register_image(iid)
    for k in range(30):
        rec.add_point3D(Pw[k], [(i, k) for i in range(4)])
    opts = t_ctl.DenseOptions(
        patch_match=t_pm.PatchMatchOptions(num_depths=32, num_iterations=3))
    fused = t_ctl.dense_reconstruct(rec, dict(enumerate(imgs)),
                                    str(tmp_path), opts)
    assert len(fused["xyz"]) > 2000
    assert abs(np.median(fused["xyz"][:, 2]) - 5.0) < 0.05
    assert (tmp_path / "fused.ply").exists()


def test_rig_ba_repeats_bit_for_bit_on_the_card(cuda):
    """Rig BA (dense J scattered from its blocks, JᵀJ, one dense solve
    per iteration) gives the same bits twice on the card and agrees with
    the CPU to rel 1e-7."""
    from chip_smoke import rig_config, rig_scene
    from dagsfm_tpu_torch.scene import camera_rig as t_rig
    from dagsfm_tpu_torch.sfm import rig_bundle_adjustment as t_rba
    import json
    import tempfile
    rec, _ = rig_scene(12, 300, seed=1)
    with tempfile.TemporaryDirectory() as d:
        with open(d + "/rig.json", "w") as f:
            json.dump(rig_config(), f)
        rigs = t_rig.read_rig_config(d + "/rig.json", rec)
    outs = []
    for dev in (cuda, cuda, "cpu"):
        prob, _ = t_rig.make_rig_ba_problem(rec, rigs, device=dev)
        outs.append(t_rba.solve(prob, t_rba.RigBAOptions(max_iterations=20)))
    for a, b, c in zip(*outs):
        assert torch.equal(a, b)
        c = c.numpy()
        assert np.abs(a.cpu().numpy() - c).max() <= \
            1e-7 * max(np.abs(c).max(), 1.0)
    assert float(outs[0].final_cost) < 0.2 * float(outs[0].initial_cost)


def test_generalized_pose_on_the_card_equals_the_cpu(cuda):
    """gpnp (batched over hypotheses) and the 17-point solver (batched
    SVDs: cuSOLVER on the card, LAPACK here) agree within 1e-9, and
    their residuals too."""
    from chip_smoke import _rig_ray_pairs, rig_rays, rig_scene
    from dagsfm_tpu_torch.ops import generalized_pose as t_gp
    _, truth = rig_scene(12, 300, seed=1)
    X, o, d, _, _ = rig_rays(truth, 0)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.choice(len(X), 8, replace=False) for _ in range(256)])
    res = {}
    for dev in (cuda, "cpu"):
        T = (lambda a: torch.as_tensor(a[idx], device=dev))
        M, v = t_gp.gpnp(T(X), T(o), T(d))
        r = t_gp.gpnp_ray_residual(
            M[:, 0], *(torch.as_tensor(a, device=dev)[None]
                       for a in (X, o, d)))
        res[str(dev)] = (M.cpu(), v.cpu(), r.cpu())
    a, b = res["cuda"], res["cpu"]
    assert torch.equal(a[1], b[1])
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(a[2].numpy(), b[2].numpy(), rtol=1e-9,
                               atol=1e-12)
    # windows of 17 consecutive pairs: their cameras vary, so each
    # system has one null vector (a random 17-subset can have two)
    q1, c1, q2, c2 = _rig_ray_pairs(truth, 0, 1)
    pick = (np.arange(256)[:, None] + np.arange(17)) % len(q1)
    res = {}
    for dev in (cuda, "cpu"):
        args = [torch.as_tensor(a[pick], device=dev) for a in (q1, c1, q2,
                                                                 c2)]
        M, v = t_gp.generalized_relative_pose_17pt(*args)
        r = t_gp.gec_residual(M[:, 0], *args)
        res[str(dev)] = (M.cpu(), v.cpu(), r.cpu())
    a, b = res["cuda"], res["cpu"]
    assert torch.equal(a[1], b[1])
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(a[2].numpy(), b[2].numpy(), rtol=1e-6,
                               atol=1e-20)


def test_hough_repeats_bit_for_bit_and_equals_the_cpu_on_the_card(cuda):
    """The Hough accumulator sums its votes in a fixed order on the card
    (no atomics): two runs equal to the bit; the CPU's within 1e-5 of
    the largest bin but next to pixels whose bin rounding decides."""
    from chip_smoke import line_images
    from dagsfm_tpu_torch.estimation import coordinate_frame as cf
    rec = t_syn.to_reconstruction(t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=3, num_points=50, seed=1)))
    for img in line_images(rec).values():
        x = torch.as_tensor(img, device=cuda)
        a, rho_max = cf._hough_accumulate(x)
        b, _ = cf._hough_accumulate(x)
        assert torch.equal(a, b)
        c, rho_cpu = cf._hough_accumulate(torch.as_tensor(img))
        assert rho_cpu == rho_max
        gap = (a.cpu() - c).abs()
        assert int((gap > 1e-5 * float(c.max())).sum()) <= 8
        on_card = cf.detect_lines(x, device=cuda)
        on_cpu = cf.detect_lines(img, device="cpu")
        assert np.array_equal(on_card[2], on_cpu[2])


def test_solvers_on_the_card_equal_the_cpu(cuda):
    """ADMM and the block SDP on the card against the CPU port (float64;
    the products and Cholesky factors sum in other orders)."""
    from dagsfm_tpu_torch.ops import rotations as rops
    from dagsfm_tpu_torch.solvers import admm, sdp
    rng = np.random.default_rng(3)
    A = rng.normal(0, 1, (300, 20))
    b = A @ rng.normal(0, 1, 20)
    b[:40] += 8.0
    opts = admm.ADMMOptions(max_iterations=200)
    x_gpu = admm.l1_regression(torch.as_tensor(A, device=cuda),
                               torch.as_tensor(b, device=cuda), opts)[0]
    x_cpu = admm.l1_regression(torch.as_tensor(A), torch.as_tensor(b),
                               opts)[0]
    np.testing.assert_allclose(x_gpu.cpu().numpy(), x_cpu.numpy(),
                               rtol=0, atol=1e-9)
    n = 12
    R = rops.angleaxis_to_rotmat(torch.as_tensor(
        rng.normal(0, 0.8, (n, 3)))).numpy()
    C = np.zeros((3 * n, 3 * n))
    for i in range(n):
        for j in range(i + 1, n):
            C[3 * i:3 * i + 3, 3 * j:3 * j + 3] = (R[j] @ R[i].T).T
            C[3 * j:3 * j + 3, 3 * i:3 * i + 3] = R[j] @ R[i].T
    Y_gpu = sdp.solve_block_sdp(torch.as_tensor(C, device=cuda), n, 20)
    Y_cpu = sdp.solve_block_sdp(torch.as_tensor(C), n, 20)
    np.testing.assert_allclose(Y_gpu.cpu().numpy(), Y_cpu.numpy(), rtol=0,
                               atol=1e-9)


def test_robust_estimate_on_the_card_equals_the_cpu(cuda):
    """The same samples on both devices: the same model and inliers."""
    from dagsfm_tpu_torch.ops import ransac_variants as rv

    def solver(xs, ys):
        a, b = ys[1] - ys[0], xs[0] - xs[1]
        n = torch.sqrt(a * a + b * b)
        return (torch.stack([a / n, b / n, -(a * xs[0] + b * ys[0]) / n])
                [None], (n > 1e-9)[None])

    def residual(m, xs, ys):
        return (m[0] * xs + m[1] * ys + m[2]) ** 2

    rng = np.random.default_rng(4)
    x = rng.uniform(-5, 5, 400)
    y = 2 * x + 1 + rng.normal(0, 0.01, 400)
    y[:100] += 5.0
    idx = torch.as_tensor(rng.integers(0, 400, (256, 2)))
    idx = idx[idx[:, 0] != idx[:, 1]]
    for scoring in ("msac", "lmeds"):
        out = [rv.robust_estimate(
            solver, residual, (torch.as_tensor(x, device=d),
                               torch.as_tensor(y, device=d)),
            torch.ones(400, dtype=torch.bool, device=d), 2, 0.01,
            scoring=scoring, sample_idx=idx.to(d)) for d in (cuda, "cpu")]
        np.testing.assert_allclose(out[0].model.cpu().numpy(),
                                   out[1].model.numpy(), rtol=0, atol=1e-12)
        assert torch.equal(out[0].inliers.cpu(), out[1].inliers)


def test_e2e_1000_repeats_bit_for_bit_on_the_card(cuda, tmp_path,
                                                  monkeypatch):
    """The 1000-image tool at 20 images, twice on the card: K1 launches,
    the gates hold, and the merged models (after the final BA) are the
    same registered images and the same bits in their .bin files."""
    from dagsfm_tpu_torch.pipeline.distributed_mapper import \
        DistributedMapperController
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.tools import e2e_1000

    merged = []
    final_ba = DistributedMapperController.adjust_global_bundle

    def keep(self, rec):
        out = final_ba(self, rec)
        merged.append(rec)
        return out

    monkeypatch.setattr(DistributedMapperController, "adjust_global_bundle",
                        keep)
    records = [e2e_1000.run(20, device=cuda, log=open(os.devnull, "w"))
               for _ in range(2)]
    assert all(r["k1_launches"] > 0 and r["registered"] >= 18
               and r["ate"] < 0.15 for r in records)
    assert records[0]["ate"] == records[1]["ate"]
    assert merged[0].reg_image_ids == merged[1].reg_image_ids
    files = []
    for k, m in enumerate(merged):
        scene_io.write_model_bin(m, str(tmp_path / str(k)))
        files.append({f: (tmp_path / str(k) / f).read_bytes()
                      for f in ("cameras.bin", "images.bin",
                                "points3D.bin")})
    assert files[0] == files[1]


# ----------------------------------------------- spans on the profiler clock

def _planted_pipeline(device):
    """A FeaturePipeline on planted features of 6 images, every pair."""
    from dagsfm_tpu_torch.pipeline import feature_pipeline as t_fp
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=6, num_points=150, seed=3, max_track_length=4))
    kps, descs, masks = plant_features(sc, K=256, seed=3)
    ids = sorted(kps)
    fp = t_fp.FeaturePipeline({i: None for i in ids},
                              {i: sc.camera for i in ids},
                              t_fp.FeaturePipelineOptions(
                                  num_ransac_hypotheses=64),
                              device=device)
    fp.keypoints, fp.descriptors, fp.masks = kps, descs, masks
    fp.bank = t_fm.make_bank(descs, masks, ids, device=device)
    return fp, [(i, j) for i in ids for j in ids if i < j]


def test_k1_launch_falls_inside_the_match_span(cuda):
    """In a trace of the card's activity alone, the CUDA call that
    launched K1 lies between the stamps the `match` span's root record
    keeps: the spans are on the profiler's clock. That trace holds no
    event of a span, so none can cover the card's idle gaps in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dagsfm_tpu_torch.utils import observability as obs
    fp, pairs = _planted_pipeline(cuda)
    fp.match_and_verify(pairs)                     # K1 built
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fp.match_and_verify(pairs)
        torch.cuda.synchronize()
    rec = obs.roots()[-1]
    assert rec["name"] == "verify.job" and rec["profiled"]
    (s0, s1), = [(a, b) for n, a, b in rec["stamps"] if n == "match"]
    events = list(prof.profiler.kineto_results.events())
    k1 = {e.correlation_id() for e in events
          if e.device_type() == DeviceType.CUDA and "match_tiles" in e.name()}
    launches = [e for e in events if e.device_type() != DeviceType.CUDA
                and "LaunchKernel" in e.name() and e.correlation_id() in k1]
    assert k1 and len(launches) == len(k1)
    for e in launches:
        assert s0 <= e.start_ns() and e.start_ns() + e.duration_ns() <= s1
    assert not [e.name() for e in events if e.name() in rec["spans"]]


def test_profiler_trace_holds_spans_and_kernels_on_the_card(cuda, tmp_path):
    """profiler_trace writes one Chrome trace with the program's spans,
    the kernels and the CUDA calls that launched them; K1's launch lies
    inside the `match` span."""
    import json

    from dagsfm_tpu_torch.utils import observability as obs
    fp, pairs = _planted_pipeline(cuda)
    fp.match_and_verify(pairs)
    with obs.profiler_trace(str(tmp_path)):
        fp.match_and_verify(pairs)
    ev = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in ev if e.get("cat") == "user_annotation"}
    assert {"verify.job", "match", "verify", "verify.pack", "verify.sample",
            "verify.ransac.E", "verify.ransac.F", "verify.ransac.H",
            "verify.pose", "verify.read", "verify.select"} <= set(spans)
    corr = {e["args"]["correlation"] for e in ev if e.get("cat") == "kernel"
            and "match_tiles" in e["name"]}
    launches = [e for e in ev if e.get("cat") == "cuda_runtime"
                and e.get("args", {}).get("correlation") in corr]
    m = spans["match"]
    assert corr and len(launches) == len(corr)
    for e in launches:
        assert m["ts"] <= e["ts"] and e["ts"] + e["dur"] <= m["ts"] + m["dur"]


# ------------------------------------------ the minimal-nullspace kernel
# The profiled test below comes after the span tests: profiled earlier
# in the file, it left their later CUDA-only traces without a kernel on
# the H100 (each passed alone and right after it).


def _pixel_rows(n_pairs: int, n: int, seed: int):
    """classify_pairs rows: n_pairs general two-view scenes of n pixel
    correspondences at f = 800, 30 % outliers."""
    from dagsfm_tpu_torch.ops import rotations as t_rops
    rng = np.random.default_rng(seed)
    K = np.array([[800.0, 0, 512], [0, 800.0, 384], [0, 0, 1]])
    rows = []
    for k in range(n_pairs):
        X = rng.uniform(-2, 2, (n, 3)) + [0, 0, 8]
        R = t_rops.angleaxis_to_rotmat(
            torch.as_tensor(rng.normal(size=3) * 0.1)).numpy()
        X2 = X @ R.T + np.array([1.0, 0.2, 0.1])
        p1 = X[:, :2] / X[:, 2:] * 800 + [512, 384]
        p2 = X2[:, :2] / X2[:, 2:] * 800 + [512, 384]
        p2 = p2 + rng.normal(size=(n, 2)) * 0.5
        bad = rng.random(n) < 0.3
        p2[bad] = rng.uniform([0, 0], [1024, 768], (bad.sum(), 2))
        rows.append(((k, k + 1), p1, p2, K, K, (1024, 768), (1024, 768),
                     True))
    return rows


def test_verification_batch_runs_the_nullspace_kernel_alone(cuda,
                                                            monkeypatch):
    """A 64-pair classify_pairs batch at 1,024 matches under a root: one
    kernel launch per estimator, 64 x 256 x 3 systems counted, a trace
    of the card that holds no orgqr or larft kernel and fewer cuSOLVER
    helper kernels (lacpy, batch_eye, copy_info) than pairs (the batch's
    few eigh and svd calls launch some; the library's QR launched them
    per system), and the same answers as with the library's complete QR
    in the kernel's place."""
    from torch.profiler import ProfilerActivity, profile

    from dagsfm_tpu_torch.ops import epipolar as epi
    from dagsfm_tpu_torch.ops import nullspace_kernel as nk
    from dagsfm_tpu_torch.ops import two_view_classify as tvc
    from dagsfm_tpu_torch.utils import observability as obs
    rows = _pixel_rows(64, 1024, seed=3)
    opts = tvc.TwoViewOptions()
    tvc.classify_pairs(rows, opts, seed=0, device=cuda)      # built, warm
    before = nk.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with obs.span("verify.job"):
            out = tvc.classify_pairs(rows, opts, seed=0, device=cuda)
        torch.cuda.synchronize()
    assert nk.launches == before + 3
    assert obs.roots()[-1]["counters"]["nullspace_systems"] == 64 * 256 * 3
    kernel_nullspace = epi._nullspace_k

    def library_nullspace(A, k):
        if A.shape[-2] + k != A.shape[-1]:
            return kernel_nullspace(A, k)
        return torch.linalg.qr(A.mT, mode="complete")[0][..., A.shape[-2]:]

    monkeypatch.setattr(epi, "_nullspace_k", library_nullspace)
    lib = tvc.classify_pairs(rows, opts, seed=0, device=cuda)
    assert nk.launches == before + 3 and lib.keys() == out.keys()
    for pk, a in out.items():
        b = lib[pk]
        assert (a.config, a.num_inliers) == (b.config, b.num_inliers), pk
        np.testing.assert_array_equal(a.inlier_mask, b.inlier_mask)
    counts = {e.key: e.count for e in prof.key_averages()}
    assert any("minimal_nullspace" in k for k in counts)
    assert not [k for k in counts if "orgqr" in k or "larft" in k]
    assert sum(n for k, n in counts.items() if any(
        w in k for w in ("lacpy", "batch_eye", "copy_info"))) < 64
