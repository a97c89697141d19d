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
edges read from a database agree with the CPU. Every test here needs a
CUDA card and skips without one.

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:xdist \
        -p no:cacheprovider -o addopts=""
"""
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
