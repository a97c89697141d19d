"""The CUDA kernels on the card: the fused matcher (K1) and the top-2
matchers (K2, K3, K4) against their plain versions, their input checks
and launch counts, the matcher path through K1, and that the kernels,
mapping and SIFT repeat bit for bit on the card. K1, K2 and K4 multiply
on the bf16 tensor cores and are held to the borderline rule (scores
within EPS; an index may differ only where the plain scores put it
within 2 EPS of a tie or a threshold); K3 (one ordered FMA chain per
score) and match_one_pair equal their plain versions to the bit. Every
test here needs a CUDA card and skips without one.

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:xdist \
        -p no:cacheprovider -o addopts=""
"""
import numpy as np
import pytest
import torch

from chip_smoke import plant_features, planted_pairs
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
