"""The CUDA kernel on the card: the fused matcher against its plain
version, its input checks and its launch count, and the matcher path
through it. Every test here needs a CUDA card and skips without one.

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
    assert j.dtype == torch.int32 and j.shape == (8, K)
    assert torch.equal(j, ref)
    assert bool((j[0] == -1).all())          # every column masked


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
    for pk in cpu:
        np.testing.assert_array_equal(gpu[pk], cpu[pk])
    assert sum(len(m) for m in cpu.values()) > 100
