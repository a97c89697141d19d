"""Port matcher vs the JAX reference.

`fused_match_j_reference` (the kernel's plain version, which the CPU
path runs) against the Pallas kernel in interpret mode; the port's
`match_pairs` against the reference's; the CUDA kernel itself is held
against the plain version on the card by chip_smoke.py and by
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.features import matching as j_fm
from dagsfm_tpu.ops import pallas_matcher as pm
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.features import matching as t_fm
from dagsfm_tpu_torch.ops import matcher_kernel as mk

torch.set_num_threads(1)


def planted(B, K, seed, common_frac=0.3, noise=0.02):
    """Non-negative unit descriptors with planted matches and masks."""
    rng = np.random.default_rng(seed)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    d1 = unit(np.abs(rng.normal(size=(B, K, 128))))
    d2 = unit(np.abs(rng.normal(size=(B, K, 128))))
    c = int(K * common_frac)
    for b in range(B):
        perm = rng.permutation(K)[:c]
        d2[b, perm] = unit(np.clip(d1[b, :c] + rng.normal(0, noise, (c, 128)),
                                   0, None))
    m1 = rng.random((B, K)) > 0.1
    m2 = rng.random((B, K)) > 0.1
    m1[:, -K // 8:] = False
    m2[-1, :] = False                  # a pair with every column masked
    return (d1.astype(np.float32), d2.astype(np.float32), m1, m2)


@pytest.mark.parametrize("K", [256, 2048])
@pytest.mark.parametrize("cross_check", [True, False])
def test_plain_version_matches_pallas_kernel(K, cross_check):
    d1, d2, m1, m2 = planted(2, K, seed=K + cross_check)
    ref = np.asarray(pm.pallas_match_j_batch(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2),
        cross_check=cross_check, interpret=True))
    port = mk.fused_match_j_reference(
        torch.as_tensor(d1), torch.as_tensor(d2), torch.as_tensor(m1),
        torch.as_tensor(m2), cross_check=cross_check).numpy()
    np.testing.assert_array_equal(port, ref)
    assert (ref >= 0).sum() > 0.2 * K
    assert (ref[-1] == -1).all()


def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    d1, d2, m1, m2 = (torch.as_tensor(a) for a in planted(2, 128, seed=1))
    before = mk.launches
    j = mk.fused_match_j(d1.to(torch.bfloat16), d2.to(torch.bfloat16), m1,
                         m2)
    np.testing.assert_array_equal(
        j.numpy(), mk.fused_match_j_reference(d1, d2, m1, m2).numpy())
    assert mk.launches == before


def test_ties_take_the_first_index():
    """Duplicate columns: argbest is the first, second equals best (ratio
    test fails); duplicate rows: the mutual check picks the first row."""
    rng = np.random.default_rng(3)
    d = np.abs(rng.normal(size=(1, 128, 128)))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d2 = d.copy()
    d2[0, 5] = d2[0, 2]                  # column 2 duplicated at 5
    d1 = d.copy()
    d1[0, 6] = d1[0, 3]                  # row 3 duplicated at 6
    m = np.ones((1, 128), bool)
    args = [jnp.asarray(d1, jnp.float32), jnp.asarray(d2, jnp.float32),
            jnp.asarray(m), jnp.asarray(m)]
    for cross in (True, False):
        ref = np.asarray(pm.pallas_match_j_batch(*args, cross_check=cross,
                                                 max_ratio=1.01,
                                                 interpret=True))
        port = mk.fused_match_j_reference(
            *(torch.as_tensor(np.asarray(a)) for a in args), max_ratio=1.01,
            cross_check=cross).numpy()
        np.testing.assert_array_equal(port, ref)


def test_match_pair_batch_matches_reference():
    d1, d2, m1, m2 = planted(3, 192, seed=5)
    jm, jn = j_fm.match_pair_batch(jnp.asarray(d1), jnp.asarray(d2),
                                   jnp.asarray(m1), jnp.asarray(m2))
    tm, tn = t_fm.match_pair_batch(*(torch.as_tensor(a)
                                     for a in (d1, d2, m1, m2)))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def _planted_images(n_img, K, seed):
    from chip_smoke import plant_features
    from dagsfm_tpu_torch.scene import synthetic
    sc = synthetic.generate(synthetic.SyntheticSceneSpec(
        num_cameras=n_img, num_points=150, seed=seed, max_track_length=4))
    return plant_features(sc, K=K, seed=seed)


def test_match_pairs_equals_reference_dict():
    _, descs, masks = _planted_images(6, 256, seed=3)
    ids = sorted(descs)
    pairs = [(i, j) for i in ids for j in ids if i < j]
    opts = t_fm.MatchingOptions(max_num_matches=40)
    ref = j_fm.match_pairs(descs, masks, pairs,
                           j_fm.MatchingOptions(max_num_matches=40),
                           use_pallas=False)
    bank = interop.descriptor_bank(descs, masks, ids, device="cpu")
    for kw in ({"device": "cpu"}, {"bank": bank}):
        port = t_fm.match_pairs(descs, masks, pairs, opts, batch_size=4,
                                **kw)
        assert port.keys() == ref.keys()
        for pk in ref:
            assert port[pk].dtype == np.uint32
            np.testing.assert_array_equal(port[pk], ref[pk])
    assert sum(len(m) for m in ref.values()) > 100
    assert max(len(m) for m in ref.values()) == 40    # truncation exercised


def test_bank_is_bf16_and_slots_follow_ids():
    _, descs, masks = _planted_images(3, 192, seed=1)
    bank = t_fm.make_bank(descs, masks, [3, 1, 2], device="cpu")
    assert bank.desc.dtype == torch.bfloat16 and bank.slot == {3: 0, 1: 1,
                                                               2: 2}
    np.testing.assert_array_equal(bank.mask[0].numpy(), masks[3])
    assert t_fm.match_pairs(descs, masks, [], device="cpu") == {}
    dev_bank = t_fm.make_bank_from_device(
        [3, 1, 2], bank.desc.float(), bank.mask.to(torch.uint8))
    assert dev_bank.slot == bank.slot
    assert torch.equal(dev_bank.desc, bank.desc)
    assert torch.equal(dev_bank.mask, bank.mask)
    pairs = [(1, 2), (1, 3), (2, 3)]
    assert {k: v.tolist() for k, v in t_fm.match_pairs(
        descs, masks, pairs, bank=dev_bank).items()} == \
        {k: v.tolist() for k, v in t_fm.match_pairs(
            descs, masks, pairs, device="cpu").items()}
