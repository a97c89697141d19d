"""The plain versions of K2, K3 and K4 and the entry points on them,
against the Pallas kernels in interpret mode.

K2 `pallas_top2_batch`, K3 `pallas_top2` and `pallas_match` run with
`interpret=True`; K4's `_mk_kernel(mode)` (tools/matcher_mfu.py) runs in
this file's own `pl.pallas_call(..., interpret=True)` with the tool's
module globals B, K and TILE_J patched small. Indices must be equal;
best and second agree within 2e-6 (the reference sums the 128 products
in XLA's order, the port in index order). The CUDA kernels themselves
are held against these plain versions on the card (chip_smoke.py,
tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dagsfm_tpu.ops import pallas_matcher as pm
from dagsfm_tpu_torch.ops import matcher_kernel as mk
from dagsfm_tpu_torch.ops import top2_matcher as tm
from tools import matcher_mfu as jmfu

torch.set_num_threads(1)

TOL = 2e-6


def planted(B, K, seed, common_frac=0.3, noise=0.02, K2=None):
    """Non-negative unit descriptors with planted matches, masked rows,
    masked columns and (for B > 1) a pair with every column masked."""
    rng = np.random.default_rng(seed)
    K2 = K if K2 is None else K2

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    d1 = unit(np.abs(rng.normal(size=(B, K, 128))))
    d2 = unit(np.abs(rng.normal(size=(B, K2, 128))))
    c = int(min(K, K2) * common_frac)
    for b in range(B):
        perm = rng.permutation(K2)[:c]
        d2[b, perm] = unit(np.clip(d1[b, :c] + rng.normal(0, noise, (c, 128)),
                                   0, None))
    m1 = rng.random((B, K)) > 0.1
    m2 = rng.random((B, K2)) > 0.1
    m1[:, -K // 8:] = False
    if B > 1:
        m2[-1, :] = False
    return (d1.astype(np.float32), d2.astype(np.float32), m1, m2)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close(port, ref):
    port = port.numpy()
    ref = np.asarray(ref)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(port), fin)
    np.testing.assert_array_equal(port[~fin], ref[~fin])
    np.testing.assert_allclose(port[fin], ref[fin], rtol=0, atol=TOL)


def _equal(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("K", [128, 256])
def test_top2_batch_plain_version_matches_pallas(K):
    d1, d2, m1, m2 = planted(3, K, seed=K)
    ref = pm.pallas_top2_batch(jnp.asarray(d1), jnp.asarray(d2),
                               jnp.asarray(m1), jnp.asarray(m2),
                               interpret=True)
    port = tm.top2_batch_reference(*_t(d1, d2, m1, m2))
    for p, r in zip(port[:2], ref[:2]):
        _close(p, r)
    for p, r in zip(port[2:], ref[2:]):
        _equal(p, r)
    best, second, idx, rev = (np.asarray(r) for r in ref)
    assert np.isneginf(best[-1]).all() and (idx[-1] == 0).all()
    assert (rev[-1] == 0).all()                  # every column masked


def _run_k4(mode, d1, d2, m1, m2, monkeypatch):
    """tools/matcher_mfu.py's kernel body in interpret mode at this size."""
    B, K, D = d1.shape
    monkeypatch.setattr(jmfu, "B", B)
    monkeypatch.setattr(jmfu, "K", K)
    monkeypatch.setattr(jmfu, "TILE_J", 128)
    spec = pl.BlockSpec((1, K, D), lambda b: (b, 0, 0),
                        memory_space=pltpu.VMEM)
    vec = pl.BlockSpec((1, K, 1), lambda b: (b, 0, 0),
                       memory_space=pltpu.VMEM)
    outs = pl.pallas_call(
        jmfu._mk_kernel(mode), grid=(B,), in_specs=[spec, spec, vec, vec],
        out_specs=[vec] * 4,
        out_shape=[jax.ShapeDtypeStruct((B, K, 1), jnp.float32)] * 2
        + [jax.ShapeDtypeStruct((B, K, 1), jnp.int32)] * 2,
        interpret=True,
    )(jnp.asarray(d1, jnp.bfloat16), jnp.asarray(d2, jnp.bfloat16),
      jnp.asarray(m1, jnp.float32)[..., None],
      jnp.asarray(m2, jnp.float32)[..., None])
    return [np.asarray(o[..., 0]) for o in outs]


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_mfu_variant_plain_version_matches_tool_kernel(mode, monkeypatch):
    d1, d2, m1, m2 = planted(2, 256, seed=10 + mode)
    ref = _run_k4(mode, d1, d2, m1, m2, monkeypatch)
    port = tm.mfu_variant_reference(*_t(d1, d2, m1, m2), mode)
    for p, r in zip(port[:2], ref[:2]):
        _close(p, r)
    for p, r in zip(port[2:], ref[2:]):
        _equal(p, r)
    if mode == 0:
        assert np.isneginf(ref[1]).all() and (ref[2] == 0).all()
    if mode < 2:
        assert (ref[3] == 0).all()
    if mode == 3:
        for p, q in zip(port, tm.top2_batch_reference(*_t(d1, d2, m1, m2))):
            assert torch.equal(p, q)


@pytest.mark.parametrize("K1,K2", [(128, 128), (256, 384)])
def test_top2_plain_version_matches_pallas(K1, K2):
    d1, d2, _, _ = planted(1, K1, seed=K1 + K2, K2=K2)
    ref = pm.pallas_top2(jnp.asarray(d1[0]), jnp.asarray(d2[0]),
                         interpret=True)
    port = tm.top2(*_t(d1[0], d2[0]))             # CPU: the plain version
    _close(port[0], ref[0])
    _close(port[1], ref[1])
    _equal(port[2], ref[2])


@pytest.mark.parametrize("K1,K2", [(128, 256), (256, 256)])
def test_match_one_pair_matches_pallas_match(K1, K2):
    d1, d2, m1, m2 = planted(1, K1, seed=3 * K1 + K2, K2=K2)
    ref_m, ref_n = pm.pallas_match(jnp.asarray(d1[0]), jnp.asarray(d2[0]),
                                   jnp.asarray(m1[0]), jnp.asarray(m2[0]),
                                   interpret=True)
    port_m, port_n = tm.match_one_pair(*_t(d1[0], d2[0], m1[0], m2[0]))
    _equal(port_m, ref_m)
    assert int(port_n) == int(ref_n) > 0.15 * min(K1, K2)


def test_match_pair_batch_fused_matches_pallas():
    d1, d2, m1, m2 = planted(2, 256, seed=4)
    ref_m, ref_n = pm.pallas_match_pair_batch(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2),
        interpret=True)
    port_m, port_n = mk.match_pair_batch_fused(*_t(d1, d2, m1, m2))
    _equal(port_m, ref_m)
    _equal(port_n, ref_n)


def test_ties_fall_as_in_the_reference():
    """Duplicate columns in one tile and across tiles, duplicate rows:
    first column wins a row, second equals best, first row wins a
    column."""
    rng = np.random.default_rng(3)
    d = np.abs(rng.normal(size=(1, 256, 128)))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d2 = d.copy()
    d2[0, 5] = d2[0, 2]
    d2[0, 200] = d2[0, 7]                        # duplicate in another tile
    d1 = d.copy()
    d1[0, 6] = d1[0, 3]
    d1[0, 190] = d1[0, 8]
    d1, d2 = d1.astype(np.float32), d2.astype(np.float32)
    m = np.ones((1, 256), bool)
    ref = pm.pallas_top2_batch(jnp.asarray(d1), jnp.asarray(d2),
                               jnp.asarray(m), jnp.asarray(m), interpret=True)
    port = tm.top2_batch_reference(*_t(d1, d2, m, m))
    for p, r in zip(port[2:], ref[2:]):
        _equal(p, r)
    best, second, idx, rev = (np.asarray(r) for r in ref)
    assert idx[0, 2] == 2 and idx[0, 7] == 7 and second[0, 7] == best[0, 7]
    assert rev[0, 3] == 3 and rev[0, 8] == 8
    ref3 = pm.pallas_top2(jnp.asarray(d1[0]), jnp.asarray(d2[0]),
                          interpret=True)
    _equal(tm.top2(*_t(d1[0], d2[0]))[2], ref3[2])


def test_wrappers_on_cpu_run_plain_versions_and_count_nothing():
    d1, d2, m1, m2 = _t(*planted(2, 128, seed=1))
    before = (tm.top2_batch_launches, tm.top2_launches, tm.mfu_launches)
    b16 = (d1.to(torch.bfloat16), d2.to(torch.bfloat16), m1, m2)
    for p, q in zip(tm.top2_batch(*b16), tm.top2_batch_reference(*b16)):
        assert torch.equal(p, q)
    for mode in range(4):
        for p, q in zip(tm.mfu_variant(*b16, mode),
                        tm.mfu_variant_reference(*b16, mode)):
            assert torch.equal(p, q)
    for p, q in zip(tm.top2(d1[0], d2[0]), tm.top2_reference(d1[0], d2[0])):
        assert torch.equal(p, q)
    assert (tm.top2_batch_launches, tm.top2_launches, tm.mfu_launches) \
        == before


def test_shapes_the_kernels_do_not_take_raise():
    d = torch.zeros((100, 128))
    with pytest.raises(ValueError):
        tm.top2(d, torch.zeros((128, 128)))      # K1 not a multiple of 128
    with pytest.raises(ValueError):
        tm.top2(torch.zeros((128, 128)), torch.zeros((128, 64)))
    with pytest.raises(ValueError):
        tm.mfu_variant(d[None], d[None], None, None, 4)


def test_k4_takes_ragged_k_as_k2_does():
    """K2 and K4 take any K (the reference's VMEM gate is not ported)."""
    d1, d2, m1, m2 = _t(*planted(2, 200, seed=6))
    best, second, idx, rev = tm.top2_batch(d1, d2, m1, m2)
    sim = tm.ordered_scores(d1.to(torch.bfloat16), d2.to(torch.bfloat16))
    sim = torch.where(m1[:, :, None] & m2[:, None, :], sim, -torch.inf)
    assert torch.equal(best, sim.amax(-1))
    assert torch.equal(rev.long(), sim.argmax(1))
