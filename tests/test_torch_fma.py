"""The port's f32 fused multiply-add in plain PyTorch (`ops/fma.py`) and
K3's plain version on it (`top2_matcher.ordered_fma_scores`).

`fma32` must round acc + a * b once, as `fmaf` on the card does; the
scores of K3's plain version are one ordered chain of it per score, so a
silent return to multiply-then-add (`ordered_scores`, two roundings a
step) must show. No JAX here: the reference for one rounding is exact
rational arithmetic."""
from fractions import Fraction

import numpy as np
import torch

from dagsfm_tpu_torch.ops import top2_matcher as tm
from dagsfm_tpu_torch.ops.fma import fma32

F32 = np.float32


def _round_f32(q: Fraction) -> F32:
    """The f32 nearest to the exact rational q, ties to even."""
    f = F32(float(q))
    cands = [np.nextafter(f, F32(-np.inf)), f, np.nextafter(f, F32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - q),
                                     int(np.array(c).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """acc = 1, a = 1 + 2896 * 2^-23, b = 2^-24 * (1 - 2895 * 2^-23): the
    exact sum lies just above the midpoint between 1 and 1 + 2^-23, so one
    rounding gives 1 + 2^-23; rounding to f64 first lands on the
    midpoint, and then to f32 on 1 (ties to even)."""
    acc = torch.tensor([1.0], dtype=torch.float32)
    a = torch.tensor([1 + 2896 * 2.0 ** -23], dtype=torch.float32)
    b = torch.tensor([2.0 ** -24 * (1 - 2895 * 2.0 ** -23)],
                     dtype=torch.float32)
    assert float(a) == 1 + 2896 * 2.0 ** -23      # all three exact in f32
    assert float(b) == 2.0 ** -24 * (1 - 2895 * 2.0 ** -23)
    twice = (acc.double() + a.double() * b.double()).float()
    assert float(twice) == 1.0
    assert float(fma32(acc, a, b)) == 1 + 2.0 ** -23
    assert float(fma32(acc, float(a), b)) == 1 + 2.0 ** -23   # scalar a


def test_fma32_is_the_exact_sum_rounded_once():
    """Seeded triples over a wide range of exponents and both signs, and
    near-cancelling ones, against exact rational arithmetic."""
    rng = np.random.default_rng(5)
    n = 400
    acc = (rng.normal(size=n) * 2.0 ** rng.integers(-20, 20, n)).astype(F32)
    a = (rng.normal(size=n) * 2.0 ** rng.integers(-12, 12, n)).astype(F32)
    b = (rng.normal(size=n) * 2.0 ** rng.integers(-12, 12, n)).astype(F32)
    acc[:100] = (-(a[:100].astype(np.float64) * b[:100])).astype(F32)
    got = fma32(torch.as_tensor(acc), torch.as_tensor(a),
                torch.as_tensor(b)).numpy()
    for k in range(n):
        q = Fraction(float(acc[k])) + Fraction(float(a[k])) * Fraction(
            float(b[k]))
        assert got[k] == _round_f32(q), k


def _block(R, C, seed):
    rng = np.random.default_rng(seed)
    unit = (lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True))
    return (torch.as_tensor(unit(np.abs(rng.normal(size=(R, 128))))
                            .astype(F32)),
            torch.as_tensor(unit(np.abs(rng.normal(size=(C, 128))))
                            .astype(F32)))


def test_ordered_fma_scores_is_one_fma_chain_per_score():
    a, b = _block(5, 6, seed=2)
    scores = tm.ordered_fma_scores(a, b)
    for r in range(a.shape[0]):
        for c in range(b.shape[0]):
            acc = torch.zeros((), dtype=torch.float32)
            for k in range(128):
                acc = fma32(acc, a[r, k], b[c, k])
            assert torch.equal(scores[r, c], acc), (r, c)


def test_ordered_fma_scores_differ_from_multiply_then_add():
    a, b = _block(16, 24, seed=3)
    fused = tm.ordered_fma_scores(a, b)
    split = tm.ordered_scores(a, b)
    assert bool((fused != split).any())
    assert float((fused - split).abs().max()) < 128 * 2.0 ** -23


def test_k3_plain_version_takes_the_fma_scores():
    a, b = _block(128, 256, seed=4)
    best, second, idx = tm.top2_reference(a, b)
    s = tm.ordered_fma_scores(a, b)
    assert torch.equal(best, s.amax(-1))
    assert torch.equal(idx.long(), s.argmax(-1))
    s[torch.arange(128), idx.long()] = -torch.inf
    assert torch.equal(second, s.amax(-1))
