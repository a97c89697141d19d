"""The borderline rule that the bf16 tensor-core kernels (K1, K2, K4) are
held to, and the kernel build's cache key, on the CPU.

The kernels add the 128 products of a score in the tensor cores' order,
so their scores may differ from the plain version's by up to EPS and a
decision may flip where two scores, or a score and a threshold, are that
close. `matcher_kernel.borderline_rows` and `top2_matcher.borderline`
flag exactly the rows and columns where that can happen; these tests
perturb the plain scores by at most EPS and check that every decision
that changes is flagged, and that planted ties and near-threshold ratios
are flagged."""
import numpy as np
import pytest
import torch

from chip_smoke import planted_pairs
from dagsfm_tpu_torch.ops import cuda_build
from dagsfm_tpu_torch.ops import matcher_kernel as mk
from dagsfm_tpu_torch.ops import top2_matcher as tm

torch.set_num_threads(1)

EPS = tm.EPS


def _near_ties(sim: torch.Tensor, rng, frac: float = 0.3) -> torch.Tensor:
    """`sim` with, for a fraction of the rows, one other column moved to
    within 3 EPS of the row's best, and as many columns' runner-up rows
    moved to within 3 EPS of the column's best: gaps on both sides of the
    2 EPS line."""
    sim = sim.clone()
    B, R, C = sim.shape
    best, arg = sim.max(-1)
    for b in range(B):
        for r in np.nonzero(rng.random(R) < frac)[0]:
            if not torch.isfinite(best[b, r]):
                continue
            c = int(rng.integers(C))
            if c != int(arg[b, r]):
                sim[b, r, c] = best[b, r] - float(rng.uniform(0, 3)) * EPS
    cbest, carg = sim.max(-2)
    for b in range(B):
        for c in np.nonzero(rng.random(C) < frac)[0]:
            if not torch.isfinite(cbest[b, c]):
                continue
            r = int(rng.integers(R))
            if r != int(carg[b, c]):
                sim[b, r, c] = cbest[b, c] - float(rng.uniform(0, 3)) * EPS
    return sim


def _near_ratios(sim: torch.Tensor, rng, frac: float = 0.3) -> torch.Tensor:
    """`sim` with, for a fraction of the rows that match (d_best < 0.6),
    a second best that puts the ratio test within a few EPS of its line
    d_best = 0.8 * d_second, on either side."""
    sim = sim.clone()
    B, R, C = sim.shape
    best, arg = sim.max(-1)
    d_best = torch.sqrt(torch.clamp(2.0 - 2.0 * best, min=0.0))
    for b in range(B):
        for r in np.nonzero(rng.random(R) < frac)[0]:
            if not torch.isfinite(best[b, r]) or d_best[b, r] >= 0.6:
                continue
            d_s = float(d_best[b, r]) / 0.8 * (1 + rng.uniform(-3e-4, 3e-4))
            c = int(rng.integers(C))
            if c != int(arg[b, r]):
                sim[b, r, c] = 1.0 - d_s * d_s / 2.0
    return sim


def _perturbations(sim: torch.Tensor, rng):
    """Perturbations of the finite scores by at most 0.9 EPS (the f32
    rounding of the sum stays far inside the last 0.1 EPS): random ones,
    and the two that push every row's best down and the rest up, and the
    reverse."""
    fin = torch.isfinite(sim)
    is_best = sim == sim.amax(-1, keepdim=True)
    for delta in (rng.uniform(-0.9, 0.9, sim.shape),
                  np.where(is_best, -0.9, 0.9), np.where(is_best, 0.9, -0.9)):
        d = torch.as_tensor(delta * EPS, dtype=torch.float32)
        yield torch.where(fin, sim + d, sim)


@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_decisions_change_only_at_borderline_rows(seed, cross_check):
    rng = np.random.default_rng(seed)
    d1, d2, m1, m2 = planted_pairs(3, 96, seed=seed, device="cpu")
    sim = _near_ratios(_near_ties(mk.masked_scores(d1, d2, m1, m2), rng),
                       rng)
    j = mk.match_j_of_scores(sim, m1, cross_check=cross_check)
    flag = mk.borderline_of_scores(sim, cross_check=cross_check)
    changed = torch.zeros_like(flag)
    for pert in _perturbations(sim, rng):
        jp = mk.match_j_of_scores(pert, m1, cross_check=cross_check)
        changed |= jp != j
        assert not bool((changed & ~flag).any())
    assert int(changed.sum()) > 0           # the perturbations did flip rows
    assert int(flag.sum()) < flag.numel() // 2


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_top2_idx_and_rev_change_only_at_borderline(mode):
    rng = np.random.default_rng(10 + mode)
    d1, d2, m1, m2 = planted_pairs(2, 96, seed=mode, device="cpu")
    sim = tm.ordered_scores(d1, d2)
    if mode == 3:
        sim = torch.where(m1[:, :, None] & m2[:, None, :], sim, -torch.inf)
    sim = _near_ties(sim, rng)
    _, _, idx, rev = tm._top2_of(sim, mode)
    rows, cols = tm.borderline_of_scores(sim)
    moved = [torch.zeros_like(rows), torch.zeros_like(cols)]
    for pert in _perturbations(sim, rng):
        best, second, pi, pr = tm._top2_of(pert, mode)
        moved[0] |= pi != idx
        moved[1] |= pr != rev
        assert not bool((moved[0] & ~rows).any())
        assert not bool((moved[1] & ~cols).any())
    assert int(moved[0].sum()) > 0
    if mode >= 2:
        assert int(moved[1].sum()) > 0


def test_planted_ties_and_near_threshold_ratios_are_flagged():
    """Rows of one pair of plain scores, against the default ratio 0.8
    and distance 0.7: an exact tie, a ratio test and a distance test an
    EPS from their thresholds, rows clear of every line, and a column tie
    at a row's argbest."""
    C = 6
    sim = torch.full((1, 6, C), 0.05)
    # d = sqrt(2 - 2 s): d(0.71875) = 0.75 and d(0.82) = 0.6 = 0.8 * 0.75
    sim[0, 0, :3] = torch.tensor([0.82 + 2e-6, 0.71875, 0.1])  # ratio line
    sim[0, 1, :2] = torch.tensor([0.9, 0.9])                 # exact tie
    sim[0, 2, :2] = torch.tensor([0.755 - 2e-6, 0.1])       # d_best ~ 0.7
    sim[0, 3, :2] = torch.tensor([0.95, 0.3])                # clear match
    sim[0, 4, :2] = torch.tensor([0.3, 0.25])                # clear non-match
    sim[0, 5, 3:5] = torch.tensor([0.97, 0.2])               # clear match at 3
    sim[0, 3, 3] = 0.97                                      # column 3 tied
    m1 = torch.ones((1, 6), dtype=torch.bool)
    flag = mk.borderline_of_scores(sim, cross_check=True)
    assert flag[0].tolist() == [True, True, True, True, False, True]
    flag = mk.borderline_of_scores(sim, cross_check=False)
    assert flag[0].tolist() == [True, True, True, False, False, False]
    j = mk.match_j_of_scores(sim, m1, cross_check=False)
    assert j[0, 3] == 3 and j[0, 4] == -1 and j[0, 5] == 3
    rows, cols = tm.borderline_of_scores(sim)
    assert rows[0].tolist() == [False, True, False, False, False, False]
    assert bool(cols[0, 3]) and not bool(cols[0, 2])


def test_duplicates_are_flagged_and_masked_lines_are_not():
    """A duplicate column flags its rows' idx, a duplicate row its
    columns' rev; all-masked rows and columns (all -inf) are not
    borderline: every version gives index 0 there."""
    d1, d2, m1, m2 = planted_pairs(2, 64, seed=4, device="cpu")
    d2[1, 9] = d2[1, 3]
    d1[1, 20] = d1[1, 11]
    sim = torch.where(m1[:, :, None] & m2[:, None, :],
                      tm.ordered_scores(d1, d2), -torch.inf)
    rows, cols = tm.borderline_of_scores(sim)
    _, _, idx, rev = tm._top2_of(sim, 3)
    on3 = (idx[1] == 3) & m1[1]
    assert bool(on3.any()) and bool(rows[1][on3].all())
    on11 = (rev[1] == 11) & m2[1]
    assert bool(on11.any()) and bool(cols[1][on11].all())
    assert not bool(rows[0].any())          # pair 0: every column masked
    assert not bool(cols[0].any())
    assert not bool(cols[1][~m2[1]].any())


def test_library_path_follows_the_shared_header(tmp_path, monkeypatch):
    """Editing a header in csrc/ changes the library path of every source
    (so every kernel library is rebuilt); editing one source changes
    only its own."""
    src = tmp_path / "csrc"
    src.mkdir()
    for f in cuda_build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", src)
    names = sorted(f.stem for f in src.glob("*.cu"))
    assert names == ["fused_matcher", "minimal_nullspace", "schur_matvec",
                     "top2_matcher"]
    before = {n: cuda_build._so_path(n) for n in names}
    header = src / "matcher_tiles.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build._so_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert all(after[n].parent == cuda_build.BUILD_DIR for n in names)
    (src / "top2_matcher.cu").write_text(
        (src / "top2_matcher.cu").read_text() + "\n// edited\n")
    again = {n: cuda_build._so_path(n) for n in names}
    assert again["fused_matcher"] == after["fused_matcher"]
    assert again["minimal_nullspace"] == after["minimal_nullspace"]
    assert again["schur_matvec"] == after["schur_matvec"]
    assert again["top2_matcher"] != after["top2_matcher"]
