"""The port's tools/ programs on the CPU against the JAX package's tools.

profile_two_view: the port's `make_pairs` is the reference tool's bit for
bit, and on those pairs, with the reference's sample draws replayed into
`draw_samples` (as tests/test_torch_two_view_efh.py replays them),
`classify_pairs` gives every pair the reference's configuration and
inlier count; `run` returns every phase the reference tool prints.
ba_phase_profile and prologue_probe at a tiny size in float64: each
phase's tensors, and the S·x its `matvec` runs (`schur_matvec.schur_mv`),
equal what `_solve_iterative` computes inside it (rel 1e-12), the full
solve's final cost the JAX package's `ba.solve` (rel 1e-7), and the byte
model a count written out from the arrays' shapes.
multiproc_smoke on gloo passes; scaling_curves at D = 1 and 2 agrees
across D to rel 1e-9 and its ablated twins complete. No reference tool
runs here, and the repo's records of the JAX tools stay byte for byte.
"""
import hashlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.ops import ransac as j_rnsc
from dagsfm_tpu.ops import two_view_classify as j_tvc
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu.sfm import bundle_adjustment as j_ba
from dagsfm_tpu_torch.ops import two_view_classify as t_tvc
from dagsfm_tpu_torch.sfm import bundle_adjustment as t_ba
from dagsfm_tpu_torch.tools import ba_phase_profile as bpp
from dagsfm_tpu_torch.tools import (multiproc_smoke, profile_two_view,
                                    prologue_probe, scaling_curves)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (12, 200, 8)          # cameras, points, max track length
RECORDS = {
    "E2E_r05.json":
        "c330d48553e49ff2e93d74788866b4929caa39a3d1f774a15bb8536cd0588ceb",
    "BA_PHASES_r05.json":
        "77eb49fe8c751e5fdd55ddca3d218a42158f4acc23d3f3b7e94e1f441ea9c387",
    "SCALING_r05.json":
        "52114dea7b63d8a74e37421211f8dad49947d496fcdb07d79ed465a62e1cb391",
    "MULTIPROC_r04.json":
        "153a9e21c650a55533dfbbbd6c05934740696081efb4c15751d135b0d1bfdb1b",
}


def reference_tool(name: str):
    """The JAX package's tools/<name>.py as a module (imported, never
    run)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_pairs_are_the_reference_tool_s_bit_for_bit():
    ref = reference_tool("profile_two_view").make_pairs()
    port = profile_two_view.make_pairs()
    assert len(port) == len(ref) == 64
    for a, b in zip(port, ref):
        assert a[0] == b[0] and a[5:] == b[5:]
        for x, y in zip(a[1:5], b[1:5]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_classify_pairs_with_the_reference_draws(monkeypatch):
    pairs = profile_two_view.make_pairs(16)
    jopts = j_tvc.TwoViewOptions(num_hypotheses=64)
    topts = t_tvc.TwoViewOptions(num_hypotheses=64)
    ref = j_tvc.classify_pairs(pairs, jopts, seed=0)
    # the reference draws: key k of split(PRNGKey(0), B) for pair k (one
    # bucket of 256), split into E, F and H keys inside _efh_batched
    N = 256
    keys = jax.random.split(jax.random.PRNGKey(0), len(pairs))
    mask = jnp.ones(N, bool)
    draws = {"E": [], "F": [], "H": []}
    for k in range(len(pairs)):
        kE, kF, kH = jax.random.split(keys[k], 3)
        for name, key, s in (("E", kE, 5), ("F", kF, 7), ("H", kH, 4)):
            draws[name].append(np.asarray(j_rnsc._sample_indices(
                key, jopts.num_hypotheses, s, N, mask)))

    def replay(gen, m, num_hyps, kinds="EFH"):
        assert m.shape == (len(pairs), N) and num_hyps == 64
        return {k: torch.as_tensor(np.stack(draws[k])) for k in kinds}

    monkeypatch.setattr(t_tvc, "draw_samples", replay)
    port = t_tvc.classify_pairs(pairs, topts, seed=0, device="cpu")
    assert port.keys() == ref.keys()
    for pk in ref:
        assert port[pk].config == ref[pk].config, pk
        assert port[pk].num_inliers == ref[pk].num_inliers, pk
        np.testing.assert_array_equal(port[pk].inlier_mask,
                                      ref[pk].inlier_mask)


def test_profile_two_view_times_every_phase():
    rec = profile_two_view.run(n_pairs=8, device="cpu", reps=1)
    # the reference prints: classify_pairs, _efh_batched, _e_batched, E, F
    # and H RANSAC alone, the host _select_model loop and efh + fetch
    assert {"classify_pairs", "efh_batched", "e_batched", "e_ransac",
            "f_ransac", "h_ransac", "select_model_host",
            "efh_and_fetch"} <= set(rec["ms"])
    assert all(v > 0 for v in rec["ms"].values())
    assert rec["card"] == "cpu" and rec["device"] == "cpu"
    assert sum(rec["configs"].values()) == 8


def _inside_the_solver(monkeypatch, prob, opts, wt):
    """What `_solve_iterative` computes inside one call from
    `_build_and_solve`: its weighted inputs, _point_blocks' outputs, the
    block inverse's argument and result, and the CG's b, S·x and
    preconditioner."""
    seen = {}

    def keep(name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen[name] = (a, out)
            return out
        return wrapped

    for name in ("_solve_iterative", "_point_blocks", "_block_inverse",
                 "_pcg"):
        monkeypatch.setattr(t_ba, name, keep(name, getattr(t_ba, name)))
    t_ba._build_and_solve(prob, None, wt["r"], wt["Jc"], wt["Jp"], None,
                          wt["w"], bpp.LAM, opts, None)
    return seen


def test_ba_phases_equal_what_the_solver_computes(monkeypatch):
    prob, opts = bpp.problem(*TINY, "cpu", torch.float64)
    wt = bpp.weighted(prob, opts)
    env = bpp.prologue(bpp.environment(prob, opts, wt))
    seen = _inside_the_solver(monkeypatch, prob, opts, wt)

    def same(a, b):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=0)

    args = seen["_solve_iterative"][0]
    for k, key in ((1, "r_w"), (2, "Jc_w"), (3, "Jp_w")):
        same(env[key], args[k])
    gp, Vinv = seen["_point_blocks"][1]
    same(env["gp"], gp)
    same(env["Vinv"], Vinv)
    S, _ = seen["_block_inverse"][0]
    same(env["Ud"] - env["B"], S)
    same(env["Minv"], seen["_block_inverse"][1])
    S_mv, precond, (b,), _, _ = seen["_pcg"][0]
    same(env["b"], b)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(TINY[0], 6)))
    same(bpp.matvec(env, x), S_mv(x)[0])
    same(env["Minv"] @ x[..., None], precond(x)[0][..., None])
    assert [s[1] for s in bpp.PROLOGUE][-1] == "Minv"


def test_full_solve_cost_equals_the_reference():
    rec = bpp.run(device="cpu", dtype=torch.float64, reps=1, sizes=TINY)
    ncam, npts, mtl = TINY
    sc = j_syn.generate(j_syn.SyntheticSceneSpec(
        num_cameras=ncam, num_points=npts, pixel_noise=0.5, seed=0,
        max_track_length=mtl))
    arrays = j_syn.to_scene_arrays(sc, dtype=np.float64)
    rng = np.random.default_rng(1)
    arrays = arrays._replace(points_xyz=arrays.points_xyz + rng.normal(
        0, 0.02, arrays.points_xyz.shape))
    const = np.zeros(ncam, bool)
    const[:2] = True
    jprob = j_ba.make_problem(arrays, const_image=const, dtype=jnp.float64,
                              max_track_len=mtl)
    _, stats = j_ba.solve(jprob, j_ba.BAOptions(
        max_iterations=bpp.LM_ITERS, solver="iterative", pinhole_only=True,
        ftol=0.0))
    got = rec["full_solve"]["final_cost"]
    assert got < 0.5 * rec["full_solve"]["initial_cost"]
    assert abs(got - float(stats.final_cost)) <= 1e-7 * float(
        stats.final_cost)
    assert rec["full_solve"]["lm_iterations"] == bpp.LM_ITERS
    assert set(rec["roofline"]) <= set(rec["ms"])
    assert all(r["bound_ms"] is None and r["achieved_gbps"] is None
               for r in rec["roofline"].values())


def _seg(M, k, T, K, s):
    """Bytes of a segment sum as the byte model counts them."""
    return 3 * M * k * s + 8 * M + 2 * K * k * s + T * k * s


def test_byte_model_equals_a_count_from_the_shapes():
    prob, opts = bpp.problem(*TINY, "cpu", torch.float64)
    env = bpp.prologue(bpp.environment(prob, opts,
                                       bpp.weighted(prob, opts)))
    N, P, I = prob.obs_xy.shape[0], prob.points.shape[0], TINY[0]
    Kp, Ki = prob.by_point.chunks.numel(), prob.by_image.chunks.numel()
    s = 8
    prologue = (15 * N * s + _seg(N, 9, P, Kp, s) + 11 * N * s
                + _seg(N, 3, P, Kp, s) + 18 * P * s + 36 * N * s
                + 8 * N + 18 * N * s + 8 * N + 6 * N * s + 45 * N * s
                + 48 * N * s + _seg(N, 36, I, Ki, s) + 20 * N * s
                + _seg(N, 6, I, Ki, s) + 27 * N * s
                + _seg(N, 6, I, Ki, s) + 72 * N * s + _seg(N, 36, I, Ki, s)
                + 72 * I * s + 19 * I * s + 109 * I * s)
    assert sum(bpp.step_bytes(env, st) for st in bpp.PROLOGUE) == prologue
    matvec = 18 * N * s + 9 * P * s + 16 * N + 12 * I * s
    assert bpp.matvec_bytes(env) == matvec
    gathers = N * (24 * s + 32)
    assert bpp.gathers_bytes(prob) == gathers
    wt = bpp.weighted(prob, opts)
    assert bpp.gathers_bytes(prob, bpp.nbytes(
        wt["r"], wt["Jc"], wt["Jp"], wt["w"])) == gathers + 21 * N * s


def test_prologue_probe_times_every_statement():
    rec = prologue_probe.run(device="cpu", dtype=torch.float64, reps=1,
                             sizes=TINY)
    names = [s["statement"] for s in rec["statements"]]
    assert names == [s[0] for s in bpp.PROLOGUE]
    assert all(s["ms"] > 0 and s["gb_moved"] > 0 and s["bound_ms"] is None
               for s in rec["statements"])
    prob, opts = bpp.problem(*TINY, "cpu", torch.float64, perturb=False)
    env = bpp.prologue(bpp.environment(prob, opts,
                                       bpp.weighted(prob, opts)))
    assert sum(s["gb_moved"] for s in rec["statements"]) == pytest.approx(
        sum(bpp.step_bytes(env, st) for st in bpp.PROLOGUE) / 1e9,
        rel=1e-12)


def test_multiproc_smoke_on_gloo():
    rec = multiproc_smoke.run(device="cpu", timeout=120)
    assert rec["pass"], rec
    assert sorted(rec["jobs_by_host"][0] + rec["jobs_by_host"][1]) == \
        list(range(multiproc_smoke.JOBS))
    assert all(r["all_reduce"] == 3.0 for r in rec["processes"])


def test_scaling_curves_agree_across_shards():
    sizes = {"ba_cameras": 12, "ba_points": 200, "ra_images": 50,
             "ra_random_edges": 150, "match_images": 8, "match_pairs": 16,
             "K": 64}
    rec = scaling_curves.run(devices=(1, 2), device="cpu", sizes=sizes)
    ba, ra, mt = (rec["curves"][k] for k in (
        "ba_iterative_sharded", "rotation_averaging_sharded",
        "matching_sharded"))
    assert [r["devices"] for r in ba] == [1, 2]
    assert ba[1]["final_cost"] == pytest.approx(ba[0]["final_cost"],
                                                rel=1e-9)
    assert ba[1]["max_point_dev_vs_D1"] >= 0.0
    assert ra[1]["max_rotation_dev_vs_D1"] <= 1e-9
    assert mt[1]["equal_vs_D1"]
    for r in ba:
        assert r["lm_step_compute_s"] > 0          # the ablated twin ran
    for r in ra:
        assert r["solve_compute_s"] > 0
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_the_reference_tools_records_are_unchanged(name):
    with open(os.path.join(ROOT, name), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == RECORDS[name]
