"""The port's recorder (utils/observability.py): nested spans aggregated
into root records, host reads counted and timed on the innermost span,
the bounded deque of finished roots, the `profiled` flag and the span
stamps on the profiler's clock, `enable(False)`, the benchmark readers'
window of roots (sfmbench.program_roots), and that spans change no number of verification or
bundle adjustment."""
import contextlib
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dagsfm_tpu_torch.ops import two_view_classify as tvc
from dagsfm_tpu_torch.scene import synthetic as t_syn
from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
from dagsfm_tpu_torch.utils import observability as obs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh():
    obs.enable(True)
    obs.clear()
    yield
    obs.enable(True)
    obs.clear()


def _last():
    return obs.roots()[-1]


def test_spans_nest_and_aggregate():
    with obs.span("job") as job:
        for _ in range(3):
            with obs.span("job.a"):
                with obs.span("job.a.b"):
                    time.sleep(0.001)
        with obs.span("job.c"):
            obs.count("items", 5)
            obs.count("items", 2)
        assert obs.roots() == []             # the root is still open
    assert len(obs.roots()) == 1
    rec = _last()
    assert rec["name"] == "job" and not rec["profiled"]
    assert rec["stamps"] == []
    assert {k: v["calls"] for k, v in rec["spans"].items()} == \
        {"job": 1, "job.a": 3, "job.a.b": 3, "job.c": 1}
    s = {k: v["seconds"] for k, v in rec["spans"].items()}
    assert s["job.a.b"] >= 0.003 and s["job.a"] >= s["job.a.b"]
    assert s["job"] >= s["job.a"] + s["job.c"]
    assert job.seconds == pytest.approx(s["job"], abs=1e-6)
    assert rec["counters"] == {"items": 7}
    # a span with no open parent is a root of its own
    with obs.span("other"):
        pass
    assert [r["name"] for r in obs.roots()] == ["job", "other"]


def test_reads_count_on_the_innermost_span():
    x = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    with obs.span("job"):
        with obs.span("job.read"):
            got = obs.host_read(x)
            assert torch.equal(got, x.cpu())
            assert obs.host_read(x[0, 1], float) == float(x[0, 1]) == 1.0
            assert obs.host_read(x[1, 2], int) == 5
            assert obs.host_read(x.sum() > 1, bool) is True
        obs.host_read(x[0, 0], bool)
    rec = _last()["spans"]
    assert rec["job.read"]["reads"] == 4 and rec["job"]["reads"] == 1
    assert rec["job.read"]["wait_s"] > 0 and rec["job"]["wait_s"] > 0
    assert rec["job.read"]["wait_s"] <= rec["job.read"]["seconds"]
    # a read outside any span is made and counted nowhere
    assert obs.host_read(x[0, 2], float) == 2.0
    assert len(obs.roots()) == 1


def test_finished_roots_are_bounded():
    for k in range(obs.MAX_ROOTS + 6):
        with obs.span("r"):
            obs.count("k", k)
    got = obs.roots()
    assert len(got) == obs.MAX_ROOTS
    assert [r["counters"]["k"] for r in got] == \
        list(range(6, obs.MAX_ROOTS + 6))


def test_profiled_flag_and_stamps_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    with obs.span("plain"):
        pass
    with obs.span("started"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("started.inner"):
                torch.ones(8).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("traced"):
            for _ in range(2):
                with obs.span("traced.a"):
                    torch.ones(64).sum()
            with obs.span("traced.b"):
                time.sleep(0.002)
    with obs.span("after"):
        pass
    flags = {r["name"]: r["profiled"] for r in obs.roots()}
    assert flags == {"plain": False, "started": True, "traced": True,
                     "after": False}
    rec = obs.roots()[2]
    assert [s[0] for s in rec["stamps"]] == ["traced.a", "traced.a",
                                             "traced.b", "traced"]
    # each span is a record_function range within 1 ms of its stamps
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("traced")]
    assert len(events) == len(rec["stamps"])
    for e, (name, s0, s1) in zip(
            sorted(events, key=lambda e: e.start_ns()),
            sorted(rec["stamps"], key=lambda s: s[1])):
        assert e.name() == name
        assert abs(e.start_ns() - s0) < 1_000_000
        assert abs(e.start_ns() + e.duration_ns() - s1) < 1_000_000
    assert rec["spans"]["traced.b"]["seconds"] >= 0.002


def test_profiler_trace_shows_the_spans(tmp_path):
    with obs.profiler_trace(str(tmp_path)) as prof:
        with obs.span("job"):
            with obs.span("job.a"):
                torch.ones(64).sum()
    assert prof is not None and obs.roots()[-1]["profiled"]
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e["name"] for e in events["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"job", "job.a"} <= names


def test_enable_false_records_nothing():
    x = torch.ones(3)
    obs.enable(False)
    with obs.span("job") as s:
        with obs.span("job.a"):
            obs.count("n", 3)
            assert obs.host_read(x.sum(), float) == 3.0
        time.sleep(0.001)
    assert obs.roots() == []
    assert s.seconds >= 0.001          # the span still times its caller
    obs.enable(True)
    with obs.span("job"):
        pass
    assert len(obs.roots()) == 1


def test_threads_keep_their_own_roots():
    """Spans are per thread and finished roots are shared: under a short
    switch interval, 16 threads each finish roots whose counters and
    calls are their own while the main thread reads the deque."""
    import sys
    import threading
    errors = []

    def work(k):
        try:
            for _ in range(50):
                with obs.span(f"t{k}"):
                    for _ in range(3):
                        with obs.span(f"t{k}.a"):
                            obs.count("n", k)
                            obs.host_read(torch.ones(1), float)
        except Exception as e:          # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            for rec in obs.roots():
                assert rec["name"][0] == "t"
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    got = obs.roots()
    assert len(got) == obs.MAX_ROOTS
    for rec in got:
        k = int(rec["name"][1:])
        assert rec["counters"] == {"n": 3 * k}
        assert rec["spans"] == {
            rec["name"]: {**rec["spans"][rec["name"]], "calls": 1,
                          "reads": 0},
            f"t{k}.a": {**rec["spans"][f"t{k}.a"], "calls": 3, "reads": 3}}


def _roots(kind, counts, profiled=()):
    from torch.profiler import ProfilerActivity, profile
    for k, n in enumerate(counts):
        ctx = profile(activities=[ProfilerActivity.CPU]) if k in profiled \
            else contextlib.nullcontext()
        with ctx:
            with obs.span(kind):
                obs.count("pairs", n)
                obs.count("classified", n - 1)


def test_window_of_roots():
    from sfmbench import program_roots
    _roots("verify.job", [8, 8, 8, 5], profiled={1})
    with obs.span("ba.solve"):
        obs.count("pairs", 100)

    def window(kind, **counters):
        return program_roots.window(dict(counters=counters), kind)

    got, classified = window("verify", pairs=13)
    assert [r["counters"]["pairs"] for r in got] == [8, 5]
    assert classified == 7 + 4
    # the profiled root is skipped, not a break in the run
    got, classified = window("verify", pairs=21)
    assert [r["counters"]["pairs"] for r in got] == [8, 8, 5]
    assert classified == 7 + 7 + 4
    for total in (12, 14, 30, 0, None):
        assert window("verify", pairs=total) is None
    assert window("verify") is None
    assert window("ba", iterations=4) is None
    # a window of roots that classified nothing has no unit to divide by
    _roots("verify.job", [1])
    assert window("verify", pairs=1) is None


def _reader(name):
    from sfmbench import harness
    return harness.load_module(ROOT / "sfmbench" / "metrics" / f"{name}.py")


def test_readers_find_their_window_or_nothing():
    with obs.span("verify.job"):
        obs.count("pairs", 4)
        obs.count("classified", 4)
        with obs.span("verify"):
            with obs.span("verify.read"):
                obs.host_read(torch.ones(2))
            for name in ("verify.sample", "verify.ransac.E", "verify.pose",
                         "verify.select"):
                with obs.span(name):
                    time.sleep(0.001)
    rec = _last()["spans"]
    ctx = dict(counters=dict(pairs=4), window_s=1.0, trace=None)
    want = {
        "verify_read_wait_ms_per_pair": rec["verify.read"]["wait_s"] / 4e-3,
        "ransac_host_ms_per_pair": sum(
            rec[n]["seconds"] for n in ("verify.sample", "verify.ransac.E",
                                        "verify.pose")) / 4e-3,
        "select_ms_per_pair": rec["verify.select"]["seconds"] / 4e-3}
    for name, v in want.items():
        assert _reader(name).read(ctx) == pytest.approx(v, rel=1e-12)
        assert _reader(name).read(dict(ctx, counters=dict(pairs=5))) is None
        assert _reader(name).read(dict(ctx, counters={})) is None
    for steps in (3, 2):
        with obs.span("ba.solve"):
            obs.count("lm_steps", steps)
            with obs.span("ba.pcg"):
                for _ in range(4 * steps):
                    obs.host_read(torch.ones(1), bool)
    ctx = dict(counters=dict(iterations=5), window_s=1.0, trace=None)
    assert _reader("host_reads_per_lm_step").read(ctx) == 4.0
    waits = sum(r["spans"]["ba.pcg"]["wait_s"] for r in obs.roots()[-2:])
    assert _reader("ba_read_wait_ms_per_lm_step").read(ctx) == \
        pytest.approx(1e3 * waits / 5, rel=1e-12)
    for name in ("host_reads_per_lm_step", "ba_read_wait_ms_per_lm_step"):
        assert _reader(name).read(dict(ctx, counters=dict(
            iterations=4))) is None


def _pair_data():
    rng = np.random.default_rng(4)
    K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    rows = []
    for k in range(5):
        n = 60 + 10 * k
        X = rng.uniform(-2, 2, (n, 3)) + [0, 0, 8]
        if k == 3:
            X[:, 2] = 8.0                                # a plane
        t = np.zeros(3) if k == 4 else np.array([1.0, 0.1, 0.0])
        x2 = X + t
        p1 = X[:, :2] / X[:, 2:] * 800 + [320, 240]
        p2 = x2[:, :2] / x2[:, 2:] * 800 + [320, 240]
        p2 += rng.normal(size=p2.shape) * 0.3
        bad = rng.random(n) < 0.2
        p2[bad] = rng.uniform([0, 0], [640, 480], (bad.sum(), 2))
        rows.append(((0, k + 1), p1, p2, K, K, (640, 480), (640, 480),
                     k % 2 == 0))
    return rows


def _ba_problem():
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=8, num_points=120, pixel_noise=0.3, seed=5,
        camera_model="SIMPLE_RADIAL"))
    arrays = t_syn.to_scene_arrays(sc, torch.device("cpu"))
    cp = arrays.cam_params.clone()
    cp[0, 0] *= 1.05
    arrays = arrays._replace(
        cam_params=cp, points_xyz=arrays.points_xyz + 0.01 * torch.as_tensor(
            np.random.default_rng(5).normal(size=arrays.points_xyz.shape)))
    const = np.zeros(8, bool)
    const[:2] = True
    from dagsfm_tpu_torch.scene import cameras as t_cm
    return ba.make_problem(arrays, const_image=const,
                           cam_refine=t_cm.intrinsics_refine_mask(
                               [t_cm.SIMPLE_RADIAL], True, False, True))


@pytest.mark.parametrize("essential_only", [False, True])
def test_spans_change_no_number_of_verification(essential_only):
    opts = tvc.TwoViewOptions(num_hypotheses=32,
                              essential_only=essential_only)
    runs = []
    for on in (True, False, True):
        obs.enable(on)
        with obs.span("verify.job"):
            runs.append(tvc.classify_pairs(_pair_data(), opts, seed=9,
                                           device="cpu"))
    obs.enable(True)
    for other in runs[1:]:
        assert other.keys() == runs[0].keys()
        for pk, a in runs[0].items():
            b = other[pk]
            assert a.config == b.config and a.num_inliers == b.num_inliers
            np.testing.assert_array_equal(a.inlier_mask, b.inlier_mask)
            for f in ("E", "F", "H", "R", "t"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)
    assert len({r.config for r in runs[0].values()}) >= 2
    recs = obs.roots()
    assert len(recs) == 2
    spans = recs[0]["spans"]
    assert spans["verify.read"]["reads"] == 14 * spans["verify.read"]["calls"]
    names = {"verify.pack", "verify.sample", "verify.ransac.E",
             "verify.pose", "verify.read", "verify.select"}
    assert names <= set(spans)
    # the calibrated pairs run E alone in a chunk of their own
    assert spans["verify.ransac.E"]["calls"] - \
        spans["verify.ransac.H"]["calls"] == int(essential_only)
    # the pipeline counts the job; classify_pairs counts the minimal
    # systems it solves: 32 hypotheses of each estimator a pair runs
    estimators = sum(1 if essential_only and row[-1] else 3
                     for row in _pair_data())
    assert recs[0]["counters"] == {"nullspace_systems": 32 * estimators}
    assert recs[0] == {**recs[1], "spans": recs[0]["spans"]}


@pytest.mark.parametrize("cg_cap", [100, 2])
def test_spans_change_no_number_of_bundle_adjustment(cg_cap):
    opts = ba.BAOptions(max_iterations=6, loss="cauchy", refine_focal=True,
                        refine_extra=True, solver="iterative",
                        max_linear_iterations=cg_cap)
    runs = []
    for on in (True, False):
        obs.enable(on)
        runs.append(ba.solve(_ba_problem(), opts))
    obs.enable(True)
    (a, sa), (b, sb) = runs
    assert sa == sb
    for name in ("image_qvec", "image_tvec", "points", "cam_params"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    rec = obs.roots()
    assert len(rec) == 1 and rec[0]["name"] == "ba.solve"
    rec = rec[0]
    assert rec["counters"] == {"lm_steps": sa.num_iterations}
    calls = {k: v["calls"] for k, v in rec["spans"].items()}
    steps = sa.num_iterations
    assert calls == {"ba.solve": 1, "ba.linearize": steps,
                     "ba.solve_step": steps, "ba.pcg": steps,
                     "ba.evaluate": steps}
    reads = {k: v["reads"] for k, v in rec["spans"].items()}
    # one cost read to start, then per step the CG test k + 1 times (k
    # times where CG stops at its cap, which skips the last test) and
    # the trial's cost
    capped = steps if cg_cap == 2 else 0
    assert sa.cg_iterations == 2 * steps if cg_cap == 2 else \
        sa.cg_iterations < cg_cap * steps
    assert reads == {"ba.solve": 1, "ba.linearize": 0, "ba.solve_step": 0,
                     "ba.pcg": sa.cg_iterations + steps - capped,
                     "ba.evaluate": steps}
    json.dumps(rec)
