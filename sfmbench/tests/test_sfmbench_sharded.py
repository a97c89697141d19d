"""The sharded bundle adjustment cell, `ba.final13682x4`, at a test size
on the CPU (four gloo ranks): found by name, its result line in both
modes, its check correct on the program and not on the control or under
each fault of faults_sharded, the reference's held images and free
intrinsics from the configuration alone, no result where a worker rank
loaded a forbidden module; and the files and entries of the benchmark it
was added to, unchanged."""

import hashlib
import json
import subprocess
import sys
import time

import pytest
import torch

from sfmbench import faults_sharded, harness
from sfmbench import sharded_ranks as sr
from sfmbench.tests.conftest import ROOT

NAME = "ba.final13682x4"
# the cell with 40 cameras, 600 points and 4,800 observations (tracks up
# to 40 long, so the rule decimates some)
SMALL = {"config": {"problem": {"num_cameras": 40, "num_points": 600,
                                "num_observations": 4800}}}
# the single-card BA cell's readers, then the sharded cell's own
METRICS = ["cg_per_lm_step", "ba_lm_roofline", "device_idle_pct.ba",
           "sharded_lm_step_ms", "allreduces_per_lm_step",
           "allreduce_ms_per_lm_step", "shard_local_ms_per_solve"]


def test_the_cell_is_found_by_name():
    cell = harness.Cell(ROOT, NAME)
    assert cell.entry["chips"] == 4 and cell.mix["runner"] == "ba_sharded"
    assert [m["name"] for m in cell.e2e] == ["ba_solve_s", "setup_s"]
    assert list(cell.readers) == METRICS
    assert cell.config["reduced"] == ["max_iterations"]
    assert "50" in cell.config["cut"]["max_iterations"]
    sh = cell.config["sharding"]
    assert sh["shards"] == sh["ranks"] == cell.entry["chips"]
    pr = cell.config["problem"]
    assert (pr["num_cameras"], pr["num_points"], pr["num_observations"]) \
        == (13682, 4456117, 28987644)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_at_test_size(trace):
    cell = harness.Cell(ROOT, NAME, SMALL)
    out = harness.run_cell(cell, 2 ** 33 + 7, 0.2, bool(trace),
                           torch.device("cpu"), time.perf_counter())
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert list(out["checks"]) == ["cost_gap", "descent_gap", "rank_gap"]
    assert out["attempted"] % 2 == 0          # whole passes over 2 starts
    want = ({"ba_solve_s", "setup_s"} if not trace else
            {m["name"] for m in cell.per_layer
             if m["source"] != "device_trace"})
    assert want == set(out["metrics"])
    if trace:
        # a collective per LM step for its trial's cost and its blocks,
        # and one per CG iteration
        assert out["metrics"]["allreduces_per_lm_step"]["value"] > 2


def _judged_under(st, fault: int) -> dict:
    """One solve of the pool's first start with fault `fault` of
    faults_sharded planted on every rank (0: none), judged as the
    runner's check judges."""
    run = st.runner
    node = st.node
    node.command(sr.FAULT, fault)
    out, stats = node.command(sr.SOLVE, st.order[0])
    gap = node.command(sr.GAP, len(node.outputs) - 1)
    node.command(sr.FAULT, 0)
    k = st.order[0]
    found = run.numbers(st, run._solution(node, out), stats.initial_cost,
                        stats.final_cost,
                        run.reference_run(st, k, torch.float64)[1:])
    return dict(found, rank_gap=gap)


def test_program_passes_control_and_faults_fail():
    cell = harness.Cell(ROOT, NAME, SMALL)
    st = cell.runner.setup(cell.config, cell.mix, 5, torch.device("cpu"))
    st.runner = cell.runner
    try:
        readings = [_judged_under(st, f)
                    for f in range(len(faults_sharded.FAULTS) + 1)]
    finally:
        st.node.command(sr.STOP)
        torch.distributed.destroy_process_group()
        assert sr.stop_workers(st.workers) == [0, 0, 0]
    limits = cell.mix["limits"]

    def fails(found):
        return [n for n, v in found.items() if not v <= limits[n]]

    program, *faulted = readings
    assert not fails(program), program
    # the blocked reference reproduces the program's run of the rule
    assert program["cost_gap"] <= 1e-12 and program["descent_gap"] <= 1e-12
    for fault, found in zip(faults_sharded.FAULTS, faulted):
        assert fails(found), (fault.__name__, found)
    control = cell.runner.control_numbers(st, st.order[0])
    assert fails(control), control


def test_reference_takes_held_images_and_free_intrinsics_from_the_config():
    cell = harness.Cell(ROOT, NAME)
    held, free = cell.runner._held_and_free(cell.config, 5, "cpu")
    assert held.tolist() == [True, True, False, False, False]
    assert free.shape == (5, 3) and bool(free.all())
    cfg = harness.deep_update(cell.config, {"refine": {"extra": False}})
    assert cell.runner._held_and_free(cfg, 5, "cpu")[1].tolist() == \
        [[True, False, False]] * 5
    cfg = dict(cell.config, camera_model="SIMPLE_RADIAL")
    assert cell.runner._held_and_free(cfg, 2, "cpu")[1].tolist() == \
        [[True, True, False]] * 2


def test_a_forbidden_module_on_a_worker_rank_gives_no_result(monkeypatch):
    """Rank 2 starts with `flax` in its modules: the runner's release
    raises after stopping and joining every rank, so the run has no
    result line."""
    plant = ("import runpy, sys, types; "
             "sys.modules['flax'] = types.ModuleType('flax'); "
             "runpy.run_module('sfmbench.sharded_ranks', "
             "run_name='__main__', alter_sys=True)")
    popen = subprocess.Popen

    def planted(args, **kw):
        if args[3:5] == ["--rank", "2"]:
            args = [args[0], "-c", plant] + args[3:]
        return popen(args, **kw)

    monkeypatch.setattr(subprocess, "Popen", planted)
    cell = harness.Cell(ROOT, NAME, SMALL)
    st = cell.runner.setup(cell.config, cell.mix, 3, torch.device("cpu"))
    cell.runner.unit(st)
    with pytest.raises(RuntimeError, match=r"ranks \[2\]"):
        cell.runner.release(st)
    assert [p.returncode for p in st.workers] == [0, 0, 0]
    assert "flax" not in sys.modules


def _hash(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


# the benchmark as the cell found it: every file's hash, and each entry of
# BENCHMARK.json (the new cells taken out of the `workloads` they were
# appended to)
FILES = {
    "README.md": "014b74f7b86a2739",
    "__init__.py": "3ace9376b10082fd",
    "calibrate.py": "9a41efead5d473f5",
    "configs/bal-dubrovnik356.json": "51ba91b544bf6ac4",
    "configs/cluster100.json": "998aff07c4ab143c",
    "counts.py": "028e7660a2d472bd",
    "faults.py": "6c2de1f0b2efbfc7",
    "harness.py": "8cdfe61b856e0e10",
    "metrics/ba_lm_roofline.py": "a4a335b21e7d1af2",
    "metrics/ba_read_wait_ms_per_lm_step.py": "594e064b3cf5afb6",
    "metrics/cg_per_lm_step.py": "098845e2bf0c5148",
    "metrics/device_idle_pct.ba.py": "871b284893fa9038",
    "metrics/device_idle_pct.verify.py": "fb3e0860fa5239f3",
    "metrics/host_reads_per_lm_step.py": "36ee03ec5b7bb89c",
    "metrics/k1_roofline.py": "83821808a14ba694",
    "metrics/lm_step_ms.py": "8c75b8aa73acf676",
    "metrics/match_ms_per_pair.py": "2377231cb1333dc6",
    "metrics/ransac_host_ms_per_pair.py": "7e4314984ebcdc1a",
    "metrics/select_ms_per_pair.py": "f06ebb130aff3728",
    "metrics/verify_ms_per_pair.py": "5e4c7acfc86d5414",
    "metrics/verify_read_wait_ms_per_pair.py": "d755a549a96e5400",
    "peaks.py": "2303a6fb5ee22b09",
    "program_roots.py": "8f27228e28999dad",
    "reference/ba.py": "55afe926c2c0be69",
    "reference/matcher.py": "cae630371cbfdd76",
    "reference/two_view.py": "83a23171d22296f5",
    "run.py": "4a2d567bfb135c6f",
    "runners/ba.py": "bd1e07f7c5df8999",
    "runners/verify.py": "cfc32fc000ee8598",
    "scenes.py": "d4bc2a07d3dc7908",
    "tests/__init__.py": "e3b0c44298fc1c14",
    "tests/conftest.py": "503fff71401285f1",
    "tests/test_sfmbench_control.py": "888058539e4d69a1",
    "tests/test_sfmbench_discovery.py": "4c56322608efdee6",
    "tests/test_sfmbench_imports.py": "37026fba943394b8",
    "tests/test_sfmbench_inputs.py": "0fb1512ee357ac9c",
    "tests/test_sfmbench_reference.py": "774c52b4708f26cd",
    "tests/test_sfmbench_result.py": "0607e265bbb7616d",
    "trace.py": "3138f0f6f701b57b",
    "traffic/sequential_jobs128.json": "636d167e2ada7164",
    "traffic/start_pool2.json": "7086de2971360319",
}
ENTRIES = {
    "configs": {"cluster100": "510f2ef5dbaea922",
                "bal-dubrovnik356": "be4698c25365acef"},
    "workloads": {"verify.cluster100": "77d3750c99112fea",
                  "ba.dubrovnik356": "42f55493e9c49def"},
    "end_to_end": {"pairs_verified_per_s": "8c45ff0908de89d6",
                   "ba_solve_s": "7997c5c00ef325e1",
                   "setup_s": "2e3afdd1be0e39bd"},
    "per_layer": {
        "match_ms_per_pair": "4e31cff0f6d349fb",
        "k1_roofline": "0ce8db95bca4f1d2",
        "verify_ms_per_pair": "9f1b6fcdad6191aa",
        "lm_step_ms": "b4e2c6d4b4392047",
        "cg_per_lm_step": "dc4d8e686d88867b",
        "ba_lm_roofline": "ca13c66e2783a154",
        "device_idle_pct.verify": "c2a2791d6d33228a",
        "device_idle_pct.ba": "83bd32e021fce13c",
        "verify_read_wait_ms_per_pair": "e07b1ae183fc3b10",
        "ransac_host_ms_per_pair": "1b4d430cf7ab05f8",
        "select_ms_per_pair": "5d9d0973cca28bf7",
        "ba_read_wait_ms_per_lm_step": "b03743efbfaa60b9",
        "host_reads_per_lm_step": "3d3f439d929f2c04"},
}


def test_no_existing_benchmark_file_or_entry_changed():
    for rel, want in FILES.items():
        assert _hash((ROOT / "sfmbench" / rel).read_bytes()) == want, rel
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert (spec["command"], spec["paths"], spec["run_seconds"]) == \
        (["python3", "-m", "sfmbench.run"], ["sfmbench"], 30)
    new_cells = [w["name"] for w in spec["workloads"]
                 if w["name"] not in ENTRIES["workloads"]]
    for section, old in ENTRIES.items():
        names = [e["name"] for e in spec[section]]
        assert names[:len(old)] == list(old), section    # new ones last
        for e in spec[section][:len(old)]:
            e = dict(e)
            if "workloads" in e:
                e["workloads"] = [w for w in e["workloads"]
                                  if w not in new_cells]
            assert _hash(json.dumps(e, sort_keys=True).encode()) == \
                old[e["name"]], (section, e["name"])
