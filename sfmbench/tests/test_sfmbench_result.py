"""The result line: its keys and their order, the checks last, the
metrics of each mode, on every cell at its test size on the CPU; and the
command's exits without a card and without the program."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from sfmbench import harness
from sfmbench.tests.conftest import ROOT, TINY


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", sorted(TINY))
def test_result_line(name, trace, capsys):
    cell = harness.Cell(ROOT, name, TINY[name])
    out = harness.run_cell(cell, 2 ** 33 + 1, 0.2, bool(trace),
                           torch.device("cpu"), time.perf_counter())
    json.dumps(out)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    want = ({m["name"] for m in cell.e2e} if not trace
            else {m["name"] for m in cell.per_layer
                  if m["source"] != "device_trace"})
    assert want <= set(out["metrics"])
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    err = capsys.readouterr().err.strip().splitlines()
    assert [ln.split()[1] for ln in err[-len(out["checks"]):]] == \
        list(out["checks"])
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)


def _run(cwd, extra_env=None):
    env = dict(os.environ, **(extra_env or {}))
    env["PYTHONPATH"] = ""
    return subprocess.run(
        [sys.executable, "-m", "sfmbench.run", "--workload",
         "verify.cluster100", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "sfmbench", tmp_path / "sfmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
