"""A configuration, a traffic mix and a per-layer metric added as new
files, with new entries in BENCHMARK.json, are found by name and run,
with no file of the benchmark edited."""

import json
import shutil
import time

import torch

from sfmbench import harness
from sfmbench.tests.conftest import ROOT, TINY


def _copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "sfmbench", tmp_path / "sfmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def test_new_files_are_found_by_name(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "sfmbench").rglob("*")
              if p.is_file()}
    bench = root / "sfmbench"
    cfg = json.loads((bench / "configs" / "cluster100.json").read_text())
    cfg.update(name="cluster60")
    cfg["scene"]["num_cameras"] = 60
    (bench / "configs" / "cluster60.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "sequential_jobs128.json")
                     .read_text())
    mix.update(job_pairs=64)
    (bench / "traffic" / "sequential_jobs64.json").write_text(
        json.dumps(mix))
    (bench / "metrics" / "jobs_per_s.py").write_text(
        "def read(ctx):\n"
        "    return ctx['counters']['pairs'] / 64 / ctx['window_s']\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(
        name="cluster60", source=cfg["source"],
        file="sfmbench/configs/cluster60.json", reduced=["scene"],
        why="a smaller cluster"))
    spec["workloads"].append(dict(
        name="verify.cluster60", config="cluster60",
        traffic="sequential_jobs64", chips=1, why="smaller jobs"))
    spec["end_to_end"][0]["workloads"].append("verify.cluster60")
    spec["per_layer"].append(dict(
        name="jobs_per_s", unit="jobs/s", better="higher",
        source="host_clock", layer="feature pipeline",
        moves="pairs_verified_per_s", workloads=["verify.cluster60"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    over = {"config": TINY["verify.cluster100"]["config"],
            "traffic": dict(TINY["verify.cluster100"]["traffic"], job_pairs=4)}
    cell = harness.Cell(root, "verify.cluster60", over)
    assert cell.mix["job_pairs"] == 4 and cell.config["name"] == "cluster60"
    assert [m["name"] for m in cell.e2e] == ["pairs_verified_per_s",
                                             "setup_s"]
    assert list(cell.readers) == ["jobs_per_s"]
    out = harness.run_cell(cell, 5, 0.2, True, torch.device("cpu"),
                           time.perf_counter())
    assert out["correct"] and out["metrics"]["jobs_per_s"]["value"] > 0
    assert set(out["metrics"]) == {"jobs_per_s"}
    # the cells already there are untouched and still found
    old = harness.Cell(root, "verify.cluster100")
    assert "k1_roofline" in old.readers and "jobs_per_s" not in old.readers
    for p, b in before.items():
        assert p.read_bytes() == b, p
