"""Nothing the benchmark loads in a run has the top-level name jax,
jaxlib, flax or dagsfm_tpu, compared whole (dagsfm_tpu_torch is the
program and is allowed)."""

import subprocess
import sys
import types

from sfmbench import harness
from sfmbench.tests.conftest import ROOT

_GUARD = r"""
import importlib.abc, sys, time
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["flax"] = None

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "dagsfm_tpu":
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import torch
torch.set_num_threads(2)
from sfmbench import harness
from sfmbench.tests.conftest import ROOT, TINY
for name in sorted(TINY):
    cell = harness.Cell(ROOT, name, TINY[name])
    out = harness.run_cell(cell, 3, 0.1, True, torch.device("cpu"),
                           time.perf_counter())
    assert out is not None and out["correct"], (name, out)
print("LOADED", [m for m in sys.modules if m.startswith("dagsfm_tpu")][:3])
print("BAD", harness.forbidden_modules())
"""


def test_a_run_loads_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dagsfm_tpu_torch" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_names_are_compared_whole(monkeypatch):
    for name in ("dagsfm_tpu_torch", "dagsfm_tpu_torch.ops", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    for name in ("dagsfm_tpu.ops", "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == ["dagsfm_tpu.ops", "flax",
                                           "jaxlib"]


def test_benchmark_sources_import_neither():
    for p in (ROOT / "sfmbench").rglob("*.py"):
        for line in p.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in harness.FORBIDDEN, (p, line)
