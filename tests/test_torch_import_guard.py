"""The port imports neither jax nor the JAX package (dagsfm_tpu).

Runs in a subprocess where `jax` is unimportable and a meta-path hook
refuses `dagsfm_tpu` and `dagsfm_tpu.*` — but not `dagsfm_tpu_torch`,
whose name shares the prefix — then imports every port module (the
parallel layer and the CLI among them) and chip_smoke.py, or runs
`python -m dagsfm_tpu_torch`'s commands as far as their arguments.
"""
import os
import pkgutil
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys
sys.modules["jax"] = None

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "dagsfm_tpu" or name.startswith("dagsfm_tpu."):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import dagsfm_tpu_torch
names = ["dagsfm_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(dagsfm_tpu_torch.__path__,
                                          "dagsfm_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "dagsfm_tpu" or m.startswith("dagsfm_tpu.")]
assert not [m for m in bad if sys.modules[m] is not None], bad
print("IMPORTED", len(names))
"""


def _run(code: str):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax_or_reference():
    out = _run(_GUARD)
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split("IMPORTED")[-1])
    import dagsfm_tpu_torch
    expected = 1 + sum(1 for _ in pkgutil.walk_packages(
        dagsfm_tpu_torch.__path__, "dagsfm_tpu_torch."))
    assert n == expected >= 20


def test_cli_runs_without_jax_or_reference():
    """`python -m dagsfm_tpu_torch` and each command's --help, under the
    guard and in one process: argparse exits 0 after printing the usage,
    and nothing of jax or the JAX package was imported."""
    head = _GUARD.split("import dagsfm_tpu_torch")[0]
    argvs = [[], ["local_sfm_worker"], ["local_matching_worker"],
             ["distributed_mapper"], ["vocab_tree_builder"],
             ["vocab_tree_retriever"], ["spatial_matcher"],
             ["transitive_matcher"], ["image_undistorter"],
             ["model_converter"], ["poisson_mesher"], ["delaunay_mesher"],
             ["mapper"], ["sfm_aligner"], ["bundle_adjuster"],
             ["point_triangulator"], ["image_registrator"],
             ["database_creator"], ["matches_importer"],
             ["database_merger"], ["feature_importer"], ["model_analyzer"],
             ["model_merger"], ["model_aligner"], ["point_filtering"],
             ["image_deleter"], ["image_filterer"], ["synthetic_scene"],
             ["project_generator"], ["rig_bundle_adjuster"],
             ["feature_extractor"], ["exhaustive_matcher"],
             ["sequential_matcher"], ["vocab_tree_matcher"],
             ["global_matcher"], ["automatic_reconstructor"],
             ["color_extractor"], ["image_rectifier"],
             ["model_orientation_aligner"]]
    out = _run(head + (
        "import contextlib, io, runpy\n"
        f"for argv in {argvs!r}:\n"
        "    sys.argv = ['dagsfm_tpu_torch'] + argv + ['--help']\n"
        "    buf = io.StringIO()\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(buf):\n"
        "            runpy.run_module('dagsfm_tpu_torch', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (argv, e.code)\n"
        "    assert 'usage: dagsfm_tpu_torch' in buf.getvalue(), argv\n"
        "    print('HELP', *argv)\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and "
        "(m == 'jax' or m.startswith(('jax.', 'dagsfm_tpu.')) or "
        "m == 'dagsfm_tpu')]\n"
        "assert not bad, bad\n"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("HELP") == len(argvs)


def test_guard_refuses_the_reference():
    """The hook itself works: the JAX package cannot be imported under it,
    so the test above proves something."""
    out = _run(_GUARD.split("import dagsfm_tpu_torch")[0]
               + "import dagsfm_tpu.scene.synthetic\n")
    assert out.returncode != 0
    assert "refused: dagsfm_tpu" in out.stderr


def test_port_sources_never_name_jax():
    """No source line of the port or chip_smoke imports jax/dagsfm_tpu."""
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|dagsfm_tpu)(\s|\.|$)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "dagsfm_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    offenders = [f for f in files for line in open(f)
                 if pat.match(line)]
    assert not offenders, offenders


def test_ops_import_nothing_of_sfm_and_the_sums_live_in_ops():
    """No module under ops/ imports dagsfm_tpu_torch.sfm, at the top or
    inside a function, and the fixed-order sum is defined in one place:
    ops/segment_sum.py."""
    import ast
    port = os.path.join(ROOT, "dagsfm_tpu_torch")
    up, defs = [], []
    for d, _, fs in os.walk(port):
        for f in (f for f in fs if f.endswith(".py")):
            rel = os.path.relpath(os.path.join(d, f), port)
            with open(os.path.join(d, f)) as src:
                tree = ast.parse(src.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module] + [f"{node.module}.{a.name}"
                                             for a in node.names]
                elif isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                else:
                    names = []
                if rel.startswith("ops" + os.sep) and any(
                        n == "dagsfm_tpu_torch.sfm" or
                        n.startswith("dagsfm_tpu_torch.sfm.") for n in names):
                    up.append(rel)
                if isinstance(node, ast.FunctionDef) and \
                        node.name.lstrip("_") == "segment_sum":
                    defs.append(rel)
    assert not up, up
    assert defs == [os.path.join("ops", "segment_sum.py")], defs


def test_tools_help_runs_without_jax_or_reference():
    """`python -m dagsfm_tpu_torch.tools.<tool> --help` for every ported
    tools/ program, under the guard and in one process."""
    tools = sorted(f[:-3] for f in os.listdir(
        os.path.join(ROOT, "dagsfm_tpu_torch", "tools"))
        if f.endswith(".py") and f not in ("__init__.py", "common.py"))
    assert len(tools) == 8           # the JAX package's eight tools
    head = _GUARD.split("import dagsfm_tpu_torch")[0]
    out = _run(head + (
        "import contextlib, io, runpy\n"
        f"for name in {tools!r}:\n"
        "    sys.argv = [name, '--help']\n"
        "    buf = io.StringIO()\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(buf):\n"
        "            runpy.run_module('dagsfm_tpu_torch.tools.' + name,\n"
        "                             run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (name, e.code)\n"
        "    assert 'usage:' in buf.getvalue(), name\n"
        "    print('HELP', name)\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and "
        "(m == 'jax' or m.startswith(('jax.', 'dagsfm_tpu.')) or "
        "m == 'dagsfm_tpu')]\n"
        "assert not bad, bad\n"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("HELP") == len(tools)
