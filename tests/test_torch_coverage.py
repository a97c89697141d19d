"""The port covers the JAX package: every module has a counterpart at
the same path in dagsfm_tpu_torch/ with each of its public functions
and classes, and every CLI command has the same flags (plus `--device`
where the port's command computes on a device).

Two modules have none by design:
- ops/pallas_matcher.py, the Pallas kernels, whose counterparts are the
  CUDA kernels' modules ops/matcher_kernel.py (K1) and
  ops/top2_matcher.py (K2-K4);
- utils/compile_cache.py, XLA's persistent compile cache.
Four public functions have none either: parallel/mesh.py's make_mesh,
shard_leading and replicate and parallel/ba_sharded.py's place build a
JAX device mesh or put arrays on it, which torch.distributed has no
counterpart of.
The test reads the JAX package's files and builds its parser; it runs
none of its commands."""
import ast
import importlib
import os

from dagsfm_tpu.pipeline import cli as j_cli
from dagsfm_tpu_torch.pipeline import cli as t_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE, PORT = (os.path.join(ROOT, p) for p in ("dagsfm_tpu",
                                                     "dagsfm_tpu_torch"))
ELSEWHERE = {"ops/pallas_matcher.py": ("ops/matcher_kernel.py",
                                       "ops/top2_matcher.py")}
NONE = {"utils/compile_cache.py"}
XLA_ONLY = {"parallel/mesh.py": {"make_mesh", "shard_leading", "replicate"},
            "parallel/ba_sharded.py": {"place"}}


def modules(root: str) -> set:
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")
            and "__pycache__" not in d}


def test_every_module_has_a_counterpart():
    ref, port = modules(REFERENCE), modules(PORT)
    assert len(ref) >= 80
    missing = ref - port - set(ELSEWHERE) - NONE
    assert not missing, sorted(missing)
    for mod, there in ELSEWHERE.items():
        assert mod in ref and mod not in port
        assert set(there) <= port, there
    assert NONE <= ref and not NONE & port


def public_names(path: str) -> set:
    """The public functions and classes a module file defines."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body if isinstance(
        n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def test_every_public_function_has_a_counterpart():
    missing = {}
    for rel in sorted(modules(REFERENCE) & modules(PORT)):
        name = "dagsfm_tpu_torch." + rel[:-3].replace(os.sep, ".")
        port = importlib.import_module(name.removesuffix(".__init__"))
        lack = {n for n in public_names(os.path.join(REFERENCE, rel))
                if not hasattr(port, n)} - XLA_ONLY.get(rel, set())
        if lack:
            missing[rel] = sorted(lack)
    assert not missing, missing


def _commands(parser) -> dict:
    sub = next(a for a in parser._actions if a.dest == "command")
    return {name: {a.option_strings[0]: (a.default, a.required, a.type,
                                         a.nargs, a.const)
                   for a in sp._actions if a.option_strings
                   and a.dest != "help"}
            for name, sp in sub.choices.items()}


def test_every_command_has_the_reference_s_flags():
    ref, port = _commands(j_cli.build_parser()), _commands(
        t_cli.build_parser())
    assert set(port) == set(ref) and len(ref) == 38
    with_device = set()
    for name, flags in ref.items():
        got = dict(port[name])
        if "--device" in got:
            assert got.pop("--device") == ("cuda", False, None, None, None)
            with_device.add(name)
        assert got == flags, name
    # the commands that run only on the host take no --device
    assert set(ref) - with_device == {
        "model_converter", "delaunay_mesher", "synthetic_scene",
        "database_creator", "matches_importer", "model_analyzer",
        "model_aligner", "point_filtering", "database_merger",
        "project_generator", "feature_importer", "image_deleter",
        "image_filterer", "color_extractor"}


def _flags(path: str) -> set:
    """The option strings a file passes to any `add_argument`."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "add_argument" and n.args
            and isinstance(n.args[0], ast.Constant)
            and str(n.args[0].value).startswith("--")}


def test_every_tool_has_a_counterpart_with_its_flags():
    """Every tools/*.py program of the JAX package is a module of
    dagsfm_tpu_torch/tools/ with the same name, a `run` and a `main`, and
    every flag of the reference tool; the seven ported in one slice also
    take --device (default cuda) and --out."""
    tools = os.path.join(ROOT, "tools")
    ref = {f for f in os.listdir(tools) if f.endswith(".py")}
    assert len(ref) == 8
    for f in sorted(ref):
        name = "dagsfm_tpu_torch.tools." + f[:-3]
        port = importlib.import_module(name)
        assert callable(port.run) and callable(port.main), name
        got = _flags(port.__file__)
        assert _flags(os.path.join(tools, f)) <= got, name
        if f != "matcher_mfu.py":
            assert {"--device", "--out"} <= got, name
            device = next(a for a in port.parser()._actions
                          if "--device" in a.option_strings)
            assert device.default == "cuda", name
