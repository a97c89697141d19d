"""The port's photo commands that map or take a model, against the JAX
package's on the CPU (`cli.main` of each package in its own directory,
so both print the same lines):

- automatic_reconstructor of the port on eight neighbouring views of
  tests/test_e2e_pixels.py's 12-view ring at 320 x 240 (JPEGs, quality
  95; fewer or smaller views leave a mapper short of a whole model):
  all eight registered within tests/test_e2e_pixels.py's limits (ATE <
  0.1, mean rotation error < 1 degree). Its slow twin runs the JAX
  package's command on the same photos: the same line but for the point
  count, both models within those limits.
- color_extractor, image_rectifier and model_orientation_aligner of both
  packages on the port's model: the models byte for byte (the aligned
  quaternions within 1 ulp and the translations within 8, as for
  `model_aligner` in tests/test_torch_cli_models.py), the .npz files'
  images to 1e-5 (float32 warps) and Q exactly, the same lines;
  MANHATTAN-WORLD also on photos of lines through each camera's
  vanishing points, where a frame is found.
- Without PIL every photo command exits with the JAX package's message.
"""
import builtins
import os

import numpy as np
import pytest
import torch

from dagsfm_tpu.pipeline import cli as j_cli
from dagsfm_tpu_torch.pipeline import cli as t_cli
from dagsfm_tpu_torch.scene import io as t_io
from dagsfm_tpu_torch.scene import synthetic as t_syn
from tests.test_torch_cli_models import _read_images_bin, _same_files
from tests.test_torch_cli_photos import run, write_photos

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

torch.set_num_threads(1)

NMAP = 8


@pytest.fixture(scope="module")
def photos_to_map(tmp_path_factory):
    """Eight views at 320 x 240, which both packages map whole (fewer or
    smaller views leave a mapper short of a whole model)."""
    d = str(tmp_path_factory.mktemp("photos_to_map"))
    return (d,) + write_photos(d, 320, 240, NMAP)


def automatic(pkg: str, d: str, flags: list) -> tuple:
    """automatic_reconstructor of one package in d/<pkg>: (printed
    lines, the workspace)."""
    import contextlib
    import io
    cli = t_cli if pkg == "port" else j_cli
    os.makedirs(f"{d}/{pkg}", exist_ok=True)
    here = os.getcwd()
    os.chdir(f"{d}/{pkg}")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(["automatic_reconstructor", "--image_path",
                      f"{d}/imgs", "--workspace_path", "ws"] + flags
                     + (["--device", "cpu"] if pkg == "port" else []))
    finally:
        os.chdir(here)
    return buf.getvalue().splitlines(), f"{d}/{pkg}/ws"


def check_model(lines, ws, sc):
    """automatic_reconstructor's line and model against the truth."""
    assert lines[0].startswith(f"reconstruction: {NMAP} images, ")
    assert lines[0].endswith(" points -> ws/sparse/0") and len(lines) == 1
    rec = t_io.read_model_bin(f"{ws}/sparse/0")
    err = t_syn.pose_errors(rec, sc)
    assert err["num_reg"] == NMAP, err
    assert err["ate"] < 0.1 and err["rot_err_deg_mean"] < 1.0, err
    assert os.path.exists(f"{ws}/database.db")


@pytest.fixture(scope="module")
def port_model(photos_to_map):
    """The port's automatic_reconstructor: (lines, workspace)."""
    d, _, flags = photos_to_map
    return automatic("port", d, flags)


def test_automatic_reconstructor(photos_to_map, port_model):
    check_model(*port_model, photos_to_map[1])


@pytest.mark.slow
def test_automatic_reconstructor_against_reference(photos_to_map,
                                                   port_model):
    """The JAX package's command on the same photos (its jit compiles and
    mapping take about a minute on the CPU): the same line but for the
    point count, both models within the limits."""
    d, sc, flags = photos_to_map
    lines, ws = automatic("ref", d, flags)
    check_model(lines, ws, sc)
    assert lines[0].split(",")[0] == port_model[0][0].split(",")[0]


def _both(cmd_argv, d, capsys, tag):
    """One command in both packages, each writing to <pkg>/<tag>;
    returns {pkg: (lines, output path)}."""
    return {pkg: (run(pkg, cmd_argv + ["--output_path", tag], capsys, d),
                  f"{d}/{pkg}/{tag}") for pkg in ("ref", "port")}


def test_color_extractor(photos_to_map, port_model, capsys):
    d, _, _ = photos_to_map
    model = port_model[1] + "/sparse/0"
    out = _both(["color_extractor", "--image_path", f"{d}/imgs",
                 "--input_path", model], d, capsys, "color")
    (jl, jo), (tl, to) = out["ref"], out["port"]
    assert tl == jl
    n, total = map(int, tl[0].split()[1].split("/"))
    assert n == total > 0
    _same_files(jo, to)


def test_image_rectifier(photos_to_map, port_model, capsys):
    d, _, _ = photos_to_map
    model = port_model[1] + "/sparse/0"
    pairs = f"{d}/pairs.txt"
    with open(pairs, "w") as f:
        f.write("image00001.jpg image00002.jpg\n\nbad line here\n"
                "image00003.jpg image00005.jpg\n")
    out = _both(["image_rectifier", "--image_path", f"{d}/imgs",
                 "--input_path", model, "--stereo_pairs_list", pairs],
                d, capsys, "rect")
    (jl, jo), (tl, to) = out["ref"], out["port"]
    assert tl == jl == ["rectified 2 stereo pairs -> rect"]
    assert sorted(os.listdir(to)) == sorted(os.listdir(jo)) == \
        ["image00001-image00002.npz", "image00003-image00005.npz"]
    for name in os.listdir(jo):
        j, t = np.load(f"{jo}/{name}"), np.load(f"{to}/{name}")
        assert sorted(t.files) == sorted(j.files) == ["Q", "left", "right"]
        np.testing.assert_array_equal(t["Q"], j["Q"])
        for k in ("left", "right"):
            assert t[k].shape == j[k].shape
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-5)


def _same_models(a: str, b: str) -> None:
    """Two .bin models: cameras.bin and points3D.bin byte for byte,
    images.bin's quaternions within 1 ulp (NaN where the other's is NaN)
    and the rest of each record byte for byte."""
    for name in ("cameras.bin", "points3D.bin"):
        assert open(f"{a}/{name}", "rb").read() == \
            open(f"{b}/{name}", "rb").read(), name
    for (i, q, r), (j, p, t) in zip(_read_images_bin(f"{a}/images.bin"),
                                    _read_images_bin(f"{b}/images.bin")):
        assert (i, r) == (j, t)
        np.testing.assert_allclose(q[:4], p[:4], rtol=0,
                                   atol=np.spacing(1.0))
        np.testing.assert_allclose(q[4:], p[4:], rtol=0,
                                   atol=8 * np.spacing(np.abs(p[4:]).max()))


@pytest.mark.parametrize("method", ["IMAGE-ORIENTATION", "MANHATTAN-WORLD"])
def test_model_orientation_aligner(photos_to_map, port_model, method,
                                   capsys):
    """On the mapped photos. They show no straight lines, so the
    Manhattan frame is empty and both packages write NaN poses (the JAX
    package's `rotation_from_unit_vectors` of a zero axis)."""
    d, _, _ = photos_to_map
    model = port_model[1] + "/sparse/0"
    out = _both(["model_orientation_aligner", "--image_path", f"{d}/imgs",
                 "--input_path", model, "--method", method], d, capsys,
                method)
    (jl, jo), (tl, to) = out["ref"], out["port"]
    assert tl == jl == [f"aligned ({method.lower()}) -> {method}"]
    _same_models(jo, to)
    q = t_io.read_model_bin(to).images[1].qvec
    assert np.isnan(q).all() == (method == "MANHATTAN-WORLD")


@pytest.mark.parametrize("max_size", ["1024", "100"])
def test_manhattan_aligner_on_lines(tmp_path, capsys, max_size):
    """On photos of lines through each camera's vanishing points
    (tests/test_torch_coordinate_frame.manhattan_images): a frame, the
    same models."""
    from tests.test_torch_coordinate_frame import (_yawed_rec,
                                                   manhattan_images)
    _, trec = _yawed_rec()
    d = str(tmp_path)
    t_io.write_model_bin(trec, f"{d}/model")
    os.makedirs(f"{d}/imgs")
    for iid, img in manhattan_images(trec).items():
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(
            f"{d}/imgs/{trec.images[iid].name}")
    out = _both(["model_orientation_aligner", "--image_path", f"{d}/imgs",
                 "--input_path", f"{d}/model", "--max_image_size",
                 max_size], d, capsys, "aligned")
    (jl, jo), (tl, to) = out["ref"], out["port"]
    assert tl == jl == ["aligned (manhattan-world) -> aligned"]
    _same_models(jo, to)
    rec = t_io.read_model_bin(to)
    assert all(np.isfinite(im.qvec).all() for im in rec.images.values())


PHOTO_ARGS = {
    "feature_extractor": ["--database_path", "x.db"],
    "exhaustive_matcher": ["--database_path", "x.db"],
    "sequential_matcher": ["--database_path", "x.db"],
    "vocab_tree_matcher": ["--database_path", "x.db"],
    "global_matcher": ["--database_path", "x.db"],
    "automatic_reconstructor": ["--workspace_path", "ws"],
    "color_extractor": ["--input_path", "MODEL", "--output_path", "o"],
    "image_rectifier": ["--input_path", "MODEL", "--output_path", "o",
                        "--stereo_pairs_list", "p.txt"],
    "model_orientation_aligner": ["--input_path", "MODEL", "--output_path",
                                  "o", "--method", "MANHATTAN-WORLD"]}


def test_without_pil_each_command_exits(photos_to_map, port_model,
                                       monkeypatch, capsys, tmp_path):
    d, _, _ = photos_to_map
    model = port_model[1] + "/sparse/0"
    for pkg in ("ref", "port"):
        os.makedirs(tmp_path / pkg)
        (tmp_path / pkg / "p.txt").write_text(
            "image00001.jpg image00002.jpg\n")
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    for cmd, args in PHOTO_ARGS.items():
        args = [model if a == "MODEL" else a for a in args]
        msgs = []
        for pkg in ("ref", "port"):
            with pytest.raises(SystemExit) as e:
                run(pkg, [cmd, "--image_path", f"{d}/imgs"] + args, capsys,
                    str(tmp_path))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and "requires PIL" in msgs[0], cmd
    for pkg in ("ref", "port"):
        assert not os.path.exists(tmp_path / pkg / "x.db")
