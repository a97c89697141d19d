"""The dense path's commands, `python -m dagsfm_tpu_torch image_undistorter
| model_converter | poisson_mesher | delaunay_mesher`, against the JAX
package's CLI on the CPU: the same files, byte for byte, and the same
printed lines. image_undistorter's keypoints come from each package's
Newton undistortion, which agree to rel 1e-9 and not always to the last
bit, so its images.bin is compared field by field (keypoints to rel
1e-9) and every other file byte for byte."""
import os

import numpy as np
import pytest
import torch

from dagsfm_tpu.mvs import io as j_mvs_io
from dagsfm_tpu.pipeline import cli as j_cli
from dagsfm_tpu.scene import cameras as j_cm
from dagsfm_tpu.scene import io as j_io
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu_torch.pipeline import cli as t_cli
from dagsfm_tpu_torch.scene import io as t_io

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A .bin model and its text twin: a SIMPLE_RADIAL camera, coloured
    points, one unregistered image."""
    spec = j_syn.SyntheticSceneSpec(num_cameras=6, num_points=70,
                                    pixel_noise=0.3, seed=8)
    rec = j_syn.to_reconstruction(j_syn.generate(spec))
    cam = rec.cameras[1]
    rec.cameras[1] = j_cm.Camera(1, j_cm.SIMPLE_RADIAL, cam.width,
                                 cam.height, tuple(cam.params) + (-0.05,))
    rng = np.random.default_rng(1)
    for pt in rec.points3D.values():
        pt.color = rng.integers(0, 256, 3).astype(np.uint8)
    rec.images[2].registered = False
    root = tmp_path_factory.mktemp("model")
    j_io.write_model_bin(rec, str(root / "bin"))
    os.makedirs(root / "txt")
    j_io.write_model_text(rec, str(root / "txt"))
    return root


def run(mod, argv, capsys) -> str:
    mod.main(argv)
    return capsys.readouterr().out


def tree(root) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def both(tmp_path, capsys, argv, port_extra=()):
    """Run argv (with OUT standing for a per-package output path) through
    each CLI; returns ({side: printed text with OUT restored}, paths)."""
    printed, paths = {}, {}
    for side, mod, extra in (("ref", j_cli, ()), ("port", t_cli, port_extra)):
        out = str(tmp_path / side / "out")
        os.makedirs(tmp_path / side, exist_ok=True)
        args = [out if a == "OUT" else a for a in argv] + list(extra)
        printed[side] = run(mod, args, capsys).replace(out, "OUT")
        paths[side] = out
    return printed, paths


@pytest.mark.parametrize("kind", ["BIN", "TXT", "PLY", "NVM", "Bundler"])
@pytest.mark.parametrize("src", ["bin", "txt"])
def test_model_converter(model, tmp_path, capsys, kind, src):
    if kind in ("BIN", "TXT"):
        for side in ("ref", "port"):
            os.makedirs(tmp_path / side / "out")
    printed, paths = both(tmp_path, capsys, [
        "model_converter", "--input_path", str(model / src),
        "--output_path", "OUT", "--output_type", kind])
    assert printed["ref"] == printed["port"] == f"converted -> OUT ({kind})\n"
    ref, port = tree(tmp_path / "ref"), tree(tmp_path / "port")
    assert ref == port and len(ref) == {"BIN": 3, "TXT": 3,
                                        "Bundler": 2}.get(kind, 1)


def test_model_converter_unknown_type(model, tmp_path):
    for mod in (j_cli, t_cli):
        with pytest.raises(SystemExit, match="unknown output_type XYZ"):
            mod.main(["model_converter", "--input_path", str(model / "bin"),
                      "--output_path", str(tmp_path / "x"),
                      "--output_type", "XYZ"])


@pytest.mark.parametrize("kind", ["COLMAP", "PMVS", "CMP-MVS"])
def test_image_undistorter(model, tmp_path, capsys, kind):
    printed, paths = both(tmp_path, capsys, [
        "image_undistorter", "--input_path", str(model / "bin"),
        "--output_path", "OUT", "--output_type", kind],
        port_extra=("--device", "cpu"))
    assert printed["ref"] == printed["port"] == \
        f"undistorted -> OUT ({kind})\n"
    ref, port = tree(paths["ref"]), tree(paths["port"])
    assert sorted(ref) == sorted(port) and len(ref) >= 3
    images_bin = os.path.join("sparse", "images.bin")
    for name in ref:
        if name != images_bin:
            assert ref[name] == port[name], name
    if kind == "COLMAP":
        a = j_io.read_images_bin(os.path.join(paths["ref"], images_bin))
        b = t_io.read_images_bin(os.path.join(paths["port"], images_bin))
        assert sorted(a) == sorted(b)
        for i, im in a.items():
            g = b[i]
            assert (g.name, g.camera_id) == (im.name, im.camera_id)
            assert np.array_equal(g.qvec, im.qvec)
            assert np.array_equal(g.tvec, im.tvec)
            assert np.array_equal(g.point3D_ids, im.point3D_ids)
            assert np.abs(g.xys - im.xys).max() <= 1e-9 * np.abs(im.xys).max()


@pytest.fixture(scope="module")
def fused_ply(tmp_path_factory):
    rng = np.random.default_rng(2)
    v = rng.normal(size=(3000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    root = tmp_path_factory.mktemp("fused")
    j_mvs_io.write_ply_points(str(root / "fused.ply"),
                              v + rng.normal(0, 0.01, v.shape), normal=v,
                              color=rng.uniform(0, 1, 3000))
    j_mvs_io.write_ply_points(str(root / "bare.ply"), v)
    return root


@pytest.mark.parametrize("flags", [["--grid", "40"],
                                   ["--grid", "32", "--screen", "2.0",
                                    "--smooth", "1.5"]])
def test_poisson_mesher(fused_ply, tmp_path, capsys, flags):
    printed, paths = both(tmp_path, capsys, [
        "poisson_mesher", "--input_path", str(fused_ply / "fused.ply"),
        "--output_path", "OUT"] + flags, port_extra=("--device", "cpu"))
    assert printed["ref"] == printed["port"]
    assert printed["ref"].startswith("poisson mesh: ")
    with open(paths["ref"], "rb") as a, open(paths["port"], "rb") as b:
        ref = a.read()
        assert ref == b.read() and len(ref) > 10000


def test_poisson_mesher_needs_normals(fused_ply, tmp_path):
    for mod, extra in ((j_cli, []), (t_cli, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="needs a PLY with nx/ny/nz"):
            mod.main(["poisson_mesher", "--input_path",
                      str(fused_ply / "bare.ply"), "--output_path",
                      str(tmp_path / "m.ply")] + extra)


@pytest.mark.parametrize("factor", ["3.0", "1.5"])
def test_delaunay_mesher(fused_ply, tmp_path, capsys, factor):
    printed, paths = both(tmp_path, capsys, [
        "delaunay_mesher", "--input_path", str(fused_ply / "bare.ply"),
        "--output_path", "OUT", "--max_edge_factor", factor])
    assert printed["ref"] == printed["port"]
    assert printed["ref"].startswith("delaunay mesh: 3000 vertices")
    with open(paths["ref"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
