"""The port's extraction and matching commands on photos against the
JAX package's on the CPU, each pair on the same directory (`cli.main`
of each package): six neighbouring views of tests/test_e2e_pixels.py's
12-view ring at 160 x 120, written by PIL as JPEGs (quality 95) named as
the database names them. The commands that map and those that take a
model are in tests/test_torch_cli_photo_models.py.

- The flags of the nine photo commands are the JAX package's, plus
  `--device` where a command computes.
- feature_extractor: the database's cameras and image rows equal; the
  same number of keypoints per image, all but 1 % of them within 1e-3
  px and their uint8 descriptors within 1 (the SIFT tests' tolerances:
  the last bit of atan2 moves a few orientations); the same line.
- the four matchers: the same verified pairs and printed lines, the
  matches as tests/test_torch_pixels.py counts them; k-means' first
  centroids replay the JAX package's draws.
"""
import os

import numpy as np
import pytest
import torch

from dagsfm_tpu.pipeline import cli as j_cli
from dagsfm_tpu_torch.pipeline import cli as t_cli
from dagsfm_tpu_torch.scene import io as t_io
from dagsfm_tpu_torch.scene import synthetic as t_syn
from dagsfm_tpu_torch.features import retrieval as t_rt
from tests.test_torch_cli_models import _flags
from tests.test_torch_retrieval import replay_key

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

torch.set_num_threads(1)

NEW = {  # command -> computes on a device (takes --device)
    "feature_extractor": True, "exhaustive_matcher": True,
    "sequential_matcher": True, "vocab_tree_matcher": True,
    "global_matcher": True, "automatic_reconstructor": True,
    "color_extractor": False, "image_rectifier": True,
    "model_orientation_aligner": True}


def run(pkg: str, argv: list, capsys, root: str) -> list:
    """One command of one package in root/<pkg>/, so that relative
    output paths print the same; its printed lines."""
    os.makedirs(f"{root}/{pkg}", exist_ok=True)
    here = os.getcwd()
    os.chdir(f"{root}/{pkg}")
    try:
        capsys.readouterr()
        if pkg == "port":
            t_cli.main(argv + (["--device", "cpu"] if NEW[argv[0]] else []))
        else:
            j_cli.main(argv)
        return capsys.readouterr().out.splitlines()
    finally:
        os.chdir(here)


def test_flags_are_the_reference_s():
    jp, tp = j_cli.build_parser(), t_cli.build_parser()
    for name, device in NEW.items():
        ref, got = _flags(jp, name), _flags(tp, name)
        if device:
            assert got.pop("--device") == ("cuda", False, None), name
        assert got == ref, name


def write_photos(d, W, H, n):
    """n neighbouring views of tests/test_e2e_pixels.py's 12-view ring at
    W x H as JPEGs in d/imgs; returns (the scene, the reader flags: the
    true focal as an explicit SIMPLE_PINHOLE calibration)."""
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=12, num_points=50, image_width=W, image_height=H,
        focal=480.0 * W / 448, seed=4, ring_radius=9.0,
        point_cloud_extent=3.5, ring_height_jitter=0.3))
    imgs = t_syn.render_images(sc, device="cpu")
    os.makedirs(f"{d}/imgs")
    for i, img in list(imgs.items())[:n]:
        u8 = np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(u8).save(f"{d}/imgs/image{i:05d}.jpg", quality=95)
    return sc, ["--camera_model", "SIMPLE_PINHOLE", "--camera_params",
                f"{sc.camera.params[0]},{W / 2},{H / 2}"]


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    """Six views at 160 x 120: (directory, scene, reader flags)."""
    d = str(tmp_path_factory.mktemp("photos"))
    return (d,) + write_photos(d, 160, 120, 6)


def _db(path):
    with t_io.ColmapDatabase(path) as db:
        imgs = db.read_images()
        return (db.read_cameras(), imgs,
                {i: db.read_keypoints(i) for i in imgs},
                {i: db.read_descriptors(i) for i in imgs},
                {(a, b): m for a, b, m, *_ in
                 db.read_all_two_view_geometries()})


def test_feature_extractor(photos, capsys):
    d, _, flags = photos
    out = {}
    for pkg in ("ref", "port"):
        out[pkg] = run(pkg, ["feature_extractor", "--image_path",
                             f"{d}/imgs", "--database_path", "fe.db"]
                       + flags, capsys, d), _db(f"{d}/{pkg}/fe.db")
    (jl, (jc, ji, jk, jd, _)), (tl, (tc, ti, tk, td, _)) = \
        out["ref"], out["port"]
    assert tl == jl and tc == jc and ti == ji
    off = total = 0
    for i in ji:
        assert tk[i].shape == jk[i].shape and len(jk[i]) > 50
        far = np.abs(tk[i][:, :2] - jk[i][:, :2]).max(1) > 1e-3
        wide = np.abs(td[i].astype(int) - jd[i].astype(int)).max(1) > 1
        off += int((far | wide).sum())
        total += len(far)
    # measured: 2 of 1,935 keypoints (one 1.3e-3 px off, one whose
    # orientation atan2's last bit moved)
    assert off <= 0.01 * total, (off, total)


@pytest.mark.parametrize("cmd", ["exhaustive_matcher", "sequential_matcher",
                                 "vocab_tree_matcher", "global_matcher"])
def test_matchers(photos, cmd, capsys, monkeypatch):
    """k-means' first centroids (BoW and VLAD) replay the JAX package's
    draws; the RANSAC samples are each package's own."""
    monkeypatch.setattr(t_rt, "_draw_init", replay_key(0))
    d, _, flags = photos
    res = {}
    for pkg in ("ref", "port"):
        lines = run(pkg, [cmd, "--image_path", f"{d}/imgs",
                          "--database_path", f"{cmd}.db"] + flags, capsys, d)
        res[pkg] = lines, _db(f"{d}/{pkg}/{cmd}.db")[4]
    (jl, jg), (tl, tg) = res["ref"], res["port"]
    assert tl == jl
    assert set(tg) == set(jg) and len(jg) >= 1
    for pk in jg:
        assert abs(len(tg[pk]) - len(jg[pk])) <= 0.15 * len(jg[pk]) + 2
    # a database that holds geometries is loaded, not computed again
    assert run("port", [cmd, "--image_path", f"{d}/imgs", "--database_path",
                        f"{cmd}.db"] + flags, capsys, d) == \
        [tl[0].rsplit(":", 1)[0] + ": 0"]
