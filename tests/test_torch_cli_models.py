"""The port's model and database commands against the JAX package's on
the CPU, each pair on its own copy of one database or model built from
the same planted scene (`python -m dagsfm_tpu_torch <command>` through
`cli.main`, the reference's through its `cli.main`).

- Host-only commands: the same files byte for byte and the same printed
  lines. Two write rotations through `rotmat_to_quat`
  (`synthetic_scene`, `model_aligner`): their quaternions agree to 1
  ulp (XLA:CPU sums a quaternion's squares with fused multiply-adds)
  and the translations computed from them within a few, every other
  byte is the same.
- `bundle_adjuster`, `point_triangulator`, `rig_bundle_adjuster`: poses
  and points within rel 1e-7 (sums in other orders).
- `mapper`, `image_registrator`, `sfm_aligner`, `model_merger`, whose
  RANSAC draws differ: the same registered images, and both packages'
  pose errors under the planted limits (ATE < 0.05, mean rotation error
  < 0.2 degrees).
The flags of every command are the reference's, plus `--device` where
the command computes on a device."""
import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch

from chip_smoke import rig_config, rig_scene
from dagsfm_tpu.pipeline import cli as j_cli
from dagsfm_tpu_torch.ops import rotations as t_rops
from dagsfm_tpu_torch.pipeline import cli as t_cli
from dagsfm_tpu_torch.scene import io as t_io
from dagsfm_tpu_torch.scene import synthetic as t_syn

torch.set_num_threads(1)

NEW = {  # command -> computes on a device (takes --device)
    "mapper": True, "sfm_aligner": True, "bundle_adjuster": True,
    "point_triangulator": True, "image_registrator": True,
    "model_merger": True, "rig_bundle_adjuster": True,
    "database_creator": False, "matches_importer": False,
    "database_merger": False, "feature_importer": False,
    "model_analyzer": False, "model_aligner": False,
    "point_filtering": False, "image_deleter": False,
    "image_filterer": False, "synthetic_scene": False,
    "project_generator": False}


def run(pkg: str, argv: list, capsys) -> list:
    """One command of one package; its printed lines."""
    capsys.readouterr()
    if pkg == "port":
        if NEW[argv[0]]:
            argv = argv + ["--device", "cpu"]
        t_cli.main(argv)
    else:
        j_cli.main(argv)
    return capsys.readouterr().out.splitlines()


def _flags(parser, name):
    sub = next(a for a in parser._actions if a.dest == "command")
    return {a.option_strings[0]: (a.default, a.required, a.type)
            for a in sub.choices[name]._actions if a.option_strings
            and a.dest != "help"}


def test_flags_are_the_reference_s():
    jp, tp = j_cli.build_parser(), t_cli.build_parser()
    for name, device in NEW.items():
        ref, got = _flags(jp, name), _flags(tp, name)
        if device:
            assert got.pop("--device") == ("cuda", False, None), name
        assert got == ref, name


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A planted scene of 12 ring cameras: its ground-truth model (.bin)
    and a database of its keypoints, random descriptors and its true
    correspondences as verified two-view geometries."""
    d = str(tmp_path_factory.mktemp("cli"))
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=12, num_points=400, pixel_noise=0.3, seed=21))
    t_io.write_model_bin(t_syn.to_reconstruction(sc), d + "/model")
    cams, images, graph = t_syn.to_matching_problem(sc)
    rng = np.random.default_rng(0)
    with t_io.ColmapDatabase(d + "/database.db") as db:
        for c in cams.values():
            db.add_camera(c)
        for i, im in sorted(images.items()):
            db.add_image(im.name, im.camera_id, image_id=i)
            db.add_keypoints(i, im.xys.astype(np.float32))
            db.add_descriptors(i, rng.integers(0, 256, (len(im.xys), 128),
                                               dtype=np.uint8))
        for (i, j), m in sorted(graph.pair_matches.items()):
            db.add_matches(i, j, m)
            db.add_two_view_geometry(i, j, m, config=2)
    return d, sc


def _copy(src: str, dst: str) -> str:
    (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, dst)
    return dst


def _read_images_bin(path: str) -> list:
    """images.bin as (id, qvec and tvec, rest of the record's bytes)."""
    out = []
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            iid = struct.unpack("<I", f.read(4))[0]
            q = np.frombuffer(f.read(56), np.float64)
            rest = f.read(4)
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            n2d = struct.unpack("<Q", f.read(8))[0]
            rest += name + f.read(24 * n2d)
            out.append((iid, q, rest))
    return out


def _same_files(a: str, b: str, quat_ulp: bool = False) -> None:
    if os.path.isfile(a):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read(), a
        return
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        if quat_ulp and name == "images.bin":
            for (i, q, r), (j, p, s) in zip(_read_images_bin(
                    os.path.join(a, name)), _read_images_bin(
                    os.path.join(b, name))):
                assert (i, r) == (j, s)
                # the quaternion within 1 ulp, tvec = -R C within a few
                assert np.abs(q[:4] - p[:4]).max() <= np.spacing(1.0)
                assert np.abs(q[4:] - p[4:]).max() <= \
                    8 * np.spacing(np.abs(p[4:]).max())
        else:
            _same_files(os.path.join(a, name), os.path.join(b, name))


def _feature_files(d: str) -> str:
    """Two images' features in COLMAP's text format: one new image and
    one the database already holds."""
    rng = np.random.default_rng(3)
    os.makedirs(d, exist_ok=True)
    for name, n in (("fresh.jpg", 6), ("image00002.jpg", 4)):
        rows = np.concatenate([rng.uniform(0, 500, (n, 4)),
                               rng.integers(0, 40, (n, 128))], 1)
        np.savetxt(os.path.join(d, name + ".txt"), rows, header=f"{n} 128",
                   comments="")
    return d


def _host_case(name: str, d: str, out: str) -> tuple:
    """(argv, the output compared, quaternions to 1 ulp) for a host-only
    command writing under `out` from inputs copied from world `d`."""
    model = _copy(d + "/model", out + "/in")
    if name == "model_analyzer":
        return ["model_analyzer", "--input_path", model], None, False
    if name == "point_filtering":
        return ["point_filtering", "--input_path", model, "--output_path",
                out + "/o", "--min_track_len", "5"], out + "/o", False
    if name == "image_deleter":
        with open(out + "/ids.txt", "w") as f:
            f.write("3\n\n4\n99\n3\n")
        with open(out + "/names.txt", "w") as f:
            f.write("image00007.jpg\nnot_there.jpg\n")
        return ["image_deleter", "--input_path", model, "--output_path",
                out + "/o", "--image_ids_path", out + "/ids.txt",
                "--image_names_path", out + "/names.txt"], out + "/o", False
    if name == "image_filterer":
        return ["image_filterer", "--input_path", model, "--output_path",
                out + "/o", "--min_num_observations", "190"], out + "/o", \
            False
    if name == "model_aligner":
        rec = t_io.read_model_bin(model)
        rng = np.random.default_rng(1)
        with open(out + "/refs.txt", "w") as f:
            for i in rec.reg_image_ids[:9]:
                im = rec.images[i]
                c = 2.0 * (-t_rops.quat_to_rotmat_np(im.qvec).T @ im.tvec) \
                    + [1.0, -2.0, 0.5] + rng.normal(0, 0.01, 3)
                f.write(f"{im.name} {float(c[0])!r} {float(c[1])!r} "
                        f"{float(c[2])!r}\n")
        return ["model_aligner", "--input_path", model, "--ref_images_path",
                out + "/refs.txt", "--output_path", out + "/o"], \
            out + "/o", True
    if name == "synthetic_scene":
        return ["synthetic_scene", "--output_path", out + "/o",
                "--num_cameras", "9", "--num_points", "150", "--seed", "4"], \
            out + "/o", True
    if name == "project_generator":
        return ["project_generator", "--output_path", out + "/p.ini",
                "--quality", "MEDIUM"], out + "/p.ini", False
    if name == "database_creator":
        return ["database_creator", "--database_path", out + "/new.db"], \
            out + "/new.db", False
    db = _copy(d + "/database.db", out + "/database.db")
    if name == "matches_importer":
        with open(out + "/m.txt", "w") as f:
            f.write("image00001.jpg image00005.jpg\n0 1\n2 3\n\n"
                    "image00002.jpg image00009.jpg\n4 4\nbad\n7 2\n")
        return ["matches_importer", "--database_path", db,
                "--match_list_path", out + "/m.txt"], db, False
    if name == "database_merger":
        return ["database_merger", "--database_path1", db,
                "--database_path2", db, "--merged_database_path",
                out + "/merged.db"], out + "/merged.db", False
    assert name == "feature_importer"
    return ["feature_importer", "--database_path", db, "--import_path",
            _feature_files(out + "/feats")], db, False


@pytest.mark.parametrize("name", [n for n, dev in NEW.items() if not dev])
def test_host_command_writes_the_reference_s_files(name, world, tmp_path,
                                                   capsys):
    d, _ = world
    lines, outs = {}, {}
    for pkg in ("port", "reference"):
        os.makedirs(tmp_path / pkg)
        argv, outs[pkg], ulp = _host_case(name, d, str(tmp_path / pkg))
        lines[pkg] = run(pkg, argv, capsys)
    strip = (lambda ls: [ln.replace(str(tmp_path / "port"), "*").replace(
        str(tmp_path / "reference"), "*") for ln in ls])
    assert strip(lines["port"]) == strip(lines["reference"])
    assert lines["port"]
    if outs["port"] is not None:
        _same_files(outs["port"], outs["reference"], quat_ulp=ulp)


def test_project_files_read_across_packages(tmp_path):
    from dagsfm_tpu.utils import options as j_opt
    from dagsfm_tpu_torch import interop
    from dagsfm_tpu_torch.utils import options as t_opt
    jo = j_opt.ProjectOptions(image_path="imgs", database_path="d.db")
    j_opt.apply_quality_preset(jo, "extreme")
    jo.mapper.init_min_tri_angle_deg = 2.5
    jo.clustering.cluster_type = "NCUT"
    jo.track_selection.long_track_length_threshold = 7
    j_opt.save_project(jo, str(tmp_path / "j.ini"))
    to = t_opt.load_project(str(tmp_path / "j.ini"))
    assert to == interop.project_options(jo)
    assert to.ra_options() == interop.project_options(jo).ra_options()
    t_opt.save_project(to, str(tmp_path / "t.ini"))
    assert (tmp_path / "t.ini").read_bytes() == \
        (tmp_path / "j.ini").read_bytes()
    assert j_opt.load_project(str(tmp_path / "t.ini")) == jo


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _close_models(a, b, rtol: float) -> None:
    assert sorted(a.reg_image_ids) == sorted(b.reg_image_ids)
    for i in b.reg_image_ids:
        assert _rel(a.images[i].qvec, b.images[i].qvec) <= rtol
        assert _rel(a.images[i].tvec, b.images[i].tvec) <= rtol
    assert sorted(a.points3D) == sorted(b.points3D)
    X = np.stack([a.points3D[k].xyz for k in sorted(a.points3D)])
    Y = np.stack([b.points3D[k].xyz for k in sorted(b.points3D)])
    assert _rel(X, Y) <= rtol
    assert all(a.points3D[k].track == b.points3D[k].track for k in a.points3D)


def _both(argv_of, tmp_path, capsys) -> dict:
    """Run `argv_of(out_dir)` in both packages: {pkg: (lines with the
    output directory written as *, out_dir)}."""
    out = {}
    for pkg in ("port", "reference"):
        o = str(tmp_path / pkg)
        out[pkg] = ([ln.replace(o, "*") for ln in
                     run(pkg, argv_of(o), capsys)], o)
    return out


def test_bundle_adjuster_against_reference(world, tmp_path, capsys):
    d, sc = world
    res = _both(lambda o: ["bundle_adjuster", "--input_path", d + "/model",
                           "--output_path", o, "--max_num_iterations", "8"],
                tmp_path, capsys)
    assert res["port"][0] == res["reference"][0]
    _close_models(t_io.read_model_bin(res["port"][1]),
                  t_io.read_model_bin(res["reference"][1]), 1e-7)


def test_point_triangulator_against_reference(world, tmp_path, capsys):
    d, _ = world
    rec = t_io.read_model_bin(d + "/model")
    for pid in list(rec.points3D):
        rec.delete_point3D(pid)
    t_io.write_model_bin(rec, str(tmp_path / "stripped"))
    res = _both(lambda o: ["point_triangulator", "--database_path",
                           d + "/database.db", "--input_path",
                           str(tmp_path / "stripped"), "--output_path", o],
                tmp_path, capsys)
    assert res["port"][0][-1].split(" -> ")[0] == \
        res["reference"][0][-1].split(" -> ")[0]
    a = t_io.read_model_bin(res["port"][1])
    _close_models(a, t_io.read_model_bin(res["reference"][1]), 1e-7)
    assert a.num_points3D() > 300


def _pose_ok(rec, sc, n: int) -> None:
    err = t_syn.pose_errors(rec, sc)
    assert err["num_reg"] == n and err["ate"] < 0.05 \
        and err["rot_err_deg_mean"] < 0.2, err


def test_mapper_against_reference(world, tmp_path, capsys):
    d, sc = world
    res = _both(lambda o: ["mapper", "--database_path", d + "/database.db",
                           "--output_path", o], tmp_path, capsys)
    assert res["port"][0] == res["reference"][0]
    a, b = (t_io.read_model_bin(res[p][1] + "/0") for p in res)
    assert sorted(a.reg_image_ids) == sorted(b.reg_image_ids)
    _pose_ok(a, sc, 12)
    _pose_ok(b, sc, 12)


def _drop(d: str, ids, out: str) -> str:
    rec = t_io.read_model_bin(d + "/model")
    for i in ids:
        rec.deregister_image(i)
    t_io.write_model_bin(rec, out)
    return out


def test_image_registrator_against_reference(world, tmp_path, capsys):
    d, sc = world
    part = _drop(d, (10, 11, 12), str(tmp_path / "part"))
    res = _both(lambda o: ["image_registrator", "--database_path",
                           d + "/database.db", "--input_path", part,
                           "--output_path", o], tmp_path, capsys)
    assert res["port"][0] == res["reference"][0] == \
        ["registered 3 new images (12 total)"]
    a, b = (t_io.read_model_bin(res[p][1]) for p in res)
    assert sorted(a.reg_image_ids) == sorted(b.reg_image_ids)
    _pose_ok(a, sc, 12)
    _pose_ok(b, sc, 12)


@pytest.mark.parametrize("name", ["sfm_aligner", "model_merger"])
def test_merges_against_reference(name, world, tmp_path, capsys):
    d, sc = world
    os.makedirs(tmp_path / "parts")
    a = _drop(d, (10, 11, 12), str(tmp_path / "parts" / "a"))
    b = _drop(d, (1, 2, 3), str(tmp_path / "parts" / "b"))
    argv = (["sfm_aligner", "--input_path", str(tmp_path / "parts")]
            if name == "sfm_aligner" else
            ["model_merger", "--input_path1", a, "--input_path2", b])
    res = _both(lambda o: argv + ["--output_path", o], tmp_path, capsys)
    assert res["port"][0] == res["reference"][0]
    x, y = (t_io.read_model_bin(res[p][1]) for p in res)
    assert sorted(x.reg_image_ids) == sorted(y.reg_image_ids)
    _pose_ok(x, sc, 12)
    _pose_ok(y, sc, 12)


def test_rig_bundle_adjuster_against_reference(tmp_path, capsys):
    rec, _ = rig_scene(10, 150, seed=4)
    t_io.write_model_bin(rec, str(tmp_path / "rig_model"))
    (tmp_path / "rig.json").write_text(json.dumps(rig_config()))
    res = _both(lambda o: ["rig_bundle_adjuster", "--input_path",
                           str(tmp_path / "rig_model"), "--output_path", o,
                           "--rig_config_path", str(tmp_path / "rig.json"),
                           "--max_num_iterations", "12"], tmp_path, capsys)
    assert res["port"][0][0] == res["reference"][0][0] == \
        "Camera Rig 1: 4 cameras, 10 snapshots"
    costs = [[float(x) for x in res[p][0][-1].split("cost")[1].split("->")]
             for p in res]
    np.testing.assert_allclose(costs[0], costs[1], rtol=1e-6)
    _close_models(t_io.read_model_bin(res["port"][1]),
                  t_io.read_model_bin(res["reference"][1]), 1e-7)
