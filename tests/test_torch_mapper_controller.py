"""The port's MapperController, ReconstructionManager and model snapshots
against the JAX package on the CPU.

tests/test_mapper_controller.py's four scenarios run through both
packages (one component, two disconnected components, a poisoned initial
pair, the manager's write / read layout). RANSAC draws differ between
the packages (jax.random against a torch.Generator), so the end results
are compared: the same number of models, the same registered images per
model, each within that file's limits. The controller's trial options
and filtered inputs, and the snapshot directories written for one
sequence of registration counts, are compared exactly."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu.scene.reconstruction_manager import \
    ReconstructionManager as JManager
from dagsfm_tpu.sfm import correspondence_graph as j_cg
from dagsfm_tpu.sfm import incremental_mapper as j_im
from dagsfm_tpu.sfm import mapper_controller as j_mc
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.scene import io as t_io
from dagsfm_tpu_torch.scene import synthetic as t_syn
from dagsfm_tpu_torch.scene.reconstruction import Reconstruction
from dagsfm_tpu_torch.scene.reconstruction_manager import \
    ReconstructionManager as TManager
from dagsfm_tpu_torch.sfm import correspondence_graph as t_cg
from dagsfm_tpu_torch.sfm import incremental_mapper as t_im
from dagsfm_tpu_torch.sfm import mapper_controller as t_mc

torch.set_num_threads(1)


def _scene(syn, seed, num_cameras=8, num_points=250):
    sc = syn.generate(syn.SyntheticSceneSpec(
        num_cameras=num_cameras, num_points=num_points, pixel_noise=0.3,
        seed=seed))
    return sc, syn.to_matching_problem(sc)


def _two_components(syn, cg):
    """test_mapper_controller.py's two disjoint 6-camera scenes, the
    second's image ids offset by 100."""
    sc1, (cams, images1, graph1) = _scene(syn, 2, num_cameras=6)
    sc2, (_, images2, graph2) = _scene(syn, 3, num_cameras=6)
    images = dict(images1)
    graph = cg.CorrespondenceGraph()
    for i, im in images1.items():
        graph.add_image(i, len(im.xys))
    for i, im in images2.items():
        images[i + 100] = dataclasses.replace(im, image_id=i + 100)
        graph.add_image(i + 100, len(im.xys))
    for (i, j), m in graph1.pair_matches.items():
        graph.add_matches(i, j, m)
    for (i, j), m in graph2.pair_matches.items():
        graph.add_matches(i + 100, j + 100, m)
    return (sc1, sc2), (cams, images, graph)


SCENARIOS = {
    # name: (function making the problem, controller options as keywords)
    "single_component": (lambda syn, cg: _scene(syn, 1), {}),
    "two_components": (_two_components, {"min_model_size": 3}),
    "poisoned_init_pair": (
        lambda syn, cg: _scene(syn, 4),
        {"mapper": {"init_min_num_inliers": 100000,
                    "init_min_tri_angle_deg": 89.0},
         "init_num_trials": 16}),
    "manager_layout": (lambda syn, cg: _scene(syn, 5, num_cameras=6), {}),
}


def _options(mod, kw):
    kw = dict(kw)
    if "mapper" in kw:
        kw["mapper"] = mod.MapperOptions(**kw["mapper"])
    return kw


def _check_poses(rec, sc, off=0):
    """test_mapper_controller.py's limit (ATE < 0.05) on one model, its
    image ids shifted back by `off` to index the scene."""
    shifted = Reconstruction()
    shifted.images = {i - off: im for i, im in rec.images.items()}
    err = t_syn.pose_errors(shifted, sc)
    assert err["ate"] < 0.05, err


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenarios_give_the_same_models(name, tmp_path):
    build, kw = SCENARIOS[name]
    sc, (jc, ji, jg) = build(j_syn, j_cg)
    _, (tc, ti, tg) = build(t_syn, t_cg)
    jopts = j_mc.ControllerOptions(**_options(j_im, kw))
    topts = t_mc.ControllerOptions(**_options(t_im, kw))
    assert interop.controller_options(dataclasses.asdict(jopts)) == topts
    jmgr = j_mc.MapperController(jc, ji, jg, jopts).run()
    tmgr = t_mc.MapperController(tc, ti, tg, topts, device="cpu").run()
    assert len(tmgr) == len(jmgr) >= 1
    for jrec, trec in zip(jmgr, tmgr):
        assert sorted(trec.reg_image_ids) == sorted(jrec.reg_image_ids)
    if name == "two_components":
        assert sorted(r.num_reg_images() for r in tmgr) == [6, 6]
        for rec in tmgr:
            off = 100 if min(rec.reg_image_ids) > 100 else 0
            _check_poses(rec, sc[off // 100], off)
    else:
        assert tmgr.get(0).num_reg_images() >= 6
        _check_poses(tmgr.get(0), sc)
    if name == "single_component":
        assert tmgr.get(0).num_reg_images() == 8
    if name == "manager_layout":
        for binary in (True, False):
            out = str(tmp_path / f"sparse_{binary}")
            tmgr.write(out, binary=binary)
            assert os.path.isdir(os.path.join(out, "0"))
            back = TManager.read(out)
            jback = JManager.read(out)
            assert len(back) == len(jback) == len(tmgr)
            for a, b, c in zip(back, jback, tmgr):
                assert a.num_reg_images() == b.num_reg_images() \
                    == c.num_reg_images()
                assert a.num_points3D() == b.num_points3D() \
                    == c.num_points3D()
            assert back.largest().num_points3D() == \
                tmgr.largest().num_points3D()
        # the reference's manager, carried over, writes the same bytes
        jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
        jmgr.write(jout)
        interop.reconstruction_manager(jmgr).write(tout)
        for f in ("cameras.bin", "images.bin", "points3D.bin"):
            with open(os.path.join(jout, "0", f), "rb") as a, \
                    open(os.path.join(tout, "0", f), "rb") as b:
                assert a.read() == b.read()


def test_relaxed_options_and_filtered_inputs_are_the_reference_s():
    _, (jc, ji, jg) = _two_components(j_syn, j_cg)
    _, (tc, ti, tg) = _two_components(t_syn, t_cg)
    jopts = j_mc.ControllerOptions(mapper=j_im.MapperOptions(
        init_min_num_inliers=100, init_min_tri_angle_deg=16.0, seed=7))
    topts = interop.controller_options(dataclasses.asdict(jopts))
    jctrl = j_mc.MapperController(jc, ji, jg, jopts)
    tctrl = t_mc.MapperController(tc, ti, tg, topts, device="cpu")
    for trial in range(4):
        jo, to = jctrl._relaxed_options(trial), tctrl._relaxed_options(trial)
        assert interop.controller_options(
            {"mapper": dataclasses.asdict(jo)}).mapper == to
    assert [tctrl._relaxed_options(k).init_min_num_inliers
            for k in range(4)] == [100, 50, 25, 12]
    for used in (set(), {1, 2, 3}, {101, 102}, set(range(1, 7))):
        jimg, jgr = jctrl._filtered_inputs(used)
        timg, tgr = tctrl._filtered_inputs(used)
        assert list(timg) == list(jimg)
        assert tgr.num_keypoints == jgr.num_keypoints
        assert list(tgr.pair_matches) == list(jgr.pair_matches)
        for k, m in jgr.pair_matches.items():
            np.testing.assert_array_equal(tgr.pair_matches[k], m)


def test_snapshots_are_named_as_the_reference_names_them(tmp_path):
    """_maybe_snapshot through one sequence of registration counts: the
    counter starts at the count after initialisation, a snapshot is due
    every snapshot_images_freq images, directories snapshot_{n:06d}."""
    names = {}
    for pkg, syn, im_mod, kw in (("j", j_syn, j_im, {}),
                                 ("t", t_syn, t_im, {"device": "cpu"})):
        _, (cams, images, graph) = _scene(syn, 1, num_cameras=14,
                                          num_points=120)
        path = str(tmp_path / pkg)
        mapper = im_mod.IncrementalMapper(
            cams, images, graph, im_mod.MapperOptions(
                snapshot_path=path, snapshot_images_freq=3), **kw)
        ids = sorted(images)
        for i in ids[:2]:
            mapper.rec.register_image(i)
        mapper._last_snapshot_at = mapper.rec.num_reg_images()
        for step in (1, 1, 2, 1, 3, 1, 1, 1):
            for i in ids[mapper.rec.num_reg_images():
                         mapper.rec.num_reg_images() + step]:
                mapper.rec.register_image(i)
            mapper._maybe_snapshot()
        names[pkg] = sorted(os.listdir(path))
    assert names["t"] == names["j"] == [
        "snapshot_000006", "snapshot_000010", "snapshot_000013"]
    back = t_io.read_model_bin(str(tmp_path / "t" / "snapshot_000010"))
    assert back.num_reg_images() == 10


def test_mapping_writes_snapshots(tmp_path):
    """The port's mapper writes snapshots on its own: at least one, each
    reading back with as many registered images as its name says."""
    _, (cams, images, graph) = _scene(t_syn, 1)
    opts = t_mc.ControllerOptions(mapper=t_im.MapperOptions(
        snapshot_path=str(tmp_path), snapshot_images_freq=2))
    mgr = t_mc.MapperController(cams, images, graph, opts, device="cpu").run()
    snaps = sorted(os.listdir(tmp_path))
    assert mgr.get(0).num_reg_images() == 8 and snaps
    for s in snaps:
        n = int(s.split("_")[1])
        assert t_io.read_model_bin(str(tmp_path / s)).num_reg_images() == n
