"""The port's model exporters against the JAX package on the CPU, byte for
byte: NVM (and its reader), Bundler with its image list, and the PMVS and
CMP-MVS workspace layouts, on a synthetic model (a SIMPLE_RADIAL camera,
coloured points, an unregistered image) carried across with
interop.reconstruction."""
import os

import numpy as np
import pytest
import torch

from dagsfm_tpu.scene import cameras as j_cm
from dagsfm_tpu.scene import exporters as j_ex
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.scene import exporters as t_ex

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def recs():
    spec = j_syn.SyntheticSceneSpec(num_cameras=7, num_points=80,
                                    pixel_noise=0.3, seed=5)
    rec = j_syn.to_reconstruction(j_syn.generate(spec))
    cam = rec.cameras[1]
    rec.cameras[1] = j_cm.Camera(1, j_cm.SIMPLE_RADIAL, cam.width,
                                 cam.height, tuple(cam.params) + (-0.03,))
    rng = np.random.default_rng(0)
    for pt in rec.points3D.values():
        pt.color = rng.integers(0, 256, 3).astype(np.uint8)
    rec.images[3].registered = False
    return rec, interop.reconstruction(rec.cameras, rec.images,
                                       rec.points3D)


def files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_nvm_bytes(recs, tmp_path):
    j_ex.write_nvm(recs[0], str(tmp_path / "ref.nvm"))
    t_ex.write_nvm(recs[1], str(tmp_path / "port.nvm"))
    a = (tmp_path / "ref.nvm").read_bytes()
    assert a == (tmp_path / "port.nvm").read_bytes()
    assert a.startswith(b"NVM_V3\n\n6\n")


def test_read_nvm_equals_reference(recs, tmp_path):
    p = str(tmp_path / "m.nvm")
    j_ex.write_nvm(recs[0], p)
    ref, got = j_ex.read_nvm(p), t_ex.read_nvm(p)
    assert sorted(got.images) == sorted(ref.images)
    assert got.reg_image_ids == ref.reg_image_ids
    for i, im in ref.images.items():
        g = got.images[i]
        assert (g.name, g.camera_id) == (im.name, im.camera_id)
        for a, b in ((g.qvec, im.qvec), (g.tvec, im.tvec), (g.xys, im.xys),
                     (g.point3D_ids, im.point3D_ids)):
            assert np.array_equal(a, b)
        c, rc = got.cameras[g.camera_id], ref.cameras[im.camera_id]
        assert (c.model_id, tuple(c.params)) == (rc.model_id,
                                                 tuple(rc.params))
    assert sorted(got.points3D) == sorted(ref.points3D)
    for pid, pt in ref.points3D.items():
        g = got.points3D[pid]
        assert np.array_equal(g.xyz, pt.xyz)
        assert np.array_equal(g.color, pt.color)
        assert g.track == pt.track
    # and what the port writes reads back to the same text
    t_ex.write_nvm(got, str(tmp_path / "again_port.nvm"))
    j_ex.write_nvm(ref, str(tmp_path / "again_ref.nvm"))
    assert (tmp_path / "again_port.nvm").read_bytes() == \
        (tmp_path / "again_ref.nvm").read_bytes()


@pytest.mark.parametrize("with_list", [True, False])
def test_bundler_bytes(recs, tmp_path, with_list):
    for name, mod, rec in (("ref", j_ex, recs[0]), ("port", t_ex, recs[1])):
        d = tmp_path / name
        d.mkdir()
        mod.write_bundler(rec, str(d / "bundle.out"),
                          str(d / "list.txt") if with_list else None)
    assert files(tmp_path / "ref") == files(tmp_path / "port")
    assert len(files(tmp_path / "ref")) == (2 if with_list else 1)


@pytest.mark.parametrize("kind", ["pmvs", "cmpmvs"])
def test_mvs_workspace_bytes(recs, tmp_path, kind):
    for name, mod, rec in (("ref", j_ex, recs[0]), ("port", t_ex, recs[1])):
        getattr(mod, f"write_{kind}_workspace")(rec, str(tmp_path / name))
    ref = files(tmp_path / "ref")
    assert ref == files(tmp_path / "port")
    assert len(ref) == (6 + 2 if kind == "pmvs" else 6)
