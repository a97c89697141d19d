"""scene/image_reader.py and scene/camera_database.py of the port
against the JAX package's on the CPU: JPEGs and PNGs with EXIF written by
PIL into tmp_path, as tests/test_image_reader.py writes them. Cameras
equal field for field, images bit for bit, names equal; the EXIF focal
priors, the explicit calibration and the single-camera mode as the JAX
package gives them; without PIL both readers exit with the same
message."""
import builtins

import numpy as np
import pytest

from dagsfm_tpu.scene import camera_database as j_cdb
from dagsfm_tpu.scene import image_reader as j_ir
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.scene import camera_database as t_cdb
from dagsfm_tpu_torch.scene import cameras as t_cm
from dagsfm_tpu_torch.scene import image_reader as t_ir

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402


def write_image(path, w=64, h=48, make=None, model=None, focal_mm=None,
                focal_35mm=None, seed=0, rgb=False):
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if rgb else (h, w)
    img = Image.fromarray((rng.random(shape) * 255).astype("uint8"))
    exif = Image.Exif()
    if make:
        exif[271] = make
    if model:
        exif[272] = model
    ifd = exif.get_ifd(34665)
    if focal_mm is not None:
        ifd[37386] = focal_mm
    if focal_35mm is not None:
        ifd[41989] = focal_35mm
    img.save(path, exif=exif)


def same_reads(path, j_opts=None):
    """Both readers on one directory: images bit for bit, names, and
    cameras field for field (the same sharing of camera records)."""
    t_opts = None if j_opts is None else interop.image_reader_options(
        j_opts)
    ji, jn, jc = j_ir.read_images_with_cameras(str(path), j_opts)
    ti, tn, tc = t_ir.read_images_with_cameras(str(path), t_opts)
    assert tn == jn and list(ti) == list(ji)
    for i in ji:
        assert ti[i].dtype == ji[i].dtype == np.float32
        assert np.array_equal(ti[i], ji[i])
        assert tuple(tc[i]) == tuple(jc[i]), (tc[i], jc[i])
        assert isinstance(tc[i], t_cm.Camera)
    ids = sorted(ji)
    assert [tc[a] is tc[b] for a in ids for b in ids] == \
        [jc[a] is jc[b] for a in ids for b in ids]
    return ti, tn, tc


@pytest.fixture
def photo_dir(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    write_image(d / "a.jpg", 640, 480, "SomeMake", "SomeModel",
                focal_35mm=50, seed=1)
    write_image(d / "b.jpg", 640, 480, "Canon", "Canon EOS 5D Mark II",
                focal_mm=35.0, seed=2)
    write_image(d / "c.JPG", 96, 64, seed=3)
    write_image(d / "d.png", 80, 60, seed=4, rgb=True)
    write_image(d / "e.jpeg", 64, 48, "Apple", "iPhone 12 Pro",
                focal_mm=4.2, seed=5)
    (d / "notes.txt").write_text("not an image")
    return d


@pytest.mark.parametrize("opts", [
    None,
    j_ir.ImageReaderOptions(default_focal_length_factor=1.5),
    j_ir.ImageReaderOptions(single_camera=True),
    j_ir.ImageReaderOptions(camera_model="OPENCV"),
    j_ir.ImageReaderOptions(camera_model="FOV", single_camera=True),
    j_ir.ImageReaderOptions(camera_model="PINHOLE",
                            camera_params="100,101,32,24")])
def test_read_images_with_cameras(photo_dir, opts):
    _, names, cams = same_reads(photo_dir, opts)
    assert list(names.values()) == ["a.jpg", "b.jpg", "c.JPG", "d.png",
                                    "e.jpeg"]
    if opts is None:
        assert cams[1].prior_focal and cams[2].prior_focal
        assert cams[1].focal() == pytest.approx(50.0 / 35.0 * 640)
        assert cams[2].focal() == pytest.approx(35.0 / 35.8 * 640)
        assert not cams[3].prior_focal
        assert cams[3].focal() == pytest.approx(1.2 * 96)


def test_default_params_and_bad_params():
    for name in t_cm.CAMERA_MODEL_IDS:
        for w, h, f in ((100, 80, 120.0), (641, 479, 333.3)):
            assert t_ir.default_camera_params(name, w, h, f) == \
                j_ir.default_camera_params(name, w, h, f)
    with pytest.raises(ValueError):
        t_ir.camera_from_exif(1, 64, 48, {}, t_ir.ImageReaderOptions(
            camera_model="PINHOLE", camera_params="1,2,3"))
    for exif in ({}, None, {"make": "x", "focal_mm": 20.0},
                 {"make": "Nikon", "model": "D850", "focal_mm": 24.0},
                 {"focal_35mm": 28.0, "focal_mm": 4.0}):
        for opts in (None, j_ir.ImageReaderOptions(camera_model="RADIAL")):
            t_opts = None if opts is None else \
                interop.image_reader_options(opts)
            assert tuple(t_ir.camera_from_exif(7, 640, 480, exif, t_opts)) \
                == tuple(j_ir.camera_from_exif(7, 640, 480, exif, opts))


def test_extract_exif(tmp_path):
    write_image(tmp_path / "a.jpg", make="Sony", model="ILCE-7M3",
                focal_mm=55.0, focal_35mm=55)
    for p in (tmp_path / "a.jpg",):
        with Image.open(p) as im:
            assert t_ir.extract_exif(im) == j_ir.extract_exif(im)
    plain = Image.fromarray(np.zeros((8, 8), np.uint8))
    assert t_ir.extract_exif(plain) == j_ir.extract_exif(plain) == {}


def test_camera_database_is_the_reference_s():
    assert t_cdb._SENSOR_WIDTHS == j_cdb._SENSOR_WIDTHS
    assert t_cdb._FORMAT_WIDTHS == j_cdb._FORMAT_WIDTHS
    assert t_cdb.DEFAULT_FOCAL_FACTOR == j_cdb.DEFAULT_FOCAL_FACTOR
    queries = [("Canon", "EOS 5D Mark III"), ("APPLE", "iPhone 12 Pro"),
               ("Unknown", "Thing"), ("  DJI ", "FC6310  "),
               ("x", "APS-C body"), ("Panasonic", "DMC-GH4"),
               ("canon", "eos r5"), ("gopro", "HERO9 1/2.3")]
    for make, model in queries:
        assert t_cdb.sensor_width_mm(make, model) == \
            j_cdb.sensor_width_mm(make, model)
        for f_mm, f35 in ((50.0, None), (0.0, 35.0), (0.0, None),
                          (24.0, 0.0)):
            assert t_cdb.focal_from_exif(make, model, f_mm, 6000, 4000,
                                         focal_35mm=f35) == \
                j_cdb.focal_from_exif(make, model, f_mm, 6000, 4000,
                                      focal_35mm=f35)


def test_without_pil_both_exit_with_the_same_message(photo_dir,
                                                     monkeypatch):
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    msgs = []
    for mod in (j_ir, t_ir):
        with pytest.raises(SystemExit) as e:
            mod.read_images_with_cameras(str(photo_dir))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "requires PIL" in msgs[0]
