"""Image ingestion with EXIF-driven intrinsics priors.

Port of dagsfm_tpu/scene/image_reader.py (COLMAP's ImageReader): the
default camera model is SIMPLE_RADIAL; the focal length comes from EXIF
(FocalLengthIn35mmFilm, else FocalLength over the sensor width of
`camera_database`) and marks the camera's focal as a prior, else it is
default_focal_length_factor * max(width, height) with no prior.
`single_camera` shares one camera record across all images;
`camera_params` pins an explicit calibration (a prior focal).

Reading is host work. Images are decoded by PIL, imported when the
first image is read; without PIL the reader exits with the JAX
package's message, and there is no other decoder. Grayscale is
`np.asarray(im.convert("L"), np.float32) / 255.0`, so both packages see
the same pixels.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from dagsfm_tpu_torch.scene import cameras as cm
from dagsfm_tpu_torch.scene.camera_database import (DEFAULT_FOCAL_FACTOR,
                                                    focal_from_exif)

# EXIF tag ids (TIFF/EXIF standard)
_TAG_MAKE = 271
_TAG_MODEL = 272
_TAG_FOCAL_LENGTH = 37386
_TAG_FOCAL_35MM = 41989
_EXIF_IFD = 34665

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}


@dataclass
class ImageReaderOptions:
    """COLMAP's ImageReaderOptions."""
    camera_model: str = "SIMPLE_RADIAL"
    single_camera: bool = False
    camera_params: str = ""          # comma-separated explicit calibration
    default_focal_length_factor: float = DEFAULT_FOCAL_FACTOR


def default_camera_params(model: str, width: int, height: int,
                          focal: float) -> tuple:
    """Initial parameters for any of the 11 camera models: the focal
    slot(s), the principal point at the centre, zero distortion (FOV's
    omega 1e-2: omega = 0 divides by zero)."""
    model_id = cm.CAMERA_MODEL_IDS[model]
    n = cm.CAMERA_MODEL_NUM_PARAMS[model_id]
    cx, cy = width / 2.0, height / 2.0
    if model_id in cm._SINGLE_FOCAL or model_id == cm.SIMPLE_PINHOLE:
        base = [focal, cx, cy]
    else:
        base = [focal, focal, cx, cy]
    extra = [0.0] * (n - len(base))
    if model == "FOV" and extra:
        extra[0] = 1e-2
    return tuple(base + extra)


def extract_exif(pil_image) -> dict:
    """make, model, focal_mm and focal_35mm of a PIL image, where present
    (an empty dict without EXIF)."""
    out = {}
    try:
        exif = pil_image.getexif()
    except Exception:  # noqa: BLE001 — EXIF parsing must never kill ingestion
        return out
    if not exif:
        return out
    out["make"] = str(exif.get(_TAG_MAKE, "") or "")
    out["model"] = str(exif.get(_TAG_MODEL, "") or "")
    # FocalLength and FocalLengthIn35mmFilm live in the Exif sub-IFD
    try:
        sub = exif.get_ifd(_EXIF_IFD)
    except Exception:  # noqa: BLE001
        sub = {}
    for tag, key in ((_TAG_FOCAL_LENGTH, "focal_mm"),
                     (_TAG_FOCAL_35MM, "focal_35mm")):
        v = sub.get(tag, exif.get(tag))
        if v is not None:
            try:
                out[key] = float(v)
            except (TypeError, ValueError, ZeroDivisionError):
                pass
    return out


def camera_from_exif(camera_id: int, width: int, height: int,
                     exif: dict | None,
                     options: ImageReaderOptions | None = None) -> cm.Camera:
    """A Camera as COLMAP's ImageReader builds it, in this order:
    options.camera_params (prior focal), the EXIF focal (prior focal),
    default_focal_length_factor * max(width, height) (no prior)."""
    opts = options or ImageReaderOptions()
    model_id = cm.CAMERA_MODEL_IDS[opts.camera_model]
    if opts.camera_params:
        params = tuple(float(x) for x in opts.camera_params.split(","))
        n = cm.CAMERA_MODEL_NUM_PARAMS[model_id]
        if len(params) != n:
            raise ValueError(
                f"camera_params has {len(params)} values; "
                f"{opts.camera_model} needs {n}")
        return cm.Camera(camera_id, model_id, width, height, params,
                         prior_focal=True)
    exif = exif or {}
    focal, has_prior = focal_from_exif(
        exif.get("make", ""), exif.get("model", ""),
        exif.get("focal_mm", 0.0), width, height,
        focal_35mm=exif.get("focal_35mm"))
    if not has_prior:
        focal = opts.default_focal_length_factor * max(width, height)
    params = default_camera_params(opts.camera_model, width, height, focal)
    return cm.Camera(camera_id, model_id, width, height, params,
                     prior_focal=has_prior)


def image_files(image_path: str) -> list:
    """The directory's image files by name, sorted."""
    return sorted(f for f in os.listdir(image_path)
                  if os.path.splitext(f.lower())[1] in IMAGE_EXTENSIONS)


def read_images_with_cameras(image_path: str,
                             options: ImageReaderOptions | None = None):
    """A directory of images -> (images, names, cameras), each keyed by
    image id (1, 2, ... in file-name order): float32 grayscale arrays in
    [0, 1], file names, Cameras with their EXIF priors. With
    single_camera every image shares camera 1, built from the first."""
    try:
        from PIL import Image
    except ImportError as e:
        raise SystemExit("image loading requires PIL; for synthetic "
                         "pipelines use `synthetic_scene`") from e
    opts = options or ImageReaderOptions()
    images, names, cams = {}, {}, {}
    shared_cam = None
    for k, f in enumerate(image_files(image_path)):
        img_id = k + 1
        with Image.open(os.path.join(image_path, f)) as im:
            exif = extract_exif(im)
            arr = np.asarray(im.convert("L"), np.float32) / 255.0
        images[img_id] = arr
        names[img_id] = f
        h, w = arr.shape
        if opts.single_camera:
            if shared_cam is None:
                shared_cam = camera_from_exif(1, w, h, exif, opts)
            cams[img_id] = shared_cam
        else:
            cams[img_id] = camera_from_exif(img_id, w, h, exif, opts)
    return images, names, cams
