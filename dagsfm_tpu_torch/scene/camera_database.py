"""Camera make/model -> sensor width, for focal-length priors from EXIF.

Port of dagsfm_tpu/scene/camera_database.py (COLMAP's
base/camera_database: EXIF make and model looked up in a table of sensor
widths to turn a focal length in mm into pixels). Pure Python, copied:
the same table, the same normalisation and the same fallback to the
default prior 1.2 * max(width, height) when a camera is unknown.
"""

from __future__ import annotations

import re

# sensor widths in mm, keyed by normalized "make model" substrings
_SENSOR_WIDTHS = {
    "canon eos 5d": 35.8, "canon eos 6d": 35.8, "canon eos r": 36.0,
    "canon eos 70d": 22.5, "canon eos 80d": 22.3, "canon eos 7d": 22.3,
    "nikon d850": 35.9, "nikon d750": 35.9, "nikon d90": 23.6,
    "nikon d3200": 23.2, "nikon d5100": 23.6,
    "sony ilce-7": 35.8, "sony ilce-6000": 23.5, "sony dsc-rx100": 13.2,
    "fujifilm x-t": 23.6, "olympus e-m": 17.3, "panasonic dmc-g": 17.3,
    "apple iphone 6": 4.89, "apple iphone 7": 4.89,
    "apple iphone 8": 4.89, "apple iphone x": 5.67,
    "apple iphone 11": 5.67, "apple iphone 12": 5.78,
    "apple iphone 13": 7.01, "apple iphone 14": 7.57,
    "samsung sm-g": 6.4, "google pixel": 6.17,
    "dji fc300": 6.17, "dji fc330": 6.17, "dji fc6310": 13.2,
    "dji fc220": 6.17, "gopro hero": 6.17,
}

# generic format fallbacks by keyword
_FORMAT_WIDTHS = [
    ("full frame", 36.0), ("aps-c", 23.6), ("four thirds", 17.3),
    ("1-inch", 13.2), ("1/2.3", 6.17), ("1/3", 4.8),
]

DEFAULT_FOCAL_FACTOR = 1.2    # default prior = 1.2 * max dim


def _normalize(s: str) -> str:
    s = s.lower().strip()
    s = re.sub(r"\s+", " ", s)
    return s


def sensor_width_mm(make: str, model: str) -> float | None:
    """The sensor width in mm, None if unknown: the longest table key
    found in "make model", else a format keyword."""
    key = _normalize(f"{make} {model}")
    for k in sorted(_SENSOR_WIDTHS, key=len, reverse=True):
        if k in key:
            return _SENSOR_WIDTHS[k]
    for kw, wmm in _FORMAT_WIDTHS:
        if kw in key:
            return wmm
    return None


def focal_from_exif(make: str, model: str, focal_mm: float,
                    image_width: int, image_height: int,
                    focal_35mm: float | None = None) -> tuple:
    """EXIF -> (focal_pixels, has_prior): FocalLengthIn35mmFilm if given,
    else focal_mm over the table's sensor width, else the default factor
    (no prior)."""
    max_dim = max(image_width, image_height)
    if focal_35mm and focal_35mm > 0:
        return focal_35mm / 35.0 * max_dim, True
    if focal_mm and focal_mm > 0:
        w = sensor_width_mm(make, model)
        if w:
            return focal_mm / w * image_width, True
    return DEFAULT_FOCAL_FACTOR * max_dim, False
