"""ReconstructionManager: an ordered collection of models.

Port of dagsfm_tpu/scene/reconstruction_manager.py (COLMAP
base/reconstruction_manager): the models of one mapper run, written and
read under COLMAP's `0/`, `1/`, ... directory layout.
"""

from __future__ import annotations

import os

from dagsfm_tpu_torch.scene import io as scene_io
from dagsfm_tpu_torch.scene.reconstruction import Reconstruction


class ReconstructionManager:
    def __init__(self):
        self._recons: list[Reconstruction] = []

    def __len__(self) -> int:
        return len(self._recons)

    def __iter__(self):
        return iter(self._recons)

    def get(self, idx: int) -> Reconstruction:
        return self._recons[idx]

    def add(self, rec: Reconstruction) -> int:
        """Append a reconstruction; returns its index."""
        self._recons.append(rec)
        return len(self._recons) - 1

    def largest(self) -> Reconstruction | None:
        """The model with the most registered images (the first of a
        tie)."""
        if not self._recons:
            return None
        return max(self._recons, key=lambda r: r.num_reg_images())

    def write(self, path: str, binary: bool = True) -> None:
        """Every model under path/0, path/1, ... as .bin (or .txt)."""
        os.makedirs(path, exist_ok=True)
        for k, rec in enumerate(self._recons):
            sub = os.path.join(path, str(k))
            os.makedirs(sub, exist_ok=True)
            if binary:
                scene_io.write_model_bin(rec, sub)
            else:
                scene_io.write_model_text(rec, sub)

    @classmethod
    def read(cls, path: str) -> "ReconstructionManager":
        """Every model from path/0, path/1, ...: .bin, or .txt where a
        .bin file is missing."""
        mgr = cls()
        k = 0
        while os.path.isdir(sub := os.path.join(path, str(k))):
            try:
                mgr.add(scene_io.read_model_bin(sub))
            except FileNotFoundError:
                mgr.add(scene_io.read_model_text(sub))
            k += 1
        return mgr
