"""Project options: the option dataclasses composed, quality presets, and
.ini project files.

Port of dagsfm_tpu/utils/options.py (COLMAP's OptionManager: per-module
option bundles, project files written and read with configparser, the
quality presets). A project file written here is the JAX package's byte
for byte, and each package reads the other's: the sections hold the same
dataclasses with the same fields in the same order.
"""

from __future__ import annotations

import configparser
import dataclasses

from dagsfm_tpu_torch.clustering.image_clustering import ClusteringOptions
from dagsfm_tpu_torch.estimation.rotation_averaging import RAOptions
from dagsfm_tpu_torch.sfm.incremental_mapper import MapperOptions
from dagsfm_tpu_torch.sfm.track_selection import TrackSelectionOptions


@dataclasses.dataclass
class ProjectOptions:
    """The whole option tree (COLMAP's OptionManager members)."""
    image_path: str = ""
    database_path: str = ""
    output_path: str = ""
    clustering: ClusteringOptions = dataclasses.field(
        default_factory=ClusteringOptions)
    mapper: MapperOptions = dataclasses.field(default_factory=MapperOptions)
    track_selection: TrackSelectionOptions = dataclasses.field(
        default_factory=TrackSelectionOptions)
    # RAOptions is a NamedTuple; its two iteration counts live here
    ra_l1_iterations: int = 10
    ra_irls_iterations: int = 100

    def ra_options(self) -> RAOptions:
        return RAOptions(l1_iterations=self.ra_l1_iterations,
                         irls_iterations=self.ra_irls_iterations)


# quality presets (COLMAP option_manager.h ModifyFor*Quality)
_PRESETS = {
    "low": dict(max_num_features=512, num_ransac_hypotheses=128,
                ba_global_max_iterations=20),
    "medium": dict(max_num_features=1024, num_ransac_hypotheses=256,
                   ba_global_max_iterations=30),
    "high": dict(max_num_features=2048, num_ransac_hypotheses=512,
                 ba_global_max_iterations=50),
    "extreme": dict(max_num_features=4096, num_ransac_hypotheses=1024,
                    ba_global_max_iterations=75),
}


def apply_quality_preset(opts: ProjectOptions, quality: str) -> None:
    p = _PRESETS[quality]
    opts.mapper.num_ransac_hypotheses = p["num_ransac_hypotheses"]
    opts.mapper.ba_global_max_iterations = p["ba_global_max_iterations"]


def save_project(opts: ProjectOptions, path: str) -> None:
    """Write an .ini project file (COLMAP OptionManager::Write)."""
    cp = configparser.ConfigParser()
    cp["root"] = {
        "image_path": opts.image_path,
        "database_path": opts.database_path,
        "output_path": opts.output_path,
        "ra_l1_iterations": str(opts.ra_l1_iterations),
        "ra_irls_iterations": str(opts.ra_irls_iterations),
    }
    for section, dc in (("clustering", opts.clustering),
                        ("mapper", opts.mapper),
                        ("track_selection", opts.track_selection)):
        cp[section] = {f.name: str(getattr(dc, f.name))
                       for f in dataclasses.fields(dc)}
    with open(path, "w") as f:
        cp.write(f)


def load_project(path: str) -> ProjectOptions:
    """Read an .ini project file (COLMAP OptionManager::Read); a field
    the file lacks keeps its default."""
    cp = configparser.ConfigParser()
    cp.read(path)
    opts = ProjectOptions()
    root = cp["root"]
    opts.image_path = root.get("image_path", "")
    opts.database_path = root.get("database_path", "")
    opts.output_path = root.get("output_path", "")
    opts.ra_l1_iterations = int(root.get("ra_l1_iterations", "10"))
    opts.ra_irls_iterations = int(root.get("ra_irls_iterations", "100"))
    parse = {"int": int, "float": float,
             "bool": lambda raw: raw in ("True", "true", "1")}
    for section, dc in (("clustering", opts.clustering),
                        ("mapper", opts.mapper),
                        ("track_selection", opts.track_selection)):
        if section not in cp:
            continue
        for f in dataclasses.fields(dc):
            if f.name in cp[section]:
                raw = cp[section][f.name]
                setattr(dc, f.name, parse.get(f.type, str)(raw))
    return opts
