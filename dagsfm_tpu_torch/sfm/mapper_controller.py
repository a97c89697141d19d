"""Multi-model incremental mapper controller.

Port of dagsfm_tpu/sfm/mapper_controller.py (COLMAP's
IncrementalMapperController trials-and-relaxation loop):

  * initialisation trials: trial k halves the init gates
    (init_min_num_inliers, init_min_tri_angle_deg) k times, down to 6
    inliers and 0.5 degrees, and seeds its mapper with mapper.seed + k;
  * multiple models: images registered by one model are left out of the
    next, so each disconnected component gets its own model;
  * a model is kept at max(2, min_model_size) registered images or more.

`run` returns a ReconstructionManager with the models in the order they
were built. Every IncrementalMapper runs on the controller's `device`.
"""

from __future__ import annotations

import dataclasses

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.scene.reconstruction_manager import \
    ReconstructionManager
from dagsfm_tpu_torch.sfm.correspondence_graph import CorrespondenceGraph
from dagsfm_tpu_torch.sfm.incremental_mapper import (IncrementalMapper,
                                                     MapperOptions)


@dataclasses.dataclass
class ControllerOptions:
    """COLMAP incremental_mapper_controller.h's multi-model knobs."""
    mapper: MapperOptions = dataclasses.field(default_factory=MapperOptions)
    multiple_models: bool = True
    max_num_models: int = 50
    min_model_size: int = 3
    init_num_trials: int = 3


class MapperController:
    def __init__(self, cameras: dict, images: dict,
                 graph: CorrespondenceGraph,
                 options: ControllerOptions | None = None, device=None):
        self.cameras = cameras
        self.images = images
        self.graph = graph
        self.opts = options or ControllerOptions()
        self.device = devmod.resolve(device)

    def _filtered_inputs(self, used: set):
        """The images and graph without the images in `used` (keypoint
        counts and the order of the pairs kept)."""
        if not used:
            return self.images, self.graph
        images = {i: im for i, im in self.images.items() if i not in used}
        graph = CorrespondenceGraph()
        for i, im in images.items():
            graph.add_image(i, self.graph.num_keypoints.get(i, len(im.xys)))
        for (i, j), m in self.graph.pair_matches.items():
            if i in images and j in images and len(m):
                graph.add_matches(i, j, m)
        return images, graph

    def _relaxed_options(self, trial: int) -> MapperOptions:
        """Trial 0 is strict; each further trial halves the init gates."""
        o = dataclasses.replace(self.opts.mapper)
        o.init_min_num_inliers = max(
            6, o.init_min_num_inliers // (2 ** trial))
        o.init_min_tri_angle_deg = max(
            0.5, o.init_min_tri_angle_deg / (2 ** trial))
        return o

    def run(self) -> ReconstructionManager:
        mgr = ReconstructionManager()
        used: set = set()
        for _model in range(self.opts.max_num_models
                            if self.opts.multiple_models else 1):
            images, graph = self._filtered_inputs(used)
            if len(images) < 2 or not graph.pair_matches:
                break
            rec = None
            for trial in range(self.opts.init_num_trials):
                opts = self._relaxed_options(trial)
                opts.seed = self.opts.mapper.seed + trial
                cand = IncrementalMapper(self.cameras, images, graph, opts,
                                         device=self.device).reconstruct()
                if cand.num_reg_images() >= max(2, self.opts.min_model_size):
                    rec = cand
                    break
            if rec is None:
                break    # even the relaxed gates found no model
            used.update(rec.reg_image_ids)
            mgr.add(rec)
            if not self.opts.multiple_models:
                break
        return mgr
