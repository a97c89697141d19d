"""Track selection for the final global bundle adjustment.

Port of dagsfm_tpu/sfm/track_selection.py, host code copied as it is:
rank tracks by (truncated length, mean reprojection error), take every
track that covers a new cell of an image's pixel grid, then top up the
images below the per-view minimum.
"""

from __future__ import annotations

import dataclasses

from dagsfm_tpu_torch.scene.reconstruction import Reconstruction


@dataclasses.dataclass
class TrackSelectionOptions:
    long_track_length_threshold: int = 10   # ref :125 (truncation cap)
    image_grid_cell_size_pixels: int = 100  # ref :129
    min_num_optimized_tracks_per_view: int = 200  # ref :133


def select_tracks(rec: Reconstruction,
                  opts: TrackSelectionOptions = TrackSelectionOptions()
                  ) -> set:
    """Return the set of selected point3D ids."""
    # rank key: (min(len, cap) DESC, error ASC)
    ranked = sorted(
        rec.points3D.items(),
        key=lambda kv: (-min(len(kv[1].track),
                             opts.long_track_length_threshold),
                        kv[1].error if kv[1].error >= 0 else 1e9))

    cell = opts.image_grid_cell_size_pixels
    selected: set = set()
    per_image_count: dict[int, int] = {}
    covered_cells: dict[int, set] = {}
    need = {i: opts.min_num_optimized_tracks_per_view
            for i in rec.reg_image_ids}

    # pass 1: grid coverage — take a track if it covers any uncovered cell
    for pid, pt in ranked:
        takes = False
        for (i, kp) in pt.track:
            im = rec.images.get(i)
            if im is None or not im.registered:
                continue
            x, y = im.xys[kp]
            key = (int(x) // cell, int(y) // cell)
            cells = covered_cells.setdefault(i, set())
            if key not in cells:
                takes = True
        if takes:
            selected.add(pid)
            for (i, kp) in pt.track:
                im = rec.images.get(i)
                if im is None or not im.registered:
                    continue
                x, y = im.xys[kp]
                covered_cells.setdefault(i, set()).add(
                    (int(x) // cell, int(y) // cell))
                per_image_count[i] = per_image_count.get(i, 0) + 1

    # pass 2: top-up images below the per-view minimum
    for pid, pt in ranked:
        if pid in selected:
            continue
        if any(per_image_count.get(i, 0) < need.get(i, 0)
               for (i, _) in pt.track):
            selected.add(pid)
            for (i, _) in pt.track:
                per_image_count[i] = per_image_count.get(i, 0) + 1
    return selected
