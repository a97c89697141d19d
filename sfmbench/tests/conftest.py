"""Shared pieces of the benchmark's tests: the card fixture (tests that
need a CUDA card skip inside the test without one) and the test sizes of
each cell.

    python -m pytest sfmbench/tests -q -p no:cacheprovider -o addopts=""
"""

from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

# each cell at a size a CPU test run holds: the same configuration and
# traffic with fewer images, slots, points and observations
TINY = {
    "verify.cluster100": {
        "config": {"scene": {"num_cameras": 8, "num_points": 180,
                             "width": 640, "height": 480},
                   "features": {"max_num_features": 256},
                   "matching": {"sequential_overlap": 3}},
        # about 100 matches a pair at 640 x 480: the poses are read
        # about ten times less sharply than at the cell's size
        "traffic": {"job_pairs": 8, "control_pairs": 6,
                    "judge": {"max_model_gap": 1e-4,
                              "max_rotation_deg": 5.0,
                              "max_translation_deg": 15.0,
                              "min_inlier_share": 0.8}}},
    "ba.dubrovnik356": {
        "config": {"problem": {"num_cameras": 12, "num_points": 300,
                               "num_observations": 1500}},
        "traffic": {"starts": 3}},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's kernels run only there")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)
