"""Rotation averaging of the port against the JAX package on
tests/test_rotation_averaging.py's exact, noisy and outlier graphs:
spanning-tree init exactly, the L1 + IRLS solve and the Gauss-Newton
refinement to rel 1e-9, the rotation alignment, and the same
orientation-filter mask."""
import numpy as np
import pytest
import torch

from dagsfm_tpu.estimation import rotation_averaging as j_ra
from dagsfm_tpu_torch.estimation import rotation_averaging as t_ra
from tests.test_rotation_averaging import angular_errors, make_ra_problem

torch.set_num_threads(1)

PROBLEMS = {   # test_rotation_averaging.py's graphs
    "exact": dict(num_images=20),
    "noise": dict(num_images=30, noise_deg=1.0, seed=1),
    "outliers": dict(num_images=30, noise_deg=0.5, outlier_frac=0.15,
                     seed=2),
    "filter": dict(num_images=25, noise_deg=0.3, outlier_frac=0.2, seed=3),
}
LIMITS = {"exact": 1e-4, "noise": 0.5, "outliers": 1.0}


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def problem(request):
    args = PROBLEMS[request.param]
    R_gt, edges, rels = make_ra_problem(**args)
    return request.param, args["num_images"], R_gt, edges, rels


def test_spanning_tree_init_is_exact(problem):
    _, n, _, edges, rels = problem
    np.testing.assert_array_equal(t_ra.spanning_tree_init(n, edges, rels),
                                  j_ra.spanning_tree_init(n, edges, rels))


def test_estimate_rotations_matches_reference(problem):
    name, n, R_gt, edges, rels = problem
    ref = j_ra.estimate_rotations(n, edges, rels)
    R = t_ra.estimate_rotations(n, edges, rels, device="cpu")
    np.testing.assert_allclose(R, ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(R[0], np.eye(3), atol=1e-12)
    if name in LIMITS:     # test_rotation_averaging.py's mean error limits
        assert angular_errors(R, R_gt).mean() < LIMITS[name]
    keep = t_ra.filter_pairs_from_orientation(edges, rels, R, 5.0,
                                              device="cpu")
    np.testing.assert_array_equal(
        keep, j_ra.filter_pairs_from_orientation(edges, rels, ref, 5.0))


def test_nonlinear_refinement_matches_reference(problem):
    _, n, _, edges, rels = problem
    ref = j_ra.estimate_rotations_nonlinear(n, edges, rels, iterations=20)
    R = t_ra.estimate_rotations_nonlinear(n, edges, rels, iterations=20,
                                          device="cpu")
    np.testing.assert_allclose(R, ref, rtol=1e-9, atol=1e-9)
    init = t_ra.estimate_rotations(n, edges, rels, device="cpu")
    np.testing.assert_allclose(
        t_ra.estimate_rotations_nonlinear(n, edges, rels, init=init,
                                          iterations=5, device="cpu"),
        j_ra.estimate_rotations_nonlinear(n, edges, rels, init=init,
                                          iterations=5),
        rtol=1e-9, atol=1e-9)


def test_options_and_alignment_match_reference(problem):
    _, n, R_gt, edges, rels = problem
    opts = dict(l1_iterations=3, irls_iterations=7, cg_iterations=20,
                sigma_deg=2.0)
    R = t_ra.estimate_rotations(n, edges, rels, t_ra.RAOptions(**opts),
                                device="cpu")
    np.testing.assert_allclose(
        R, j_ra.estimate_rotations(n, edges, rels, j_ra.RAOptions(**opts)),
        rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(t_ra.align_rotations(R, R_gt),
                               j_ra.align_rotations(R, R_gt),
                               rtol=1e-12, atol=1e-12)
