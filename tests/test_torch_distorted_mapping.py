"""Mapping from cameras without a focal prior on the CPU: keypoints of
synthetic.to_matching_problem seen through a SIMPLE_RADIAL camera
(f 900, k1 = -0.1; chip_smoke.distort_keypoints) -> IncrementalMapper ->
write_model_bin, from one blind camera shared by every image (BA
refines f and k1) and from one blind camera per image (the focal grid
runs on each camera's first registration). The limits are
tests/test_incremental_mapper.py's (ATE < 0.05, mean rotation error <
0.2 deg)."""
import numpy as np
import torch

from chip_smoke import distort_keypoints
from dagsfm_tpu_torch.scene import cameras as t_cm
from dagsfm_tpu_torch.scene import io as t_io
from dagsfm_tpu_torch.scene import synthetic as t_syn
from dagsfm_tpu_torch.sfm import incremental_mapper as t_im

torch.set_num_threads(1)

N_IMG = 12
ATE, ROT = 0.05, 0.2


def _check(err):
    assert err["num_reg"] == N_IMG, err
    assert err["ate"] < ATE, err
    assert err["rot_err_deg_mean"] < ROT, err


def _distorted_problem(num_cameras: int):
    """to_matching_problem's keypoints seen through SIMPLE_RADIAL
    (f 900, k1 = -0.1) with 0.3 px noise."""
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=num_cameras, num_points=60 * num_cameras, seed=3,
        image_width=1024, image_height=768, focal=900.0))
    _, images, graph = t_syn.to_matching_problem(sc)
    truth = t_cm.Camera(1, t_cm.SIMPLE_RADIAL, 1024, 768,
                        (900.0, 512.0, 384.0, -0.1))
    return sc, distort_keypoints(sc, images, truth, noise=0.3), graph


def test_blind_distorted_camera_end_to_end(tmp_path):
    """A dozen images from one blind SIMPLE_RADIAL camera (f = 1228.8,
    k1 = 0, no prior): every image registers, BA refines f and k1 with
    the right sign, and the model file keeps the camera."""
    sc, images, graph = _distorted_problem(N_IMG)
    blind = t_cm.make_simple_camera(1, 1024, 768, model="SIMPLE_RADIAL")
    mapper = t_im.IncrementalMapper({1: blind}, images, graph,
                                    t_im.MapperOptions(seed=0), device="cpu")
    rec = mapper.reconstruct()
    _check(t_syn.pose_errors(rec, sc))
    cam = rec.cameras[1]
    assert cam.model_name == "SIMPLE_RADIAL" and not cam.prior_focal
    assert abs(cam.params[0] - 900.0) < 9.0, cam
    assert -0.15 < cam.params[3] < -0.05, cam
    # one shared camera: its first registration is the initial pair
    assert mapper.focal_grid_factors == []
    t_io.write_model_bin(rec, str(tmp_path))
    assert t_io.read_model_bin(str(tmp_path)).cameras[1].params == \
        cam.params


def test_focal_grid_on_each_cameras_first_registration():
    """One blind camera per image: every image registered after the
    initial pair first goes through the focal grid, whose pick BA then
    refines towards the true focal."""
    n = 8
    sc, images, graph = _distorted_problem(n)
    cams = {}
    for i, im in images.items():
        im.camera_id = i
        cams[i] = t_cm.make_simple_camera(i, 1024, 768,
                                          model="SIMPLE_RADIAL")
    mapper = t_im.IncrementalMapper(cams, images, graph,
                                    t_im.MapperOptions(seed=0), device="cpu")
    rec = mapper.reconstruct()
    err = t_syn.pose_errors(rec, sc)
    assert err["num_reg"] == n and err["rot_err_deg_mean"] < ROT, err
    grid = np.exp(np.linspace(np.log(0.2), np.log(5.0), 15))
    assert len(mapper.focal_grid_factors) == n - 2
    # grid points only; the nearest to 900 / 1228.8 = 0.732 wins most
    # often (the first of tied inlier counts wins, which may be smaller)
    picks = mapper.focal_grid_factors
    assert all(np.isclose(grid, p, rtol=1e-12, atol=0).any() for p in picks)
    assert picks.count(grid[6]) >= len(picks) // 2, picks
    for c in rec.cameras.values():
        assert abs(c.params[0] - 900.0) < 18.0 and c.params[3] < 0, c
