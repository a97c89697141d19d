"""The port's twin of tests/test_e2e_scale.py on the CPU: 100 rendered
images through the whole distributed pipeline, with the reference
test's own options and gates (chip_smoke.scale_inputs, which the
retrieval path of chip_smoke.py runs on the card): SIFT -> sequential
pairs with BoW loop closure -> essential-only verification -> view
graph, rotation averaging, clustering (at most 30 images) -> per-cluster
mapping -> Sim(3) merge -> final BA. The port's own k-means and RANSAC
draws. One to two minutes on four CPU threads -> marked slow."""
import pytest
import torch

from chip_smoke import scale_inputs
from dagsfm_tpu_torch.pipeline.distributed_mapper import \
    DistributedMapperController
from dagsfm_tpu_torch.pipeline.feature_pipeline import FeaturePipeline
from dagsfm_tpu_torch.scene import synthetic


@pytest.mark.slow
def test_100_image_pixels_to_model():
    torch.set_num_threads(4)
    sc, images, cams, opts, dm_opts = scale_inputs("cpu")
    fp = FeaturePipeline(images, cams, opts, device="cpu")
    fp.extract_features()
    fp.match_and_verify()
    assert len(fp.two_view) > 300, len(fp.two_view)
    seam = [(i, j) for (i, j) in fp.two_view if j - i > 80]
    assert seam, "loop closure missed the ring seam"
    cams2, imgs2, graph = fp.to_mapper_inputs()
    ctrl = DistributedMapperController(
        cams2, imgs2, graph, dm_opts,
        two_view_geometries=fp.two_view_edges(), device="cpu")
    merged = ctrl.run()
    err = synthetic.pose_errors(merged, sc)
    sep_rmse = ctrl.separator_rmse(merged)
    print("scale e2e:", err, "separator_rmse_px:", sep_rmse,
          "timings:", {k: round(v, 1) for k, v in fp.timings.items()},
          {k: round(v, 1) for k, v in ctrl.timings.items()})
    assert err["num_reg"] >= 90, err
    assert err["ate"] < 0.1, err
    assert sep_rmse < 2.0, sep_rmse
