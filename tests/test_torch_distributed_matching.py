"""The port's matching jobs over the lease runtime, on the CPU: twins of
tests/test_distributed_matching.py. The candidate pairs are cut into
jobs (each pair in exactly one), workers extract, match and verify each
job into its own database, and the master merges the databases (one id
per image name) and maps the merged one."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dagsfm_tpu.parallel import distributed as j_dist
from dagsfm_tpu_torch.features import sift
from dagsfm_tpu_torch.parallel.distributed import (make_matching_jobs,
                                                   merge_matching_databases,
                                                   run_matching_worker)
from dagsfm_tpu_torch.pipeline.feature_pipeline import (
    FeaturePipeline, FeaturePipelineOptions)
from dagsfm_tpu_torch.scene import cameras as cm
from dagsfm_tpu_torch.scene import synthetic
from dagsfm_tpu_torch.sfm.incremental_mapper import (IncrementalMapper,
                                                     MapperOptions)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ring_pairs(ids, width=2):
    n = len(ids)
    out = []
    for a in range(n):
        for d in range(1, width + 1):
            i, j = ids[a], ids[(a + d) % n]
            out.append((min(i, j), max(i, j)))
    return sorted(set(out))


def check_jobs(jobs, pairs):
    seen = []
    for jb in jobs:
        idset = set(jb["image_ids"])
        for (i, j) in jb["pairs"]:
            assert i in idset and j in idset
            seen.append((i, j))
    assert sorted(seen) == pairs          # every pair in exactly one job


@pytest.mark.parametrize("num_jobs", [1, 2, 4])
def test_make_matching_jobs_covers_all_pairs_once(num_jobs):
    pairs = ring_pairs(list(range(1, 25)), width=3)
    cand = [(i, j, 1.0) for (i, j) in pairs]
    jobs = make_matching_jobs(cand, num_jobs, device="cpu")
    assert len(jobs) >= min(num_jobs, 2)
    check_jobs(jobs, pairs)
    if num_jobs == 1:       # no clustering: the reference's single job
        assert jobs == j_dist.make_matching_jobs(cand, 1)


@pytest.fixture(scope="module")
def rendered_scene():
    spec = synthetic.SyntheticSceneSpec(
        num_cameras=12, num_points=40, image_width=320, image_height=240,
        focal=340.0, seed=5, ring_radius=9.0, point_cloud_extent=3.5)
    sc = synthetic.generate(spec)
    return spec, sc, synthetic.render_images(sc, device="cpu")


def pipeline_options(max_num_features=512):
    opts = FeaturePipelineOptions(batch_size=4)
    opts.sift = sift.SiftOptions(max_num_features=max_num_features,
                                 candidates_per_octave=min(
                                     512, max_num_features),
                                 num_octaves=3)
    return opts


def cameras_of(spec, ids):
    return {i: cm.make_simple_camera(i, spec.image_width, spec.image_height,
                                     focal=spec.focal) for i in ids}


def test_in_process_matching_worker_single_job(rendered_scene, tmp_path):
    spec, sc, images = rendered_scene
    ids = sorted(images)[:4]
    pairs = [(ids[0], ids[1]), (ids[1], ids[2]), (ids[2], ids[3])]
    jobs = make_matching_jobs([(i, j, 1.0) for (i, j) in pairs], 1,
                              device="cpu")
    done = run_matching_worker({i: images[i] for i in ids},
                               cameras_of(spec, ids), jobs, str(tmp_path),
                               pipeline_options=pipeline_options(),
                               device="cpu")
    assert done == [0]
    merged = str(tmp_path / "m.db")
    assert merge_matching_databases(str(tmp_path), [0], merged) >= 2
    cams, imgs, graph = FeaturePipeline({}, {}, device="cpu") \
        .load_from_database(merged)
    assert len(imgs) == 4
    assert graph.num_correspondences_for_image(ids[1]) > 0


@pytest.mark.slow
def test_two_process_matching_merges_to_one_model(rendered_scene,
                                                  tmp_path):
    """Two `local_matching_worker` processes split the jobs of a 12-image
    ring; the merged database holds one record per image and maps every
    image but at most one."""
    spec, sc, images = rendered_scene
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i, img in images.items():
        np.save(img_dir / f"image{i}.npy", img)
    ids = sorted(images)
    pairs = ring_pairs(ids, width=2)
    jobs = make_matching_jobs([(i, j, 1.0) for (i, j) in pairs], 2,
                              device="cpu")
    wd = tmp_path / "work"
    wd.mkdir()
    with open(wd / "matching_jobs.json", "w") as f:
        json.dump(jobs, f)
    cmd = [sys.executable, "-m", "dagsfm_tpu_torch", "local_matching_worker",
           "--image_path", str(img_dir), "--work_dir", str(wd),
           "--focal", str(spec.focal), "--max_num_features", "768",
           "--guided_matching", "--device", "cpu", "--host_id"]
    procs = [subprocess.Popen(cmd + [str(h)], cwd=ROOT,
                              env=dict(os.environ, OMP_NUM_THREADS="1"),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for h in (0, 1)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
    completed = []
    for o in outs:
        line = [ln for ln in o.splitlines() if "completed jobs" in ln][-1]
        completed.append(json.loads(line.split("completed jobs")[1]))
    assert sorted(j for c in completed for j in c) == \
        sorted(j["job_id"] for j in jobs), outs
    assert all(len(c) >= 1 for c in completed), completed
    merged = str(tmp_path / "merged.db")
    n_tvg = merge_matching_databases(str(wd), [j["job_id"] for j in jobs],
                                     merged)
    assert n_tvg >= len(pairs) * 0.8, (n_tvg, len(pairs))
    cams, imgs, graph = FeaturePipeline({}, {}, device="cpu") \
        .load_from_database(merged)
    assert len(imgs) == len(ids)
    rec = IncrementalMapper(cams, imgs, graph, MapperOptions(seed=0),
                            device="cpu").reconstruct()
    err = synthetic.pose_errors(rec, sc)
    assert err["num_reg"] >= len(ids) - 1, err
    assert err["ate"] < 0.2, err
