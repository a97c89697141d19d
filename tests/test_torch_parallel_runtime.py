"""The port's lease runtime (parallel/distributed.py) on the CPU: twins of
tests/test_distributed_runtime.py, a work_dir shared with the JAX
package's runners, worker processes started through
`python -m dagsfm_tpu_torch local_sfm_worker --device cpu`, and the
process group over localhost (gloo)."""
import json
import multiprocessing as mp
import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dagsfm_tpu.parallel import distributed as j_dist
from dagsfm_tpu.utils.observability import ProgressMonitor
from dagsfm_tpu_torch.clustering.image_clustering import ClusteringOptions
from dagsfm_tpu_torch.ops import cuda_build
from dagsfm_tpu_torch.parallel import distributed as dist
from dagsfm_tpu_torch.pipeline.distributed_mapper import (
    DistributedMapperController, DistributedMapperOptions)
from dagsfm_tpu_torch.scene import cameras as cm
from dagsfm_tpu_torch.scene import io as scene_io
from dagsfm_tpu_torch.scene import synthetic
from dagsfm_tpu_torch.scene.reconstruction import (ImageRecord,
                                                   Reconstruction)
from dagsfm_tpu_torch.sfm.incremental_mapper import MapperOptions
from test_torch_distributed_mapper import noisy_geometries

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_assign_clusters_balanced():
    sizes = [100, 90, 30, 20, 10, 10]
    assign = dist.assign_clusters_to_hosts(sizes, 2)
    assert assign == j_dist.assign_clusters_to_hosts(sizes, 2)
    loads = [0, 0]
    for s, h in zip(sizes, assign):
        loads[h] += s
    assert abs(loads[0] - loads[1]) <= 30


def test_single_host_identity():
    assert dist.init_multihost(device="cpu") == (0, 1)


def small_model():
    """Two registered images of one camera: what a partition holds."""
    rec = Reconstruction()
    rec.add_camera(cm.make_simple_camera(1, 64, 48, focal=50.0))
    for i in (1, 2):
        rec.add_image(ImageRecord(
            image_id=i, name=f"im{i}", camera_id=1,
            qvec=np.array([1.0, 0, 0, 0]), tvec=np.zeros(3),
            xys=np.zeros((0, 2)), point3D_ids=np.zeros(0, np.int64)))
        rec.register_image(i)
    return rec


class TestLeases:
    def test_claim_and_complete(self, tmp_path):
        r = dist.ClusterJobRunner(str(tmp_path), host_id=0)
        assert r.claim(0)
        assert not dist.ClusterJobRunner(str(tmp_path), 1).claim(0)
        r.complete(0, small_model())
        assert r.is_done(0)
        assert not r.claim(0)              # done jobs are not claimed again
        assert r.orphaned_jobs([0, 1]) == [1]

    def test_expired_lease_reclaimed(self, tmp_path):
        r = dist.ClusterJobRunner(str(tmp_path), 0, lease_timeout_s=0.01)
        assert r.claim(3)
        time.sleep(0.05)
        r2 = dist.ClusterJobRunner(str(tmp_path), 1, lease_timeout_s=0.01)
        assert 3 in r2.orphaned_jobs([3])
        assert r2.claim(3)
        with open(os.path.join(str(tmp_path), "leases",
                               "cluster3.lease")) as f:
            assert json.load(f)["host"] == 1

    def test_work_dir_shared_with_the_reference(self, tmp_path):
        """A JAX worker and a port worker see each other's leases,
        failure markers and partitions."""
        wd = str(tmp_path)
        j = j_dist.ClusterJobRunner(wd, 0)
        t = dist.ClusterJobRunner(wd, 1)
        assert j.claim(0) and not t.claim(0)
        assert t.claim(1) and not j.claim(1)
        t.complete(1, small_model())
        assert j.is_done(1) and j.orphaned_jobs([0, 1, 2]) == [2]
        assert t.record_failure(2) == 1 and j.record_failure(2) == 2
        jm, tm = j_dist.MatchingJobRunner(wd, 0), \
            dist.MatchingJobRunner(wd, 1)
        assert tm.claim(5) and not jm.claim(5)
        with open(tm.tmp_out_path(5), "w") as f:
            f.write("db")
        tm.complete_db(5)
        assert jm.is_done(5)


def test_threaded_cluster_map():
    monitor = ProgressMonitor()
    jobs = list(range(6))

    def fn(k):
        time.sleep(0.01)
        return k * k

    out = dist.run_clusters_threaded(jobs, fn, max_workers=3,
                                     monitor=monitor)
    assert out == [k * k for k in jobs]
    assert monitor.all_completed()


def test_threaded_map_propagates_errors():
    def fn(k):
        if k == 2:
            raise ValueError("boom")
        return k

    with pytest.raises(ValueError):
        dist.run_clusters_threaded([0, 1, 2], fn)


def test_kernel_loads_from_many_threads_build_once(monkeypatch):
    """cuda_build.load from more threads than cores at once: each library
    is built and loaded once (check-then-act under the module's lock)."""
    built = []

    def fake_load(names):
        for n in names:
            if n not in cuda_build._libs:
                time.sleep(0.001)
                built.append(n)
                cuda_build._libs[n] = object()
        return {n: cuda_build._libs[n] for n in names}

    monkeypatch.setattr(cuda_build, "_load", fake_load)
    monkeypatch.setattr(cuda_build, "_libs", {})
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=cuda_build.load,
                                    args=("a", "b", "c"))
                   for _ in range(4 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert sorted(built) == ["a", "b", "c"]


def worker_options():
    return DistributedMapperOptions(
        clustering=ClusteringOptions(num_images_ub=8, image_overlap=4,
                                     completeness_ratio=0.5),
        mapper=MapperOptions(init_min_num_inliers=30,
                             num_ransac_hypotheses=256, seed=11))


def test_run_worker_end_to_end(tmp_path):
    """Two workers drain the cluster jobs by lease; the master resumes
    from their partitions and merges (tests/test_distributed_runtime.py's
    scene and limits; pose edges from the scene's truth)."""
    sc = synthetic.generate(synthetic.SyntheticSceneSpec(
        num_cameras=14, num_points=400, pixel_noise=0.3, seed=21))
    cams, images, graph = synthetic.to_matching_problem(sc, seed=3)
    geo = noisy_geometries(sc, graph)
    opts = worker_options()
    ctrl = DistributedMapperController(cams, images, graph, opts,
                                       two_view_geometries=geo,
                                       device="cpu")
    ctrl.build_view_graph()
    ctrl.filter_and_average_rotations()
    ctrl.cluster_scenes()
    wd = str(tmp_path / "work")
    ctrl.export_cluster_jobs(wd)
    clusters = json.load(open(f"{wd}/clusters.json"))
    assert len(clusters) >= 2

    done0 = dist.run_worker(cams, images, graph, clusters, wd, host_id=0,
                            mapper_options=opts.mapper, device="cpu")
    done1 = dist.run_worker(cams, images, graph, clusters, wd, host_id=1,
                            mapper_options=opts.mapper, device="cpu")
    assert set(done0) | set(done1) == set(range(len(clusters)))
    assert not set(done0) & set(done1)
    for k, spec in enumerate(clusters):
        part = scene_io.read_model_bin(os.path.join(wd, f"partition{k}"))
        assert set(part.reg_image_ids) <= set(spec["image_ids"])
        assert part.num_reg_images() >= 2

    merged = DistributedMapperController(
        cams, images, graph, opts, device="cpu").run(checkpoint_path=wd)
    assert merged.num_reg_images() >= 12
    errs = synthetic.pose_errors(merged, sc)
    assert errs["ate"] < 0.1, errs


def make_workspace(tmp_path, num_cameras=12, num_points=200, seed=7,
                   overlap=0):
    """A database of a ring scene's matches (CALIBRATED) and a work_dir
    whose clusters.json cuts the ring in two halves, the second one
    starting `overlap` images early."""
    sc = synthetic.generate(synthetic.SyntheticSceneSpec(
        num_cameras=num_cameras, num_points=num_points, pixel_noise=0.3,
        seed=seed))
    cams, images, graph = synthetic.to_matching_problem(sc)
    db = str(tmp_path / "database.db")
    with scene_io.ColmapDatabase(db) as d:
        d.add_camera(cams[1])
        for i, im in sorted(images.items()):
            d.add_image(im.name, 1, image_id=i)
            d.add_keypoints(i, im.xys)
        for (i, j), m in graph.pair_matches.items():
            d.add_matches(i, j, m)
            d.add_two_view_geometry(i, j, m, config=2)
    wd = str(tmp_path / "work")
    os.makedirs(wd, exist_ok=True)
    half = num_cameras // 2
    clusters = [
        {"cluster_id": 0, "image_ids": list(range(1, half + 1))},
        {"cluster_id": 1, "image_ids": list(range(half + 1 - overlap,
                                                  num_cameras + 1))}]
    with open(f"{wd}/clusters.json", "w") as f:
        json.dump(clusters, f)
    return db, wd, clusters, sc


def worker_cmd(db, wd, host_id, lease_timeout=3600.0):
    return [sys.executable, "-m", "dagsfm_tpu_torch", "local_sfm_worker",
            "--database_path", db, "--work_dir", wd, "--host_id",
            str(host_id), "--lease_timeout", str(lease_timeout),
            "--device", "cpu"]


def run_two_workers(db, wd):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(worker_cmd(db, wd, h), env=env, cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for h in (0, 1)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=560)
        outs.append(out)
        assert p.returncode == 0, out[-2000:]
    done_sets = []
    for out in outs:
        m = re.search(r"worker \d: completed clusters \[(.*?)\]", out)
        assert m, out[-2000:]
        done_sets.append({int(x) for x in m.group(1).split(",")
                          if x.strip()})
    return done_sets


def check_split(wd, done_sets):
    for k in range(2):
        assert os.path.exists(os.path.join(wd, f"partition{k}",
                                           "cameras.bin"))
    assert done_sets[0] | done_sets[1] == {0, 1}
    assert not done_sets[0] & done_sets[1], done_sets
    assert not [d for d in os.listdir(wd) if ".tmp." in d]


def test_two_worker_processes_split_the_work_and_merge(tmp_path):
    """Two `local_sfm_worker` processes on the CPU share the jobs of a
    12-image ring (clusters of 6 and 8, two images in both); the master
    merges their partitions and runs the sharded final BA in two
    shards."""
    db, wd, clusters, sc = make_workspace(tmp_path, num_points=160, seed=5,
                                          overlap=2)
    check_split(wd, run_two_workers(db, wd))
    fp_cams, images, graph = _load(db)
    ctrl = DistributedMapperController(
        fp_cams, images, graph, DistributedMapperOptions(
            distributed_final_ba=True, num_devices=2, final_ba_iterations=5),
        device="cpu")
    merged = ctrl.run(checkpoint_path=wd)
    assert merged.num_reg_images() == 12
    assert ctrl.ba_stats.num_iterations == 5
    assert ctrl.ba_stats.final_cost <= ctrl.ba_stats.initial_cost
    assert synthetic.pose_errors(merged, sc)["ate"] < 0.1


def _load(db):
    from dagsfm_tpu_torch.pipeline.feature_pipeline import FeaturePipeline
    return FeaturePipeline({}, {}, device="cpu").load_from_database(db)


@pytest.mark.slow
def test_two_processes_split_the_work(tmp_path):
    db, wd, _, _ = make_workspace(tmp_path)
    check_split(wd, run_two_workers(db, wd))


@pytest.mark.slow
def test_orphan_lease_takeover_cross_process(tmp_path):
    db, wd, _, _ = make_workspace(tmp_path, seed=8)
    os.makedirs(os.path.join(wd, "leases"), exist_ok=True)
    with open(os.path.join(wd, "leases", "cluster0.lease"), "w") as f:
        json.dump({"host": 99, "t_start": time.time() - 10_000}, f)
    p = subprocess.run(worker_cmd(db, wd, 1, lease_timeout=60.0), cwd=ROOT,
                       env=dict(os.environ, OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=560)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    for k in range(2):
        assert os.path.exists(os.path.join(wd, f"partition{k}",
                                           "cameras.bin"))


class TestAtomicLeaseContention:
    def test_barrier_synced_claims_one_winner(self, tmp_path):
        """Six processes claim one job at the same instant: exactly one
        wins. The processes import only the port's parallel.distributed."""
        import torch_ranks

        ctx = mp.get_context("spawn")
        n_procs = 6
        barrier = ctx.Barrier(n_procs)
        q = ctx.Queue()
        procs = [ctx.Process(target=torch_ranks.lease_claim,
                             args=(str(tmp_path), h, barrier, q))
                 for h in range(n_procs)]
        for p in procs:
            p.start()
        results = [q.get(timeout=120) for _ in range(n_procs)]
        for p in procs:
            p.join(timeout=60)
        assert not any(p.is_alive() for p in procs)
        winners = [h for h, ok in results if ok]
        assert len(winners) == 1, f"lease race: winners={winners}"

    def test_failure_tombstone_bounds_retries(self, tmp_path):
        r = dist.ClusterJobRunner(str(tmp_path), 0, max_attempts=3)
        for _ in range(3):
            assert not r.is_failed(0)
            assert r.claim(0)
            r.record_failure(0)
        assert r.is_failed(0)
        assert not r.claim(0)
        assert r.orphaned_jobs([0, 1]) == [1]


def test_two_process_group_all_reduce(tmp_path):
    """init_multihost over localhost in two processes on the CPU: gloo,
    chosen from the device and printed, then an all_reduce."""
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
    except OSError:
        pytest.skip("localhost TCP is forbidden here; by hand: two "
                    "processes calling init_multihost('127.0.0.1:<port>', "
                    "2, <rank>, device='cpu'), then all_reduce")
    port = s.getsockname()[1]
    s.close()

    def code(rank):
        return (
            "import torch, torch.distributed as d;"
            "from dagsfm_tpu_torch.parallel.distributed import "
            "init_multihost;"
            f"idx, cnt = init_multihost('127.0.0.1:{port}', 2, {rank}, "
            "device='cpu');"
            "assert cnt == 2, cnt;"
            "x = torch.tensor([idx + 1.0], dtype=torch.float64);"
            "d.all_reduce(x);"
            "assert float(x[0]) == 3.0, x;"
            f"print('proc {rank} all_reduce ok', float(x[0]));"
            "d.destroy_process_group()")

    procs = [subprocess.Popen([sys.executable, "-c", code(r)], cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("the localhost rendezvous timed out")
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
        assert "backend gloo on cpu" in o and "all_reduce ok" in o, o


class TestCrashSafePublication:
    def test_partial_matching_db_not_done(self, tmp_path):
        r = dist.MatchingJobRunner(str(tmp_path), 0)
        with open(r.tmp_out_path(3), "w") as f:
            f.write("partial sqlite bytes")
        assert not r.is_done(3)
        assert r.claim(3)
        r.complete_db(3)
        assert r.is_done(3)

    def test_failure_counter_append_only_concurrent(self, tmp_path):
        a = dist.ClusterJobRunner(str(tmp_path), 0, max_attempts=4)
        b = dist.ClusterJobRunner(str(tmp_path), 1, max_attempts=4)
        assert a.record_failure(7) == 1
        assert b.record_failure(7) == 2
        assert a.record_failure(7) == 3
        assert not a.is_failed(7)
        assert b.record_failure(7) == 4
        assert a.is_failed(7) and b.is_failed(7)

    def test_verify_lease_detects_takeover(self, tmp_path):
        a = dist.ClusterJobRunner(str(tmp_path), 0, lease_timeout_s=0.0)
        b = dist.ClusterJobRunner(str(tmp_path), 1, lease_timeout_s=0.0)
        assert a.claim(0)
        assert a.verify_lease(0)
        assert b.claim(0)
        assert b.verify_lease(0)
        assert not a.verify_lease(0)

    def test_cluster_complete_is_atomic_rename(self, tmp_path):
        rec = small_model()
        a = dist.ClusterJobRunner(str(tmp_path), 0)
        b = dist.ClusterJobRunner(str(tmp_path), 1)
        assert not a.is_done(5)
        a.claim(5)
        a.complete(5, rec)
        assert a.is_done(5)
        b.complete(5, rec)          # a second publisher keeps the first's
        assert b.is_done(5)
        assert not [d for d in os.listdir(tmp_path) if ".tmp." in d]


def test_worker_entry_points_need_a_gpu_unless_told_cpu(monkeypatch,
                                                        tmp_path):
    """init_multihost, run_worker, make_matching_jobs and
    run_matching_worker run on the card unless asked for the CPU; so do
    the CLI's commands (--device, default cuda)."""
    from dagsfm_tpu_torch.pipeline import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: dist.init_multihost(),
                 lambda: dist.run_worker({}, {}, None, [], str(tmp_path)),
                 lambda: dist.make_matching_jobs([(1, 2), (2, 3)], 2),
                 lambda: dist.run_matching_worker({}, {}, [],
                                                  str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    db, wd, _, _ = make_workspace(tmp_path, num_cameras=4, num_points=40)
    for argv in (["local_sfm_worker", "--database_path", db, "--work_dir",
                  wd],
                 ["distributed_mapper", "--database_path", db,
                  "--output_path", str(tmp_path / "out")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    with open(os.path.join(wd, "matching_jobs.json"), "w") as f:
        json.dump([], f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["local_matching_worker", "--image_path", str(tmp_path),
                  "--work_dir", wd])
