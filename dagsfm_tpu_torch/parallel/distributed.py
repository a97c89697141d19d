"""Multi-host distribution: the process group, lease-coordinated jobs and
parallel cluster mapping.

Port of dagsfm_tpu/parallel/distributed.py, function for function and
with the same files on disk, so that a worker of either package can share
one work_dir:

  control plane  -> torch.distributed, its rendezvous on tcp://<coordinator>
                    (NCCL for a process on the card, gloo on the CPU)
  job assignment -> static size-sorted balanced partition of clusters to
                    hosts, or leases that workers claim
  data plane     -> COLMAP files on shared storage:
                      leases/cluster<k>.lease, leases/match<k>.lease
                      leases/<job>.fail.d/   (one marker per failure)
                      partition<k>/          (a mapped cluster)
                      matches<k>.db          (a matching job's database)
  intra-host     -> a thread pool over clusters

A worker that dies leaves its lease behind; once it expires,
`orphaned_jobs` lists the job and another worker claims it. A job that
fails `max_attempts` times is tombstoned and no longer claimed.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
import time

import numpy as np

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.parallel.mesh import partition_balanced


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, device=None,
                   backend: str | None = None) -> tuple:
    """Join the process group at tcp://<coordinator> (host:port) as rank
    `process_id` of `num_processes`; without a coordinator, join nothing.
    The backend follows `device` (the GPU unless "cpu" is asked): NCCL on
    the card, gloo on the CPU, or `backend` when the caller names one;
    it is printed. A process on the card uses card `process_id` modulo
    the cards present. Raises if the group cannot be set up.

    Returns (rank, world_size): (0, 1) without a group."""
    import torch
    import torch.distributed as tdist

    dev = devmod.resolve(device)
    if coordinator is not None:
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if dev.type == "cuda" and dev.index is None:
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        print(f"torch.distributed: backend {backend} on {dev.type}, rank "
              f"{process_id} of {num_processes}, tcp://{coordinator}",
              flush=True)
        tdist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                 world_size=num_processes, rank=process_id)
    if tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def assign_clusters_to_hosts(cluster_sizes: list, num_hosts: int) -> list:
    """Static size-balanced assignment. Returns host id per cluster."""
    return partition_balanced(np.asarray(cluster_sizes, float),
                              num_hosts).tolist()


class ClusterJobRunner:
    """One host's side of the cluster jobs, coordinated by lease files.

    work_dir layout:
      leases/cluster<k>.lease   — json {host, t_start, nonce} while running
      leases/cluster<k>.fail.d/ — one marker file per failed attempt
      partition<k>/cameras.bin  — completed output (checkpoint)
    """

    def __init__(self, work_dir: str, host_id: int,
                 lease_timeout_s: float = 3600.0, max_attempts: int = 3):
        self.work_dir = work_dir
        self.host_id = host_id
        self.lease_timeout_s = lease_timeout_s
        self.max_attempts = max_attempts
        self._my_nonce: dict = {}
        os.makedirs(os.path.join(work_dir, "leases"), exist_ok=True)

    def _lease_path(self, k: int) -> str:
        return os.path.join(self.work_dir, "leases", f"cluster{k}.lease")

    def _fail_path(self, k: int) -> str:
        return os.path.join(self.work_dir, "leases", f"cluster{k}.fail")

    def _out_path(self, k: int) -> str:
        return os.path.join(self.work_dir, f"partition{k}")

    def is_done(self, k: int) -> bool:
        return os.path.exists(os.path.join(self._out_path(k), "cameras.bin"))

    def _count_failures(self, k: int) -> int:
        try:
            return len(os.listdir(self._fail_path(k) + ".d"))
        except FileNotFoundError:
            return 0

    def is_failed(self, k: int) -> bool:
        """True once the job is tombstoned (>= max_attempts failures): a
        cluster that fails every time stops being retried."""
        return self._count_failures(k) >= self.max_attempts

    def _release(self, k: int) -> None:
        try:
            os.remove(self._lease_path(k))
        except FileNotFoundError:
            pass

    def record_failure(self, k: int) -> int:
        """Record one failed attempt and release the lease. Returns the
        number of attempts so far (tombstoned at max_attempts).

        Append-only: each failure creates one uniquely named marker
        (O_CREAT | O_EXCL) in <job>.fail.d/ and the count is the number
        of markers, so failures recorded at once on different hosts are
        all counted."""
        fail_dir = self._fail_path(k) + ".d"
        os.makedirs(fail_dir, exist_ok=True)
        marker = os.path.join(
            fail_dir, f"{self.host_id}-{os.getpid()}-{time.time_ns()}")
        fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        with os.fdopen(fd, "w") as f:
            json.dump({"host": self.host_id, "t": time.time()}, f)
        self._release(k)
        return self._count_failures(k)

    def claim(self, k: int) -> bool:
        """Take the lease of job k; False if it is done, tombstoned or
        held elsewhere by a live lease.

        A fresh claim is atomic: of any number of claimers at once,
        exactly one wins. Taking over an expired (or unreadable) lease is
        best effort: each candidate replaces the file, waits, and reads it
        back, which filters most double elections but not all; holders
        therefore call `verify_lease` before publishing, and publication
        is an atomic rename, so a job run twice keeps one result."""
        if self.is_done(k) or self.is_failed(k):
            return False
        path = self._lease_path(k)
        nonce = f"{self.host_id}-{os.getpid()}-{time.time_ns()}"
        self._my_nonce[k] = nonce
        payload = json.dumps({"host": self.host_id,
                              "t_start": time.time(), "nonce": nonce})

        def atomic_create() -> bool:
            """Publish the lease with its content in one step: hard-link a
            fully written temp file into place. (Creating the file and
            then writing it would leave an empty lease that a racing
            claimer reads as corrupt and takes over.)"""
            tmp = path + f".claim.{nonce}"
            with open(tmp, "w") as f:
                f.write(payload)
            try:
                os.link(tmp, path)
                return True
            except FileExistsError:
                return False
            finally:
                os.remove(tmp)

        if atomic_create():
            return True
        try:
            with open(path) as f:
                lease = json.load(f)
            if time.time() - lease["t_start"] < self.lease_timeout_s:
                return False                      # live lease held elsewhere
        except FileNotFoundError:
            # released between the create and the read: try once more
            return atomic_create()
        except (json.JSONDecodeError, KeyError):
            pass                                  # corrupt: take it over
        tmp = path + f".takeover.{nonce}"
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, path)
        time.sleep(0.05)          # let racing replacers land, then read back
        try:
            with open(path) as f:
                return json.load(f).get("nonce") == nonce
        except (FileNotFoundError, json.JSONDecodeError):
            return False

    def verify_lease(self, k: int) -> bool:
        """True if this runner's nonce still holds job k's lease (checked
        just before publishing, see `claim`)."""
        nonce = self._my_nonce.get(k)
        if nonce is None:
            return False
        try:
            with open(self._lease_path(k)) as f:
                return json.load(f).get("nonce") == nonce
        except (FileNotFoundError, json.JSONDecodeError, KeyError):
            return False

    def complete(self, k: int, rec) -> None:
        """Publish the partition atomically: write a temp directory, then
        rename it into place. A crash while writing leaves nothing that
        `is_done` takes for complete; of two holders that both finish,
        one rename wins and the other's output is discarded."""
        from dagsfm_tpu_torch.scene import io as scene_io
        out = self._out_path(k)
        tmp = out + f".tmp.{os.getpid()}.{time.time_ns()}"
        scene_io.write_model_bin(rec, tmp)
        try:
            os.rename(tmp, out)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            if not os.path.exists(out):
                # a rename that failed for another reason (permissions, a
                # shared file system's quirk) would lose the work quietly
                self.record_failure(k)
                raise
            # else another holder published first: keep theirs
        self._release(k)

    def orphaned_jobs(self, all_jobs: list) -> list:
        """Jobs with no output and no live lease (none, expired or
        unreadable): the ones to claim again. Tombstoned jobs are left
        out."""
        out = []
        for k in all_jobs:
            if self.is_done(k) or self.is_failed(k):
                continue
            path = self._lease_path(k)
            if not os.path.exists(path):
                out.append(k)
                continue
            try:
                with open(path) as f:
                    lease = json.load(f)
                if time.time() - lease["t_start"] >= self.lease_timeout_s:
                    out.append(k)
            except (json.JSONDecodeError, KeyError):
                out.append(k)
        return out


def run_clusters_threaded(jobs: list, fn, max_workers: int = 4,
                          monitor=None) -> list:
    """fn(job) for every job on a pool of threads; results in job order,
    the first exception raised. Device work and native code release the
    interpreter lock, so one cluster's host bookkeeping overlaps
    another's device work. `monitor` (start(index, num_images),
    complete(index)) follows the jobs."""
    results = [None] * len(jobs)
    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = {}
        for idx, job in enumerate(jobs):
            if monitor is not None:
                monitor.start(idx, getattr(job, "num_images", 0) or 0)
            futs[ex.submit(fn, job)] = idx
        for fut in cf.as_completed(futs):
            idx = futs[fut]
            results[idx] = fut.result()
            if monitor is not None:
                monitor.complete(idx)
    return results


def cluster_inputs(images: dict, graph, image_ids: list):
    """(images, correspondence graph) of one cluster: its images and the
    matches between two of them."""
    from dagsfm_tpu_torch.sfm.correspondence_graph import CorrespondenceGraph
    idset = set(image_ids)
    sub = CorrespondenceGraph()
    for i in image_ids:
        sub.add_image(i, graph.num_keypoints[i])
    for (i, j), m in graph.pair_matches.items():
        if i in idset and j in idset:
            sub.add_matches(i, j, m)
    return {i: images[i] for i in image_ids}, sub


def run_worker(cameras: dict, images: dict, graph, clusters: list,
               work_dir: str, host_id: int = 0, mapper_options=None,
               lease_timeout_s: float = 3600.0, device=None) -> list:
    """Worker loop: claim cluster jobs by lease, biggest first, map each
    on `device` (the GPU unless "cpu" is asked) and publish it as
    work_dir/partition<k>/. A cluster that registers fewer than two
    images counts as a failed attempt.

    clusters: [{"cluster_id": int, "image_ids": [int]}], as
    `DistributedMapperController.export_cluster_jobs` writes them.
    Returns the indices of the jobs this worker completed."""
    from dagsfm_tpu_torch.sfm.incremental_mapper import (IncrementalMapper,
                                                         MapperOptions)
    dev = devmod.resolve(device)
    runner = ClusterJobRunner(work_dir, host_id,
                              lease_timeout_s=lease_timeout_s)
    order = sorted(range(len(clusters)),
                   key=lambda k: -len(clusters[k]["image_ids"]))
    done = []
    for k in order:
        if not runner.claim(k):
            continue
        spec = clusters[k]
        sub_images, sub = cluster_inputs(images, graph, spec["image_ids"])
        rec = IncrementalMapper(cameras, sub_images, sub,
                                mapper_options or MapperOptions(),
                                device=dev).reconstruct()
        for im in rec.images.values():
            im.cluster_id = spec["cluster_id"]
        if rec.num_reg_images() >= 2:
            if runner.verify_lease(k) or not runner.is_done(k):
                runner.complete(k, rec)
                done.append(k)
        else:
            runner.record_failure(k)
    return done


# ---------------------------------------------------------------------------
# Matching jobs over the same leases: job specs in matching_jobs.json, each
# job's result a COLMAP database matches<k>.db, and the reduce a merge of
# those databases that keys images by name.
# ---------------------------------------------------------------------------


class MatchingJobRunner(ClusterJobRunner):
    """Lease-coordinated matching jobs: output = matches<k>.db."""

    def _lease_path(self, k: int) -> str:
        return os.path.join(self.work_dir, "leases", f"match{k}.lease")

    def _fail_path(self, k: int) -> str:
        return os.path.join(self.work_dir, "leases", f"match{k}.fail")

    def _out_path(self, k: int) -> str:
        return os.path.join(self.work_dir, f"matches{k}.db")

    def is_done(self, k: int) -> bool:
        return os.path.exists(self._out_path(k))

    def tmp_out_path(self, k: int) -> str:
        """Where a worker writes job k's database; `complete_db` renames it
        into place, so matches<k>.db (the done marker) only ever appears
        whole."""
        return self._out_path(k) + f".tmp.{os.getpid()}"

    def complete_db(self, k: int) -> None:
        os.replace(self.tmp_out_path(k), self._out_path(k))
        self._release(k)


def make_matching_jobs(candidate_pairs: list, num_jobs: int,
                       device=None) -> list:
    """Cut the candidate-pair graph into matching jobs: the image
    clustering's cut, then every lost pair added to one cluster of its
    endpoints (`ImageClustering.expand_all_edges`, on `device`), so each
    candidate pair lands in exactly one job.

    candidate_pairs: [(i, j[, score])...]. Returns
    [{"job_id", "image_ids", "pairs"}] with pairs as [i, j] lists."""
    from dagsfm_tpu_torch.clustering.image_clustering import (
        ClusteringOptions, ImageClustering)

    dev = devmod.resolve(device)
    edges = {}
    for p in candidate_pairs:
        i, j = int(p[0]), int(p[1])
        score = float(p[2]) if len(p) > 2 and p[2] else 1.0
        key = (i, j) if i < j else (j, i)
        edges[key] = max(edges.get(key, 0.0), score)
    ids = sorted({i for k in edges for i in k})
    if num_jobs <= 1 or len(ids) <= 2:
        return [{"job_id": 0, "image_ids": ids,
                 "pairs": [[i, j] for (i, j) in sorted(edges)]}]
    ub = max(2, -(-len(ids) // num_jobs))
    ic = ImageClustering(ids, edges, ClusteringOptions(num_images_ub=ub),
                         device=dev)
    ic.cut()
    jobs = []
    for k, c in enumerate(ic.expand_all_edges()):
        if not c.edges:
            continue
        jobs.append({"job_id": k, "image_ids": sorted(c.image_ids),
                     "pairs": [[i, j] for (i, j) in sorted(c.edges)]})
    return jobs


def run_matching_worker(images: dict, cameras: dict, jobs: list,
                        work_dir: str, host_id: int = 0,
                        pipeline_options=None,
                        lease_timeout_s: float = 3600.0,
                        device=None) -> list:
    """Worker loop for matching jobs: claim by lease, most pairs first,
    then extract, match and verify the job's pairs on `device` (the GPU
    unless "cpu" is asked; SIFT and the fused matcher run here) into the
    job's own database, work_dir/matches<k>.db. A job that raises is
    counted as a failed attempt and the worker goes on.

    images: image_id -> (H, W) float array. Returns the completed job
    ids."""
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        FeaturePipeline, FeaturePipelineOptions)

    dev = devmod.resolve(device)
    runner = MatchingJobRunner(work_dir, host_id,
                               lease_timeout_s=lease_timeout_s)
    order = sorted(range(len(jobs)), key=lambda k: -len(jobs[k]["pairs"]))
    done = []
    for k in order:
        jid = jobs[k]["job_id"]
        if not runner.claim(jid):
            continue
        spec = jobs[k]
        tmp_db = runner.tmp_out_path(jid)
        fp = FeaturePipeline({i: images[i] for i in spec["image_ids"]},
                             {i: cameras[i] for i in spec["image_ids"]},
                             pipeline_options or FeaturePipelineOptions(),
                             device=dev, database_path=tmp_db)
        try:
            fp.extract_features()
            fp.match_and_verify(pairs=[tuple(p) for p in spec["pairs"]])
            fp.write_database()
        except Exception as exc:  # noqa: BLE001 — the worker outlives a job
            _remove(tmp_db)
            runner.record_failure(jid)
            print(f"[matching-worker {host_id}] job {jid} failed: {exc!r}")
            continue
        if runner.verify_lease(jid) or not runner.is_done(jid):
            runner.complete_db(jid)
            done.append(jid)
        else:                     # lost an expired lease to another worker
            _remove(tmp_db)
    return done


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def merge_matching_databases(work_dir: str, job_ids: list,
                             out_path: str) -> int:
    """The master's reduce: fold every work_dir/matches<k>.db into one
    database at out_path with `ColmapDatabase.merge`, which keeps one id
    per image name (an image in several jobs is one image). Returns the
    number of two-view geometries in it."""
    from dagsfm_tpu_torch.scene.io import ColmapDatabase

    paths = [os.path.join(work_dir, f"matches{k}.db") for k in job_ids]
    paths = [p for p in paths if os.path.exists(p)]
    if not paths:
        return 0
    _remove(out_path)
    if len(paths) == 1:
        shutil.copy(paths[0], out_path)
    else:
        acc, tmp_prev = paths[0], None
        for step, nxt in enumerate(paths[1:]):
            tmp = out_path + f".step{step}"
            with ColmapDatabase(acc) as db1, ColmapDatabase(nxt) as db2, \
                    ColmapDatabase(tmp) as out:
                ColmapDatabase.merge(db1, db2, out)
            if tmp_prev is not None:
                os.remove(tmp_prev)
            acc = tmp_prev = tmp
        os.replace(acc, out_path)
    with ColmapDatabase(out_path) as db:
        return db.num_two_view_geometries()
