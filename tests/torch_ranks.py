"""Process targets for the port's multi-process tests.

Started with the `spawn` method, so each process imports this module
afresh: it imports torch, numpy and the port only, never jax or the JAX
package.
"""
import os

import numpy as np


def lease_claim(work_dir, host_id, barrier, q):
    """Claim job 0 the moment every process is ready; report the result."""
    from dagsfm_tpu_torch.parallel.distributed import ClusterJobRunner
    runner = ClusterJobRunner(work_dir, host_id)
    barrier.wait()
    q.put((host_id, runner.claim(0)))


def gloo_rank(rank, world, store, cases, out_dir):
    """One rank of a gloo process group on the CPU: every sharded case,
    each rank's outputs written to out_dir/rank<r>.npz.

    cases: {"ba": {name: (shard fields, BAOptions fields, shard_pts,
    num_points)}, "ra": (num_images, edges, rel_rot, RAOptions fields,
    D), "match": (descriptors, masks, pairs, D)}."""
    import torch
    import torch.distributed as tdist

    from dagsfm_tpu_torch import interop
    from dagsfm_tpu_torch.estimation import rotation_averaging as ra
    from dagsfm_tpu_torch.parallel import ba_sharded
    from dagsfm_tpu_torch.parallel.matching_sharded import \
        match_pairs_sharded
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{store}",
                             world_size=world, rank=rank)
    out = {}
    try:
        for name, (fields, opts, shard_pts, n) in cases["ba"].items():
            prob = interop.sharded_problem(fields, device="cpu")
            res, st = ba_sharded.solve_sharded(prob, ba.BAOptions(**opts))
            out[f"{name}.qvec"] = res.image_qvec.numpy()
            out[f"{name}.tvec"] = res.image_tvec.numpy()
            out[f"{name}.cam_params"] = res.cam_params.numpy()
            out[f"{name}.points"] = ba_sharded.gather_points(res, shard_pts,
                                                             n)
            out[f"{name}.cost"] = np.array([st.initial_cost, st.final_cost])
        num_images, edges, rel_rot, ra_opts, D = cases["ra"]
        out["ra"] = ra.estimate_rotations_sharded(
            num_images, edges, rel_rot, ra.RAOptions(**ra_opts),
            num_shards=D, device="cpu")
        descs, masks, pairs, D = cases["match"]
        for p, m in match_pairs_sharded(descs, masks, pairs, num_shards=D,
                                        device="cpu").items():
            out[f"match.{p[0]}.{p[1]}"] = m
    finally:
        tdist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
