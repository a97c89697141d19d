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
    D), "match": (descriptors, masks, pairs, D)}. Each BA case also
    writes its root span's counters."""
    import torch
    import torch.distributed as tdist

    from dagsfm_tpu_torch import interop
    from dagsfm_tpu_torch.estimation import rotation_averaging as ra
    from dagsfm_tpu_torch.parallel import ba_sharded
    from dagsfm_tpu_torch.parallel.matching_sharded import \
        match_pairs_sharded
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
    from dagsfm_tpu_torch.utils import observability as obs

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{store}",
                             world_size=world, rank=rank)
    out = {}
    try:
        for name, (fields, opts, shard_pts, n) in cases["ba"].items():
            prob = interop.sharded_problem(fields, device="cpu")
            res, st = ba_sharded.solve_sharded(prob, ba.BAOptions(**opts))
            root = obs.roots()[-1]
            assert root["name"] == "ba.sharded.solve"
            for k in ("lm_steps", "cg_iterations", "allreduce",
                      "allreduce_bytes"):
                out[f"{name}.{k}"] = np.array(root["counters"].get(k, 0))
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


def sharded_scene(device):
    """A 12-image SIMPLE_RADIAL scene, focal +8 % and k1 = 0.03 off, its
    poses turned by 0.01 rad and points moved by 0.05 (the first two
    images kept), drawn alike on every device; and its refine mask
    (focal and extra)."""
    import torch

    from dagsfm_tpu_torch.ops import rotations as rops
    from dagsfm_tpu_torch.scene import cameras as cm
    from dagsfm_tpu_torch.scene import synthetic as syn
    sc = syn.generate(syn.SyntheticSceneSpec(
        num_cameras=12, num_points=250, pixel_noise=0.5, seed=11,
        camera_model="SIMPLE_RADIAL"))
    arrays = syn.to_scene_arrays(sc, device)
    rng = np.random.default_rng(4)
    dq = rops.angleaxis_to_quat(torch.as_tensor(
        rng.normal(0, 0.01, (12, 3)), device=device))
    q = rops.quat_multiply(dq, arrays.image_qvec)
    q[:2] = arrays.image_qvec[:2]
    cp = arrays.cam_params.clone()
    cp[0, 0] *= 1.08
    cp[0, 3] = 0.03
    refine = cm.intrinsics_refine_mask(arrays.cam_model_id.cpu().numpy(),
                                       True, False, True)
    return arrays._replace(
        image_qvec=q, cam_params=cp,
        points_xyz=arrays.points_xyz + torch.as_tensor(rng.normal(
            0, 0.05, tuple(arrays.points_xyz.shape)), device=device)), refine


SHARDED_OPTIONS = dict(max_iterations=4, refine_focal=True, refine_extra=True,
                       loss_scale=2.0)


def sharded_solve(device, num_shards=8):
    """`sharded_scene` cut into num_shards and solved on the process group
    (none: this process alone): the gathered results and the root's
    counters."""
    from dagsfm_tpu_torch.parallel import ba_sharded
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
    from dagsfm_tpu_torch.utils import observability as obs

    arrays, refine = sharded_scene(device)
    prob, pts = ba_sharded.shard_problem(arrays, num_shards,
                                         cam_refine=refine, device=device)
    res, st = ba_sharded.solve_sharded(prob, ba.BAOptions(**SHARDED_OPTIONS))
    root = [r for r in obs.roots() if r["name"] == "ba.sharded.solve"][-1]
    return dict(qvec=res.image_qvec.cpu().numpy(),
                tvec=res.image_tvec.cpu().numpy(),
                cam_params=res.cam_params.cpu().numpy(),
                points=ba_sharded.gather_points(res, pts,
                                                arrays.points_xyz.shape[0]),
                cost=np.array([st.initial_cost, st.final_cost]),
                cg=np.array(st.cg_iterations),
                allreduce=np.array(root["counters"].get("allreduce", 0)))


def nccl_rank(rank, world, address, out_dir):
    """One rank of an NCCL process group, one card each
    (parallel.mesh.init_ranks): `sharded_solve` on its card, written to
    out_dir/rank<r>.npz with the rank's device."""
    import torch.distributed as tdist

    from dagsfm_tpu_torch.parallel import mesh
    dev = mesh.init_ranks(rank, world, address, timeout_s=120)
    try:
        out = sharded_solve(dev)
        out["device"] = np.array(str(dev))
        out["backend"] = np.array(tdist.get_backend())
    finally:
        tdist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
