"""Robust global rotation averaging: L1 then IRLS over a matrix-free CG.

Port of dagsfm_tpu/estimation/rotation_averaging.py, with its
edge-sharded solve over torch.distributed. Spanning-tree initialisation
on the host, then on the device a fixed number of L1 and IRLS steps,
each solving the graph Laplacian system (L ⊗ I₃) dω = b by 50
Jacobi-preconditioned CG steps whose mat-vec is segment sums over the
edge list. Every sum adds its terms in edge order
(`ops/segment_sum`), so a run repeats to the bit on the
card. Clamps, the 1e8 gauge pin on node 0 and the final re-anchor are
the reference's.

Convention (COLMAP): R_j = R_ij @ R_i with world-to-camera rotations.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.ops import rotations as rops
from dagsfm_tpu_torch.parallel.mesh import (all_reduce, own_shards,
                                            process_group)
from dagsfm_tpu_torch.ops.segment_sum import segment_sum, segments


class RAOptions(NamedTuple):
    l1_iterations: int = 10
    irls_iterations: int = 100
    cg_iterations: int = 50
    sigma_deg: float = 5.0


def spanning_tree_init(num_images: int, edges: np.ndarray,
                       rel_rot: np.ndarray) -> np.ndarray:
    """Initial global rotations (I, 3, 3) composed along a depth-first
    spanning tree from node 0; edges (E, 2), rel_rot (E, 3, 3) with
    R_j = R_ij R_i."""
    adj: dict[int, list] = {}
    for e, (i, j) in enumerate(edges):
        adj.setdefault(int(i), []).append((int(j), e, False))
        adj.setdefault(int(j), []).append((int(i), e, True))
    R = np.tile(np.eye(3), (num_images, 1, 1))
    seen = {0}
    stack = [0]
    while stack:
        i = stack.pop()
        for (j, e, inv) in adj.get(i, ()):
            if j in seen:
                continue
            seen.add(j)
            Rij = rel_rot[e].T if inv else rel_rot[e]
            R[j] = Rij @ R[i]
            stack.append(j)
    return R


def _solve_ra(R_init: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              rel_rot: torch.Tensor, opts: RAOptions, seg_both, seg_diff,
              emask: torch.Tensor | None = None) -> torch.Tensor:
    """L1 then IRLS from R_init over the edges (src, dst). seg_both(v)
    and seg_diff(v) are the (I, ...) sums over the whole edge list of v
    at both endpoints, and of v at src minus v at dst; emask (E,) zeroes
    the weights of padded edges."""
    I = R_init.shape[0]
    q = rops.rotmat_to_quat(R_init)
    q_rel = rops.rotmat_to_quat(rel_rot)

    def residuals(q):
        # body-frame residual e = log(R_j^T M_ij R_i): with R_k <- R_k
        # exp(d_k), e' = e + d_i - d_j to first order
        q_err = rops.quat_multiply(rops.quat_conjugate(q[dst]),
                                   rops.quat_multiply(q_rel, q[src]))
        return rops.quat_to_angleaxis(q_err)

    def cg_solve(w, b):
        """(L ⊗ I3) x = b with L the weighted Laplacian, node 0 pinned."""
        deg = seg_both(w)
        deg[0] += 1e8
        Minv = (1.0 / torch.clamp(deg, min=1e-12))[:, None]

        def matvec(x):
            out = seg_diff(w[:, None] * (x[src] - x[dst]))
            out[0] += 1e8 * x[0]
            return out

        x = torch.zeros((I, 3), dtype=b.dtype, device=b.device)
        r = b
        z = r * Minv
        p = z
        rz = torch.sum(r * z)
        for _ in range(opts.cg_iterations):
            Ap = matvec(p)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-18)
            x = x + alpha * p
            r = r - alpha * Ap
            z = r * Minv
            rz_new = torch.sum(r * z)
            p = z + rz_new / torch.clamp(rz, min=1e-18) * p
            rz = rz_new
        return x

    def step(q, w):
        b = -seg_diff(w[:, None] * residuals(q))
        dq = rops.angleaxis_to_quat(cg_solve(w, b))
        return rops.quat_normalize(rops.quat_multiply(q, dq))

    def masked(w):
        return w if emask is None else emask * w

    for _ in range(opts.l1_iterations):
        nrm = torch.linalg.norm(residuals(q), dim=-1)
        q = step(q, masked(1.0 / torch.clamp(nrm, min=1e-5)))
    sigma2 = float(np.radians(opts.sigma_deg)) ** 2
    for _ in range(opts.irls_iterations):
        e = residuals(q)
        q = step(q, masked((sigma2 / (torch.sum(e * e, -1) + sigma2)) ** 2))
    return rops.quat_to_rotmat(q)


def _solve_ra_local(R_init: torch.Tensor, edges: np.ndarray,
                    rel_rot: torch.Tensor, opts: RAOptions) -> torch.Tensor:
    """`_solve_ra` over the whole edge list in this process: every sum
    adds its terms in edge order."""
    I, dev = R_init.shape[0], R_init.device
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    by_src = segments(edges[:, 0], I, dev)
    by_dst = segments(edges[:, 1], I, dev)
    return _solve_ra(
        R_init, torch.as_tensor(edges[:, 0], device=dev),
        torch.as_tensor(edges[:, 1], device=dev), rel_rot, opts,
        lambda v: segment_sum(v, by_src) + segment_sum(v, by_dst),
        lambda v: segment_sum(v, by_src) + segment_sum(-v, by_dst))


def _reanchored(R: torch.Tensor) -> np.ndarray:
    """R_k @ R_0ᵀ for every k (R[0] becomes the identity gauge)."""
    R = R.cpu().numpy()
    return np.einsum("nij,kj->nik", R, R[0])


def estimate_rotations(num_images: int, edges: np.ndarray,
                       rel_rot: np.ndarray, opts: RAOptions = RAOptions(),
                       device=None) -> np.ndarray:
    """Spanning-tree init, then L1 and IRLS refinement on `device` (the
    GPU unless told "cpu"). edges (E, 2) indices into [0, num_images),
    rel_rot (E, 3, 3). Returns (I, 3, 3) with R[0] the identity gauge."""
    dev = devmod.resolve(device)
    R0 = spanning_tree_init(num_images, edges, rel_rot)
    return _reanchored(_solve_ra_local(devmod.as_tensor(R0, dev), edges,
                                       devmod.as_tensor(rel_rot, dev), opts))


def estimate_rotations_nonlinear(num_images: int, edges: np.ndarray,
                                 rel_rot: np.ndarray,
                                 init: np.ndarray | None = None,
                                 iterations: int = 30,
                                 device=None) -> np.ndarray:
    """Gauss-Newton rotation refinement with unit weights: the IRLS loop
    with the robust weight turned off (sigma -> inf), on `device`."""
    dev = devmod.resolve(device)
    if init is None:
        init = spanning_tree_init(num_images, edges, rel_rot)
    opts = RAOptions(l1_iterations=0, irls_iterations=iterations,
                     sigma_deg=1e9)
    return _reanchored(_solve_ra_local(devmod.as_tensor(init, dev), edges,
                                       devmod.as_tensor(rel_rot, dev), opts))


def estimate_rotations_sharded(num_images: int, edges: np.ndarray,
                               rel_rot: np.ndarray,
                               opts: RAOptions = RAOptions(),
                               num_shards: int | None = None,
                               device=None) -> np.ndarray:
    """Rotation averaging with the edges cut into `num_shards` shards
    (default: one per rank), on `device` (the GPU unless "cpu" is asked).

    The algorithm of estimate_rotations: the spanning-tree start (the
    same on every rank), then L1 and IRLS. The edges are padded to a
    multiple of D with masked identity edges on image 0 and cut into D
    contiguous shards, shard d on rank d % W; every graph sum adds both
    endpoints' terms in one segment sum over the rank's edges and makes
    one all_reduce, as the reference's psum_seg_diff / psum_seg_both.
    Returns (I, 3, 3) with R[0] the identity gauge."""
    dev = devmod.resolve(device)
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    rel_rot = np.asarray(rel_rot, np.float64)
    D = num_shards or process_group()[2]
    E = len(edges)
    pad = (-E) % D
    edges_p = np.concatenate([edges, np.zeros((pad, 2), np.int64)])
    rel_p = np.concatenate([rel_rot, np.tile(np.eye(3), (pad, 1, 1))])
    emask = np.concatenate([np.ones(E), np.zeros(pad)])
    Ed = (E + pad) // D
    rows = np.concatenate([np.arange(d * Ed, (d + 1) * Ed)
                           for d in own_shards(D)] or [np.zeros(0, int)])
    src, dst = edges_p[rows, 0], edges_p[rows, 1]
    by_both = segments(np.concatenate([src, dst]), num_images, dev)

    def seg_both(v):
        return all_reduce(segment_sum(torch.cat([v, v]), by_both))

    def seg_diff(v):
        return all_reduce(segment_sum(torch.cat([v, -v]), by_both))

    R0 = spanning_tree_init(num_images, edges, rel_rot)
    return _reanchored(_solve_ra(
        devmod.as_tensor(R0, dev), torch.as_tensor(src, device=dev),
        torch.as_tensor(dst, device=dev), devmod.as_tensor(rel_p[rows], dev),
        opts, seg_both, seg_diff, devmod.as_tensor(emask[rows], dev)))


def align_rotations(estimated: np.ndarray,
                    reference: np.ndarray) -> np.ndarray:
    """`estimated` rotated onto `reference` by one world rotation S (the
    chordal L2 mean: S = proj_SO3(Σ R_estᵀ R_ref)); returns R_est @ S."""
    est = np.asarray(estimated, float)
    ref = np.asarray(reference, float)
    M = np.einsum("kji,kjl->il", est, ref)
    U, _, Vt = np.linalg.svd(M)
    S = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    return np.einsum("kij,jl->kil", est, S)


def filter_pairs_from_orientation(edges: np.ndarray, rel_rot: np.ndarray,
                                  global_R: np.ndarray,
                                  max_angle_deg: float = 5.0,
                                  device=None) -> np.ndarray:
    """Keep mask (E,) of the pairs whose relative rotation lies within
    max_angle_deg of the averaged global rotations', in one call on
    `device`."""
    dev = devmod.resolve(device)
    e = torch.as_tensor(np.asarray(edges, np.int64), device=dev)
    R = devmod.as_tensor(global_R, dev)
    Ri, Rj = R[e[:, 0]], R[e[:, 1]]
    ang = rops.rotation_angle_deg(devmod.as_tensor(rel_rot, dev),
                                  Rj @ Ri.transpose(-1, -2))
    return (ang < max_angle_deg).cpu().numpy()
