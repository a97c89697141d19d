"""Batched multi-view DLT triangulation.

Port of dagsfm_tpu/ops/triangulation.py. Ragged tracks are fixed-width
padded blocks with a mask, so thousands of points triangulate in one
batched eigendecomposition.
"""

from __future__ import annotations

import numpy as np
import torch

from dagsfm_tpu_torch.ops import rotations as rops


def _proj_matrices(qvec, tvec):
    """(..., 4) wxyz + (..., 3) -> (..., 3, 4) [R|t]."""
    return torch.cat([rops.quat_to_rotmat(qvec), tvec[..., :, None]], dim=-1)


def triangulate_dlt(qvecs: torch.Tensor, tvecs: torch.Tensor,
                    uvs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Multi-view DLT, batched over leading dims.

    qvecs (..., K, 4), tvecs (..., K, 3) world->cam; uvs (..., K, 2)
    normalized coords; mask (..., K). Returns xyz (..., 3): the smallest
    eigenvector of the 4x4 AᵀA, invalid rows zero-weighted.
    """
    P = _proj_matrices(qvecs, tvecs)                     # (..., K, 3, 4)
    u = uvs[..., 0:1]
    v = uvs[..., 1:2]
    r1 = u * P[..., 2, :] - P[..., 0, :]                  # (..., K, 4)
    r2 = v * P[..., 2, :] - P[..., 1, :]
    A = torch.cat([r1, r2], dim=-2)                       # (..., 2K, 4)
    w = torch.cat([mask, mask], dim=-1).to(A.dtype)
    AtA = (A * w[..., :, None]).transpose(-1, -2) @ A      # (..., 4, 4)
    _, evecs = torch.linalg.eigh(AtA)
    X = evecs[..., :, 0]
    wc = X[..., 3]
    wc = torch.where(torch.abs(wc) < 1e-12, torch.full_like(wc, 1e-12), wc)
    return X[..., :3] / wc[..., None]


# triangulate_dlt batches over its leading dims already: (B, K, ...) in,
# (B, 3) out, as the reference's vmap of its one-track DLT
triangulate_dlt_batch = triangulate_dlt


def triangulate_two_view(qvec1, tvec1, qvec2, tvec2, uv1, uv2):
    """Batched two-view DLT: (..., 2) normalized coords -> (..., 3)."""
    qvecs = torch.stack([qvec1, qvec2], dim=-2)
    tvecs = torch.stack([tvec1, tvec2], dim=-2)
    uvs = torch.stack([uv1, uv2], dim=-2)
    mask = torch.ones(qvecs.shape[:-1], dtype=torch.bool, device=qvecs.device)
    return triangulate_dlt(qvecs, tvecs, uvs, mask)


def track_blocks_from_obs(obs_image, obs_point, obs_uv, obs_mask,
                          num_points: int, max_track_len: int):
    """Host helper: flat observations -> (P, T) padded track blocks.

    Returns (track_img (P,T) int32, track_uv (P,T,2), track_mask (P,T)).
    """
    obs_image = np.asarray(obs_image)
    obs_point = np.asarray(obs_point)
    obs_uv = np.asarray(obs_uv)
    obs_mask = np.asarray(obs_mask)
    track_img = np.zeros((num_points, max_track_len), np.int32)
    track_uv = np.zeros((num_points, max_track_len, 2), obs_uv.dtype)
    track_mask = np.zeros((num_points, max_track_len), bool)
    fill = np.zeros(num_points, np.int32)
    for n in np.nonzero(obs_mask)[0]:
        p = obs_point[n]
        k = fill[p]
        if k < max_track_len:
            track_img[p, k] = obs_image[n]
            track_uv[p, k] = obs_uv[n]
            track_mask[p, k] = True
            fill[p] = k + 1
    return track_img, track_uv, track_mask


def triangulate_tracks(image_qvec, image_tvec, track_img, track_uv,
                       track_mask):
    """Triangulate all padded tracks at once: (P, T, ...) -> (P, 3)."""
    return triangulate_dlt(image_qvec[track_img], image_tvec[track_img],
                           track_uv, track_mask)
