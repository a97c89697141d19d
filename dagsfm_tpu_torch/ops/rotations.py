"""Batched rotation algebra: quaternions, angle-axis, rotation matrices.

Port of dagsfm_tpu/ops/rotations.py. Conventions (COLMAP):
quaternions are (w, x, y, z) with x_cam = R @ x_world + t; angle-axis
vectors are theta * n. Every function broadcasts over leading dims.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize along the last axis; a zero quaternion -> identity."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    small = n < _EPS
    q = q / torch.where(small, torch.ones_like(n), n)
    ident = torch.zeros_like(q)
    ident[..., 0] = 1.0
    return torch.where(small, ident, q)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3)."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz,
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz, branch-free Shepperd (all four
    candidates, the best-conditioned one selected), w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)            # (..., 4, 4)
    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    scales = 2.0 * torch.sqrt(torch.clamp(mags, min=0.0))
    best = torch.argmax(mags, dim=-1, keepdim=True)          # (..., 1)
    q = torch.gather(cands, -2,
                     best[..., None].expand(best.shape + (4,)))[..., 0, :]
    s = torch.gather(scales, -1, best)
    q = q / torch.clamp(s, min=_EPS)
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2 (wxyz), broadcastable."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4)."""
    q = quat_normalize(q)
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    w = w.expand(u.shape[:-1] + (1,))
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def angleaxis_to_quat(aa: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(aa * aa, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(theta * 0.5))
    s = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(theta * 0.5) / theta)
    return torch.cat([w[..., None], aa * s[..., None]], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix [v]_x for (..., 3) vectors."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       dim=-1).reshape(v.shape[:-1] + (3, 3))


def angleaxis_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues with 2nd-order Taylor limits for tiny angles."""
    theta2 = torch.sum(aa * aa, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    s = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    c = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    K = skew(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + s[..., None, None] * K + c[..., None, None] * (K @ K)


def quat_to_angleaxis(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    sin_half = torch.linalg.norm(q[..., 1:], dim=-1)
    theta = 2.0 * torch.atan2(sin_half, w)
    small = sin_half < 1e-8
    scale = torch.where(small, torch.full_like(theta, 2.0),
                        theta / torch.clamp(sin_half, min=_EPS))
    return q[..., 1:] * scale[..., None]


def rotmat_to_angleaxis(R: torch.Tensor) -> torch.Tensor:
    return quat_to_angleaxis(rotmat_to_quat(R))


def angleaxis_rotate(aa: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by angle-axis aa (Rodrigues, no matrix); below
    theta^2 = 1e-8 the first-order v + aa x v."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    axis = aa / torch.where(small, torch.ones_like(theta), theta)
    cos_t = torch.where(small, 1.0 - theta2 / 2.0, torch.cos(theta))
    sin_t = torch.where(small, theta - theta2 * theta / 6.0,
                        torch.sin(theta))
    axis, v = torch.broadcast_tensors(axis, v)
    rot = v * cos_t + torch.linalg.cross(axis, v, dim=-1) * sin_t + \
        axis * torch.sum(axis * v, dim=-1, keepdim=True) * (1.0 - cos_t)
    aa_b = aa.expand(v.shape)
    return torch.where(small, v + torch.linalg.cross(aa_b, v, dim=-1), rot)


def rotation_angle_deg(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle in degrees between rotation matrices."""
    Rrel = R1.transpose(-1, -2) @ R2
    tr = Rrel.diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.rad2deg(torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)))


def relative_rotation(R_i: torch.Tensor, R_j: torch.Tensor) -> torch.Tensor:
    """R_ij such that R_j = R_ij @ R_i (world->cam rotations)."""
    return R_j @ R_i.transpose(-1, -2)


def project_to_rotmat(M: torch.Tensor) -> torch.Tensor:
    """The rotation closest to M (..., 3, 3): SVD with the determinant's
    sign on the last singular direction."""
    U, _, Vt = torch.linalg.svd(M)
    D = torch.ones(M.shape[:-2] + (3,), dtype=M.dtype, device=M.device)
    D[..., 2] = torch.sign(torch.linalg.det(U @ Vt))
    return (U * D[..., None, :]) @ Vt


def compose_pose(R1, t1, R2, t2):
    """World->cam poses composed: (R1, t1) first, then (R2, t2)."""
    return R2 @ R1, (R2 @ t1[..., None])[..., 0] + t2


def invert_pose(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def camera_center(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Projection center C = -R^T t for a world->cam pose."""
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


# ---------------------------------------------------------------------------
# NumPy twins for host-side bookkeeping
# ---------------------------------------------------------------------------

def quat_to_rotmat_np(q):
    """Vectorized numpy wxyz quaternion(s) -> rotation matrices."""
    q = np.asarray(q, np.float64)
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    q = q / np.where(n < 1e-12, 1.0, n)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = np.stack([
        ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz,
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat_np(R):
    """Vectorized numpy rotation matrix(es) -> wxyz quaternion(s)
    (Shepperd's method, stable for all traces)."""
    R = np.asarray(R, np.float64)
    single = R.ndim == 2
    Rb = R.reshape(-1, 3, 3)
    out = np.empty((len(Rb), 4))
    for k, m in enumerate(Rb):
        t = np.trace(m)
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                          (m[0, 2] - m[2, 0]) / s,
                          (m[1, 0] - m[0, 1]) / s])
        elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
            s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
            q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                          (m[0, 1] + m[1, 0]) / s,
                          (m[0, 2] + m[2, 0]) / s])
        elif m[1, 1] > m[2, 2]:
            s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
            q = np.array([(m[0, 2] - m[2, 0]) / s,
                          (m[0, 1] + m[1, 0]) / s, 0.25 * s,
                          (m[1, 2] + m[2, 1]) / s])
        else:
            s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
            q = np.array([(m[1, 0] - m[0, 1]) / s,
                          (m[0, 2] + m[2, 0]) / s,
                          (m[1, 2] + m[2, 1]) / s, 0.25 * s])
        out[k] = q if q[0] >= 0 else -q
    out /= np.linalg.norm(out, axis=-1, keepdims=True)
    return out[0] if single else out.reshape(R.shape[:-2] + (4,))
