"""Two-view epipolar geometry: E/F/H solvers, residuals, pose from E.

Port of dagsfm_tpu/ops/epipolar.py. Points are normalized image
coordinates for E, pixels for F and H (Hartley-normalized inside). Every
function broadcasts over leading batch dims: where the reference vmaps
one minimal problem, the port writes the (pairs, hypotheses) batch out as
dimensions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dagsfm_tpu_torch.ops import polynomials as poly
from dagsfm_tpu_torch.ops import solve as lin


def _epipolar_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) pairs -> (..., N, 9) rows of x2ᵀ F x1 = 0."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                        u1, v1, one], dim=-1)


def _smallest_eigvec(AtA: torch.Tensor) -> torch.Tensor:
    _, V = torch.linalg.eigh(AtA)
    return V[..., :, 0]


def _nullspace_k(A: torch.Tensor, k: int) -> torch.Tensor:
    """k-dim nullspace basis of A (..., rows, 9): complete QR of Aᵀ for
    exact minimal systems, else the k smallest eigenvectors of AᵀA."""
    if A.shape[-2] + k == A.shape[-1]:
        Q, _ = torch.linalg.qr(A.transpose(-1, -2), mode="complete")
        return Q[..., A.shape[-2]:]
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return V[..., :, :k]


def essential_8pt(x1: torch.Tensor, x2: torch.Tensor, mask=None):
    """E from >= 8 correspondences (..., N, 2), projected onto the
    essential manifold. Returns (E (..., 1, 3, 3), valid (..., 1))."""
    A = _epipolar_rows(x1, x2)
    if mask is not None:
        A = A * mask.to(A.dtype)[..., :, None]
    e = _smallest_eigvec(A.transpose(-1, -2) @ A)
    E = e.reshape(e.shape[:-1] + (3, 3))
    U, S, Vt = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    keep = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    E = (U * keep * s[..., None, None]) @ Vt
    valid = torch.ones(E.shape[:-2] + (1,), dtype=torch.bool, device=E.device)
    return E[..., None, :, :], valid


# Monomials in (x, y, z) of degree <= 3: the 10 eliminated (A group)
# then the 10 kept (B group), as in the reference.
def _np_monomials(x, y, z):
    return np.array([
        x ** 3, y ** 3, x * x * y, x * y * y, x * x * z, y * y * z,
        x * y * z, x * x, y * y, x * y,
        x * z * z, x * z, x, y * z * z, y * z, y,
        z ** 3, z * z, z, 1.0,
    ])


_SAMPLES = np.random.default_rng(1234).uniform(-1.5, 1.5, size=(20, 3))
_V_INV = np.linalg.inv(np.stack([_np_monomials(*p) for p in _SAMPLES]))


def _essential_constraints(E: torch.Tensor) -> torch.Tensor:
    """det(E) and 2 E Eᵀ E - trace(E Eᵀ) E (Nistér Eq. 2-3): (..., 10)."""
    detE = torch.linalg.det(E)
    EEt = E @ E.transpose(-1, -2)
    tr = EEt.diagonal(dim1=-2, dim2=-1).sum(-1)
    T = 2.0 * (EEt @ E) - tr[..., None, None] * E
    return torch.cat([detE[..., None], T.reshape(T.shape[:-2] + (9,))],
                     dim=-1)


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched full polynomial product (numpy.convolve on the last axis)."""
    la, lb = a.shape[-1], b.shape[-1]
    out = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
                      + (la + lb - 1,), dtype=a.dtype, device=a.device)
    for i in range(la):
        out[..., i:i + lb] += a[..., i:i + 1] * b
    return out


def essential_5pt(x1: torch.Tensor, x2: torch.Tensor, max_solutions: int = 10):
    """Nistér 5-point solver on (..., 5, 2) samples.

    4-dim nullspace -> the 10 cubic constraints by interpolation at 20
    fixed samples -> Gauss-Jordan -> degree-10 det polynomial -> real
    roots -> back-substitution. Returns (E (..., 10, 3, 3), valid (..., 10)).
    """
    A = _epipolar_rows(x1, x2)                              # (..., 5, 9)
    N4 = _nullspace_k(A, 4)                                 # (..., 9, 4)
    bshape = N4.shape[:-2]
    X = N4[..., :, 0].reshape(bshape + (3, 3))
    Y = N4[..., :, 1].reshape(bshape + (3, 3))
    Z = N4[..., :, 2].reshape(bshape + (3, 3))
    W = N4[..., :, 3].reshape(bshape + (3, 3))

    smp = torch.as_tensor(_SAMPLES, dtype=A.dtype, device=A.device)
    Es = (smp[:, 0, None, None] * X[..., None, :, :]
          + smp[:, 1, None, None] * Y[..., None, :, :]
          + smp[:, 2, None, None] * Z[..., None, :, :]
          + W[..., None, :, :])                             # (..., 20, 3, 3)
    F_vals = _essential_constraints(Es)                     # (..., 20, 10)
    Vinv = torch.as_tensor(_V_INV, dtype=A.dtype, device=A.device)
    M = (Vinv @ F_vals).transpose(-1, -2)                   # (..., 10, 20)
    C = lin.solve_or_nan(M[..., :10], M[..., 10:])          # (..., 10, 10)

    def _shift_mul_z(c):
        z0 = torch.zeros_like(c[..., :1])
        return (torch.cat([c[..., 0:3], z0], -1),
                torch.cat([c[..., 3:6], z0], -1),
                torch.cat([c[..., 6:10], z0], -1))

    def _plain(c):
        z0 = torch.zeros_like(c[..., :1])
        return (torch.cat([z0, c[..., 0:3]], -1),
                torch.cat([z0, c[..., 3:6]], -1),
                torch.cat([z0, c[..., 6:10]], -1))

    B_rows = []
    for sq_row, zz_row in ((7, 4), (8, 5), (9, 6)):
        a1, a2, a3 = _shift_mul_z(C[..., sq_row, :])
        b1, b2, b3 = _plain(C[..., zz_row, :])
        B_rows.append((a1 - b1, a2 - b2, a3 - b3))
    (p11, p12, p13), (p21, p22, p23), (p31, p32, p33) = B_rows
    m11 = _conv(p22, p33) - _conv(p23, p32)
    m12 = _conv(p21, p33) - _conv(p23, p31)
    m13 = _conv(p21, p32) - _conv(p22, p31)
    det = _conv(p11, m11) - _conv(p12, m12) + _conv(p13, m13)  # (..., 11)

    roots, valid = poly.real_roots_sturm(det, max_roots=max_solutions)

    def pv(p):
        return poly.polyval(p[..., None, :], roots)         # (..., R)

    a00, a01, a10, a11 = pv(p11), pv(p12), pv(p21), pv(p22)
    b0, b1 = -pv(p13), -pv(p23)
    det2 = a00 * a11 - a01 * a10
    det2 = torch.where(torch.abs(det2) < 1e-20, torch.full_like(det2, 1e-20),
                       det2)
    xs = (b0 * a11 - b1 * a01) / det2
    ys = (a00 * b1 - a10 * b0) / det2
    Emods = (xs[..., None, None] * X[..., None, :, :]
             + ys[..., None, None] * Y[..., None, :, :]
             + roots[..., None, None] * Z[..., None, :, :]
             + W[..., None, :, :])                          # (..., R, 3, 3)
    norm = torch.linalg.norm(Emods.flatten(-2), dim=-1)
    Emods = Emods / torch.clamp(norm, min=1e-12)[..., None, None]
    return Emods, valid


def _hartley_normalize(pts: torch.Tensor, mask=None):
    """Center (..., N, 2) points and scale them to mean distance sqrt(2)
    (over the masked points). Returns (pts, T (..., 3, 3))."""
    w = (torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
         if mask is None else mask.to(pts.dtype))
    wsum = torch.clamp(w.sum(-1), min=1e-12)
    mean = (pts * w[..., None]).sum(-2) / wsum[..., None]
    centered = pts - mean[..., None, :]
    dist = torch.sqrt(torch.sum(centered ** 2, dim=-1))
    mean_dist = (dist * w).sum(-1) / wsum
    s = math.sqrt(2.0) / torch.clamp(mean_dist, min=1e-12)
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype,
                    device=pts.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 2, 2] = 1.0
    T[..., 0, 2] = -s * mean[..., 0]
    T[..., 1, 2] = -s * mean[..., 1]
    return centered * s[..., None, None], T


def fundamental_8pt(x1: torch.Tensor, x2: torch.Tensor, mask=None):
    """F from >= 8 pixel correspondences (..., N, 2), Hartley-normalized,
    projected to rank 2, scaled to |F[2, 2]| = 1. Returns (F (..., 1, 3,
    3), valid (..., 1))."""
    n1, T1 = _hartley_normalize(x1, mask)
    n2, T2 = _hartley_normalize(x2, mask)
    A = _epipolar_rows(n1, n2)
    if mask is not None:
        A = A * mask.to(A.dtype)[..., :, None]
    f = _smallest_eigvec(A.transpose(-1, -2) @ A)
    F = f.reshape(f.shape[:-1] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = (U * S[..., None, :]) @ Vt
    F = T2.transpose(-1, -2) @ F @ T1
    F = F / torch.clamp(torch.abs(F[..., 2:3, 2:3]), min=1e-12)
    valid = torch.ones(F.shape[:-2] + (1,), dtype=torch.bool, device=F.device)
    return F[..., None, :, :], valid


def fundamental_7pt(x1: torch.Tensor, x2: torch.Tensor):
    """F from exactly 7 correspondences (..., 7, 2): the roots of the
    cubic det(l F1 + F2) = 0 over the 2-dim nullspace. Returns (F (..., 3,
    3, 3), valid (..., 3))."""
    A = _epipolar_rows(x1, x2)
    N2 = _nullspace_k(A, 2)
    F1 = N2[..., :, 0].reshape(N2.shape[:-2] + (3, 3))
    F2 = N2[..., :, 1].reshape(N2.shape[:-2] + (3, 3))
    ls = torch.tensor([-1.0, 0.0, 1.0, 2.0], dtype=A.dtype, device=A.device)
    vals = torch.linalg.det(ls[:, None, None] * F1[..., None, :, :]
                            + F2[..., None, :, :])          # (..., 4)
    V = torch.stack([ls ** 3, ls ** 2, ls, torch.ones_like(ls)], dim=-1)
    coeffs = torch.linalg.solve(V, vals[..., None])[..., 0]
    lam, lvalid = poly.solve_cubic_all(coeffs[..., 0], coeffs[..., 1],
                                       coeffs[..., 2], coeffs[..., 3])
    Fs = lam[..., None, None] * F1[..., None, :, :] + F2[..., None, :, :]
    norm = torch.linalg.norm(Fs.flatten(-2), dim=-1)
    return Fs / torch.clamp(norm, min=1e-12)[..., None, None], lvalid


def essential_from_fundamental(F, K1, K2):
    """E = K2ᵀ F K1."""
    return K2.transpose(-1, -2) @ F @ K1


def fundamental_from_essential(E, K1, K2):
    return torch.linalg.inv(K2.transpose(-1, -2)) @ E @ torch.linalg.inv(K1)


def homography_dlt(x1: torch.Tensor, x2: torch.Tensor, mask=None):
    """H (x2 ~ H x1) from >= 4 correspondences (..., N, 2): the exact
    nullspace of the minimal 8 x 9 system, or the least-squares solution
    over the masked points. Returns (H (..., 1, 3, 3), valid (..., 1))."""
    n1, T1 = _hartley_normalize(x1, mask)
    n2, T2 = _hartley_normalize(x2, mask)
    u1, v1 = n1[..., 0], n1[..., 1]
    u2, v2 = n2[..., 0], n2[..., 1]
    zero = torch.zeros_like(u1)
    one = torch.ones_like(u1)
    r1 = torch.stack([-u1, -v1, -one, zero, zero, zero,
                      u1 * u2, v1 * u2, u2], dim=-1)
    r2 = torch.stack([zero, zero, zero, -u1, -v1, -one,
                      u1 * v2, v1 * v2, v2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    if mask is not None:
        m2 = torch.cat([mask, mask], dim=-1).to(A.dtype)
        A = A * m2[..., :, None]
        h = _smallest_eigvec(A.transpose(-1, -2) @ A)
    else:
        h = _nullspace_k(A, 1)[..., 0]
    H = h.reshape(h.shape[:-1] + (3, 3))
    H = torch.linalg.inv(T2) @ H @ T1
    h22 = H[..., 2:3, 2:3]
    H = H / torch.where(torch.abs(h22) < 1e-12, torch.full_like(h22, 1e-12),
                        h22)
    valid = torch.ones(H.shape[:-2] + (1,), dtype=torch.bool, device=H.device)
    return H[..., None, :, :], valid


def sampson_error(F: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance. F (..., 3, 3); x1, x2 (..., N, 2);
    leading dims broadcast. Returns (..., N)."""
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    Fx1 = p1 @ F.transpose(-1, -2)
    Ftx2 = p2 @ F
    num = torch.sum(p2 * Fx1, dim=-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2
           + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-18)


def epipolar_line_error(F, x1, x2):
    """Squared point-to-epipolar-line distance in image 2."""
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    l2 = p1 @ F.transpose(-1, -2)
    num = torch.sum(p2 * l2, dim=-1) ** 2
    den = l2[..., 0] ** 2 + l2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-18)


def homography_error(H, x1, x2):
    """Squared transfer error |x2 - H x1|². H (..., 3, 3); x1, x2 (..., N,
    2); leading dims broadcast. Returns (..., N)."""
    ones = torch.ones_like(x1[..., :1])
    q = torch.cat([x1, ones], dim=-1) @ H.transpose(-1, -2)
    w = q[..., 2:]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return torch.sum((q[..., :2] / w - x2) ** 2, dim=-1)


def decompose_essential(E: torch.Tensor):
    """E (..., 3, 3) -> the four (R (..., 4, 3, 3), t (..., 4, 3))."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def _cheirality_counts(Rs, ts, x1, x2, mask):
    """Points with positive depth in both views per (R, t) candidate,
    from the closed-form 2x2 normal equations of z2 h2 = z1 R h1 + t.
    Rs (..., C, 3, 3), ts (..., C, 3); x1, x2 (..., N, 2); mask (..., N).
    Returns (..., C) counts."""
    ones = torch.ones_like(x1[..., :1])
    h1 = torch.cat([x1, ones], dim=-1)                     # (..., N, 3)
    h2 = torch.cat([x2, ones], dim=-1)
    a = h1[..., None, :, :] @ Rs.transpose(-1, -2)         # (..., C, N, 3)
    b = -h2[..., None, :, :]
    aa = torch.sum(a * a, dim=-1)
    ab = torch.sum(a * b, dim=-1)
    bb = torch.sum(b * b, dim=-1)
    at = torch.sum(a * (-ts[..., :, None, :]), dim=-1)
    bt = torch.sum(b * (-ts[..., :, None, :]), dim=-1)
    det = aa * bb - ab * ab
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    z1 = (at * bb - ab * bt) / det
    z2 = (aa * bt - ab * at) / det
    good = ((z1 > 1e-6) & (z2 > 1e-6) & (z1 < 1e3) & (z2 < 1e3)
            & mask[..., None, :])
    return torch.sum(good, dim=-1)


def pose_from_essential(E, x1, x2, mask):
    """The (R, t) candidate with the most points passing cheirality.
    Returns (R (..., 3, 3), t (..., 3), num_in_front (...))."""
    Rs, ts = decompose_essential(E)
    counts = _cheirality_counts(Rs, ts, x1, x2, mask)
    best = torch.argmax(counts, dim=-1)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(
        best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    return R, t, torch.gather(counts, -1, best[..., None])[..., 0]
