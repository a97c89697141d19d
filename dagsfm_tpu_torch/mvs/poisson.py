"""Poisson surface reconstruction on a dense grid, solved with FFTs.

Port of dagsfm_tpu/mvs/poisson.py: oriented points -> a watertight
iso-surface. The indicator function is solved spectrally on a regular
G^3 grid, on the device in float64 / complex128:

  1. splat the oriented normals and a unit density into a (G, G, G, 4)
     field (trilinear, 8 corners per point),
  2. Gaussian-smooth it, take the divergence and solve
     (Laplacian - screen) chi = div V in Fourier space (one fftn, one
     elementwise divide, one ifftn),
  3. iso level = the density-weighted mean of chi at the input points,
  4. marching tetrahedra (host numpy, the reference's code; 6 tets per
     cell) extract the triangle mesh at that level.

The reference's splat is a scatter-add (`.at[].add`); on the card a
scatter-add of floats is a set of atomics whose order, and so whose
bits, change from run to run. Here the splat sorts the corner
contributions by cell (a stable sort) and sums each cell's run in a
fixed order (`ops/segment_sum`), so two runs on
the same cloud give the same mesh bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.ops.segment_sum import segment_sum, segments


class PoissonOptions(NamedTuple):
    grid: int = 128          # G: grid cells per side
    padding: float = 0.1     # fraction of bbox added per side
    screen: float = 4.0      # screening weight (0 = pure Poisson)
    smooth_sigma: float = 1.0  # Gaussian pre-smoothing of V, in cells
    min_density: float = 0.05  # cells with splat density below this
    #                            fraction of the mean carry no surface


def _corners(pts: torch.Tensor, G: int):
    """For each of the 8 corners (dx, dy, dz) of the cells holding pts
    (N, 3), in the reference's order: (flat cell index (N,), trilinear
    weight (N,))."""
    i0 = torch.floor(pts).long()
    f = pts - i0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                idx = torch.clamp(i0 + torch.tensor(
                    [dx, dy, dz], device=pts.device), 0, G - 1)
                yield (idx[:, 0] * G + idx[:, 1]) * G + idx[:, 2], w


def _trilinear_scatter(grid_shape, pts, vals):
    """(G, G, G, C) grid of vals (N, C) splatted at fractional pts (N, 3):
    each cell sums its corner contributions in the reference's order
    (corner by corner, points in order), the same bits on every run."""
    G, C = grid_shape[0], grid_shape[-1]
    keys, parts = [], []
    for key, w in _corners(pts, G):
        keys.append(key)
        parts.append(vals * w[:, None])
    seg = segments(torch.cat(keys), G ** 3, pts.device)
    return segment_sum(torch.cat(parts), seg).reshape(G, G, G, C)


def _trilinear_sample(vol, pts):
    """Sample (G, G, G) vol at fractional pts (N, 3)."""
    G = vol.shape[0]
    flat = vol.reshape(-1)
    acc = 0.0
    for key, w in _corners(pts, G):
        acc = acc + w * flat[key]
    return acc


def _poisson_field(pts_g, normals, G: int, screen: float, sigma: float):
    """pts_g (N, 3) in grid coords and unit normals -> (chi (G, G, G),
    iso (0-d), smoothed density (G, G, G)), in float64 on their device."""
    field = _trilinear_scatter(
        (G, G, G, 4), pts_g, torch.cat([normals, torch.ones_like(
            normals[:, :1])], dim=1))
    V, density = field[..., :3], field[..., 3]

    # Gaussian smoothing of the splatted field in Fourier space
    k = torch.fft.fftfreq(G, dtype=torch.float64,
                          device=pts_g.device) * G   # integer frequencies
    kx, ky, kz = torch.meshgrid(k, k, k, indexing="ij")
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    gauss = torch.exp(-2.0 * (np.pi * sigma / G) ** 2 * k2)

    Vf = torch.fft.fftn(V, dim=(0, 1, 2)) * gauss[..., None]
    # divergence and Laplacian as spectral operators (unit cell size)
    two_pi_i = 2j * np.pi / G
    divf = two_pi_i * (kx * Vf[..., 0] + ky * Vf[..., 1] + kz * Vf[..., 2])
    lap = -(2 * np.pi / G) ** 2 * k2
    chif = divf / (lap - screen / (G * G))
    chi = torch.real(torch.fft.ifftn(chif, dim=(0, 1, 2)))

    dens_s = torch.real(torch.fft.ifftn(torch.fft.fftn(density) * gauss))
    w = _trilinear_sample(dens_s, pts_g)
    iso = torch.sum(_trilinear_sample(chi, pts_g) * w) / torch.clamp(
        torch.sum(w), min=1e-12)
    return chi, iso, dens_s


# marching-tetrahedra decomposition: 6 tets per cube sharing the main
# diagonal 0-7; corner index c = dx | dy<<1 | dz<<2. Each tet is
# (0, a, b, 7) where 0 -> a -> b -> 7 walks one axis permutation.
_TETS = np.array([
    [0, 1, 3, 7], [0, 1, 5, 7], [0, 2, 3, 7],
    [0, 2, 6, 7], [0, 4, 5, 7], [0, 4, 6, 7]], np.int32)
_CORNER = np.array([[x, y, z] for z in (0, 1) for y in (0, 1)
                    for x in (0, 1)], np.int32)  # corner bit = x|y<<1|z<<2


def _marching_tets(chi: np.ndarray, iso: float, mask: np.ndarray):
    """Triangulate the chi == iso surface (host numpy, vectorized).

    mask (G,G,G) bool: cells allowed to carry surface (density gate).
    Returns (verts (V,3) grid coords, tris (M,3) int)."""
    G = chi.shape[0]
    base = np.stack(np.meshgrid(np.arange(G - 1), np.arange(G - 1),
                                np.arange(G - 1), indexing="ij"),
                    axis=-1).reshape(-1, 3)                 # (C,3)
    cell_ok = mask[base[:, 0], base[:, 1], base[:, 2]]
    base = base[cell_ok]
    if len(base) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    # corner values/positions per cell
    cpos = base[:, None, :] + _CORNER[None]                 # (C,8,3)
    cval = chi[cpos[..., 0], cpos[..., 1], cpos[..., 2]] - iso

    verts = []
    tris = []
    vcount = 0
    for tet in _TETS:
        v = cval[:, tet]                                    # (C,4)
        p = cpos[:, tet].astype(np.float64)                 # (C,4,3)
        inside = v > 0
        code = (inside[:, 0].astype(int) | (inside[:, 1] << 1)
                | (inside[:, 2] << 2) | (inside[:, 3] << 3))

        def edge_pt(sel, a, b):
            va, vb = v[sel, a], v[sel, b]
            t = va / np.where(np.abs(va - vb) < 1e-30, 1e-30, va - vb)
            return p[sel, a] + t[:, None] * (p[sel, b] - p[sel, a])

        # single-corner cases (1 triangle) and two-corner cases (2)
        for c_in, flip in (((1,), False), ((2,), False), ((4,), False),
                           ((8,), False), ((14,), True), ((13,), True),
                           ((11,), True), ((7,), True)):
            cc = c_in[0]
            sel = np.nonzero(code == cc)[0]
            if not len(sel):
                continue
            corner = int(np.log2(cc if not flip else (15 ^ cc)))
            others = [i for i in range(4) if i != corner]
            pa = edge_pt(sel, corner, others[0])
            pb = edge_pt(sel, corner, others[1])
            pc = edge_pt(sel, corner, others[2])
            tri_v = np.stack([pa, pb, pc], axis=1)          # (S,3,3)
            verts.append(tri_v.reshape(-1, 3))
            n = len(sel)
            tris.append(vcount + np.arange(3 * n).reshape(n, 3))
            vcount += 3 * n
        for ab in ((3,), (5,), (9,), (6,), (10,), (12,)):
            cc = ab[0]
            sel = np.nonzero(code == cc)[0]
            if not len(sel):
                continue
            ins = [i for i in range(4) if cc & (1 << i)]
            outs = [i for i in range(4) if not cc & (1 << i)]
            p00 = edge_pt(sel, ins[0], outs[0])
            p01 = edge_pt(sel, ins[0], outs[1])
            p10 = edge_pt(sel, ins[1], outs[0])
            p11 = edge_pt(sel, ins[1], outs[1])
            quad1 = np.stack([p00, p01, p11], axis=1)
            quad2 = np.stack([p00, p11, p10], axis=1)
            verts.append(quad1.reshape(-1, 3))
            verts.append(quad2.reshape(-1, 3))
            n = len(sel)
            tris.append(vcount + np.arange(3 * n).reshape(n, 3))
            vcount += 3 * n
            tris.append(vcount + np.arange(3 * n).reshape(n, 3))
            vcount += 3 * n

    if not verts:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    verts = np.concatenate(verts)
    tris = np.concatenate(tris)
    # weld duplicate vertices (edges shared between tets/cells)
    key = np.round(verts * 1024).astype(np.int64)
    _, uniq_idx, inv = np.unique(key, axis=0, return_index=True,
                                 return_inverse=True)
    return verts[uniq_idx], inv[tris]


def poisson_mesh(xyz: np.ndarray, normals: np.ndarray,
                 opts: PoissonOptions = PoissonOptions(),
                 device=None) -> tuple:
    """Oriented point cloud -> (vertices (V, 3) world, triangles (M, 3)):
    the field solved on `device`, the mesh extracted on the host."""
    dev = devmod.resolve(device)
    xyz = np.asarray(xyz, np.float64)
    normals = np.asarray(normals, np.float64)
    nn = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.maximum(nn, 1e-12)
    G = opts.grid

    lo = xyz.min(0)
    hi = xyz.max(0)
    span = float((hi - lo).max())
    pad = opts.padding * span
    origin = lo - pad
    scale = (span + 2 * pad) / (G - 1)
    pts_g = (xyz - origin) / scale

    chi, iso, dens = _poisson_field(
        devmod.as_tensor(pts_g, dev), devmod.as_tensor(normals, dev), G,
        float(opts.screen), float(opts.smooth_sigma))
    chi = chi.cpu().numpy()
    iso = float(iso)
    dens = dens.cpu().numpy()
    mask = dens > opts.min_density * max(dens.mean(), 1e-12)
    # a cell carries surface if any of its 8 corners is near data
    m = mask
    for ax in (0, 1, 2):
        m = m | np.roll(m, -1, axis=ax)
    verts_g, tris = _marching_tets(chi, iso, m)
    verts = verts_g * scale + origin
    return verts, tris
