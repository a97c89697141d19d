"""Batched SIFT extraction in PyTorch.

Port of dagsfm_tpu/features/sift.py (`extract` / `_extract`): a (B, H, W)
batch of grayscale images in, padded keypoint / descriptor arrays out.

  1. Gaussian scale space: separable blurs (the reference's shifted-slice
     form, kept because it holds the reference's f32 rounding), with the
     first octave upsampled 2x when `first_octave` is -1.
  2. DoG extrema over 3x3x3 neighbourhoods.
  3. A fixed budget of candidates per octave, the largest |DoG| first.
  4. One Newton step of sub-pixel / sub-scale refinement, contrast and
     edge checks.
  5. Orientation from a 36-bin gradient histogram.
  6. The 4x4x8 descriptor, L2 -> clip 0.2 -> L2 -> L1-root; optionally
     on a grid warped by the keypoint's affine shape
     (`estimate_affine_shape`) and pooled over domain sizes
     (`domain_size_pooling`), both through the gather route as in the
     reference.

Precision follows the reference as its tests run it (JAX with x64): the
pyramid, DoG and candidate scores in float32, everything from the
refinement on in float64. Ties in candidate selection and in the final
top-K fall to the lowest index first, as `jax.lax.top_k` does (a stable
descending sort: `torch.topk` promises no order). The reference's TPU
workarounds are not carried over: the one-hot patch-sampling route
(bit-identical to the gather route, which this port uses) and
`approx_max_k` (exact top-k here; on the CPU the reference's is exact
too).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dagsfm_tpu_torch.ops import solve as lin
from dagsfm_tpu_torch.ops.fma import fma32

F64 = torch.float64


class SiftOptions(NamedTuple):
    num_octaves: int = 0                # 0 = derive from image size
    first_octave: int = -1              # -1 = 2x upsampling
    max_image_size: int = 3200          # resize bound (FeaturePipeline)
    scales_per_octave: int = 3
    sigma0: float = 1.6
    first_octave_blur: float = 0.5      # assumed input blur
    peak_threshold: float = 0.0067
    edge_threshold: float = 10.0
    max_num_features: int = 8192        # per image
    candidates_per_octave: int = 1024
    adaptive_candidates: bool = True    # budget by octave area
    descriptor_patch: int = 16          # sample grid (4 bins x 4 samples)
    l1_root: bool = True
    upright: bool = False
    domain_size_pooling: bool = False   # DSP-SIFT
    dsp_min_scale: float = 1.0 / 6.0
    dsp_max_scale: float = 3.0
    dsp_num_scales: int = 10
    estimate_affine_shape: bool = False  # one-shot affine adaptation


class SiftFeatures(NamedTuple):
    xy: torch.Tensor          # (B, K, 2) pixel coords (x, y), float64
    scale: torch.Tensor       # (B, K) sigma in input-image pixels
    orientation: torch.Tensor  # (B, K) radians
    score: torch.Tensor       # (B, K) |DoG| response, float32
    descriptor: torch.Tensor  # (B, K, 128) float64, normalised
    mask: torch.Tensor        # (B, K) valid


def _gauss_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W) with zero padding: a sum of
    shifted slices in the reference's order, each step one fused
    multiply-add as the reference's compiled program rounds it."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    k = [float(v) for v in _gauss_kernel1d(sigma, radius)]
    B, H, W = img.shape
    xp = torch.nn.functional.pad(img, (radius, radius))
    out = k[0] * xp[:, :, 0:W]
    for i in range(1, 2 * radius + 1):
        out = fma32(out, k[i], xp[:, :, i:i + W])
    xp = torch.nn.functional.pad(out, (0, 0, radius, radius))
    out = k[0] * xp[:, 0:H, :]
    for i in range(1, 2 * radius + 1):
        out = fma32(out, k[i], xp[:, i:i + H, :])
    return out


def _downsample(img: torch.Tensor) -> torch.Tensor:
    return img[:, ::2, ::2].contiguous()


def _resize_weights(n_in: int, n_out: int, antialias: bool = True,
                    device=None) -> torch.Tensor:
    """(n_in, n_out) f32 weights of `jax.image.resize(..., "linear")`
    along one axis: a triangle kernel at the output's sample positions,
    widened by the scale when shrinking (antialias), normalised per
    output sample, computed in float64 and rounded to float32."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0) if antialias else 1.0
    sample = (torch.arange(n_out, dtype=F64) + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=F64)[:, None]) \
        / kscale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    tot = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(torch.float32).to(device)


def resize_linear(img: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, h, w) -> (B, H, W) as `jax.image.resize(img, (B, H, W),
    "linear")`: separable triangle filter, antialiased when shrinking,
    f32 weights contracted in f32."""
    B, h, w = img.shape
    out = img
    if h != H:
        out = torch.einsum("bhw,hH->bHw", out,
                           _resize_weights(h, H, device=img.device))
    if w != W:
        out = torch.einsum("bhw,wW->bhW", out,
                           _resize_weights(w, W, device=img.device))
    return out


def _octave_budget(H: int, W: int, opts: SiftOptions) -> int:
    """Candidate slots for an octave of H x W pixels: ~1 per 128 px,
    rounded up to a multiple of 128, at most candidates_per_octave."""
    if not opts.adaptive_candidates:
        return opts.candidates_per_octave
    want = -(-(H * W) // 128)
    want = -(-want // 128) * 128
    return int(min(opts.candidates_per_octave, max(128, want)))


def _top_k_stable(x: torch.Tensor, k: int):
    """Largest k along the last axis, ties lowest index first (as
    jax.lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _wrap(i: torch.Tensor, n: int) -> torch.Tensor:
    """Index semantics of a traced jnp gather: negative indices count
    from the end once, then out-of-range ones clamp."""
    return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)


def _index(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """clip(v, lo, hi) as an integer index, NaN (a degenerate candidate's
    refinement) taken as 0 the way XLA converts it."""
    return torch.nan_to_num(torch.clamp(v, lo, hi), nan=0.0).long()


def _grad(v: torch.Tensor, dim: int) -> torch.Tensor:
    """np.gradient with unit spacing: central differences inside,
    one-sided at the two ends."""
    return torch.gradient(v, dim=dim)[0]


def _sample(gflat: torch.Tensor, base: torch.Tensor, W: int,
            yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """gflat (B, NS*H*W) gathered at row base (B, N) + yi * W + xi, where
    yi, xi are (B, N, ...)."""
    B, N = base.shape
    lin = base.reshape(B, N, *([1] * (yi.dim() - 2))) + yi * W + xi
    return torch.gather(gflat, 1, lin.reshape(B, -1)).reshape(lin.shape)


def _orientation(gflat, base, H, W, yf, xf, sigma):
    """(B, N) dominant gradient orientation: 36-bin histogram of the
    nearest-pixel gradients over a 17 x 17 window of step 1.5 sigma / 8
    * 3, weighted by a Gaussian, smoothed twice, parabola-refined peak."""
    nb = 8
    dev = yf.device
    grid = torch.arange(-nb, nb + 1, dtype=torch.float32, device=dev)
    step = 1.5 * sigma / nb * 3.0                       # (B, N) f64
    ys = yf[..., None, None] + grid[:, None] * step[..., None, None]
    xs = xf[..., None, None] + grid[None, :] * step[..., None, None]
    yi = _index(torch.round(ys), 0, H - 1)             # (B, N, 17, 1)
    xi = _index(torch.round(xs), 0, W - 1)             # (B, N, 1, 17)
    yi, xi = torch.broadcast_tensors(yi, xi)
    v = _sample(gflat, base, W, yi, xi)                 # (B, N, 17, 17) f32
    gy = _grad(v, -2)
    gx = _grad(v, -1)
    mag = torch.sqrt(gx * gx + gy * gy)
    w = torch.exp(-(grid[:, None] ** 2 + grid[None, :] ** 2)
                  / (2 * (nb / 1.5) ** 2))
    ang = torch.atan2(gy, gx)
    bins = torch.remainder(torch.floor((ang + math.pi) / (2 * math.pi) * 36)
                           .to(torch.int32), 36)
    wm = (mag * w).to(F64).flatten(-2)                  # (B, N, 289)
    bins = bins.flatten(-2)
    # one fixed-order sum per bin: scatter_add_'s atomics on a GPU add in
    # no fixed order, and two runs could then differ in the last bits
    hist = torch.stack([torch.where(bins == k, wm, 0.0).sum(-1)
                        for k in range(36)], -1)
    for _ in range(2):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) \
            / 3.0
    peak = torch.argmax(hist, dim=-1, keepdim=True)
    left = torch.gather(hist, -1, (peak - 1) % 36)[..., 0]
    c = torch.gather(hist, -1, peak)[..., 0]
    right = torch.gather(hist, -1, (peak + 1) % 36)[..., 0]
    denom = left - 2 * c + right
    dpk = torch.where(torch.abs(denom) < 1e-9, torch.zeros_like(denom),
                      0.5 * (left - right) / denom)
    return (peak[..., 0] + dpk + 0.5) / 36.0 * 2 * math.pi - math.pi


def _spatial_weight_matrix(P: int) -> np.ndarray:
    """(P², 16) trilinear spatial-bin weights of the 4x4 grid."""
    half = P / 2.0
    gg = ((np.arange(P, dtype=np.float32) - half + 0.5) / half)
    by = np.broadcast_to(((gg[:, None] + 1.0) * 2.0 - 0.5), (P, P))
    bx = np.broadcast_to(((gg[None, :] + 1.0) * 2.0 - 0.5), (P, P))
    S = np.zeros((P * P, 16), np.float32)
    y0 = np.floor(by)
    x0 = np.floor(bx)
    for dyy in (0, 1):
        for dxx in (0, 1):
            yy = y0 + dyy
            xx = x0 + dxx
            w = (1 - np.abs(by - yy)) * (1 - np.abs(bx - xx))
            ok = (yy >= 0) & (yy < 4) & (xx >= 0) & (xx < 4)
            lin = (np.clip(yy, 0, 3) * 4 + np.clip(xx, 0, 3))
            np.add.at(S, (np.arange(P * P), lin.astype(np.int64).reshape(-1)),
                      np.where(ok, w, 0.0).reshape(-1))
    return S


def _normalize_desc(out: torch.Tensor, l1_root: bool) -> torch.Tensor:
    """L2 -> clip 0.2 -> L2; optional L1-root."""
    out = out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True),
                            min=1e-9)
    out = torch.clamp(out, max=0.2)
    out = out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True),
                            min=1e-9)
    if l1_root:
        out = torch.sqrt(out / torch.clamp(
            torch.sum(torch.abs(out), dim=-1, keepdim=True), min=1e-9))
    return out


def _bilinear(gflat, base, H, W, ys, xs):
    """Bilinear samples at (B, N, ...) positions ys, xs (the reference's
    `_bilinear_lvl`: the cell clamped into the level, weights in [0, 1])."""
    y0 = _index(torch.floor(ys), 0, H - 2)
    x0 = _index(torch.floor(xs), 0, W - 2)
    dy = torch.clamp(ys - y0, 0.0, 1.0)
    dx = torch.clamp(xs - x0, 0.0, 1.0)
    v00 = _sample(gflat, base, W, y0, x0)
    v01 = _sample(gflat, base, W, y0, x0 + 1)
    v10 = _sample(gflat, base, W, y0 + 1, x0)
    v11 = _sample(gflat, base, W, y0 + 1, x0 + 1)
    return (v00 * (1 - dy) * (1 - dx) + v01 * (1 - dy) * dx
            + v10 * dy * (1 - dx) + v11 * dy * dx)


def _affine_shape(gflat, base, H, W, yf, xf, sigma):
    """(B, N, 2, 2) one-shot affine adaptation: the second-moment matrix M
    of the bilinear gradients over a 17 x 17 window of step 1.5 sigma / 8
    * 2, Gaussian weighted, divided by its trace; M^(-1/2) from the 2x2
    eigendecomposition in closed form (the eigenvector of the larger
    eigenvalue is (M01, l1 - M00), or (1, 0) when |M01| <= 1e-12),
    scaled to unit determinant so the keypoint keeps its scale."""
    nb = 8
    dev = yf.device
    grid = torch.arange(-nb, nb + 1, dtype=torch.float32, device=dev)
    step = (1.5 * sigma / nb * 2.0)[..., None, None]
    ys, xs = torch.broadcast_tensors(
        yf[..., None, None] + grid[:, None] * step,
        xf[..., None, None] + grid[None, :] * step)
    v = _bilinear(gflat, base, H, W, ys, xs)            # (B, N, 17, 17)
    gy = _grad(v, -2)
    gx = _grad(v, -1)
    w = torch.exp(-(grid[:, None] ** 2 + grid[None, :] ** 2)
                  / (2 * (nb / 1.5) ** 2))
    mxx = torch.sum(w * gx * gx, (-2, -1))
    mxy = torch.sum(w * gx * gy, (-2, -1))
    myy = torch.sum(w * gy * gy, (-2, -1))
    trace = torch.clamp(mxx + myy, min=1e-12)
    m00, m01, m11 = mxx / trace, mxy / trace, myy / trace
    tr = m00 + m11
    det = m00 * m11 - m01 * m01
    disc = torch.sqrt(torch.clamp(tr * tr / 4 - det, min=1e-18))
    l1 = tr / 2 + disc
    l2 = torch.clamp(tr / 2 - disc, min=1e-9)
    off = torch.abs(m01) > 1e-12
    e = torch.stack([torch.where(off, m01, torch.ones_like(m01)),
                     torch.where(off, l1 - m00, torch.zeros_like(m01))], -1)
    e = e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True),
                        min=1e-12)
    V = torch.stack([e, torch.stack([-e[..., 1], e[..., 0]], -1)], -1)
    lam = torch.stack([l1 ** -0.5, l2 ** -0.5], -1)
    Ainv = (V * lam[..., None, :]) @ V.transpose(-1, -2)
    det_a = Ainv[..., 0, 0] * Ainv[..., 1, 1] - Ainv[..., 0, 1] \
        * Ainv[..., 1, 0]
    return Ainv / torch.sqrt(torch.clamp(det_a, min=1e-12))[..., None, None]


def _dsp_scales(opts: SiftOptions) -> np.ndarray:
    """DSP's domain-size multipliers: numpy's linspace, within a few ulps
    of the reference's jnp.linspace (a descriptor moves by ~1e-15)."""
    return np.linspace(opts.dsp_min_scale, opts.dsp_max_scale,
                       opts.dsp_num_scales)


def _histograms(gflat, base, H, W, yf, xf, sigma, theta, A, opts):
    """(B, N, 128) raw descriptor histograms: a P x P grid rotated by
    theta over 6 sigma each way (warped by A, (B, N, 2, 2), when given),
    bilinear samples, gradients, orientation soft-binned into 8 bins and
    space into the 4 x 4 grid."""
    P = opts.descriptor_patch
    dev = yf.device
    half = P / 2.0
    gg = (torch.arange(P, dtype=torch.float32, device=dev) - half + 0.5) / half
    S_mat = torch.as_tensor(_spatial_weight_matrix(P), device=dev).to(F64)
    w_gauss = torch.exp(-(gg[:, None] ** 2 + gg[None, :] ** 2) / (2 * 0.5))
    ct = torch.cos(theta)[..., None, None]
    st = torch.sin(theta)[..., None, None]
    ext = (6.0 * sigma)[..., None, None]
    u = gg[:, None] * ext                               # (B, N, P, 1)
    v = gg[None, :] * ext                               # (B, N, 1, P)
    uy = u * ct - v * st
    ux = u * st + v * ct
    if A is None:
        ys = yf[..., None, None] + uy
        xs = xf[..., None, None] + ux
    else:
        a = A[..., None, None, :, :]
        ys = yf[..., None, None] + a[..., 0, 0] * uy + a[..., 0, 1] * ux
        xs = xf[..., None, None] + a[..., 1, 0] * uy + a[..., 1, 1] * ux
    val = _bilinear(gflat, base, H, W, ys, xs)          # (B, N, P, P) f64
    gy = _grad(val, -2)
    gx = _grad(val, -1)
    mag = (torch.sqrt(gx * gx + gy * gy) * w_gauss).flatten(-2)
    ang = torch.atan2(gy, gx) - theta[..., None, None]
    ob = (torch.remainder(ang + 2 * math.pi, 2 * math.pi) / (2 * math.pi)
          * 8.0).flatten(-2)
    o0 = torch.floor(ob)
    fo = ob - o0
    o0i = torch.remainder(o0.long(), 8)
    O = torch.zeros(ob.shape + (8,), dtype=F64, device=dev)
    O.scatter_(-1, o0i[..., None], (1.0 - fo)[..., None])
    O.scatter_add_(-1, ((o0i + 1) % 8)[..., None], fo[..., None])
    D = torch.einsum("bns,si,bnsj->bnij", mag, S_mat, O)  # (B, N, 16, 8)
    return D.flatten(-2)


def _describe(gflat, base, H, W, yf, xf, sigma, theta, opts: SiftOptions):
    """(B, N, 128) normalised descriptors. With estimate_affine_shape the
    sampling grid is warped by each keypoint's affine shape; with
    domain_size_pooling the raw histograms are averaged over
    dsp_num_scales domain sizes, then normalised once."""
    A = _affine_shape(gflat, base, H, W, yf, xf, sigma) \
        if opts.estimate_affine_shape else None
    if opts.domain_size_pooling:
        raw = torch.stack([_histograms(gflat, base, H, W, yf, xf,
                                       sigma * float(m), theta, A, opts)
                           for m in _dsp_scales(opts)]).mean(0)
    else:
        raw = _histograms(gflat, base, H, W, yf, xf, sigma, theta, A, opts)
    return _normalize_desc(raw, opts.l1_root)


def _extract_octave(gauss: torch.Tensor, octave: int, opts: SiftOptions):
    """Candidates of one octave: gauss (B, S+3, H, W) f32. Returns xy
    (B, N, 2), sigma, orientation (B, N) in input pixels, scores (B, N)
    f32, descriptors (B, N, 128) and the ok mask."""
    B, NS, H, W = gauss.shape
    S = opts.scales_per_octave
    dev = gauss.device
    dog = gauss[:, 1:] - gauss[:, :-1]                  # (B, S+2, H, W)
    K_oct = _octave_budget(H, W, opts)

    is_max = torch.ones_like(dog, dtype=torch.bool)
    is_min = torch.ones_like(dog, dtype=torch.bool)
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == dy == dx == 0:
                    continue
                nb = torch.roll(dog, (-ds, -dy, -dx), dims=(1, 2, 3))
                is_max &= dog > nb
                is_min &= dog < nb
    extremum = (is_max | is_min) & (torch.abs(dog) > 0.8 * opts.peak_threshold)
    bm = torch.zeros((NS - 1, H, W), dtype=torch.bool, device=dev)
    bm[1:S + 1, 8:H - 8, 8:W - 8] = True
    extremum &= bm[None]
    score = torch.where(extremum, torch.abs(dog), torch.zeros_like(dog))
    vals, idx = _top_k_stable(score.reshape(B, -1), K_oct)
    ks = idx // (H * W)
    ky = (idx // W) % H
    kx = idx % W
    valid = vals > opts.peak_threshold * 0.8

    # ---- sub-pixel refinement: one Newton step on the DoG
    dflat = dog.reshape(B, -1)

    def d(ds, dy_, dx_):
        lin = ((_wrap(ks + ds, NS - 1) * H + _wrap(ky + dy_, H)) * W
               + _wrap(kx + dx_, W))
        return torch.gather(dflat, 1, lin)

    c = d(0, 0, 0)
    g = torch.stack([(d(1, 0, 0) - d(-1, 0, 0)) * 0.5,
                     (d(0, 1, 0) - d(0, -1, 0)) * 0.5,
                     (d(0, 0, 1) - d(0, 0, -1)) * 0.5], -1)
    hss = d(1, 0, 0) + d(-1, 0, 0) - 2 * c
    hyy = d(0, 1, 0) + d(0, -1, 0) - 2 * c
    hxx = d(0, 0, 1) + d(0, 0, -1) - 2 * c
    hsy = (d(1, 1, 0) - d(1, -1, 0) - d(-1, 1, 0) + d(-1, -1, 0)) * 0.25
    hsx = (d(1, 0, 1) - d(1, 0, -1) - d(-1, 0, 1) + d(-1, 0, -1)) * 0.25
    hyx = (d(0, 1, 1) - d(0, 1, -1) - d(0, -1, 1) + d(0, -1, -1)) * 0.25
    Hm = torch.stack([torch.stack([hss, hsy, hsx], -1),
                      torch.stack([hsy, hyy, hyx], -1),
                      torch.stack([hsx, hyx, hxx], -1)], -2).to(F64)
    Hm = Hm + 1e-9 * torch.eye(3, dtype=F64, device=dev)
    g64 = g.to(F64)
    off = -lin.solve_or_nan(Hm, g64[..., None])[..., 0]      # (B, N, 3)
    contrast = c.to(F64) + 0.5 * torch.sum(g64 * off, -1)
    tr = hyy + hxx
    det = hyy * hxx - hyx * hyx
    r = opts.edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    off_ok = torch.all(torch.abs(off) < 1.5, dim=-1)
    ok = valid & edge_ok & off_ok & (torch.abs(contrast) > opts.peak_threshold)

    sf = ks + off[..., 0]
    yf = ky + off[..., 1]
    xf = kx + off[..., 2]
    sigma = opts.sigma0 * torch.pow(2.0, sf / S)
    lvl = _index(torch.nan_to_num(torch.round(sf), nan=0.0), 0, S + 1)

    gflat = gauss.reshape(B, -1)
    base = lvl * (H * W)
    if opts.upright:
        theta = torch.zeros_like(yf)
    else:
        theta = _orientation(gflat, base, H, W, yf, xf, sigma)
    desc = _describe(gflat, base, H, W, yf, xf, sigma, theta, opts)
    scale_mult = 2.0 ** octave
    return (torch.stack([xf, yf], -1) * scale_mult, sigma * scale_mult,
            theta, vals, desc, ok)


def extract(images: torch.Tensor, opts: SiftOptions = SiftOptions()
            ) -> SiftFeatures:
    """SIFT for a batch of grayscale images (B, H, W) in [0, 1], on the
    images' device. With first_octave -1 the base octave is the image
    upsampled 2x; keypoints are in the original pixel frame."""
    B, H, W = images.shape
    S = opts.scales_per_octave
    k = 2.0 ** (1.0 / S)
    first_octave = min(opts.first_octave, 0)
    img = images.to(torch.float32)
    input_blur = opts.first_octave_blur
    if first_octave < 0:
        up = 2 ** (-first_octave)
        img = resize_linear(img, H * up, W * up)
        input_blur = opts.first_octave_blur * up
    base_sigma = math.sqrt(max(opts.sigma0 ** 2 - input_blur ** 2, 0.01))
    img = _blur(img, base_sigma)
    if opts.num_octaves > 0:
        n_oct = opts.num_octaves
    else:
        n_oct = max(1, int(math.floor(math.log2(
            min(img.shape[1], img.shape[2])))) - 3)

    per_octave = []
    for o in range(n_oct):
        if img.shape[1] < 32 or img.shape[2] < 32:
            break
        levels = [img]
        sigma_prev = opts.sigma0
        for s in range(1, S + 3):
            sigma_total = opts.sigma0 * k ** s
            sigma_extra = math.sqrt(max(sigma_total ** 2 - sigma_prev ** 2,
                                        0.01))
            levels.append(_blur(levels[-1], sigma_extra))
            sigma_prev = sigma_total
        gauss = torch.stack(levels, dim=1)              # (B, S+3, h, w)
        per_octave.append(_extract_octave(gauss, o + first_octave, opts))
        img = _downsample(levels[S])

    xy, scale, ori, score, desc, ok = (
        torch.cat([p[i] for p in per_octave], dim=1) for i in range(6))
    K = min(opts.max_num_features, int(xy.shape[1]))
    sc = torch.where(ok, score, torch.full_like(score, -1.0))
    vals, idx = _top_k_stable(sc, K)
    take = (lambda a: torch.gather(
        a, 1, idx.reshape(idx.shape + (1,) * (a.dim() - 2))
        .expand(idx.shape + a.shape[2:])))
    return SiftFeatures(xy=take(xy), scale=take(scale),
                        orientation=take(ori), score=vals,
                        descriptor=take(desc), mask=vals > 0)


def descriptors_to_uint8(desc) -> np.ndarray:
    """COLMAP-compatible uint8 quantisation (512 * value, clipped)."""
    d = torch.as_tensor(desc)
    return torch.clamp(torch.round(d * 512.0), 0, 255).cpu().numpy() \
        .astype(np.uint8)
