"""Branch-free polynomial root finding for the minimal solvers.

Port of dagsfm_tpu/ops/polynomials.py: closed-form quadratic / cubic /
quartic, and fixed-grid sign-change isolation + bisection + Newton for
the 5-point solver's degree-10 polynomial. Every function broadcasts
over leading dims and returns (roots, valid_mask) with static shapes.
"""

from __future__ import annotations

import math

import torch


def polyval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """coeffs[..., 0] * x^n + ... + coeffs[..., n] (Horner)."""
    out = torch.zeros_like(x) + coeffs[..., 0]
    for k in range(1, coeffs.shape[-1]):
        out = out * x + coeffs[..., k]
    return out


def polyder(coeffs: torch.Tensor) -> torch.Tensor:
    n = coeffs.shape[-1] - 1
    powers = torch.arange(n, 0, -1, dtype=coeffs.dtype, device=coeffs.device)
    return coeffs[..., :-1] * powers


def _nz(x, eps=1e-14):
    """x with |x| < eps replaced by eps (the reference's division guard)."""
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def solve_quadratic(a, b, c):
    """Real roots of a x^2 + b x + c; handles a ~ 0 (linear)."""
    lin = torch.abs(a) < 1e-14
    disc = b * b - 4 * a * c
    has = disc >= 0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    sgn = torch.where(b >= 0, torch.ones_like(b), -torch.ones_like(b))
    q = -0.5 * (b + sgn * sq)
    a_safe = torch.where(lin, torch.ones_like(a), a)
    q_safe = _nz(q)
    r1 = torch.where(lin, -c / _nz(b), q / a_safe)
    r2 = torch.where(lin, r1, c / q_safe)
    roots = torch.stack([r1, r2], dim=-1)
    mask = torch.stack([has | lin, has & ~lin], dim=-1)
    return roots, mask


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def solve_cubic_real(a, b, c, d):
    """One real root of a x^3 + b x^2 + c x + d (Cardano / trig hybrid)."""
    a_safe = _nz(a)
    b_, c_, d_ = b / a_safe, c / a_safe, d / a_safe
    p = c_ - b_ * b_ / 3.0
    q = 2.0 * b_ ** 3 / 27.0 - b_ * c_ / 3.0 + d_
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    root_pos = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)
    p_safe = torch.where(p >= -1e-14, torch.full_like(p, -1e-14), p)
    m = 2.0 * torch.sqrt(-p_safe / 3.0)
    arg = torch.clamp(3.0 * q / (p_safe * m), -1.0, 1.0)
    root_neg = m * torch.cos(torch.arccos(arg) / 3.0)
    root = torch.where(disc > 0, root_pos, root_neg)
    return root - b_ / 3.0


def solve_cubic_all(a, b, c, d):
    """All real roots of a cubic: one by `solve_cubic_real`, the other two
    from the deflated quadratic. Returns (roots (..., 3), mask (..., 3))."""
    r1 = solve_cubic_real(a, b, c, d)
    e = b + a * r1
    f = c + e * r1
    r23, m23 = solve_quadratic(a, e, f)
    roots = torch.cat([r1[..., None], r23], dim=-1)
    mask = torch.cat([torch.ones_like(r1, dtype=torch.bool)[..., None], m23],
                     dim=-1)
    return roots, mask


def solve_quartic_real(a, b, c, d, e):
    """Real roots of a quartic via Ferrari. Returns (roots (..., 4), mask)."""
    a_safe = _nz(a)
    b_, c_, d_, e_ = b / a_safe, c / a_safe, d / a_safe, e / a_safe
    p = c_ - 3.0 * b_ * b_ / 8.0
    q = d_ - b_ * c_ / 2.0 + b_ ** 3 / 8.0
    r = e_ - b_ * d_ / 4.0 + b_ * b_ * c_ / 16.0 - 3.0 * b_ ** 4 / 256.0
    m = solve_cubic_real(torch.ones_like(p), p, p * p / 4.0 - r,
                         -q * q / 8.0)
    m = torch.clamp(m, min=1e-14)
    s = torch.sqrt(2.0 * m)
    s_safe = _nz(s)
    c1 = m + p / 2.0 - q / (2.0 * s_safe)
    c2 = m + p / 2.0 + q / (2.0 * s_safe)
    one = torch.ones_like(s)
    r12, m12 = solve_quadratic(one, s, c1)
    r34, m34 = solve_quadratic(one, -s, c2)
    roots = torch.cat([r12, r34], dim=-1) - b_[..., None] / 4.0
    mask = torch.cat([m12, m34], dim=-1)
    return roots, mask


def real_roots_sturm(coeffs: torch.Tensor, lo: float = -10.0,
                     hi: float = 10.0, grid: int = 512,
                     bisect_iters: int = 40, newton_iters: int = 3,
                     max_roots: int = 10):
    """Real roots by sign changes on a tan-warped fixed grid, bisection,
    then Newton polish. coeffs (..., n+1) highest degree first.
    Returns (roots (..., max_roots), mask (..., max_roots))."""
    dev, dt = coeffs.device, coeffs.dtype
    start, stop = -math.pi / 2 + 1e-3, math.pi / 2 - 1e-3
    ts = torch.linspace(start, stop, grid, dtype=dt, device=dev)
    xs = torch.tan(ts)                                        # (G,)
    vals = polyval(coeffs[..., None, :], xs)                  # (..., G)
    sign = torch.sign(vals)
    change = (sign[..., :-1] * sign[..., 1:]) < 0             # (..., G-1)
    ar = torch.arange(grid - 1, device=dev).expand(change.shape)
    idx = torch.where(change, ar, torch.full_like(ar, grid))
    order = torch.sort(idx, dim=-1).values[..., :max_roots]
    valid = order < grid
    safe = torch.clamp(order, max=grid - 2)
    a = xs[safe]
    b = xs[safe + 1]
    cf = coeffs[..., None, :]
    for _ in range(bisect_iters):
        mid = 0.5 * (a + b)
        fm = polyval(cf, mid)
        fa = polyval(cf, a)
        left = (fa * fm) <= 0
        a, b = torch.where(left, a, mid), torch.where(left, mid, b)
    x = 0.5 * (a + b)
    dcf = polyder(coeffs)[..., None, :]
    for _ in range(newton_iters):
        f = polyval(cf, x)
        df = polyval(dcf, x)
        df = torch.where(torch.abs(df) < 1e-20, torch.full_like(df, 1e-20), df)
        x = x - torch.clamp(f / df, -1.0, 1.0)
    return torch.where(valid, x, torch.zeros_like(x)), valid
