"""The Schur product S·x of bundle adjustment's iterative Schur PCG: CUDA
kernel and plain version.

S = U - W V⁻¹ Wᵀ is the reduced camera system of one LM step
(`sfm/bundle_adjustment._solve_iterative`), over the poses (I, 6) and,
with the intrinsics, every camera's G = 8 slots; the PCG applies it
matrix-free once an iteration. Replaces no TPU
kernel: the JAX package leaves this product to XLA. The kernel is
`csrc/schur_matvec.cu` (K6), compiled with nvcc for sm_90a into a shared
library with a plain C interface and loaded with ctypes; see the .cu file
for its passes, bound and design.

`system` gathers one step's blocks and, for CUDA tensors, the kernel's
int32 index arrays; `schur_mv` and `point_sums` launch the kernel for
CUDA tensors and run the plain version (`schur_mv_reference`,
`point_sums_reference`: the port's fixed-order segment sums, as the PCG
computed S·x before the kernel) only for CPU tensors; for a CUDA tensor
they launch or raise, never fall back. Every sum of the kernel is taken
in a fixed order, with no atomics: two launches give the same bits, and
the plain version's to the rounding of another order. Each `schur_mv`
adds 1 to the open root's counter `schur_mv` (utils/observability).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dagsfm_tpu_torch.ops import cuda_build
from dagsfm_tpu_torch.ops.segment_sum import mtv, mv, segment_sum
from dagsfm_tpu_torch.utils import observability as obs

launches = 0          # kernel launches (four per schur_mv on a GPU)
G_SLOTS = 8           # intrinsic slots of the joint system
DTYPES = (torch.float64, torch.float32)
I32 = torch.int32


class KernelIndex(NamedTuple):
    """The kernel's int32 index arrays of one problem."""
    point_rows: torch.Tensor    # (N, 4): observation, image, camera, 0
    point_off: torch.Tensor     # (P + 1,) first row of each point
    image_rows: torch.Tensor    # (N, 2): observation, point
    chunk_off: torch.Tensor     # (K + 1,) first row of each chunk
    image_chunks: torch.Tensor  # (I + 1,) first chunk of each image
    camidx: torch.Tensor        # (I,)
    cam_off: torch.Tensor       # (C + 1,) first image row of each camera
    cam_images: torch.Tensor    # (I,) images grouped by camera


class SchurSystem(NamedTuple):
    """One LM step's reduced camera system, never formed. Without the
    intrinsics Wg, U_pg, U_gg and gfree are None."""
    prob: object                # the BAProblem (indices and segments)
    Wc: torch.Tensor            # (N, 6, 3)
    Wg: torch.Tensor | None     # (N, G, 3)
    Vinv: torch.Tensor          # (P, 3, 3)
    U_pp: torch.Tensor          # (I, 6, 6), damped
    U_pg: torch.Tensor | None   # (I, 6, G)
    U_gg: torch.Tensor | None   # (C, G, G), damped
    free: torch.Tensor          # (I, 1), 0 for a pinned image
    gfree: torch.Tensor | None  # (C, G), 0 for a held slot
    index: KernelIndex | None   # CUDA only


def load_library():
    """Build (when the source hash changed) and load the kernel library."""
    lib = cuda_build.load("schur_matvec")["schur_matvec"]
    cuda_build.set_signature(lib.schur_point_launch, 10,
                             [ctypes.c_int] * 3, 1)
    cuda_build.set_signature(lib.schur_image_launch, 9,
                             [ctypes.c_int] * 4, 1)
    cuda_build.set_signature(lib.schur_camera_launch, 14,
                             [ctypes.c_int] * 4, 1)
    return lib


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    """(T + 1,) int32 starts of T consecutive runs of `counts` rows."""
    return torch.cat([counts.new_zeros(1),
                      torch.cumsum(counts, 0)]).to(I32)


def _kernel_index(prob) -> KernelIndex:
    bp, bi, bc = prob.by_point, prob.by_image, prob.img_by_cam
    m, mi = bp.order, bi.order
    point_rows = torch.stack([m, prob.obs_image[m], prob.obs_cam[m],
                              torch.zeros_like(m)], 1).to(I32)
    image_rows = torch.stack([mi, prob.obs_point[mi]], 1).to(I32)
    return KernelIndex(point_rows, _offsets(bp.lengths), image_rows,
                       _offsets(bi.chunks), _offsets(bi.chunk_counts),
                       prob.image_camidx.to(I32), _offsets(bc.lengths),
                       bc.order.to(I32))


def system(prob, Wc, Wg, Vinv, U_pp, U_pg, U_gg, free, gfree) -> SchurSystem:
    """The SchurSystem of one step. CUDA tensors: every block of Wc's
    dtype, float64 or float32, contiguous and of its shape, Wg, U_pg, U_gg
    and gfree all given (G = 8) or all None, W 16-byte aligned, fewer
    than 2**31 observations; anything else raises."""
    sys_ = SchurSystem(prob, Wc, Wg, Vinv, U_pp, U_pg, U_gg, free, gfree,
                       None)
    dev = Wc.device
    if dev.type == "cpu":
        return sys_
    if dev.type != "cuda":
        raise ValueError(f"schur_matvec: unsupported device {dev}")
    joint = [t is None for t in (Wg, U_pg, U_gg, gfree)]
    if any(joint) and not all(joint):
        raise ValueError("schur_matvec: Wg, U_pg, U_gg and gfree are given "
                         "together or not at all")
    N, P = prob.obs_image.shape[0], prob.points.shape[0]
    I, C = prob.image_qvec.shape[0], prob.cam_params.shape[0]
    if N >= 2 ** 31:
        raise ValueError(f"schur_matvec: {N} observations, the kernel "
                         "indexes fewer than 2**31")
    dt = Wc.dtype if Wc.dtype in DTYPES else torch.float64
    want = [("Wc", Wc, dt, (N, 6, 3)), ("Vinv", Vinv, dt, (P, 3, 3)),
            ("U_pp", U_pp, dt, (I, 6, 6)), ("free", free, dt, (I, 1))]
    if Wg is not None:
        G = G_SLOTS
        want += [("Wg", Wg, dt, (N, G, 3)), ("U_pg", U_pg, dt, (I, 6, G)),
                 ("U_gg", U_gg, dt, (C, G, G)),
                 ("gfree", gfree, dt, (C, G))]
    cuda_build.check_tensors("schur_matvec", want, dev)
    for name, W in (("Wc", Wc), ("Wg", Wg)):
        if W is not None and W.data_ptr() % 16:
            raise ValueError(f"schur_matvec: {name} must be 16-byte aligned")
    return sys_._replace(index=_kernel_index(prob))


def _check_x(sys_: SchurSystem, x: tuple) -> None:
    joint = sys_.Wg is not None
    if len(x) != 1 + joint or any(t is None for t in x):
        raise ValueError(f"schur_matvec: x must be {1 + joint} blocks")
    dt = sys_.Wc.dtype
    want = [("x_p", x[0], dt, (sys_.U_pp.shape[0], 6))]
    if joint:
        want.append(("x_g", x[1], dt, tuple(sys_.gfree.shape)))
    cuda_build.check_tensors("schur_matvec", want, sys_.Wc.device)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _is_double(t: torch.Tensor) -> int:
    return int(t.dtype == torch.float64)


def _launched(err: int, n: int) -> None:
    """Raise on a launch's CUDA error, else count its n kernels."""
    global launches
    if err != 0:
        raise RuntimeError(f"schur_matvec: CUDA launch error {err}")
    launches += n


def _point_launch(sys_: SchurSystem, xp, xg, Vinv) -> torch.Tensor:
    P = sys_.Vinv.shape[0]
    ix = sys_.index
    out = torch.empty((P, 3), dtype=xp.dtype, device=xp.device)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = load_library().schur_point_launch(
        sys_.Wc.data_ptr(), _ptr(sys_.Wg), ix.point_rows.data_ptr(),
        ix.point_off.data_ptr(), xp.data_ptr(), sys_.free.data_ptr(),
        _ptr(xg), _ptr(sys_.gfree), _ptr(Vinv), out.data_ptr(), P,
        0 if sys_.Wg is None else G_SLOTS, _is_double(xp), stream)
    _launched(err, 1)
    return out


def point_sums_reference(sys_: SchurSystem, xp, xg=None) -> torch.Tensor:
    """Plain version of `point_sums`: the per-observation products, then
    their segment sums by point."""
    prob = sys_.prob
    t = mtv(sys_.Wc, (xp * sys_.free)[prob.obs_image])
    if sys_.Wg is not None:
        t = t + mtv(sys_.Wg, (xg * sys_.gfree)[prob.obs_cam])
    return segment_sum(t, prob.by_point)


def point_sums(sys_: SchurSystem, xp, xg=None) -> torch.Tensor:
    """(P, 3): t_p = Σ_{n∈obs(p)} Wc_nᵀ (x_p free)[i(n)] + Wg_nᵀ (x_g
    gfree)[c(n)], the point side of S·x and of the back-substitution."""
    x = (xp,) if sys_.Wg is None else (xp, xg)
    if sys_.index is None:
        return point_sums_reference(sys_, *x)
    _check_x(sys_, x)
    return _point_launch(sys_, xp, xg, None)


def no_reduce(*xs):
    """The reduce of one process: the blocks as they are."""
    return xs


def schur_mv_reference(sys_: SchurSystem, x: tuple,
                       reduce=no_reduce) -> tuple:
    """Plain version of `schur_mv`: the port's segment sums, as the PCG
    computed S·x before the kernel."""
    prob, free, gfree = sys_.prob, sys_.free, sys_.gfree
    joint = sys_.Wg is not None
    xpm = x[0] * free
    xgm = x[1] * gfree if joint else None
    yo = mv(sys_.Vinv, point_sums_reference(sys_, *x))[prob.obs_point]
    z = [segment_sum(mv(sys_.Wc, yo), prob.by_image)]
    if joint:
        z.append(segment_sum(mv(sys_.Wg, yo), prob.by_image))
    z = reduce(*z)
    Sxp = mv(sys_.U_pp, xpm)
    if joint:
        Sxp = Sxp + mv(sys_.U_pg, xgm[prob.image_camidx])
    out = ((Sxp - z[0]) * free + x[0] * (1.0 - free),)
    if not joint:
        return out

    def fold(z_img):
        return segment_sum(z_img, prob.img_by_cam)

    Sxg = mv(sys_.U_gg, xgm) + fold(mtv(sys_.U_pg, xpm)) - fold(z[1])
    return out + (Sxg * gfree + x[1] * (1.0 - gfree),)


def schur_mv(sys_: SchurSystem, x: tuple, reduce=no_reduce) -> tuple:
    """S·x for x = (x_p,) or, with the intrinsics, (x_p, x_g): a tuple of
    the same blocks, pinned images and held slots passed through as the
    identity. `reduce` sums the per-image products over the ranks that
    hold the other observations (`parallel.mesh.all_reduce_many`; none
    in one process), between the image sums and the fold into cameras.
    CUDA tensors: x of the system's dtype, contiguous and of its shape;
    anything else raises. No host synchronisation on the card."""
    obs.count("schur_mv")
    if sys_.index is None:
        return schur_mv_reference(sys_, x, reduce)
    _check_x(sys_, x)
    joint = sys_.Wg is not None
    G = G_SLOTS if joint else 0
    xp, xg = x[0], (x[1] if joint else None)
    dev, dt = xp.device, xp.dtype
    ix = sys_.index
    I, K = sys_.U_pp.shape[0], ix.chunk_off.shape[0] - 1
    C = sys_.gfree.shape[0] if joint else 0
    y = _point_launch(sys_, xp, xg, sys_.Vinv)
    part = torch.empty((K, 6 + G), dtype=dt, device=dev)
    zc = torch.empty((I, 6), dtype=dt, device=dev)
    zg = torch.empty((I, G), dtype=dt, device=dev) if joint else None
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.schur_image_launch(
        sys_.Wc.data_ptr(), _ptr(sys_.Wg), ix.image_rows.data_ptr(),
        ix.chunk_off.data_ptr(), ix.image_chunks.data_ptr(), y.data_ptr(),
        part.data_ptr(), zc.data_ptr(), _ptr(zg), K, I, G, _is_double(xp),
        stream)
    _launched(err, 2)
    z = reduce(zc, zg) if joint else reduce(zc)
    zc = z[0].contiguous()
    zg = z[1].contiguous() if joint else None
    outp = torch.empty((I, 6), dtype=dt, device=dev)
    outg = torch.empty((C, G), dtype=dt, device=dev) if joint else None
    err = lib.schur_camera_launch(
        sys_.U_pp.data_ptr(), _ptr(sys_.U_pg), _ptr(sys_.U_gg),
        xp.data_ptr(), sys_.free.data_ptr(), _ptr(xg), _ptr(sys_.gfree),
        zc.data_ptr(), _ptr(zg), ix.camidx.data_ptr(), ix.cam_off.data_ptr(),
        ix.cam_images.data_ptr(), outp.data_ptr(), _ptr(outg), I, C, G,
        _is_double(xp), stream)
    _launched(err, 1)
    return (outp,) if not joint else (outp, outg)
