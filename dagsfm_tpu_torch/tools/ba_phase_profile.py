"""The phases of the iterative bundle adjustment against the card's
bandwidth.

    python -m dagsfm_tpu_torch.tools.ba_phase_profile [--smoke]
        [--out PATH] [--device cuda|cpu]

Counterpart of tools/ba_phase_profile.py, on its problem: 1,000 cameras,
50,000 points, tracks of up to 20 (about 1M observations; `--smoke`:
200, 5,000, 8), points moved by N(0, 0.02), the first two images held,
float32, 5 LM iterations of the ITERATIVE_SCHUR solver with ftol 0. Each
phase is timed on the port's own functions in `sfm/bundle_adjustment.py`
(device ms from CUDA events after a warm-up):

  * residual_jacobian: `_residuals_and_jacobians` and `_robust_weights`;
  * trial_cost: `_plain_cost`, once per LM step on the trial;
  * schur_prologue: the statements of `_solve_iterative` before its CG
    (`PROLOGUE`, with `_point_blocks`, the segment sums, `_damp` and
    `_block_inverse`), each of which `prologue_probe` times alone, and
    the step's `schur_matvec.system`;
  * cg_matvec: one S·x of its CG (`matvec`: `schur_matvec.schur_mv`, the
    kernel K6 on the card), and cg_30_matvecs: 30 in a chain;
  * linear_solve_total: `_solve_iterative` whole (prologue, PCG,
    back-substitution);
  * lm_iteration: `solve` over 5 LM iterations, divided by 5.

The byte model (`roofline` in the record) counts the arrays the port's
statements read and write, each once per statement: a product reads
its operands and writes its result; a gather reads the index (int64)
and the rows it takes and writes them; a segment sum of M rows into T
targets reads the rows and the sort order, writes and reads the sorted
copy, writes and reads its K chunk partials and writes the T sums
(3 M k + 2 K k + T k values and M indices, k the row width).
residual_jacobian counts the per-observation gathers of its inputs
(pose, point, camera, model, the three index arrays and the
observation) and its outputs r, Jc, Jp and w, not the temporaries of
the camera-model chain; trial_cost the same inputs. Temporaries inside one
expression are not counted either, so the model is a floor on the bytes
moved. cg_matvec counts what the benchmark counts for a CG iteration:
W and V⁻¹ read once, two indices per observation, x in and the product
out. Each phase gets GB moved, its bound at the H100's 3.35 TB/s and
the achieved GB/s (bounds null off the card). Prints one JSON object on
stdout with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from dagsfm_tpu_torch.ops import schur_matvec as sx
from dagsfm_tpu_torch.ops.segment_sum import mv, segment_sum
from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
from dagsfm_tpu_torch.tools import common

FULL = (1000, 50000, 20)
SMOKE = (200, 5000, 8)
LAM = 1e-4
LM_ITERS = 5
I64 = 8                       # bytes of an index


def problem(ncam: int, npts: int, mtl: int, dev, dtype=torch.float32,
            perturb: bool = True):
    """(BAProblem in `dtype`, BAOptions) of the reference tool; its points
    moved by N(0, 0.02) unless `perturb` is off."""
    from dagsfm_tpu_torch.scene import synthetic
    sc = synthetic.generate(synthetic.SyntheticSceneSpec(
        num_cameras=ncam, num_points=npts, pixel_noise=0.5, seed=0,
        max_track_length=mtl))
    arrays = synthetic.to_scene_arrays(sc, dev)
    if perturb:
        rng = np.random.default_rng(1)
        noise = rng.normal(0, 0.02, tuple(arrays.points_xyz.shape))
        arrays = arrays._replace(points_xyz=arrays.points_xyz
                                 + torch.as_tensor(noise, device=dev))
    const = np.zeros(ncam, bool)
    const[:2] = True
    prob = ba.make_problem(arrays, max_track_len=mtl, const_image=const)
    prob = prob._replace(**{k: getattr(prob, k).to(dtype) for k in (
        "image_qvec", "image_tvec", "cam_params", "points", "obs_xy",
        "cam_refine")})
    opts = ba.BAOptions(max_iterations=LM_ITERS, solver="iterative",
                        ftol=0.0)
    return prob, opts


def weighted(prob, opts) -> dict:
    """residual_jacobian's outputs and their weighted forms, as
    `_build_and_solve` weighs them."""
    r, Jc, Jp, _ = ba._residuals_and_jacobians(prob, False)
    w = ba._robust_weights(torch.sum(r * r, -1), opts.loss, opts.loss_scale)
    r_w, Jc_w, Jp_w, _ = ba._weighted(prob, r, Jc, Jp, None, w)
    return {"r": r, "Jc": Jc, "Jp": Jp, "w": w, "r_w": r_w, "Jc_w": Jc_w,
            "Jp_w": Jp_w}


def _seg(key: str, seg: str, neg: bool = False):
    def fn(e):
        out = segment_sum(e[key], getattr(e["prob"], seg))
        return -out if neg else out
    return fn


def _point_inverse(e):
    """_point_blocks' damping and inverse of V."""
    V = e["V"]
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    Vd = V + (e["lam"] * torch.clamp(V.diagonal(dim1=-2, dim2=-1), min=1e-6)[
        ..., None] + e["opts"].point_damping) * eye3
    return ba._inv3(Vd + 1e-12 * eye3)


# The statements of `_solve_iterative` (with `_point_blocks`) before its
# CG, in its order: (name, output, inputs, kind, fn of the environment),
# kind the segments it sums by, "gather" or None (a product). Each
# computes what the solver computes, with the same operations; the
# solver forms every product before it sums the four by image.
PROLOGUE = (
    ("JpT Jp", "JpTJp", ("Jp_w",), None,
     lambda e: e["Jp_w"].transpose(1, 2) @ e["Jp_w"]),
    ("V: sum by point", "V", ("JpTJp",), "by_point", _seg("JpTJp",
                                                          "by_point")),
    ("JpT r", "JpTr", ("Jp_w", "r_w"), None,
     lambda e: (e["Jp_w"].transpose(1, 2) @ e["r_w"][..., None])[..., 0]),
    ("gp: sum by point", "gp", ("JpTr",), "by_point",
     _seg("JpTr", "by_point", neg=True)),
    ("Vinv: damp and invert", "Vinv", ("V",), None, _point_inverse),
    ("W = JcT Jp", "W", ("Jc_w", "Jp_w"), None,
     lambda e: e["Jc_w"].transpose(1, 2) @ e["Jp_w"]),
    ("Vinv per observation", "Vinv_obs", ("Vinv", "op"), "gather",
     lambda e: e["Vinv"][e["op"]]),
    ("gp per observation", "gp_obs", ("gp", "op"), "gather",
     lambda e: e["gp"][e["op"]]),
    ("W Vinv", "WVinv", ("W", "Vinv_obs"), None,
     lambda e: e["W"] @ e["Vinv_obs"]),
    ("JcT Jc", "JcTJc", ("Jc_w",), None,
     lambda e: e["Jc_w"].transpose(1, 2) @ e["Jc_w"]),
    ("U: sum by image", "U", ("JcTJc",), "by_image", _seg("JcTJc",
                                                          "by_image")),
    ("JcT r", "JcTr", ("Jc_w", "r_w"), None,
     lambda e: mv(e["Jc_w"].transpose(1, 2), e["r_w"])),
    ("gc: sum by image", "gc", ("JcTr",), "by_image", _seg("JcTr",
                                                           "by_image")),
    ("W Vinv gp", "WVgp", ("WVinv", "gp_obs"), None,
     lambda e: mv(e["WVinv"], e["gp_obs"])),
    ("corr: sum by image", "corr", ("WVgp",), "by_image",
     _seg("WVgp", "by_image")),
    ("W Vinv Wt", "WVinvWt", ("WVinv", "W"), None,
     lambda e: e["WVinv"] @ e["W"].transpose(1, 2)),
    ("B: sum by image", "B", ("WVinvWt",), "by_image",
     _seg("WVinvWt", "by_image")),
    ("Ud = damp(U)", "Ud", ("U",), None,
     lambda e: ba._damp(e["U"], e["lam"])),
    ("b = -(gc + corr)", "b", ("gc", "corr", "free"), None,
     lambda e: (-e["gc"] - e["corr"]) * e["free"]),
    ("Minv: block inverse of Ud - B", "Minv", ("Ud", "B", "free"), None,
     lambda e: ba._block_inverse(e["Ud"] - e["B"],
                                 e["free"].expand(-1, 6))),
)


def environment(prob, opts, wt: dict) -> dict:
    """The prologue's inputs."""
    return {"prob": prob, "opts": opts, "lam": LAM, "op": prob.obs_point,
            "free": (~prob.const_image).to(wt["r_w"].dtype)[:, None],
            "r_w": wt["r_w"], "Jc_w": wt["Jc_w"], "Jp_w": wt["Jp_w"]}


def prologue(env: dict) -> dict:
    """Every statement of PROLOGUE in order, then the step's Schur
    system (`system`), as the solver builds it before its CG; env gains
    their outputs."""
    for _, out, _, _, fn in PROLOGUE:
        env[out] = fn(env)
    env["system"] = sx.system(env["prob"], env["W"], None, env["Vinv"],
                              env["Ud"], None, None, env["free"], None)
    return env


def matvec(env: dict, x):
    """One S·x of `_solve_iterative`'s CG: `schur_matvec.schur_mv` on the
    environment's system (the kernel on the card)."""
    return sx.schur_mv(env["system"], (x,))[0]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def seg_bytes(M: int, row: int, seg) -> int:
    """A segment sum of M rows of `row` bytes grouped by `seg` (see the
    docstring)."""
    return (3 * M * row + M * I64 + 2 * seg.chunks.numel() * row
            + seg.lengths.numel() * row)


def step_bytes(env: dict, step) -> int:
    """Bytes one PROLOGUE statement reads and writes."""
    _, out, ins, seg, _ = step
    if seg == "gather":
        return nbytes(env[ins[1]]) + 2 * nbytes(env[out])
    if seg is not None:
        rows = env[ins[0]]
        return seg_bytes(rows.shape[0], nbytes(rows) // rows.shape[0],
                         getattr(env["prob"], seg))
    return nbytes(*(env[k] for k in ins), env[out])


def gathers_bytes(prob, obs_out: int = 0) -> int:
    """Per-observation gathers of the projection's inputs (pose 4 + 3,
    point 3, camera 12 values, model id), the three index arrays and the
    observation, plus `obs_out` bytes of outputs."""
    N = prob.obs_xy.shape[0]
    s = prob.obs_xy.element_size()
    return N * ((4 + 3 + 3 + 12 + 2) * s + 4 * I64) + obs_out


def matvec_bytes(env: dict) -> int:
    """One S·x as the benchmark counts a CG iteration's bytes: W and
    Vinv read once, each observation's image and point index (int64),
    x in and the product out."""
    prob = env["prob"]
    N, I = prob.obs_xy.shape[0], prob.image_qvec.shape[0]
    s = prob.obs_xy.element_size()
    return nbytes(env["W"], env["Vinv"]) + 2 * N * I64 + 2 * I * 6 * s


def run(smoke: bool = False, device=None, dtype=torch.float32,
        reps: int = 5, sizes: tuple | None = None) -> dict:
    """Every phase on `device` (the card unless told) at FULL, SMOKE or
    `sizes` (cameras, points, max track length); returns the record."""
    dev = common.resolve(device)
    ncam, npts, mtl = sizes or (SMOKE if smoke else FULL)
    prob, opts = problem(ncam, npts, mtl, dev, dtype)
    N, P, I = prob.obs_xy.shape[0], prob.points.shape[0], ncam
    shapes = {"I": I, "P": P, "N": N, "max_track_len": mtl,
              "dtype": str(dtype).replace("torch.", "")}
    print(f"shapes: {shapes}", file=sys.stderr, flush=True)

    def t(fn):
        return common.call_ms(fn, dev, reps)

    ms, gbytes = {}, {}
    ms["residual_jacobian"] = t(lambda: weighted(prob, opts)["w"])
    wt = weighted(prob, opts)
    gbytes["residual_jacobian"] = gathers_bytes(prob, nbytes(
        wt["r"], wt["Jc"], wt["Jp"], wt["w"]))
    ms["trial_cost"] = t(lambda: ba._plain_cost(prob, opts))
    gbytes["trial_cost"] = gathers_bytes(prob)
    env = prologue(environment(prob, opts, wt))
    ms["schur_prologue"] = t(lambda: prologue(environment(prob, opts, wt)))
    gbytes["schur_prologue"] = sum(step_bytes(env, s) for s in PROLOGUE)
    x = torch.ones((I, 6), dtype=dtype, device=dev)
    ms["cg_matvec"] = t(lambda: matvec(env, x))
    gbytes["cg_matvec"] = matvec_bytes(env)

    def chain():
        y = x
        for _ in range(30):
            y = matvec(env, y) * (1.0 / (1.0 + torch.sum(y * y)))
        return y
    ms["cg_30_matvecs"] = t(chain)
    gbytes["cg_30_matvecs"] = 30 * gbytes["cg_matvec"]
    ms["linear_solve_total"] = t(lambda: ba._solve_iterative(
        prob, wt["r_w"], wt["Jc_w"], wt["Jp_w"], None, LAM, opts, None))
    ba.solve(prob, opts, max_iters=1)                   # warm-up
    common.sync(dev)
    t0 = time.perf_counter()
    _, st = ba.solve(prob, opts)
    common.sync(dev)
    full_ms = (time.perf_counter() - t0) * 1e3
    ms["lm_iteration"] = full_ms / st.num_iterations

    on_card = dev.type == "cuda"
    roofline = {k: {"gb_moved": b / 1e9,
                    "bound_ms": b / common.HBM_BYTES_PER_S * 1e3
                    if on_card else None,
                    "achieved_gbps": b / 1e9 / (ms[k] / 1e3)
                    if on_card else None}
                for k, b in gbytes.items()}
    return {"what": f"iterative BA phases at {I} cameras, {N} observations, "
                    f"{shapes['dtype']} (dagsfm_tpu_torch/tools/"
                    "ba_phase_profile.py)",
            "shapes": shapes, "ms": ms, "roofline": roofline,
            "full_solve": {"ms": full_ms, "lm_iterations": st.num_iterations,
                           "cg_iterations": st.cg_iterations,
                           "initial_cost": st.initial_cost,
                           "final_cost": st.final_cost},
            "hbm_bytes_per_s": common.HBM_BYTES_PER_S,
            "peak_f32_flops": common.PEAK_F32_FLOPS,
            "timing": "CUDA events (device ms); lm_iteration host clock "
                      "ended by a sync" if on_card else "host clock",
            "device": dev.type, "card": common.card(dev)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None, help="also write the record here")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    common.emit(run(args.smoke, args.device), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
