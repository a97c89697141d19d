"""Runner `ba`: repeated bundle adjustment solves of one problem
(`sfm/bundle_adjustment.solve`), each from a start drawn from the seed.

Traffic keys: `pool_seed` and `starts`: the problem and a pool of
`starts` starts, all drawn from `pool_seed`, so that every run solves
the same set of problems and its work does not change with the run's
seed; the run's seed orders the pool (the window cycles over it in that
order, and ends only on a whole pass: `cycle`) and draws the judged
solves. `check_solves` (solves judged after
the window), `judge_iterations` (the reference's LM iterations from a
judged solution), `limits`. The configuration gives the problem's
shape, the cameras, the solver's options and the sizes of the
perturbations.

One unit of work is one solve to the solver's own stopping rule; its
work is 1.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sfmbench import scenes
from sfmbench.reference import ba as ref_ba


class State:
    pass


def make_truth(cfg: dict, seed: int, dev) -> dict:
    pr = cfg["problem"]
    return scenes.bal_truth(
        pr["num_cameras"], pr["num_points"], pr["num_observations"],
        pr["width"], pr["height"], pr["focal_factor"], pr["focal_spread"],
        tuple(pr["k1_range"]), tuple(pr["k2_range"]), pr["ring_radius"],
        pr["ring_height_jitter"], pr["ball_radius"], pr["pixel_noise"],
        seed, dev)


def _padded(intr: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((intr.shape[0], 12), dtype=intr.dtype,
                      device=intr.device)
    out[:, :5] = intr
    return out


def setup(cfg: dict, mix: dict, seed: int, dev) -> State:
    from dagsfm_tpu_torch.scene import cameras as cm
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba

    st = State()
    st.cfg, st.mix, st.seed, st.dev = cfg, mix, seed, dev
    st.limits = mix["limits"]
    pool = mix["pool_seed"]
    st.truth = truth = make_truth(cfg, pool, dev)
    sv, rf = cfg["solver"], cfg["refine"]
    I = cfg["problem"]["num_cameras"]
    mids = np.full(I, cm.CAMERA_MODEL_IDS[cfg["camera_model"]])
    const_image = np.zeros(I, bool)
    const_image[:sv["held_images"]] = True
    host = (lambda a: a.cpu().numpy())
    st.prob = ba.problem_from_observations(
        host(truth["qvec"]), host(truth["tvec"]), np.arange(I), mids,
        host(_padded(truth["intr"])), host(truth["points"]),
        host(truth["obs_image"]), host(truth["obs_point"]),
        host(truth["obs_xy"]), const_image=const_image,
        cam_refine=cm.intrinsics_refine_mask(
            mids, rf["focal"], rf["principal"], rf["extra"]), device=dev)
    st.opts = ba.BAOptions(
        max_iterations=sv["max_iterations"], loss=sv["loss"],
        loss_scale=sv["loss_scale"], refine_focal=rf["focal"],
        refine_principal=rf["principal"], refine_extra=rf["extra"],
        solver=sv["solver"], ftol=sv["ftol"], linear_rtol=sv["linear_rtol"])
    st.solve = ba.solve
    st.starts = [scenes.bal_start(truth, cfg["start"], sv["held_images"],
                                  pool, k) for k in range(mix["starts"])]
    st.order = [int(k) for k in np.random.default_rng(
        [int(seed), 13]).permutation(mix["starts"])]
    st.next = 0
    st.solves = []              # (start index, output problem, stats)
    st.counters = dict(solves=0, iterations=0, cg_iterations=0,
                       solve_s=0.0)
    return st


def _problem(st, k):
    s = st.starts[k]
    return st.prob._replace(image_qvec=s["qvec"].clone(),
                            image_tvec=s["tvec"].clone(),
                            cam_params=_padded(s["intr"]),
                            points=s["points"].clone())


def warmup(st) -> None:
    st.solve(_problem(st, st.order[0]), st.opts, max_iters=2)


def cycle(st) -> int:
    return len(st.order)


def reset(st) -> None:
    st.solves.clear()
    for k in st.counters:
        st.counters[k] = type(st.counters[k])(0)


def unit(st) -> int:
    k = st.order[st.next]
    st.next = (st.next + 1) % len(st.order)
    prob = _problem(st, k)
    if st.dev.type == "cuda":
        torch.cuda.synchronize(st.dev)
    t0 = time.perf_counter()
    out, stats = st.solve(prob, st.opts)
    if st.dev.type == "cuda":
        torch.cuda.synchronize(st.dev)
    c = st.counters
    c["solve_s"] += time.perf_counter() - t0
    c["solves"] += 1
    c["iterations"] += stats.num_iterations
    c["cg_iterations"] += stats.cg_iterations
    st.solves.append((k, out, stats))
    return 1


def e2e(st, seconds: float) -> dict:
    return {"ba_solve_s": seconds / max(st.counters["solves"], 1)}


def counters(st) -> dict:
    pr = st.cfg["problem"]
    return dict(st.counters, N=pr["num_observations"], P=pr["num_points"],
                I=pr["num_cameras"], C=pr["num_cameras"])


def release(st) -> None:
    keep = []
    for k, out, stats in st.solves:
        keep.append((k, dict(qvec=out.image_qvec, tvec=out.image_tvec,
                             intr=out.cam_params[:, :5], points=out.points),
                     float(stats.final_cost)))
    st.solves = keep
    st.prob = None


def _observations(st, dtype):
    t = st.truth
    return ref_ba.prepare(t["obs_image"], t["obs_point"], t["obs_xy"],
                          t["qvec"].shape[0], t["points"].shape[0], dtype)


def judge(st, solution: dict, reported_cost: float, obs) -> tuple:
    """(cost_gap, descent_left) of one solution against the reference."""
    sv = st.cfg["solver"]
    sol = ref_ba.from_program(solution["qvec"], solution["tvec"],
                              solution["intr"], solution["points"])
    c = float(ref_ba.cost(sol, obs, sv["loss_scale"]))
    _, c_after, _ = ref_ba.lm(sol, obs, sv["held_images"],
                              st.mix["judge_iterations"], 0.0,
                              sv["loss_scale"])
    return abs(reported_cost - c) / c, (c - c_after) / c


def _numbers(st, judged) -> tuple:
    gaps = [g for g, _ in judged]
    left = [d for _, d in judged]
    st.parts = dict(cost_gap=gaps, descent_left=left)
    L = st.limits
    failed = sum(int(g > L["cost_gap"] or d > L["descent_left"])
                 for g, d in judged)
    return ([("cost_gap", max(gaps), L["cost_gap"]),
             ("descent_left", max(left), L["descent_left"])], failed)


def check(st, seed: int) -> tuple:
    rng = np.random.default_rng([int(seed), 11])
    picks = sorted(rng.choice(len(st.solves), min(st.mix["check_solves"],
                                                  len(st.solves)),
                              replace=False))
    obs = _observations(st, torch.float64)
    judged = [judge(st, st.solves[i][1], st.solves[i][2], obs)
              for i in picks]
    return _numbers(st, judged)


def control(st, seed: int) -> tuple:
    """The control's numbers: the reference in the program's place, in
    float32, on a start drawn as `check` draws a solve."""
    sv = st.cfg["solver"]
    rng = np.random.default_rng([int(seed), 11])
    obs32 = _observations(st, torch.float32)
    obs64 = _observations(st, torch.float64)
    judged = []
    for k in sorted(rng.choice(len(st.starts), min(st.mix["check_solves"],
                                                   len(st.starts)),
                               replace=False)):
        s = st.starts[k]
        sol = ref_ba.from_program(s["qvec"], s["tvec"], s["intr"],
                                  s["points"], torch.float32)
        sol, c, _ = ref_ba.lm(sol, obs32, sv["held_images"],
                              sv["max_iterations"], sv["ftol"],
                              sv["loss_scale"])
        q = torch.as_tensor(scenes.rotmat_to_quat_np(
            sol["R"].double().cpu().numpy()), device=st.dev)
        out = dict(qvec=q, tvec=sol["tvec"].double(),
                   intr=sol["intr"].double(), points=sol["points"].double())
        judged.append(judge(st, out, c, obs64))
    return _numbers(st, judged)
