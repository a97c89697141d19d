"""The port's sharded BA (parallel/ba_sharded.py), sharded rotation
averaging and sharded matching against the JAX package's, on the CPU.

`shard_problem`'s arrays equal the reference's exactly at D = 1, 4 and 8.
`solve_sharded` (dense Schur, iterative PCG, joint with the intrinsics)
and `estimate_rotations_sharded` agree with the reference's at the same D
to rel 1e-9 (float64; psum and all_reduce add in other orders): on one
rank, and on four gloo ranks, spawned once for the module, which run
every case. The port's twins of tests/test_ba_sharded.py hold the solver
to the same limits as the reference's.

The same solves, on one rank and on the four gloo ranks, against the
benchmark's plain blocked reference of the sharded rule
(sfmbench/reference/ba_blocked.py): the observations kept, the cost of
what a solve returns, and (iterative and joint) the share of the start's
cost it removes against the reference's run of the rule, within the
limits of the cell `ba.final13682x4`; the collectives each solve counts.
"""
import json
import multiprocessing as mp
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.estimation import rotation_averaging as j_ra
from dagsfm_tpu.features.matching import MatchingOptions
from dagsfm_tpu.ops import rotations as j_rops
from dagsfm_tpu.parallel import ba_sharded as j_bs
from dagsfm_tpu.parallel.matching_sharded import match_pairs_sharded
from dagsfm_tpu.parallel.mesh import make_mesh
from dagsfm_tpu.scene import cameras as j_cm
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu.sfm import bundle_adjustment as j_ba
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.estimation import rotation_averaging as t_ra
from dagsfm_tpu_torch.ops import rotations as t_rops
from dagsfm_tpu_torch.parallel import ba_sharded as t_bs
from dagsfm_tpu_torch.parallel import matching_sharded as t_ms
from dagsfm_tpu_torch.scene import synthetic as t_syn
from dagsfm_tpu_torch.sfm import bundle_adjustment as t_ba
from sfmbench.reference import ba_blocked

torch.set_num_threads(1)
RTOL = 1e-9
LIMITS = json.loads((Path(__file__).resolve().parents[1] / "sfmbench" /
                     "traffic" / "sharded_start_pool2.json").read_text())[
                         "limits"]


def perturbed_arrays(seed=3, pixel_noise=0.5):
    """tests/test_ba_sharded.py's perturbed 12-camera scene (with pixel
    noise, so the final cost stays a number to compare)."""
    sc = j_syn.generate(j_syn.SyntheticSceneSpec(
        num_cameras=12, num_points=250, pixel_noise=pixel_noise,
        seed=seed))
    arrays = j_syn.to_scene_arrays(sc, dtype=np.float64)
    rng = np.random.default_rng(seed + 1)
    qvec = np.array(arrays.image_qvec)
    tvec = np.array(arrays.image_tvec)
    for i in range(2, len(qvec)):
        dq = j_rops.angleaxis_to_quat(jnp.asarray(rng.normal(0, 0.01, 3)))
        qvec[i] = np.asarray(j_rops.quat_multiply(dq, jnp.asarray(qvec[i])))
        tvec[i] += rng.normal(0, 0.05, 3)
    pts = np.array(arrays.points_xyz) + rng.normal(
        0, 0.05, arrays.points_xyz.shape)
    return arrays._replace(image_qvec=qvec, image_tvec=tvec,
                           points_xyz=pts), sc


def port_arrays(arrays):
    return interop.scene_arrays({k: np.asarray(v) for k, v in
                                 arrays._asdict().items()}, device="cpu")


def radial_arrays():
    """tests/test_ba_sharded.py's SIMPLE_RADIAL scene with focal +8 % and
    k1 = 0.03, and its refine mask (focal and extra)."""
    sc = j_syn.generate(j_syn.SyntheticSceneSpec(
        num_cameras=12, num_points=200, seed=11, pixel_noise=0.5,
        camera_model="SIMPLE_RADIAL"))
    arrays = j_syn.to_scene_arrays(sc, dtype=np.float64)
    cp = np.array(arrays.cam_params)
    cp[0, 0] *= 1.08
    cp[0, 3] = 0.03
    refine = np.asarray(j_cm.intrinsics_refine_mask(
        arrays.cam_model_id, refine_focal=True, refine_principal=False,
        refine_extra=True))
    return arrays._replace(cam_params=cp), refine, sc


# case -> (scene, D, BAOptions fields)
CASES = {
    "dense-1": ("plain", 1, dict(max_iterations=4, solver="dense")),
    "dense-8": ("plain", 8, dict(max_iterations=4, solver="dense")),
    "iterative-8": ("plain", 8, dict(max_iterations=4, solver="iterative")),
    "joint-8": ("radial", 8, dict(max_iterations=4, refine_focal=True,
                                  refine_extra=True, loss_scale=2.0)),
}


@pytest.fixture(scope="module")
def scenes():
    plain, _ = perturbed_arrays()
    radial, refine, _ = radial_arrays()
    return {"plain": (plain, None), "radial": (radial, refine)}


@pytest.fixture(scope="module")
def reference(scenes):
    """The JAX package's sharded solves: case -> (fields, shard_pts,
    (qvec, tvec, cam_params, gathered points, [cost0, cost1]))."""
    out = {}
    for name, (scene, D, opts) in CASES.items():
        arrays, refine = scenes[scene]
        prob, shard_pts = j_bs.shard_problem(arrays, D, cam_refine=refine)
        mesh = make_mesh(D)
        res, st = j_bs.solve_sharded(j_bs.place(prob, mesh), mesh,
                                     j_ba.BAOptions(**opts))
        n = arrays.points_xyz.shape[0]
        out[name] = ({k: np.asarray(v) for k, v in prob._asdict().items()},
                     shard_pts,
                     (np.asarray(res.image_qvec), np.asarray(res.image_tvec),
                      np.asarray(res.cam_params),
                      j_bs.gather_points(res, shard_pts, n),
                      np.array([float(st.initial_cost),
                                float(st.final_cost)])))
    return out


def assert_close(port, ref, what=""):
    port, ref = np.asarray(port), np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max(), err_msg=what)


def assert_solve_equal(got: tuple, want: tuple):
    for name, a, b in zip(("qvec", "tvec", "cam_params", "points", "cost"),
                          got, want):
        assert_close(a, b, name)


@pytest.mark.parametrize("D", [1, 4, 8])
def test_shard_problem_equals_reference(scenes, D):
    arrays, refine = scenes["plain" if D != 4 else "radial"]
    const = None
    if D == 4:
        const = np.zeros(arrays.image_qvec.shape[0], bool)
        const[[0, 5]] = True
    ref, ref_pts = j_bs.shard_problem(arrays, D, const_image=const,
                                      cam_refine=refine)
    got, got_pts = t_bs.shard_problem(port_arrays(arrays), D,
                                      const_image=const, cam_refine=refine,
                                      device="cpu")
    for f in j_bs.ShardedBAProblem._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert len(ref_pts) == len(got_pts) == D
    for a, b in zip(ref_pts, got_pts):
        np.testing.assert_array_equal(b, a)
    # the reference's shards as the port's, through interop
    back = interop.sharded_problem(ref._asdict(), device="cpu")
    for f in j_bs.ShardedBAProblem._fields:
        assert torch.equal(getattr(back, f), getattr(got, f)), f


def _port_solve(prob, shard_pts, n, opts):
    res, st = t_bs.solve_sharded(prob, t_ba.BAOptions(**opts))
    return (res.image_qvec.numpy(), res.image_tvec.numpy(),
            res.cam_params.numpy(), t_bs.gather_points(res, shard_pts, n),
            np.array([st.initial_cost, st.final_cost])), st


@pytest.mark.parametrize("case", list(CASES))
def test_solve_sharded_equals_reference_on_one_rank(scenes, reference,
                                                    case):
    scene, D, opts = CASES[case]
    arrays, refine = scenes[scene]
    prob, shard_pts = t_bs.shard_problem(port_arrays(arrays), D,
                                         cam_refine=refine, device="cpu")
    got, st = _port_solve(prob, shard_pts, arrays.points_xyz.shape[0], opts)
    assert_solve_equal(got, reference[case][2])
    assert st.num_iterations == opts["max_iterations"]
    assert st.final_cost < 0.5 * st.initial_cost


def ra_problem():
    """tests/test_rotation_averaging.py's sharded case: 20 rotations,
    edges to the next three, 0.01 rad of noise."""
    rng = np.random.default_rng(3)
    n = 20

    def rand_quat():
        q = rng.normal(size=4)
        return q / np.linalg.norm(q)

    Rg = np.stack([j_rops.quat_to_rotmat_np(rand_quat()) for _ in range(n)])
    edges, rels = [], []
    for i in range(n):
        for j in range(i + 1, min(i + 4, n)):
            edges.append((i, j))
            Rn = np.asarray(j_rops.quat_to_rotmat(j_rops.angleaxis_to_quat(
                jnp.asarray(rng.normal(0, 0.01, 3)))))
            rels.append(Rn @ Rg[j] @ Rg[i].T)
    opts = j_ra.RAOptions(l1_iterations=5, irls_iterations=20,
                          cg_iterations=30)
    return n, np.array(edges, np.int32), np.stack(rels), opts


@pytest.mark.parametrize("D", [1, 8])
def test_estimate_rotations_sharded_equals_reference(D):
    n, edges, rels, opts = ra_problem()
    ref = j_ra.estimate_rotations_sharded(n, edges, rels, make_mesh(D), opts)
    got = t_ra.estimate_rotations_sharded(n, edges, rels,
                                          t_ra.RAOptions(*opts),
                                          num_shards=D, device="cpu")
    assert_close(got, ref)
    # and the one-process solve, as the reference's test holds it
    whole = t_ra.estimate_rotations(n, edges, rels, t_ra.RAOptions(*opts),
                                    device="cpu")
    np.testing.assert_allclose(got, whole, atol=1e-9)


def match_problem():
    """tests/test_db_matchers.py's sharded-matching descriptors."""
    rng = np.random.default_rng(7)
    K = 64
    descs, masks = {}, {}
    base = rng.normal(0, 1, (40, 128)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    for i in range(6):
        d = base + rng.normal(0, 0.05, base.shape).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        descs[i] = np.zeros((K, 128), np.float32)
        descs[i][:40] = d
        masks[i] = np.zeros(K, bool)
        masks[i][:40] = True
    return descs, masks, [(i, j) for i in range(6) for j in range(i + 1, 6)]


@pytest.fixture(scope="module")
def four_gloo_ranks(reference, tmp_path_factory):
    """Every D = 8 case on four gloo ranks, in one spawn: the ranks'
    outputs (one dict per rank)."""
    import torch_ranks

    tmp = tmp_path_factory.mktemp("gloo")
    n, edges, rels, ra_opts = ra_problem()
    cases = {
        "ba": {name: (fields, CASES[name][2], shard_pts,
                      len(np.concatenate(shard_pts)))
               for name, (fields, shard_pts, _) in reference.items()
               if CASES[name][1] == 8},
        "ra": (n, edges, rels, ra_opts._asdict(), 8),
        "match": match_problem() + (8,)}
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=torch_ranks.gloo_rank,
                         args=(r, 4, str(tmp / "store"), cases, str(tmp)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][1] == 8])
def test_solve_sharded_equals_reference_on_four_gloo_ranks(
        reference, four_gloo_ranks, case):
    for out in four_gloo_ranks:
        got = tuple(out[f"{case}.{k}"] for k in ("qvec", "tvec",
                                                  "cam_params", "points",
                                                  "cost"))
        assert_solve_equal(got, reference[case][2])
    # every rank holds the same result, to the bit
    for out in four_gloo_ranks[1:]:
        for k, v in four_gloo_ranks[0].items():
            np.testing.assert_array_equal(out[k], v, err_msg=k)


def test_rotations_and_matches_sharded_on_four_gloo_ranks(four_gloo_ranks):
    n, edges, rels, opts = ra_problem()
    ref = j_ra.estimate_rotations_sharded(n, edges, rels, make_mesh(8), opts)
    descs, masks, pairs = match_problem()
    ref_m = match_pairs_sharded(descs, masks, pairs, MatchingOptions(),
                                mesh=make_mesh(8))
    for out in four_gloo_ranks:
        assert_close(out["ra"], ref)
        for (i, j) in pairs:
            np.testing.assert_array_equal(out[f"match.{i}.{j}"],
                                          ref_m[(i, j)])


def test_matches_sharded_equal_reference_on_one_rank():
    descs, masks, pairs = match_problem()
    ref = match_pairs_sharded(descs, masks, pairs, MatchingOptions(),
                              mesh=make_mesh(8))
    for D in (1, 8):
        got = t_ms.match_pairs_sharded(descs, masks, pairs, num_shards=D,
                                       device="cpu")
        assert set(got) == set(ref)
        for p in pairs:
            np.testing.assert_array_equal(got[p], ref[p])
            assert got[p].dtype == np.uint32 and len(got[p]) > 10


# --- twins of tests/test_ba_sharded.py, on the port alone --------------


def test_sharded_ba_converges():
    arrays, sc = perturbed_arrays(0, pixel_noise=0.0)
    prob, _ = t_bs.shard_problem(port_arrays(arrays), 8, device="cpu")
    out, st = t_bs.solve_sharded(prob, t_ba.BAOptions(max_iterations=20))
    assert st.final_cost < st.initial_cost * 1e-5, st
    ang = t_rops.rotation_angle_deg(
        torch.as_tensor(sc.R), t_rops.quat_to_rotmat(out.image_qvec)).numpy()
    assert ang.max() < 0.01, ang.max()


def test_sharded_matches_dense():
    arrays, _ = perturbed_arrays(3, pixel_noise=0.0)
    const = np.zeros(arrays.image_qvec.shape[0], bool)
    const[:2] = True
    opts = t_ba.BAOptions(max_iterations=15)
    dense, _ = t_ba.solve(t_ba.make_problem(port_arrays(arrays),
                                            const_image=const), opts)
    prob, shard_pts = t_bs.shard_problem(port_arrays(arrays), 8,
                                         const_image=const, device="cpu")
    out, _ = t_bs.solve_sharded(prob, opts)
    np.testing.assert_allclose(out.image_qvec.numpy(),
                               dense.image_qvec.numpy(), atol=1e-6)
    np.testing.assert_allclose(out.image_tvec.numpy(),
                               dense.image_tvec.numpy(), atol=1e-5)
    pts = t_bs.gather_points(out, shard_pts, arrays.points_xyz.shape[0])
    np.testing.assert_allclose(pts, dense.points.numpy(), atol=1e-5)


def test_shard_problem_structure():
    arrays, _ = perturbed_arrays(1)
    prob, shard_pts = t_bs.shard_problem(port_arrays(arrays), 4,
                                         device="cpu")
    assert prob.points.shape[0] == 4
    assert sum(len(s) for s in shard_pts) == arrays.points_xyz.shape[0]
    for d in range(4):
        om = prob.obs_mask[d].numpy()
        op = prob.obs_point[d].numpy()[om]
        assert (op < len(shard_pts[d])).all()
        np.testing.assert_allclose(prob.points[d].numpy()[op],
                                   np.asarray(arrays.points_xyz)[
                                       shard_pts[d][op]])


def test_sharded_iterative_matches_dense_sharded():
    arrays, _ = perturbed_arrays(3, pixel_noise=0.0)
    prob, _ = t_bs.shard_problem(port_arrays(arrays), 8, device="cpu")
    outd, sd = t_bs.solve_sharded(prob, t_ba.BAOptions(max_iterations=10,
                                                       solver="dense"))
    outi, si = t_bs.solve_sharded(prob, t_ba.BAOptions(
        max_iterations=10, solver="iterative", linear_rtol=1e-11))
    np.testing.assert_allclose(si.final_cost, sd.final_cost, rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(outi.image_tvec.numpy(),
                               outd.image_tvec.numpy(), atol=1e-6)


def test_sharded_iterative_large_scene():
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=300, num_points=3000, pixel_noise=0.3, seed=9,
        max_track_length=8))
    arrays = t_syn.to_scene_arrays(sc, "cpu")
    rng = np.random.default_rng(10)
    arrays = arrays._replace(points_xyz=arrays.points_xyz + torch.as_tensor(
        rng.normal(0, 0.02, tuple(arrays.points_xyz.shape))))
    prob, _ = t_bs.shard_problem(arrays, 8, device="cpu")
    _, st = t_bs.solve_sharded(prob, t_ba.BAOptions(max_iterations=8,
                                                    solver="iterative"))
    assert st.final_cost < 0.2 * st.initial_cost, st


def test_sharded_intrinsics_refinement():
    arrays, refine, sc = radial_arrays()
    f_gt = float(sc.camera.params[0])
    prob, _ = t_bs.shard_problem(port_arrays(arrays), 8, cam_refine=refine,
                                 device="cpu")
    out, st = t_bs.solve_sharded(prob, t_ba.BAOptions(
        max_iterations=25, refine_focal=True, refine_extra=True,
        loss_scale=2.0))
    f_rec, k_rec = float(out.cam_params[0, 0]), float(out.cam_params[0, 3])
    assert abs(f_rec - f_gt) / f_gt < 0.01, (f_rec, f_gt)
    assert abs(k_rec) < 0.01, k_rec
    assert st.final_cost < 0.05 * st.initial_cost


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    """shard_problem, interop.sharded_problem, estimate_rotations_sharded
    and match_pairs_sharded run on the card unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays, _ = perturbed_arrays(1)
    targ = port_arrays(arrays)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_bs.shard_problem(targ, 2)
    prob, _ = j_bs.shard_problem(arrays, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.sharded_problem(prob._asdict())
    n, edges, rels, opts = ra_problem()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ra.estimate_rotations_sharded(n, edges, rels)
    descs, masks, pairs = match_problem()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ms.match_pairs_sharded(descs, masks, pairs)


# --- against the benchmark's blocked reference of the sharded rule -----


def _blocked(arrays, refine, block=ba_blocked.BLOCK):
    """The reference's observations of a scene (its live ones, in their
    order) and the start's solution."""
    a = {k: torch.as_tensor(np.asarray(v)) for k, v in
         arrays._asdict().items()}
    live = torch.nonzero(a["obs_mask"].bool())[:, 0]
    obs = ba_blocked.prepare(a["obs_image"][live], a["obs_point"][live],
                             a["obs_xy"][live], a["image_camidx"],
                             a["points_xyz"].shape[0], 16, block=block)
    sol = ba_blocked.solution(a["image_qvec"], a["image_tvec"],
                              a["cam_params"], a["points_xyz"],
                              a["image_camidx"])
    free = torch.zeros((a["cam_params"].shape[0], 3), dtype=torch.float64) \
        if refine is None else torch.as_tensor(np.asarray(refine))[:, [0, 4,
                                                                      5]]
    held = torch.zeros(a["image_qvec"].shape[0], dtype=torch.bool)
    held[:2] = True
    return a, live, obs, sol, held, free


def _blocked_numbers(arrays, refine, opts, fields, shard_pts, result):
    """The check's numbers of a sharded solve (result: qvec, tvec,
    cam_params, gathered points, [initial, final] cost): its kept
    observations against the reference's, the cost gap, and for the
    iterative rule the descent gap."""
    a, live, obs, sol0, held, free = _blocked(arrays, refine)
    # kept (image, point) pairs: the program's shards against the rule
    om = np.asarray(fields["obs_mask"])
    prog = {(int(i), int(shard_pts[d][p]))
            for d in range(om.shape[0])
            for i, p in zip(np.asarray(fields["obs_image"])[d][om[d]],
                            np.asarray(fields["obs_point"])[d][om[d]])}
    want = {(int(i), int(p)) for i, p in zip(obs["image"], obs["point"])}
    assert prog == want and len(want) == int(obs["kept"].sum())
    qvec, tvec, cams, points, cost = (torch.as_tensor(np.asarray(x))
                                      for x in result)
    c = float(ba_blocked.cost(ba_blocked.solution(
        qvec, tvec, cams, points, a["image_camidx"]), obs,
        opts.get("loss_scale", 1.0)))
    out = dict(cost_gap=abs(float(cost[1]) - c) / c)
    if opts.get("solver") != "dense":
        o = t_ba.BAOptions(**opts)
        _, c0, c1, _ = ba_blocked.lm(
            sol0, obs, held, free, o.max_iterations, o.loss_scale,
            o.linear_rtol, o.max_linear_iterations, o.init_lambda,
            o.point_damping)
        removed = (float(cost[0]) - float(cost[1])) / float(cost[0])
        out["descent_gap"] = abs(removed - (c0 - c1) / c0) / \
            ((c0 - c1) / c0)
    return out


def _assert_within_limits(found):
    for name, value in found.items():
        assert value <= LIMITS[name], (name, value)


@pytest.mark.parametrize("case", list(CASES))
def test_solve_sharded_equals_blocked_reference_on_one_rank(scenes, case):
    scene, D, opts = CASES[case]
    arrays, refine = scenes[scene]
    prob, shard_pts = t_bs.shard_problem(port_arrays(arrays), D,
                                         cam_refine=refine, device="cpu")
    got, _ = _port_solve(prob, shard_pts, arrays.points_xyz.shape[0], opts)
    fields = {k: v.numpy() for k, v in prob._asdict().items()}
    found = _blocked_numbers(arrays, refine, opts, fields, shard_pts, got)
    assert found["cost_gap"] <= 1e-12
    _assert_within_limits(found)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][1] == 8])
def test_solve_sharded_equals_blocked_reference_on_four_gloo_ranks(
        scenes, reference, four_gloo_ranks, case):
    scene, _, opts = CASES[case]
    arrays, refine = scenes[scene]
    fields, shard_pts, _ = reference[case]
    for out in four_gloo_ranks:
        got = tuple(out[f"{case}.{k}"] for k in ("qvec", "tvec",
                                                  "cam_params", "points",
                                                  "cost"))
        found = _blocked_numbers(arrays, refine, opts, fields, shard_pts,
                                 got)
        assert found["cost_gap"] <= 1e-12
        _assert_within_limits(found)
        # one collective for each cost (the start's and each trial's),
        # one per LM step for its blocks, one per CG iteration, one for
        # the points at the end
        steps = opts["max_iterations"]
        assert int(out[f"{case}.lm_steps"]) == steps
        assert int(out[f"{case}.allreduce"]) == \
            2 + 2 * steps + int(out[f"{case}.cg_iterations"])
        assert int(out[f"{case}.allreduce_bytes"]) > 0


@pytest.mark.parametrize("block", [1, 7, 64])
def test_blocked_reference_is_the_same_for_any_block_size(scenes, block):
    arrays, refine = scenes["radial"]
    _, _, whole, sol, held, free = _blocked(arrays, refine)
    _, _, blocks, _, _, _ = _blocked(arrays, refine, block)
    a, b = float(ba_blocked.cost(sol, whole, 2.0)), \
        float(ba_blocked.cost(sol, blocks, 2.0))
    assert abs(a - b) <= 1e-12 * a
    ra = ba_blocked.lm(sol, whole, held, free, 2, 2.0)
    rb = ba_blocked.lm(sol, blocks, held, free, 2, 2.0)
    assert ra[3] == rb[3]
    np.testing.assert_allclose(ra[2], rb[2], rtol=1e-9)
    np.testing.assert_allclose(ra[0]["points"].numpy(),
                               rb[0]["points"].numpy(), rtol=1e-7,
                               atol=1e-9)


def test_blocked_reference_decimates_uniformly():
    """A track of 40 keeps 16 observations spread along it, at the
    positions where (p 16) // 40 steps; shorter tracks keep all."""
    op = torch.cat([torch.zeros(40, dtype=torch.long),
                    torch.ones(16, dtype=torch.long),
                    torch.full((3,), 2, dtype=torch.long)])
    op = op[torch.randperm(len(op), generator=torch.Generator()
                           .manual_seed(0))]
    keep = ba_blocked.kept(op, 3, 16)
    pos = torch.cumsum((op == 0).long(), 0) - 1
    want = (op != 0) | ((pos * 16) // 40 != ((pos + 1) * 16) // 40)
    assert torch.equal(keep, want) and int(keep[op == 0].sum()) == 16


def test_partition_balanced_equals_the_greedy_loop():
    """The heap's partition is the plain greedy loop's: each item, largest
    first, to the first of the least loaded bins."""
    from dagsfm_tpu_torch.parallel.mesh import partition_balanced

    def loop(sizes, num_bins):
        loads = np.zeros(num_bins)
        assign = np.zeros(len(sizes), np.int32)
        for i in np.argsort(-np.asarray(sizes)):
            b = int(np.argmin(loads))
            assign[i] = b
            loads[b] += sizes[i]
        return assign

    rng = np.random.default_rng(0)
    for n, bins in ((2000, 4), (333, 8), (50, 3), (7, 1), (0, 4)):
        for sizes in (rng.geometric(0.3, n), rng.random(n) * 10,
                      np.ones(n, int)):
            np.testing.assert_array_equal(partition_balanced(sizes, bins),
                                          loop(sizes, bins))


def test_init_ranks_on_the_cpu(monkeypatch):
    """One rank on the CPU: gloo, the CPU, from an explicit address and,
    as under torchrun, from the environment."""
    import socket

    import torch.distributed as tdist

    from dagsfm_tpu_torch.parallel import mesh

    def port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for env in (False, True):
        if env:
            for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"),
                         ("MASTER_ADDR", "localhost"),
                         ("MASTER_PORT", str(port()))):
                monkeypatch.setenv(k, v)
            dev = mesh.init_ranks(timeout_s=30)
        else:
            dev = mesh.init_ranks(0, 1, f"tcp://localhost:{port()}",
                                  timeout_s=30)
        try:
            assert dev == torch.device("cpu")
            assert tdist.get_backend() == "gloo"
            assert mesh.process_group()[1:] == (0, 1)
            x = torch.ones(3, dtype=torch.float64)
            assert torch.equal(mesh.all_reduce(x), torch.ones(3))
        finally:
            tdist.destroy_process_group()
