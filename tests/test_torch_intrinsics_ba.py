"""Port bundle adjustment with intrinsics refinement and the iterative
PCG solver vs the JAX reference, float64.

The reference's BAProblem goes through `interop.ba_problem` (its live
observations, in its image-major order), so both packages solve the
same problem: residuals and Jacobians agree to rtol 1e-10, the cost
after one LM iteration (dense joint, iterative, iterative joint) to rel
1e-8, and the camera after a dense joint solve to convergence to rel
1e-7. The sums run in different orders, hence not to the bit."""
import jax
import numpy as np
import pytest
import torch

from dagsfm_tpu.scene import cameras as j_cm
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu.sfm import bundle_adjustment as j_ba
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.sfm import bundle_adjustment as t_ba

torch.set_num_threads(1)


def _arrays(model="SIMPLE_RADIAL", seed=6, num_cameras=10, num_points=150,
            noise=0.3):
    """The reference test's perturbed-intrinsics scene (focal +10 %, first
    distortion term 0.05) with pixel noise and, for models with more
    terms, small random ones."""
    sc = j_syn.generate(j_syn.SyntheticSceneSpec(
        num_cameras=num_cameras, num_points=num_points, seed=seed,
        pixel_noise=noise))
    arrays, _ = j_syn.to_reconstruction(sc).to_arrays()
    mid = j_cm.CAMERA_MODEL_IDS[model]
    n = j_cm.CAMERA_MODEL_NUM_PARAMS[mid]
    f = float(arrays.cam_params[0, 0])
    cx, cy = float(arrays.cam_params[0, 1]), float(arrays.cam_params[0, 2])
    base = ([f, cx, cy] if mid in j_cm._SINGLE_FOCAL
            else [f, 1.02 * f, cx, cy])
    cp = np.zeros_like(np.asarray(arrays.cam_params))
    cp[:, :len(base)] = base
    cp[:, len(base):n] = np.random.default_rng(seed).normal(
        0.0, 0.01, (cp.shape[0], n - len(base)))
    cp[:, 0] *= 1.10
    cp[:, len(base)] = 0.05
    return arrays._replace(cam_params=cp, cam_model_id=np.full_like(
        np.asarray(arrays.cam_model_id), mid)), f


def _both(arrays, refine=(True, False, True), const=2):
    mask = None
    if refine is not None:
        mask = j_cm.intrinsics_refine_mask(arrays.cam_model_id, *refine)
    c = np.zeros(arrays.image_qvec.shape[0], bool)
    c[:const] = True
    jp = j_ba.make_problem(arrays, const_image=c, cam_refine=mask)
    return jp, interop.ba_problem(jp._asdict(), device="cpu")


def _opts(**kw):
    return (j_ba.BAOptions(**kw), t_ba.BAOptions(**kw))


@pytest.mark.parametrize("model", ["SIMPLE_RADIAL", "RADIAL", "OPENCV"])
def test_residuals_and_jacobians_with_intrinsics(model):
    arrays, _ = _arrays(model, seed=1, num_cameras=6, num_points=60)
    jp, tp = _both(arrays, (True, True, True), const=0)
    live = np.asarray(jp.obs_mask)
    ref = j_ba._residuals_and_jacobians(jp, True)
    port = t_ba._residuals_and_jacobians(tp, True)
    scale = np.abs(np.asarray(jp.obs_xy)).max()
    for name, a, b in zip(("r", "Jc", "Jp", "Jg"), port, ref):
        b = np.asarray(b)[live]
        atol = 1e-10 * scale if name == "r" else 0.0
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=atol,
                                   err_msg=name)
    assert np.abs(np.asarray(ref[3])).max() > 0
    # without refinement there is no Jg and the rest is unchanged
    r, Jc, Jp, Jg = t_ba._residuals_and_jacobians(tp, False)
    assert Jg is None and torch.equal(Jc, port[1]) and torch.equal(r, port[0])


@pytest.mark.parametrize("model", ["SIMPLE_RADIAL", "RADIAL", "OPENCV"])
def test_one_dense_joint_iteration(model):
    arrays, _ = _arrays(model)
    jp, tp = _both(arrays)
    jo, to = _opts(max_iterations=1, loss="cauchy", refine_focal=True,
                   refine_extra=True, solver="dense")
    jout, js = j_ba.solve(jp, jo)
    tout, ts = t_ba.solve(tp, to)
    assert ts.initial_cost == pytest.approx(float(js.initial_cost),
                                            rel=1e-12)
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=1e-8)
    assert ts.final_cost < 0.2 * ts.initial_cost
    np.testing.assert_allclose(tout.cam_params.numpy(),
                               np.asarray(jout.cam_params), rtol=1e-8)


@pytest.mark.parametrize("refine", [True, False])
def test_iterative_solve(refine):
    """The iterative PCG (joint when intrinsics refine): the first LM
    iteration, then five with the CG warm start carried across them."""
    arrays, _ = _arrays(seed=3, num_cameras=12, num_points=200)
    if not refine:
        cp = np.array(arrays.cam_params)
        cp[:, 0] /= 1.10
        cp[:, 3] = 0.0
        arrays = arrays._replace(cam_params=cp, points_xyz=np.asarray(
            arrays.points_xyz) + np.random.default_rng(0).normal(
                0, 0.03, np.shape(arrays.points_xyz)))
    jp, tp = _both(arrays, (True, False, True) if refine else None)
    jo, to = _opts(loss="trivial", refine_focal=refine, refine_extra=refine,
                   solver="iterative", ftol=0.0)
    jsolve = jax.jit(lambda p, k: j_ba.solve(p, jo, max_iters=k))
    for iters in (1, 5):
        jout, js = jsolve(jp, iters)
        tout, ts = t_ba.solve(tp, to, max_iters=iters)
        assert ts.final_cost == pytest.approx(float(js.final_cost),
                                              rel=1e-8), iters
        assert ts.lam == pytest.approx(float(js.lam), rel=1e-12)
        assert ts.num_iterations == iters and ts.cg_iterations >= iters
        np.testing.assert_allclose(tout.cam_params.numpy(),
                                   np.asarray(jout.cam_params), rtol=1e-8)
    assert ts.final_cost < 0.1 * ts.initial_cost


def test_dense_joint_to_convergence():
    arrays, f_gt = _arrays(seed=5)
    jp, tp = _both(arrays)
    jo, to = _opts(max_iterations=30, loss="trivial", refine_focal=True,
                   refine_extra=True)
    jout, js = jax.jit(lambda p: j_ba.solve(p, jo))(jp)
    tout, ts = t_ba.solve(tp, to)
    # at the noise floor the two may accept or reject a last step of no
    # gain differently, so the iteration counts may differ
    np.testing.assert_allclose(tout.cam_params.numpy(),
                               np.asarray(jout.cam_params), rtol=1e-7)
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=1e-7)
    assert abs(float(tout.cam_params[0, 0]) - f_gt) / f_gt < 0.01
    assert abs(float(tout.cam_params[0, 3])) < 0.005
    np.testing.assert_allclose(tout.points.numpy(), np.asarray(jout.points),
                               atol=1e-6)


@pytest.mark.parametrize("solver", ["dense", "iterative"])
def test_recovers_focal_and_k1(solver):
    """tests/test_bundle_adjustment.py's intrinsics recovery, on the port
    alone and without pixel noise: focal within 1 %, k1 near 0."""
    arrays, f_gt = _arrays(seed=6 if solver == "iterative" else 5,
                           noise=0.0)
    _, tp = _both(arrays)
    before = float(t_ba.mean_reproj_error_px(tp))
    assert before > 2.0
    out, st = t_ba.solve(tp, t_ba.BAOptions(
        max_iterations=30, loss="trivial", refine_focal=True,
        refine_extra=True, solver=solver))
    f_rec, k_rec = float(out.cam_params[0, 0]), float(out.cam_params[0, 3])
    assert abs(f_rec - f_gt) / f_gt < 0.01, (f_rec, f_gt)
    assert abs(k_rec) < (0.005 if solver == "dense" else 0.01), k_rec
    assert float(t_ba.mean_reproj_error_px(out)) < 0.1
    assert (st.cg_iterations > 0) == (solver == "iterative")


def test_refine_mask_respected():
    """Slots outside the refine mask do not move: focal only, k1 stays."""
    arrays, _ = _arrays(seed=7, noise=0.0)
    _, tp = _both(arrays, (True, False, False))
    out, _ = t_ba.solve(tp, t_ba.BAOptions(max_iterations=10, loss="trivial",
                                           refine_focal=True))
    assert float(out.cam_params[0, 3]) == 0.05
    assert float(out.cam_params[0, 1]) == float(tp.cam_params[0, 1])
    assert float(out.cam_params[0, 0]) != float(tp.cam_params[0, 0])


def test_auto_solver_picks_by_image_count():
    """solver='auto' is the dense solve up to dense_threshold images and
    the iterative one above it, as the reference picks."""
    arrays, _ = _arrays(seed=8, num_cameras=8, num_points=100)
    _, tp = _both(arrays)
    kw = dict(max_iterations=3, refine_focal=True, refine_extra=True)
    for threshold, solver in ((8, "dense"), (7, "iterative")):
        _, auto = t_ba.solve(tp, t_ba.BAOptions(dense_threshold=threshold,
                                                **kw))
        _, ref = t_ba.solve(tp, t_ba.BAOptions(solver=solver, **kw))
        assert auto == ref
    with pytest.raises(ValueError):
        t_ba.solve(tp, t_ba.BAOptions(solver="sparse"))
