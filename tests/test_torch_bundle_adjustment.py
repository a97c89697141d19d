"""Port bundle adjustment vs the JAX reference (Schur LM, pinhole).

The same SceneArrays go through both `make_problem`s: the kept
observation set must be the same (Knuth-hash track decimation), the cost
after one LM iteration equal to rtol 1e-9 for the dense step (as
__graft_entry__.entry's step) and 1e-8 for the iterative one, and the
cost after a full solve to rtol 1e-6, because the two sum the normal
equations in different orders. The pose-only step is the joint step with
every intrinsic slot held."""
import jax
import numpy as np
import pytest
import torch

from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu.sfm import bundle_adjustment as j_ba
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.ops import segment_sum as t_seg
from dagsfm_tpu_torch.sfm import bundle_adjustment as t_ba

torch.set_num_threads(1)


def _arrays(num_cameras=6, num_points=64, seed=0, noise=0.01):
    """The graft entry's scene: ground truth with perturbed points."""
    sc = j_syn.generate(j_syn.SyntheticSceneSpec(
        num_cameras=num_cameras, num_points=num_points, pixel_noise=0.3,
        seed=seed))
    arrays, _ = j_syn.to_reconstruction(sc).to_arrays()
    rng = np.random.default_rng(seed)
    return arrays._replace(points_xyz=arrays.points_xyz + rng.normal(
        0, noise, arrays.points_xyz.shape))


def _both(arrays, const_image, max_track_len=16):
    jp = j_ba.make_problem(arrays, max_track_len=max_track_len,
                           const_image=const_image)
    tp = t_ba.make_problem(interop.scene_arrays(arrays._asdict(),
                                                device="cpu"),
                           max_track_len=max_track_len,
                           const_image=const_image)
    return jp, tp


def _obs_set(img, pt, xy, mask=None):
    img, pt, xy = np.asarray(img), np.asarray(pt), np.asarray(xy)
    if mask is not None:
        m = np.asarray(mask)
        img, pt, xy = img[m], pt[m], xy[m]
    return sorted(zip(img.tolist(), pt.tolist(), xy[:, 0].tolist(),
                      xy[:, 1].tolist()))


@pytest.mark.parametrize("max_track_len", [16, 4, 3])
def test_make_problem_keeps_the_same_observations(max_track_len):
    arrays = _arrays(num_cameras=12, num_points=80, seed=3)
    const = np.zeros(12, bool)
    const[0] = True
    jp, tp = _both(arrays, const, max_track_len)
    ref = _obs_set(jp.obs_image, jp.obs_point, jp.obs_xy, jp.obs_mask)
    port = _obs_set(tp.obs_image, tp.obs_point, tp.obs_xy)
    assert port == ref
    if max_track_len < 12:        # decimation exercised
        assert len(port) < int(np.asarray(arrays.obs_mask).sum())
    np.testing.assert_array_equal(tp.const_image.numpy(), const)


@pytest.mark.parametrize("solver,rel", [("dense", 1e-9),
                                        ("iterative", 1e-8)])
@pytest.mark.parametrize("loss", ["cauchy", "huber", "trivial"])
def test_one_lm_iteration_cost(loss, solver, rel):
    arrays = _arrays()
    const = np.zeros(arrays.image_qvec.shape[0], bool)
    const[:2] = True
    jp, tp = _both(arrays, const)
    jo = j_ba.BAOptions(max_iterations=1, loss=loss, loss_scale=1.0,
                        solver=solver)
    to = t_ba.BAOptions(max_iterations=1, loss=loss, loss_scale=1.0,
                        solver=solver)
    _, js = j_ba.solve(jp, jo)
    out, ts = t_ba.solve(tp, to)
    assert ts.initial_cost == pytest.approx(float(js.initial_cost),
                                            rel=1e-12)
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=rel)
    assert ts.final_cost < ts.initial_cost
    assert ts.num_iterations == int(js.num_iterations) == 1
    assert ts.lam == pytest.approx(float(js.lam), rel=1e-12)
    assert float(t_ba.compute_cost(out, to)) == pytest.approx(
        ts.final_cost, rel=1e-12)


def test_solve_to_convergence():
    arrays = _arrays(num_cameras=8, num_points=120, seed=1, noise=0.05)
    arrays = arrays._replace(
        image_tvec=arrays.image_tvec + np.random.default_rng(4).normal(
            0, 0.02, arrays.image_tvec.shape))
    const = np.zeros(8, bool)
    const[0] = True
    jp, tp = _both(arrays, const)
    jout, js = jax.jit(lambda p: j_ba.solve(p, j_ba.BAOptions()))(jp)
    tout, ts = t_ba.solve(tp, t_ba.BAOptions())
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=1e-6)
    assert ts.final_cost < 0.1 * ts.initial_cost      # 0.3 px noise floor
    np.testing.assert_allclose(tout.image_tvec.numpy(),
                               np.asarray(jout.image_tvec), atol=1e-6)
    np.testing.assert_allclose(tout.points.numpy(), np.asarray(jout.points),
                               atol=1e-5)
    np.testing.assert_array_equal(tout.image_tvec[0].numpy(),
                                  np.asarray(arrays.image_tvec[0]))
    assert float(t_ba.mean_reproj_error_px(tout)) == pytest.approx(
        float(j_ba.mean_reproj_error_px(jout)), rel=1e-6)


def test_fixed_budget_runs_every_iteration():
    """ftol = 0 and no max_iters: the reference's scan path runs all
    max_iterations; so does the port."""
    arrays = _arrays(seed=2)
    jp, tp = _both(arrays, None)
    jo = j_ba.BAOptions(max_iterations=4, ftol=0.0)
    to = t_ba.BAOptions(max_iterations=4, ftol=0.0)
    _, js = j_ba.solve(jp, jo)
    _, ts = t_ba.solve(tp, to)
    assert ts.num_iterations == int(js.num_iterations) == 4
    assert ts.final_cost == pytest.approx(float(js.final_cost), rel=1e-8)


@pytest.mark.parametrize("chunk", [4, 512])
def test_segment_sums_of_long_runs(chunk, monkeypatch):
    """Every run is summed in chunks of at most SEGMENT_CHUNK rows and
    then the chunk sums (runs up to SEGMENT_CHUNK long in one chunk):
    the per-target sums stay right (empty targets 0), and a solve of
    pinhole cameras is unchanged by the chunk length."""
    monkeypatch.setattr(t_seg, "SEGMENT_CHUNK", chunk)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 7, 1000)
    keys[keys == 3] = 5                                  # an empty target
    x = rng.normal(size=(1000, 2, 3))
    seg = t_seg.segments(keys, 8, "cpu")
    lengths = np.bincount(keys, minlength=8)
    assert seg.chunk_counts.tolist() == np.maximum(
        -(-lengths // chunk), 1).tolist()
    assert int(seg.chunks.max()) == min(chunk, lengths.max())
    assert int(seg.chunks.sum()) == 1000
    want = np.stack([x[keys == k].sum(0) for k in range(8)])
    np.testing.assert_allclose(t_seg.segment_sum(torch.as_tensor(x), seg)
                               .numpy(), want, rtol=1e-12, atol=1e-12)
    arrays = interop.scene_arrays(_arrays(seed=5)._asdict(), device="cpu")
    out, st = t_ba.solve(t_ba.make_problem(arrays), t_ba.BAOptions(
        max_iterations=3))
    monkeypatch.setattr(t_seg, "SEGMENT_CHUNK", 256)
    out2, st2 = t_ba.solve(t_ba.make_problem(arrays), t_ba.BAOptions(
        max_iterations=3))
    assert st.final_cost == pytest.approx(st2.final_cost, rel=1e-12)
    assert t_ba.all_pinhole(arrays)


def _one_step(prob, solver: str, joint: bool, x_init=None):
    """One weighted step of `solver` at lam 1e-4, joint (with Jg) or
    pose-only."""
    opts = t_ba.BAOptions(solver=solver)
    r, Jc, Jp, Jg = t_ba._residuals_and_jacobians(prob, joint)
    w = t_ba._robust_weights(torch.sum(r * r, -1), opts.loss,
                             opts.loss_scale)
    pairs = t_ba._pairs(prob, joint) if solver == "dense" else None
    return t_ba._build_and_solve(prob, pairs, r, Jc, Jp, Jg, w, 1e-4, opts,
                                 x_init)


@pytest.mark.parametrize("solver,rtol", [("dense", 1e-9),
                                         ("iterative", 1e-12)])
def test_pose_only_step_is_the_joint_step_with_every_slot_held(solver,
                                                                rtol):
    """With cam_refine all 0 the joint step's Jg is zero and its
    intrinsics solve as the identity, so its poses and points are the
    pose-only step's: to rounding for the dense step, whose Cholesky runs
    on the larger matrix, and to 1e-12 for the iterative one, which takes
    as many CG iterations from the same warm start."""
    arrays = interop.scene_arrays(_arrays(seed=3)._asdict(), device="cpu")
    const = np.zeros(arrays.image_qvec.shape[0], bool)
    const[:2] = True
    prob = t_ba.make_problem(arrays, const_image=const)
    assert not prob.cam_refine.any()
    x_init = torch.as_tensor(np.random.default_rng(7).normal(
        0, 1e-3, (prob.image_qvec.shape[0], 6)))
    dcam, dint, dpt, k = _one_step(prob, solver, False, x_init)
    jcam, jint, jpt, jk = _one_step(prob, solver, True, x_init)
    assert dint is None and torch.count_nonzero(jint) == 0
    assert jint.shape == prob.cam_refine.shape
    assert k == jk and (k > 0) == (solver == "iterative")
    assert float(dcam.abs().max()) > 0 and float(dpt.abs().max()) > 0
    np.testing.assert_allclose(jcam.numpy(), dcam.numpy(), rtol=rtol,
                               atol=0)
    np.testing.assert_allclose(jpt.numpy(), dpt.numpy(), rtol=rtol, atol=0)


def test_failed_factorisations_give_nan_as_the_reference():
    """An indefinite Schur matrix or a singular system gives NaN, as
    jax.scipy.linalg.cho_factor / jnp.linalg.solve do, and the LM loop
    then rejects the step; torch.linalg.cholesky / solve would raise."""
    import jax.numpy as jnp
    import jax.scipy.linalg as jsl

    from dagsfm_tpu_torch.ops import solve as lin
    indefinite = np.array([[1.0, 2.0], [2.0, 1.0]])
    assert not np.isfinite(np.asarray(jsl.cho_factor(
        jnp.asarray(indefinite))[0])).all()
    L = lin.cholesky_or_nan(torch.as_tensor(np.stack([np.eye(2),
                                                      indefinite])))
    assert torch.isfinite(L[0]).all() and not torch.isfinite(L[1]).any()
    singular = np.zeros((3, 3))
    assert not np.isfinite(np.asarray(jnp.linalg.solve(
        jnp.asarray(singular), jnp.ones(3)))).all()
    X = lin.solve_or_nan(torch.as_tensor(np.stack([np.eye(3), singular])),
                         torch.ones((2, 3, 1), dtype=torch.float64))
    assert torch.equal(X[0, :, 0], torch.ones(3, dtype=torch.float64))
    assert not torch.isfinite(X[1]).any()
