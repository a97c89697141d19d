"""The public functions the port's modules had lacked, against the JAX
reference on the CPU, float64: projection's project_full and
angular_error, RANSAC's trial count, the rotation helpers, the batched
DLT, the camera models' per-row (batched) forms and NUM_MODELS,
SyntheticScene.look_dirs and to_reconstruction, and the pair-batched
essential estimation with the reference's draws replayed.

Tolerances: elementwise float64 math to rtol 1e-12; the SVD- and
eigh-based results (project_to_rotmat, the DLT) to 1e-10; Newton
undistortion to 1e-10; the two-view estimates exactly in their counts
and inlier masks and to 1e-8 in R and t. to_reconstruction equals the
reference in every field but the quaternions, which agree to 1 ulp
(XLA:CPU sums the quaternion's squares with fused multiply-adds)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.ops import projection as j_proj
from dagsfm_tpu.ops import ransac as j_rnsc
from dagsfm_tpu.ops import rotations as j_rops
from dagsfm_tpu.ops import triangulation as j_tri
from dagsfm_tpu.scene import cameras as j_cm
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu.sfm import two_view as j_tv
from dagsfm_tpu_torch.ops import projection as t_proj
from dagsfm_tpu_torch.ops import ransac as t_rnsc
from dagsfm_tpu_torch.ops import rotations as t_rops
from dagsfm_tpu_torch.ops import triangulation as t_tri
from dagsfm_tpu_torch.scene import cameras as t_cm
from dagsfm_tpu_torch.scene import synthetic as t_syn
from dagsfm_tpu_torch.sfm import two_view as t_tv

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def _rotations(rng, n):
    aa = rng.normal(0, 1.0, (n, 3))
    return aa, np.asarray(j_rops.angleaxis_to_rotmat(jnp.asarray(aa)))


def test_angleaxis_rotate_against_reference():
    rng = np.random.default_rng(0)
    aa = rng.normal(0, 1.0, (64, 3))
    aa[:8] *= 1e-5                    # the first-order branch
    aa[8] = 0.0
    v = rng.normal(size=(64, 3))
    np.testing.assert_allclose(
        t_rops.angleaxis_rotate(T(aa), T(v)).numpy(),
        np.asarray(j_rops.angleaxis_rotate(jnp.asarray(aa), jnp.asarray(v))),
        rtol=1e-12, atol=1e-14)
    # broadcast: one rotation, many vectors
    np.testing.assert_allclose(
        t_rops.angleaxis_rotate(T(aa[9]), T(v)).numpy(),
        v @ t_rops.angleaxis_to_rotmat(T(aa[9])).numpy().T, atol=1e-12)


def test_pose_helpers_against_reference():
    rng = np.random.default_rng(1)
    _, R1 = _rotations(rng, 16)
    _, R2 = _rotations(rng, 16)
    t1, t2 = rng.normal(size=(16, 3)), rng.normal(size=(16, 3))
    J = (lambda *a: tuple(jnp.asarray(x) for x in a))
    np.testing.assert_allclose(
        t_rops.relative_rotation(T(R1), T(R2)).numpy(),
        np.asarray(j_rops.relative_rotation(*J(R1, R2))), rtol=1e-12,
        atol=1e-15)
    for got, ref in zip(t_rops.compose_pose(T(R1), T(t1), T(R2), T(t2)),
                        j_rops.compose_pose(*J(R1, t1, R2, t2))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-12, atol=1e-14)
    for got, ref in zip(t_rops.invert_pose(T(R1), T(t1)),
                        j_rops.invert_pose(*J(R1, t1))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-12, atol=1e-14)
    Ri, ti = t_rops.invert_pose(T(R1), T(t1))
    Rc, tc = t_rops.compose_pose(T(R1), T(t1), Ri, ti)
    np.testing.assert_allclose(Rc.numpy(), np.broadcast_to(np.eye(3),
                                                           (16, 3, 3)),
                               atol=1e-12)
    np.testing.assert_allclose(tc.numpy(), 0, atol=1e-12)


def test_project_to_rotmat_against_reference():
    rng = np.random.default_rng(2)
    _, R = _rotations(rng, 32)
    M = R + rng.normal(0, 0.05, R.shape)
    M[:4] *= -1                       # det < 0: the sign fix
    got = t_rops.project_to_rotmat(T(M)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(j_rops.project_to_rotmat(jnp.asarray(M))),
        rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-12)


def test_num_trials_for_confidence_equals_reference():
    for ratio in (0.1, 0.25, 0.5, 0.9, 0.999999):
        for s in (3, 5, 7, 8):
            for conf in (0.99, 0.9999):
                assert t_rnsc.num_trials_for_confidence(ratio, s, conf) == \
                    j_rnsc.num_trials_for_confidence(ratio, s, conf)


def _camera_rows(rng, n):
    """n rows of random camera models with plausible params (padded)."""
    mids = np.arange(n) % t_cm.NUM_MODELS
    params = np.zeros((n, t_cm.MAX_CAMERA_PARAMS))
    for k, m in enumerate(mids):
        nparams = t_cm.CAMERA_MODEL_NUM_PARAMS[int(m)]
        p = rng.normal(0, 0.01, nparams)
        single = m in t_cm._SINGLE_FOCAL
        p[0] = 800.0
        p[1:3 if single else 4] = ([320.0, 240.0] if single
                                   else [810.0, 320.0, 240.0])
        params[k, :nparams] = p
    return mids, params


def test_camera_batched_forms_against_reference():
    assert t_cm.NUM_MODELS == j_cm.NUM_MODELS == 11
    rng = np.random.default_rng(3)
    mids, params = _camera_rows(rng, 44)
    uv = rng.uniform(-0.4, 0.4, (44, 2))
    xyz = np.concatenate([uv, np.ones((44, 1))], 1) * rng.uniform(
        1, 5, (44, 1))
    J = (lambda a: jnp.asarray(a))
    np.testing.assert_allclose(
        t_cm.distort_batched(T(mids), T(params), T(uv)).numpy(),
        np.asarray(j_cm.distort_batched(J(mids), J(params), J(uv))),
        rtol=1e-12, atol=1e-13)
    px = t_cm.img_from_cam_batched(T(mids), T(params), T(xyz)).numpy()
    np.testing.assert_allclose(
        px, np.asarray(j_cm.img_from_cam_batched(J(mids), J(params),
                                                 J(xyz))),
        rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(
        t_cm.cam_from_img_batched(T(mids), T(params), T(px)).numpy(),
        np.asarray(j_cm.cam_from_img_batched(J(mids), J(params), J(px))),
        rtol=1e-10, atol=1e-12)


def test_project_full_and_angular_error_against_reference():
    rng = np.random.default_rng(4)
    mids, params = _camera_rows(rng, 22)
    aa = rng.normal(0, 0.3, (22, 3))
    q = np.asarray(j_rops.angleaxis_to_quat(jnp.asarray(aa)))
    t = rng.normal(0, 0.5, (22, 3)) + [0, 0, 6]
    X = rng.uniform(-1, 1, (22, 3))
    ref_px, ref_z = jax.vmap(j_proj.project_full)(
        *(jnp.asarray(a) for a in (mids, params, q, t, X)))
    px, z = t_proj.project_full(T(mids), T(params), T(q), T(t), T(X))
    np.testing.assert_allclose(px.numpy(), np.asarray(ref_px), rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), rtol=1e-12)
    ray = rng.normal(size=(22, 3)) + [0, 0, 3]
    np.testing.assert_allclose(
        t_proj.angular_error(T(q), T(t), T(X), T(ray)).numpy(),
        np.asarray(j_proj.angular_error(*(jnp.asarray(a)
                                          for a in (q, t, X, ray)))),
        rtol=1e-12, atol=1e-12)


def test_triangulate_dlt_batch_against_reference():
    rng = np.random.default_rng(5)
    B, K = 32, 5
    aa = rng.normal(0, 0.2, (B, K, 3))
    q = np.asarray(j_rops.angleaxis_to_quat(jnp.asarray(aa)))
    t = rng.normal(0, 1.0, (B, K, 3)) + [0, 0, 5]
    X = rng.uniform(-1, 1, (B, 3))
    Xc = np.asarray(j_rops.quat_rotate(jnp.asarray(q), jnp.asarray(
        np.broadcast_to(X[:, None], (B, K, 3))))) + t
    uv = Xc[..., :2] / Xc[..., 2:] + rng.normal(0, 1e-4, (B, K, 2))
    mask = rng.random((B, K)) > 0.2
    mask[:, :2] = True
    ref = np.asarray(j_tri.triangulate_dlt_batch(
        *(jnp.asarray(a) for a in (q, t, uv, mask))))
    got = t_tri.triangulate_dlt_batch(T(q), T(t), T(uv), T(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got, X, atol=1e-2)


def test_synthetic_look_dirs_and_to_reconstruction():
    spec = dict(num_cameras=12, num_points=200, pixel_noise=0.5, seed=7)
    jsc = j_syn.generate(j_syn.SyntheticSceneSpec(**spec))
    tsc = t_syn.generate(t_syn.SyntheticSceneSpec(**spec))
    assert np.array_equal(tsc.look_dirs(), jsc.look_dirs())
    for with_points in (True, False):
        a = j_syn.to_reconstruction(jsc, with_points=with_points)
        b = t_syn.to_reconstruction(tsc, with_points=with_points)
        assert a.cameras == {c: v for c, v in b.cameras.items()}
        assert sorted(a.images) == sorted(b.images)
        for i, im in a.images.items():
            tb = b.images[i]
            assert (tb.name, tb.camera_id, tb.registered) == \
                (im.name, im.camera_id, im.registered)
            for f in ("tvec", "xys", "point3D_ids"):
                assert np.array_equal(getattr(tb, f), getattr(im, f)), f
            assert np.abs(tb.qvec - im.qvec).max() <= np.spacing(1.0)
        assert sorted(a.points3D) == sorted(b.points3D)
        for k, p in a.points3D.items():
            assert np.array_equal(b.points3D[k].xyz, p.xyz)
            assert b.points3D[k].track == p.track


def test_estimate_two_view_batched_with_reference_draws():
    rng = np.random.default_rng(8)
    B, N, H, f = 2, 64, 32, 800.0
    x1 = np.zeros((B, N, 2))
    x2 = np.zeros((B, N, 2))
    mask = np.zeros((B, N), bool)
    for b, n in enumerate((64, 50)):
        X = rng.uniform(-2, 2, (n, 3)) + [0, 0, 8]
        th = rng.normal(0, 0.1, 3)
        R = np.asarray(j_rops.angleaxis_to_rotmat(jnp.asarray(th)))
        X2 = X @ R.T + [1.0, 0.1, 0.0]
        x1[b, :n] = X[:, :2] / X[:, 2:] + rng.normal(0, 0.3 / f, (n, 2))
        x2[b, :n] = X2[:, :2] / X2[:, 2:] + rng.normal(0, 0.3 / f, (n, 2))
        bad = rng.random(n) < 0.2
        x2[b, :n][bad] = rng.uniform(-0.3, 0.3, (bad.sum(), 2))
        mask[b, :n] = True
    thr = np.full(B, (4.0 / f) ** 2)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    ref = j_tv.estimate_two_view_batched(
        keys, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
        jnp.asarray(thr), num_hyps=H)
    idx = np.stack([np.asarray(j_rnsc._sample_indices(
        keys[b], H, 5, N, jnp.asarray(mask[b]))) for b in range(B)])
    got = t_tv.estimate_two_view_batched(T(idx), T(x1), T(x2), T(mask),
                                         T(thr))
    R, t, ninl, nf, inl, valid = (g.numpy() for g in got)
    assert np.array_equal(ninl, np.asarray(ref[2]))
    assert np.array_equal(nf, np.asarray(ref[3]))
    assert np.array_equal(inl, np.asarray(ref[4]))
    assert np.array_equal(valid, np.asarray(ref[5]))
    np.testing.assert_allclose(R, np.asarray(ref[0]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(t, np.asarray(ref[1]), rtol=0, atol=1e-8)
