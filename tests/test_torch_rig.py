"""The port's rig group vs the JAX reference (tests/test_rig.py's
scenes), float64 on the CPU: gpnp, the 17-point generalized relative
pose and both residuals; CameraRig, read_rig_config,
make_rig_ba_problem and apply_rig_ba_result; rig BA at S, C, P = 4, 2,
60 through `interop`.

Tolerances: the solvers' models within 1e-9 of the reference's (the
same lifts, decompositions from different libraries; R and t are
independent of the singular vectors' signs, so the models are compared,
not the vectors); gpnp under RANSAC with the reference's sample indices
gives the same inliers; host bookkeeping in numpy equals the
reference's to the bit; rig BA's parameters within rel 1e-7 and both
costs within rel 1e-9 (its sums run in other orders)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import rig_config, rig_scene
from dagsfm_tpu.ops import generalized_pose as j_gp
from dagsfm_tpu.ops import ransac as j_rnsc
from dagsfm_tpu.ops import rotations as j_rops
from dagsfm_tpu.scene import camera_rig as j_rig
from dagsfm_tpu.scene import io as j_io
from dagsfm_tpu.sfm import rig_bundle_adjustment as j_rba
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.ops import generalized_pose as t_gp
from dagsfm_tpu_torch.ops import ransac as t_rnsc
from dagsfm_tpu_torch.scene import camera_rig as t_rig
from dagsfm_tpu_torch.scene import io as t_io
from dagsfm_tpu_torch.sfm import rig_bundle_adjustment as t_rba

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def _rot(rng, scale=0.5):
    return np.asarray(j_rops.angleaxis_to_rotmat(
        jnp.asarray(rng.normal(0, scale, 3))))


def _rig_rays(rng, n=30, noise=0.0):
    """tests/test_rig.py::_make_rig_scene: a random rig pose and two
    cameras offset in the rig frame, point-ray correspondences."""
    R_gt, t_gt = _rot(rng), rng.normal(0, 1, 3)
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 6.0])
    o = np.array([[-0.5, 0, 0], [0.5, 0, 0]])[np.arange(n) % 2]
    d = X @ R_gt.T + t_gt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if noise:
        d = d + rng.normal(0, noise, d.shape)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    return X, o, d, R_gt, t_gt


def _ray_pairs(rng, n=24):
    """tests/test_rig.py's 17-point scene: rays of three cameras in two
    rig frames, x2 = R x1 + t."""
    R_gt, t_gt = _rot(rng, 0.3), rng.normal(0, 0.5, 3)
    X1 = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 5.0])
    off = np.array([[-0.4, 0, 0], [0.4, 0.1, 0], [0, -0.3, 0.1]])
    c1, c2 = off[np.arange(n) % 3], off[(np.arange(n) + 1) % 3]
    return X1 - c1, c1, X1 @ R_gt.T + t_gt - c2, c2, R_gt, t_gt


@pytest.mark.parametrize("noise,n", [(0.0, 30), (1e-3, 8)])
def test_gpnp_against_reference(noise, n):
    X, o, d, R_gt, t_gt = _rig_rays(np.random.default_rng(0), noise=noise)
    Mj, vj = j_gp.gpnp(*(jnp.asarray(a[:n]) for a in (X, o, d)))
    Mt, vt = t_gp.gpnp(*(T(a[:n]) for a in (X, o, d)))
    assert Mt.shape == (1, 3, 4) and bool(vt[0]) == bool(vj[0])
    np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), rtol=0,
                               atol=1e-9)
    if not noise:
        np.testing.assert_allclose(Mt[0, :, :3].numpy(), R_gt, atol=1e-6)
        np.testing.assert_allclose(Mt[0, :, 3].numpy(), t_gt, atol=1e-6)


def test_gpnp_batched_equals_one_by_one():
    X, o, d, _, _ = _rig_rays(np.random.default_rng(1), noise=1e-3)
    idx = np.random.default_rng(2).permutation(30)[:24].reshape(2, 2, 6)
    Mb, vb = t_gp.gpnp(*(T(a[idx]) for a in (X, o, d)))
    assert Mb.shape == (2, 2, 1, 3, 4) and vb.shape == (2, 2, 1)
    for a in range(2):
        for b in range(2):
            M1, v1 = t_gp.gpnp(*(T(x[idx[a, b]]) for x in (X, o, d)))
            np.testing.assert_allclose(Mb[a, b].numpy(), M1.numpy(),
                                       rtol=0, atol=1e-12)


def test_gpnp_ray_residual_against_reference():
    X, o, d, R_gt, t_gt = _rig_rays(np.random.default_rng(1))
    M = np.hstack([R_gt, t_gt[:, None]])
    r = t_gp.gpnp_ray_residual(T(M), T(X), T(o), T(d)).numpy()
    assert r.max() < 1e-12
    M2 = M + np.random.default_rng(3).normal(0, 0.01, M.shape)
    np.testing.assert_allclose(
        t_gp.gpnp_ray_residual(T(M2), T(X), T(o), T(d)).numpy(),
        np.asarray(j_gp.gpnp_ray_residual(jnp.asarray(M2), jnp.asarray(X),
                                          jnp.asarray(o), jnp.asarray(d))),
        rtol=1e-12, atol=1e-20)


def test_gpnp_ransac_with_reference_samples():
    """tests/test_rig.py::test_ransac_with_outliers: the reference's draws
    (its `_sample_indices` from the same key) fed to the port's ransac."""
    rng = np.random.default_rng(2)
    X, o, d, R_gt, t_gt = _rig_rays(rng, n=60)
    bad = rng.choice(60, 15, replace=False)
    d[bad] = rng.normal(size=(15, 3))
    d[bad] /= np.linalg.norm(d[bad], axis=1, keepdims=True)
    key = jax.random.PRNGKey(0)
    mask = jnp.ones(60, bool)
    jres = j_rnsc.ransac(key, j_gp.gpnp, j_gp.gpnp_ray_residual,
                         (jnp.asarray(X), jnp.asarray(o), jnp.asarray(d)),
                         mask, sample_size=8, threshold=1e-6,
                         num_hypotheses=64)
    idx = np.asarray(j_rnsc._sample_indices(key, 64, 8, 60, mask))
    tres = t_rnsc.ransac(
        t_gp.gpnp, lambda M, a, b, c: t_gp.gpnp_ray_residual(
            M, a[:, None], b[:, None], c[:, None]),
        (T(X)[None], T(o)[None], T(d)[None]),
        torch.ones((1, 60), dtype=torch.bool), T(idx)[None], 1e-6)
    assert bool(tres.valid[0]) and bool(jres.valid)
    assert np.array_equal(tres.inliers[0].numpy(), np.asarray(jres.inliers))
    assert not tres.inliers[0].numpy()[bad].any()
    np.testing.assert_allclose(tres.model[0].numpy(), np.asarray(jres.model),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(tres.model[0, :, :3].numpy(), R_gt,
                               atol=1e-4)


def test_17pt_against_reference():
    q1, c1, q2, c2, R_gt, t_gt = _ray_pairs(np.random.default_rng(3))
    for n in (17, 24):
        Mj, vj = j_gp.generalized_relative_pose_17pt(
            *(jnp.asarray(a[:n]) for a in (q1, c1, q2, c2)))
        Mt, vt = t_gp.generalized_relative_pose_17pt(
            *(T(a[:n]) for a in (q1, c1, q2, c2)))
        assert bool(vt[0]) and bool(vj[0])
        np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(Mt[0, :, :3].numpy(), R_gt, atol=1e-5)
        t = Mt[0, :, 3].numpy()
        np.testing.assert_allclose(t / np.linalg.norm(t),
                                   t_gt / np.linalg.norm(t_gt), atol=1e-4)
    # a batch of systems, each its own null vector
    Mb, _ = t_gp.generalized_relative_pose_17pt(
        *(torch.stack([T(a[:17]), T(a[7:24])]) for a in (q1, c1, q2, c2)))
    for k, sl in enumerate((slice(0, 17), slice(7, 24))):
        M1, _ = t_gp.generalized_relative_pose_17pt(
            *(T(a[sl]) for a in (q1, c1, q2, c2)))
        np.testing.assert_allclose(Mb[k].numpy(), M1.numpy(), rtol=0,
                                   atol=1e-9)


def test_gec_residual_against_reference():
    q1, c1, q2, c2, R_gt, t_gt = _ray_pairs(np.random.default_rng(3))
    M = np.hstack([R_gt, t_gt[:, None]])
    assert t_gp.gec_residual(T(M), *(T(a) for a in (q1, c1, q2, c2))
                             ).numpy().max() < 1e-12
    M2 = M + np.random.default_rng(4).normal(0, 0.01, M.shape)
    np.testing.assert_allclose(
        t_gp.gec_residual(T(M2), *(T(a) for a in (q1, c1, q2, c2))).numpy(),
        np.asarray(j_gp.gec_residual(jnp.asarray(M2), *(
            jnp.asarray(a) for a in (q1, c1, q2, c2)))),
        rtol=1e-10, atol=1e-24)


def _two_rigs():
    """The same two-camera rig in both packages (tests/test_rig.py's)."""
    q1 = j_rops.rotmat_to_quat_np(_rot(np.random.default_rng(5), 0.1))
    out = []
    for mod in (j_rig, t_rig):
        rig = mod.CameraRig()
        rig.add_camera(0, np.array([1.0, 0, 0, 0]), np.zeros(3))
        rig.add_camera(1, q1, np.array([0.3, 0.0, 0.0]))
        rig.set_ref_camera_id(0)
        out.append(rig)
    return out


def test_camera_rig_against_reference():
    jr, tr = _two_rigs()
    for rig in (jr, tr):
        rig.cam_from_rig_q[0] = np.asarray(j_rops.rotmat_to_quat_np(
            _rot(np.random.default_rng(9), 0.2)))
        rig.normalize_to_ref()
    for cid in (0, 1):
        assert np.array_equal(tr.cam_from_rig_q[cid], jr.cam_from_rig_q[cid])
        assert np.array_equal(tr.cam_from_rig_t[cid], jr.cam_from_rig_t[cid])
    np.testing.assert_allclose(tr.cam_from_rig_q[0], [1, 0, 0, 0],
                               atol=1e-12)
    ported = interop.camera_rig(jr)
    assert ported.ref_camera_id == 0 and ported.snapshots == []
    assert all(np.array_equal(ported.cam_from_rig_q[c], tr.cam_from_rig_q[c])
               for c in (0, 1))


def test_compute_rig_from_world_against_reference():
    from dagsfm_tpu.scene.reconstruction import ImageRecord as JImage
    from dagsfm_tpu.scene.reconstruction import Reconstruction as JRec
    jr, tr = _two_rigs()
    rng = np.random.default_rng(6)
    q_rw = j_rops.rotmat_to_quat_np(_rot(rng))
    t_rw = rng.normal(0, 1, 3)
    rec = JRec()
    for iid, cid in ((10, 0), (11, 1)):
        q, t = jr.image_pose(cid, q_rw, t_rw)
        rec.add_image(JImage(image_id=iid, name=f"i{iid}", camera_id=cid,
                             qvec=q, tvec=t, xys=np.zeros((0, 2)),
                             point3D_ids=np.zeros(0, np.int64)))
        rec.register_image(iid)
        assert all(np.array_equal(a, b) for a, b in zip(
            tr.image_pose(cid, q_rw, t_rw), (q, t)))
    for rig in (jr, tr):
        rig.add_snapshot([10, 11])
        rig.check(rec)
    trec = interop.reconstruction({}, rec.images, {})
    qj, tj = jr.compute_rig_from_world(0, rec)
    qt, tt = tr.compute_rig_from_world(0, trec)
    assert np.array_equal(qt, qj) and np.array_equal(tt, tj)
    np.testing.assert_allclose(abs(np.dot(qt, q_rw)), 1.0, atol=1e-9)
    np.testing.assert_allclose(tt, t_rw, atol=1e-9)


@pytest.fixture(scope="module")
def rig_dir(tmp_path_factory):
    """chip_smoke.rig_scene at 10 snapshots and 150 points, written as
    .bin with its rig config."""
    d = tmp_path_factory.mktemp("rig")
    rec, _ = rig_scene(10, 150, seed=4)
    t_io.write_model_bin(rec, str(d / "model"))
    (d / "rig.json").write_text(json.dumps(rig_config()))
    return str(d)


@pytest.fixture
def rig_model(rig_dir):
    """The rig model as each package reads it (fresh for each test)."""
    return (rig_dir, j_io.read_model_bin(rig_dir + "/model"),
            t_io.read_model_bin(rig_dir + "/model"))


def test_read_rig_config_and_problem_against_reference(rig_model):
    d, jrec, trec = rig_model
    jrigs = j_rig.read_rig_config(d + "/rig.json", jrec)
    trigs = t_rig.read_rig_config(d + "/rig.json", trec)
    assert len(trigs) == 1 and trigs[0].snapshots == jrigs[0].snapshots
    assert trigs[0].num_snapshots == 10 and trigs[0].num_cameras == 4
    for cid in jrigs[0].cam_from_rig_q:
        assert np.array_equal(trigs[0].cam_from_rig_q[cid],
                              jrigs[0].cam_from_rig_q[cid])
        assert np.array_equal(trigs[0].cam_from_rig_t[cid],
                              jrigs[0].cam_from_rig_t[cid])
    jprob, jmeta = j_rig.make_rig_ba_problem(jrec, jrigs)
    tprob, tmeta = t_rig.make_rig_ba_problem(trec, trigs, device="cpu")
    for k, v in jprob._asdict().items():
        assert np.array_equal(getattr(tprob, k).numpy(), np.asarray(v)), k
    assert tmeta["pt_ids"] == jmeta["pt_ids"]
    assert tmeta["mount_key"] == jmeta["mount_key"]


def test_rig_ba_problem_and_result_with_free_images(rig_model):
    """Images no snapshot covers become one-image snapshots with an
    identity mount per camera, as in the reference; a few LM iterations
    later both packages write back the same poses, points and mounts."""
    d, jrec, trec = rig_model
    for rec in (jrec, trec):
        for iid in (3, 7):      # cameras 3 and 4 of snapshot 0
            rec.images[iid].name = f"loose/{iid}.png"
    jrigs = j_rig.read_rig_config(d + "/rig.json", jrec)
    trigs = t_rig.read_rig_config(d + "/rig.json", trec)
    jprob, jmeta = j_rig.make_rig_ba_problem(jrec, jrigs)
    tprob, tmeta = t_rig.make_rig_ba_problem(trec, trigs, device="cpu")
    assert ("free", 3) in tmeta["mount_key"] and \
        tmeta["mount_key"] == jmeta["mount_key"]
    for k, v in jprob._asdict().items():
        assert np.array_equal(getattr(tprob, k).numpy(), np.asarray(v)), k
    jout = j_rba.solve(jprob, j_rba.RigBAOptions(max_iterations=8))
    tout = t_rba.solve(tprob, t_rba.RigBAOptions(max_iterations=8))
    assert float(tout.final_cost) < 0.2 * float(tout.initial_cost)
    j_rig.apply_rig_ba_result(jrec, jrigs, jout, jmeta)
    t_rig.apply_rig_ba_result(trec, trigs, tout, tmeta)
    for iid in jrec.images:
        for f in ("qvec", "tvec"):
            a, b = getattr(trec.images[iid], f), getattr(jrec.images[iid], f)
            assert np.abs(a - b).max() <= 1e-7 * max(1.0, np.abs(b).max())
    for pid in jrec.points3D:
        np.testing.assert_allclose(trec.points3D[pid].xyz,
                                   jrec.points3D[pid].xyz, rtol=1e-7)
    for cid in jrigs[0].cam_from_rig_q:
        np.testing.assert_allclose(trigs[0].cam_from_rig_t[cid],
                                   jrigs[0].cam_from_rig_t[cid], rtol=1e-7,
                                   atol=1e-9)


def _rig_problem(noise, P=60):
    """tests/test_rig.py::test_converges_and_respects_rig's problem with
    pixel noise and a perturbed second mount."""
    rng = np.random.default_rng(7)
    S, C, f = 4, 2, 500.0
    mount_q = np.stack([[1, 0, 0, 0], j_rops.rotmat_to_quat_np(
        _rot(rng, 0.05))])
    mount_t = np.array([[0.0, 0, 0], [0.4, 0, 0]])
    rig_R = [_rot(rng, 0.2) for _ in range(S)]
    rig_t = [np.array([0.2 * s, 0, 0]) for s in range(S)]
    X = rng.uniform(-2, 2, (P, 3)) + np.array([0, 0, 8.0])
    snap, cam, pt, obs = [], [], [], []
    for s in range(S):
        for c in range(C):
            Rm = j_rops.quat_to_rotmat_np(mount_q[c])
            for p in range(P):
                xc = Rm @ (rig_R[s] @ X[p] + rig_t[s]) + mount_t[c]
                snap.append(s)
                cam.append(c)
                pt.append(p)
                obs.append(xc[:2] / xc[2] * f + 400.0
                           + rng.normal(0, noise, 2))
    rig_q = np.stack([j_rops.rotmat_to_quat_np(
        _rot(rng, 0.01) @ R if s else R) for s, R in enumerate(rig_R)])
    rig_t = np.stack(rig_t) + np.vstack([np.zeros(3), rng.normal(
        0, 0.02, (S - 1, 3))])
    mq = mount_q.copy()
    mq[1] = j_rops.rotmat_to_quat_np(
        _rot(rng, 0.01) @ j_rops.quat_to_rotmat_np(mq[1]))
    return j_rba.RigBAProblem(
        snap_idx=jnp.asarray(snap, jnp.int32),
        cam_idx=jnp.asarray(cam, jnp.int32),
        pt_idx=jnp.asarray(pt, jnp.int32), obs_xy=jnp.asarray(obs),
        focal=jnp.full((C,), f), pp=jnp.full((C, 2), 400.0),
        rig_q=jnp.asarray(rig_q), rig_t=jnp.asarray(rig_t),
        mount_q=jnp.asarray(mq),
        mount_t=jnp.asarray(mount_t + [[0, 0, 0], [0.01, 0, 0]]),
        points=jnp.asarray(X + rng.normal(0, 0.02, X.shape)))


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("iters", [1, 4, 25])
def test_rig_ba_against_reference(refine, iters):
    jprob = _rig_problem(noise=0.5)
    opts = j_rba.RigBAOptions(max_iterations=iters,
                              refine_relative_poses=refine)
    jout = j_rba.solve(jprob, opts)
    tout = t_rba.solve(interop.rig_ba_problem(jprob._asdict(), device="cpu"),
                       interop.rig_ba_options(opts._asdict()))
    for k in ("rig_q", "rig_t", "mount_q", "mount_t", "points"):
        ref = np.asarray(getattr(jout, k))
        got = getattr(tout, k).numpy()
        assert np.abs(got - ref).max() <= 1e-7 * np.abs(ref).max(), k
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(tout, k)),
                                   float(getattr(jout, k)), rtol=1e-9)
    # the gauge: snapshot 0's rig pose and mount 0 stay as they were
    assert np.array_equal(tout.rig_q[0].numpy(), np.asarray(jprob.rig_q[0]))
    assert np.array_equal(tout.mount_q[0].numpy(),
                          np.asarray(jprob.mount_q[0]))
    if not refine:
        assert np.array_equal(tout.mount_t.numpy(),
                              np.asarray(jprob.mount_t))


def test_rig_ba_jacobian_equals_jacfwd():
    """The analytic Jacobian against the reference's jacfwd of its
    residuals at the problem's parameters (rtol 1e-10)."""
    S, C, P = 4, 2, 20
    jprob = _rig_problem(noise=0.5, P=P)
    n = 6 * S + 6 * C + 3 * P

    def res(delta):
        p = jprob._replace(points=jprob.points
                           + delta[6 * S + 6 * C:].reshape(P, 3))
        return j_rba._residuals(p, delta, True)[0]
    Jj = np.asarray(jax.jacfwd(res)(jnp.zeros(n)))
    free = t_rba.gauge_mask(S, C, P, True, "cpu")
    tprob = interop.rig_ba_problem(jprob._asdict(), device="cpu")
    r, terms = t_rba._project(tprob)
    Jt = t_rba._jacobian(tprob, terms, free).numpy()
    np.testing.assert_allclose(r.numpy(), np.asarray(res(jnp.zeros(n))),
                               rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(Jt, Jj * free.numpy()[None, :], rtol=1e-10,
                               atol=1e-9)
