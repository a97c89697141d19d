"""Port geometry vs the JAX reference on the same numpy inputs (float64):
rotations, cameras, projection, triangulation, polynomials, P3P, EPnP,
the P3P LO-RANSAC with its EPnP refit and its focal grid, Umeyama, the
mapper's normalisation through a distorted camera and the device rule
of the port's entry points. Every camera model has its own cases in
tests/test_torch_cameras.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from dagsfm_tpu.ops import absolute_pose as j_ap
from dagsfm_tpu.ops import ransac as j_rnsc
from dagsfm_tpu.ops import polynomials as j_poly
from dagsfm_tpu.ops import projection as j_proj
from dagsfm_tpu.ops import rotations as j_rot
from dagsfm_tpu.ops import triangulation as j_tri
from dagsfm_tpu.ops import umeyama as j_ume
from dagsfm_tpu.scene import cameras as j_cm
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu.sfm import incremental_mapper as j_im
from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.ops import absolute_pose as t_ap
from dagsfm_tpu_torch.ops import polynomials as t_poly
from dagsfm_tpu_torch.ops import projection as t_proj
from dagsfm_tpu_torch.ops import rotations as t_rot
from dagsfm_tpu_torch.ops import triangulation as t_tri
from dagsfm_tpu_torch.ops import umeyama as t_ume
from dagsfm_tpu_torch.scene import cameras as t_cm
from dagsfm_tpu_torch.scene import synthetic as t_syn
from dagsfm_tpu_torch.sfm import incremental_mapper as t_im

torch.set_num_threads(1)
RTOL = 1e-10


def T(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def close(port, ref, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("fn", ["quat_to_rotmat", "quat_normalize",
                                "quat_to_angleaxis"])
def test_quat_functions(fn):
    q = _quats(np.random.default_rng(0), 64)
    q[0] = [1.0, 1e-10, 0, 0]      # small-angle branch
    close(getattr(t_rot, fn)(T(q)), getattr(j_rot, fn)(jnp.asarray(q)))


def test_rotmat_to_quat_and_products():
    rng = np.random.default_rng(1)
    q1, q2 = _quats(rng, 32), _quats(rng, 32)
    R = np.asarray(j_rot.quat_to_rotmat(jnp.asarray(q1)))
    close(t_rot.rotmat_to_quat(T(R)), j_rot.rotmat_to_quat(jnp.asarray(R)))
    close(t_rot.quat_multiply(T(q1), T(q2)),
          j_rot.quat_multiply(jnp.asarray(q1), jnp.asarray(q2)))
    v = rng.normal(size=(32, 3))
    close(t_rot.quat_rotate(T(q1), T(v)),
          j_rot.quat_rotate(jnp.asarray(q1), jnp.asarray(v)))
    close(t_rot.rotmat_to_quat_np(R), j_rot.rotmat_to_quat_np(R))
    close(t_rot.quat_to_rotmat_np(q1), j_rot.quat_to_rotmat_np(q1))


def test_rotation_angle_center_and_angleaxis():
    rng = np.random.default_rng(9)
    R1 = np.asarray(j_rot.quat_to_rotmat(jnp.asarray(_quats(rng, 24))))
    R2 = np.asarray(j_rot.quat_to_rotmat(jnp.asarray(_quats(rng, 24))))
    t = rng.normal(size=(24, 3))
    close(t_rot.rotation_angle_deg(T(R1), T(R2)),
          j_rot.rotation_angle_deg(jnp.asarray(R1), jnp.asarray(R2)))
    close(t_rot.camera_center(T(R1), T(t)),
          j_rot.camera_center(jnp.asarray(R1), jnp.asarray(t)))
    close(t_rot.rotmat_to_angleaxis(T(R1)),
          j_rot.rotmat_to_angleaxis(jnp.asarray(R1)))


@pytest.mark.parametrize("scale", [1.0, 1e-5])
def test_angleaxis(scale):
    aa = np.random.default_rng(2).normal(size=(32, 3)) * scale
    close(t_rot.angleaxis_to_quat(T(aa)), j_rot.angleaxis_to_quat(
        jnp.asarray(aa)))
    close(t_rot.angleaxis_to_rotmat(T(aa)), j_rot.angleaxis_to_rotmat(
        jnp.asarray(aa)))


@pytest.mark.parametrize("model", ["SIMPLE_PINHOLE", "PINHOLE"])
def test_cameras(model):
    rng = np.random.default_rng(3)
    jc = j_cm.make_simple_camera(1, 640, 480, focal=500.0, model=model)
    tc = t_cm.make_simple_camera(1, 640, 480, focal=500.0, model=model)
    assert tuple(tc) == tuple(jc)
    assert tc.model_name == jc.model_name == model
    close(tc.calibration_matrix(), jc.calibration_matrix())
    params = np.zeros(12)
    params[: len(jc.params)] = jc.params
    xyz = np.concatenate([rng.normal(size=(50, 2)),
                          rng.uniform(1, 5, (50, 1))], 1)
    close(t_cm.img_from_cam(jc.model_id, T(params), T(xyz)),
          j_cm.img_from_cam(jc.model_id, jnp.asarray(params),
                            jnp.asarray(xyz)))
    xy = rng.uniform(0, 640, (50, 2))
    close(t_cm.cam_from_img(jc.model_id, T(params), T(xy)),
          j_cm.cam_from_img(jc.model_id, jnp.asarray(params),
                            jnp.asarray(xy)))
    mids = np.array([0, 1, 0])
    for flags in [(True, False, True), (True, True, True)]:
        np.testing.assert_array_equal(
            t_cm.intrinsics_refine_mask(mids, *flags,
                                        eligible=[True, False, True]),
            j_cm.intrinsics_refine_mask(mids, *flags,
                                        eligible=[True, False, True]))


def test_projection_and_angles():
    rng = np.random.default_rng(4)
    q1, q2 = _quats(rng, 40), _quats(rng, 40)
    t1, t2 = rng.normal(size=(40, 3)), rng.normal(size=(40, 3))
    X = rng.normal(size=(40, 3)) * 3
    close(t_proj.world_to_cam(T(q1), T(t1), T(X)),
          j_proj.world_to_cam(jnp.asarray(q1), jnp.asarray(t1),
                              jnp.asarray(X)))
    close(t_proj.triangulation_angles(T(q1), T(t1), T(q2), T(t2), T(X)),
          j_proj.triangulation_angles(*(jnp.asarray(a) for a in
                                        (q1, t1, q2, t2, X))))
    pj, zj = j_proj.project_simple(jnp.asarray(q1), jnp.asarray(t1), 500.0,
                                   jnp.asarray([320.0, 240.0]),
                                   jnp.asarray(X))
    pt, zt = t_proj.project_simple(T(q1), T(t1), 500.0, T([320.0, 240.0]),
                                   T(X))
    close(pt, pj)
    close(zt, zj)


def test_reproj_errors_obs():
    from dagsfm_tpu.scene import synthetic as j_syn
    from dagsfm_tpu_torch import interop
    sc = j_syn.generate(j_syn.SyntheticSceneSpec(
        num_cameras=5, num_points=60, pixel_noise=0.5, seed=3))
    ja = j_syn.to_scene_arrays(sc)
    ta = interop.scene_arrays(ja._asdict(), device="cpu")
    je, jd, jm = j_proj.reproj_errors_obs(ja)
    te, td, tm = t_proj.reproj_errors_obs(ta)
    close(te, je)
    close(td, jd)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    close(t_proj.mean_reproj_error(ta), j_proj.mean_reproj_error(ja))


def test_triangulation():
    rng = np.random.default_rng(5)
    P, K = 30, 4
    q = _quats(rng, P * K).reshape(P, K, 4)
    q[..., 0] += 4.0
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(P, K, 3)) * 0.3
    X = rng.normal(size=(P, 3)) + [0, 0, 6]
    Rm = np.asarray(j_rot.quat_to_rotmat(jnp.asarray(q)))
    Xc = np.einsum("pkij,pj->pki", Rm, X) + t
    uv = Xc[..., :2] / Xc[..., 2:] + rng.normal(size=(P, K, 2)) * 1e-3
    mask = rng.random((P, K)) > 0.2
    mask[:, :2] = True
    close(t_tri.triangulate_dlt(T(q), T(t), T(uv), torch.as_tensor(mask)),
          j_tri.triangulate_dlt_batch(jnp.asarray(q), jnp.asarray(t),
                                      jnp.asarray(uv), jnp.asarray(mask)),
          rtol=1e-9)
    close(t_tri.triangulate_two_view(T(q[:, 0]), T(t[:, 0]), T(q[:, 1]),
                                     T(t[:, 1]), T(uv[:, 0]), T(uv[:, 1])),
          j_tri.triangulate_two_view(*(jnp.asarray(a) for a in (
              q[:, 0], t[:, 0], q[:, 1], t[:, 1], uv[:, 0], uv[:, 1]))),
          rtol=1e-9)
    oi = rng.integers(0, 5, 80)
    op = rng.integers(0, 20, 80)
    ouv = rng.normal(size=(80, 2))
    om = rng.random(80) > 0.1
    blocks = t_tri.track_blocks_from_obs(oi, op, ouv, om, 20, 6)
    for a, b in zip(blocks,
                    j_tri.track_blocks_from_obs(oi, op, ouv, om, 20, 6)):
        np.testing.assert_array_equal(a, np.asarray(b))
    qi, ti = q.reshape(-1, 4)[:5], t.reshape(-1, 3)[:5]
    tb = [torch.as_tensor(np.asarray(a)) for a in blocks]
    close(t_tri.triangulate_tracks(T(qi), T(ti), *tb),
          j_tri.triangulate_tracks(jnp.asarray(qi), jnp.asarray(ti),
                                   *(jnp.asarray(a) for a in blocks)),
          rtol=1e-9, atol=1e-9)


def test_polynomials():
    rng = np.random.default_rng(6)
    c = rng.normal(size=(20, 5))
    rt, mt = t_poly.solve_quartic_real(*(T(c[:, k]) for k in range(5)))
    rj, mj = j_poly.solve_quartic_real(*(jnp.asarray(c[:, k])
                                         for k in range(5)))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    close(np.where(mt.numpy(), rt.numpy(), 0), np.where(mj, rj, 0),
          rtol=1e-9)
    roots = rng.uniform(-3, 3, (4,))
    coeffs = np.poly(roots)
    rt, mt = t_poly.real_roots_sturm(T(coeffs), max_roots=6)
    rj, mj = j_poly.real_roots_sturm(jnp.asarray(coeffs), max_roots=6)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    close(rt, rj, rtol=1e-10)


def test_p3p_and_umeyama():
    rng = np.random.default_rng(7)
    for _ in range(5):
        R = np.asarray(j_rot.quat_to_rotmat(jnp.asarray(_quats(rng, 1)[0])))
        t = rng.normal(size=3)
        X = rng.normal(size=(3, 3)) + R.T @ (np.array([0, 0, 6.0]) - t)
        Xc = X @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:]
        Rt, tt, vt = t_ap.p3p(T(X), T(uv))
        Rj, tj, vj = j_ap.p3p(jnp.asarray(X), jnp.asarray(uv))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        v = vt.numpy()
        close(Rt.numpy()[v], np.asarray(Rj)[v], rtol=RTOL, atol=1e-9)
        close(tt.numpy()[v], np.asarray(tj)[v], rtol=RTOL, atol=1e-9)
        pts = rng.normal(size=(25, 3)) * 2 + [0, 0, 8]
        puv = rng.normal(size=(25, 2)) * 0.2
        close(t_ap.pose_reproj_error(T(R), T(t), T(pts), T(puv)),
              j_ap.pose_reproj_error(jnp.asarray(R), jnp.asarray(t),
                                     jnp.asarray(pts), jnp.asarray(puv)))
    x = rng.normal(size=(20, 3))
    y = 2.0 * x @ R.T + 1.0 + rng.normal(size=(20, 3)) * 0.01
    w = (rng.random(20) > 0.3).astype(float)
    for a, b in zip(t_ume.umeyama(T(x), T(y), T(w)),
                    j_ume.umeyama(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(w))):
        close(a, b, rtol=1e-9)
    for a, b in zip(t_ume.umeyama_np(x, y), j_ume.umeyama_np(x, y)):
        close(a, b)


def _pnp_data(seed, n=40, outliers=0.0, noise=0.0, f=1.0):
    """A pose, generic non-planar points in front of it, their
    normalized image coordinates / f, and the outlier flags."""
    rng = np.random.default_rng(seed)
    R = np.asarray(j_rot.quat_to_rotmat(jnp.asarray(_quats(rng, 1)[0])))
    t = rng.normal(size=3)
    X = rng.normal(size=(n, 3)) * [1.0, 1.5, 0.8] + R.T @ (
        np.array([0, 0, 6.0]) - t)
    Xc = X @ R.T + t
    uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(size=(n, 2)) * noise
    bad = rng.random(n) < outliers
    uv[bad] = rng.uniform(-0.4, 0.4, (bad.sum(), 2))
    return R, t, X, uv / f, bad


@pytest.mark.parametrize("masked", [False, True])
def test_epnp(masked):
    """Batched EPnP against the reference one problem at a time; masked
    rows hold outliers. eigh's signs differ between the libraries, so
    R and t are compared, not the eigenvectors."""
    Xs, uvs, ms, Rs = [], [], [], []
    for b in range(3):
        R, t, X, uv, bad = _pnp_data(20 + b, outliers=0.3 if masked else 0)
        Xs.append(X)
        uvs.append(uv)
        ms.append(~bad)
        Rs.append((R, t))
    Xs, uvs, ms = map(np.stack, (Xs, uvs, ms))
    Rt, tt, ok = t_ap.epnp(T(Xs), T(uvs),
                           torch.as_tensor(ms) if masked else None)
    for b in range(3):
        Rj, tj, okj = j_ap.epnp(jnp.asarray(Xs[b]), jnp.asarray(uvs[b]),
                                mask=jnp.asarray(ms[b]) if masked else None)
        assert bool(ok[b]) == bool(okj)
        close(Rt[b], Rj, rtol=0, atol=1e-8)
        close(tt[b], tj, rtol=0, atol=1e-8)
        close(Rt[b], Rs[b][0], rtol=0, atol=1e-8)


def test_ransac_p3p_with_epnp_refit_and_reference_samples():
    """The mapper's P3P LO-RANSAC (EPnP refit on the inliers) on the
    reference's own samples: the same inliers and model."""
    _, _, X, uv, bad = _pnp_data(31, n=80, outliers=0.25, noise=1e-3)
    mask = np.ones(80, bool)
    key, H, thr = jax.random.PRNGKey(3), 64, (12.0 / 1000) ** 2
    idx = np.asarray(j_rnsc._sample_indices(key, H, 3, 80,
                                            jnp.asarray(mask)))
    ref = j_im._ransac_p3p(key, jnp.asarray(X), jnp.asarray(uv),
                           jnp.asarray(mask), thr, H)
    res = t_im.ransac_p3p(T(X)[None], T(uv)[None], thr,
                          torch.as_tensor(idx)[None])
    np.testing.assert_array_equal(res.inliers[0].numpy(),
                                  np.asarray(ref.inliers))
    assert not res.inliers[0].numpy()[bad].any()
    # the EPnP refit of noisy inliers depends on its control points, and
    # those on eigh's signs: the poses agree to the noise
    close(res.model[0], ref.model, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed,true_index", [(40, 5), (41, 9)])
def test_ransac_p3p_focal_with_reference_samples(seed, true_index):
    """The focal grid on one shared sample set: the same factor wins,
    with the same inliers and model. Keypoints are exact at the true
    focal, which lies on the grid."""
    factors = np.exp(np.linspace(np.log(0.2), np.log(5.0), 15))
    f_true = 900.0
    focal0 = f_true / factors[true_index]
    _, _, X, uv, bad = _pnp_data(seed, n=60, outliers=0.2)
    centered = uv * f_true
    mask = np.ones(60, bool)
    key, H = jax.random.PRNGKey(seed), 64
    idx = np.asarray(j_rnsc._sample_indices(key, H, 3, 60,
                                            jnp.asarray(mask)))
    jm, ji, jn, jf = j_im._ransac_p3p_focal(
        key, jnp.asarray(X), jnp.asarray(centered), jnp.asarray(mask),
        focal0, 12.0, H)
    tm, ti, tn, tf = t_im._ransac_p3p_focal(
        T(X), T(centered), focal0, 12.0, torch.as_tensor(idx)[None])
    assert float(tf) == pytest.approx(float(jf), rel=1e-12)
    assert float(tf) == pytest.approx(factors[true_index], rel=1e-12)
    assert int(tn) == int(jn) == int((~bad).sum())
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(tm, jm, rtol=0, atol=1e-8)


def test_mapper_normalize_through_a_distorted_camera():
    """Both mappers' keypoint normalisation on a blind SIMPLE_RADIAL
    camera (k1 = -0.1): the port's per-call `_normalize` and its cached
    all-keypoints `_normalized` give the reference's coordinates."""
    spec = dict(num_cameras=4, num_points=300, seed=2, image_width=1024,
                image_height=768, focal=900.0)
    jcams, jimgs, jgraph = j_syn.to_matching_problem(
        j_syn.generate(j_syn.SyntheticSceneSpec(**spec)))
    tcams, timgs, tgraph = t_syn.to_matching_problem(
        t_syn.generate(t_syn.SyntheticSceneSpec(**spec)))
    params = (1228.8, 512.0, 384.0, -0.1)
    jm = j_im.IncrementalMapper({1: j_cm.Camera(1, 2, 1024, 768, params,
                                                prior_focal=False)},
                                jimgs, jgraph)
    tm = t_im.IncrementalMapper({1: t_cm.Camera(1, 2, 1024, 768, params,
                                                prior_focal=False)},
                                timgs, tgraph, device="cpu")
    for i in (1, 3):
        xys = np.asarray(tm.rec.images[i].xys)
        ref = np.asarray(jm._normalize(i, np.asarray(jm.rec.images[i].xys)))
        close(tm._normalize(i, xys), ref, rtol=0, atol=1e-10)
        close(tm._normalized(i, np.arange(len(xys))), ref, rtol=0,
              atol=1e-10)
    # the cache follows the camera: a new k1 gives new coordinates
    before = tm._normalized(2, np.arange(5))
    tm.rec.cameras[1] = tm.rec.cameras[1]._replace(
        params=(1228.8, 512.0, 384.0, -0.05))
    after = tm._normalized(2, np.arange(5))
    close(after, tm._normalize(2, tm.rec.images[2].xys[:5]), rtol=0,
          atol=0)
    assert np.abs(after - before).max() > 1e-4


def test_refine_pose_matches_reference():
    rng = np.random.default_rng(8)
    R = np.asarray(j_rot.quat_to_rotmat(jnp.asarray(_quats(rng, 1)[0])))
    t = rng.normal(size=3)
    X = rng.normal(size=(60, 3)) + R.T @ (np.array([0, 0, 7.0]) - t)
    Xc = X @ R.T + t
    uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(size=(60, 2)) * 1e-3
    mask = rng.random(60) > 0.1
    dR = np.asarray(j_rot.angleaxis_to_rotmat(jnp.asarray([0.01, -0.02,
                                                           0.015])))
    R0, t0 = dR @ R, t + 0.05
    Rt, tt = t_ap.refine_pose(T(R0), T(t0), T(X), T(uv),
                              torch.as_tensor(mask))
    Rj, tj = j_ap.refine_pose(jnp.asarray(R0), jnp.asarray(t0),
                              jnp.asarray(X), jnp.asarray(uv),
                              jnp.asarray(mask))
    close(Rt, Rj, rtol=1e-8, atol=1e-10)
    close(tt, tj, rtol=1e-8, atol=1e-10)


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devmod.resolve()
    with pytest.raises(RuntimeError):
        devmod.resolve("cuda")
    assert devmod.resolve("cpu").type == "cpu"
    from dagsfm_tpu_torch.pipeline.feature_pipeline import FeaturePipeline
    from dagsfm_tpu_torch.sfm.correspondence_graph import CorrespondenceGraph
    from dagsfm_tpu_torch.sfm.incremental_mapper import IncrementalMapper
    with pytest.raises(RuntimeError):
        FeaturePipeline({}, {})
    with pytest.raises(RuntimeError):
        IncrementalMapper({}, {}, CorrespondenceGraph())
    from dagsfm_tpu_torch import interop
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=2, num_points=10, image_width=32, image_height=32))
    with pytest.raises(RuntimeError):
        t_syn.render_images(sc, camera=t_cm.make_simple_camera(
            1, 32, 32, model="SIMPLE_RADIAL"))
    with pytest.raises(RuntimeError):
        interop.ba_problem({})
    from dagsfm_tpu_torch.sfm import bundle_adjustment as t_ba
    with pytest.raises(RuntimeError):
        t_ba.problem_from_observations(
            np.array([[1.0, 0, 0, 0]]), np.zeros((1, 3)), [0], [0],
            np.zeros((1, 12)), np.zeros((1, 3)), [0], [0], np.zeros((1, 2)))
    from dagsfm_tpu_torch.clustering.image_clustering import ImageClustering
    from dagsfm_tpu_torch.clustering.spectral import spectral_cluster
    from dagsfm_tpu_torch.estimation import rotation_averaging as t_ra
    from dagsfm_tpu_torch.graph import native as t_ng
    from dagsfm_tpu_torch.graph.view_graph import ViewGraph
    from dagsfm_tpu_torch.pipeline.distributed_mapper import \
        DistributedMapperController
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        load_two_view_geometries_from_database, run_matcher_on_database)
    from dagsfm_tpu_torch.scene.reconstruction import Reconstruction
    from dagsfm_tpu_torch.sfm.aligner import SfMAligner
    from dagsfm_tpu_torch.sfm.mapper_controller import MapperController
    from dagsfm_tpu_torch.sfm.two_view import verify_pairs
    edges, rels = np.array([[0, 1]]), np.eye(3)[None]
    for call in (
            lambda: ViewGraph().filter_cycles_by_rotation(),
            lambda: spectral_cluster(edges, np.ones(1), 4, 2),
            lambda: t_ng.ncut(2, edges, np.ones(1), 2),
            lambda: ImageClustering([0, 1], {(0, 1): 1.0}),
            lambda: t_ra.estimate_rotations(2, edges, rels),
            lambda: t_ra.estimate_rotations_nonlinear(2, edges, rels),
            lambda: t_ra.filter_pairs_from_orientation(edges, rels,
                                                       np.eye(3)[[0, 0]]),
            lambda: SfMAligner([]),
            lambda: IncrementalMapper.wrap({}, Reconstruction(),
                                           CorrespondenceGraph()),
            lambda: DistributedMapperController({}, {},
                                                CorrespondenceGraph()),
            lambda: FeaturePipeline({}, {}, database_path="database.db"),
            lambda: MapperController({}, {}, CorrespondenceGraph()),
            lambda: verify_pairs([]),
            lambda: load_two_view_geometries_from_database("database.db"),
            lambda: run_matcher_on_database("database.db", [(1, 2)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
