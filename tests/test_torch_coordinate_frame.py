"""estimation/coordinate_frame.py of the port against the JAX package's
on the CPU, inputs from numpy seeds.

- The host functions (consensus axis, rotation between unit vectors,
  vanishing points, segment classes) equal the JAX package's to 1e-15.
- The Sobel gradients equal `lax.conv`'s bit for bit (the port adds the
  taps in XLA:CPU's order, `coordinate_frame._sobel`).
- The Hough accumulator (float32) to 1e-5 of its largest bin, leaving
  out the pixels that rounding decides: their gradient angle or rho sits
  within 1e-4 of a bin's edge (in bin units; float32 rounding of atan2,
  cos and sin moves them by about 5e-6), or their |grad| within rel 1e-6
  of the vote threshold. Each such vote may land in any bin its angle
  and rho reach within 1e-4 (theta wraps at pi, where rho changes
  sign), so a bin may differ by the weight of the votes that may land
  in it (`chip_smoke.rounding_slack`, which the card's gate uses too);
  the test counts them and reports them. The peak bins of detect_lines
  are
  the same, but for bins at the top K's cut-off that such a pixel moves
  across it (counted; none on the images of lines); equal supports
  (ties) are counted.
- IMAGE-ORIENTATION: the gravity vector, the rotation and the aligned
  model to 1e-12; MANHATTAN-WORLD: the same frame to 1e-12 on images of
  anti-aliased lines through each camera's vanishing points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import line_images, peak_bins, rounding_slack
from dagsfm_tpu.estimation import coordinate_frame as J
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.estimation import coordinate_frame as T
from dagsfm_tpu_torch.ops import rotations as t_rops
from dagsfm_tpu_torch.scene import synthetic as t_syn

torch.set_num_threads(1)

def rendered(num=3, W=256, H=192, seed=4):
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=num, num_points=50, image_width=W, image_height=H,
        focal=120.0 * W / 256, seed=seed, ring_radius=9.0,
        point_cloud_extent=3.5))
    return [np.asarray(v, np.float32) for v in
            t_syn.render_images(sc, device="cpu").values()]


def box():
    img = np.zeros((128, 128), np.float32)
    img[:, 30:50] = 1.0
    img[:, 80:90] = 0.6
    img[20:40, :] += 0.4
    return img


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    smooth = np.cumsum(np.cumsum(rng.normal(size=(96, 80)), 0), 1)
    smooth = ((smooth - smooth.min()) / np.ptp(smooth)).astype(np.float32)
    _, trec = _yawed_rec()
    return {"rendered": rendered(), "smooth": [smooth], "box": [box()],
            "lines": list(manhattan_images(trec).values())}


def test_host_functions_are_the_reference_s():
    rng = np.random.default_rng(0)
    good = [np.array([0, 1, 0.0]) + rng.normal(0, 0.005, 3)
            for _ in range(15)]
    axes = [a / np.linalg.norm(a) for a in good] + [
        np.array([1.0, 0, 0]), np.array([0.0, 0, 1])]
    for d in (0.05, 0.001):
        np.testing.assert_array_equal(T.find_best_consensus_axis(axes, d),
                                      J.find_best_consensus_axis(axes, d))
    assert np.array_equal(T.find_best_consensus_axis([]), np.zeros(3))
    pairs = [(rng.normal(size=3), rng.normal(size=3)) for _ in range(4)]
    pairs += [([0, 0, 1], [0, 0, 1]), ([0, 0, 1], [0, 0, -1]),
              ([1, 0, 0], [-1, 0, 0])]
    for a, b in pairs:
        np.testing.assert_allclose(T.rotation_from_unit_vectors(a, b),
                                   J.rotation_from_unit_vectors(a, b),
                                   rtol=0, atol=1e-15)
    vp_true = np.array([250.0, -120.0, 1.0])
    lines = []
    for ang in np.linspace(0.2, 2.8, 10):
        n = np.array([-np.sin(ang), np.cos(ang)])
        lines.append([n[0], n[1], -(n @ vp_true[:2])])
    lines = np.asarray(lines) + rng.normal(0, 1e-3, (10, 3))
    w = rng.uniform(1, 5, 10)
    for thr, f in ((0.02, 500.0), (0.002, 100.0)):
        tv, ti = T.estimate_vanishing_point(lines, w, thr, f)
        jv, ji = J.estimate_vanishing_point(lines, w, thr, f)
        assert np.array_equal(tv, jv) and np.array_equal(ti, ji)
    segs = rng.normal(0, 50, (40, 2, 2))
    for tol in (0.25, 0.6):
        assert np.array_equal(
            T.classify_line_segment_orientations(segs, tol),
            J.classify_line_segment_orientations(segs, tol))
    frame = np.zeros((3, 3))
    frame[:, 1] = [0.1, 0.99, 0.0]
    for fr in (frame, frame[:, ::-1].copy(), np.eye(3)[[1, 0, 2]]):
        np.testing.assert_allclose(T.align_to_manhattan_world(None, fr),
                                   J.align_to_manhattan_world(None, fr),
                                   rtol=0, atol=1e-15)


def test_sobel_is_lax_conv_bit_for_bit(images):
    kx = jnp.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], jnp.float32)
    conv = jax.jit(lambda p, k: jax.lax.conv(p, k[None, None], (1, 1),
                                             "VALID")[0, 0])
    for img in images["rendered"] + images["smooth"] + images["box"]:
        pad = jnp.pad(jnp.asarray(img), 1, mode="edge")[None, None]
        gx, gy = T._sobel(torch.as_tensor(img))
        assert np.array_equal(gx.numpy(), np.asarray(conv(pad, kx)))
        assert np.array_equal(gy.numpy(), np.asarray(conv(pad, kx.T)))


def peak_set(lines, rho_max) -> set:
    return set(peak_bins(lines, rho_max))


@pytest.mark.parametrize("kind", ["rendered", "smooth", "lines", "box"])
def test_hough_accumulator(images, kind, capsys):
    # the rendered and smooth images' peaks stay under the default
    # support of 20 at these sizes: their peaks are compared above 0.5
    opts = J.ManhattanOptions(
        min_line_support=20.0 if kind in ("lines", "box") else 0.5)
    topts = interop.manhattan_options(opts)
    for img in images[kind]:
        ja, jr = J._hough_accumulate(jnp.asarray(img), 60, 128)
        ja = np.asarray(ja)
        ta, tr = T._hough_accumulate(torch.as_tensor(img), 60, 128)
        ta = ta.numpy()
        assert ta.dtype == np.float32 and tr == float(jr)
        n_edge, slack = rounding_slack(img, 60, 128)
        tol = 1e-5 * np.abs(ja).max()
        assert (np.abs(ta - ja) <= tol + slack).all()
        clean = slack == 0
        assert np.abs(ta - ja)[clean].max() <= tol
        # the peak bins
        tl = T.detect_lines(img, topts, device="cpu")
        jl = J.detect_lines(img, opts)
        ties = int(np.sum(np.diff(tl[1]) == 0))
        with capsys.disabled():
            print(f"\n  {kind} {img.shape}: {n_edge} votes decided by "
                  f"rounding, {int((~clean).sum())} bins they may land in; "
                  f"lines {len(tl[0])} (JAX package {len(jl[0])}), "
                  f"{ties} tied supports")
        if kind != "box":
            # the same bins, but for bins at the top K's cut-off that a
            # rounding-decided pixel moves across it (counted)
            tb, jb = peak_set(tl, tr), peak_set(jl, tr)
            moved = tb ^ jb
            with capsys.disabled():
                print(f"  peak bins differing {len(moved)} of {len(jb)}")
            assert len(tl[0]) >= 4 and len(moved) <= len(jb) // 4
            # a bin moves in or out of the top K only at the cut-off:
            # within the votes rounding may move into it or into the
            # K-th bins
            cut = min(tl[1][-1], jl[1][-1])
            s_cut = max(slack[peak_bins(x, tr)[-1]] for x in (tl, jl))
            assert all(abs(max(ta[b], ja[b]) - cut)
                       <= 2 * tol + slack[b] + s_cut for b in moved)
            same = [k for k, b in enumerate(peak_bins(jl, tr)) if b in tb]
            tk = [peak_bins(tl, tr).index(peak_bins(jl, tr)[k])
                  for k in same]
            np.testing.assert_allclose(tl[0][tk], jl[0][same], rtol=0,
                                       atol=1e-12)
            np.testing.assert_allclose(tl[1][tk], jl[1][same], rtol=1e-5,
                                       atol=slack.max())
            if kind == "lines":
                assert not moved and np.array_equal(tl[2], jl[2])
                np.testing.assert_allclose(tl[1], jl[1], rtol=1e-5)
        else:
            # a synthetic edge along the axes puts every pixel of it on
            # the edge of theta bins 29 and 30, where atan2's last bit
            # decides: the JAX package's peaks are not the port's there
            assert n_edge > 1000


def test_line_segments(images):
    for img in images["rendered"][:2] + images["smooth"]:
        ts, tl = T.detect_line_segments(img, device="cpu")
        js, jl = J.detect_line_segments(img)
        assert np.array_equal(tl, jl)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-9)
        assert np.array_equal(T.classify_line_segment_orientations(ts),
                              J.classify_line_segment_orientations(js))


def synth_rec(n=8, seed=0):
    sc = j_syn.generate(j_syn.SyntheticSceneSpec(
        num_cameras=n, num_points=120, pixel_noise=0.0, seed=seed))
    jrec = j_syn.to_reconstruction(sc)
    return jrec, interop.reconstruction(jrec.cameras, jrec.images,
                                        jrec.points3D)


def _same_models(trec, jrec, atol):
    for i in jrec.images:
        np.testing.assert_allclose(trec.images[i].qvec, jrec.images[i].qvec,
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(trec.images[i].tvec, jrec.images[i].tvec,
                                   rtol=0, atol=atol * 10)
    for p in jrec.points3D:
        np.testing.assert_allclose(trec.points3D[p].xyz,
                                   jrec.points3D[p].xyz, rtol=0,
                                   atol=atol * 10)


@pytest.mark.parametrize("seed", [0, 3])
def test_image_orientation_alignment(seed):
    from dagsfm_tpu_torch.pipeline.cli import model_orientation_aligner
    jrec, trec = synth_rec(seed=seed)
    g_j = J.estimate_gravity_vector_from_image_orientation(jrec)
    g_t = T.estimate_gravity_vector_from_image_orientation(trec)
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-12)
    tf_j = J.rotation_from_unit_vectors(g_j, [0, 1, 0])
    tform, frame = model_orientation_aligner(trec, "image-orientation")
    np.testing.assert_allclose(tform, tf_j, rtol=0, atol=1e-12)
    assert frame is None
    jrec.transform(1.0, np.asarray(tf_j, float), np.zeros(3))
    _same_models(trec, jrec, 1e-12)
    g = T.estimate_gravity_vector_from_image_orientation(trec)
    assert g @ [0, 1, 0] > 0.9


def manhattan_images(rec, W=160, H=120):
    """chip_smoke.line_images at 160 x 120: lines through each camera's
    vanishing points of the world's x and y axes."""
    return line_images(rec, W, H)


def _yawed_rec(n=4, seed=1):
    """n cameras yawed about the world's y axis and tilted a little."""
    jrec, _ = synth_rec(n=n, seed=seed)
    rng = np.random.default_rng(seed)
    for k, iid in enumerate(sorted(jrec.images)):
        aa = np.array([rng.normal(0, 0.05), 0.3 * k, rng.normal(0, 0.05)])
        R = t_rops.angleaxis_to_rotmat(torch.as_tensor(aa)).numpy()
        jrec.images[iid].qvec = t_rops.rotmat_to_quat_np(R)
    return jrec, interop.reconstruction(jrec.cameras, jrec.images,
                                        jrec.points3D)


@pytest.mark.parametrize("max_size", [256, 100])
def test_manhattan_frame(max_size):
    from dagsfm_tpu_torch.pipeline.cli import model_orientation_aligner
    jrec, trec = _yawed_rec()
    imgs = manhattan_images(trec)
    opts = J.ManhattanOptions(max_image_size=max_size)
    fj = J.estimate_manhattan_world_frame(jrec, imgs, opts)
    ft = T.estimate_manhattan_world_frame(
        trec, imgs, interop.manhattan_options(opts),
        device="cpu")
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-12)
    assert abs(ft[:, 1] @ [0, 1, 0]) > 0.99     # the planted down axis
    tform, frame = model_orientation_aligner(trec, "manhattan-world",
                                             imgs, max_size, "cpu")
    np.testing.assert_allclose(frame, fj, rtol=0, atol=1e-12)
    jrec.transform(1.0, np.asarray(J.align_to_manhattan_world(jrec, fj),
                                   float), np.zeros(3))
    _same_models(trec, jrec, 1e-12)


def test_invalid_method_exits():
    _, trec = synth_rec(n=3)
    from dagsfm_tpu_torch.pipeline.cli import model_orientation_aligner
    with pytest.raises(SystemExit, match="Invalid `method`"):
        model_orientation_aligner(trec, "upright")
