"""The port's multi-view stereo against the JAX package on the CPU, on
tests/test_mvs.py's 48 x 64 textured plane seen by three cameras.

Depth and normal maps, PLY points and meshes are compared byte for byte
(mvs/io.py, meshing.write_ply_mesh), the cost functions to rel 1e-12 and
the plane sweep, PatchMatch refinement, normals, consistency masks,
fusion and the dense controller in float64 on both sides. torch cannot
replay jax.random, so the refinement's perturbations are the
reference's own draws, put into `patch_match._draw_perturbations` (the
same key splits: per view, per iteration, then two).

Two things are decided by rounding, and the comparisons leave them out
and count them:
  - near ties: a pixel whose reference best and second-best plane-sweep
    costs lie within 1e-9;
  - image edges: in this scene a source's rows (or columns) map exactly
    onto the reference's, so row 0 (column 0) of the reference view
    projects onto the source's edge, 0 ± 1 ulp, where the in-bounds test
    `y >= 0` goes either way (the reference's own jitted plane sweep and
    its eager cost functions disagree there), and at depths 3 and 8 (the
    sweep's first and last planes) whole rows and columns shift by an
    integer onto it. Such a pixel changes the ZNCC cost of every pixel
    whose window holds it, and the refinement carries a change one
    window and one shift further per iteration (wrapping around the
    image, as its `roll` does): the comparisons of refined maps leave out
    that toroidal margin. In fusion the same projections decide a
    consistency check: fused clouds are compared on the pixels both
    packages keep.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.mvs import controller as j_ctl
from dagsfm_tpu.mvs import fusion as j_fus
from dagsfm_tpu.mvs import io as j_io
from dagsfm_tpu.mvs import meshing as j_mesh
from dagsfm_tpu.mvs import patch_match as j_pm
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.mvs import controller as t_ctl
from dagsfm_tpu_torch.mvs import fusion as t_fus
from dagsfm_tpu_torch.mvs import io as t_io
from dagsfm_tpu_torch.mvs import meshing as t_mesh
from dagsfm_tpu_torch.mvs import patch_match as t_pm
from tests.test_mvs import FOCAL, PLANE_Z, H, K, W, _cameras, _rel, _render

torch.set_num_threads(1)

T = (lambda a: torch.as_tensor(np.array(a, np.float64)))


@pytest.fixture(scope="module")
def scene():
    Rs, ts = _cameras()
    imgs, depths = zip(*[_render(R, t) for R, t in zip(Rs, ts)])
    R_rel = np.stack([_rel(0, s, Rs, ts)[0] for s in (1, 2)])
    t_rel = np.stack([_rel(0, s, Rs, ts)[1] for s in (1, 2)])
    ref = np.asarray(imgs[0], np.float64)
    src = np.stack([imgs[1], imgs[2]]).astype(np.float64)
    args = (ref, src, K, np.stack([K, K]), R_rel, t_rel)
    return types.SimpleNamespace(Rs=Rs, ts=ts, imgs=imgs, depths=depths,
                                 args=args)


def j_args(s):
    return tuple(jnp.asarray(a) for a in s.args)


def t_args(s):
    return tuple(T(a) for a in s.args)


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def dilate(mask, r: int, wrap: bool = False):
    """Chebyshev dilation by r pixels (toroidal with wrap)."""
    out = mask.copy()
    for axis in (0, 1):
        acc = out.copy()
        for k in range(1, r + 1):
            for sh in (k, -k):
                if wrap:
                    acc |= np.roll(out, sh, axis)
                else:
                    rolled = np.roll(out, sh, axis)
                    idx = [slice(None)] * 2
                    idx[axis] = slice(0, sh) if sh > 0 else slice(sh, None)
                    rolled[tuple(idx)] = False
                    acc |= rolled
        out = acc
    return out


def edge_pixels(s, depths, eps=1e-9):
    """(H, W): reference pixels that project within eps px of a source's
    in-bounds limits at any of the depth maps `depths` (..., H, W)."""
    ref, src, Kr, Ks, R_rel, t_rel = t_args(s)
    rays = t_pm._pixel_rays(torch.linalg.inv(Kr), H, W)
    out = np.zeros((H, W), bool)
    for d in T(depths).reshape(-1, H, W):
        X = (rays * d).reshape(3, -1)
        ps = Ks @ (R_rel @ X + t_rel[:, :, None])
        x = (ps[:, 0] / ps[:, 2]).numpy().reshape(-1, H, W)
        y = (ps[:, 1] / ps[:, 2]).numpy().reshape(-1, H, W)
        near = ((np.abs(x) < eps) | (np.abs(x - (W - 1.001)) < eps)
                | (np.abs(y) < eps) | (np.abs(y - (H - 1.001)) < eps))
        out |= near.any(0)
    return out


def reference_draws(key):
    """`_draw_perturbations` as the reference's refine(key, ...) draws."""
    def draw(generator, n, shape, perturbation, dtype=None):
        out = []
        for k in jax.random.split(key, n):
            k1, k2 = jax.random.split(k)
            out.append([np.asarray(jax.random.uniform(
                kk, shape, minval=-sc, maxval=sc))
                for kk, sc in ((k1, perturbation),
                               (k2, 0.25 * perturbation))])
        return torch.as_tensor(np.asarray(out))
    return draw


def reference_chain(seed):
    """`_draw_perturbations` as the reference's dense_reconstruct draws:
    PRNGKey(seed) split once per view, in view order."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(generator, n, shape, perturbation, dtype=None):
        state["key"], sub = jax.random.split(state["key"])
        return reference_draws(sub)(generator, n, shape, perturbation)
    return draw


# --------------------------------------------------------------- mvs/io.py

@pytest.mark.parametrize("channels", [0, 1, 3])
def test_map_bin_bytes_and_read(tmp_path, channels):
    rng = np.random.default_rng(channels)
    data = rng.normal(size=(H, W) if channels == 0 else (H, W, channels))
    j_io.write_map_bin(str(tmp_path / "ref.bin"), data)
    t_io.write_map_bin(str(tmp_path / "port" / "x.bin"), data)
    raw = (tmp_path / "ref.bin").read_bytes()
    assert raw == (tmp_path / "port" / "x.bin").read_bytes()
    back = t_io.read_map_bin(str(tmp_path / "ref.bin"))
    ref = j_io.read_map_bin(str(tmp_path / "ref.bin"))
    assert back.dtype == ref.dtype and np.array_equal(back, ref)


def test_map_paths():
    for kind in ("geometric", "photometric"):
        assert t_io.depth_map_path("ws", "a/im.png", kind) == \
            j_io.depth_map_path("ws", "a/im.png", kind)
        assert t_io.normal_map_path("ws", "im.png", kind) == \
            j_io.normal_map_path("ws", "im.png", kind)


@pytest.mark.parametrize("normal", [False, True])
@pytest.mark.parametrize("color", [None, "gray", "rgb255"])
def test_ply_points_bytes(tmp_path, normal, color):
    rng = np.random.default_rng(3)
    n = 257
    xyz = rng.normal(size=(n, 3))
    nrm = rng.normal(size=(n, 3)) if normal else None
    col = {None: None, "gray": rng.uniform(0, 1, n),
           "rgb255": rng.uniform(0, 300, (n, 3))}[color]
    j_io.write_ply_points(str(tmp_path / "ref.ply"), xyz, nrm, col)
    t_io.write_ply_points(str(tmp_path / "port.ply"), xyz, nrm, col)
    assert (tmp_path / "ref.ply").read_bytes() == \
        (tmp_path / "port.ply").read_bytes()
    got, ref = (t_io.read_ply_points(str(tmp_path / "ref.ply")),
                j_io.read_ply_points(str(tmp_path / "ref.ply")))
    assert np.array_equal(got[0], ref[0])
    assert (got[1] is None) == (ref[1] is None) == (not normal)
    if normal:
        assert np.array_equal(got[1], ref[1])


def test_read_ascii_ply(tmp_path):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(20, 6))
    p = tmp_path / "a.ply"
    with open(p, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 20\n"
                + "".join(f"property float {c}\n"
                          for c in ("x", "y", "z", "nx", "ny", "nz"))
                + "end_header\n")
        np.savetxt(f, pts)
    got, ref = t_io.read_ply_points(str(p)), j_io.read_ply_points(str(p))
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])


# ------------------------------------------------------ mvs/patch_match.py

def test_box_and_zncc(scene):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, H, W))
    for r in (1, 2, 3):
        assert rel_err(t_pm._box(T(x), r).numpy(),
                       j_pm._box(jnp.asarray(x), r)) <= 1e-12
    ref = scene.args[0]
    warped = rng.normal(size=(H, W))
    valid = rng.uniform(size=(H, W)) > 0.3
    assert rel_err(
        t_pm._zncc_cost(T(ref), T(warped), torch.as_tensor(valid), 2).numpy(),
        j_pm._zncc_cost(jnp.asarray(ref), jnp.asarray(warped),
                        jnp.asarray(valid), 2)) <= 1e-12


def test_bilinear_stack_equals_per_source(scene):
    rng = np.random.default_rng(6)
    src = scene.args[1]
    y = rng.uniform(-3, H + 2, (4, 2, H, W))
    x = rng.uniform(-3, W + 2, (4, 2, H, W))
    v, ok = t_pm._bilinear(T(src), T(y), T(x))
    for s in range(2):
        jv, jok = j_pm._bilinear(jnp.asarray(src[s]), jnp.asarray(y[:, s]),
                                 jnp.asarray(x[:, s]))
        assert np.array_equal(ok[:, s].numpy(), np.asarray(jok))
        assert rel_err(np.where(jok, v[:, s].numpy(), 0),
                       np.where(jok, jv, 0)) <= 1e-12


@pytest.mark.parametrize("depth", ["plane", "random"])
def test_warp_and_multi_view_cost(scene, depth):
    rng = np.random.default_rng(7)
    d = (scene.depths[0].astype(np.float64) if depth == "plane"
         else rng.uniform(3.0, 8.0, (H, W)))
    ref, src, Kr, Ks, R_rel, t_rel = scene.args
    Kinv = np.linalg.inv(Kr)
    for s in range(2):
        got = t_pm._warp_cost(T(ref), T(src[s]), T(Kinv), T(Ks[s]),
                              T(R_rel[s]), T(t_rel[s]), T(d), 2)
        want = j_pm._warp_cost(jnp.asarray(ref), jnp.asarray(src[s]),
                               jnp.asarray(Kinv), jnp.asarray(Ks[s]),
                               jnp.asarray(R_rel[s]), jnp.asarray(t_rel[s]),
                               jnp.asarray(d), 2)
        assert rel_err(got.numpy(), want) <= 1e-12
    opts = j_pm.PatchMatchOptions()
    got = t_pm._multi_view_cost(T(ref), T(src), T(Kinv), T(Ks), T(R_rel),
                                T(t_rel), T(np.stack([d, d * 1.1])),
                                interop.patch_match_options(opts._asdict()))
    for k, dd in enumerate((d, d * 1.1)):
        want = j_pm._multi_view_cost(
            jnp.asarray(ref), jnp.asarray(src), jnp.asarray(Kinv),
            jnp.asarray(Ks), jnp.asarray(R_rel), jnp.asarray(t_rel),
            jnp.asarray(dd), opts)
        assert rel_err(got[k].numpy(), want) <= 1e-12


def test_depth_hypotheses_match_linspace():
    for dmin, dmax, n in ((3.0, 8.0, 48), (0.7, 31.3, 64), (2.0, 2.5, 3)):
        got = t_pm.depth_hypotheses(dmin, dmax, n).numpy()
        want = np.asarray(jnp.linspace(1.0 / dmax, 1.0 / dmin, n))
        assert np.abs(got - want).max() <= 2 * np.spacing(want).max()
        assert got[0] == want[0] and got[-1] == want[-1]


def _reference_volume(s, opts):
    """The reference's plane-sweep cost volume, one hypothesis at a time
    (its eager cost functions)."""
    ref, src, Kr, Ks, R_rel, t_rel = j_args(s)
    Kinv = jnp.linalg.inv(Kr)
    inv_d = jnp.linspace(1.0 / 8.0, 1.0 / 3.0, opts.num_depths)
    return np.stack([np.asarray(j_pm._multi_view_cost(
        ref, src, Kinv, Ks, R_rel, t_rel, jnp.full((H, W), d), opts))
        for d in np.asarray(1.0 / inv_d)]), np.asarray(1.0 / inv_d)


@pytest.mark.parametrize("num_depths,radius", [(48, 2), (16, 1)])
def test_plane_sweep(scene, num_depths, radius):
    opts = j_pm.PatchMatchOptions(num_depths=num_depths,
                                  window_radius=radius)
    jd, jc = j_pm.plane_sweep(*j_args(scene), 3.0, 8.0, opts)
    td, tc = t_pm.plane_sweep(*t_args(scene), 3.0, 8.0,
                              interop.patch_match_options(opts._asdict()))
    vol, hyps = _reference_volume(scene, opts)
    srt = np.sort(vol, 0)
    ties = srt[1] - srt[0] < 1e-9
    edge = dilate(edge_pixels(scene, hyps[:, None, None] * np.ones(
        (1, H, W))), radius)
    off = ties | edge
    differ = np.abs(td.numpy() - np.asarray(jd)) > 1e-9 * np.asarray(jd)
    print(f"plane sweep D={num_depths} r={radius}: {int(ties.sum())} "
          f"near-tie and {int(edge.sum())} edge pixels of {H * W}; "
          f"{int(differ.sum())} depths differ, {int((differ & ~off).sum())}"
          " elsewhere")
    assert not (differ & ~off).any()
    assert rel_err(np.where(off, 0, tc.numpy()), np.where(off, 0, jc)) <= 1e-9
    assert int(off.sum()) < H * W // 2
    assert td.dtype == torch.float64


def refine_margin(scene, maps, radius: int, iterations: int):
    """Pixels a refinement may decide differently: within radius +
    iterations (radius + 1) of an edge pixel, on the torus."""
    return dilate(edge_pixels(scene, maps), radius + iterations *
                  (radius + 1), wrap=True)


@pytest.mark.parametrize("iterations,radius", [(2, 2), (3, 1)])
def test_refine_with_the_reference_draws(scene, monkeypatch, iterations,
                                         radius):
    opts = j_pm.PatchMatchOptions(num_depths=16, window_radius=radius,
                                  num_iterations=iterations)
    topts = interop.patch_match_options(opts._asdict())
    d0, _ = j_pm.plane_sweep(*j_args(scene), 3.0, 8.0, opts)
    key = jax.random.PRNGKey(3)
    jd, jc = j_pm.refine(key, *j_args(scene), d0, 3.0, 8.0, opts)
    monkeypatch.setattr(t_pm, "_draw_perturbations", reference_draws(key))
    td, tc = t_pm.refine(None, *t_args(scene), T(d0), 3.0, 8.0, topts)
    jd, jc = np.asarray(jd), np.asarray(jc)
    margin = refine_margin(scene, np.stack([np.asarray(d0), jd,
                                            td.numpy()]), radius, iterations)
    differ = np.abs(td.numpy() - jd) > 1e-9 * jd
    print(f"refine n={iterations} r={radius}: margin {int(margin.sum())} of "
          f"{H * W} pixels; {int(differ.sum())} depths differ, "
          f"{int((differ & ~margin).sum())} outside it")
    assert not (differ & ~margin).any()
    assert rel_err(np.where(margin, 0, tc.numpy()),
                   np.where(margin, 0, jc)) <= 1e-9
    assert int((~margin).sum()) >= H * W // 4
    # the refinement moved depths, and toward the plane
    interior = ~margin
    assert (np.abs(jd - np.asarray(d0))[interior] > 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_perturbation_draws_are_seeded(dtype):
    a = t_pm._draw_perturbations(torch.Generator().manual_seed(5), 3,
                                 (4, 6), 0.1, dtype)
    b = t_pm._draw_perturbations(torch.Generator().manual_seed(5), 3,
                                 (4, 6), 0.1, dtype)
    assert a.shape == (3, 2, 4, 6) and a.dtype == dtype
    assert torch.equal(a, b)
    assert float(a[:, 0].abs().max()) <= 0.1
    assert float(a[:, 1].abs().max()) <= 0.025


@pytest.mark.parametrize("which", ["truth", "noisy"])
def test_normals_from_depth(scene, which):
    d = scene.depths[0].astype(np.float64)
    if which == "noisy":
        d = d * (1 + 0.01 * np.random.default_rng(8).normal(size=d.shape))
    got = t_pm.normals_from_depth(T(d), T(K)).numpy()
    want = np.asarray(j_pm.normals_from_depth(jnp.asarray(d),
                                              jnp.asarray(K)))
    assert np.abs(got - want).max() <= 1e-12


def test_gradient_edges_match_jnp():
    x = np.random.default_rng(9).normal(size=(5, 7, 6))
    for axis in (0, 1, 2):
        assert np.array_equal(torch.gradient(T(x), dim=axis)[0].numpy(),
                              np.asarray(jnp.gradient(jnp.asarray(x),
                                                      axis=axis)))


def test_estimate_depth_map(scene, monkeypatch):
    opts = j_pm.PatchMatchOptions(num_depths=24, num_iterations=2)
    key = jax.random.PRNGKey(11)
    jd, jn, jc = j_pm.estimate_depth_map(key, *j_args(scene), 3.0, 8.0, opts)
    monkeypatch.setattr(t_pm, "_draw_perturbations", reference_draws(key))
    td, tn, tc = t_pm.estimate_depth_map(
        None, *t_args(scene), 3.0, 8.0,
        interop.patch_match_options(opts._asdict()))
    margin = refine_margin(scene, np.stack([np.asarray(jd), td.numpy()]), 2,
                           3)
    normal_margin = dilate(margin, 1)
    assert rel_err(np.where(margin, 0, td.numpy()),
                   np.where(margin, 0, jd)) <= 1e-9
    assert rel_err(np.where(normal_margin[..., None], 0, tn.numpy()),
                   np.where(normal_margin[..., None], 0, jn)) <= 1e-9
    err = np.abs(td.numpy() - scene.depths[0])[~margin] / PLANE_Z
    assert np.median(err) < 0.02


# ---------------------------------------------------------- mvs/fusion.py

def _consistency_inputs(scene, corrupt):
    depths = [d.astype(np.float64) for d in scene.depths]
    if corrupt:
        rng = np.random.default_rng(12)
        depths[1] = depths[1] * (1 + 0.02 * rng.normal(size=(H, W)))
    return depths


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("r,s", [(0, 1), (0, 2), (1, 0), (2, 1)])
def test_consistency_check_masks(scene, corrupt, r, s):
    d = _consistency_inputs(scene, corrupt)
    Rs, ts = scene.Rs, scene.ts
    want = np.asarray(j_fus.consistency_check(
        jnp.asarray(d[r]), None, jnp.asarray(K), jnp.asarray(Rs[r]),
        jnp.asarray(ts[r]), jnp.asarray(d[s]), jnp.asarray(K),
        jnp.asarray(Rs[s]), jnp.asarray(ts[s]), jnp.asarray(2.0),
        jnp.asarray(0.01)))
    got = t_fus.consistency_check(
        T(d[r]), None, T(K), T(Rs[r]), T(ts[r]), T(d[s]), T(K), T(Rs[s]),
        T(ts[s]), 2.0, 0.01).numpy()
    ok, z, d_src, reproj = (x.numpy() for x in t_fus._consistency_terms(
        T(d[r]), T(K), T(Rs[r]), T(ts[r]), T(d[s]), T(K), T(Rs[s]),
        T(ts[s])))
    # the thresholds' near ties, and projections onto the source's edges
    border = ((np.abs(np.abs(d_src - z) - 0.01 * np.abs(z))
               < 1e-9 * np.abs(z)) | (np.abs(reproj - 2.0) < 1e-9))
    Xs = (np.linalg.inv(K) @ np.stack([*np.mgrid[0:H, 0:W][::-1],
                                       np.ones((H, W))]).reshape(3, -1)
          ).reshape(3, H, W) * d[r]
    Xs = np.einsum("ij,jhw->ihw", Rs[s] @ Rs[r].T, Xs - ts[r][:, None, None]
                   ) + ts[s][:, None, None]
    px = K[0, 0] * Xs[0] / Xs[2] + K[0, 2]
    py = K[1, 1] * Xs[1] / Xs[2] + K[1, 2]
    border |= ((np.abs(px) < 1e-9) | (np.abs(py) < 1e-9)
               | (np.abs(px - (W - 1.001)) < 1e-9)
               | (np.abs(py - (H - 1.001)) < 1e-9))
    differ = got != want
    print(f"consistency r={r} s={s} corrupt={corrupt}: {int(want.sum())} "
          f"consistent, {int(border.sum())} borderline, {int(differ.sum())} "
          "differ")
    assert not (differ & ~border).any()
    assert int(border.sum()) <= H + W


def kept_pixels(fus, depths, Rs, ts, min_num_consistent):
    """Per view, the pixels `fus` (either package's fusion module) keeps:
    consistent with at least min_num_consistent other views."""
    if fus is j_fus:
        def check(r, s):
            return np.asarray(j_fus.consistency_check(
                jnp.asarray(depths[r]), None, jnp.asarray(K),
                jnp.asarray(Rs[r]), jnp.asarray(ts[r]),
                jnp.asarray(depths[s]), jnp.asarray(K), jnp.asarray(Rs[s]),
                jnp.asarray(ts[s]), jnp.asarray(2.0), jnp.asarray(0.01)))
    else:
        def check(r, s):
            return t_fus.consistency_check(
                T(depths[r]), None, T(K), T(Rs[r]), T(ts[r]), T(depths[s]),
                T(K), T(Rs[s]), T(ts[s]), 2.0, 0.01).numpy()
    n = len(depths)
    return [(sum(check(r, s).astype(int) for s in range(n) if s != r)
             >= min_num_consistent) & (depths[r] > 0) for r in range(n)]


def per_pixel(fused, keep, key):
    """Each view's slice of a fused output (views in order, kept pixels in
    raster order) scattered back onto its (H, W) grid."""
    out, at = [], 0
    for k in keep:
        n = int(k.sum())
        grid = np.zeros((H, W) + fused[key].shape[1:])
        grid[k] = fused[key][at:at + n]
        out.append(grid)
        at += n
    assert at == len(fused[key])
    return out


def hold_fused(got, want, keep_port, keep_ref, depths_equal=None):
    """The fused outputs agree on every pixel both packages keep (and, if
    given, whose depths agree); returns (shared, kept by one side)."""
    shared = n_only = 0
    for key in ("xyz", "normal", "color"):
        for r, (a, b) in enumerate(zip(per_pixel(got, keep_port, key),
                                       per_pixel(want, keep_ref, key))):
            both = keep_port[r] & keep_ref[r]
            if depths_equal is not None:
                both &= depths_equal[r]
            assert rel_err(a[both], b[both]) <= 1e-12
            if key == "xyz":
                shared += int(both.sum())
                n_only += int((keep_port[r] ^ keep_ref[r]).sum())
    return shared, n_only


@pytest.mark.parametrize("corrupt", [False, True])
def test_fuse(scene, corrupt):
    d = _consistency_inputs(scene, corrupt)
    rng = np.random.default_rng(13)
    normals = [rng.normal(size=(H, W, 3)) for _ in range(3)]
    imgs = [np.asarray(i, np.float64) for i in scene.imgs]
    opts = j_fus.FusionOptions(min_num_consistent=1)
    want = j_fus.fuse(d, normals, imgs, [K] * 3, scene.Rs, scene.ts, opts)
    got = t_fus.fuse(d, normals, imgs, [K] * 3, scene.Rs, scene.ts,
                     interop.fusion_options(opts._asdict()), device="cpu")
    keep_r = kept_pixels(j_fus, d, scene.Rs, scene.ts, 1)
    keep_p = kept_pixels(t_fus, d, scene.Rs, scene.ts, 1)
    shared, n_only = hold_fused(got, want, keep_p, keep_r)
    print(f"fuse corrupt={corrupt}: {shared} shared pixels, {n_only} kept "
          f"by one side; "
          f"{len(want['xyz'])} / {len(got['xyz'])} points")
    assert shared > 2 * H * W and n_only <= 2 * (H + W)
    assert sum(int(k.sum()) for k in keep_p) == len(got["xyz"])


def test_fuse_voxel_dedupe(scene):
    """voxel_size > 0 keeps, of fuse's voxel_size = 0 output, the first
    point of each voxel as the reference's np.unique(axis=0) does."""
    d = _consistency_inputs(scene, False)
    imgs = [np.asarray(i, np.float64) for i in scene.imgs]
    full = t_fus.fuse(d, [None] * 3, imgs, [K] * 3, scene.Rs, scene.ts,
                      device="cpu")
    got = t_fus.fuse(d, [None] * 3, imgs, [K] * 3, scene.Rs, scene.ts,
                     t_fus.FusionOptions(voxel_size=0.05), device="cpu")
    idx = np.unique(np.floor(full["xyz"] / 0.05).astype(np.int64), axis=0,
                    return_index=True)[1]
    for k in ("xyz", "normal", "color", "num_consistent"):
        assert np.array_equal(got[k], full[k][idx])
    assert 100 < len(got["xyz"]) < len(full["xyz"])


def test_fuse_without_normals_or_images(scene):
    d = [x.astype(np.float64) for x in scene.depths]
    want = j_fus.fuse(d, [None] * 3, [None] * 3, [K] * 3, scene.Rs,
                      scene.ts)
    got = t_fus.fuse(d, [None] * 3, [None] * 3, [K] * 3, scene.Rs, scene.ts,
                     device="cpu")
    assert rel_err(got["xyz"], want["xyz"]) <= 1e-12
    assert np.array_equal(got["normal"], want["normal"])
    assert np.array_equal(got["color"], want["color"])
    bad = [d[0] * 0, d[1] * 0, d[2] * 0]
    got = t_fus.fuse(bad, [None] * 3, [None] * 3, [K] * 3, scene.Rs,
                     scene.ts, device="cpu")
    assert got["xyz"].shape == (0, 3)


@pytest.mark.parametrize("span", [50, 2 ** 22])
def test_voxel_first_is_np_unique(span):
    rng = np.random.default_rng(span)
    xyz = rng.uniform(-span, span, (5000, 3)) * 0.37
    xyz[1000:1100] = xyz[:100]                    # repeated voxels
    want = np.unique(np.floor(xyz / 0.37).astype(np.int64), axis=0,
                     return_index=True)[1]
    assert np.array_equal(t_fus.voxel_first(xyz, 0.37), want)


def test_fusion_entry_points_need_a_gpu_unless_told_cpu(scene):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    d = [x.astype(np.float64) for x in scene.depths]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_fus.fuse(d, [None] * 3, [None] * 3, [K] * 3, scene.Rs, scene.ts)


# ------------------------------------------------------ mvs/controller.py

def _sparse_model():
    """test_mvs.py's controller scene: 30 sparse points on the plane seen
    by the three cameras (the reference's model, and the port's)."""
    from dagsfm_tpu.ops import rotations as j_rops
    from dagsfm_tpu.scene import cameras as j_cm
    from dagsfm_tpu.scene.reconstruction import ImageRecord, Reconstruction
    Rs, ts = _cameras()
    rec = Reconstruction()
    rec.add_camera(j_cm.make_simple_camera(0, W, H, focal=FOCAL,
                                           model="SIMPLE_PINHOLE"))
    rng = np.random.default_rng(0)
    Pw = np.column_stack([rng.uniform(-2, 2, 30),
                          rng.uniform(-1.5, 1.5, 30), np.full(30, PLANE_Z)])
    for iid, (R, t) in enumerate(zip(Rs, ts)):
        Pc = Pw @ R.T + t
        xy = (Pc[:, :2] / Pc[:, 2:]) * FOCAL + np.array([W / 2, H / 2])
        q = np.asarray(j_rops.rotmat_to_quat(jnp.asarray(R, jnp.float64)))
        rec.add_image(ImageRecord(
            image_id=iid, name=f"im{iid}.png", camera_id=0, qvec=q,
            tvec=np.asarray(t, float), xys=xy,
            point3D_ids=np.full(30, -1, np.int64)))
        rec.register_image(iid)
    for k in range(30):
        rec.add_point3D(Pw[k], [(i, k) for i in range(3) if i != k % 4])
    return rec, interop.reconstruction(rec.cameras, rec.images, rec.points3D)


def test_source_selection_and_depth_range():
    jrec, trec = _sparse_model()
    for i in range(3):
        for m in (1, 2, 4):
            assert t_ctl.select_source_images(trec, i, m) == \
                j_ctl.select_source_images(jrec, i, m)
        for margin in (0.0, 0.25):
            assert t_ctl.depth_range(trec, i, margin) == \
                j_ctl.depth_range(jrec, i, margin)


def test_dense_options_carry_over():
    opts = j_ctl.DenseOptions(
        max_src_images=3, patch_match=j_pm.PatchMatchOptions(num_depths=8),
        fusion=j_fus.FusionOptions(voxel_size=0.1))
    got = interop.dense_options(opts._asdict())
    assert got.patch_match._asdict() == opts.patch_match._asdict()
    assert got.fusion._asdict() == opts.fusion._asdict()
    assert (got.max_src_images, got.depth_margin) == (3, 0.25)


def _float64_reference(monkeypatch):
    """Run the reference's controller at float64 (it casts its images and
    cameras with jnp.float32) and the port's (DENSE_DTYPE), so the
    comparison rounds as the functions above do."""
    monkeypatch.setattr(j_ctl, "jnp", types.SimpleNamespace(
        asarray=jnp.asarray, float32=jnp.float64))
    monkeypatch.setattr(t_ctl, "DENSE_DTYPE", torch.float64)


def test_dense_reconstruct_with_the_reference_draws(scene, monkeypatch,
                                                    tmp_path):
    _float64_reference(monkeypatch)
    fused_inputs = {}
    for name, mod in (("ref", j_fus), ("port", t_fus)):
        def capture(*a, _fuse=mod.fuse, _name=name, **k):
            fused_inputs[_name] = a[0]
            return _fuse(*a, **k)
        monkeypatch.setattr(mod, "fuse", capture)
    jrec, trec = _sparse_model()
    images = {i: np.asarray(scene.imgs[i], np.float64) for i in range(3)}
    opts = j_ctl.DenseOptions(
        patch_match=j_pm.PatchMatchOptions(num_depths=24, num_iterations=2),
        fusion=j_fus.FusionOptions(min_num_consistent=1))
    want = j_ctl.dense_reconstruct(jrec, images, str(tmp_path / "ref"), opts,
                                   seed=4)
    monkeypatch.setattr(t_pm, "_draw_perturbations", reference_chain(4))
    got = t_ctl.dense_reconstruct(trec, images, str(tmp_path / "port"),
                                  interop.dense_options(opts._asdict()),
                                  seed=4, device="cpu")
    Rs, ts = _cameras()
    dref = [np.asarray(x) for x in fused_inputs["ref"]]
    dport = [x.numpy() for x in fused_inputs["port"]]
    same = []
    for i in range(3):
        s = [x for x in range(3) if x != i]
        sc = types.SimpleNamespace(args=(
            None, None, K, np.stack([K, K]),
            np.stack([_rel(i, x, Rs, ts)[0] for x in s]),
            np.stack([_rel(i, x, Rs, ts)[1] for x in s])))
        margin = refine_margin(sc, np.stack([dref[i], dport[i]]), 2, 2)
        assert rel_err(np.where(margin, 0, dport[i]),
                       np.where(margin, 0, dref[i])) <= 1e-9
        same.append((np.abs(dport[i] - dref[i]) <= 1e-12 * dref[i])
                    & ~margin)
        # the maps written: the .bin bytes are the same off the margin
        bins = [j_io.read_map_bin(j_io.depth_map_path(str(tmp_path / side),
                                                      f"im{i}.png"))
                for side in ("ref", "port")]
        assert np.array_equal(bins[0][same[i]], bins[1][same[i]])
        nrm = [j_io.read_map_bin(j_io.normal_map_path(str(tmp_path / side),
                                                      f"im{i}.png"))
               for side in ("ref", "port")]
        nm = ~dilate(~same[i], 1)
        assert np.abs(nrm[0] - nrm[1])[nm].max() <= 1e-6
    keep_r = kept_pixels(j_fus, dref, Rs, ts, 1)
    keep_p = kept_pixels(t_fus, dport, Rs, ts, 1)
    shared, n_only = hold_fused(got, want, keep_p, keep_r, same)
    print(f"dense_reconstruct: {shared} shared fused pixels with equal "
          f"depths, {n_only} kept by one side; {len(want['xyz'])} / "
          f"{len(got['xyz'])} points")
    assert shared > H * W
    assert abs(np.median(got["xyz"][:, 2]) - PLANE_Z) < 0.1
    head = [(tmp_path / side / "fused.ply").read_bytes().split(b"\n")[:3]
            for side in ("ref", "port")]
    assert head[0][:2] == head[1][:2]


def test_dense_reconstruct_float32_on_the_cpu(scene, tmp_path):
    """The default path (float32, the port's own seeded draws): the
    depths are the plane's and the workspace holds every map."""
    jrec, trec = _sparse_model()
    images = {i: scene.imgs[i] for i in range(3)}
    opts = t_ctl.DenseOptions(
        patch_match=t_pm.PatchMatchOptions(num_depths=24, num_iterations=2))
    fused = t_ctl.dense_reconstruct(trec, images, str(tmp_path), opts,
                                    device="cpu")
    again = t_ctl.dense_reconstruct(trec, images, None, opts, device="cpu")
    assert np.array_equal(fused["xyz"], again["xyz"])
    assert len(fused["xyz"]) > 500
    assert abs(np.median(fused["xyz"][:, 2]) - PLANE_Z) < 0.1
    for i in range(3):
        d = t_io.read_map_bin(t_io.depth_map_path(str(tmp_path), f"im{i}.png"))
        assert d.dtype == np.float32 and d.shape == (H, W)
        assert np.median(np.abs(d[8:-8, 8:-8] - scene.depths[i][8:-8, 8:-8])
                         / PLANE_Z) < 0.02
        n = t_io.read_map_bin(t_io.normal_map_path(str(tmp_path),
                                                   f"im{i}.png"))
        assert n.shape == (H, W, 3)
    assert (tmp_path / "fused.ply").exists()


# -------------------------------------------------------- mvs/meshing.py

@pytest.mark.parametrize("n,noise", [(64, 0.02), (600, 0.01), (3, 0.0)])
def test_delaunay_mesh(n, noise):
    rng = np.random.default_rng(n)
    if n == 64:
        g = np.linspace(0, 1, 8)
        xx, yy = np.meshgrid(g, g)
        xyz = np.column_stack([xx.ravel(), yy.ravel(),
                               noise * rng.standard_normal(64)])
    else:
        v = rng.normal(size=(n, 3))
        xyz = v / np.linalg.norm(v, axis=1, keepdims=True) \
            + noise * rng.normal(size=(n, 3))
    jv, jt = j_mesh.delaunay_mesh(xyz)
    opts = interop.meshing_options(j_mesh.MeshingOptions()._asdict())
    tv, tt = t_mesh.delaunay_mesh(xyz, opts)
    assert np.array_equal(tv, jv)
    assert tt.dtype == np.int64 and np.array_equal(tt, jt)
    if n > 3:
        assert len(tt) > 20


def test_boundary_faces_large_index_fallback():
    simplices = np.array([[0, 1, 2, 3], [1, 2, 3, 4]])
    a = t_mesh._boundary_faces(simplices, 5)
    b = t_mesh._boundary_faces(simplices, 3_000_000)
    assert np.array_equal(a, b) and len(a) == 6


@pytest.mark.parametrize("n_tris", [0, 1, 500])
def test_ply_mesh_bytes(tmp_path, n_tris):
    rng = np.random.default_rng(n_tris)
    verts = rng.normal(size=(300, 3))
    tris = rng.integers(0, 300, (n_tris, 3))
    j_mesh.write_ply_mesh(str(tmp_path / "ref.ply"), verts, tris)
    t_mesh.write_ply_mesh(str(tmp_path / "port" / "m.ply"), verts, tris)
    assert (tmp_path / "ref.ply").read_bytes() == \
        (tmp_path / "port" / "m.ply").read_bytes()
