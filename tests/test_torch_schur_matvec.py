"""Bundle adjustment's Schur product S·x (ops/schur_matvec.py) on the
CPU: the plain version is the PCG's product of before bit for bit, in
the iterative step's pose-only and joint forms, and so is the
back-substitution's point sum; it
equals S = U - W V⁻¹ Wᵀ formed densely, pinned images and held slots
passed through; the kernel's index arrays walk every observation once
and, summed as the kernel's passes sum them, give the same product; a
solve counts one `schur_mv` per product; and the wrapper refuses a
device it does not take. The kernel itself runs only on the card, where
tests/test_torch_cuda.py and chip_smoke.py hold it against the plain
version."""
import numpy as np
import pytest
import torch

from chip_smoke import schur_case
from dagsfm_tpu_torch.ops import schur_matvec as sx
from dagsfm_tpu_torch.ops.segment_sum import (SEGMENT_CHUNK, mtv, mv,
                                              segment_sum)
from dagsfm_tpu_torch.scene import cameras as t_cm
from dagsfm_tpu_torch.scene import synthetic as t_syn
from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
from dagsfm_tpu_torch.utils import observability as obs

torch.set_num_threads(1)
CPU = torch.device("cpu")


def product_of_before(S, x):
    """The PCG's S·x as the iterative step's pose-only and joint forms
    wrote it before the kernel."""
    prob, free, gfree = S.prob, S.free, S.gfree
    oi, op, oc = prob.obs_image, prob.obs_point, prob.obs_cam
    if S.Wg is None:
        xm = x[0] * free
        y = mv(S.Vinv, segment_sum(mtv(S.Wc, xm[oi]), prob.by_point))
        z = segment_sum(mv(S.Wc, y[op]), prob.by_image)
        return ((mv(S.U_pp, xm) - z) * free + x[0] * (1.0 - free),)

    def fold(z_img):
        return segment_sum(z_img, prob.img_by_cam)

    xp, xg = x
    xpm, xgm = xp * free, xg * gfree
    tmp = segment_sum(mtv(S.Wc, xpm[oi]) + mtv(S.Wg, xgm[oc]),
                      prob.by_point)
    yo = mv(S.Vinv, tmp)[op]
    zc = segment_sum(mv(S.Wc, yo), prob.by_image)
    zg = segment_sum(mv(S.Wg, yo), prob.by_image)
    Sxp = mv(S.U_pp, xpm) + mv(S.U_pg, xgm[prob.image_camidx]) - zc
    Sxg = mv(S.U_gg, xgm) + fold(mtv(S.U_pg, xpm)) - fold(zg)
    return (Sxp * free + xp * (1.0 - free), Sxg * gfree + xg * (1.0 - gfree))


def back_substitution_of_before(S, x):
    prob = S.prob
    t = mtv(S.Wc, x[0][prob.obs_image])
    if S.Wg is not None:
        t = t + mtv(S.Wg, x[1][prob.obs_cam])
    return segment_sum(t, prob.by_point)


@pytest.mark.parametrize("joint", [False, True])
def test_plain_version_is_the_product_of_before(joint):
    S, x = schur_case(CPU, 40, 400, joint, long_image=300)
    got = sx.schur_mv(S, x)
    assert len(got) == len(x)
    for a, b in zip(got, product_of_before(S, x)):
        assert torch.equal(a, b)
    masked = (x[0] * S.free,) + ((x[1] * S.gfree,) if joint else ())
    assert torch.equal(sx.point_sums(S, *masked),
                       back_substitution_of_before(S, masked))


@pytest.mark.parametrize("joint", [False, True])
def test_the_solvers_pcg_takes_the_helper(monkeypatch, joint):
    """The S·x that each form of the iterative step hands its PCG is the
    helper's, bit for bit the product of before, on a real problem."""
    seen = []

    def keep(S_mv, *a):
        seen.append(S_mv)
        return pcg(S_mv, *a)

    def keep_system(*a):
        seen.append(system(*a))
        return seen[-1]

    pcg, system = ba._pcg, sx.system
    monkeypatch.setattr(ba, "_pcg", keep)
    monkeypatch.setattr(sx, "system", keep_system)
    ba.solve(_problem(), _options(joint, max_iterations=1))
    S, S_mv = seen
    rng = np.random.default_rng(3)
    x = tuple(torch.as_tensor(rng.normal(size=t.shape))
              for t in ((S.U_pp[:, 0],) + ((S.gfree,) if joint else ())))
    for a, b in zip(S_mv(*x), product_of_before(S, x)):
        assert torch.equal(a, b)


def dense_product(S, x):
    """S·x with S = U - W V⁻¹ Wᵀ formed as one matrix over the poses and
    the cameras' slots, pinned rows and columns replaced by the
    identity's."""
    prob = S.prob
    I, P = S.U_pp.shape[0], S.Vinv.shape[0]
    C, G = (0, 0) if S.Wg is None else tuple(S.gfree.shape)
    n = 6 * I + G * C
    N = S.Wc.shape[0]
    rows = torch.arange(N)
    W = torch.zeros((N, n, 3), dtype=torch.float64)
    oi, oc = prob.obs_image, prob.obs_cam
    for k in range(6):
        W[rows, 6 * oi + k] = S.Wc[:, k]
    U = torch.zeros((n, n), dtype=torch.float64)
    for i in range(I):
        U[6 * i:6 * i + 6, 6 * i:6 * i + 6] = S.U_pp[i]
    fv = S.free.repeat_interleave(6, 0)[:, 0]
    if G:
        for k in range(G):
            W[rows, 6 * I + G * oc + k] = S.Wg[:, k]
        for i in range(I):
            c = 6 * I + G * int(prob.image_camidx[i])
            U[6 * i:6 * i + 6, c:c + G] = S.U_pg[i]
            U[c:c + G, 6 * i:6 * i + 6] = S.U_pg[i].T
        for c in range(C):
            U[6 * I + G * c:6 * I + G * c + G,
              6 * I + G * c:6 * I + G * c + G] = S.U_gg[c]
        fv = torch.cat([fv, S.gfree.reshape(-1)])
    B = torch.zeros((P, n, 3), dtype=torch.float64).index_add_(
        0, prob.obs_point, W)
    Sd = U - torch.einsum("pia,pab,pjb->ij", B, S.Vinv, B)
    v = torch.cat([t.reshape(-1) for t in x])
    out = fv * (Sd @ (fv * v)) + (1.0 - fv) * v
    return out[:6 * I].reshape(I, 6), out[6 * I:].reshape(C, G)


@pytest.mark.parametrize("joint,cameras", [(False, 3), (True, 1),
                                           (True, 5)])
def test_plain_version_equals_the_dense_schur_complement(joint, cameras):
    S, x = schur_case(CPU, 40, 400, joint, num_cameras=cameras,
                      long_image=300)
    got = sx.schur_mv(S, x)
    want = dense_product(S, x)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * float(b.abs().max()))


@pytest.mark.parametrize("joint", [False, True])
def test_kernel_index_sums_to_the_product(joint):
    """The index arrays the kernel walks, summed pass by pass as the
    kernel sums them (the point pass over each point's rows, the image
    pass in chunks of at most SEGMENT_CHUNK rows, then the chunks of
    each image, the camera pass over each camera's images), give the
    plain version's product; every observation is walked once in each
    pass."""
    S, x = schur_case(CPU, 40, 400, joint, num_cameras=5, long_image=300)
    ix = sx._kernel_index(S.prob)
    prob = S.prob
    N, P = S.Wc.shape[0], S.Vinv.shape[0]
    I = S.U_pp.shape[0]
    n = (lambda t: t.numpy())
    rows, off = n(ix.point_rows), n(ix.point_off)
    assert sorted(rows[:, 0]) == list(range(N)) and off[-1] == N
    pt = np.repeat(np.arange(P), np.diff(off))
    assert (n(prob.obs_point)[rows[:, 0]] == pt).all()
    assert (rows[:, 1] == n(prob.obs_image)[rows[:, 0]]).all()
    assert (rows[:, 2] == n(prob.obs_cam)[rows[:, 0]]).all()
    xp = n(x[0] * S.free)
    t = np.zeros((P, 3))
    np.add.at(t, pt, np.einsum("nab,na->nb", n(S.Wc)[rows[:, 0]],
                               xp[rows[:, 1]]))
    if joint:
        xg = n(x[1] * S.gfree)
        np.add.at(t, pt, np.einsum("nab,na->nb", n(S.Wg)[rows[:, 0]],
                                   xg[rows[:, 2]]))
    y = np.einsum("pab,pb->pa", n(S.Vinv), t)
    irows, roff, coff = n(ix.image_rows), n(ix.chunk_off), n(ix.image_chunks)
    assert sorted(irows[:, 0]) == list(range(N)) and roff[-1] == N
    assert np.diff(roff).max() <= SEGMENT_CHUNK and coff[-1] == len(roff) - 1
    K = len(roff) - 1
    chunk = np.repeat(np.arange(K), np.diff(roff))
    img = np.repeat(np.arange(I), np.diff(coff))
    assert (n(prob.obs_image)[irows[:, 0]] == img[chunk]).all()
    assert (n(prob.obs_point)[irows[:, 0]] == irows[:, 1]).all()
    part = np.zeros((K, 6 + (8 if joint else 0)))
    yo = y[irows[:, 1]]
    np.add.at(part[:, :6], chunk, np.einsum("nab,nb->na",
                                            n(S.Wc)[irows[:, 0]], yo))
    if joint:
        np.add.at(part[:, 6:], chunk, np.einsum("nab,nb->na",
                                                n(S.Wg)[irows[:, 0]], yo))
    z = np.zeros((I, part.shape[1]))
    np.add.at(z, img, part)
    fr = n(S.free)
    Sxp = np.einsum("iab,ib->ia", n(S.U_pp), xp) - z[:, :6]
    want = sx.schur_mv_reference(S, x)
    if joint:
        cam = n(ix.camidx)
        Sxp += np.einsum("iab,ib->ia", n(S.U_pg), xg[cam])
        co, cim = n(ix.cam_off), n(ix.cam_images)
        assert sorted(cim) == list(range(I))
        owner = np.repeat(np.arange(len(co) - 1), np.diff(co))
        assert (cam[cim] == owner).all()
        a = np.zeros_like(xg)
        np.add.at(a, owner, np.einsum("iab,ia->ib", n(S.U_pg)[cim], xp[cim])
                  - z[cim, 6:])
        gf = n(S.gfree)
        Sxg = np.einsum("cab,cb->ca", n(S.U_gg), xg) + a
        Sxg = Sxg * gf + n(x[1]) * (1.0 - gf)
        np.testing.assert_allclose(Sxg, n(want[1]), rtol=0,
                                   atol=1e-12 * np.abs(n(want[1])).max())
    Sxp = Sxp * fr + n(x[0]) * (1.0 - fr)
    np.testing.assert_allclose(Sxp, n(want[0]), rtol=0,
                               atol=1e-12 * np.abs(n(want[0])).max())


def _problem():
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(
        num_cameras=8, num_points=120, pixel_noise=0.3, seed=5,
        camera_model="SIMPLE_RADIAL"))
    arrays = t_syn.to_scene_arrays(sc, CPU)
    arrays = arrays._replace(points_xyz=arrays.points_xyz + 0.01 *
                             torch.as_tensor(np.random.default_rng(5).normal(
                                 size=arrays.points_xyz.shape)))
    const = np.zeros(8, bool)
    const[:2] = True
    return ba.make_problem(arrays, const_image=const,
                           cam_refine=t_cm.intrinsics_refine_mask(
                               [t_cm.SIMPLE_RADIAL], True, False, True))


def _options(joint, solver="iterative", max_iterations=4):
    return ba.BAOptions(max_iterations=max_iterations, refine_focal=joint,
                        refine_extra=joint, solver=solver)


@pytest.mark.parametrize("solver,joint", [("iterative", False),
                                          ("iterative", True),
                                          ("dense", True)])
def test_a_solve_counts_every_schur_product(solver, joint):
    """`ba.solve`'s root counts one `schur_mv` per CG iteration and one
    per LM step (each step's CG starts warm, from the last step's poses);
    the dense solver takes none."""
    obs.enable(True)
    obs.clear()
    _, st = ba.solve(_problem(), _options(joint, solver))
    counters = obs.roots()[-1]["counters"]
    obs.clear()
    if solver == "dense":
        assert "schur_mv" not in counters and st.cg_iterations == 0
    else:
        assert counters["schur_mv"] == st.cg_iterations + st.num_iterations


def test_wrapper_refuses_a_device_it_does_not_take():
    S, x = schur_case(CPU, 12, 60, True, long_image=0)
    meta = torch.empty(tuple(S.Wc.shape), dtype=torch.float64,
                       device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sx.system(S.prob, meta, S.Wg, S.Vinv, S.U_pp, S.U_pg, S.U_gg,
                  S.free, S.gfree)
