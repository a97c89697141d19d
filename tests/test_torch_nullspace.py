"""The nullspace of the exact minimal systems (ops/nullspace_kernel.py)
against LAPACK's complete QR and the JAX package's `_nullspace_k`.

The plain version repeats the kernel's Householder steps (dgeqr2 +
dorg2r), so on well-conditioned systems its columns equal the library's
to rounding, not only their span. A zero row gives a reflector with
tau = 0, which both take as the identity, so the columns still match. A
repeated row leaves a residual of rounding noise that decides the next
reflector, so there the columns are held only to being finite,
orthonormal and in the nullspace. The CUDA kernel is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.ops import epipolar as j_epi
from dagsfm_tpu_torch.ops import epipolar as t_epi
from dagsfm_tpu_torch.ops import nullspace_kernel as nk
from dagsfm_tpu_torch.ops import two_view_classify as t_tvc
from dagsfm_tpu_torch.utils import observability as obs

torch.set_num_threads(1)


def systems(r: int, case: str, S: int = 256, seed: int = 0) -> np.ndarray:
    """(S, r, 9) systems: random rows, one repeated row or one zero row."""
    rng = np.random.default_rng([seed, r])
    A = rng.normal(size=(S, r, 9))
    if case == "repeated":
        A[:, r - 1] = A[:, 0]
    elif case == "zero":
        A[:, r // 2] = 0.0
    return A


@pytest.mark.parametrize("case", ["well", "repeated", "zero"])
@pytest.mark.parametrize("r", [5, 7, 8])
def test_plain_version_equals_the_librarys_columns(r, case):
    A = systems(r, case)
    N = nk.minimal_nullspace(torch.as_tensor(A))
    assert N.shape == (len(A), 9, 9 - r) and N.dtype == torch.float64
    N = N.numpy()
    assert np.isfinite(N).all()
    eye = np.eye(9 - r)
    assert np.abs(np.swapaxes(N, -1, -2) @ N - eye).max() <= 1e-13
    norm_A = np.linalg.norm(A, axis=(-2, -1))[:, None, None]
    assert (np.abs(A @ N) <= 1e-12 * norm_A).all()
    if case == "repeated":
        return
    Q = torch.linalg.qr(torch.as_tensor(A).mT, mode="complete")[0].numpy()
    np.testing.assert_allclose(N, Q[..., r:], rtol=0, atol=1e-12)
    ref = np.asarray(j_epi._nullspace_k(jnp.asarray(A), 9 - r))
    np.testing.assert_allclose(N, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("r", [5, 7, 8])
def test_nullspace_k_takes_the_plain_version_on_the_cpu(r):
    """The exact-minimal branch of `_nullspace_k` on (pairs, hypotheses)
    batches: the plain version's columns, the batch dims kept, no launch
    counted, and float32 within rounding of float64."""
    A = torch.as_tensor(systems(r, "well", S=24)).reshape(4, 6, r, 9)
    before = nk.launches
    N = t_epi._nullspace_k(A, 9 - r)
    assert nk.launches == before and N.shape == (4, 6, 9, 9 - r)
    assert torch.equal(N.reshape(24, 9, 9 - r),
                       nk.minimal_nullspace_reference(A.reshape(24, r, 9)))
    N32 = t_epi._nullspace_k(A.float(), 9 - r)
    assert N32.dtype == torch.float32
    assert float((N32.double() - N).abs().max()) <= 1e-4


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        nk.minimal_nullspace(torch.zeros((4, 5, 9), device="meta"))


def test_classify_pairs_counts_nullspace_systems():
    """Under a root, full E/F/H verification counts every minimal system
    it solves: pairs x hypotheses x 3 estimators."""
    rng = np.random.default_rng(5)
    K = np.array([[800.0, 0, 512], [0, 800.0, 384], [0, 0, 1]])
    rows = []
    for k in range(3):
        X = rng.uniform(-2, 2, (40, 3)) + [0, 0, 8]
        x2 = X + [1.0, 0.1, 0.0]
        p1 = X[:, :2] / X[:, 2:] * 800 + [512, 384]
        p2 = x2[:, :2] / x2[:, 2:] * 800 + [512, 384]
        rows.append(((k, k + 1), p1, p2, K, K, (1024, 768), (1024, 768),
                     True))
    opts = t_tvc.TwoViewOptions(num_hypotheses=16)
    with obs.span("verify.job"):
        t_tvc.classify_pairs(rows, opts, seed=0, device="cpu")
    assert obs.roots()[-1]["counters"]["nullspace_systems"] == 3 * 16 * 3
