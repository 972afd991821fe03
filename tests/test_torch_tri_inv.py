"""K5's schedule (`tri_inv`, recursive doubling) checked on the CPU.

The CUDA kernels (csrc/chol.cuh: tri_inv_diag_kernel, tri_inv_level_kernel)
cannot run here. `doubling_inverse` below is a plain-torch mirror of their
schedule, kept in this file and never on the port's path: the diagonal
32x32 inverses `linvd` from K3, then levels w = 32, 64, 128, ... that turn
each pair of inverted w-blocks into a 2w-block by X21 = -X22 (L21 X11), the
second block cut at n. Its float32 error is held against a float64 inverse
and against the twin's (`solve_triangular`), on factors of the main path's
kind of matrix (a synthetic cohort's masked LMC-SM gram plus noise,
factored by K3's twin), and against the Pallas kernel
`medgp_tpu.ops.pallas_chol.tri_inv` in interpret mode (as
tests/test_torch_chol.py runs it); K4's launches (the schedule, then
c (X^T X - alpha alpha^T)) against the Pallas `qmat` likewise.

Tolerances: 1e-4 absolute, LINV_TOL of chip_smoke.py and the Pallas
kernels' bound for L^{-1} (tests/test_pallas_chol.py); and at most 4x the
twin's own error against float64, so that the reordering of the sums costs
no more than a small factor.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one torch
# thread each, as these small tensors gain nothing from more
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from medgp_tpu.ops import pallas_chol  # noqa: E402
from medgp_tpu_torch.data.synthetic import cluster_thetas, sample_cohort  # noqa: E402
from medgp_tpu_torch.models import gp as tgp  # noqa: E402
from medgp_tpu_torch.models.params import LMCSMSpec, theta_from_numpy  # noqa: E402
from medgp_tpu_torch.ops import cuda_chol  # noqa: E402

LINV_TOL = 1e-4
ERR_RATIO = 4.0
SPEC = LMCSMSpec(5, 24, 8)  # the canonical width


def doubling_inverse(L: torch.Tensor, linvd: torch.Tensor) -> torch.Tensor:
    """L^{-1} by K5's schedule: 32-wide diagonal inverses, then pairs of
    inverted w-blocks combined level by level (w = 32, 64, ...)."""
    Bt, n, _ = L.shape
    bs = cuda_chol.BLOCK
    X = torch.zeros_like(L)
    for k in range(n // bs):
        X[:, bs * k:bs * (k + 1), bs * k:bs * (k + 1)] = linvd[:, k]
    w = bs
    while w < n:
        for a in range(0, n - w, 2 * w):
            o2 = a + w
            e2 = min(o2 + w, n)
            T = L[:, o2:e2, a:o2] @ X[:, a:o2, a:o2]
            X[:, o2:e2, a:o2] = -(X[:, o2:e2, o2:e2] @ T)
        w *= 2
    return X


def _cohort_system(n, seed):
    """Two patients of a synthetic cohort padded to n: the masked gram
    (unit diagonal on padding), the per-observation noise and y."""
    recs = sample_cohort(seed, SPEC, 2, n_clusters=1, n_obs_range=(n // 2, n))
    theta = theta_from_numpy(SPEC, cluster_thetas(seed, SPEC, 1)[0], torch.device("cpu"))
    t = np.zeros((2, n), np.float32)
    y = np.zeros((2, n), np.float32)
    meta = np.zeros((2, n), np.int32)
    mask = np.zeros((2, n), np.float32)
    for i, r in enumerate(recs):
        t[i, :r.n_obs], y[i, :r.n_obs] = r.t, r.y
        meta[i, :r.n_obs], mask[i, :r.n_obs] = r.meta, 1.0
    data = tgp.PatientData(*(torch.as_tensor(x) for x in (t, y, meta, mask)))
    K = tgp.noiseless_gram(SPEC, theta, data, masked=True)
    noise = tgp.noise_variance(SPEC, theta, data.meta) * data.mask
    return K, noise, data.y


def _eye64(L):
    n = L.shape[-1]
    return torch.eye(n, dtype=torch.float64).expand(L.shape[0], n, n)


@pytest.mark.parametrize("n", [256, 1024])
def test_doubling_schedule_error_against_float64(n):
    K, noise, y = _cohort_system(n, seed=3)
    L, _, linvd = cuda_chol.chol_solve(K, noise, y)
    assert bool(torch.isfinite(L).all())
    exact = torch.linalg.solve_triangular(L.double(), _eye64(L), upper=False)
    got = doubling_inverse(L, linvd)
    twin = cuda_chol.tri_inv(L, linvd)  # the CPU twin
    err = float((got.double() - exact).abs().max())
    twin_err = float((twin.double() - exact).abs().max())
    assert err <= LINV_TOL, (err, twin_err)
    assert err <= ERR_RATIO * twin_err, (err, twin_err)
    assert bool((torch.triu(got, 1) == 0).all())


def test_doubling_schedule_matches_pallas_kernel_interpret():
    n = 256
    K, noise, y = _cohort_system(n, seed=4)
    L, _, linvd = cuda_chol.chol_solve(K, noise, y)
    # the Pallas kernel's own 128-wide diagonal inverses, from its factor
    _, _, d_p = jax.jit(pallas_chol.chol_solve)(
        jnp.asarray(K.numpy()), jnp.asarray(noise.numpy()), jnp.asarray(y.numpy())
    )
    want = np.asarray(jax.jit(pallas_chol.tri_inv)(jnp.asarray(L.numpy()), d_p))
    got = doubling_inverse(L, linvd).numpy()
    np.testing.assert_allclose(got, want, rtol=LINV_TOL, atol=LINV_TOL)


def test_qmat_on_doubling_schedule_matches_pallas_kernel_interpret():
    """K4's launches: X = L^{-1} by the doubling schedule into the
    workspace, then c (X^T X - alpha alpha^T), against the Pallas `qmat`
    (interpret mode), within K4_REL = 1e-4 of max |out| (chip_smoke.py)."""
    n = 256
    K, noise, y = _cohort_system(n, seed=5)
    L, alpha, linvd = cuda_chol.chol_solve(K, noise, y)
    coef = torch.tensor([0.3, 0.8])
    X = doubling_inverse(L, linvd)
    got = (coef[:, None, None] * (X.mT @ X - alpha[:, :, None] * alpha[:, None, :])).numpy()
    _, _, d_p = jax.jit(pallas_chol.chol_solve)(
        jnp.asarray(K.numpy()), jnp.asarray(noise.numpy()), jnp.asarray(y.numpy())
    )
    want = np.asarray(jax.jit(pallas_chol.qmat)(
        jnp.asarray(L.numpy()), d_p, jnp.asarray(alpha.numpy()),
        jnp.asarray(coef.numpy()[:, None]),
    ))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=LINV_TOL, atol=LINV_TOL * scale)


@pytest.mark.parametrize("n", [32, 96, 160, 384])
def test_doubling_schedule_ragged_n(n):
    """n a multiple of 32 but not of a power of two times 32: the last
    block of a level is cut at n, as in the kernels' launch plan."""
    rng = np.random.default_rng(n)
    A = rng.normal(size=(2, n, n))
    M = A @ A.transpose(0, 2, 1) / n + 0.5 * np.eye(n)
    L = torch.as_tensor(np.linalg.cholesky(M).astype(np.float32))
    linvd = cuda_chol.block_inverses(L)
    exact = torch.linalg.solve_triangular(L.double(), _eye64(L), upper=False)
    got = doubling_inverse(L, linvd)
    assert float((got.double() - exact).abs().max()) <= LINV_TOL
    # identity members (the retry driver's stand-in) stay the identity
    eye = torch.eye(n).expand(1, n, n).contiguous()
    ident = doubling_inverse(eye, cuda_chol.block_inverses(eye))
    assert torch.equal(ident, eye)
