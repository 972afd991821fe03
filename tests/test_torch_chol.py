"""K3 (`chol_solve`) and K5 (`tri_inv`) twins against the JAX package.

The port's wrappers take their plain twins for CPU tensors; they are held
against XLA's factorization (jnp.linalg.cholesky / cho_solve /
solve_triangular) and against the Pallas kernels in interpret mode (as
tests/test_pallas_chol.py runs them), including a non-SPD matrix (NaN on
the diagonal) and the jitter-retry loop. The CUDA kernels are compared
with the twins on the card by chip_smoke.py.

Tolerances are the ones the Pallas kernels were held to
(tests/test_pallas_chol.py): L 1e-5, alpha and L^{-1} 1e-4 (rtol and atol),
float32 on both sides with sums taken in another order.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.scipy.linalg import cho_solve, solve_triangular  # noqa: E402

from medgp_tpu.ops import nlml as jnlml  # noqa: E402
from medgp_tpu.ops import pallas_chol  # noqa: E402
from medgp_tpu_torch.ops import cuda_chol  # noqa: E402
from medgp_tpu_torch.ops.nlml import jittered_chol_solve  # noqa: E402

N = 128


def _spd(rng, B, n=N):
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    return np.einsum("bij,bkj->bik", A, A) + 10 * np.eye(n, dtype=np.float32)


def _port_chol(K, noise, y):
    return [
        x.numpy()
        for x in cuda_chol.chol_solve(
            torch.as_tensor(K), torch.as_tensor(noise), torch.as_tensor(y)
        )
    ]


def test_chol_solve_twin_matches_xla():
    rng = np.random.default_rng(21)
    K = _spd(rng, 3)
    noise = rng.uniform(0.1, 0.5, size=(3, N)).astype(np.float32)
    y = rng.normal(size=(3, N)).astype(np.float32)
    L, alpha, linvd = _port_chol(K, noise, y)
    M = jnp.asarray(K) + jax.vmap(jnp.diag)(jnp.asarray(noise))
    L_x = jnp.linalg.cholesky(M)
    a_x = jax.vmap(lambda l, b: cho_solve((l, True), b))(L_x, jnp.asarray(y))
    np.testing.assert_allclose(L, np.asarray(L_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(alpha, np.asarray(a_x), rtol=1e-4, atol=1e-4)
    assert np.all(np.triu(L, 1) == 0.0)
    # linvd: inverses of L's 32x32 diagonal blocks
    for k in range(N // cuda_chol.BLOCK):
        s = slice(32 * k, 32 * (k + 1))
        np.testing.assert_allclose(
            linvd[:, k], np.linalg.inv(L[:, s, s]), rtol=1e-4, atol=1e-4
        )


def test_chol_solve_twin_matches_pallas_kernel_interpret():
    rng = np.random.default_rng(22)
    K = _spd(rng, 2)
    noise = rng.uniform(0.1, 0.5, size=(2, N)).astype(np.float32)
    y = rng.normal(size=(2, N)).astype(np.float32)
    L_p, a_p, d_p = jax.jit(pallas_chol.chol_solve)(
        jnp.asarray(K), jnp.asarray(noise), jnp.asarray(y)
    )
    L, alpha, linvd = _port_chol(K, noise, y)
    np.testing.assert_allclose(L, np.asarray(L_p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(alpha, np.asarray(a_p), rtol=1e-4, atol=1e-4)
    # the Pallas kernel keeps 128-wide block inverses; the inverse of a
    # lower-triangular block matrix has the inverses of its diagonal
    # sub-blocks on its diagonal, so the port's 32-wide blocks sit there
    d_p = np.asarray(d_p)
    for k in range(N // 32):
        s = slice(32 * (k % 4), 32 * (k % 4 + 1))
        np.testing.assert_allclose(
            linvd[:, k], d_p[:, k // 4, s, s], rtol=1e-4, atol=1e-4
        )


@pytest.mark.parametrize("against", ["xla", "pallas"])
def test_tri_inv_twin_matches_jax(against):
    rng = np.random.default_rng(23)
    K = _spd(rng, 2)
    zeros = np.zeros((2, N), np.float32)
    L, _, linvd = _port_chol(K, zeros, zeros)
    if against == "xla":
        eye = jnp.eye(N, dtype=jnp.float32)
        want = jax.vmap(lambda l: solve_triangular(l, eye, lower=True))(
            jnp.asarray(L)
        )
    else:
        _, _, d_p = jax.jit(pallas_chol.chol_solve)(
            jnp.asarray(K), jnp.asarray(zeros), jnp.asarray(zeros)
        )
        want = jax.jit(pallas_chol.tri_inv)(jnp.asarray(L), d_p)
    got = cuda_chol.tri_inv(torch.as_tensor(L), torch.as_tensor(linvd))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4
    )


def test_non_spd_gives_nan_diagonal_like_pallas():
    """A non-SPD member yields NaN on L's diagonal (what chol_ok and the
    retry loop detect) in the port's twin as in the Pallas kernel, without
    touching the other members (tests/test_pallas_chol.py:99)."""
    rng = np.random.default_rng(24)
    K = _spd(rng, 3)
    K[1] = -np.eye(N, dtype=np.float32)
    zeros = np.zeros((3, N), np.float32)
    y = rng.normal(size=(3, N)).astype(np.float32)
    L, alpha, _ = _port_chol(K, zeros, y)
    L_p, _, _ = jax.jit(pallas_chol.chol_solve)(
        jnp.asarray(K), jnp.asarray(zeros), jnp.asarray(y)
    )
    for Lx in (L, np.asarray(L_p)):
        d = np.diagonal(Lx, axis1=1, axis2=2)
        assert np.isnan(d[1]).any()
        assert np.isfinite(d[0]).all() and np.isfinite(d[2]).all()
    np.testing.assert_allclose(
        L[[0, 2]], np.asarray(L_p)[[0, 2]], rtol=1e-5, atol=1e-5
    )


def _retry_case(rng):
    """Member 0 succeeds at mult 1; member 1 (A A^T / n - 2.5 I, noise 1)
    fails at mult 1 and 2 and succeeds at 3; member 2 (-I, noise 1e-3)
    never succeeds."""
    K = _spd(rng, 3) / 10.0
    A = rng.normal(size=(N, N)).astype(np.float32)
    K[1] = A @ A.T / N - 2.5 * np.eye(N, dtype=np.float32)
    K[2] = -np.eye(N, dtype=np.float32)
    noise = np.full((3, N), 0.1, np.float32)
    noise[1] = 1.0
    noise[2] = 1e-3
    y = rng.normal(size=(3, N)).astype(np.float32)
    return K.astype(np.float32), y, noise


def test_jitter_retry_matches_xla_path():
    """Per-member escalation mult = 1..1+max_retries, with the first
    successful factorization kept and L = I, alpha = 0 on final failure,
    as medgp_tpu.ops.nlml._jittered_chol_cv + cho_solve (the XLA path)."""
    rng = np.random.default_rng(25)
    K, y, noise = _retry_case(rng)
    L_x, ok_x, mult_x = jax.vmap(
        lambda k, nz: jnlml._jittered_chol_cv(k, nz, 10)
    )(jnp.asarray(K), jnp.asarray(noise))
    a_x = jax.vmap(lambda l, b: cho_solve((l, True), b))(L_x, jnp.asarray(y))
    L, alpha, linvd, ok, mult = jittered_chol_solve(
        torch.as_tensor(K), torch.as_tensor(y), torch.as_tensor(noise), 10
    )
    assert mult.tolist() == np.asarray(mult_x).tolist() == [1, 3, 11]
    assert ok.tolist() == np.asarray(ok_x).tolist() == [True, True, False]
    np.testing.assert_allclose(L.numpy(), np.asarray(L_x), rtol=1e-5, atol=1e-5)
    # alpha of the failed member is 0 as on the Pallas path (the XLA path
    # solves with L = I there); the LOO fallback discards it either way
    np.testing.assert_allclose(
        alpha[:2].numpy(), np.asarray(a_x)[:2], rtol=1e-4, atol=1e-4
    )
    assert np.array_equal(L[2].numpy(), np.eye(N, dtype=np.float32))
    assert np.all(alpha[2].numpy() == 0.0)


def test_jitter_retry_matches_pallas_path():
    """The same escalation through the Pallas fast path
    (medgp_tpu.ops.nlml._jittered_chol_solve, interpret mode;
    tests/test_pallas_chol.py:140), on the members that recover."""
    rng = np.random.default_rng(26)
    K, y, noise = _retry_case(rng)
    K, y, noise = K[:2], y[:2], noise[:2]
    drive = jax.jit(jax.vmap(
        functools.partial(jnlml._jittered_chol_solve, max_retries=10)
    ))
    L_p, a_p, _, ok_p, mult_p = drive(
        jnp.asarray(K), jnp.asarray(y), jnp.asarray(noise)
    )
    L, alpha, _, ok, mult = jittered_chol_solve(
        torch.as_tensor(K), torch.as_tensor(y), torch.as_tensor(noise), 10
    )
    assert mult.tolist() == np.asarray(mult_p).tolist() == [1, 3]
    assert ok.tolist() == np.asarray(ok_p).tolist() == [True, True]
    np.testing.assert_allclose(L.numpy(), np.asarray(L_p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        alpha.numpy(), np.asarray(a_p), rtol=1e-4, atol=1e-4
    )


def test_block_size_is_checked_on_every_device():
    K = torch.eye(48)[None]
    with pytest.raises(ValueError, match="multiple of 32"):
        cuda_chol.chol_solve(K, torch.zeros(1, 48), torch.zeros(1, 48))
