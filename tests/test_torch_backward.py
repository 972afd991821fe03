"""K4 (`qmat`) and K2 (the gram backward): plain twins against the JAX package.

The port's wrappers take their plain twins for CPU tensors. They are held
against the Pallas kernels in interpret mode, as tests/test_pallas_chol.py
and tests/test_pallas_gram.py run them on the CPU (`pallas_chol.qmat`,
`pallas_gram._gram_bwd_vm` / `_gram_bwdm_vm`), and K2's twin also against
autograd of the plain gram. The CUDA kernels are compared with the twins on
the card by chip_smoke.py.

Tolerances:
  * K4, 1e-4 relative to max |out|: the bound the Pallas factorization
    kernels were held to for alpha and L^{-1} (tests/test_pallas_chol.py);
    the two sides invert L with different block widths (32 vs 128) and sum
    the product in another order, in float32;
  * K2, rtol/atol 2e-3 relative to the gradient's scale: the Pallas
    gram VJP's own bound (tests/test_pallas_gram.py:83); float32 phases
    2 pi mu t of up to ~90 rad are rounded in a different order.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one torch
# thread each, as these small tensors gain nothing from more
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from medgp_tpu.ops import pallas_chol, pallas_gram  # noqa: E402
from medgp_tpu_torch.models.params import LMCSMSpec  # noqa: E402
from medgp_tpu_torch.ops import cuda_chol, cuda_gram  # noqa: E402

Q, D, R = 2, 3, 1
QMAT_REL = 1e-4
GRAD_TOL = 2e-3


def _spd(rng, B, n):
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    return (np.einsum("bij,bkj->bik", A, A) / n + np.eye(n, dtype=np.float32)).astype(
        np.float32
    )


@pytest.mark.parametrize("n", [128, 256])
def test_qmat_twin_matches_pallas_kernel_interpret(n):
    rng = np.random.default_rng(61 + n)
    B = 2
    K = _spd(rng, B, n)
    noise = rng.uniform(0.1, 0.5, size=(B, n)).astype(np.float32)
    y = rng.normal(size=(B, n)).astype(np.float32)
    coef = rng.uniform(0.2, 1.0, size=(B, 1)).astype(np.float32)
    L, alpha, linvd = cuda_chol.chol_solve(
        torch.as_tensor(K), torch.as_tensor(noise), torch.as_tensor(y)
    )
    # the Pallas kernel takes its own 128-wide diagonal-block inverses
    _, _, d_p = jax.jit(pallas_chol.chol_solve)(
        jnp.asarray(K), jnp.asarray(noise), jnp.asarray(y)
    )
    want = np.asarray(jax.jit(pallas_chol.qmat)(
        jnp.asarray(L.numpy()), d_p, jnp.asarray(alpha.numpy()), jnp.asarray(coef)
    ))
    got = cuda_chol.qmat(L, linvd, alpha, torch.as_tensor(coef)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=QMAT_REL, atol=QMAT_REL * scale)
    assert np.array_equal(got, np.swapaxes(got, 1, 2))  # full symmetric output

    # alpha = 0, coef = 1: the bare inverse (K + diag(noise))^{-1}
    bare = cuda_chol.qmat(
        L, linvd, torch.zeros_like(alpha), torch.ones(B)
    ).numpy()
    inv = np.linalg.inv(K.astype(np.float64) + np.stack([np.diag(x) for x in noise]))
    np.testing.assert_allclose(
        bare, inv, rtol=QMAT_REL, atol=QMAT_REL * np.abs(inv).max()
    )


def _gram_case(seed, n=128, batch=3, D=D):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 168, size=(batch, n)), axis=1).astype(np.float32)
    meta = rng.integers(0, D, size=(batch, n)).astype(np.int32)
    mask = np.ones((batch, n), np.float32)
    mask[0, 100:] = 0.0
    mask[-1, 70:] = 0.0
    t[mask == 0] = 0.0
    meta[mask == 0] = 0
    A = (rng.normal(size=(batch, Q, D, R)) * 0.4).astype(np.float32)
    kappa = rng.uniform(0.01, 0.05, size=(batch, Q, D)).astype(np.float32)
    B = (np.einsum("bqdr,bqer->bqde", A, A)
         + kappa[..., None] * np.eye(D, dtype=np.float32)).astype(np.float32)
    mu = (1.0 / rng.uniform(12, 72, size=(batch, Q))).astype(np.float32)
    v = (1.0 / (2 * np.pi * rng.uniform(6, 72, size=(batch, Q)))).astype(np.float32)
    dK = rng.normal(size=(batch, n, n)).astype(np.float32)  # not symmetric
    return t, meta, mask, B, mu, v, dK


def _assert_grads_close(got, want):
    for name, g, w in zip(("dB", "dmu", "dv"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(w).max(), err_msg=name
        )


# D = 40 is past the 32 outputs the first CUDA K2 took: the function the
# kernel must now take (chip_smoke.py holds the kernel to the twin at D=48)
@pytest.mark.parametrize(
    "masked,outputs", [(False, D), (True, D), (False, 40), (True, 40)],
    ids=["False", "True", "False-D40", "True-D40"],
)
def test_gram_bwd_twin_matches_pallas_kernel_interpret(masked, outputs):
    t, meta, mask, B, mu, v, dK = _gram_case(71, D=outputs)
    ts = t - t.min(axis=1, keepdims=True)  # the shift of the JAX VJP
    args = [jnp.asarray(x) for x in (dK, ts, meta, B, mu, v)]
    if masked:
        want = pallas_gram._gram_bwdm_vm(*args, jnp.asarray(mask))
    else:
        want = pallas_gram._gram_bwd_vm(*args)
    got = cuda_gram.gram_lmcsm_bwd(
        *(torch.as_tensor(x) for x in (dK, t, meta, B, mu, v)),
        mask=torch.as_tensor(mask) if masked else None,
    )
    _assert_grads_close([x.numpy() for x in got], want)


@pytest.mark.parametrize("masked", [False, True])
def test_gram_bwd_twin_and_function_match_autograd(masked):
    """K2's twin, and the GramLMCSM autograd Function that routes the
    backward through it, against autograd of the plain gram."""
    t, meta, mask, B, mu, v, dK = _gram_case(72)
    tt = [torch.as_tensor(x) for x in (t, meta, B, mu, v, dK, mask)]
    t_, meta_, B_, mu_, v_, dK_, mask_ = tt
    m = mask_ if masked else None
    hyp = [x.clone().requires_grad_() for x in (B_, mu_, v_)]
    K = cuda_gram.gram_lmcsm_plain(t_, meta_, *hyp, mask=m)
    want = torch.autograd.grad(K, hyp, dK_)
    twin = cuda_gram.gram_lmcsm_bwd_plain(dK_, t_, meta_, B_, mu_, v_, m)
    _assert_grads_close([x.numpy() for x in twin], [x.numpy() for x in want])

    hyp = [x.clone().requires_grad_() for x in (B_, mu_, v_)]
    K = cuda_gram.GramLMCSM.apply(t_, meta_, *hyp, m)
    got = torch.autograd.grad(K, hyp, dK_)
    _assert_grads_close([x.numpy() for x in got], [x.numpy() for x in want])


def test_gram_bwd_gives_the_coregional_gradient_like_jax():
    """Through B = A A^T + diag(kappa): the port's dA, dkappa (autograd
    over K2's twin) against jax.grad through the Pallas gram's custom VJP
    in interpret mode (medgp_tpu.ops.pallas_gram.gram_lmcsm_fused)."""
    t, meta, mask, _, mu, v, dK = _gram_case(73, batch=1)
    rng = np.random.default_rng(74)
    A = (rng.normal(size=(Q, D, R)) * 0.4).astype(np.float32)
    kappa = rng.uniform(0.01, 0.05, size=(Q, D)).astype(np.float32)
    from medgp_tpu.models.params import LMCSMSpec as JSpec

    jspec = JSpec(Q, D, R)

    def loss(A, mu, v, kappa):
        K = pallas_gram.gram_lmcsm_fused(
            jspec, jnp.asarray(t[0]), jnp.asarray(meta[0]), A, mu, v, kappa,
            mask=jnp.asarray(mask[0]),
        )
        return jnp.sum(K * jnp.asarray(dK[0]))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(A), jnp.asarray(mu[0]), jnp.asarray(v[0]), jnp.asarray(kappa)
    )
    spec = LMCSMSpec(Q, D, R)
    hyp = [torch.as_tensor(x).requires_grad_() for x in (A, mu[0], v[0], kappa)]
    Bq = spec.coregional_B(hyp[0], hyp[3])[None].contiguous()
    K = cuda_gram.GramLMCSM.apply(
        torch.as_tensor(t), torch.as_tensor(meta), Bq, hyp[1][None], hyp[2][None],
        torch.as_tensor(mask),
    )
    got = torch.autograd.grad(torch.sum(K * torch.as_tensor(dK)), hyp)
    for name, g, w in zip(("A", "mu", "v", "kappa"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(w).max(),
            err_msg=name,
        )


@pytest.mark.parametrize("which", ["qmat", "gram_lmcsm_bwd"])
def test_backward_wrappers_refuse_devices_without_a_kernel(which):
    """Only CPU tensors take a twin; another non-CUDA device raises."""
    dev = "meta"
    if which == "qmat":
        L = torch.zeros(1, 32, 32, device=dev)
        with pytest.raises(ValueError, match="unsupported device"):
            cuda_chol.qmat(L, torch.zeros(1, 1, 32, 32, device=dev),
                           torch.zeros(1, 32, device=dev), torch.ones(1, device=dev))
    else:
        t = torch.zeros(1, 32, device=dev)
        with pytest.raises(ValueError, match="unsupported device"):
            cuda_gram.gram_lmcsm_bwd(
                torch.zeros(1, 32, 32, device=dev), t, t.int(),
                torch.zeros(1, 1, 2, 2, device=dev), torch.zeros(1, 1, device=dev),
                torch.zeros(1, 1, device=dev),
            )
