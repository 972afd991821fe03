"""K1's plain twin (medgp_tpu_torch.ops.cuda_gram) against the JAX package.

The same numpy inputs (seeded) go through the JAX gram
(`medgp_tpu.ops.gram.gram_lmcsm` + `mask_gram`), the Pallas gram kernel in
interpret mode (`pallas_gram._gram_fwd_batched`, as tests/test_pallas_gram.py
runs it on the CPU) and the port's `gram_lmcsm_fused`, which takes its plain
twin for CPU tensors. The CUDA kernel itself is compared with the twin on
the card by chip_smoke.py.

Tolerance rtol 1e-4, atol 1e-5: the Pallas kernel's own bound against the
XLA gram (tests/test_pallas_gram.py); both sides are float32 with the
phase 2 pi mu |t_i - t_j| rounded in a different order.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from medgp_tpu.models import gp as jgp  # noqa: E402
from medgp_tpu.models import params as jparams  # noqa: E402
from medgp_tpu.ops import pallas_gram  # noqa: E402
from medgp_tpu.ops.gram import gram_lmcsm as jax_gram_lmcsm  # noqa: E402
from medgp_tpu.ops.nlml import mask_gram as jax_mask_gram  # noqa: E402
from medgp_tpu_torch.models import gp as tgp  # noqa: E402
from medgp_tpu_torch.models import params as tparams  # noqa: E402
from medgp_tpu_torch.ops.cuda_gram import gram_lmcsm_fused  # noqa: E402

Q, D, R, N, BATCH = 2, 3, 1, 128, 3


def _inputs(seed):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 168, size=(BATCH, N)), axis=1).astype(np.float32)
    meta = rng.integers(0, D, size=(BATCH, N)).astype(np.int32)
    mask = np.ones((BATCH, N), np.float32)
    mask[0, 100:] = 0.0
    mask[2, 60:] = 0.0
    t[mask == 0] = 0.0
    meta[mask == 0] = 0
    A = (rng.normal(size=(Q, D, R)) * 0.4).astype(np.float32)
    mu = (1.0 / rng.uniform(12, 72, size=Q)).astype(np.float32)
    v = (1.0 / (2 * np.pi * rng.uniform(6, 72, size=Q))).astype(np.float32)
    kappa = rng.uniform(0.01, 0.05, size=(Q, D)).astype(np.float32)
    return t, meta, mask, A, mu, v, kappa


def _port_gram(t, meta, mask, A, mu, v, kappa, masked):
    spec = tparams.LMCSMSpec(Q, D, R)
    B = spec.coregional_B(torch.as_tensor(A), torch.as_tensor(kappa))
    return gram_lmcsm_fused(
        torch.as_tensor(t), torch.as_tensor(meta),
        B.expand(BATCH, -1, -1, -1).contiguous(),
        torch.as_tensor(mu).expand(BATCH, -1).contiguous(),
        torch.as_tensor(v).expand(BATCH, -1).contiguous(),
        mask=torch.as_tensor(mask) if masked else None,
    ).numpy()


@pytest.mark.parametrize("masked", [False, True])
def test_gram_twin_matches_xla_gram(masked):
    t, meta, mask, A, mu, v, kappa = _inputs(11)
    spec = jparams.LMCSMSpec(Q, D, R)

    hyp = [jnp.asarray(x) for x in (A, mu, v, kappa)]

    def one(tb, mb, kb):
        K = jax_gram_lmcsm(spec, tb, mb, *hyp)
        return jax_mask_gram(K, kb) if masked else K

    want = np.asarray(jax.vmap(one)(t, meta, mask))
    got = _port_gram(t, meta, mask, A, mu, v, kappa, masked)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_gram_twin_matches_pallas_kernel_interpret(masked):
    t, meta, mask, A, mu, v, kappa = _inputs(12)
    spec = jparams.LMCSMSpec(Q, D, R)
    B = np.asarray(spec.coregional_B(jnp.asarray(A), jnp.asarray(kappa)))
    want = np.asarray(
        pallas_gram._gram_fwd_batched(
            jnp.asarray(t), jnp.asarray(meta),
            jnp.asarray(np.broadcast_to(B, (BATCH, Q, D, D))),
            jnp.asarray(np.broadcast_to(mu, (BATCH, Q))),
            jnp.asarray(np.broadcast_to(v, (BATCH, Q))),
            jnp.asarray(mask) if masked else None,
        )
    )
    got = _port_gram(t, meta, mask, A, mu, v, kappa, masked)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["LMC-SM", "SE", "SM"])
def test_noiseless_gram_and_noise_match_jax(kind):
    rng = np.random.default_rng(13)
    jspec, tspec = {
        "LMC-SM": (jparams.LMCSMSpec(Q, D, R), tparams.LMCSMSpec(Q, D, R)),
        "SE": (jparams.SESpec(), tparams.SESpec()),
        "SM": (jparams.SMSpec(2), tparams.SMSpec(2)),
    }[kind]
    theta = rng.normal(size=jspec.n_hyp) * 0.3
    theta[: jspec.n_lik] = np.log(rng.uniform(0.2, 0.4, size=jspec.n_lik))
    if kind != "LMC-SM":  # SE / SM: lengthscales and periods in hours
        theta[jspec.n_lik:] += 1.0
    t, meta, mask, *_ = _inputs(14)
    if kind != "LMC-SM":
        meta = np.zeros_like(meta)
    for masked in (False, True):
        want = np.stack([
            np.asarray(jgp.noiseless_gram(
                jspec, jnp.asarray(theta, jnp.float32),
                jgp.PatientData(t=jnp.asarray(t[b]), y=jnp.zeros(N),
                                meta=jnp.asarray(meta[b]),
                                mask=jnp.asarray(mask[b])),
                masked=masked,
            ))
            for b in range(BATCH)
        ])
        data = tgp.PatientData(
            t=torch.as_tensor(t), y=torch.zeros(BATCH, N),
            meta=torch.as_tensor(meta), mask=torch.as_tensor(mask),
        )
        theta_t = tparams.theta_from_numpy(tspec, theta)
        got = tgp.noiseless_gram(tspec, theta_t, data, masked=masked).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    nv_want = np.asarray(jgp.noise_variance(
        jspec, jnp.asarray(theta, jnp.float32), jnp.asarray(meta)))
    nv_got = tgp.noise_variance(tspec, theta_t, torch.as_tensor(meta)).numpy()
    np.testing.assert_allclose(nv_got, nv_want, rtol=1e-6)


def test_wrapper_refuses_devices_without_a_kernel():
    """Only CPU tensors take the twin; any other non-CUDA device raises
    instead of silently computing elsewhere."""
    t = torch.zeros(1, 32, device="meta")
    B = torch.zeros(1, 1, 2, 2, device="meta")
    mu = torch.zeros(1, 1, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gram_lmcsm_fused(t, t.int(), B, mu, mu)
