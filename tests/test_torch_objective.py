"""The training objective of the port against the JAX package.

The same numpy inputs (seeded) go through `medgp_tpu.ops.nlml.masked_nlml`,
`medgp_tpu.models.gp.objective_and_grad` / `posterior_at`,
`medgp_tpu.models.priors.log_prior` and `medgp_tpu.data.inits.random_inits`,
and through their counterparts in the port, which run the kernels' plain
twins on the CPU. Where the JAX function reaches a Pallas kernel it runs in
interpret mode (MEDGP_PALLAS_CHOL=1 / MEDGP_PALLAS_GRAM=1, as
tests/test_pallas_chol.py:115-137 runs it); "0" takes the XLA path.

Tolerances: values 1e-4 relative (float32 factorizations summed in
another order, as tests/test_pallas_chol.py:134); gradients rtol/atol
2e-3 relative to the gradient's scale (tests/test_pallas_chol.py:136,
tests/test_pallas_gram.py:83); the inits 1e-6 relative (the same float32
arithmetic, with log from two libraries).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one torch
# thread each, as these small tensors gain nothing from more
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from medgp_tpu.data import inits as jinits  # noqa: E402
from medgp_tpu.models import gp as jgp  # noqa: E402
from medgp_tpu.models import params as jparams  # noqa: E402
from medgp_tpu.models import priors as jpriors  # noqa: E402
from medgp_tpu.ops import nlml as jnlml  # noqa: E402
from medgp_tpu_torch.data import inits as tinits  # noqa: E402
from medgp_tpu_torch.models import gp as tgp  # noqa: E402
from medgp_tpu_torch.models import params as tparams  # noqa: E402
from medgp_tpu_torch.models import priors as tpriors  # noqa: E402
from medgp_tpu_torch.ops import nlml as tnlml  # noqa: E402

Q, D, R, N = 2, 3, 1, 128
VAL_REL = 1e-4
GRAD_TOL = 2e-3


def _close(got, want, tol=GRAD_TOL, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=tol, atol=tol * np.abs(want).max(),
        err_msg=msg,
    )


def _systems(seed):
    """Three systems at n=128: a well-conditioned one, a padded one, and
    one (A A^T / n - 2.5 I, noise 1) that fails at noise multipliers 1 and
    2 and succeeds at 3 (the jitter retry)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(3, N, N)).astype(np.float32)
    K = (np.einsum("bij,bkj->bik", A, A) / N).astype(np.float32)
    K[:2] += 0.5 * np.eye(N, dtype=np.float32)
    K[2] -= 2.5 * np.eye(N, dtype=np.float32)
    K = 0.5 * (K + np.swapaxes(K, 1, 2))
    y = rng.normal(size=(3, N)).astype(np.float32)
    nv = np.full((3, N), 0.2, np.float32)
    nv[2] = 1.0
    mask = np.ones((3, N), np.float32)
    mask[1, 90:] = 0.0
    return K, y, nv, mask


@pytest.mark.parametrize("pallas_chol", ["0", "1"])
def test_masked_nlml_value_and_gradient_match_jax(pallas_chol, monkeypatch):
    """The hot backward (only d_nlml: K4 / its twin) and the jitter retry,
    against JAX's XLA path and its Pallas path (chol_solve + qmat)."""
    monkeypatch.setenv("MEDGP_PALLAS_CHOL", pallas_chol)
    K, y, nv, mask = _systems(81)

    def jloss(K, y, nv):
        res = jax.vmap(lambda k, yy, v, m: jnlml.masked_nlml(k, yy, v, m))(
            K, y, nv, jnp.asarray(mask)
        )
        return jnp.sum(res.nlml), res

    (jv, jres), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(K), jnp.asarray(y), jnp.asarray(nv)
    )
    tt = [torch.as_tensor(x).requires_grad_() for x in (K, y, nv)]
    res = tnlml.masked_nlml(*tt, torch.as_tensor(mask))
    tg = torch.autograd.grad(res.nlml.sum(), tt)
    assert res.mult.tolist() == np.asarray(jres.mult).tolist() == [1, 1, 3]
    assert res.ok.all() and np.asarray(jres.ok).all()
    np.testing.assert_allclose(
        res.nlml.detach().numpy(), np.asarray(jres.nlml), rtol=VAL_REL
    )
    for name, g, w in zip(("K", "y", "noise"), tg, jg):
        _close(g.numpy(), w, msg=name)


def test_masked_nlml_failure_reports_inf_and_zero_gradient():
    K, y, nv, mask = _systems(82)
    K[2] = -np.eye(N, dtype=np.float32)
    nv[2] = 1e-3  # never positive definite within 11 multipliers
    tt = [torch.as_tensor(x).requires_grad_() for x in (K, y, nv)]
    res = tnlml.masked_nlml(*tt, torch.as_tensor(mask))
    assert res.ok.tolist() == [True, True, False]
    assert np.isinf(res.nlml[2].item())
    total = torch.where(res.ok, res.nlml, torch.zeros_like(res.nlml)).sum()
    gK, gy, gn = torch.autograd.grad(total, tt)
    assert torch.all(gK[2] == 0) and torch.all(gy[2] == 0) and torch.all(gn[2] == 0)
    assert torch.isfinite(gK).all()


def _patients(seed, n=N, batch=3, n_valid=(128, 100, 70)):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 168, size=(batch, n)), axis=1).astype(np.float32)
    meta = rng.integers(0, D, size=(batch, n)).astype(np.int32)
    mask = np.zeros((batch, n), np.float32)
    for b, k in enumerate(n_valid[:batch]):
        mask[b, :k] = 1.0
    t[mask == 0] = 0.0
    meta[mask == 0] = 0
    y = (rng.normal(size=(batch, n)) * mask).astype(np.float32)
    return t, y, meta, mask


def _thetas(seed, batch=3):
    rng = np.random.default_rng(seed)
    spec = jparams.LMCSMSpec(Q, D, R)
    sl = jparams.cov_slices(spec)
    th = np.zeros((batch, spec.n_hyp), np.float32)
    th[:, sl["lik"]] = np.log(rng.uniform(0.2, 0.4, size=(batch, D)))
    th[:, sl["a"]] = rng.normal(size=(batch, Q * D * R)) * 0.4
    th[:, sl["mu"]] = np.log(1.0 / rng.uniform(12, 72, size=(batch, Q)))
    th[:, sl["v"]] = np.log(1.0 / (2 * np.pi * rng.uniform(6, 72, size=(batch, Q))))
    th[:, sl["kappa"]] = np.log(rng.uniform(0.01, 0.05, size=(batch, Q * D)))
    return th


@pytest.mark.parametrize("path", ["xla", "pallas"])
def test_objective_and_grad_matches_jax(path, monkeypatch):
    """A padded batch under the hier-gamma prior with one A element
    clamped: value, gradient (exactly 0 at the clamped element) and ok."""
    flag = "1" if path == "pallas" else "0"
    monkeypatch.setenv("MEDGP_PALLAS_CHOL", flag)
    monkeypatch.setenv("MEDGP_PALLAS_GRAM", flag)
    jspec, tspec = jparams.LMCSMSpec(Q, D, R), tparams.LMCSMSpec(Q, D, R)
    t, y, meta, mask = _patients(83)
    theta = _thetas(84)
    clamp = np.zeros(Q * D * R, bool)
    clamp[1] = True
    jprior = jpriors.clamp_a_elements(
        jpriors.hier_gamma_prior(jspec, 0.5), jspec, jnp.asarray(clamp)
    )
    tprior = tpriors.clamp_a_elements(
        tpriors.hier_gamma_prior(tspec, 0.5), tspec, torch.as_tensor(clamp)
    )
    want = [
        jgp.objective_and_grad(
            jspec, jgp.PatientData(*(jnp.asarray(x[b]) for x in (t, y, meta, mask))),
            jprior,
        )(jnp.asarray(theta[b]))
        for b in range(len(theta))
    ]
    data = tgp.PatientData(*(torch.as_tensor(x) for x in (t, y, meta, mask)))
    v, g, ok = tgp.objective_and_grad(tspec, data, tprior)(torch.as_tensor(theta))
    np.testing.assert_allclose(
        v.numpy(), [float(w[0]) for w in want], rtol=VAL_REL
    )
    assert ok.tolist() == [bool(w[2]) for w in want] == [True] * 3
    _close(g.numpy(), np.stack([np.asarray(w[1]) for w in want]))
    a_clamped = jspec.n_lik + 1
    assert torch.all(g[:, a_clamped] == 0.0)

    # a subset of the batch (the optimizer's per-element evaluation)
    idx = torch.tensor([2, 0])
    v2, g2, _ = tgp.objective_and_grad(tspec, data, tprior)(
        torch.as_tensor(theta)[idx], idx
    )
    np.testing.assert_allclose(v2.numpy(), v.numpy()[[2, 0]], rtol=1e-6)
    np.testing.assert_allclose(g2.numpy(), g.numpy()[[2, 0]], rtol=1e-5, atol=1e-5)


def test_objective_rejects_patients_with_two_observations():
    tspec = tparams.LMCSMSpec(Q, D, R)
    t, y, meta, mask = _patients(85, n_valid=(128, 2, 60))
    data = tgp.PatientData(*(torch.as_tensor(x) for x in (t, y, meta, mask)))
    v, g, ok = tgp.objective_and_grad(tspec, data)(torch.as_tensor(_thetas(86)))
    assert ok.tolist() == [True, False, True]
    assert np.isinf(v[1].item()) and torch.all(g[1] == 0)


def test_posterior_cold_path_gradient_matches_jax():
    """d_alpha and d_L cotangents (through `predict`): the cold backward
    (K5 + M^{-1}, and the replayed factorization), via posterior_at."""
    jspec, tspec = jparams.LMCSMSpec(Q, D, R), tparams.LMCSMSpec(Q, D, R)
    t, y, meta, mask = _patients(87, batch=2)
    rng = np.random.default_rng(88)
    t2 = rng.uniform(0, 168, size=(2, 16)).astype(np.float32)
    meta2 = rng.integers(0, D, size=(2, 16)).astype(np.int32)
    theta = _thetas(89, batch=1)[0]

    def jf(th, b):
        post = jgp.posterior_at(
            jspec, th, jgp.PatientData(*(jnp.asarray(x[b]) for x in (t, y, meta, mask))),
            jnp.asarray(t2[b]), jnp.asarray(meta2[b]),
        )
        return jnp.sum(post.mean) + jnp.sum(post.var), post

    jg, jmean, jvar = 0.0, [], []
    for b in range(2):
        (_, post), g = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(theta), b)
        jg = jg + np.asarray(g)
        jmean.append(np.asarray(post.mean))
        jvar.append(np.asarray(post.var))
    th = torch.as_tensor(theta).requires_grad_()
    data = tgp.PatientData(*(torch.as_tensor(x) for x in (t, y, meta, mask)))
    post = tgp.posterior_at(tspec, th, data, torch.as_tensor(t2), torch.as_tensor(meta2))
    (tg,) = torch.autograd.grad(post.mean.sum() + post.var.sum(), th)
    _close(post.mean.detach().numpy(), np.stack(jmean), tol=VAL_REL)
    _close(post.var.detach().numpy(), np.stack(jvar), tol=VAL_REL)
    _close(tg.numpy(), jg)

    pp, contrib = tgp.parsed_posterior_at(
        tspec, th.detach(), data, torch.as_tensor(t2), torch.as_tensor(meta2)
    )
    np.testing.assert_allclose(
        contrib.sum(dim=1).numpy(), pp.mean.numpy(), rtol=1e-4, atol=1e-5
    )


def test_log_prior_with_kde_matches_jax():
    jspec, tspec = jparams.LMCSMSpec(Q, D, R), tparams.LMCSMSpec(Q, D, R)
    rng = np.random.default_rng(90)
    theta = _thetas(91, batch=1)[0]
    samples = rng.normal(size=7) * 0.3 + theta[2]
    jp = jpriors.set_kde_prior(jpriors.hier_gamma_prior(jspec, 0.1), 2, samples, 0.2)
    tp = tpriors.set_kde_prior(tpriors.hier_gamma_prior(tspec, 0.1), 2, samples, 0.2)
    jp = jpriors.set_kde_prior(jp, 4, samples[:3], 0.5, max_samples=9)
    tp = tpriors.set_kde_prior(tp, 4, samples[:3], 0.5, max_samples=9)
    jv, jg = jax.value_and_grad(lambda th: jpriors.log_prior(jp, th))(jnp.asarray(theta))
    th = torch.as_tensor(theta).requires_grad_()
    tv = tpriors.log_prior(tp, th)
    (tg,) = torch.autograd.grad(tv, th)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    assert torch.isfinite(tg).all()
    _close(tg.numpy(), jg, tol=1e-4)


def test_random_inits_lie_on_the_grid_and_match_jax(monkeypatch):
    jspec, tspec = jparams.LMCSMSpec(Q, D, R), tparams.LMCSMSpec(Q, D, R)
    bounds = tinits.default_bounds(tspec)
    S = 64
    got = tinits.random_inits(718, tspec, bounds, S).numpy()
    assert got.shape == (S, tspec.n_hyp) and got.dtype == np.float32
    # invert the per-block transforms: every draw sits on the 12-bit grid
    sl = tparams.cov_slices(tspec)
    u = np.empty_like(got, dtype=np.float64)
    u[:, sl["lik"]] = np.exp(got[:, sl["lik"]])
    u[:, sl["a"]] = got[:, sl["a"]] / (0.9 / np.sqrt(Q * R))
    u[:, sl["mu"]] = 1.0 / np.exp(got[:, sl["mu"]])
    u[:, sl["v"]] = 1.0 / (2 * np.pi * np.exp(got[:, sl["v"]]))
    u[:, sl["kappa"]] = np.exp(got[:, sl["kappa"]]) * Q / 0.1
    lb, ub = bounds.lb.astype(np.float64), bounds.ub.astype(np.float64)
    k = (u - lb) * 4096 / (ub - lb) - 1
    assert np.abs(k - np.round(k)).max() < 2e-2
    assert k.min() > -0.5 and k.max() < 4095.5

    levels = np.random.default_rng(92).integers(0, 4096, size=(S, tspec.n_hyp))
    monkeypatch.setattr(
        tinits, "_draw_levels", lambda gen, shape: torch.as_tensor(levels)
    )
    monkeypatch.setattr(
        jinits.jax.random, "randint",
        lambda key, shape, lo, hi: jnp.asarray(levels, jnp.int32),
    )
    want = np.asarray(jinits.random_inits(
        jax.random.key(0), jspec, jinits.default_bounds(jspec), S
    ))
    got = tinits.random_inits(0, tspec, bounds, S).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
