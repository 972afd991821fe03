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

The port's LMC-SM objective with the zero mean is one autograd node
(`ops/objective.py:LMCSMObjective`), so `objective_and_grad` here runs it;
`test_fused_objective_matches_the_composition` holds it against the
composition the other specs and priors take, and the float64 tests of its
prologue and epilogue twins hold them to 1e-10 of the composition's own
functions and of autograd through them.
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
from medgp_tpu_torch.ops import objective as tobjective  # noqa: E402
from medgp_tpu_torch.utils import metrics as tmetrics  # noqa: E402

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


# -- the fused LMC-SM objective (ops/objective.py:LMCSMObjective) ----------
#
# `objective_and_grad` takes one autograd node for the LMC-SM kernel with
# the zero mean and a prior without KDE samples; `gp.fusable` returning
# False gives the composition (noiseless_gram + masked_nlml + log_prior
# under autograd), which SE, SM, non-zero means and KDE priors take.

FUSED_CASES = (
    "hier_gamma_clamped", "test_prior", "no_prior", "idx_subset", "padded",
    "two_observations", "factorization_fails", "jitter_retry", "detached_rows",
)


def _hier_prior_clamped(tspec, jspec):
    """A batched hier-gamma prior with A-elements clamped row by row."""
    clamp = np.zeros((3, Q * D * R), bool)
    clamp[0, 1] = clamp[1, [0, 4]] = clamp[2, 5] = True
    tprior = tpriors.clamp_a_elements(
        tpriors.hier_gamma_prior(tspec, 0.5).expand(3), tspec, torch.as_tensor(clamp))
    jprior = [jpriors.clamp_a_elements(jpriors.hier_gamma_prior(jspec, 0.5), jspec,
                                       jnp.asarray(c)) for c in clamp]
    return tprior, jprior


def _fused_case(case, tspec, jspec):
    """(data, theta, torch prior, JAX priors per row or None, idx)."""
    from medgp_tpu.parallel import runner as jrunner
    from medgp_tpu_torch.parallel import runner as trunner

    n_valid = dict(padded=(128, 17, 64), two_observations=(128, 2, 60)).get(
        case, (128, 100, 70))
    t, y, meta, mask = _patients(93, n_valid=n_valid)
    theta = _thetas(94)
    tprior, jprior = _hier_prior_clamped(tspec, jspec)
    idx = None
    if case == "test_prior":
        mode = theta[0].copy()
        mode[jspec.n_lik + np.array([0, 3])] = 0.0
        theta[:, jspec.n_lik + np.array([0, 3])] = 0.0
        tprior = trunner._test_prior(tspec, mode, "cpu")
        jprior = [jrunner._test_prior(jspec, mode)] * 3
    elif case == "no_prior":
        tprior, jprior = None, [None] * 3
    elif case == "idx_subset":
        idx = torch.tensor([2, 0])
    elif case == "factorization_fails":
        theta[2, tparams.cov_slices(tspec)["kappa"]] = 100.0  # exp overflows: K is inf
    data = tgp.PatientData(*(torch.as_tensor(x) for x in (t, y, meta, mask)))
    with_jax = case in ("hier_gamma_clamped", "test_prior", "no_prior")
    return data, torch.as_tensor(theta), tprior, jprior if with_jax else None, idx


def _fail_first_factorization(monkeypatch, row):
    """K3 reports row `row` of a full batch as failed at multiplier 1, so the
    jitter loop factors it again at 2."""
    orig = tnlml.cuda_chol.chol_solve

    def chol_solve(K, noise, y):
        L, alpha, linvd = orig(K, noise, y)
        if K.shape[0] == 3:
            L[row, 0, 0] = float("nan")
        return L, alpha, linvd
    monkeypatch.setattr(tnlml.cuda_chol, "chol_solve", chol_solve)


def _detach_second_half(monkeypatch):
    """The benchmark's `half` fault: the second half of every batch's
    values leaves autograd."""
    orig = tgp.nlml_fn

    def nlml_fn(*a, **k):
        loss = orig(*a, **k)

        def faulty(theta):
            value, res = loss(theta)
            h = value.shape[0] // 2
            return torch.cat([value[:h], value[h:].detach()]), res
        return faulty
    monkeypatch.setattr(tgp, "nlml_fn", nlml_fn)


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_objective_matches_the_composition(case, monkeypatch):
    """Value, gradient and ok of the fused objective against the
    composition (and, for the first three cases, the JAX package's XLA
    path), at VAL_REL and `_close`."""
    monkeypatch.setenv("MEDGP_PALLAS_CHOL", "0")
    monkeypatch.setenv("MEDGP_PALLAS_GRAM", "0")
    jspec, tspec = jparams.LMCSMSpec(Q, D, R), tparams.LMCSMSpec(Q, D, R)
    data, theta, tprior, jprior, idx = _fused_case(case, tspec, jspec)
    if case == "jitter_retry":
        _fail_first_factorization(monkeypatch, row=1)
    th = theta if idx is None else theta[idx]
    fused_before = tmetrics.snapshot()["objective.fused_systems"]
    if case == "detached_rows":
        whole = tgp.objective_and_grad(tspec, data, tprior)(th)
        _detach_second_half(monkeypatch)
    v, g, ok = tgp.objective_and_grad(tspec, data, tprior)(th, idx)
    assert tmetrics.snapshot()["objective.fused_systems"] - fused_before == (
        2 * th.shape[0] if case == "detached_rows" else th.shape[0])
    _, res = tgp.nlml_fn(tspec, data if idx is None else data.rows(idx),
                         None if tprior is None or idx is None else tprior.rows(idx))(th)
    with monkeypatch.context() as m:
        m.setattr(tgp, "fusable", lambda *a: False)
        v_c, g_c, ok_c = tgp.objective_and_grad(tspec, data, tprior)(th, idx)
        _, res_c = tgp.nlml_fn(tspec, data if idx is None else data.rows(idx),
                               None if tprior is None or idx is None else tprior.rows(idx))(th)
    assert tmetrics.snapshot()["objective.fused_systems"] - fused_before == (
        2 * th.shape[0] if case == "detached_rows" else th.shape[0])
    assert ok.tolist() == ok_c.tolist()
    assert res.mult.tolist() == res_c.mult.tolist()
    assert torch.equal(torch.isinf(v), torch.isinf(v_c))
    np.testing.assert_allclose(v[ok].numpy(), v_c[ok].numpy(), rtol=VAL_REL)
    _close(g.numpy(), g_c.numpy())

    want_ok = dict(two_observations=[True, False, True],
                   factorization_fails=[True, True, False]).get(case, [True] * th.shape[0])
    assert ok.tolist() == want_ok
    assert torch.all(torch.isinf(v[~ok])) and torch.all(g[~ok] == 0)
    if case == "jitter_retry":
        assert res.mult.tolist() == [1, 2, 1]
    if case == "detached_rows":
        assert torch.all(g[1:] == 0) and torch.all(g_c[1:] == 0)
        np.testing.assert_array_equal(g[:1].numpy(), whole[1][:1].numpy())
    if tprior is not None:
        gm = tprior.grad_mask() if idx is None or tprior.active.dim() == 1 \
            else tprior.grad_mask()[idx]
        assert torch.all(g[(gm == 0).expand_as(g)] == 0)
    if jprior is not None:
        want = [jgp.objective_and_grad(
            jspec, jgp.PatientData(*(jnp.asarray(x[b].numpy()) for x in data)), jprior[b],
        )(jnp.asarray(theta[b].numpy())) for b in range(3)]
        np.testing.assert_allclose(v.numpy(), [float(w[0]) for w in want], rtol=VAL_REL)
        assert ok.tolist() == [bool(w[2]) for w in want]
        _close(g.numpy(), np.stack([np.asarray(w[1]) for w in want]))


TWIN_PRIORS = ("hier_gamma_clamped", "test_prior", "no_prior", "laplace_at_loc")


def _twin_prior(kind, tspec, theta):
    if kind == "hier_gamma_clamped":
        pr = _hier_prior_clamped(tspec, jparams.LMCSMSpec(Q, D, R))[0]
        return pr._replace(loc=pr.loc.double(), scale=pr.scale.double())
    if kind == "test_prior":
        a = torch.zeros(Q * D * R, dtype=torch.bool)
        a[[0, 3]] = True
        return tpriors.clamp_a_elements(
            tpriors.empty_prior(tspec.n_hyp, dtype=torch.float64), tspec, a)
    if kind == "laplace_at_loc":
        # Laplace terms whose hyper sits exactly on loc: sign 0, as abs's
        # gradient gives; one plain, one through exp
        pr = tpriors.hier_gamma_prior(tspec, 0.3, dtype=torch.float64)
        sl = tparams.cov_slices(tspec)
        j, jk = sl["a"].start + 2, sl["kappa"].start + 1
        ptype, loc = pr.ptype.clone(), pr.loc.clone()
        ptype[j] = tpriors.PRIOR_LAPLACE
        loc[j] = theta[0, j]
        loc[jk] = torch.exp(theta[0, jk])
        return pr._replace(ptype=ptype, loc=loc, scale=pr.scale.clone())
    return None


def _twin_inputs(seed):
    rng = np.random.default_rng(seed)
    tspec = tparams.LMCSMSpec(Q, D, R)
    t, y, meta, mask = _patients(seed, n_valid=(128, 100, 70))
    theta = torch.as_tensor(_thetas(seed + 1).astype(np.float64))
    k, n = theta.shape[0], N
    dB = torch.as_tensor(rng.normal(size=(k, Q, D, D)))
    dmu, dv = (torch.as_tensor(rng.normal(size=(k, Q))) for _ in range(2))
    dKm = torch.as_tensor(rng.normal(size=(k, n, n)))
    mult = torch.tensor([1, 3, 2], dtype=torch.int32)
    d_value = torch.tensor([1.0, 0.5, 0.0], dtype=torch.float64)
    return tspec, (torch.as_tensor(x) for x in (t, y, meta, mask)), theta, (
        dB, dmu, dv, dKm, mult, d_value)


@pytest.mark.parametrize("kind", TWIN_PRIORS)
def test_theta_prologue_twin_matches_the_composition(kind):
    """In float64, to 1e-10: B, mu, v, the masked noise and y, the log
    prior and the valid count against the composition's own functions."""
    tspec, (t, y, meta, mask), theta, _ = _twin_inputs(95)
    prior = _twin_prior(kind, tspec, theta)
    data = tgp.PatientData(t.double(), y.double(), meta, mask.double())
    B, mu, v, noise, y_eff, lp, n_eff = tobjective.theta_prologue(
        theta, data.y, data.meta, data.mask, prior, tspec)
    p = tspec.unpack(theta)
    want = dict(
        B=tspec.coregional_B(p["A"], p["kappa"]), mu=p["mu"], v=p["v"],
        noise=tgp.noise_variance(tspec, theta, data.meta) * data.mask,
        y_eff=data.y * data.mask,
        lp=torch.zeros(3, dtype=torch.float64) if prior is None
        else tpriors.log_prior(prior, theta),
        n_eff=data.n_obs)
    for name, got in zip(want, (B, mu, v, noise, y_eff, lp, n_eff)):
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=1e-10,
                                   atol=1e-10 * float(want[name].abs().max()), err_msg=name)


@pytest.mark.parametrize("kind", TWIN_PRIORS)
def test_theta_epilogue_twin_matches_autograd_of_the_composition(kind):
    """In float64, to 1e-10: dtheta from given dB, dmu, dv, dKm, mult and
    d_value against autograd through coregional_B, exp, noise_variance and
    log_prior; rows not ok are 0, and a Laplace hyper on its loc gets sign
    0."""
    tspec, (t, y, meta, mask), theta, (dB, dmu, dv, dKm, mult, d_value) = _twin_inputs(96)
    prior = _twin_prior(kind, tspec, theta)
    mask = mask.double()
    ok = torch.tensor([True, True, False])
    got = tobjective.theta_epilogue(theta, dB, dmu, dv, dKm, mult, meta, mask, d_value, ok,
                                    prior, tspec)
    th = theta.clone().requires_grad_()
    p = tspec.unpack(th)
    B = tspec.coregional_B(p["A"], p["kappa"])
    noise = tgp.noise_variance(tspec, th, meta) * mask
    dnoise = mult.double()[:, None] * torch.diagonal(dKm, dim1=-2, dim2=-1)
    total = (dB * B).sum() + (dmu * p["mu"]).sum() + (dv * p["v"]).sum() + (dnoise * noise).sum()
    if prior is not None:
        total = total - (d_value * tpriors.log_prior(prior, th)).sum()
    (want,) = torch.autograd.grad(total, th)
    want = torch.where(ok[:, None], want, torch.zeros_like(want))
    assert torch.all(got[2] == 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-10 * float(want.abs().max()))
