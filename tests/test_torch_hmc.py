"""The port's HMC, its warmup, potential and diagnostics against the JAX
package.

The port's samplers run every (patient, chain) pair as a row of one batch;
the JAX package's run one chain and are vmapped. The deterministic parts
take the same numpy inputs on both sides and are held exactly: float64
(`jax.enable_x64()`) at 1e-8 where the arithmetic is the same but for the
order of reductions; float32 at the objective's tolerances (values 1e-4
relative, gradients 2e-3 of their scale, tests/test_torch_objective.py).
The random streams differ (Philox per row, `infer/streams.py`, against
`jax.random`), so the samplers themselves are held in distribution: at the
JAX tests' own Gaussian targets and tolerances (tests/test_hmc.py), and on
a GP patient, where the port's and the JAX package's posterior means, from
the same MAP start, must agree within 4 combined Monte-Carlo standard
errors.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one torch
# thread each, as these small tensors gain nothing from more
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from medgp_tpu.infer import diagnostics as jdiag  # noqa: E402
from medgp_tpu.infer import hmc as jhmc  # noqa: E402
from medgp_tpu.models import gp as jgp  # noqa: E402
from medgp_tpu.models import params as jparams  # noqa: E402
from medgp_tpu.models import priors as jpriors  # noqa: E402
from medgp_tpu_torch.infer import diagnostics as tdiag  # noqa: E402
from medgp_tpu_torch.infer import hmc as thmc  # noqa: E402
from medgp_tpu_torch.infer.scg import scg_minimize  # noqa: E402
from medgp_tpu_torch.infer.streams import patient_streams  # noqa: E402
from medgp_tpu_torch.models import gp as tgp  # noqa: E402
from medgp_tpu_torch.models import params as tparams  # noqa: E402
from medgp_tpu_torch.models import priors as tpriors  # noqa: E402
from tests.test_nlml import random_theta  # noqa: E402
from tests.test_torch_objective import _patients, _thetas  # noqa: E402
from tests.test_varem import synth_lmcsm_patient  # noqa: E402

F64_REL = 1e-8
VAL_REL = 1e-4
GRAD_TOL = 2e-3
MC_SIGMAS = 4.0  # port vs JAX posterior means: combined Monte-Carlo SE


def _close(got, want, tol=GRAD_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=tol, atol=tol * np.abs(want).max()
    )


# --------------------------------------------------------------------------
# the deterministic parts, held exactly
# --------------------------------------------------------------------------

@pytest.mark.parametrize("x64", [False, True])
def test_da_update_matches_jax(x64):
    rng = np.random.default_rng(0)
    dt = np.float64 if x64 else np.float32
    k = 6
    le, lb, hb, mu = (rng.normal(size=k).astype(dt) for _ in range(4))
    ap = rng.uniform(size=k).astype(dt)
    with jax.enable_x64(x64):
        for i in (0, 3, 17, 150):
            want = jax.vmap(
                lambda a, b, c, p, m: jhmc._da_update(
                    jhmc._DAState(a, b, c), p, jnp.asarray(i), 0.8, m)
            )(le, lb, hb, ap, mu)
            got = thmc._da_update(
                thmc._DAState(*(torch.as_tensor(x) for x in (le, lb, hb))),
                torch.as_tensor(ap), i, 0.8, torch.as_tensor(mu),
            )
            for g, w in zip(got, want):
                assert g.dtype == (torch.float64 if x64 else torch.float32)
                np.testing.assert_allclose(
                    g.numpy(), np.asarray(w), rtol=F64_REL if x64 else 1e-6
                )


def _toy_step(th, eps, inv_mass, xp):
    """A deterministic transition: a move that depends on the position, the
    step size and the mass, and an accept statistic of the position, not on
    a key. It contracts, and the statistic does not feed back through the
    step size at once, so the two packages' last-bit differences in cos and
    exp do not grow along the warmup."""
    e = eps[..., None]
    new = th * (1.0 - 0.1 * e) + 0.05 * e * xp.sqrt(inv_mass) * xp.cos(th) + 0.01 * e
    acc = 1.0 / (1.0 + xp.exp(xp.sum(xp.cos(th), -1) - 2.0))
    return new, acc


@pytest.mark.parametrize("num_warmup", [1, 12, 37])
def test_two_phase_warmup_matches_jax_on_a_deterministic_kernel(num_warmup):
    """Both phases, the Welford window, the shrinkage, the median-mass
    rescale and the fallbacks, per row, in float64."""
    rng = np.random.default_rng(1)
    k, H = 4, 5
    th0 = rng.normal(size=(k, H))
    gmask = np.ones(H)
    gmask[1] = 0.0
    with jax.enable_x64():
        def one(th):
            def kernel(state, key, eps, inv_mass):
                return _toy_step(state, eps, inv_mass, jnp)

            return jhmc.two_phase_warmup(
                kernel, th, lambda s: s, jax.random.key(0), num_warmup,
                0.05, 0.8, jnp.asarray(gmask), jnp.float64,
            )

        want = [np.asarray(x) for x in jax.vmap(one)(jnp.asarray(th0))]

    def kernel(state, eps, inv_mass):
        return _toy_step(state, eps, inv_mass, torch)

    got = thmc.two_phase_warmup(
        kernel, torch.as_tensor(th0), lambda s: s, num_warmup, 0.05, 0.8,
        torch.as_tensor(gmask),
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=F64_REL, atol=1e-12)


Q, D, R = 2, 3, 1


def _gp_batch(seed, k, n=128, dtype=np.float32):
    """k padded LMC-SM(Q, D, R) patients and thetas (tests/test_torch_objective.py)."""
    t, y, meta, mask = _patients(seed, n=n, batch=k, n_valid=[128, 100, 70, 90][:k])
    th = _thetas(seed + 1, batch=k).astype(dtype)
    return (t.astype(dtype), y.astype(dtype), meta, mask.astype(dtype)), th


def _close64(got, want, tol=F64_REL):
    """float64 agreement relative to the quantity's scale."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def gp_rows():
    """Eight LMC-SM(2, 3, 1) rows in float64 under the hier-gamma prior: four
    patients of 128, 100, 70 and 90 observations, a factorization that fails
    at every jitter (row 4: one observation repeated, almost no noise), a patient with two observations (row 5) and
    rows at extreme hypers (6: v = e^10, 7: kappa = e^30). The JAX
    package's potential and raw NLML gradient at theta, and its leapfrog
    trajectory from momenta p with per-row step counts (row 0 frozen from
    the start, row 1 running the whole budget), from one compiled program."""
    arrs, _ = _gp_batch(41, 4, dtype=np.float64)
    t, y, meta, mask = (np.concatenate([a, a]) for a in arrs)
    mask[5, 2:] = 0.0
    t[5, 2:] = y[5, 2:] = 0.0
    meta[5, 2:] = 0
    t[4], meta[4] = 10.0, 0  # 128 copies of one observation: K of rank 1
    jspec = jparams.LMCSMSpec(Q, D, R)
    sl = jparams.cov_slices(jspec)
    th = _thetas(42, batch=8).astype(np.float64)
    th[4, sl["lik"]] = -40.0  # noise 1.8e-35: no jitter multiple rescues it
    th[6, sl["v"]] = 10.0
    th[7, sl["kappa"]] = 30.0
    rng = np.random.default_rng(43)
    H = th.shape[1]
    lf = dict(
        p=rng.normal(size=(8, H)),
        eps=np.array([1e-3, 5e-3, 2e-3, 4e-3, 3e-3, 3e-3, 1e-3, 1e-3]),
        inv_mass=rng.uniform(0.5, 1.5, size=(8, H)),
        n_steps=np.array([0, 6, 3, 5, 4, 4, 2, 2]),
    )
    max_steps = 6
    with jax.enable_x64():
        prior = jpriors.hier_gamma_prior(jspec, beta_lam=0.01)
        gm = prior.grad_mask().astype(jnp.float64)

        def one(t, y, meta, mask, th, p, e, im, ns):
            data = jgp.PatientData(t, y, meta, mask)
            pg = jhmc.make_potential(jspec, data, prior)
            u, g = pg(th)
            raw = jax.grad(lambda x: jgp.nlml_fn(jspec, data, prior)(x)[0])(th)
            return (u, g, raw) + tuple(jhmc._leapfrog(pg, th, p, e, im, ns, max_steps, gm))

        want = [np.asarray(x) for x in jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in (
            t, y, meta, mask, th, lf["p"], lf["eps"], lf["inv_mass"], lf["n_steps"])))]
    tspec = tparams.LMCSMSpec(Q, D, R)
    # the prior's parameters in float32 in both packages, as JAX builds them
    tprior = tpriors.hier_gamma_prior(tspec, beta_lam=0.01)
    pg = thmc.make_potential(
        tspec, tgp.PatientData(*(torch.as_tensor(x) for x in (t, y, meta, mask))), tprior)
    return dict(th=th, lf=lf, max_steps=max_steps, want=want, pg=pg,
                gmask=tprior.grad_mask().double())


def test_make_potential_matches_jax_with_failed_and_short_patients(gp_rows):
    """U with its +inf entries, and dU, against JAX's make_potential,
    vmapped: both zero the non-finite entries of the gradient alone
    (`test_potential_zeroes_non_finite_entries_only` holds the rule on a
    gradient that is partly non-finite)."""
    ju, jg, raw = gp_rows["want"][:3]
    fin = np.isfinite(raw)
    assert np.all(fin.all(1) | ~fin.any(1)), "a JAX gradient row is partly non-finite"
    u, g = gp_rows["pg"](torch.as_tensor(gp_rows["th"]))
    assert np.isinf(ju).tolist() == torch.isinf(u).tolist()
    assert torch.isinf(u[[4, 5]]).all() and torch.isfinite(u[[0, 1, 2, 3, 6, 7]]).all()
    ok = np.isfinite(ju)
    np.testing.assert_allclose(u.numpy()[ok], ju[ok], rtol=F64_REL)
    assert torch.all(g[~torch.as_tensor(ok)] == 0) and np.all(jg[~ok] == 0)
    for i in (0, 1, 2, 3, 7):  # row 6: every lag but 0 underflows, dU is rounding
        _close64(g[i].numpy(), jg[i])


def test_potential_zeroes_non_finite_entries_only():
    """The port's gradient rule against the JAX potential's
    `jnp.where(jnp.isfinite(g), g, 0)` (hmc.py:281) on rows with a finite U
    whose gradient is finite in some entries and inf or NaN in others, and
    through `make_potential` on a potential whose autograd gradient is
    partly non-finite."""
    rng = np.random.default_rng(5)
    g = rng.normal(size=(4, 9)).astype(np.float32)
    g[0, [1, 4]] = np.inf
    g[1, 2] = -np.inf
    g[2, [0, 8]] = np.nan
    want = np.asarray(jnp.where(jnp.isfinite(g), g, jnp.zeros_like(g)))
    got = thmc.finite_grad(torch.as_tensor(g)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(np.isfinite(got[3]), np.ones(9, bool)) and np.array_equal(got[3], g[3])

    # sqrt at 0 has an infinite derivative: U finite, dU partly inf
    class _Res:
        ok = torch.ones(2, dtype=torch.bool)

    def loss(th):
        return torch.sqrt(th).sum(-1), _Res()

    data = tgp.PatientData(*(torch.ones(2, 3) for _ in range(4)))
    orig = thmc.nlml_fn
    thmc.nlml_fn = lambda *a, **k: loss
    try:
        u, du = thmc.make_potential(None, data)(torch.tensor([[0.0, 4.0], [1.0, 0.0]]))
    finally:
        thmc.nlml_fn = orig
    np.testing.assert_array_equal(u.numpy(), [2.0, 1.0])
    np.testing.assert_array_equal(du.numpy(), [[0.0, 0.25], [0.5, 0.0]])


def test_leapfrog_matches_jax_on_a_gp_potential(gp_rows):
    """Same theta, momenta, step sizes, masses and per-row step counts as
    JAX's `_leapfrog`; the failed and the short patient move ballistically
    at U = +inf in both."""
    lf, gm = gp_rows["lf"], gp_rows["gmask"]
    pg, th = gp_rows["pg"], torch.as_tensor(gp_rows["th"])
    u0, g0 = pg(th)
    got = thmc._leapfrog(
        pg, th, torch.as_tensor(lf["p"]), g0 * gm, u0, torch.as_tensor(lf["eps"]),
        torch.as_tensor(lf["inv_mass"]), torch.as_tensor(lf["n_steps"]),
        gp_rows["max_steps"], gm,
    )
    rows = [0, 1, 2, 3, 4, 5]  # 6, 7: gradients of rounding or of 1e13, no trajectory to hold
    for name, g, w in zip(("theta", "p", "U"), (got[0], got[1], got[3]), gp_rows["want"][3:]):
        g, w = g.numpy()[rows], w[rows]
        assert np.array_equal(np.isinf(g), np.isinf(w)), name
        _close64(np.where(np.isinf(w), 0, g), np.where(np.isinf(w), 0, w))
    np.testing.assert_array_equal(got[0][0].numpy(), gp_rows["th"][0])  # frozen row


def test_posterior_predict_matches_jax():
    """The mixture moments and the predictive NLL of one patient from the
    same draws (float32): 40 training observations, 10 held out, padded to
    64."""
    rng = np.random.default_rng(51)
    jspec = jparams.LMCSMSpec(1, 2, 1)
    d = synth_lmcsm_patient(rng, jspec, n=50, n_pad=14)
    tr_mask = np.zeros(64, np.float32)
    tr_mask[:40] = 1.0
    samples = np.stack([random_theta(rng, jspec, 0.2) for _ in range(12)]).astype(np.float32)
    held = slice(40, 50)

    def predict(samples, train, t2, meta2, y2):
        m, v, nll = jhmc.posterior_predict(jspec, samples, train, t2, meta2, thin=2)
        return m, v, nll(y2)

    jm, jv, jnll = jax.jit(predict)(
        jnp.asarray(samples), d._replace(mask=jnp.asarray(tr_mask)),
        d.t[held], d.meta[held], d.y[held])

    T = {k: torch.tensor(np.asarray(v)) for k, v in d._asdict().items()}
    train = tgp.PatientData(T["t"], T["y"], T["meta"], torch.as_tensor(tr_mask))
    m, v, nll = thmc.posterior_predict(
        tparams.LMCSMSpec(1, 2, 1), torch.as_tensor(samples), train,
        T["t"][held], T["meta"][held], thin=2)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=VAL_REL, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=VAL_REL)
    np.testing.assert_allclose(float(nll(T["y"][held])), float(jnll), rtol=VAL_REL)


def test_diagnostics_copy_matches_jax():
    rng = np.random.default_rng(61)
    spec_j, spec_t = jparams.LMCSMSpec(2, 2, 1), tparams.LMCSMSpec(2, 2, 1)
    chains = rng.normal(size=(3, 64, spec_t.n_hyp))
    chains[1] += 0.5
    chains[..., 4] = 2.0  # a clamped hyper
    ar = np.zeros((2, 300, 1))
    for s in range(1, 300):
        ar[:, s] = 0.9 * ar[:, s - 1] + rng.normal(size=(2, 1))
    for x in (chains, ar, chains[0]):
        np.testing.assert_allclose(tdiag.split_rhat(x), jdiag.split_rhat(x), rtol=1e-12)
        np.testing.assert_allclose(tdiag.ess_bulk(x), jdiag.ess_bulk(x), rtol=1e-12)
    got = tdiag.summarize_diagnostics(chains, spec_t)
    want = jdiag.summarize_diagnostics(chains, spec_j)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(
        [got[k] for k in want], [want[k] for k in want], rtol=1e-12)
    assert tdiag.block_slices(spec_t) == jdiag.block_slices(spec_j)


def _blocks(spec, t):
    Q, D, R, nl = spec.Q, spec.D, spec.R, spec.n_lik
    A = t[nl : nl + Q * D * R].reshape(Q, D, R)
    mu = t[nl + Q * D * R : nl + Q * D * R + Q]
    v = t[nl + Q * D * R + Q : nl + Q * D * R + 2 * Q]
    k = t[nl + Q * (D * R + 2):].reshape(Q, D)
    return A, mu, v, k


def _coregional(spec, t):
    A, _, _, k = _blocks(spec, t)
    return np.einsum("qdr,qer->qde", A, A) + np.stack(
        [np.diag(np.exp(k[q])) for q in range(spec.Q)])


def test_invariant_posterior_mean_matches_jax_and_defeats_symmetry(rng):
    """tests/test_hmc.py:142-193's draws (A-column sign flips and a
    cross-chain component permutation): the port's mean equals the JAX
    package's and averages back to the true B, mu and v."""
    spec = tparams.LMCSMSpec(3, 4, 2)
    Q, D, R, nl = spec.Q, spec.D, spec.R, spec.n_lik
    th = rng.normal(size=spec.n_hyp) * 0.5
    th[:nl] = np.log(0.3)
    A0, mu0, v0, k0 = _blocks(spec, th)
    S = 8
    perm = np.array([2, 0, 1])
    chains = np.zeros((2, S, spec.n_hyp))
    for s in range(S):
        signs = rng.choice([-1.0, 1.0], size=(Q, 1, R))
        t = th.copy()
        t[nl : nl + Q * D * R] = (A0 * signs).reshape(-1)
        chains[0, s] = t
        t2 = th.copy()
        t2[nl : nl + Q * D * R] = (A0[perm] * signs[perm]).reshape(-1)
        t2[nl + Q * D * R : nl + Q * D * R + Q] = mu0[perm]
        t2[nl + Q * D * R + Q : nl + Q * D * R + 2 * Q] = v0[perm]
        t2[nl + Q * (D * R + 2):] = k0[perm].reshape(-1)
        chains[1, s] = t2
    mean = tdiag.invariant_posterior_mean(spec, chains)
    np.testing.assert_allclose(
        mean, jdiag.invariant_posterior_mean(jparams.LMCSMSpec(Q, D, R), chains),
        rtol=1e-12, atol=1e-12)
    _, mum, vm, _ = _blocks(spec, mean)
    np.testing.assert_allclose(_coregional(spec, mean), _coregional(spec, th),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(mum, mu0, atol=1e-10)
    np.testing.assert_allclose(vm, v0, atol=1e-10)
    np.testing.assert_allclose(mean[:nl], th[:nl], atol=1e-12)


# --------------------------------------------------------------------------
# the sampler, held in distribution
# --------------------------------------------------------------------------

MU = torch.tensor([1.0, -2.0, 0.5])
SIGMA = torch.tensor([0.5, 2.0, 1.0])


def gaussian_potential(x):
    return torch.sum(0.5 * ((x - MU) / SIGMA) ** 2, -1), (x - MU) / SIGMA**2


def test_gaussian_target_moments():
    """tests/test_hmc.py:21-39: N(mu, diag(sigma^2)) recovered."""
    res = thmc.hmc_sample(
        gaussian_potential, torch.zeros(1, 3), patient_streams(0, [0]),
        num_warmup=500, num_samples=2000, num_leapfrog=16, init_step_size=0.1,
    )
    s = res.samples[0].numpy()
    assert float(res.accept_rate) > 0.6
    assert int(res.divergences) == 0
    np.testing.assert_allclose(s.mean(0), MU.numpy(), atol=0.25)
    np.testing.assert_allclose(s.std(0), SIGMA.numpy(), rtol=0.35)


def test_step_size_adapts_toward_target():
    """tests/test_hmc.py:42-55."""
    res = thmc.hmc_sample(
        lambda x: (0.5 * torch.sum(x**2, -1), x), torch.zeros(1, 5),
        patient_streams(1, [0]), num_warmup=400, num_samples=400,
        num_leapfrog=8, init_step_size=1e-4, target_accept=0.8,
    )
    assert float(res.step_size) > 1e-2
    assert 0.55 < float(res.accept_rate) <= 1.0


def gp_patient(seed, spec, n=40, n_pad=24):
    """One synthetic LMC-SM patient (tests/test_varem.py), padded to a
    multiple of the Cholesky block: numpy (t, y, meta, mask) of (n + n_pad,)."""
    d = synth_lmcsm_patient(np.random.default_rng(seed), spec, n=n, n_pad=n_pad)
    return tuple(np.asarray(x) for x in d)


def tdata(arrs):
    return tgp.PatientData(*(torch.tensor(x)[None] for x in arrs))


def jdata(arrs):
    return jgp.PatientData(*(jnp.asarray(x) for x in arrs))


def test_clamped_hypers_stay_fixed():
    """tests/test_hmc.py:86-105: a clamped A element stays exactly 0."""
    spec = tparams.LMCSMSpec(1, 2, 1)
    arrs = gp_patient(71, spec, n=25, n_pad=7)
    theta0 = random_theta(np.random.default_rng(72), spec).astype(np.float32)
    theta0[spec.n_lik] = 0.0
    prior = tpriors.clamp_a_elements(
        tpriors.empty_prior(spec.n_hyp), spec,
        torch.as_tensor([True] + [False] * (spec.Q * spec.D * spec.R - 1)),
    )
    res = thmc.hmc_patient(
        spec, tdata(arrs), torch.as_tensor(theta0)[None],
        patient_streams(3, [0]), prior=prior, num_chains=2,
        num_warmup=50, num_samples=50, num_leapfrog=6, init_step_size=0.005,
    )
    assert res.samples.shape == (1, 2, 50, spec.n_hyp)
    np.testing.assert_array_equal(res.samples[..., spec.n_lik].numpy(), 0.0)
    assert float(res.samples[..., 0].std()) > 0


def normal_priors(H):
    """N(0, 1) on every unconstrained hyper in both packages: it identifies
    the GP posterior, whose raw likelihood has flat directions along which
    MCMC drifts for nats (tests/test_vi.py:35-40)."""
    jp = jpriors.empty_prior(H)._replace(
        active=jnp.ones(H, bool), ptype=jnp.full(H, jpriors.PRIOR_NORMAL, jnp.int32),
        loc=jnp.zeros(H, jnp.float32), scale=jnp.ones(H, jnp.float32))
    tp = tpriors.empty_prior(H)._replace(
        active=torch.ones(H, dtype=torch.bool),
        ptype=torch.full((H,), tpriors.PRIOR_NORMAL, dtype=torch.int32),
        loc=torch.zeros(H), scale=torch.ones(H))
    return jp, tp


def map_start(spec, arrs, prior, seed, evals=300):
    """A MAP point by the port's SCG, the start both packages sample from."""
    f = tgp.objective_and_grad(spec, tdata(arrs), prior)
    x0 = random_theta(np.random.default_rng(seed), spec).astype(np.float32)
    res = scg_minimize(f, torch.as_tensor(x0)[None], evals)
    assert bool(res.ok[0])
    return res.x[0].numpy()


def natural_series(spec, draws):
    """Per-draw natural-scale blocks of LMC-SM(1, D, R) draws (C, S, H):
    noise std, mu, v and B = A A^T + diag(kappa), as (C, S, m). With Q = 1
    there is no component to align, and B is invariant to A's signs, so
    their means are the invariant posterior mean's (diagnostics.py)."""
    C, S, H = draws.shape
    rows = []
    for x in draws.reshape(-1, H):
        _, mu, v, _ = _blocks(spec, x)
        rows.append(np.concatenate([
            np.exp(x[: spec.n_lik]), np.exp(mu), np.exp(v), _coregional(spec, x).ravel(),
        ]))
    return np.asarray(rows).reshape(C, S, -1)


def assert_means_within_mc_error(spec, port, ref):
    """Port vs JAX posterior means of the natural-scale blocks within
    MC_SIGMAS combined standard errors, each SE the series' standard
    deviation over the square root of its bulk ESS on that side."""
    a, b = natural_series(spec, port), natural_series(spec, ref)
    se = []
    for x in (a, b):
        ess = np.array([tdiag.ess_bulk(x[..., j:j + 1])[0] for j in range(x.shape[-1])])
        se.append(x.reshape(-1, x.shape[-1]).std(0) / np.sqrt(ess))
    d = np.abs(a.mean((0, 1)) - b.mean((0, 1)))
    lim = MC_SIGMAS * np.hypot(*se)
    assert np.all(d <= lim), (d, lim)
    return d / lim


def test_gp_posterior_means_match_jax():
    """HMC on a GP patient from the same MAP start in both packages (2
    chains, 150 warmup, 250 draws, 8 leapfrog steps)."""
    jspec, spec = jparams.LMCSMSpec(1, 2, 1), tparams.LMCSMSpec(1, 2, 1)
    arrs = gp_patient(81, spec)
    jp, tp = normal_priors(spec.n_hyp)
    theta_map = map_start(spec, arrs, tp, 82)
    kw = dict(num_chains=2, num_warmup=150, num_samples=250, num_leapfrog=8,
              init_step_size=0.005)
    ref = jax.jit(lambda d, th, key: jhmc.hmc_patient(jspec, d, th, key, prior=jp, **kw))(
        jdata(arrs), jnp.asarray(theta_map), jax.random.key(2))
    res = thmc.hmc_patient(spec, tdata(arrs), torch.as_tensor(theta_map)[None],
                           patient_streams(2, [0]), prior=tp, **kw)
    assert float(res.accept_rate.min()) > 0.3
    assert torch.isfinite(res.samples).all()
    assert_means_within_mc_error(spec, res.samples[0].numpy(), np.asarray(ref.samples))
