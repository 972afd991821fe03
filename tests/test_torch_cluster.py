"""The port's clustering stack against the JAX package: KDE modes, GMM EM
and BIC selection, feature extraction and mode kernels.

Both packages run on the CPU (the port with device="cpu") on the same
numpy-seeded inputs.

Tolerances:
  * KDE (float64 in both): 1e-12 relative; only the order of the sums
    over samples differs;
  * GMM EM from shared centres (float32 in both): weights, means,
    covariances and the final mean log-likelihood within 1e-4 relative;
    batched inits against solo runs as tests/test_cluster.py:70 holds
    them (ll 1e-6 relative, means 1e-5); Lloyd steps within 1e-5 of a
    float64 numpy Lloyd;
  * features: bitwise (the same numpy code);
  * mode kernels: 1e-10 with algorithm None; 1e-5 with gmm, with the
    mixture components sorted by mu (the GMM labels depend on the
    initialisation, which the two packages draw from other streams).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one torch
# thread each, as these small tensors gain nothing from more
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from medgp_tpu.cluster import features as jfeat  # noqa: E402
from medgp_tpu.cluster import gmm as jgmm  # noqa: E402
from medgp_tpu.cluster import kde as jkde  # noqa: E402
from medgp_tpu.cluster import mode as jmode  # noqa: E402
from medgp_tpu.cluster import pipeline as jpipe  # noqa: E402
from medgp_tpu.models import params as jparams  # noqa: E402
from medgp_tpu_torch.cluster import features as tfeat  # noqa: E402
from medgp_tpu_torch.cluster import gmm as tgmm  # noqa: E402
from medgp_tpu_torch.cluster import kde as tkde  # noqa: E402
from medgp_tpu_torch.cluster import mode as tmode  # noqa: E402
from medgp_tpu_torch.cluster import pipeline as tpipe  # noqa: E402
from medgp_tpu_torch.models import params as tparams  # noqa: E402

KDE_REL = 1e-12
EM_REL = 1e-4
CPU = "cpu"


# ---------------------------------------------------------------- KDE

def _samples(seed):
    rng = np.random.default_rng(seed)
    return {
        "bimodal": np.concatenate([rng.normal(size=60) * 0.2 + 2.0,
                                   rng.normal(size=15) * 0.2 - 1.0]),
        "lognormal": np.exp(rng.normal(size=40)),
        "one": np.array([0.7]),
        "degenerate": np.full(9, 3.25),  # sigma = 0: the 1e-6 guard
        "zero_iqr": np.array([1.0] * 6 + [2.0, 5.0]),  # IQR 0: std only
    }


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("case", ["bimodal", "lognormal", "one", "degenerate", "zero_iqr"])
def test_kde_mode_matches_jax(case, weighted):
    x = _samples(3)[case]
    want = jkde.kde_mode(x, weighted=weighted)
    got = tkde.kde_mode(x, weighted=weighted, device=CPU)
    assert got == pytest.approx(want, rel=KDE_REL, abs=0)


def test_kde_mode_on_a_grid_and_gaussian_kde_match_jax():
    """The SE/SM modes' fixed grid of 100,001 points (the JAX package's
    XLA path above 2^20 pairs) and a small cross product (its numpy
    path). Far from the samples the densities fall below float64's
    smallest normal number, where XLA on the CPU flushes to zero and torch
    keeps the subnormal value: the absolute tolerance is that number."""
    x = _samples(4)["lognormal"]
    grid = np.linspace(0.01, 1000.0, 100001)
    for pts in (grid, 1.0 / grid, x[:7]):
        np.testing.assert_allclose(
            tkde.gaussian_kde(x, pts, device=CPU), jkde.gaussian_kde(x, pts),
            rtol=KDE_REL, atol=np.finfo(np.float64).tiny,
        )
    want = jkde.kde_mode(x, weighted=False, eval_points=1.0 / grid)
    assert tkde.kde_mode(x, False, eval_points=1.0 / grid, device=CPU) == want
    assert tkde.silverman_bandwidth(x) == jkde.silverman_bandwidth(x)


@pytest.mark.parametrize("weighted", [True, False])
def test_kde_mode_batch_matches_jax_across_chunks(weighted):
    """450 samples a row: 98 rows a chunk of 2e7 pairs, so 100 rows span
    two chunks; rows 5 and 99 are degenerate (sigma = 0)."""
    rng = np.random.default_rng(5)
    X = np.exp(rng.normal(size=(100, 450)) * rng.uniform(0.1, 2.0, size=(100, 1)))
    X[5] = 2.5
    X[99] = 0.0
    np.testing.assert_allclose(
        tkde.kde_mode_batch(X, weighted=weighted, device=CPU),
        jkde.kde_mode_batch(X, weighted=weighted), rtol=KDE_REL, atol=0,
    )
    # P = 1 and M = 0
    np.testing.assert_array_equal(
        tkde.kde_mode_batch(X[:, :1], device=CPU), jkde.kde_mode_batch(X[:, :1])
    )
    assert tkde.kde_mode_batch(np.zeros((0, 4)), device=CPU).shape == (0,)


def test_kde_log_density_and_grad_matches_jax():
    x = _samples(6)["bimodal"]
    for at in (-1.0, 0.3, 2.1):
        assert tkde.kde_log_density_and_grad(at, 0.4, x) == \
            jkde.kde_log_density_and_grad(at, 0.4, x)


# ---------------------------------------------------------------- GMM

def _blobs(seed, centres, n_per, scale):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal(size=(n_per, len(c))) * scale + np.asarray(c, float)
        for c in centres
    ])


@pytest.mark.parametrize("k", [2, 3])
def test_em_from_shared_centres_matches_jax_fit_single(k):
    """The JAX package's k-means++ + Lloyd centres for one key, then EM
    from them in the port and JAX's `_fit_single` from the same key."""
    X = _blobs(7, [[2.5, 0.0, 1.0], [-2.5, 0.5, 0.0], [0.0, 3.0, -2.0]], 40, 0.6)
    X = X.astype(np.float32)
    Xj, wj = jnp.asarray(X), jnp.ones(len(X), jnp.float32)
    key = jax.random.key(11)
    centres = np.array(jgmm._kmeans_pp_init(key, Xj, wj, k))
    fit = jax.jit(jgmm._fit_single, static_argnums=(3, 4, 5, 6))
    want, want_ll = fit(key, Xj, wj, k, 2000, 1e-3, 1e-6)
    got, got_ll = tgmm.fit_em(torch.as_tensor(X), torch.as_tensor(centres)[None])
    for name, g, w in zip(("weights", "means", "covs"), got, want):
        np.testing.assert_allclose(
            g[0].numpy(), np.asarray(w), rtol=EM_REL, atol=1e-6, err_msg=name
        )
    assert got_ll[0].item() == pytest.approx(float(want_ll), rel=EM_REL)


def test_batched_inits_equal_solo_runs():
    """A loose tol stops members early, far from the fixed point: a member
    that kept running after its own convergence would drift from its
    solo run."""
    X = torch.as_tensor(_blobs(8, [[2.5, 0.0], [-2.5, 0.0]], 40, 0.4), dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    centres = tgmm.kmeans_pp_init(gen, X, 2, 6)
    p_b, ll_b = tgmm.fit_em(X, centres, max_iter=200, tol=0.05)
    for i in range(6):
        p_s, ll_s = tgmm.fit_em(X, centres[i : i + 1], max_iter=200, tol=0.05)
        np.testing.assert_allclose(ll_b[i].item(), ll_s[0].item(), rtol=1e-6)
        np.testing.assert_allclose(p_b.means[i].numpy(), p_s.means[0].numpy(), atol=1e-5)


def test_lloyd_matches_numpy():
    X = _blobs(9, [[3.0, 0.0], [-3.0, 1.0], [0.0, -3.0]], 30, 0.8)
    c0 = X[[0, 1, 2]]  # three centres inside the first blob
    c = c0.copy()
    for _ in range(10):
        d2 = ((X[:, None, :] - c[None]) ** 2).sum(-1)
        onehot = np.eye(3)[d2.argmin(1)]
        c = onehot.T @ X / (onehot.sum(0) + 1e-10)[:, None]
    got = tgmm.lloyd(torch.as_tensor(X, dtype=torch.float32),
                     torch.as_tensor(c0, dtype=torch.float32)[None])
    np.testing.assert_allclose(got[0].numpy(), c, atol=1e-5)
    assert not np.allclose(c, c0)


def _same_partition(a, b):
    """Equal up to a relabelling."""
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def _d73_blobs(seed, n_per=60):
    """Two clusters in 73 dimensions whose spreads lie in complementary
    halves of the axes (a single Gaussian must cover both): BIC picks
    k = 2 at this size."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(2):
        s = np.full(73, 1e-3)
        s[c * 36 : (c + 1) * 36 + c] = 1.0
        out.append(rng.normal(size=(n_per, 73)) * s + 3.0 * c)
    return np.concatenate(out)


@pytest.mark.parametrize("d", [2, 73])
def test_run_gmm_bic_picks_the_jax_k_and_partition(d):
    """Two well-separated clusters; k up to 2 and 3 inits, so that the JAX
    package compiles two EM programs per case."""
    X = _blobs(10, [[3, 3], [-3, -3]], 70, 0.4) if d == 2 else _d73_blobs(11)
    k_j, a_j = jgmm.run_gmm_bic(X, 2, init_num=3, seed=0)
    k_t, a_t = tgmm.run_gmm_bic(X, 2, init_num=3, seed=0, device=CPU)
    assert k_t == k_j == 2
    assert _same_partition(a_t, a_j)


def test_sklearn_algorithm_agrees_on_k():
    X = _blobs(12, [[3, 3], [-3, -3], [3, -3]], 70, 0.4)
    k_t, _ = tgmm.run_gmm_bic(X, 3, init_num=2, seed=0, device=CPU)
    k_s, _ = tgmm.run_gmm_bic(X, 3, init_num=1, algorithm="sklearn")
    assert k_t == k_s == 3


def test_none_algorithm_single_cluster():
    X = np.random.default_rng(13).normal(size=(30, 5))
    k, assign = tgmm.run_clustering_top("None", X, 5, device=CPU)
    assert k == 1 and np.all(assign == 0)
    with pytest.raises(NotImplementedError):
        tgmm.run_clustering_top("kmeans", X, 5, device=CPU)


# ------------------------------------------------------ features, modes

def _hyps(spec, P, seed, spread=0.05):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=spec.n_hyp) * 0.4
    return np.tile(base, (P, 1)) + rng.normal(size=(P, spec.n_hyp)) * spread


def _spec_pair(kind):
    if kind == "LMC-SM":
        return jparams.LMCSMSpec(3, 2, 2), tparams.LMCSMSpec(3, 2, 2)
    if kind == "SM":
        return jparams.SMSpec(3), tparams.SMSpec(3)
    return jparams.SESpec(), tparams.SESpec()


@pytest.mark.parametrize("kind", ["LMC-SM", "SM", "SE"])
def test_extract_kernel_features_is_bitwise_jax(kind):
    jspec, tspec = _spec_pair(kind)
    hyps = _hyps(jspec, 7, 14, spread=1.0)
    if kind == "LMC-SM":  # drop component 1 of patient 0 (max|B_1| ~ 0)
        D, Q, R = 2, 3, 2
        hyps[0, D + D * R : D + 2 * D * R] = 0.0
        hyps[0, D + Q * (D * R + 2) + D : D + Q * (D * R + 2) + 2 * D] = -60.0
    pans = np.asarray([f"p{i}" for i in range(7)])
    want = jfeat.extract_kernel_features(jspec, pans, hyps)
    got = tfeat.extract_kernel_features(tspec, pans, hyps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if kind == "LMC-SM":
        assert got[2].shape == (7 * 3 - 1, 73)


def _lmcsm_two_families(spec, P, seed):
    """Every patient's component 0 near one frequency and component 1 near
    another, far apart."""
    hyps = _hyps(spec, P, seed, spread=1e-3)
    Q, D, R = spec.Q, spec.D, spec.R
    mu0 = D + Q * D * R
    hyps[:, mu0] = np.log(0.05) + hyps[:, mu0] * 0.01
    hyps[:, mu0 + 1] = np.log(0.9) + hyps[:, mu0 + 1] * 0.01
    return hyps


def _assert_modes_close(spec, got, want, rtol):
    """Flat LMC-SM mode thetas, mixture components sorted by mu. The
    kappa block is held as exp(theta) with an absolute bound of 1e-12:
    where R >= D the SVD re-factorization leaves lambda = diag(B - A A^T)
    at rounding level (~1e-16, or the 1e-15 clamp), whose log has no
    stable digits (ROADMAP.md §C)."""
    Q, D, R = spec.Q, spec.D, spec.R

    def blocks(theta):
        A = theta[D : D + Q * D * R].reshape(Q, D, R)
        mu = theta[D + Q * D * R : D + Q * D * R + Q]
        v = theta[D + Q * (D * R + 1) : D + Q * (D * R + 2)]
        kap = np.exp(theta[D + Q * (D * R + 2) :].reshape(Q, D))
        o = np.argsort(mu)
        return dict(noise=theta[:D], A=A[o], mu=mu[o], v=v[o], kappa=kap[o])

    g, w = blocks(got), blocks(want)
    for name in ("noise", "A", "mu", "v"):
        np.testing.assert_allclose(g[name], w[name], rtol=rtol, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(g["kappa"], w["kappa"], rtol=rtol, atol=1e-12)
    return g


@pytest.mark.parametrize("R", [1, 4])  # R = 4 > D = 2: zero-padded A columns
def test_mode_kernel_lmcsm_two_clusters_matches_jax(R):
    """Two given clusters (each patient's component q in cluster q), so
    the mode kernel's per-cluster path runs without a GMM."""
    jspec, tspec = jparams.LMCSMSpec(2, 2, R), tparams.LMCSMSpec(2, 2, R)
    P = 12
    pans = np.asarray([f"p{i:02d}" for i in range(P)])
    hyps = _lmcsm_two_families(jspec, P, 15 + R)
    cp, cq, _ = jfeat.extract_kernel_features(jspec, pans, hyps)
    want = jmode.mode_kernel_lmcsm(jspec, pans, hyps, cp, cq, 2, cq)
    got = tmode.mode_kernel_lmcsm(tspec, pans, hyps, cp, cq, 2, cq, device=CPU)
    g = _assert_modes_close(jparams.LMCSMSpec(2, 2, R), got, want, 1e-10)
    if R > 2:  # the padded columns of A are zero
        assert np.all(g["A"][:, :, 2:] == 0.0)


def _lmcsm_periodic_and_decaying(spec, P, seed):
    """Component 0 periodic (mu spread over 0.05-0.45 per hour, slow
    decay: its 72-point curves span most of the feature axes), component
    1 decaying within two hours (its curves span a few): a single full
    covariance must cover both, so BIC picks two clusters."""
    rng = np.random.default_rng(seed)
    Q, D, R = spec.Q, spec.D, spec.R
    hyps = rng.normal(size=(P, spec.n_hyp)) * 0.1
    mu0 = D + Q * D * R
    v0 = mu0 + Q
    hyps[:, mu0] = np.log(rng.uniform(0.05, 0.45, P))
    hyps[:, v0] = np.log(0.002)
    hyps[:, mu0 + 1] = np.log(rng.uniform(0.001, 0.003, P))
    hyps[:, v0 + 1] = np.log(rng.uniform(0.3, 0.5, P))
    return hyps


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("families,P,k", [
    (_lmcsm_two_families, 12, 1), (_lmcsm_periodic_and_decaying, 40, 2),
], ids=["alike", "apart"])
def test_cluster_kernels_lmcsm_matches_jax(R, families, P, k):
    """Through the GMM, where BIC picks the same k in both packages: one
    cluster for two families that vary along the same few feature axes
    (at 24 components of 73 dimensions a second full covariance does not
    pay), two for families whose curves span different axes. The mode
    kernels agree up to component order."""
    jspec, tspec = jparams.LMCSMSpec(2, 2, R), tparams.LMCSMSpec(2, 2, R)
    pans = np.asarray([f"p{i:02d}" for i in range(P)])
    hyps = families(jspec, P, 15 + R)
    for alg, rtol, want_k in (("None", 1e-10, 1), ("gmm", 1e-5, k)):
        want, qj = jpipe.cluster_kernels(jspec, pans, hyps, algorithm=alg, seed=0)
        got, qt = tpipe.cluster_kernels(tspec, pans, hyps, algorithm=alg, seed=0, device=CPU)
        assert qj == qt == want_k
        assert np.all(np.isfinite(got))
        _assert_modes_close(jparams.LMCSMSpec(qj, 2, R), got, want, rtol)


@pytest.mark.parametrize("kind", ["SM", "SE"])
def test_cluster_kernels_sm_se_match_jax(kind):
    jspec, tspec = _spec_pair(kind)
    P = 10
    pans = np.asarray([f"p{i}" for i in range(P)])
    hyps = _hyps(jspec, P, 16)
    want, qj = jpipe.cluster_kernels(jspec, pans, hyps, algorithm="None")
    got, qt = tpipe.cluster_kernels(tspec, pans, hyps, algorithm="None", device=CPU)
    assert qt == qj
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
