"""The port's NUTS against the JAX package.

The bit helpers, the U-turn criterion and the checkpoint bookkeeping take
the same inputs on both sides and are held exactly, and against the brute
force of tests/test_nuts.py:37-76. The sampler is held in distribution
(the random streams differ): at the JAX tests' Gaussian targets and
tolerances, its depth caps (sampling depth at most warmup_max_depth + 1,
ADVICE.md), and on a GP patient, where the port's and the JAX package's
posterior means, from the same MAP start, agree within 4 combined
Monte-Carlo standard errors (tests/test_torch_hmc.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from medgp_tpu.infer import nuts as jnuts  # noqa: E402
from medgp_tpu.models import params as jparams  # noqa: E402
from medgp_tpu_torch.infer import nuts as tnuts  # noqa: E402
from medgp_tpu_torch.infer.streams import patient_streams  # noqa: E402
from medgp_tpu_torch.models import params as tparams  # noqa: E402
from medgp_tpu_torch.models import priors as tpriors  # noqa: E402
from tests.test_nlml import random_theta  # noqa: E402
from tests.test_torch_hmc import (  # noqa: E402
    MU, SIGMA, assert_means_within_mc_error, gaussian_potential, gp_patient,
    jdata, map_start, normal_priors, tdata,
)


def _trailing(n):
    t = 0
    while n & 1:
        t += 1
        n >>= 1
    return t


def test_bit_helpers_match_jax():
    ns = np.arange(64, dtype=np.int32)
    pc = tnuts.popcount(torch.as_tensor(ns), 6).numpy()
    to = tnuts.trailing_ones(torch.as_tensor(ns), 6).numpy()
    np.testing.assert_array_equal(pc, np.asarray(jnuts.popcount(jnp.asarray(ns), 6)))
    np.testing.assert_array_equal(to, np.asarray(jnuts.trailing_ones(jnp.asarray(ns), 6)))
    assert pc.tolist() == [bin(n).count("1") for n in range(64)]
    assert to.tolist() == [_trailing(n) for n in range(64)]


def test_is_turning_matches_jax():
    rng = np.random.default_rng(0)
    r_l, r_r, rho = (rng.normal(size=(200, 5)).astype(np.float32) for _ in range(3))
    im = rng.uniform(0.2, 2.0, size=(200, 5)).astype(np.float32)
    want = np.asarray(jax.vmap(jnuts.is_turning)(*map(jnp.asarray, (r_l, r_r, rho, im))))
    got = tnuts.is_turning(*map(torch.as_tensor, (r_l, r_r, rho, im))).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want)


def test_ckpt_scheme_matches_jax_and_bruteforce():
    """20 trials as 20 rows: the checkpoint stacks and each leaf's turning
    decision against JAX's `ckpt_update_and_check` (vmapped over the rows)
    and against brute force over every binary subtree span that each odd
    leaf completes (tests/test_nuts.py:37-76)."""
    rng = np.random.default_rng(0)
    max_depth, H, rows = 4, 3, 20
    inv_mass = np.ones((rows, H), np.float32)
    rs = rng.normal(size=(rows, 2**max_depth, H)).astype(np.float32)
    cum = np.cumsum(rs, axis=1)

    def brute(i, n):
        if n % 2 == 0:
            return False
        for k in range(1, _trailing(n) + 1):
            lo = n - 2**k + 1
            span = cum[i, n] - (cum[i, lo] - rs[i, lo])
            v_lo, v_n = rs[i, lo], rs[i, n]
            if np.dot(v_lo, span) <= 0 or np.dot(v_n, span) <= 0:
                return True
        return False

    jstep = jax.jit(jax.vmap(
        lambda n, r, rho, rc, rhoc, im: jnuts.ckpt_update_and_check(
            n, r, rho, rc, rhoc, im, max_depth),
        in_axes=(None, 0, 0, 0, 0, 0)))
    j_ck = (jnp.zeros((rows, max_depth, H)), jnp.zeros((rows, max_depth, H)))
    t_ck = (torch.zeros(rows, max_depth, H), torch.zeros(rows, max_depth, H))
    n_turning = 0
    for n in range(2**max_depth):
        *j_ck, j_turn = jstep(jnp.asarray(n, jnp.int32), rs[:, n], cum[:, n], *j_ck, inv_mass)
        *t_ck, t_turn = tnuts.ckpt_update_and_check(
            n, torch.as_tensor(rs[:, n]), torch.as_tensor(cum[:, n]), *t_ck,
            torch.as_tensor(inv_mass), max_depth)
        for a, b in zip(t_ck, j_ck):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert t_turn.tolist() == np.asarray(j_turn).tolist(), n
        assert t_turn.tolist() == [brute(i, n) for i in range(rows)], n
        n_turning += int(t_turn.sum())
    assert n_turning > 0


def test_gaussian_target_moments():
    """tests/test_nuts.py:79-96."""
    res = tnuts.nuts_sample(
        gaussian_potential, torch.zeros(1, 3), patient_streams(0, [0]),
        num_warmup=400, num_samples=1500, max_depth=6, init_step_size=0.1,
    )
    s = res.samples[0].numpy()
    assert float(res.accept_rate) > 0.6
    assert int(res.divergences) == 0
    np.testing.assert_allclose(s.mean(0), MU.numpy(), atol=0.25)
    np.testing.assert_allclose(s.std(0), SIGMA.numpy(), rtol=0.35)
    assert res.host_reads > 0


def test_adaptive_depth_responds_to_scale():
    """tests/test_nuts.py:99-111: on a wide isotropic Gaussian the tree is
    used (mean depth above 1), within the gradient budget of max_depth 7,
    and the sampling depth stays within warmup_max_depth + 1."""
    res = tnuts.nuts_sample(
        lambda x: (0.5 * torch.sum((x / 10.0) ** 2, -1), x / 100.0),
        torch.zeros(1, 4), patient_streams(1, [0]),
        num_warmup=200, num_samples=200, max_depth=7, init_step_size=0.5,
    )
    assert float(res.tree_depth.float().mean()) > 1.0
    assert int(res.n_leapfrog.max()) <= 2**7 - 1
    assert int(res.tree_depth.max()) <= 4 + 1


def standard_normal(x):
    return 0.5 * torch.sum(x * x, -1), x


def test_adaptive_depth_cap_bounds_sampling_depth():
    """tests/test_nuts.py:158-183: the sampling phase doubles at most to
    the warmup's 0.9-quantile depth + 1, and so at most to
    warmup_max_depth + 1 (the JAX package's behaviour, kept: ROADMAP §C);
    the moments survive the truncation."""
    res = tnuts.nuts_sample(
        standard_normal, torch.zeros(1, 8), patient_streams(3, [0]),
        num_warmup=300, num_samples=600, max_depth=7, init_step_size=0.5,
        adapt_depth=True, depth_quantile=0.9,
    )
    depths = res.tree_depth[0].numpy()
    assert depths.max() <= 4 + 1
    assert np.quantile(depths, 0.99) <= np.quantile(depths, 0.9) + 1
    s = res.samples[0, 200:].numpy()
    assert abs(s.mean()) < 0.12
    assert abs(s.var() - 1.0) < 0.25


def test_warmup_depth_cap_moments_survive():
    """tests/test_nuts.py:201-223: warmup capped at depth 3 from a tiny
    step size; the sampling depth is at most 3 + 1 and the moments hold."""
    res = tnuts.nuts_sample(
        standard_normal, torch.zeros(1, 8), patient_streams(11, [0]),
        num_warmup=300, num_samples=600, max_depth=7, init_step_size=1e-3,
        warmup_max_depth=3,
    )
    s = res.samples[0, 200:].numpy()
    assert abs(s.mean()) < 0.12
    assert abs(s.var() - 1.0) < 0.25
    assert int(res.tree_depth.max()) <= 4


def test_depth_uncapped_without_adaptation():
    """tests/test_nuts.py:185-198 and :226-237: adapt_depth off and no
    warmup cap reach max_depth at most."""
    res = tnuts.nuts_sample(
        standard_normal, torch.zeros(2, 4), patient_streams(5, [0, 1]),
        num_warmup=40, num_samples=40, max_depth=5, adapt_depth=False,
        warmup_max_depth=None,
    )
    assert torch.isfinite(res.samples).all()
    assert int(res.tree_depth.max()) <= 5


def test_clamped_hypers_stay_fixed():
    """tests/test_nuts.py:138-155."""
    spec = tparams.LMCSMSpec(1, 2, 1)
    arrs = gp_patient(71, spec, n=25, n_pad=7)
    theta0 = random_theta(np.random.default_rng(72), spec).astype(np.float32)
    theta0[spec.n_lik] = 0.0
    prior = tpriors.clamp_a_elements(
        tpriors.empty_prior(spec.n_hyp), spec,
        torch.as_tensor([True] + [False] * (spec.Q * spec.D * spec.R - 1)),
    )
    res = tnuts.nuts_patient(
        spec, tdata(arrs), torch.as_tensor(theta0)[None],
        patient_streams(3, [0]), prior=prior, num_chains=2,
        num_warmup=40, num_samples=40, max_depth=4, init_step_size=0.005,
    )
    assert res.samples.shape == (1, 2, 40, spec.n_hyp)
    np.testing.assert_array_equal(res.samples[..., spec.n_lik].numpy(), 0.0)
    assert float(res.samples[..., 0].std()) > 0


def test_gp_posterior_means_match_jax():
    """NUTS on a GP patient from the same MAP start in both packages (2
    chains, 100 warmup, 100 draws, max_depth 5)."""
    jspec, spec = jparams.LMCSMSpec(1, 2, 1), tparams.LMCSMSpec(1, 2, 1)
    arrs = gp_patient(81, spec)
    jp, tp = normal_priors(spec.n_hyp)
    theta_map = map_start(spec, arrs, tp, 82)
    kw = dict(num_chains=2, num_warmup=100, num_samples=100, max_depth=5,
              init_step_size=0.005)
    ref = jax.jit(lambda d, th, key: jnuts.nuts_patient(jspec, d, th, key, prior=jp, **kw))(
        jdata(arrs), jnp.asarray(theta_map), jax.random.key(2))
    res = tnuts.nuts_patient(spec, tdata(arrs), torch.as_tensor(theta_map)[None],
                             patient_streams(2, [0]), prior=tp, **kw)
    assert float(res.accept_rate.min()) > 0.3
    assert torch.isfinite(res.samples).all()
    assert int(res.tree_depth.max()) <= 4 + 1
    assert_means_within_mc_error(spec, res.samples[0].numpy(), np.asarray(ref.samples))
