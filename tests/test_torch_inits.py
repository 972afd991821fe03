"""The port's restart inits (medgp_tpu_torch/data/inits.py) against the
JAX package's (medgp_tpu/data/inits.py), for LMC-SM (5, 2, 2), LMC-SM
(5, 24, 8), SE and SM(5):

  * `default_bounds` bitwise;
  * on the JAX package's own integer levels (jax.random.randint of the
    same key and shape), fed to the port through `_draw_levels`, the
    thetas within 1 ulp of float32 of the JAX package's: the blocks are
    the same quantized uniform and transforms, and only the `log` of the
    log blocks differs (torch's against XLA's on the CPU, at most one ulp);
  * the port's levels uniform over 0..4095 (chi-square);
  * every block of the port's thetas at 4,000 restarts against the JAX
    package's (two-sample Kolmogorov-Smirnov, the block's entries pooled),
    as tests/test_varem.py's test_random_inits_distributions draws them.

The two packages draw from other generators (torch.Generator, JAX's
threefry), so only the distributions can agree; every seed is fixed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
stats = pytest.importorskip("scipy.stats")

from medgp_tpu.data import inits as jinits  # noqa: E402
from medgp_tpu.models import params as jparams  # noqa: E402
from medgp_tpu_torch.data import inits as tinits  # noqa: E402
from medgp_tpu_torch.models import params as tparams  # noqa: E402

LEVELS = 4096
P_MIN = 1e-3  # each chi-square and KS p-value at the fixed seeds

# name: (spec args, blocks as (name, width) in flat-theta order)
SPECS = {
    "lmcsm_5_2_2": ("LMCSMSpec", (5, 2, 2)),
    "lmcsm_5_24_8": ("LMCSMSpec", (5, 24, 8)),
    "se": ("SESpec", ()),
    "sm_5": ("SMSpec", (5,)),
}


def specs(name):
    cls, args = SPECS[name]
    return getattr(jparams, cls)(*args), getattr(tparams, cls)(*args)


def blocks(spec):
    """(name, slice) of each block of one transform, in flat-theta order."""
    if isinstance(spec, tparams.LMCSMSpec):
        Q, D, R = spec.Q, spec.D, spec.R
        widths = [("noise", D), ("a", Q * D * R), ("mu", Q), ("v", Q), ("kappa", Q * D)]
    elif isinstance(spec, tparams.SESpec):
        widths = [("noise", 1), ("lengthscale", 1), ("scale", 1)]
    else:
        widths = [("noise", 1), ("w", spec.Q), ("mu", spec.Q), ("v", spec.Q)]
    out, lo = [], 0
    for name, n in widths:
        out.append((name, slice(lo, lo + n)))
        lo += n
    assert lo == spec.n_hyp
    return out


def ulps(a, b):
    """Distance in float32 units in the last place, entrywise."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def jax_inits(jspec, seed, n):
    return np.asarray(jinits.random_inits(
        jax.random.key(seed), jspec, jinits.default_bounds(jspec), n), np.float32)


@pytest.mark.parametrize("name", list(SPECS))
def test_default_bounds_bitwise(name):
    jspec, tspec = specs(name)
    opt = dict(lower_bound_noise=0.05, upper_bound_lambda=0.7)
    for cfg in (None, opt):
        jb, tb = jinits.default_bounds(jspec, cfg), tinits.default_bounds(tspec, cfg)
        for j, t in ((jb.lb, tb.lb), (jb.ub, tb.ub)):
            assert t.dtype == np.float32 and t.shape == (tspec.n_hyp,)
            assert np.asarray(j).tobytes() == t.tobytes()


@pytest.mark.parametrize("name", list(SPECS))
def test_random_inits_on_jax_levels_within_one_ulp(name, monkeypatch):
    """The JAX package's levels through the port's transforms: every entry
    within 1 ulp of float32 of the JAX package's theta (the `log` op)."""
    jspec, tspec = specs(name)
    n, seed = 16, 718
    levels = np.asarray(jax.random.randint(
        jax.random.key(seed), (n, jspec.n_hyp), 0, LEVELS))
    shapes = []

    def given(gen, shape):
        shapes.append(tuple(shape))
        return torch.from_numpy(levels.astype(np.int64))

    monkeypatch.setattr(tinits, "_draw_levels", given)
    got = tinits.random_inits(seed, tspec, tinits.default_bounds(tspec), n).numpy()
    want = jax_inits(jspec, seed, n)
    assert shapes == [(n, tspec.n_hyp)]
    assert got.dtype == np.float32 and got.shape == want.shape
    assert ulps(got, want).max() <= 1
    # the linear A block has no `log`: bitwise there
    for block, sl in blocks(tspec):
        if block == "a":
            assert np.array_equal(got[:, sl], want[:, sl])


@pytest.mark.parametrize("name", list(SPECS))
def test_port_levels_uniform(name, monkeypatch):
    """The levels the port's random_inits draws: all in 0..4095, about 100
    a level, chi-square against uniform."""
    _, tspec = specs(name)
    drawn = []
    own = tinits._draw_levels

    def kept(gen, shape):
        drawn.append(own(gen, shape))
        return drawn[-1]

    monkeypatch.setattr(tinits, "_draw_levels", kept)
    n = -(-100 * LEVELS // tspec.n_hyp)
    tinits.random_inits(3, tspec, tinits.default_bounds(tspec), n)
    k = drawn[0].numpy().ravel()
    assert len(drawn) == 1 and k.size == n * tspec.n_hyp
    assert k.min() == 0 and k.max() == LEVELS - 1
    counts = np.bincount(k, minlength=LEVELS)
    assert stats.chisquare(counts).pvalue > P_MIN


@pytest.mark.parametrize("name", list(SPECS))
def test_random_inits_blocks_match_jax_in_distribution(name):
    """Each block's thetas at 4,000 restarts, the port's draws against the
    JAX package's: a two-sample KS p-value above P_MIN."""
    jspec, tspec = specs(name)
    n = 4000
    got = tinits.random_inits(11, tspec, tinits.default_bounds(tspec), n).numpy()
    want = jax_inits(jspec, 11, n)
    assert got.shape == want.shape == (n, tspec.n_hyp)
    for block, sl in blocks(tspec):
        g, w = got[:, sl].ravel(), want[:, sl].ravel()
        p = stats.ks_2samp(g, w).pvalue
        assert p > P_MIN, f"{name} {block}: KS p = {p:.2e}"
