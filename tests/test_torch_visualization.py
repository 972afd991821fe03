"""The port's visualization modules against the JAX package's: the numpy
fastkernel oracle bitwise, the port's plain gram twins against fastkernel
at the gram tolerance (1e-4 relative, 1e-5 absolute), the kernel summaries
and their printed text, and the plots' file names (None without
matplotlib)."""

import os

import numpy as np
import pytest
import torch

from medgp_tpu.models import params as jax_params
from medgp_tpu.visualization import fastkernel as jax_fk
from medgp_tpu.visualization import printkernel as jax_pk
from medgp_tpu.visualization import vizkernel as jax_vz
from medgp_tpu_torch.models.params import LMCSMSpec, SESpec, SMSpec
from medgp_tpu_torch.ops import gram
from medgp_tpu_torch.ops.cuda_gram import gram_lmcsm_fused
from medgp_tpu_torch.visualization import fastkernel as fk
from medgp_tpu_torch.visualization import printkernel as pk
from medgp_tpu_torch.visualization import vizkernel as vz

Q, D, R = 3, 4, 2
SPECS = {
    "LMC-SM": (LMCSMSpec(Q, D, R), jax_params.LMCSMSpec(Q, D, R)),
    "SM": (SMSpec(Q), jax_params.SMSpec(Q)),
    "SE": (SESpec(), jax_params.SESpec()),
}


def _theta(rng, spec):
    theta = rng.normal(size=spec.n_hyp) * 0.3
    theta[: spec.n_lik] = np.log(0.3)
    return theta


def _inputs(n=128, seed=718):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 72, size=n)).astype(np.float32).astype(np.float64)
    meta = rng.integers(0, D, size=n)
    return rng, t, meta


def _grams(module, family, theta, t, meta):
    if family == "LMC-SM":
        return [*module.lmcsm_unpack(theta, Q, D, R),
                module.coregional_B(*module.lmcsm_unpack(theta, Q, D, R)[1::3]),
                module.gram_lmcsm(theta, t, meta, Q, D, R)]
    if family == "SM":
        return [module.gram_sm(theta, t, Q)]
    return [module.gram_se(theta, t)]


@pytest.mark.parametrize("family", sorted(SPECS))
def test_fastkernel_bitwise_jax(family):
    rng, t, meta = _inputs(n=40)
    theta = _theta(rng, SPECS[family][0])
    for got, want in zip(_grams(fk, family, theta, t, meta),
                         _grams(jax_fk, family, theta, t, meta)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    rsq = fk.squared_dist(t, t[::-1])
    assert np.array_equal(rsq, jax_fk.squared_dist(t, t[::-1]))
    assert np.array_equal(fk.sm_response(rsq, 0.05, 0.02), jax_fk.sm_response(rsq, 0.05, 0.02))
    assert np.array_equal(fk.se_response(rsq, 6.0, 1.3), jax_fk.se_response(rsq, 6.0, 1.3))
    assert fk.REF_PI == jax_fk.REF_PI


def _twin(family, spec, theta, t, meta):
    """The port's plain gram (float32 torch on the CPU) from flat theta."""
    th = torch.as_tensor(theta, dtype=torch.float32)
    tt = torch.as_tensor(t, dtype=torch.float32)
    p = spec.unpack(th)
    if family == "LMC-SM":
        B = spec.coregional_B(p["A"], p["kappa"])
        K = gram_lmcsm_fused(tt[None], torch.as_tensor(meta, dtype=torch.int32)[None],
                             B[None], p["mu"][None], p["v"][None])[0]
    elif family == "SM":
        K = gram.gram_sm(tt, p["w"], p["mu"], p["v"])
    else:
        K = gram.gram_se(tt, p["lengthscale"], p["scale"])
    return K.double().numpy()


@pytest.mark.parametrize("family", sorted(SPECS))
def test_port_gram_twin_matches_fastkernel(family):
    rng, t, meta = _inputs()
    spec = SPECS[family][0]
    theta = _theta(rng, spec)
    want = _grams(fk, family, theta, t, meta)[-1]
    np.testing.assert_allclose(_twin(family, spec, theta, t, meta), want,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", sorted(SPECS))
def test_printkernel_matches_jax(family, capsys):
    spec, jax_spec = SPECS[family]
    theta = _theta(np.random.default_rng(5), spec)
    assert pk.kernel_summary(spec, theta) == jax_pk.kernel_summary(jax_spec, theta)
    pk.print_kernel_info(spec, theta)
    got = capsys.readouterr().out
    jax_pk.print_kernel_info(jax_spec, theta)
    assert got == capsys.readouterr().out and got.count("\n") >= 1
    with pytest.raises(TypeError):
        pk.kernel_summary(object(), theta)


def _plot_calls(rng):
    """Each vizkernel entry point with the arguments of one call, in a
    form both packages take (the KDE on the CPU in the port)."""
    lmc = LMCSMSpec(2, 3, 1)
    th_lmc = rng.normal(size=lmc.n_hyp) * 0.3
    th_se, th_sm = rng.normal(size=3), rng.normal(size=1 + 3 * 2)
    kr = np.arange(0, 240) / 10.0
    return {
        "plot_kde_hist": (lambda d: ((rng.normal(size=100), d, "kde_test"), {}),
                          {"device": "cpu"}),
        "plot_cluster_scatter": (lambda d: ((rng.uniform(10, 100, 30), rng.uniform(5, 80, 30),
                                             rng.integers(0, 2, 30), d), {}), {}),
        "plot_1d_kernel": (lambda d: ((kr, np.cos(kr), d), {"name": "k1"}), {}),
        "plot_2d_kernel": (lambda d: ((rng.normal(size=(4, 4)), d), {"name": "k2"}), {}),
        "plot_one_kernel": (lambda d: (("LMC-SM", th_lmc, d),
                                       {"prefix": "mode_", "Q": 2, "D": 3, "R": 1}), {}),
        "plot_one_lmcsm": (lambda d: ((lmc, th_lmc, d), {"prefix": "m_", "krange": kr}), {}),
        "plot_one_se": (lambda d: ((th_se, d), {}), {}),
        "plot_one_sm": (lambda d: ((th_sm, d), {"Q": 2}), {}),
        "plot_lmcsm_kernel": (lambda d: ((lmc, th_lmc, d), {}), {}),
    }


def _jax_args(args):
    """The JAX package's spec in place of the port's."""
    return tuple(jax_params.LMCSMSpec(a.Q, a.D, a.R) if isinstance(a, LMCSMSpec) else a
                 for a in args)


@pytest.mark.parametrize("entry", sorted(_plot_calls(np.random.default_rng(0))))
def test_vizkernel_file_names(entry, tmp_path, monkeypatch):
    make, port_only = _plot_calls(np.random.default_rng(3))[entry]
    args, kw = make(str(tmp_path / "port"))
    got = getattr(vz, entry)(*args, **kw, **port_only)
    jargs, jkw = make(str(tmp_path / "jax"))
    want = getattr(jax_vz, entry)(*_jax_args(jargs), **jkw)
    names = lambda ps: [os.path.basename(p) for p in ([ps] if isinstance(ps, str) else ps)]
    assert got and names(got) == names(want)
    assert all(os.path.exists(p) for p in ([got] if isinstance(got, str) else got))
    monkeypatch.setattr(vz, "_HAS_MPL", False)
    args, kw = make(str(tmp_path / "off"))
    assert getattr(vz, entry)(*args, **kw, **port_only) is None
    assert not os.path.exists(tmp_path / "off")


def test_vizkernel_one_kernel_families(tmp_path):
    """The per-family dispatcher's file sets (vizkernel.py:119-365), and
    its refusal of an unknown family."""
    rng = np.random.default_rng(9)
    spec = LMCSMSpec(2, 3, 1)
    paths = vz.plot_one_kernel("LMC-SM", rng.normal(size=spec.n_hyp) * 0.3,
                               str(tmp_path), prefix="mode_", Q=2, D=3, R=1)
    assert sorted(os.path.basename(p) for p in paths) == sorted(
        f"mode_{k}_{q}.pdf" for q in range(2)
        for k in ("a_matrix", "lam_matrix", "b_matrix", "sm_1d"))
    with pytest.raises(NotImplementedError):
        vz.plot_one_kernel("RBF", np.zeros(3), str(tmp_path))
