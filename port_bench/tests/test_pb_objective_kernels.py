"""The θ prologue and gradient epilogue of the fused LMC-SM objective
(medgp_tpu_torch/ops/objective.py, csrc/theta.cuh) on the card (`card`
marker; skips without one): each kernel against its plain twin at the
canonical width (Q = 5, D = 24, R = 8) under a batched hier-gamma prior
with clamped A-elements, a shared test prior and none, two runs of each
giving the same bits; and the fused objective against the composition the
other specs take, both through the card's kernels.

    python -m pytest -q -p no:cacheprovider -n 0 port_bench/tests/test_pb_objective_kernels.py

Tolerances: the kernels and the twins sum in other orders in float32
(B_q over R by FMA against cuBLAS, the log prior over H by a tree against
torch.sum, the noise cotangent over n), so each output is held to 1e-5 of
its largest entry; the objective's value to 1e-5 relative and its gradient
to 2e-3 of its scale, the tolerances of chip_smoke.py's objective batch.
"""

import numpy as np
import pytest

Q, D, R, K, N = 5, 24, 8, 16, 256
REL = 1e-5
PRIORS = ("hier_gamma_clamped", "test_prior", "no_prior")


def _inputs(dev, kind, seed=7):
    import torch

    from medgp_tpu_torch.models import priors
    from medgp_tpu_torch.models.params import LMCSMSpec, cov_slices

    spec = LMCSMSpec(Q, D, R)
    rng = np.random.default_rng(seed)
    sl = cov_slices(spec)
    th = rng.normal(size=(K, spec.n_hyp)) * 0.3
    th[:, sl["lik"]] = np.log(rng.uniform(0.2, 0.4, size=(K, D)))
    th[:, sl["mu"]] = np.log(1.0 / rng.uniform(12, 72, size=(K, Q)))
    th[:, sl["v"]] = np.log(1.0 / (2 * np.pi * rng.uniform(6, 72, size=(K, Q))))
    th[:, sl["kappa"]] = np.log(rng.uniform(0.01, 0.05, size=(K, Q * D)))
    n_valid = rng.integers(N // 4, N + 1, size=K)
    mask = (np.arange(N)[None, :] < n_valid[:, None]).astype(np.float32)
    t = np.sort(rng.uniform(0, 168, size=(K, N)), axis=1).astype(np.float32) * mask
    meta = (rng.integers(0, D, size=(K, N)) * mask).astype(np.int32)
    y = (rng.normal(size=(K, N)) * mask).astype(np.float32)
    prior = None
    if kind == "hier_gamma_clamped":
        clamp = torch.as_tensor(rng.uniform(size=(K, Q * D * R)) < 0.1, device=dev)
        prior = priors.clamp_a_elements(
            priors.hier_gamma_prior(spec, 0.01, device=dev).expand(K), spec, clamp)
        th[:, sl["a"]][clamp.cpu().numpy()] = 0.0
    elif kind == "test_prior":
        clamp = torch.zeros(Q * D * R, dtype=torch.bool, device=dev)
        clamp[::7] = True
        prior = priors.clamp_a_elements(priors.empty_prior(spec.n_hyp, device=dev), spec, clamp)
    tens = [torch.as_tensor(x, device=dev) for x in (th.astype(np.float32), t, y, meta, mask)]
    return spec, tens, prior


def _assert_close(got, want, name):
    import torch

    assert got.shape == want.shape and got.dtype == want.dtype, name
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert bool(torch.isfinite(got).all()), name
    assert err <= REL * max(scale, 1e-30), f"{name}: max abs err {err} > {REL} x {scale}"


@pytest.mark.card
@pytest.mark.parametrize("kind", PRIORS)
def test_theta_prologue_against_its_twin_and_repeatable(card, kind):
    import torch

    from medgp_tpu_torch.ops import objective

    spec, (th, t, y, meta, mask), prior = _inputs(card, kind)
    out = objective.theta_prologue(th, y, meta, mask, prior, spec)
    again = objective.theta_prologue(th, y, meta, mask, prior, spec)
    want = objective.theta_prologue_plain(th, y, meta, mask, prior, spec)
    torch.cuda.synchronize()
    names = ("B", "mu", "v", "noise", "y_eff", "lp", "n_eff")
    for name, a, b, w in zip(names, out, again, want):
        assert torch.equal(a, b), f"{name}: two runs differ"
        _assert_close(a, w, name)
    assert torch.equal(out[0], out[0].mT), "B_q is not symmetric bitwise"


@pytest.mark.card
@pytest.mark.parametrize("kind", PRIORS)
def test_theta_epilogue_against_its_twin_and_repeatable(card, kind):
    import torch

    from medgp_tpu_torch.models.params import cov_slices
    from medgp_tpu_torch.ops import objective

    spec, (th, t, y, meta, mask), prior = _inputs(card, kind)
    gen = torch.Generator(device=card).manual_seed(11)
    dB = torch.randn((K, Q, D, D), generator=gen, device=card)
    dmu, dv = (torch.randn((K, Q), generator=gen, device=card) for _ in range(2))
    dKm = torch.randn((K, N, N), generator=gen, device=card)
    mult = torch.randint(1, 4, (K,), generator=gen, device=card, dtype=torch.int32)
    d_value = torch.rand(K, generator=gen, device=card)
    ok = torch.rand(K, generator=gen, device=card) < 0.8
    args = (th, dB, dmu, dv, dKm, mult, meta, mask, d_value, ok, prior, spec)
    got = objective.theta_epilogue(*args)
    again = objective.theta_epilogue(*args)
    want = objective.theta_epilogue_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "two runs differ"
    assert torch.all(got[~ok] == 0)
    for name, sl in cov_slices(spec).items():
        _assert_close(got[:, sl], want[:, sl], "dtheta " + name)


@pytest.mark.card
@pytest.mark.parametrize("kind", PRIORS)
def test_fused_objective_against_the_composition_on_the_card(card, kind, monkeypatch):
    import torch

    from medgp_tpu_torch.models import gp
    from medgp_tpu_torch.utils import metrics

    spec, (th, t, y, meta, mask), prior = _inputs(card, kind)
    data = gp.PatientData(t, y, meta, mask)
    before = metrics.snapshot()
    v, g, ok = gp.objective_and_grad(spec, data, prior)(th)
    v2, g2, _ = gp.objective_and_grad(spec, data, prior)(th)
    d = metrics.since(before)
    assert d["objective.fused_systems"] == 2 * K == d["k4.systems"]
    assert d["theta_prologue.launches"] == 2 and d["theta_epilogue.launches"] == 2
    monkeypatch.setattr(gp, "fusable", lambda *a: False)
    vc, gc, okc = gp.objective_and_grad(spec, data, prior)(th)
    torch.cuda.synchronize()
    assert torch.equal(v, v2) and torch.equal(g, g2), "two evaluations differ"
    assert bool(ok.all()) and torch.equal(ok, okc)
    assert float(((v - vc) / vc).abs().max()) <= REL
    assert float((g - gc).abs().max()) <= 2e-3 * float(gc.abs().max())
