"""The reference (reference/lmcsm.py) against the program at tiny sizes on
the CPU, in float64, and the frozen cohort generator."""

import numpy as np
import torch

from reference import lmcsm

Q, D, R = 2, 3, 2


def _patients(seed, n_pat=3, lo=12, hi=40):
    from benchlib.cohort import make_cohort

    pats, thetas = make_cohort(seed, Q, D, R, n_pat, 2, (lo, hi))
    return pats, thetas


def _padded(pats):
    n = -(-max(len(p.t) for p in pats) // 32) * 32  # the program's kernels take n in 32s
    t = torch.zeros((len(pats), n), dtype=torch.float64)
    y, meta, mask = torch.zeros_like(t), torch.zeros((len(pats), n), dtype=torch.int32), torch.zeros_like(t)
    for i, p in enumerate(pats):
        k = len(p.t)
        t[i, :k], y[i, :k] = torch.as_tensor(p.t).double(), torch.as_tensor(p.y).double()
        meta[i, :k], mask[i, :k] = torch.as_tensor(p.meta), 1.0
    return t, y, meta, mask


def _thetas(thetas, k, seed=0):
    rng = np.random.default_rng(seed)
    th = np.stack([thetas[i % len(thetas)] for i in range(k)])
    return torch.as_tensor(th + 0.05 * rng.normal(size=th.shape))


def test_objective_and_gradient_match_the_program():
    from medgp_tpu_torch.models.gp import PatientData, objective_and_grad
    from medgp_tpu_torch.models.params import LMCSMSpec
    from medgp_tpu_torch.models.priors import hier_gamma_prior

    pats, thetas = _patients(3)
    t, y, meta, mask = _padded(pats)
    th = _thetas(thetas, len(pats))
    spec = LMCSMSpec(Q, D, R)
    prior = hier_gamma_prior(spec, beta_lam=0.01, dtype=torch.float64)
    v_p, g_p, ok_p = objective_and_grad(spec, PatientData(t, y, meta, mask), prior)(th)
    pr = {k: getattr(prior, k) for k in ("active", "exp_tf", "ptype", "loc", "scale")}
    v_r, g_r, ok_r = lmcsm.objective_and_grad(th, t, y, meta, mask.bool(), Q, D, R, pr)
    assert bool(ok_p.all()) and bool(ok_r.all())
    torch.testing.assert_close(v_r, v_p, rtol=1e-10, atol=1e-9)
    torch.testing.assert_close(g_r, g_p, rtol=1e-8, atol=1e-8)


def test_blocked_cholesky_is_the_cholesky():
    g = torch.Generator().manual_seed(1)
    X = torch.randn((2, 150, 150), generator=g, dtype=torch.float64)
    M = X @ X.mT + 150 * torch.eye(150, dtype=torch.float64)
    L, ok = lmcsm.cholesky(M)
    assert bool(ok.all())
    torch.testing.assert_close(L, torch.linalg.cholesky(M))


def test_restart_set_is_the_programs():
    from medgp_tpu_torch.data.inits import default_bounds, random_inits
    from medgp_tpu_torch.models.params import LMCSMSpec

    spec = LMCSMSpec(5, 24, 8)
    lb, ub = lmcsm.default_bounds(24, 5, 8)
    ref = default_bounds(spec)
    assert np.array_equal(lb, ref.lb) and np.array_equal(ub, ref.ub)
    assert torch.equal(lmcsm.random_inits(718, 5, 24, 8, 16), random_inits(718, spec, ref, 16))


def test_online_loop_matches_the_program():
    """`online_with_updates` against `online_impute(update=True)`, both in
    float64, from one mode kernel with its zero A-elements clamped."""
    from medgp_tpu_torch.infer.online import online_impute, unique_times
    from medgp_tpu_torch.models.gp import PatientData
    from medgp_tpu_torch.models.params import LMCSMSpec
    from medgp_tpu_torch.parallel.runner import _test_prior

    pats, thetas = _patients(5, n_pat=3, lo=15, hi=45)
    t, y, meta, mask = _padded(pats)
    spec = LMCSMSpec(Q, D, R)
    mode = torch.as_tensor(thetas[0])
    prior = _test_prior(spec, thetas[0], "cpu")
    prior = prior._replace(loc=prior.loc.double(), scale=prior.scale.double())
    ut = np.zeros(t.shape, np.float64)
    uv = np.zeros(t.shape, bool)
    for i in range(len(pats)):
        ut[i], uv[i] = unique_times(t[i].numpy(), mask[i].numpy(), pad_to=t.shape[1])
    res = online_impute(spec, mode, PatientData(t, y, meta, mask), torch.as_tensor(ut).double(),
                        torch.as_tensor(uv), update=True, prior=prior, learn_rate=1e-3,
                        momentum=0.9)
    pr = {k: getattr(prior, k) for k in ("active", "exp_tf", "ptype", "loc", "scale")}
    pred, var, ci = lmcsm.online_with_updates(mode, t, y, meta, mask.bool(), Q, D, R, pr,
                                              1e-3, 0.9)
    m = mask.bool()
    torch.testing.assert_close(pred[m], res.pred[m], rtol=1e-8, atol=1e-8)
    torch.testing.assert_close(var[m], res.var[m], rtol=1e-8, atol=1e-10)
    assert torch.equal(ci[m], res.ci[m])


def test_cohort_generator_repeats_and_keeps_the_length_set():
    from benchlib.cohort import interleaved_shards, length_set, make_cohort

    a, ta = make_cohort(2**40 + 3, Q, D, R, 12, 2, (20, 60))
    b, tb = make_cohort(2**40 + 3, Q, D, R, 12, 2, (20, 60))
    c, _ = make_cohort(2**40 + 4, Q, D, R, 12, 2, (20, 60))
    assert np.array_equal(ta, tb)
    assert all(np.array_equal(x.y, z.y) and np.array_equal(x.t, z.t) for x, z in zip(a, b))
    assert not all(np.array_equal(x.y, z.y) for x, z in zip(a, c) if len(x.y) == len(z.y))
    assert sorted(len(p.t) for p in a) == sorted(len(p.t) for p in c) == list(length_set(12, 20, 60))
    for p in a:
        assert np.all(np.diff(p.t) >= 0) and np.array_equal(p.meta[:2 * D], np.tile(np.arange(D), 2))
        assert np.all(np.isfinite(p.y))
    shards = interleaved_shards(a, 4)
    assert sorted(p.pan for s in shards for p in s) == sorted(p.pan for p in a)


def test_generator_gram_is_the_programs_synthetic_gram():
    """The gram the generator draws from is the one of the program's numpy
    generator (data/synthetic.py) for the same parameters."""
    from benchlib import cohort

    from medgp_tpu_torch.models.params import LMCSMSpec
    from medgp_tpu_torch.models.gp import PatientData, noiseless_gram

    pats, thetas = _patients(9, n_pat=2)
    t, y, meta, mask = _padded(pats)
    th = torch.as_tensor(thetas[:1]).expand(2, -1)
    K_prog = noiseless_gram(LMCSMSpec(Q, D, R), th, PatientData(t, y, meta, mask))
    K_ref = lmcsm.gram(th, t, meta, Q, D, R)
    m = (mask[:, :, None] * mask[:, None, :]).bool()
    torch.testing.assert_close(K_ref[m], K_prog[m], rtol=1e-10, atol=1e-12)
    assert cohort.REF_PI == lmcsm.REF_PI


def test_varem_replay_follows_the_program(monkeypatch):
    """`reference/varem.py` against the program's `varem_train`, both in
    float64 from the same restarts: each patient's fit evaluates the
    objective as often, at the same points for its first 60 evaluations
    (where arithmetic in another order has not yet parted them), and ends
    at the same loss to 1%."""
    from reference import varem

    from medgp_tpu_torch.infer.varem import varem_train
    from medgp_tpu_torch.models.gp import PatientData, objective_and_grad
    from medgp_tpu_torch.models.params import LMCSMSpec

    pats, _ = _patients(3, n_pat=3, lo=15, hi=45)
    t, y, meta, mask = _padded(pats)
    spec = LMCSMSpec(Q, D, R)
    inits = lmcsm.random_inits(718, Q, D, R, 3).double()
    seen = {i: [] for i in range(3)}

    def factory(pr):
        f = objective_and_grad(spec, PatientData(t, y, meta, mask), pr)

        def g(x, idx=None):
            for j, i in enumerate(range(x.shape[0]) if idx is None else idx.tolist()):
                seen[i].append(x[j].numpy().copy())
            return f(x, idx)
        return g

    res = varem_train(spec, PatientData(t, y, meta, mask), inits, eta=0.01, beta_lam=0.01,
                      outer_iters=2, sub_opt_iter=30, objective_factory=factory)
    orig = varem.objective
    for i, p in enumerate(pats):
        mine = []

        def logged(th, *a):
            mine.append(th[0].numpy().copy())
            return orig(th, *a)
        monkeypatch.setattr(varem, "objective", logged)
        (theta, loss, ok), = varem.fit(inits[i:i + 1].numpy(), [(p.t, p.y, p.meta)],
                                           Q, D, R, 0.01, 0.01, 2, 30, torch.float64, "cpu")
        assert ok and len(mine) == len(seen[i])
        np.testing.assert_allclose(np.stack(mine[:60]), np.stack(seen[i][:60]), atol=1e-7)
        assert abs(loss - float(res.loss[i])) <= 1e-2 * abs(loss)


def test_e_step_is_the_programs():
    from reference import varem

    from medgp_tpu_torch.infer.varem import VarEMState, e_step
    from medgp_tpu_torch.models.params import LMCSMSpec

    rng = np.random.default_rng(4)
    spec = LMCSMSpec(Q, D, R)
    psi, delta = rng.uniform(0.1, 2, (2, Q, D, R))
    phi, tau = rng.uniform(0.1, 2, (2, Q, R))
    a = rng.normal(size=(Q, D, R))
    st = VarEMState(*(torch.as_tensor(x)[None] for x in (psi, delta, phi, tau)))
    fixed = torch.tensor([0.5, 0.5, 0.5, 0.5, 0.01], dtype=torch.float64)
    new, _ = e_step(spec, st, torch.as_tensor(a)[None], fixed)
    mine = varem.e_step(psi, delta, phi, a, 0.01)
    for x, y in zip(mine, (new.psi[0], new.delta[0], new.phi[0])):
        np.testing.assert_allclose(x, y.numpy(), rtol=1e-12)
