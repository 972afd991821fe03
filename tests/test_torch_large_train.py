"""The port's row-blocked large-patient path against the JAX package's.

The JAX package row-shards one large patient over the 8-device CPU mesh of
tests/conftest.py (`medgp_tpu/parallel/mesh.py`); the port walks P row
blocks on one device (`medgp_tpu_torch/parallel/mesh.py`), here with P = 8
on the CPU, where K3 and K5 are their plain twins. The same numpy inputs
go through both. The port's blocks are a multiple of 32 rows (K3's
block), so its inputs carry more mask-0 padding than the JAX mesh's; the
NLML does not depend on it.

Tolerances: value 1e-4 relative, gradients 2e-3 (tests/test_large_train.py's
bounds between the mesh and the single-device objective), 1e-8 where both
run in float64. The timestamp cotangent is NaN in every entry in both
packages (sqrt's derivative at the zero distance of the diagonal), so it is
held NaN for NaN.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from medgp_tpu.data import inits as jinits  # noqa: E402
from medgp_tpu.infer import large_train as jlarge  # noqa: E402
from medgp_tpu.infer import varem as jvarem  # noqa: E402
from medgp_tpu.models import gp as jgp  # noqa: E402
from medgp_tpu.models import params as jparams  # noqa: E402
from medgp_tpu.models import priors as jpriors  # noqa: E402
from medgp_tpu.parallel import mesh as jmesh  # noqa: E402
from medgp_tpu_torch.config import experiment as texp  # noqa: E402
from medgp_tpu_torch.data import cohort as tcohort  # noqa: E402
from medgp_tpu_torch.data import formats as tformats  # noqa: E402
from medgp_tpu_torch.data import synthetic as tsyn  # noqa: E402
from medgp_tpu_torch.infer import large_train as tlarge  # noqa: E402
from medgp_tpu_torch.infer import varem as tvarem  # noqa: E402
from medgp_tpu_torch.models import gp as tgp  # noqa: E402
from medgp_tpu_torch.models import params as tparams  # noqa: E402
from medgp_tpu_torch.models import priors as tpriors  # noqa: E402
from medgp_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from medgp_tpu_torch.parallel import runner as trunner  # noqa: E402
from medgp_tpu_torch.utils import hbm  # noqa: E402
from tests.test_nlml import random_theta  # noqa: E402
from tests.test_varem import synth_lmcsm_patient  # noqa: E402

VALUE_REL = 1e-4
GRAD_TOL = 2e-3
F64_TOL = 1e-8
P = 8
Q, D, R = 2, 2, 1


def port_args(d, n_live, dtype=torch.float32):
    """The JAX patient's live rows, padded for P blocks as the port pads."""
    t, y, meta = (np.asarray(x)[:n_live] for x in (d.t, d.y, d.meta))
    b = hbm.large_block_plan(n_live, 0, Q, blocks=P)[1]
    tp, yp, mp, maskp = tlarge.pad_observations(t, y, meta, P * b)
    return (torch.as_tensor(tp, dtype=dtype), torch.as_tensor(yp, dtype=dtype),
            torch.as_tensor(mp), torch.as_tensor(maskp, dtype=dtype))


@pytest.fixture(scope="module")
def case():
    """Two patients of LMC-SM(2, 2, 1) with their JAX mesh callables, built
    once: one of 64 observations, one of 40 with 24 mask-0 rows."""
    rng = np.random.default_rng(11)
    spec = jparams.LMCSMSpec(Q, D, R)
    full = synth_lmcsm_patient(rng, spec, n=64)
    padded = synth_lmcsm_patient(rng, spec, n=40, n_pad=24)
    theta = random_theta(rng, spec).astype(np.float32)
    mesh = jmesh.cohort_mesh()
    return dict(
        spec=spec, tspec=tparams.LMCSMSpec(Q, D, R), mesh=mesh,
        data={"full": (full, 64), "padded": (padded, 40)}, theta=theta,
        jnlml=jmesh.large_patient_nlml(spec, mesh),
        jdiff=jmesh.large_patient_nlml_diff(spec, mesh),
    )


@pytest.mark.parametrize("which", ["full", "padded"])
def test_nlml_matches_jax(case, which):
    d, n = case["data"][which]
    want, wok = case["jnlml"](jnp.asarray(case["theta"]), d.t, d.y, d.meta, d.mask)
    got, ok = tmesh.large_patient_nlml(case["tspec"], P)(
        torch.as_tensor(case["theta"]), *port_args(d, n))
    assert bool(ok) and bool(wok)
    assert got.item() == pytest.approx(float(want), rel=VALUE_REL)


def test_nlml_diff_cotangents_match_jax(case):
    """Value, theta gradient and the t and y cotangents against the JAX
    custom VJP (tests/test_large_train.py:29-49, 222-249)."""
    d, n = case["data"]["full"]
    jcall = case["jdiff"]

    def jloss(th, t, y):
        return jcall(th, t, y, d.meta, d.mask)[0]

    jv, (jth, jt, jy) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(case["theta"]), d.t, d.y)
    t, y, meta, mask = port_args(d, n)
    th = torch.as_tensor(case["theta"]).requires_grad_()
    t.requires_grad_()
    y.requires_grad_()
    v, ok = tmesh.large_patient_nlml_diff(case["tspec"], P)(th, t, y, meta, mask)
    v.backward()
    assert bool(ok)
    assert v.item() == pytest.approx(float(jv), rel=VALUE_REL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jth), rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(y.grad.numpy()[:n], np.asarray(jy), rtol=GRAD_TOL, atol=GRAD_TOL)
    assert np.all(y.grad.numpy()[n:] == 0)
    assert np.isnan(np.asarray(jt)).all() and torch.isnan(t.grad[:n]).all()


def test_nlml_diff_matches_jax_in_float64(case):
    """The port's blocked NLML and theta gradient in float64 against the
    JAX package's dense objective in float64 (`models/gp.py:
    objective_and_grad`, the function the mesh path reproduces), to 1e-8:
    the JAX mesh path itself does not trace with x64 on (ROADMAP §C)."""
    d, n = case["data"]["padded"]
    with jax.enable_x64():
        data = jgp.PatientData(*(jnp.asarray(np.asarray(x)[:n], dt) for x, dt in zip(
            (d.t, d.y, d.meta, d.mask), (jnp.float64, jnp.float64, jnp.int32, jnp.float64))))
        jv, jg, jok = jgp.objective_and_grad(case["spec"], data)(
            jnp.asarray(case["theta"], jnp.float64))
        jv, jg = float(jv), np.asarray(jg)
    th = torch.as_tensor(case["theta"], dtype=torch.float64).requires_grad_()
    v, ok = tmesh.large_patient_nlml_diff(case["tspec"], P)(
        th, *port_args(d, n, torch.float64))
    v.backward()
    assert bool(ok) and bool(jok)
    assert v.item() == pytest.approx(jv, rel=F64_TOL)
    np.testing.assert_allclose(th.grad.numpy(), jg, rtol=F64_TOL, atol=F64_TOL * np.abs(jg).max())


def test_objective_with_prior_and_padding_matches_jax(case):
    d, n = case["data"]["padded"]
    jf = jmesh.large_patient_objective(
        case["spec"], case["mesh"], d.t, d.y, d.meta, d.mask,
        prior=jpriors.hier_gamma_prior(case["spec"], beta_lam=0.01))
    jv, jg, jok = jf(jnp.asarray(case["theta"]))
    f = tmesh.large_patient_objective(
        case["tspec"], P, *port_args(d, n),
        prior=tpriors.hier_gamma_prior(case["tspec"], beta_lam=0.01))
    v, g, ok = f(torch.as_tensor(case["theta"])[None])
    assert v.shape == (1,) and g.shape == (1, case["tspec"].n_hyp) and ok.tolist() == [True]
    assert bool(jok)
    assert v.item() == pytest.approx(float(jv), rel=VALUE_REL)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(jg), rtol=GRAD_TOL, atol=GRAD_TOL)


def test_jitter_retry_recovers_near_singular(case):
    """Duplicate timestamps and tiny noise fail the first factorization; the
    retry recovers ok with a finite value and gradient in both packages
    (tests/test_large_train.py:97-125). Which multiplier first succeeds
    depends on float32 rounding, so the values are not compared."""
    rng = np.random.default_rng(3)
    spec = jparams.LMCSMSpec(1, 2, 1)
    n = 64
    t = np.repeat(np.sort(rng.uniform(0, 72, size=n // 4)), 4)
    meta = np.tile(np.arange(2), n // 2)
    y = rng.normal(size=n)
    theta = random_theta(rng, spec).astype(np.float32)
    theta[: spec.n_lik] = np.log(1e-4)
    jargs = (jnp.asarray(t, jnp.float32), jnp.asarray(y, jnp.float32),
             jnp.asarray(meta, jnp.int32), jnp.ones(n, jnp.float32))
    jv, jok = jmesh.large_patient_nlml(spec, case["mesh"])(jnp.asarray(theta), *jargs)
    jg = jax.grad(lambda x: jmesh.large_patient_nlml_diff(spec, case["mesh"])(x, *jargs)[0])(
        jnp.asarray(theta))
    assert bool(jok) and np.isfinite(float(jv)) and np.isfinite(np.asarray(jg)).all()

    tspec = tparams.LMCSMSpec(1, 2, 1)
    targs = tuple(torch.as_tensor(a) for a in tlarge.pad_observations(t, y, meta, P * 32))
    th = torch.as_tensor(theta).requires_grad_()
    first = tmesh._factor_with_retry(tspec, th.detach(), *targs, 32, 0)
    assert not first[2], "the first factorization should fail"
    v, ok = tmesh.large_patient_nlml_diff(tspec, P)(th, *targs)
    v.backward()
    assert bool(ok) and np.isfinite(v.item()) and torch.isfinite(th.grad).all()


def test_screen_matches_single_calls_and_jax(case):
    d, n = case["data"]["full"]
    spec = case["spec"]
    inits = np.array(jinits.random_inits(
        jax.random.key(3), spec, jinits.default_bounds(spec), 4))
    jvals, joks = jmesh.large_patient_screen(spec, case["mesh"])(
        jnp.asarray(inits), d.t, d.y, d.meta, d.mask)
    args = port_args(d, n)
    vals, oks = tmesh.large_patient_screen(case["tspec"], P)(torch.as_tensor(inits), *args)
    single = tmesh.large_patient_nlml(case["tspec"], P)
    for s in range(4):
        v, ok = single(torch.as_tensor(inits[s]), *args)
        assert bool(oks[s]) == bool(ok) == bool(joks[s])
        assert vals[s].item() == v.item()
        assert vals[s].item() == pytest.approx(float(jvals[s]), rel=VALUE_REL)


ULP_SPREAD_X = 4.0  # as tests/test_torch_train.py


def test_train_one_large_patient_matches_jax():
    """From the same inits: the flag, the screen's chosen init exactly and
    var_state's [psi | delta | phi | tau] layout. The final loss in float32
    is held within 1% or ULP_SPREAD_X times the JAX package's own move when
    its inits move by one ulp, whichever is larger: on this patient the
    JAX mesh path moves by 1.4% against itself (ROADMAP §C). The float64
    test below holds the trajectory itself."""
    rng = np.random.default_rng(5)
    spec = jparams.LMCSMSpec(1, 2, 1)
    d = synth_lmcsm_patient(rng, spec, n=96)
    inits = np.asarray(jinits.random_inits(
        jax.random.key(0), spec, jinits.default_bounds(spec), 3))
    t, y, meta = (np.asarray(x) for x in (d.t, d.y, d.meta))
    kw = dict(prior_mode=2, eta=0.01, beta_lam=0.01, top_iters=2, sub_opt_iter=8)
    mesh = jmesh.cohort_mesh()
    want, *moved = (
        jlarge.train_one_large_patient(spec, t, y, meta, mesh, jnp.asarray(x), **kw)
        for x in (inits, np.nextafter(inits, np.inf), np.nextafter(inits, -np.inf)))
    got = tlarge.train_one_large_patient(
        tparams.LMCSMSpec(1, 2, 1), t, y, meta, torch.as_tensor(inits),
        blocks=P, device="cpu", **kw)
    assert got["flag"] and want["flag"]
    assert got["n_obs"] == want["n_obs"] == 96
    np.testing.assert_array_equal(got["init_theta"], np.asarray(want["init_theta"]))
    spread = max(abs(m["loss"] - want["loss"]) for m in moved)
    assert abs(got["loss"] - want["loss"]) <= max(1e-2 * abs(want["loss"]), ULP_SPREAD_X * spread)
    assert got["var_state"].shape == want["var_state"].shape == (2 * 1 * (2 * 1 + 1),)
    assert got["theta"].shape == (spec.n_hyp,) and got["theta"].dtype == np.float64


def test_varem_over_the_blocked_objective_matches_jax_in_float64():
    """The trainer's optimizer in float64: varEM through the
    `objective_factory` hook over `large_patient_objective` (P = 8) against
    the JAX package's dense varEM from the same init, 200 SCG evaluations:
    the same count, the loss within 1e-6 relative."""
    rng = np.random.default_rng(5)
    spec = jparams.LMCSMSpec(1, 2, 1)
    d = synth_lmcsm_patient(rng, spec, n=96)
    theta0 = np.asarray(jinits.random_inits(
        jax.random.key(0), spec, jinits.default_bounds(spec), 1))[0].astype(np.float64)
    t, y, meta = (np.asarray(x) for x in (d.t, d.y, d.meta))
    kw = dict(eta=0.01, beta_lam=0.01, outer_iters=2, sub_opt_iter=8)
    with jax.enable_x64():
        data = jgp.PatientData(jnp.asarray(t, jnp.float64), jnp.asarray(y, jnp.float64),
                               jnp.asarray(meta), jnp.ones(96, jnp.float64))
        want = jvarem.varem_train(spec, data, jnp.asarray(theta0), **kw)
        want_loss = float(want.loss)
    tspec = tparams.LMCSMSpec(1, 2, 1)
    tp, yp, mp, maskp = tlarge.pad_observations(t, y, meta, P * 32)
    pad = len(tp) - 96
    args = (torch.as_tensor(np.pad(t.astype(np.float64), (0, pad))),
            torch.as_tensor(np.pad(y.astype(np.float64), (0, pad))),
            torch.as_tensor(mp), torch.as_tensor(maskp, dtype=torch.float64))
    base = tmesh.large_patient_nlml_diff(tspec, P)
    got = tvarem.varem_train(
        tspec, tgp.PatientData(*(a[None] for a in args)), torch.as_tensor(theta0)[None],
        objective_factory=lambda pr: tmesh.large_patient_objective(
            tspec, P, *args, prior=pr, base=base), **kw)
    assert got.n_evals.item() == 200
    assert got.loss.item() == pytest.approx(want_loss, rel=1e-6)


def _cohort(tmp_path, kernel, seed=7, features=(18, 19)):
    """Three patients of 20-30 observations, the first tiled four times
    (tests/test_large_train.py:161-220), under the port's `generate`."""
    recs = tsyn.sample_cohort(seed, tparams.LMCSMSpec(1, len(features), 1), n_patients=3,
                              n_clusters=1, n_obs_range=(20, 30))
    big = recs[0]
    big.t = np.sort(np.concatenate([big.t + i * 100 for i in range(4)]))
    big.y = np.tile(big.y, 4)
    big.meta = np.tile(big.meta, 4)
    data_root = str(tmp_path / "data")
    tsyn.write_reference_format_cohort(os.path.join(data_root, "synth"), recs, list(features))
    cfg = texp.generate_experiment(
        data_root=data_root, exp_root=str(tmp_path / "exp"), cohort="synth",
        feature_list=list(features), kernel=kernel, prior="hier-gamma",
        Q=1, R=1, eta=0.01, beta_lam=0.01, cv_fold_num=2, exp_prefix="lg",
        opt_config=dict(random_init_num=3, top_iteration_num=2, iteration_num_per_update=8),
    )
    records = tcohort.load_cohort(cfg.data_dir, cfg.pans(), cfg.feature_list)
    return cfg, records


def _stage(cfg, stage):
    with open(os.path.join(cfg.exp_log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["stage"] == stage]


def test_runner_routes_large_patients(tmp_path):
    """A low threshold sends the longest LMC-SM patient through the
    row-blocked path: one `train_large` record with devices 1 after the
    bucket, and the same train files as every other patient, in the JAX
    runner's format (tests/test_large_train.py:161-220, 272-320)."""
    cfg, records = _cohort(tmp_path, "LMC-SM")
    big_n = max(r.n_obs for r in records)
    big = next(r.pan for r in records if r.n_obs == big_n)
    out = trunner.train_cohort(cfg, records, large_threshold=big_n - 1, device="cpu")
    assert set(out) == {r.pan for r in records} and out[big]["flag"]
    assert np.isfinite(out[big]["loss"]) and out[big]["n_obs"] == big_n
    (rec,) = _stage(cfg, "train_large")
    assert (rec["pan"], rec["n_obs"], rec["devices"], rec["trained"]) == (big, big_n, 1, 1)
    assert sum(r["batch"] for r in _stage(cfg, "train")) == len(records) - 1
    names = sorted(os.listdir(cfg.exp_train_dir))
    for pan in out:
        assert [x for x in names if x.endswith(f"_{pan}.bin") or x.endswith(f"_{pan}.txt")] == [
            f"train_flag_{pan}.txt", f"train_hyp_{pan}.bin", f"train_init_hyp_{pan}.bin",
            f"train_num_{pan}.txt", f"train_var_hyp_{pan}.bin"]
    pans, hyps = tformats.read_train_kernels(cfg.exp_train_dir, [big])
    assert list(pans) == [big]
    np.testing.assert_allclose(hyps[0], out[big]["theta"], rtol=1e-6)
    sizes = {os.path.getsize(os.path.join(cfg.exp_train_dir, f"train_{k}_{big}.bin"))
             for k in ("hyp", "init_hyp")}
    assert sizes == {8 * cfg.spec().n_hyp}


@pytest.mark.parametrize("kernel", ["SE", "SM"])
def test_se_and_sm_patients_above_the_threshold_stay_bucketed(tmp_path, kernel):
    cfg, records = _cohort(tmp_path, kernel, seed=8, features=(18,))
    thr = max(r.n_obs for r in records) - 1
    out = trunner.train_cohort(cfg, records, large_threshold=thr, write=False, device="cpu")
    assert set(out) == {r.pan for r in records}
    assert _stage(cfg, "train_large") == []
    assert sum(r["batch"] for r in _stage(cfg, "train")) == len(records)


def test_value_and_gradient_hold_no_square_buffer():
    """Under a dispatch mode that records every op's output, one
    value+gradient at n = 128, P = 8 makes no tensor of n^2 elements or
    more (tests/test_large_train.py's HLO check, for the port)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Sizes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.largest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for x in torch.utils._pytree.tree_leaves(out):
                if isinstance(x, torch.Tensor):
                    self.largest = max(self.largest, x.numel())
            return out

    rng = np.random.default_rng(2)
    spec = tparams.LMCSMSpec(1, 2, 1)
    n = 128
    t = np.sort(rng.uniform(0, 72, n))
    meta = rng.integers(0, 2, n)
    y = rng.normal(size=n)
    args = tuple(torch.as_tensor(a) for a in tlarge.pad_observations(t, y, meta, P * 32))
    f = tmesh.large_patient_objective(
        spec, P, *args, prior=tpriors.hier_gamma_prior(spec, beta_lam=0.01))
    theta = torch.as_tensor(random_theta(rng, spec).astype(np.float32))[None]
    with Sizes() as sizes:
        v, g, ok = f(theta)
    assert bool(ok) and torch.isfinite(g).all()
    assert 0 < sizes.largest < n * n


def test_result_does_not_depend_on_the_block_count():
    rng = np.random.default_rng(4)
    spec = tparams.LMCSMSpec(Q, D, R)
    n = 200
    t = np.sort(rng.uniform(0, 72, n))
    meta = rng.integers(0, D, n)
    y = rng.normal(size=n)
    theta = torch.as_tensor(random_theta(rng, spec).astype(np.float32))[None]
    prior = tpriors.hier_gamma_prior(spec, beta_lam=0.01)
    got = {}
    for blocks in (2, 4, 8):
        n_pad = hbm.large_block_plan(n, 0, Q, blocks=blocks)[2]
        args = tuple(torch.as_tensor(a) for a in tlarge.pad_observations(t, y, meta, n_pad))
        got[blocks] = tmesh.large_patient_objective(spec, blocks, *args, prior=prior)(theta)
    v8, g8, _ = got[8]
    for blocks in (2, 4):
        v, g, ok = got[blocks]
        assert bool(ok)
        assert v.item() == pytest.approx(v8.item(), rel=VALUE_REL)
        np.testing.assert_allclose(g.numpy(), g8.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
    # and the dense objective on the patient padded to K3's block
    data = tgp.PatientData(*(torch.as_tensor(a)[None] for a in tlarge.pad_observations(
        t, y, meta, 32)))
    vd, gd, _ = tgp.objective_and_grad(spec, data, prior)(theta)
    assert vd.item() == pytest.approx(v8.item(), rel=VALUE_REL)
    np.testing.assert_allclose(gd.numpy(), g8.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("n", [1, 100, 4096, 16384, 65536, 100000])
def test_block_plan_obeys_its_rule(n):
    free = 80 * 2**30
    P, b, n_pad = hbm.large_block_plan(n, free, 5)
    assert b % 32 == 0 and 32 <= b <= hbm.LARGE_BLOCK_MAX
    assert n_pad == P * b >= n and n_pad - n < 32 * P
    assert hbm.large_patient_bytes(n_pad, b, 5) <= hbm.LARGE_SHARE * free
    assert hbm.large_block_plan(n, free, 5, blocks=4)[0] == 4


def test_block_plan_raises_when_nothing_fits():
    with pytest.raises(MemoryError):
        hbm.large_block_plan(100000, 2**30, 5)
    assert hbm.large_block_plan(100000, 2**30 * 24, 5)[1] < hbm.LARGE_BLOCK_MAX
