"""The port's optimizers and train stage against the JAX package.

`scg_minimize`, `varem_train` and `train_one_patient` of the port run a
padded batch as one explicit batch; the JAX package's run one element and
are vmapped. The same numpy inputs go through both.

Tolerances:
  * float64 (the `jax.enable_x64()` context, as tests/test_nlml.py:372
    uses it): the trajectories are the same arithmetic in the same order
    but for reductions (dot products, logdet, the gram's component sum),
    so x, fx and the varEM state agree to 1e-6 relative and the
    evaluation counts exactly;
  * float32, SCG on a GP objective: rounding differences of ~1e-7 grow
    along the line searches, so only the final loss is held, to 1e-3
    relative;
  * the CLI train stage (float32, as the JAX train stage runs): one varEM
    warm round of 100 SCG evaluations per patient from the same inits.
    Flags, counts and the chosen inits agree exactly. The trained hypers
    are not a stable quantity in float32, so the test measures how far
    they move: it trains the cohort with the JAX package twice more, from
    the inits moved by one ulp up and down, and holds each patient's
    train_hyp and train_var_hyp files to ULP_SPREAD_X times the larger of
    the two moves (the port's files were within 2.1 times it on this
    cohort). The trajectories themselves are held exactly in float64 above
    (the same functions the CLI runs), and the NLML at the two trained
    thetas, evaluated alike in float64, to NLML_REL.
"""

import filecmp
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one torch
# thread each, as these small tensors gain nothing from more
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from medgp_tpu.config import experiment as jexp  # noqa: E402
from medgp_tpu.data import cohort as jcohort  # noqa: E402
from medgp_tpu.data import formats as jformats  # noqa: E402
from medgp_tpu.data import inits as jinits  # noqa: E402
from medgp_tpu.infer import map_train as jmap  # noqa: E402
from medgp_tpu.infer import scg as jscg  # noqa: E402
from medgp_tpu.infer import varem as jvarem  # noqa: E402
from medgp_tpu.models import gp as jgp  # noqa: E402
from medgp_tpu.models import params as jparams  # noqa: E402
from medgp_tpu.parallel import runner as jrunner  # noqa: E402
from medgp_tpu_torch.cli import main as tcli  # noqa: E402
from medgp_tpu_torch.config import experiment as texp  # noqa: E402
from medgp_tpu_torch.data import formats as tformats  # noqa: E402
from medgp_tpu_torch.data import synthetic as tsyn  # noqa: E402
from medgp_tpu_torch.infer import map_train as tmap  # noqa: E402
from medgp_tpu_torch.infer import scg as tscg  # noqa: E402
from medgp_tpu_torch.infer import varem as tvarem  # noqa: E402
from medgp_tpu_torch.models import gp as tgp  # noqa: E402
from medgp_tpu_torch.models import params as tparams  # noqa: E402
from medgp_tpu_torch.parallel import runner as trunner  # noqa: E402

Q, D, R = 2, 3, 1
F64_REL = 1e-6
ULP_SPREAD_X = 4.0  # train_hyp / train_var_hyp vs the JAX one-ulp spread (docstring)
NLML_REL = 2e-2  # ~2.5x the largest one-ulp loss spread of the JAX train stage


def _rosen(x, limit, xp):
    """Chained Rosenbrock; evaluations with x[0] > limit fail."""
    v = xp.sum((1 - x[..., :-1]) ** 2 + 100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2, -1)
    return v, x[..., 0] <= limit


def test_scg_matches_jax_on_rosenbrock_float64():
    """Three starts in one batch; one meets a failing region (the
    evaluate-until-finite halving), so the elements leave the inner loops
    at different passes."""
    x0 = np.array([[-1.2, 1.0, 0.5], [0.5, 0.5, 0.5], [2.0, -1.0, 1.0]])
    limit = np.array([10.0, 10.0, 2.2])
    max_evals = 60
    with jax.enable_x64():
        def one(x0, lim):
            def f(x):
                (v, ok), g = jax.value_and_grad(
                    lambda z: _rosen(z, lim, jnp), has_aux=True)(x)
                return v, g, ok
            return jscg.scg_minimize(f, x0, max_evals)

        want = jax.vmap(one)(jnp.asarray(x0), jnp.asarray(limit))
        want = jax.tree.map(np.asarray, want)

    lim_t = torch.as_tensor(limit)

    def f(x, idx):
        x = x.detach().requires_grad_()
        v, ok = _rosen(x, lim_t[idx], torch)
        (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), g, ok

    got = tscg.scg_minimize(f, torch.as_tensor(x0), max_evals)
    assert got.n_evals.tolist() == want.n_evals.tolist()
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=F64_REL, atol=1e-9)
    np.testing.assert_allclose(got.fx.numpy(), want.fx, rtol=F64_REL, atol=1e-12)
    assert got.ok.tolist() == want.ok.tolist()
    f0, _ = _rosen(torch.as_tensor(x0), lim_t, torch)
    assert torch.all(got.fx < f0)  # every start improved


def _patients(seed, n=128, n_valid=(120, 90), dtype=np.float32):
    """Padded synthetic LMC-SM patients drawn from a cluster's kernel."""
    spec = tparams.LMCSMSpec(Q, D, R)
    recs = tsyn.sample_cohort(seed, spec, len(n_valid), n_clusters=1,
                              n_obs_range=(min(n_valid), max(n_valid) + 1))
    B = len(recs)
    t = np.zeros((B, n), dtype)
    y = np.zeros((B, n), dtype)
    meta = np.zeros((B, n), np.int32)
    mask = np.zeros((B, n), dtype)
    for i, r in enumerate(recs):
        t[i, : r.n_obs], y[i, : r.n_obs] = r.t, r.y
        meta[i, : r.n_obs], mask[i, : r.n_obs] = r.meta, 1.0
    return t, y, meta, mask


def _inits(seed, S, dtype=np.float32):
    spec = jparams.LMCSMSpec(Q, D, R)
    return np.asarray(
        jinits.random_inits(jax.random.key(seed), spec, jinits.default_bounds(spec), S)
    ).astype(dtype)


def _jdata(arrs):
    return jgp.PatientData(*(jnp.asarray(x) for x in arrs))


def _tdata(arrs):
    return tgp.PatientData(*(torch.as_tensor(x) for x in arrs))


def test_scg_matches_jax_on_a_gp_objective_float32():
    arrs = _patients(101)
    theta0 = _inits(102, 2)
    jspec, tspec = jparams.LMCSMSpec(Q, D, R), tparams.LMCSMSpec(Q, D, R)
    want = jax.vmap(
        lambda d, th: jscg.scg_minimize(jgp.objective_and_grad(jspec, d), th, 20)
    )(_jdata(arrs), jnp.asarray(theta0))
    got = tscg.scg_minimize(
        tgp.objective_and_grad(tspec, _tdata(arrs)), torch.as_tensor(theta0), 20
    )
    np.testing.assert_allclose(got.fx.numpy(), np.asarray(want.fx), rtol=1e-3)
    assert got.n_evals.tolist() == np.asarray(want.n_evals).tolist() == [20, 20]


def test_varem_train_matches_jax_float64():
    arrs = _patients(103, dtype=np.float64)
    theta0 = _inits(104, 2, np.float64)
    kw = dict(eta=0.01, beta_lam=0.01, outer_iters=3, sub_opt_iter=6,
              warmup_iters=2, warmup_evals=10)
    jspec, tspec = jparams.LMCSMSpec(Q, D, R), tparams.LMCSMSpec(Q, D, R)
    with jax.enable_x64():
        want = jax.vmap(
            lambda d, th: jvarem.varem_train(jspec, d, th, **kw)
        )(_jdata(arrs), jnp.asarray(theta0))
        want = jax.tree.map(np.asarray, want)
    got = tvarem.varem_train(tspec, _tdata(arrs), torch.as_tensor(theta0), **kw)
    np.testing.assert_allclose(got.theta.numpy(), want.theta, rtol=F64_REL, atol=1e-8)
    np.testing.assert_allclose(got.loss.numpy(), want.loss, rtol=F64_REL)
    for name in ("psi", "delta", "phi", "tau"):
        np.testing.assert_allclose(
            getattr(got.state, name).numpy(), getattr(want.state, name),
            rtol=F64_REL, atol=1e-9, err_msg=name,
        )
    np.testing.assert_array_equal(got.prior.ptype.numpy(), want.prior.ptype)
    np.testing.assert_allclose(got.prior.scale.numpy(), want.prior.scale, rtol=F64_REL)
    assert got.n_outer.tolist() == want.n_outer.tolist()
    assert got.ok.tolist() == want.ok.tolist()
    # the flat layout [psi | delta | phi | tau] of train_var_hyp_*.bin
    flat = got.state.flatten().numpy()
    for b in range(2):
        st = jax.tree.map(lambda x: x[b], want.state)
        np.testing.assert_allclose(
            flat[b], np.asarray(jvarem.VarEMState(*st).flatten()), rtol=F64_REL
        )


@pytest.mark.parametrize("prior_mode", [0, 2])
def test_train_one_patient_matches_jax_float64(prior_mode, monkeypatch):
    """Screen + SCG (mode 0) or screen + varEM (mode 2, its first warm
    round of 100 evaluations) for a padded batch; the second patient has
    one output observed once, so it fails the data-quality gate."""
    t, y, meta, mask = _patients(105, dtype=np.float64)
    sel = np.nonzero((meta[1] == 2) & (mask[1] > 0))[0]
    meta[1, sel[1:]] = 0  # output 2 observed once
    arrs = (t, y, meta, mask)
    inits = _inits(106, 6, np.float64)
    kw = dict(prior_mode=prior_mode, eta=0.01, beta_lam=0.01,
              top_iters=12 if prior_mode == 0 else 1, sub_opt_iter=5)
    jspec, tspec = jparams.LMCSMSpec(Q, D, R), tparams.LMCSMSpec(Q, D, R)
    with jax.enable_x64():
        want = jax.vmap(
            lambda d: jmap.train_one_patient(jspec, d, jnp.asarray(inits), **kw)
        )(_jdata(arrs))
        want = jax.tree.map(np.asarray, want)
    # a screen budget of 5 systems: the 12 (patient, restart) pairs in 3 chunks
    monkeypatch.setattr(tmap, "screen_chunk_systems", lambda n, device: 5)
    got = tmap.train_one_patient(tspec, _tdata(arrs), torch.as_tensor(inits), **kw)
    assert got.flag.tolist() == want.flag.tolist() == [True, False]
    np.testing.assert_array_equal(got.init_theta.numpy(), want.init_theta)
    np.testing.assert_allclose(got.theta.numpy(), want.theta, rtol=F64_REL, atol=1e-8)
    np.testing.assert_allclose(got.loss.numpy(), want.loss, rtol=F64_REL)
    assert got.n_obs.tolist() == want.n_obs.tolist()
    np.testing.assert_allclose(
        got.var_state.psi.numpy(), want.var_state.psi, rtol=F64_REL, atol=1e-9
    )


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """A 5-patient cohort on disk and an experiment generated by each
    package with budgets cut to one varEM warm round."""
    root = tmp_path_factory.mktemp("train")
    spec = tparams.LMCSMSpec(Q, 2, R)
    recs = tsyn.sample_cohort(47, spec, 5, n_clusters=1, n_obs_range=(40, 120))
    tsyn.write_reference_format_cohort(str(root / "data" / "synth"), recs, [18, 19])
    opt = dict(random_init_num=8, top_iteration_num=1, iteration_num_per_update=5)
    kw = dict(
        data_root=str(root / "data"), cohort="synth", feature_list=[18, 19],
        Q=Q, R=R, cv_fold_num=2, exp_prefix="train", opt_config=opt,
    )
    cfg_j = jexp.generate_experiment(exp_root=str(root / "jax"), **kw)
    cfg_t = texp.generate_experiment(exp_root=str(root / "torch"), **kw)
    return cfg_j, cfg_t


def _jax_train_from(cfg, recs, inits):
    """{pan: {"hyp", "var_hyp"}} of the JAX train stage from `inits`, not
    written to disk."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrunner, "random_inits", lambda *a: jnp.asarray(inits))
        out = jrunner.train_cohort(cfg, recs, use_mesh=False, write=False)
    return {
        pan: {"hyp": np.asarray(r["theta"], np.float64),
              "var_hyp": np.asarray(r["var_state"], np.float64)}
        for pan, r in out.items() if r["flag"]
    }


def test_cli_train_writes_what_jax_train_cohort_writes(staged, monkeypatch):
    cfg_j, cfg_t = staged
    recs = jcohort.load_cohort(cfg_j.data_dir, cfg_j.pans(), cfg_j.feature_list)
    jrunner.train_cohort(cfg_j, recs, use_mesh=False)
    # the restart set: JAX's draws (the two generators differ)
    inits = np.asarray(jinits.random_inits(
        jax.random.key(cfg_j.random_seed), cfg_j.spec(), cfg_j.bounds(),
        cfg_j.random_init_num,
    ))
    # how far the JAX stage's own results move with its inits one ulp away
    nudged = [
        _jax_train_from(cfg_j, recs, np.nextafter(inits, np.float32(to)))
        for to in (np.inf, -np.inf)
    ]
    monkeypatch.setattr(
        trunner, "random_inits", lambda seed, spec, bounds, S: torch.tensor(inits)
    )
    tcli.main([
        "train", "--cfg", os.path.join(cfg_t.exp_cfg_dir, "exp_setup.json"),
        "--device", "cpu",
    ])
    tspec = tparams.LMCSMSpec(Q, 2, R)
    n_ok = 0
    for rec in recs:
        pan = rec.pan
        pj = jformats.train_paths(cfg_j.exp_train_dir, pan)
        pt = tformats.train_paths(cfg_t.exp_train_dir, pan)
        for k in ("flag", "num", "init"):
            assert filecmp.cmp(pj[k], pt[k], shallow=False), (pan, k)
        if not int(tformats.read_int_txt(pt["flag"])[0]):
            continue
        n_ok += 1
        hj, ht = jformats.read_double_bin(pj["hyp"]), tformats.read_double_bin(pt["hyp"])
        assert ht.shape == hj.shape and np.all(np.isfinite(ht))
        vj = jformats.read_double_bin(pj["var_hyp"])
        vt = tformats.read_double_bin(pt["var_hyp"])
        assert vt.shape == vj.shape
        for k, want, got in (("hyp", hj, ht), ("var_hyp", vj, vt)):
            spread = max(np.abs(nz[pan][k] - want).max() for nz in nudged)
            diff = np.abs(got - want).max()
            assert diff <= ULP_SPREAD_X * spread, (pan, k, diff, spread)
        # both reached equally good points: the NLML of each trained theta,
        # evaluated alike (float64, the port's plain path)
        pad = 128 - rec.n_obs % 128
        data = tgp.PatientData(*(
            torch.as_tensor(np.pad(x, (0, pad)))[None] for x in (
                rec.t.astype(np.float64), rec.y.astype(np.float64), rec.meta,
                np.ones(rec.n_obs),
            )
        ))
        nl, _ = tgp.nlml_fn(tspec, data)(torch.as_tensor(np.stack([ht, hj])))
        np.testing.assert_allclose(nl[0].item(), nl[1].item(), rtol=NLML_REL, err_msg=pan)
    assert n_ok >= 4
    pans_t, hyp_t = tformats.read_train_kernels(cfg_t.exp_train_dir, cfg_t.pans())
    pans_j, hyp_j = jformats.read_train_kernels(cfg_j.exp_train_dir, cfg_j.pans())
    assert pans_t.tolist() == pans_j.tolist()
    assert hyp_t.shape == hyp_j.shape
    with open(os.path.join(cfg_t.exp_log_dir, "metrics.jsonl")) as f:
        lines = [line for line in f if '"stage": "train"' in line]
    assert lines and all('"evaluations"' in line for line in lines)
