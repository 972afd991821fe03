"""The port's cohort sampler runner (`hmc_cohort`), its CLI (`hmc`,
`run --sampler`) and `pack_patients(footprint_mult=...)` against the JAX
package.

The cohort is tests/test_torch_pipeline.py's: 8 synthetic patients, LMC-SM
Q=2, D=2, R=1, trained once by the port's CLI `train` at cut budgets.

What the runner writes does not depend on how the draws were made, so its
files are held to the JAX package's with both packages' samplers replaced
by one set of fixed draws (theta0 plus numpy noise): the same file names,
npz keys and values (bitwise: the same float32 draws go through the same
numpy diagnostics and invariant mean), the same metrics records and the
same large-patient skip. The real samplers then run through the port's
CLI at small budgets: every patient gets finite files, the diagnostics are
sane, a second HMC run repeats the first bitwise, the JAX package reads
the mean files, and `run --sampler vi` hands the variational means to
clustering.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from medgp_tpu.config import experiment as jexp  # noqa: E402
from medgp_tpu.data import cohort as jcohort  # noqa: E402
from medgp_tpu.data import formats as jformats  # noqa: E402
from medgp_tpu.infer import hmc as jhmc  # noqa: E402
from medgp_tpu.infer import nuts as jnuts  # noqa: E402
from medgp_tpu.infer import vi as jvi  # noqa: E402
from medgp_tpu.parallel import runner as jrunner  # noqa: E402
from medgp_tpu.utils import hbm as jhbm  # noqa: E402
from medgp_tpu_torch.cli import main as tcli  # noqa: E402
from medgp_tpu_torch.cluster import pipeline as tpipe  # noqa: E402
from medgp_tpu_torch.config import experiment as texp  # noqa: E402
from medgp_tpu_torch.data import cohort as tcohort  # noqa: E402
from medgp_tpu_torch.data import formats as tformats  # noqa: E402
from medgp_tpu_torch.data import synthetic as tsyn  # noqa: E402
from medgp_tpu_torch.infer import hmc as thmc  # noqa: E402
from medgp_tpu_torch.infer import nuts as tnuts  # noqa: E402
from medgp_tpu_torch.infer import vi as tvi  # noqa: E402
from medgp_tpu_torch.models import params as tparams  # noqa: E402
from medgp_tpu_torch.parallel import runner as trunner  # noqa: E402
from medgp_tpu_torch.utils import hbm as thbm  # noqa: E402

Q, D, R = 2, 2, 1
FEATURES = [18, 19]
OPT = dict(random_init_num=4, top_iteration_num=1, iteration_num_per_update=5)
SAMPLERS = ("hmc", "nuts", "vi")
C, S = 2, 6  # chains and draws of the fixed draws


def _cfg_path(cfg):
    return os.path.join(cfg.exp_cfg_dir, "exp_setup.json")


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """The cohort on disk and an experiment trained by the port's CLI; each
    test copies its train files into an experiment of its own (the JAX
    package's or the port's `generate_experiment`)."""
    root = tmp_path_factory.mktemp("samplers")
    recs = tsyn.sample_cohort(
        3, tparams.LMCSMSpec(Q, D, R), 8, n_clusters=1, n_obs_range=(24, 60)
    )
    tsyn.write_reference_format_cohort(str(root / "data" / "synth"), recs, FEATURES)

    def generate(prefix, copy_train=True, pkg=texp):
        cfg = pkg.generate_experiment(
            data_root=str(root / "data"), exp_root=str(root / prefix),
            cohort="synth", feature_list=FEATURES, Q=Q, R=R, cv_fold_num=2,
            cv_seed=718, exp_prefix=prefix, opt_config=OPT,
        )
        if copy_train:
            for name in os.listdir(trained.exp_train_dir):
                with open(os.path.join(trained.exp_train_dir, name), "rb") as f:
                    data = f.read()
                with open(os.path.join(cfg.exp_train_dir, name), "wb") as f:
                    f.write(data)
        return cfg

    trained = generate("trained", copy_train=False)
    tcli.main(["train", "--cfg", _cfg_path(trained), "--device", "cpu"])
    records = tcohort.load_cohort(trained.data_dir, trained.pans(), trained.feature_list)
    return dict(generate=generate, records=records, pans=trained.pans())


def _fixed_noise(H):
    return (0.05 * np.random.default_rng(7).normal(size=(C, S, H))).astype(np.float32)


def _fake_jax(noise):
    """The JAX package's samplers, replaced: one patient's result from
    theta0 (H,) and the fixed draws (its vmap gives the batch)."""
    c = jnp.asarray(noise)
    steps = 9

    def hmc(spec, data, theta0, key, **kw):
        samples = theta0[None, None, :] + c
        z = jnp.zeros((C, S))
        return jhmc.HMCResult(
            samples=samples, potential=z, accept_prob=z + 0.5,
            accept_rate=jnp.asarray([0.75, 0.5]), step_size=jnp.asarray([0.01, 0.02]),
            inv_mass=jnp.ones((C, theta0.shape[-1])),
            divergences=jnp.asarray([1, 0], jnp.int32),
        )

    def nuts(spec, data, theta0, key, **kw):
        h = hmc(spec, data, theta0, key)
        i = jnp.ones((C, S), jnp.int32)
        return jnuts.NUTSResult(*h, tree_depth=i, n_leapfrog=i)

    def vi(spec, data, theta0, key, prior=None, num_steps=0, num_samples=0, **kw):
        return jvi.VIResult(
            mean=theta0 + c[0, 0], log_std=theta0 * 0 - 3.0,
            samples=theta0[None, :] + c[0], elbo=theta0[0],
            elbo_trace=jnp.zeros(steps), converged=jnp.asarray(True),
        )

    return hmc, nuts, vi


def _fake_port(noise):
    """The port's samplers, replaced alike for a batch of B patients."""
    c = torch.as_tensor(noise)

    def hmc(spec, data, theta0, gen, **kw):
        B, H = theta0.shape
        samples = theta0[:, None, None, :].cpu() + c
        z = torch.zeros(B, C, S)
        return thmc.HMCResult(
            samples=samples, potential=z, accept_prob=z + 0.5,
            accept_rate=torch.tensor([0.75, 0.5]).expand(B, C),
            step_size=torch.tensor([0.01, 0.02]).expand(B, C),
            inv_mass=torch.ones(B, C, H),
            divergences=torch.tensor([1, 0], dtype=torch.int32).expand(B, C),
        )

    def nuts(spec, data, theta0, gen, **kw):
        h = hmc(spec, data, theta0, gen)
        i = torch.ones(theta0.shape[0], C, S, dtype=torch.int32)
        return tnuts.NUTSResult(*h, tree_depth=i, n_leapfrog=i, host_reads=0)

    def vi(spec, data, theta0, gen, prior=None, num_steps=0, num_samples=0, **kw):
        theta0 = theta0.cpu()
        return tvi.VIResult(
            mean=theta0 + c[0, 0], log_std=theta0 * 0 - 3.0,
            samples=theta0[:, None, :] + c[0], elbo=theta0[:, 0],
            elbo_trace=torch.zeros(theta0.shape[0], 9),
            converged=torch.ones(theta0.shape[0], dtype=torch.bool),
        )

    return hmc, nuts, vi


def _records(cfg, stages):
    with open(os.path.join(cfg.exp_log_dir, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f if json.loads(x)["stage"] in stages]


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_hmc_cohort_writes_what_jax_writes(staged, sampler, monkeypatch):
    """The same fixed draws through both runners, with one patient above a
    lowered large-patient threshold: the same out entries, files, npz keys
    and values, and metrics records."""
    cfg_j = staged["generate"](f"jax_{sampler}", pkg=jexp)
    cfg_t = staged["generate"](f"port_{sampler}")
    records = staged["records"]
    thr = sorted(r.n_obs for r in records)[-2]  # the longest patient is skipped
    H = tparams.LMCSMSpec(Q, D, R).n_hyp
    noise = _fixed_noise(H)
    for mod, fake in zip((jhmc, jnuts, jvi), _fake_jax(noise)):
        monkeypatch.setattr(mod, f"{mod.__name__.rsplit('.', 1)[1]}_patient", fake)
    for name, fake in zip(("hmc_patient", "nuts_patient", "vi_patient"), _fake_port(noise)):
        monkeypatch.setattr(trunner, name, fake)
    jrecs = [jcohort.PatientRecord(r.pan, r.t, r.y, r.meta) for r in records]
    want = jrunner.hmc_cohort(cfg_j, jrecs, num_chains=C, num_samples=S, sampler=sampler,
                              use_mesh=False, large_threshold=thr)
    got = trunner.hmc_cohort(cfg_t, records, num_chains=C, num_samples=S, sampler=sampler,
                             large_threshold=thr, device="cpu")

    assert got.keys() == want.keys()
    skipped = [p for p, v in want.items() if "samples" not in v]
    assert len(skipped) == 1 and got[skipped[0]] == want[skipped[0]] == {
        "flag": False, "reason": "large_patient"}
    for pan, w in want.items():
        assert got[pan].keys() == w.keys()
        for k, v in w.items():
            np.testing.assert_array_equal(np.asarray(got[pan][k]), np.asarray(v), err_msg=k)

    def files(cfg):
        return sorted(n for n in os.listdir(cfg.exp_train_dir)
                      if n.startswith(("train_hmc_", "train_vi_")))

    assert files(cfg_t) == files(cfg_j) and len(files(cfg_t)) == 2 * (len(records) - 1)
    for name in files(cfg_j):
        a, b = (os.path.join(c.exp_train_dir, name) for c in (cfg_t, cfg_j))
        if name.endswith(".bin"):
            np.testing.assert_array_equal(jformats.read_double_bin(a), jformats.read_double_bin(b))
            continue
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in zb.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{name}:{k}")

    stages = ("sampler_skip", sampler, f"{sampler}_diag")
    rt, rj = _records(cfg_t, stages), _records(cfg_j, stages)
    assert [r["stage"] for r in rt] == [r["stage"] for r in rj]
    for a, b in zip(rt, rj):
        for k in set(b) - {"ts", "run", "seconds", "samples_per_sec"}:
            assert a[k] == b[k], (a["stage"], k)


def test_pack_patients_footprint_caps_match_jax(monkeypatch):
    """At equal free memory (the port's gram budget, free / 32 bytes per
    entry, set to the JAX package's entry budget) both packages split the
    same patients into the same buckets for each footprint multiplier."""
    budget = jhbm.gram_entry_budget()
    monkeypatch.setattr(thbm, "device_bytes", lambda device: 32 * budget)
    rng = np.random.default_rng(3)
    ns = np.concatenate([rng.integers(20, 128, 40), rng.integers(300, 513, 70)])
    recs_t = [tcohort.PatientRecord(f"p{i}", np.zeros(n, np.float32), np.zeros(n, np.float32),
                                    np.zeros(n, np.int32)) for i, n in enumerate(ns)]
    recs_j = [jcohort.PatientRecord(r.pan, r.t, r.y, r.meta) for r in recs_t]
    for mult in (1, 2, 8):
        got = tcohort.pack_patients(recs_t, footprint_mult=mult)
        want = jcohort.pack_patients(recs_j, footprint_mult=mult)
        assert [(b.n_max, b.pans) for b in got] == [(b.n_max, b.pans) for b in want]
    assert max(len(b) for b in got if b.n_max == 512) == jhbm.bucket_cap(512) // 8 < 70


def _hmc_cli(cfg, sampler, *extra):
    tcli.main(["hmc", "--cfg", _cfg_path(cfg), "--sampler", sampler, "--chains", "2",
               "--warmup", "10", "--samples", "8", "--leapfrog", "4", "--max-depth", "4",
               "--device", "cpu", *extra])


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_cli_hmc_samples_every_trained_patient(staged, sampler):
    """The real samplers through the CLI at small budgets (2 chains, 10
    warmup, 8 draws): finite files for every trained patient, which the
    JAX package's reader reads; accept rates in (0, 1], positive step
    sizes, the diagnostics' keys, NUTS within warmup_max_depth + 1; the
    metrics records. HMC run twice repeats its draws bitwise."""
    cfg = staged["generate"](f"cli_{sampler}")
    _hmc_cli(cfg, sampler)
    spec = cfg.spec()
    prefix = "vi" if sampler == "vi" else "hmc"
    trained, _ = tformats.read_train_kernels(cfg.exp_train_dir, staged["pans"])
    assert len(trained) == len(staged["pans"])
    for pan in trained:
        mean = jformats.read_double_bin(
            os.path.join(cfg.exp_train_dir, f"train_{prefix}_mean_{pan}.bin"))
        assert mean.shape == (spec.n_hyp,) and np.isfinite(mean).all()
        with np.load(os.path.join(cfg.exp_train_dir, f"train_{prefix}_samples_{pan}.npz")) as z:
            chains = 1 if sampler == "vi" else 2
            assert z["samples"].shape == (chains, 8, spec.n_hyp)
            assert np.isfinite(z["samples"]).all()
            if sampler == "vi":
                assert np.isfinite(z["elbo"]) and z["log_std"].shape == (spec.n_hyp,)
            else:
                assert np.all((z["accept_rate"] > 0) & (z["accept_rate"] <= 1))
                assert np.all(np.isfinite(z["step_size"]) & (z["step_size"] > 0))
                for k in ("ess_bulk_min", "rhat_max", "ess_min_A", "rhat_max_kappa"):
                    assert np.isfinite(z[k]), k
    recs = _records(cfg, (sampler, f"{sampler}_diag"))
    assert [r["stage"] for r in recs].count(sampler) == 1  # one bucket
    if sampler != "vi":
        assert sorted(r["pan"] for r in recs if r["stage"] == f"{sampler}_diag") == sorted(trained)
    if sampler == "hmc":
        first = {p: np.load(os.path.join(cfg.exp_train_dir, f"train_hmc_samples_{p}.npz"))["samples"]
                 for p in trained}
        _hmc_cli(cfg, sampler)
        for p in trained:
            again = np.load(os.path.join(cfg.exp_train_dir, f"train_hmc_samples_{p}.npz"))
            np.testing.assert_array_equal(again["samples"], first[p])


def test_nuts_sampling_depth_is_capped_on_the_cohort(staged):
    """nuts_patient on the trained cohort's bucket: every draw within
    warmup_max_depth + 1, and the host reads counted."""
    cfg = staged["generate"]("nuts_depth")
    spec = cfg.spec()
    pans, hyps = tformats.read_train_kernels(cfg.exp_train_dir, staged["pans"])
    (b,) = tcohort.pack_patients(staged["records"])
    res = tnuts.nuts_patient(
        spec, trunner.batch_data(b, torch.device("cpu")),
        torch.as_tensor(np.stack([hyps[list(pans).index(p)] for p in b.pans]), dtype=torch.float32),
        torch.Generator().manual_seed(0), num_chains=2, num_warmup=10, num_samples=6,
        max_depth=6, init_step_size=0.005,
    )
    assert int(res.tree_depth.max()) <= 4 + 1
    assert res.host_reads >= 16 * 2  # at least one tree and one leaf read per draw


def test_run_with_sampler_feeds_posterior_means_to_clustering(staged, capsys, monkeypatch):
    """`run --sampler vi --device cpu` end to end: the clustering handoff
    gets every trained patient's variational mean (the file the sampler
    wrote) in place of its MAP hypers, in cohort order; the run record
    carries sampler_seconds; both test modes' outputs are written."""
    cfg = staged["generate"]("run_vi", copy_train=False)
    handed = []
    handoff = tpipe.kernel_clustering_fold_in_memory
    monkeypatch.setattr(tpipe, "kernel_clustering_fold_in_memory",
                        lambda spec, kdir, pans, hyps, *a, **kw:
                        handed.append((list(pans), hyps.copy()))
                        or handoff(spec, kdir, pans, hyps, *a, **kw))
    capsys.readouterr()
    tcli.main(["run", "--cfg", _cfg_path(cfg), "--sampler", "vi", "--warmup", "20",
               "--samples", "8", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(s["mae"]) for s in summary.values())
    pans, hyps = handed[0]
    assert pans == cfg.pans() and len(handed) == 3
    for p, h in zip(pans, hyps):
        post = tformats.read_double_bin(os.path.join(cfg.exp_train_dir, f"train_vi_mean_{p}.bin"))
        map_theta = tformats.read_double_bin(tformats.train_paths(cfg.exp_train_dir, p)["hyp"])
        np.testing.assert_array_equal(h, post)
        assert not np.array_equal(h, map_theta)
    (run,) = _records(cfg, ("run",))
    assert run["sampler_seconds"] > 0
    for mode in trunner.TEST_MODES:
        for p in pans:
            assert all(os.path.exists(x) for x in
                       tformats.test_paths(cfg.exp_test_dir, mode, p).values())
