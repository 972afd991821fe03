"""The port's CLI stages `kernclust`, `test` (both modes by default),
`eval` and the fused `run` against the JAX package's CLI.

The cohort is tests/test_pipeline.py's: 8 synthetic patients, LMC-SM Q=2,
D=2, R=1, 2 folds. It is trained once by the port's CLI `train` (budgets
cut to one varEM warm round); both packages' later stages then read the
same train files, which are byte-compatible between the packages
(tests/test_torch_train.py), so the JAX train stage's compile is not paid
here.

Tolerances: mode kernels 1e-10 with algorithm None and 1e-5 with gmm, the
components sorted by mu (tests/test_torch_cluster.py); test outputs as
tests/test_torch_slice.py holds them (pred and error 2e-4, var 2e-3
relative / 2e-4, CI flags and feature ids equal); eval files and summary
1e-12 relative (the same float64 numpy arithmetic).
"""

import filecmp
import json
import os
import re
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one torch
# thread each, as these small tensors gain nothing from more
torch.set_num_threads(1)

from medgp_tpu.cli import main as jcli  # noqa: E402
from medgp_tpu.config import experiment as jexp  # noqa: E402
from medgp_tpu.data import formats as jformats  # noqa: E402
from medgp_tpu.data import synthetic as jsyn  # noqa: E402
from medgp_tpu.models import params as jparams  # noqa: E402
from medgp_tpu_torch.cli import main as tcli  # noqa: E402
from medgp_tpu_torch.cluster import pipeline as tpipe  # noqa: E402
from medgp_tpu_torch.config import experiment as texp  # noqa: E402
from medgp_tpu_torch.data import formats as tformats  # noqa: E402
from medgp_tpu_torch.data import synthetic as tsyn  # noqa: E402
from medgp_tpu_torch.evaluation import evals as tevals  # noqa: E402
from medgp_tpu_torch.models import params as tparams  # noqa: E402
from medgp_tpu_torch.parallel import runner as trunner  # noqa: E402

Q, D, R = 2, 2, 1
FEATURES = [18, 19]
MODES = ("mean_wo_update", "mean_w_update")
OPT = dict(random_init_num=4, top_iteration_num=1, iteration_num_per_update=5)


def _cfg_path(cfg):
    return os.path.join(cfg.exp_cfg_dir, "exp_setup.json")


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """The cohort on disk; a JAX experiment and a port experiment with the
    same train files (the port's CLI train) and the same mode kernels (the
    JAX CLI's kernclust --alg gmm, every fold)."""
    root = tmp_path_factory.mktemp("pipeline")
    recs = tsyn.sample_cohort(
        3, tparams.LMCSMSpec(Q, D, R), 8, n_clusters=1, n_obs_range=(24, 60)
    )
    tsyn.write_reference_format_cohort(str(root / "data" / "synth"), recs, FEATURES)

    def generate(pkg, prefix):
        return pkg.generate_experiment(
            data_root=str(root / "data"), exp_root=str(root / prefix),
            cohort="synth", feature_list=FEATURES, Q=Q, R=R, cv_fold_num=2,
            cv_seed=718, exp_prefix=prefix, opt_config=OPT,
        )

    cfg_t = generate(texp, "torch")
    cfg_j = generate(jexp, "jax")
    tcli.main(["train", "--cfg", _cfg_path(cfg_t), "--device", "cpu"])
    shutil.copytree(cfg_t.exp_train_dir, cfg_j.exp_train_dir, dirs_exist_ok=True)
    jcli.main(["kernclust", "--cfg", _cfg_path(cfg_j), "--alg", "gmm"])
    shutil.copytree(cfg_j.exp_kernel_dir, cfg_t.exp_kernel_dir, dirs_exist_ok=True)
    return dict(root=root, generate=generate, cfg_j=cfg_j, cfg_t=cfg_t)


def _mode_blocks(theta, newQ):
    """(noise, A, mu, v, exp kappa) with components sorted by mu."""
    A = theta[D : D + newQ * D * R].reshape(newQ, D, R)
    mu = theta[D + newQ * D * R : D + newQ * D * R + newQ]
    v = theta[D + newQ * (D * R + 1) : D + newQ * (D * R + 2)]
    kap = np.exp(theta[D + newQ * (D * R + 2) :].reshape(newQ, D))
    o = np.argsort(mu)
    return theta[:D], A[o], mu[o], v[o], kap[o]


@pytest.mark.parametrize("alg", ["None", "gmm"])
def test_kernclust_writes_the_jax_mode_kernels(staged, alg):
    """The port's CLI `kernclust` on the train files the JAX CLI's read:
    every fold's mode-kernel files, and one `kernclust` record per fold."""
    cfg_j = staged["cfg_j"]
    cfg_k = staged["generate"](texp, f"kernclust_{alg}")
    shutil.copytree(cfg_j.exp_train_dir, cfg_k.exp_train_dir, dirs_exist_ok=True)
    if alg != "gmm":  # the fixture ran the JAX CLI with gmm
        jcli.main(["kernclust", "--cfg", _cfg_path(cfg_j), "--alg", alg])
    tcli.main(["kernclust", "--cfg", _cfg_path(cfg_k), "--alg", alg, "--device", "cpu"])
    rtol = 1e-10 if alg == "None" else 1e-5
    for fold in (-1, 0, 1):
        want, qj = jformats.read_mode_kernel(cfg_j.exp_kernel_dir, fold, alg)
        got, qt = tformats.read_mode_kernel(cfg_k.exp_kernel_dir, fold, alg)
        assert qt == qj and 1 <= qt <= Q
        assert len(got) == len(want) and np.all(np.isfinite(got))
        for g, w in zip(_mode_blocks(got, qt), _mode_blocks(want, qj)):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-12, err_msg=str(fold))
    with open(os.path.join(cfg_k.exp_log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert sorted(r["fold"] for r in recs if r["stage"] == "kernclust") == [-1, 0, 1]


def _compare_test_outputs(cfg_j, cfg_t, mode):
    n_pred = 0
    for pan in cfg_j.pans():
        flag_j, want = jformats.read_test_result(cfg_j.exp_test_dir, mode, pan)
        flag_t, got = tformats.read_test_result(cfg_t.exp_test_dir, mode, pan)
        assert flag_t == flag_j == 1
        for k in ("feature", "ci"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("pred", "error"):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(got["var"], want["var"], rtol=2e-3, atol=2e-4)
        n_pred += len(got["pred"])
    return n_pred


def test_cli_test_without_mode_writes_both_modes_like_jax(staged):
    """With no --mode the port's `test` runs mean_wo_update, then
    mean_w_update, as the JAX CLI's `test` does; both modes' files match."""
    cfg_j, cfg_t = staged["cfg_j"], staged["cfg_t"]
    jcli.main(["test", "--cfg", _cfg_path(cfg_j), "--alg", "gmm"])
    tcli.main(["test", "--cfg", _cfg_path(cfg_t), "--alg", "gmm", "--device", "cpu"])
    for mode in MODES:
        assert _compare_test_outputs(cfg_j, cfg_t, mode) > 8 * 24
    with open(os.path.join(cfg_t.exp_log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert {r["mode"] for r in recs if r["stage"] == "test"} == set(MODES)


def test_eval_writes_what_jax_eval_writes(staged, capsys):
    """The port's CLI `eval` on test files the JAX package wrote: the same
    per-feature mae / ci_ratio / nll files and the same summary."""
    cfg_j = staged["cfg_j"]
    if not os.path.exists(jformats.test_paths(cfg_j.exp_test_dir, "mean_w_update",
                                              cfg_j.pans()[0])["flag"]):
        jcli.main(["test", "--cfg", _cfg_path(cfg_j), "--alg", "gmm"])
    cfg_e = staged["generate"](texp, "eval")
    for name in os.listdir(cfg_j.exp_test_dir):  # the per-patient files
        if not re.search(r"_feature\d+_(mae|ci_ratio|nll)\.bin$", name):
            shutil.copy(os.path.join(cfg_j.exp_test_dir, name), cfg_e.exp_test_dir)
    for mode in MODES:
        capsys.readouterr()
        jcli.main(["eval", "--cfg", _cfg_path(cfg_j), "--test-mode", mode])
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        tcli.main(["eval", "--cfg", _cfg_path(cfg_e), "--test-mode", mode])
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(got) == set(want) == {"mae", "ci_ratio", "nll"}
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
        for fidx in FEATURES:
            for what in ("mae", "ci_ratio", "nll"):
                name = f"test_{mode}_feature{fidx}_{what}.bin"
                np.testing.assert_allclose(
                    tformats.read_double_bin(os.path.join(cfg_e.exp_test_dir, name)),
                    jformats.read_double_bin(os.path.join(cfg_j.exp_test_dir, name)),
                    rtol=1e-12, atol=0, err_msg=name,
                )
        # the MAE +- SE over the per-(patient, feature) values
        v = np.concatenate([jformats.read_double_bin(os.path.join(
            cfg_j.exp_test_dir, f"test_{mode}_feature{f}_mae.bin")) for f in FEATURES])
        assert tevals.mae_mean_se(cfg_e.exp_test_dir, mode, FEATURES) == pytest.approx(
            (v.mean(), v.std(ddof=1) / np.sqrt(len(v)), len(v)), rel=1e-12)


def test_run_writes_every_artifact_and_its_handoff_equals_kernclust(
    staged, capsys, monkeypatch
):
    """`run --device cpu`: train, kernclust of every fold from the hypers
    in memory, test in both modes, eval of both modes. The file-based
    `kernclust` on the train files that `run` wrote gives its mode kernels
    again, bitwise: the handoff passes the patients in cohort order, as
    the files are read."""
    cfg = staged["generate"](texp, "run")
    # train in two buckets, in reverse cohort order
    pack = trunner.pack_patients
    monkeypatch.setattr(trunner, "pack_patients", lambda recs, max_batch, device, **kw:
                        pack(recs[::-1], max_batch=4, device=device, **kw))
    handed = []
    handoff = tpipe.kernel_clustering_fold_in_memory
    monkeypatch.setattr(tpipe, "kernel_clustering_fold_in_memory",
                        lambda spec, kdir, pans, *a, **kw:
                        handed.append(list(pans)) or handoff(spec, kdir, pans, *a, **kw))
    capsys.readouterr()
    tcli.main(["run", "--cfg", _cfg_path(cfg), "--device", "cpu"])
    assert handed == [cfg.pans()] * 3  # every patient trained, in cohort order
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == set(MODES)
    for s in summary.values():
        assert np.isfinite(s["mae"]) and np.isfinite(s["nll"])
        assert 0.0 <= s["ci_ratio"] <= 100.0
    for pan in cfg.pans():
        p = tformats.train_paths(cfg.exp_train_dir, pan)
        assert all(os.path.exists(p[k]) for k in ("init", "hyp", "var_hyp", "num", "flag"))
        for mode in MODES:
            assert all(os.path.exists(x) for x in
                       tformats.test_paths(cfg.exp_test_dir, mode, pan).values())
    for mode in MODES:
        for fidx in FEATURES:
            for what in ("mae", "ci_ratio", "nll"):
                assert os.path.exists(os.path.join(
                    cfg.exp_test_dir, f"test_{mode}_feature{fidx}_{what}.bin"))
    with open(os.path.join(cfg.exp_log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    run = [r for r in recs if r["stage"] == "run"]
    assert len(run) == 1 and all(
        run[0][f"{k}_seconds"] > 0 for k in ("train", "kernclust", "test", "eval"))
    assert sorted(r["fold"] for r in recs if r["stage"] == "kernclust") == [-1, 0, 1]

    in_memory = {f: tformats.read_mode_kernel(cfg.exp_kernel_dir, f, "gmm")
                 for f in (-1, 0, 1)}
    tcli.main(["kernclust", "--cfg", _cfg_path(cfg), "--device", "cpu"])
    for fold, (theta, newQ) in in_memory.items():
        again, q2 = tformats.read_mode_kernel(cfg.exp_kernel_dir, fold, "gmm")
        assert q2 == newQ
        # the same rows in the same order: the same bits
        np.testing.assert_array_equal(again, theta)


def test_run_refuses_the_samplers(staged):
    """`run --sampler` and `hmc --sampler` take the JAX package's three
    samplers and refuse any other; the runner refuses one too. (The
    samplers themselves run in tests/test_torch_sampler_cohort.py.)"""
    cfg_t = staged["cfg_t"]
    for cmd in ("run", "hmc"):
        with pytest.raises(SystemExit):
            tcli.main([cmd, "--cfg", _cfg_path(cfg_t), "--sampler", "gibbs", "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown sampler"):
        trunner.hmc_cohort(cfg_t, [], sampler="gibbs", device="cpu")


def test_ptinr_cohort_is_staged_byte_identical_to_jax(tmp_path):
    """tools/refbudget_run.sh's PT/INR cohort (seed 718, 100 patients, 3
    clusters, 40-220 observations): every feature file and stat file."""
    kw = dict(n_patients=100, n_clusters=3, n_obs_range=(40, 220))
    jrecs = jsyn.sample_cohort(718, jparams.LMCSMSpec(5, 2, 2), **kw)
    trecs = tsyn.sample_cohort(718, tparams.LMCSMSpec(5, 2, 2), **kw)
    jsyn.write_reference_format_cohort(str(tmp_path / "jax"), jrecs, FEATURES)
    tsyn.write_reference_format_cohort(str(tmp_path / "torch"), trecs, FEATURES)
    n_files = 0
    for dirpath, _, files in os.walk(tmp_path / "jax"):
        rel = os.path.relpath(dirpath, tmp_path / "jax")
        for name in files:
            assert filecmp.cmp(os.path.join(dirpath, name),
                               os.path.join(tmp_path / "torch", rel, name),
                               shallow=False), (rel, name)
            n_files += 1
    assert n_files >= 100 * 2 + 2
