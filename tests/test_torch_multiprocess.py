"""The port's multi-rank path against a one-rank run, on the CPU.

Worlds of 2 and 4 ranks (gloo over separate processes, started by
`torchrun --standalone`) run tests/torch_mp_worker.py's "cohort"
scenarios: the CLI `run` with `--device cpu` (under torchrun it joins the
process group itself), then `train_cohort`, `test_cohort` in both modes
and `hmc_cohort` with the mesh, and the row-sharded value+gradient of a
large patient. The same scenarios run once in this process without a
mesh. Both worlds are spawned once, together, while the one-rank run
goes on here.

What is held (the cohort: LMC-SM(1, 2, 1), 8 patients of 16
observations as tests/mp_worker.py's, 4 inits, varEM 2 x 8; 7 of them
for the direct calls, so each world pads its buckets with all-masked
dummies):
  * train and test results, and the CLI's train files, bitwise: the
    plain PyTorch twins that run the kernels' math on the CPU give a
    patient the same bits alone and in any batch;
  * the CLI's mode kernels: the noise block from the ranks' float32 KDE
    within 2e-3 relative of the one-rank float64 host KDE (the JAX
    package's tolerance, tests/test_mesh.py:240), every other block equal;
  * the large value and its gradient bitwise (the ranks' tile
    cotangents are summed in the one-device order), no tensor of n^2 or
    n (n + b) / 2 elements on any rank;
  * every rank ends with the same gathered results, rank 0 alone writes
    the files, rank r > 0 writes its records to metrics.p{r}.jsonl with
    process r and devices W;
  * each rank plans the direct calls from its own memory budget, the last
    rank's the least (`worker.plan_budgets`): every rank forms the
    buckets and the large patient's row blocks that the least budget
    gives;
  * the sampler draws of HMC, NUTS and VI bitwise: every patient's are
    those of the one-rank run, which samples whole buckets (each
    (patient, chain) draws from its own stream, keyed by the patient's
    cohort index, so neither the rank nor the batch mates change them);
  * a patient of 256 observations above the large-patient threshold
    trains by row blocks over the ranks at P = 8 (the least budget's
    plan, which one rank makes too): one `train_large` record with
    devices W, its loss and theta bitwise one rank's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from medgp_tpu_torch.config.experiment import ExperimentConfig  # noqa: E402
from medgp_tpu_torch.data import formats  # noqa: E402
from medgp_tpu_torch.data.cohort import load_cohort, pack_patients  # noqa: E402
from medgp_tpu_torch.evaluation.evals import eval_cohort, summarize  # noqa: E402
from medgp_tpu_torch.models.params import LMCSMSpec  # noqa: E402
from medgp_tpu_torch.parallel.mesh import round_up  # noqa: E402
from medgp_tpu_torch.parallel.runner import MAX_BATCH, TRAIN_MAX_BATCH  # noqa: E402
from medgp_tpu_torch.utils.hbm import train_batch_cap  # noqa: E402
from tests import torch_mp_worker as worker  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")
WORLDS = (2, 4)
SPAWN_TIMEOUT = 240  # seconds for one world, start-up included
NOISE_REL = 2e-3


def spawn(world, args, log_path):
    """`torchrun --standalone` of the worker on `world` CPU ranks."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={world}", WORKER, *args],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
    )
    return proc, log


def finish(proc, log, log_path):
    try:
        proc.wait(timeout=SPAWN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    log.close()
    if proc.returncode != 0:
        with open(log_path) as f:
            pytest.fail(f"world failed (rc={proc.returncode}):\n{f.read()[-4000:]}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp")
    cfgs = {W: worker.stage(str(root / f"w{W}")) for W in (1,) + WORLDS}
    procs = {}
    for W in WORLDS:
        out = root / f"out{W}"
        out.mkdir()
        log_path = str(root / f"w{W}.log")
        procs[W] = (*spawn(W, ["cohort", "none", str(out), *cfgs[W]], log_path), log_path)
    ref = worker.cohort_results(*cfgs[1], lambda: None)
    got = {}
    for W, (proc, log, log_path) in procs.items():
        finish(proc, log, log_path)
        got[W] = [dict(np.load(root / f"out{W}" / f"rank{r}.npz")) for r in range(W)]
    return dict(cfgs=cfgs, ref=ref, got=got)


def _keys(d, prefix):
    return sorted(k for k in d if k.startswith(prefix))


@pytest.mark.parametrize("W", WORLDS)
def test_train_and_test_cohort_equal_one_rank(runs, W):
    ref, got = runs["ref"], runs["got"][W][0]
    keys = _keys(ref, "train/") + _keys(ref, "test/")
    assert len(_keys(ref, "train/")) == 7 * 3 and len(_keys(ref, "test/")) == 7 * 2 * 4
    assert keys == _keys(got, "train/") + _keys(got, "test/")
    for k in keys:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert all(bool(ref[f"train/p{i}/flag"]) for i in range(7))


@pytest.mark.parametrize("W", WORLDS)
def test_every_rank_gets_the_gathered_results(runs, W):
    first = runs["got"][W][0]
    for other in runs["got"][W][1:]:
        assert sorted(other) == sorted(first)
        for k in first:
            np.testing.assert_array_equal(other[k], first[k], err_msg=k)


@pytest.mark.parametrize("W", WORLDS)
def test_cli_run_files_equal_one_rank(runs, W):
    """Train files bitwise; each fold's mode kernel equal but for its noise
    block (the ranks' float32 KDE, 2e-3 of the host float64 KDE); every
    test file complete, both modes' MAE finite."""
    ref_cfg = ExperimentConfig.from_json(runs["cfgs"][1][0])
    cfg = ExperimentConfig.from_json(runs["cfgs"][W][0])
    names = sorted(os.listdir(ref_cfg.exp_train_dir))
    assert names == sorted(os.listdir(cfg.exp_train_dir)) and len(names) == 8 * 5
    for name in names:
        with open(os.path.join(ref_cfg.exp_train_dir, name), "rb") as a, \
                open(os.path.join(cfg.exp_train_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    D = cfg.D
    for fold in (-1, 0, 1):
        want, wq = formats.read_mode_kernel(ref_cfg.exp_kernel_dir, fold, "gmm")
        got, gq = formats.read_mode_kernel(cfg.exp_kernel_dir, fold, "gmm")
        assert gq == wq
        np.testing.assert_allclose(got[:D], want[:D], rtol=NOISE_REL, err_msg=f"fold {fold}")
        np.testing.assert_array_equal(got[D:], want[D:], err_msg=f"fold {fold}")
    for mode in ("mean_wo_update", "mean_w_update"):
        s = summarize(eval_cohort(cfg.data_dir, cfg.exp_test_dir, mode, cfg.feature_list,
                                  cfg.pans()))
        assert np.isfinite(s["mae"]) and np.isfinite(s["ci_ratio"])
        for pan in cfg.pans():
            flag, res = formats.read_test_result(cfg.exp_test_dir, mode, pan)
            assert flag == 1 and len(res["pred"]) == worker.N_OBS
            assert np.isfinite(res["pred"]).all()


@pytest.mark.parametrize("W", WORLDS)
def test_per_rank_metrics_files(runs, W):
    cfg = ExperimentConfig.from_json(runs["cfgs"][W][0])
    names = sorted(os.listdir(cfg.exp_log_dir))
    assert names == ["metrics.jsonl"] + [f"metrics.p{r}.jsonl" for r in range(1, W)]
    for r, name in enumerate(names):
        with open(os.path.join(cfg.exp_log_dir, name)) as f:
            recs = [json.loads(x) for x in f]
        assert {x["process"] for x in recs} == {r}
        stages = {x["stage"] for x in recs}
        assert {"train", "test"} <= stages
        assert all(x["devices"] == W for x in recs if x["stage"] in ("train", "test"))
        assert ("run" in stages) == (r == 0)
    run = [x for x in map(json.loads, open(os.path.join(cfg.exp_log_dir, "metrics.jsonl")))
           if x["stage"] == "run"]
    assert [x["devices"] for x in run] == [W]


@pytest.mark.parametrize("W", WORLDS)
def test_large_value_and_gradient_equal_one_rank(runs, W):
    ref, got = runs["ref"], runs["got"][W][0]
    np.testing.assert_array_equal(got["large_value"], ref["large_value"])
    np.testing.assert_array_equal(got["large_grad"], ref["large_grad"])


@pytest.mark.parametrize("W", WORLDS)
def test_no_rank_makes_a_square_buffer(runs, W):
    n, b = worker.LARGE_N, worker.LARGE_N // worker.LARGE_BLOCKS
    for rank in runs["got"][W]:
        assert 0 < int(rank["large_largest"]) < min(n * n, n * (n + b) // 2)


@pytest.mark.parametrize("sampler", sorted(worker.SAMPLER_RUNS))
@pytest.mark.parametrize("W", WORLDS)
def test_sharded_sampler_draws(runs, W, sampler):
    """Every patient's draws over W ranks, which sample buckets of the
    least budget padded with dummies, bitwise those of one process that
    samples the whole cohort in one bucket."""
    got, ref = runs["got"][W][0], runs["ref"]
    keys = _keys(got, f"{sampler}/")
    assert len(keys) == worker.N_PATIENTS and keys == _keys(ref, f"{sampler}/")
    H = LMCSMSpec(*worker.SPEC_ARGS).n_hyp
    kw = worker.SAMPLER_RUNS[sampler]
    for k in keys:
        s = got[k]
        assert s.shape == (kw.get("num_chains", 1), kw["num_samples"], H)
        assert np.isfinite(s).all()
        np.testing.assert_array_equal(s, ref[k], err_msg=k)


def _plan_records(path, stages):
    """(stage, n_max, batch, blocks, block_rows) of each record of
    `stages`, None where a record has no such field."""
    with open(path) as f:
        return [(x["stage"], *(None if x.get(k) is None else int(x[k])
                               for k in ("n_max", "batch", "blocks", "block_rows")))
                for x in map(json.loads, f) if x["stage"] in stages]


@pytest.mark.parametrize("W", WORLDS)
def test_ranks_plan_alike_from_different_budgets(runs, W):
    """Every rank forms the buckets and row blocks of the least budget,
    though the last rank alone has it (`worker.plan_budgets`)."""
    cfg_cli, cfg_api = (ExperimentConfig.from_json(c) for c in runs["cfgs"][W])
    recs = load_cohort(cfg_api.data_dir, cfg_api.pans(), cfg_api.feature_list)
    low = worker.BUCKET_LOW
    n = worker.BUCKET_N
    cap = min(round_up(TRAIN_MAX_BATCH, W), W * train_batch_cap(n, "cpu", low))
    train = [len(b) for b in pack_patients(recs, max_batch=cap, free_bytes=low)]
    test = [len(b) for b in pack_patients(recs, max_batch=round_up(MAX_BATCH, W),
                                          free_bytes=low)]
    assert max(train) < len(recs) and max(test) < len(recs)  # the least budget binds
    want_api = ([("train", n, B, None, None) for B in train]
                + [("train_large", None, None, *worker.LARGE_PLAN_LOW)]
                + [("test", n, B, None, None) for B in test for _ in range(2)])
    sampler_recs = load_cohort(cfg_cli.data_dir, cfg_cli.pans(), cfg_cli.feature_list)
    want_hmc = [("hmc", n, len(b), None, None) for b in pack_patients(
        sampler_recs, max_batch=round_up(32, W), free_bytes=W * low,
        footprint_mult=2 * worker.HMC["num_chains"])]
    assert all(x[2] % W for x in want_hmc)  # dummies pad every sampler bucket
    for r in range(W):
        name = "metrics.jsonl" if r == 0 else f"metrics.p{r}.jsonl"
        assert _plan_records(os.path.join(cfg_api.exp_log_dir, name),
                             ("train", "train_large", "test")) == want_api, r
        assert _plan_records(os.path.join(cfg_cli.exp_log_dir, name), ("hmc",)) == want_hmc, r
    for rank in runs["got"][W]:
        assert (int(rank["large_train/blocks"]), int(rank["large_train/block_rows"])) == \
            worker.LARGE_PLAN_LOW


@pytest.mark.parametrize("W", WORLDS)
def test_large_patient_trains_over_the_ranks(runs, W):
    """The same plan (P = 8, b = 32) on one rank and over W: one rank's
    loss and theta, bitwise."""
    ref, got = runs["ref"], runs["got"][W][0]
    assert (int(ref["large_train/blocks"]), int(ref["large_train/block_rows"])) == \
        worker.LARGE_PLAN_LOW
    assert bool(got["large_train/flag"]) and bool(ref["large_train/flag"])
    for k in ("loss", "theta"):
        np.testing.assert_array_equal(got[f"large_train/{k}"], ref[f"large_train/{k}"],
                                      err_msg=k)
    cfg = ExperimentConfig.from_json(runs["cfgs"][W][1])
    with open(os.path.join(cfg.exp_log_dir, "metrics.jsonl")) as f:
        (rec,) = [x for x in map(json.loads, f) if x["stage"] == "train_large"]
    assert (rec["pan"], rec["n_obs"], rec["devices"], rec["trained"]) == (
        "big", worker.LARGE_N, W, 1)
