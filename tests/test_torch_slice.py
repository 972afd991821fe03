"""The ported test stage as a whole, against the JAX package.

A tiny cohort (6 patients, 30-100 observations, 2 features) is staged once;
`medgp_tpu.parallel.runner.test_cohort` and the port's CLI `test` write
their artifacts into separate experiment directories, in both test modes,
and every written file is compared. Also held here: the host
layer the port carries in its own copy (parameters, synthetic cohorts,
bucketing, `generate`), which must give the JAX package's numbers and
bytes.

Tolerances: pred and error rtol/atol 2e-4, var rtol 2e-3 / atol 2e-4
(tests/test_online.py:181-188; float32 factorizations summed in another
order); CI flags, feature ids and flags equal.
"""

import filecmp
import json
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
from medgp_tpu.data import synthetic as jsyn  # noqa: E402
from medgp_tpu.models import params as jparams  # noqa: E402
from medgp_tpu.parallel import runner as jrunner  # noqa: E402
from medgp_tpu_torch.cli import main as tcli  # noqa: E402
from medgp_tpu_torch.config import experiment as texp  # noqa: E402
from medgp_tpu_torch.data import cohort as tcohort  # noqa: E402
from medgp_tpu_torch.data import formats as tformats  # noqa: E402
from medgp_tpu_torch.data import synthetic as tsyn  # noqa: E402
from medgp_tpu_torch.models import params as tparams  # noqa: E402

Q, D, R = 2, 2, 1
FEATURES = [18, 19]
SEED = 41


def test_theta_from_numpy_unpacks_like_jax():
    rng = np.random.default_rng(51)
    jspec, tspec = jparams.LMCSMSpec(3, 4, 2), tparams.LMCSMSpec(3, 4, 2)
    theta = rng.normal(size=jspec.n_hyp) * 0.5  # float64, like a .bin file
    want = jspec.unpack(jnp.asarray(theta, jnp.float32))
    got = tspec.unpack(tparams.theta_from_numpy(tspec, theta))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["A"].numpy(), np.asarray(want["A"]))
    for k in ("mu", "v", "kappa", "noise_std"):
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]), rtol=1e-6, err_msg=k
        )
    np.testing.assert_allclose(
        tspec.coregional_B(got["A"], got["kappa"]).numpy(),
        np.asarray(jspec.coregional_B(want["A"], want["kappa"])),
        rtol=1e-6, atol=1e-7,
    )
    with pytest.raises(ValueError, match="needs"):
        tparams.theta_from_numpy(tspec, theta[:-1])


def test_sample_cohort_is_identical_to_jax():
    want = jsyn.sample_cohort(
        SEED, jparams.LMCSMSpec(Q, 3, R), 5, n_clusters=2, n_obs_range=(30, 100)
    )
    got = tsyn.sample_cohort(
        SEED, tparams.LMCSMSpec(Q, 3, R), 5, n_clusters=2, n_obs_range=(30, 100)
    )
    assert [r.pan for r in got] == [r.pan for r in want]
    for g, w in zip(got, want):
        for k in ("t", "y", "meta"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
    rng = np.random.default_rng(SEED)
    clusters = [
        jsyn.sample_cluster_params(rng, jparams.LMCSMSpec(Q, 3, R))
        for _ in range(2)
    ]
    for th, c in zip(
        tsyn.cluster_thetas(SEED, tparams.LMCSMSpec(Q, 3, R), 2), clusters
    ):
        np.testing.assert_array_equal(
            th, jsyn.params_to_theta(jparams.LMCSMSpec(Q, 3, R), c)
        )


def test_pack_patients_buckets_like_jax():
    recs = tsyn.sample_cohort(
        SEED, tparams.LMCSMSpec(Q, D, R), 9, n_clusters=1, n_obs_range=(30, 300)
    )
    want = jcohort.pack_patients(recs, max_batch=4)
    got = tcohort.pack_patients(recs, max_batch=4)
    assert [(b.pans, b.n_max) for b in got] == [(b.pans, b.n_max) for b in want]
    for g, w in zip(got, want):
        for k in ("t", "y", "meta", "mask"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """Cohort on disk, an experiment generated by each package, and the
    same mode kernel (cluster 0's ground truth) for every fold."""
    root = tmp_path_factory.mktemp("slice")
    spec = tparams.LMCSMSpec(Q, D, R)
    recs = tsyn.sample_cohort(
        SEED, spec, 6, n_clusters=1, n_obs_range=(30, 100)
    )
    tsyn.write_reference_format_cohort(
        str(root / "data" / "synth"), recs, FEATURES
    )
    kw = dict(
        data_root=str(root / "data"), cohort="synth", feature_list=FEATURES,
        Q=Q, R=R, cv_fold_num=2, exp_prefix="slice",
    )
    cfg_j = jexp.generate_experiment(exp_root=str(root / "jax"), **kw)
    cfg_t = texp.generate_experiment(exp_root=str(root / "torch"), **kw)
    theta = tsyn.cluster_thetas(SEED, spec, 1)[0]
    for cfg in (cfg_j, cfg_t):
        for fold in (-1, 0, 1):
            jformats.write_mode_kernel(cfg.exp_kernel_dir, fold, "gmm", theta, Q)
    return cfg_j, cfg_t


def test_generate_writes_the_same_files(staged):
    cfg_j, cfg_t = staged
    for name in ("hyp_bound.txt", "cv_assign.txt"):
        assert filecmp.cmp(
            os.path.join(cfg_j.exp_cfg_dir, name),
            os.path.join(cfg_t.exp_cfg_dir, name), shallow=False,
        ), name

    def load(cfg):
        with open(os.path.join(cfg.exp_cfg_dir, "exp_setup.json")) as f:
            d = json.load(f)
        top = d["exp_top_dir"]
        return [(k, v.replace(top, "<top>") if isinstance(v, str) else v)
                for k, v in d.items()]

    assert load(cfg_t) == load(cfg_j)


def _compare_test_outputs(cfg_j, cfg_t, mode):
    n_pred = 0
    for pan in cfg_j.pans():
        flag_j, want = jformats.read_test_result(cfg_j.exp_test_dir, mode, pan)
        flag_t, got = tformats.read_test_result(cfg_t.exp_test_dir, mode, pan)
        assert flag_t == flag_j == 1
        for k in ("feature", "ci"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("pred", "error"):
            np.testing.assert_allclose(
                got[k], want[k], rtol=2e-4, atol=2e-4, err_msg=k
            )
        np.testing.assert_allclose(got["var"], want["var"], rtol=2e-3, atol=2e-4)
        assert len(got["etime"]) == len(want["pred"])
        assert np.all(np.isfinite(got["pred"]))
        n_pred += len(got["pred"])
    return n_pred


def test_cli_test_writes_what_jax_test_cohort_writes(staged):
    cfg_j, cfg_t = staged
    recs = jcohort.load_cohort(cfg_j.data_dir, cfg_j.pans(), cfg_j.feature_list)
    jrunner.test_cohort(
        cfg_j, recs, folds=cfg_j.cv_assign(), modes=("mean_wo_update",),
        use_mesh=False,
    )
    tcli.main([
        "test", "--cfg", os.path.join(cfg_t.exp_cfg_dir, "exp_setup.json"),
        "--mode", "mean_wo_update", "--device", "cpu",
    ])
    n_pred = _compare_test_outputs(cfg_j, cfg_t, "mean_wo_update")
    assert n_pred > 6 * 30
    # one metrics record per bucket; their predictions cover the cohort
    with open(os.path.join(cfg_t.exp_log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    recs = [r for r in recs if r["mode"] == "mean_wo_update"]
    assert {r["stage"] for r in recs} == {"test"}
    assert sum(r["predictions"] for r in recs) == n_pred
    assert all(r["sec_per_prediction"] > 0 for r in recs)


def test_cli_refuses_the_update_mode(staged):
    """CLI `test --mode mean_w_update --device cpu`, once refused, now
    writes what the JAX package's `test_cohort` writes in that mode (online
    momentum-SGD updates under the test prior), at the tolerances above."""
    cfg_j, cfg_t = staged
    recs = jcohort.load_cohort(cfg_j.data_dir, cfg_j.pans(), cfg_j.feature_list)
    jrunner.test_cohort(
        cfg_j, recs, folds=cfg_j.cv_assign(), modes=("mean_w_update",),
        use_mesh=False,
    )
    tcli.main([
        "test", "--cfg", os.path.join(cfg_t.exp_cfg_dir, "exp_setup.json"),
        "--mode", "mean_w_update", "--device", "cpu",
    ])
    assert _compare_test_outputs(cfg_j, cfg_t, "mean_w_update") > 6 * 30


@pytest.mark.parametrize("stage", ["train", "test", "kernclust", "run"])
def test_cli_without_a_card_stops_unless_asked_for_the_cpu(staged, stage):
    """`train`, `test`, `kernclust` and `run` run on the CUDA card by
    default; without one they stop with a message instead of falling back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    _, cfg_t = staged
    cfg = os.path.join(cfg_t.exp_cfg_dir, "exp_setup.json")
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit, match="pass --device cpu"):
            tcli.main([stage, "--cfg", cfg, *extra])
