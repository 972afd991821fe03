"""The port's train stage: resume from per-bucket checkpoints, and which
patients above the large-patient threshold it trains.

Resume mirrors tests/test_resume.py:13-45 (the JAX package's): a second run
restores every bucket with identical theta and loss and trains nothing; a
changed cohort re-trains its bucket; CLI `train --ckpt-dir` works. Only the
port's own resume is held: the JAX package caps its buckets otherwise and
writes orbax checkpoints, so bucket indices and files differ between them.

Above the threshold, SE and SM patients train in ordinary buckets and
LMC-SM patients leave them for the row-blocked path, as the JAX package
routes them. The SE case is held against the JAX
`train_cohort` as tests/test_torch_train.py holds the CLI train stage:
flags and counts equal, and the NLML at the two trained thetas, evaluated
alike in float64, within NLML_REL.
"""

import hashlib
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one torch
# thread each, as these small tensors gain nothing from more
torch.set_num_threads(1)

from medgp_tpu.config import experiment as jexp  # noqa: E402
from medgp_tpu.data import cohort as jcohort  # noqa: E402
from medgp_tpu.data import inits as jinits  # noqa: E402
from medgp_tpu.parallel import runner as jrunner  # noqa: E402
from medgp_tpu_torch.cli import main as tcli  # noqa: E402
from medgp_tpu_torch.config import experiment as texp  # noqa: E402
from medgp_tpu_torch.data import cohort as tcohort  # noqa: E402
from medgp_tpu_torch.data import synthetic as tsyn  # noqa: E402
from medgp_tpu_torch.models import gp as tgp  # noqa: E402
from medgp_tpu_torch.models import params as tparams  # noqa: E402
from medgp_tpu_torch.parallel import runner as trunner  # noqa: E402
from medgp_tpu_torch.utils.checkpoints import CohortCheckpointer  # noqa: E402

NLML_REL = 2e-2  # tests/test_torch_train.py's bound for the CLI train stage
OPT = dict(random_init_num=4, top_iteration_num=2, iteration_num_per_update=6)


def _experiment(root, pkg=texp, kernel="LMC-SM", features=(18, 19), n=5,
                n_obs=(20, 40), seed=9, prefix="resume"):
    data = root / "data"
    if not (data / "synth").exists():
        recs = tsyn.sample_cohort(seed, tparams.LMCSMSpec(1, len(features), 1), n,
                                  n_clusters=1, n_obs_range=n_obs)
        tsyn.write_reference_format_cohort(str(data / "synth"), recs, list(features))
    return pkg.generate_experiment(
        data_root=str(data), exp_root=str(root / prefix), cohort="synth",
        feature_list=list(features), kernel=kernel, Q=1, R=1, cv_fold_num=2,
        exp_prefix=prefix, opt_config=OPT,
    )


def _train_records(cfg):
    with open(os.path.join(cfg.exp_log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if '"stage": "train"' in line]


def test_train_resumes_every_bucket_and_retrains_a_changed_one(tmp_path):
    cfg = _experiment(tmp_path)
    recs = tcohort.load_cohort(cfg.data_dir, cfg.pans(), cfg.feature_list)
    ck = str(tmp_path / "ckpt")
    # two buckets of at most 3 patients
    out1 = trunner.train_cohort(cfg, recs, ckpt_dir=ck, max_batch=3, device="cpu")
    assert all(r["flag"] for r in out1.values())
    assert sorted(os.listdir(ck)) == ["bucket_0.npz", "bucket_1.npz"]
    n_trained = len(_train_records(cfg))
    assert n_trained == 2

    out2 = trunner.train_cohort(cfg, recs, ckpt_dir=ck, max_batch=3, device="cpu")
    assert len(_train_records(cfg)) == n_trained  # nothing trained
    assert set(out2) == set(out1)
    for pan, r in out1.items():
        np.testing.assert_array_equal(out2[pan]["theta"], r["theta"])
        np.testing.assert_array_equal(out2[pan]["init_theta"], r["init_theta"])
        np.testing.assert_array_equal(out2[pan]["var_state"], r["var_state"])
        assert out2[pan]["loss"] == r["loss"]
        assert (out2[pan]["flag"], out2[pan]["n_obs"]) == (r["flag"], r["n_obs"])

    # one patient fewer: the bucket that held it has another key and trains
    # again; the other keeps its key and is restored
    buckets = tcohort.pack_patients(recs, max_batch=3)
    drop = buckets[-1].pans[-1]
    out3 = trunner.train_cohort(
        cfg, [r for r in recs if r.pan != drop], ckpt_dir=ck, max_batch=3,
        device="cpu",
    )
    assert len(out3) == len(recs) - 1
    retrained = _train_records(cfg)[n_trained:]
    assert len(retrained) == 1 and retrained[0]["bucket"] == len(buckets) - 1


def test_checkpointer_round_trip(tmp_path):
    ck = CohortCheckpointer(str(tmp_path / "ck"))
    assert ck.load_bucket(0) is None
    state = dict(key=np.arange(1, dtype=np.int64), theta=np.ones((2, 3)),
                 flag=np.array([1, 0], np.int8), var_flat=None)
    ck.save_bucket(2, state)
    assert sorted(os.listdir(tmp_path / "ck")) == ["bucket_2.npz"]
    got = ck.load_bucket(2)
    assert set(got) == {"key", "theta", "flag"}
    np.testing.assert_array_equal(got["theta"], state["theta"])
    assert got["flag"].dtype == np.int8
    # the JAX package's key: sha256 of the joined ids, first 8 bytes
    assert trunner.bucket_key(["a", "b"]).tolist() == [
        int.from_bytes(hashlib.sha256(b"a|b").digest()[:8], "little", signed=True)
    ]


def test_cli_train_ckpt_dir_resumes(tmp_path, caplog):
    cfg = _experiment(tmp_path)
    argv = ["train", "--cfg", os.path.join(cfg.exp_cfg_dir, "exp_setup.json"),
            "--ckpt-dir", str(tmp_path / "ckpt"), "--device", "cpu"]
    tcli.main(argv)
    hyp = {p: open(os.path.join(cfg.exp_train_dir, f"train_hyp_{p}.bin"), "rb").read()
           for p in cfg.pans()}
    with caplog.at_level("INFO", logger="medgp_tpu_torch"):
        tcli.main(argv)
    assert "resumed bucket 0" in caplog.text
    assert len(_train_records(cfg)) == 1
    for p, b in hyp.items():
        assert open(os.path.join(cfg.exp_train_dir, f"train_hyp_{p}.bin"), "rb").read() == b


def test_se_patients_above_the_threshold_train_like_jax(tmp_path, monkeypatch):
    """An SE cohort (one feature) with the threshold below its longest
    patient: both packages train every patient in ordinary buckets."""
    kw = dict(kernel="SE", features=(18,), n=4, n_obs=(20, 60), seed=21)
    cfg_t = _experiment(tmp_path, prefix="se_torch", **kw)
    cfg_j = _experiment(tmp_path, pkg=jexp, prefix="se_jax", **kw)
    recs = jcohort.load_cohort(cfg_j.data_dir, cfg_j.pans(), cfg_j.feature_list)
    thr = max(r.n_obs for r in recs) - 1
    want = jrunner.train_cohort(cfg_j, recs, use_mesh=False, write=False,
                                large_threshold=thr)
    inits = np.asarray(jinits.random_inits(
        jax.random.key(cfg_j.random_seed), cfg_j.spec(), cfg_j.bounds(),
        cfg_j.random_init_num,
    ))
    monkeypatch.setattr(trunner, "random_inits",
                        lambda seed, spec, bounds, S: torch.tensor(inits))
    trecs = tcohort.load_cohort(cfg_t.data_dir, cfg_t.pans(), cfg_t.feature_list)
    got = trunner.train_cohort(cfg_t, trecs, write=False, large_threshold=thr,
                               device="cpu")
    assert set(got) == set(want)
    spec = tparams.SESpec()
    for rec in trecs:
        g, w = got[rec.pan], want[rec.pan]
        assert g["flag"] == w["flag"] and g["n_obs"] == w["n_obs"] == rec.n_obs
        np.testing.assert_array_equal(g["init_theta"], np.asarray(w["init_theta"]))
        if not g["flag"]:
            continue
        pad = 128 - rec.n_obs % 128
        data = tgp.PatientData(*(
            torch.as_tensor(np.pad(x, (0, pad)))[None] for x in (
                rec.t.astype(np.float64), rec.y.astype(np.float64), rec.meta,
                np.ones(rec.n_obs),
            )
        ))
        nl = [tgp.nlml_fn(spec, data)(torch.as_tensor(th, dtype=torch.float64)[None])[0]
              for th in (g["theta"], w["theta"])]
        np.testing.assert_allclose(nl[0].item(), nl[1].item(), rtol=NLML_REL,
                                   err_msg=rec.pan)
    assert sum(r["flag"] for r in got.values()) >= 3


def test_lmcsm_patients_above_the_threshold_are_refused(tmp_path):
    """LMC-SM patients above the threshold are refused by the buckets: they
    train after them by row blocks, one `train_large` record each (devices
    1), as the JAX package routes them (tests/test_torch_large_train.py
    holds that path to the JAX one). At the longest patient's count
    nothing is above it."""
    cfg = _experiment(tmp_path)
    recs = tcohort.load_cohort(cfg.data_dir, cfg.pans(), cfg.feature_list)
    thr = max(r.n_obs for r in recs) - 1
    big = [r.pan for r in recs if r.n_obs > thr]
    out = trunner.train_cohort(cfg, recs, large_threshold=thr, write=False, device="cpu")
    assert set(out) == {r.pan for r in recs}
    large = _stage_records(cfg, "train_large")
    assert [r["pan"] for r in large] == big and [r["devices"] for r in large] == [1]
    assert sum(r["batch"] for r in _train_records(cfg)) == len(recs) - 1
    out = trunner.train_cohort(cfg, recs[:1], large_threshold=recs[0].n_obs,
                               write=False, device="cpu")
    assert len(out) == 1
    assert len(_stage_records(cfg, "train_large")) == 1


def _stage_records(cfg, stage):
    with open(os.path.join(cfg.exp_log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["stage"] == stage]