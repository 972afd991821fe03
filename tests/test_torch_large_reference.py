"""The port's row-blocked large-patient objective against the plain PyTorch
reference of its benchmark, and what the path writes of its spans and
counters.

`port_bench/reference/lmcsm.py` is written from the model's equations and
imports nothing of the port; `medgp_tpu_torch/parallel/mesh.py` walks P row
blocks (P = 3 here, forced) with K3 and K5's plain twins on the CPU. Both
take the same patient and theta under a hier-gamma prior whose A variances
are not all 1 and some of whose A elements are clamped, as in varEM's
later rounds.

Tolerances: against the reference in float64, the port in float64 to 1e-8
(value relative, gradient relative to its largest entry: the two sum in
other orders); the port in float32 to 1e-4 and 2e-3, the bounds
tests/test_torch_large_train.py holds the port's float32 blocked path to.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from medgp_tpu_torch.config.experiment import ExperimentConfig  # noqa: E402
from medgp_tpu_torch.data.cohort import PatientRecord  # noqa: E402
from medgp_tpu_torch.infer import large_train  # noqa: E402
from medgp_tpu_torch.models import params, priors  # noqa: E402
from medgp_tpu_torch.parallel import mesh, runner  # noqa: E402
from medgp_tpu_torch.utils import hbm, metrics  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "port_bench_reference_lmcsm", os.path.join(ROOT, "port_bench", "reference", "lmcsm.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

P = 3
TOL = {torch.float64: (1e-8, 1e-8), torch.float32: (1e-4, 2e-3)}


def _patient(rng, D, n):
    """Sorted times over a week, every output at least twice."""
    t = np.sort(rng.uniform(0.0, 168.0, n)).astype(np.float32)
    meta = np.concatenate([np.arange(2 * D) % D, rng.integers(0, D, n - 2 * D)])
    return t, rng.normal(size=n).astype(np.float32), rng.permutation(meta).astype(np.int32)


def _prior(spec, rng):
    """hier-gamma with the A variances drawn and every seventh A element
    clamped."""
    pr = priors.hier_gamma_prior(spec, 0.01)
    sl = params.cov_slices(spec)["a"]
    scale, ptype = pr.scale.clone(), pr.ptype.clone()
    scale[sl] = torch.as_tensor(rng.uniform(0.2, 3.0, sl.stop - sl.start), dtype=scale.dtype)
    ptype[sl.start:sl.stop:7] = priors.PRIOR_CLAMP
    return pr._replace(scale=scale, ptype=ptype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("Q,D,R,n", [(2, 3, 2, 300), (5, 24, 8, 200)], ids=["q2d3r2", "d24"])
def test_blocked_objective_matches_the_plain_reference(Q, D, R, n, dtype):
    rng = np.random.default_rng(Q * 100 + n)
    spec = params.LMCSMSpec(Q, D, R)
    t, y, meta = _patient(rng, D, n)
    theta = ref.random_inits(718, Q, D, R, 1)
    prior = _prior(spec, rng)
    b = hbm.large_block_plan(n, 0, Q, blocks=P)[1]
    args = tuple(torch.as_tensor(a) for a in large_train.pad_observations(t, y, meta, P * b))
    args = tuple(a.to(dtype) if a.is_floating_point() else a for a in args)
    pr = prior._replace(loc=prior.loc.to(dtype), scale=prior.scale.to(dtype))
    before = metrics.snapshot()
    v, g, ok = mesh.large_patient_objective(spec, P, *args, prior=pr)(theta.to(dtype))
    assert metrics.since(before)["large.retry_factorizations"] == 0  # jitter multiplier 1
    assert ok.tolist() == [True]

    f64 = dict(dtype=torch.float64)
    want_v, want_g, want_ok = ref.objective_and_grad(
        theta.double(), torch.as_tensor(t, **f64)[None], torch.as_tensor(y, **f64)[None],
        torch.as_tensor(meta)[None], torch.ones((1, n), dtype=torch.bool), Q, D, R,
        {k: getattr(prior, k).double() if k in ("loc", "scale") else getattr(prior, k)
         for k in ("active", "exp_tf", "ptype", "loc", "scale")})
    assert bool(want_ok[0])
    vtol, gtol = TOL[dtype]
    assert v.item() == pytest.approx(want_v.item(), rel=vtol)
    assert float((g.double() - want_g).abs().max()) <= gtol * float(want_g.abs().max())
    clamped = (prior.active & (prior.ptype == priors.PRIOR_CLAMP))
    assert clamped.any() and torch.all(g[0][clamped] == 0)


def _experiment(tmp_path, threshold):
    return ExperimentConfig(
        data_dir=str(tmp_path / "data"), exp_top_dir=str(tmp_path),
        exp_log_dir=str(tmp_path / "log"), exp_train_dir=str(tmp_path / "train"),
        Q=1, D=2, R=1, feature_index="0 1 ", random_init_num=3, top_iteration_num=2,
        iteration_num_per_update=8, large_patient_threshold=threshold)


@pytest.mark.parametrize("profiled", [True, False], ids=["profiler", "no-profiler"])
def test_train_large_record_carries_the_paths_spans_and_counters(tmp_path, monkeypatch,
                                                                 profiled):
    """A lowered threshold sends the longer patient by row blocks (P = 4
    blocks of 32 rows, K3's block): its `train_large` record carries the
    table's gain over the patient, spans only under a profiler.
    `large.evaluations` is the number of calls SCG made of the blocked
    objective (counted here by a wrapper), `large.screen_values` the
    restarts, and every factorization (one per value, one per screen value,
    one per jitter retry) factors each of the P diagonal blocks by K3 and
    inverts it by K5."""
    monkeypatch.setattr(hbm, "LARGE_BLOCK_MAX", 32)
    rng = np.random.default_rng(8)
    recs = [PatientRecord(f"p{n}", *_patient(rng, 2, n)) for n in (40, 120)]
    calls = []
    orig = large_train.large_patient_objective

    def counted(*a, **k):
        f = orig(*a, **k)

        def g(theta, idx=None):
            calls.append(1)
            return f(theta, idx)
        return g
    monkeypatch.setattr(large_train, "large_patient_objective", counted)
    cfg = _experiment(tmp_path, threshold=100)
    if profiled:
        with torch.autograd.profiler.profile():
            out = runner.train_cohort(cfg, recs, write=False, device="cpu")
    else:
        out = runner.train_cohort(cfg, recs, write=False, device="cpu")
    assert out["p120"]["flag"] and out["p120"]["blocks"] == 4
    with open(os.path.join(cfg.exp_log_dir, "metrics.jsonl")) as f:
        (rec,) = [r for r in map(json.loads, f) if r["stage"] == "train_large"]
    assert (rec["pan"], rec["blocks"], rec["block_rows"]) == ("p120", 4, 32)
    assert rec["large.evaluations"] == len(calls) > 0
    assert rec["large.screen_values"] == 3
    assert rec["large.factorizations"] == (
        rec["large.evaluations"] + rec["large.screen_values"] + rec["large.retry_factorizations"])
    assert rec["k3.systems"] == rec["k5.systems"] == 4 * rec["large.factorizations"]
    spans = ("medgp.train.large", "medgp.large.screen", "medgp.large.objective",
             "medgp.large.factor", "medgp.large.backward")
    if not profiled:
        # the table keeps earlier spans' entries: none gained anything here
        assert all(v == 0 for k, v in rec.items() if k.startswith(("span_s.", "self_s.", "calls.")))
        return
    for s in spans:
        assert rec["span_s." + s] > 0 and rec["self_s." + s] >= 0, s
    assert rec["calls.medgp.train.large"] == 1 and rec["calls.medgp.large.screen"] == 1
    assert rec["calls.medgp.large.objective"] == rec["large.evaluations"]
    assert rec["calls.medgp.large.factor"] == rec["large.evaluations"] + rec["large.screen_values"]
    assert rec["calls.medgp.large.backward"] == rec["large.evaluations"]
    assert rec["span_s.medgp.large.objective"] + rec["span_s.medgp.large.screen"] \
        <= rec["span_s.medgp.train.large"]
    assert rec["span_s.medgp.large.factor"] + rec["span_s.medgp.large.backward"] \
        <= rec["span_s.medgp.large.objective"] + rec["span_s.medgp.large.screen"]
