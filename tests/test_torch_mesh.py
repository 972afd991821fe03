"""The port's mesh layer against the JAX package's.

`medgp_tpu_torch/parallel/{mesh,launch,bucketing}.py` against
`medgp_tpu/parallel/` on the same numpy inputs. The JAX side runs on the
8-device virtual CPU mesh of tests/conftest.py; the port's collective
functions run in a world of 4 CPU ranks over gloo (tests/torch_mp_worker.py
"mesh", started by `torchrun --standalone` once for the module, while the
JAX side runs here). The host-side pieces run here.

Tolerances:
  * `sharded_train_step`: bitwise equal to the port's one-device
    `train_one_patient` in both dtypes. Against the JAX package's, in
    float64 (`jax.enable_x64()`) over one varEM warm round of 5 x 20
    evaluations, loss within 1e-6 relative, each theta within 1e-6 of its
    largest entry, and the chosen
    restarts exactly, as tests/test_torch_train.py holds float64
    training (at 2 x 8 the JAX package's own sharded and vmapped steps
    part by up to 0.41 of a loss in float64). In float32, at 2 x 8, each patient's loss within 1% of the JAX
    package's, or within ULP_SPREAD_X times the JAX package's own move
    when its inits move by one ulp, whichever is larger: on this cohort
    (16 observations, varEM 2 x 8) that move exceeds 1% of the loss for
    every patient but p6 (0.9%), up to 39% for p2, so the float32 bound is
    the spread's for seven of eight (ROADMAP.md §C); float64 holds the
    arithmetic;
  * `population_noise_modes_by_fold` 1e-5 relative; `masked_weighted_kde_
    mode` and `_masked_percentile` 1e-6, NaN for no flagged entry;
  * the row-sharded `large_patient_nlml` at P = 4 blocks over the 4 ranks:
    value 1e-5 relative; `large_patient_nlml_diff` in float32: gradient
    within 2e-3 of the row's scale (tests/test_pallas_*'s gradient bound);
  * `pad_batch_to`, `pack_patients(batch_multiple=)`, `balance_shards`,
    `host_shard`, `patient_cost` and `shard_imbalance`: exactly.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from medgp_tpu.data import cohort as jcohort  # noqa: E402
from medgp_tpu.data import inits as jinits  # noqa: E402
from medgp_tpu.models import gp as jgp  # noqa: E402
from medgp_tpu.models import params as jparams  # noqa: E402
from medgp_tpu.parallel import bucketing as jbucket  # noqa: E402
from medgp_tpu.parallel import launch as jlaunch  # noqa: E402
from medgp_tpu.parallel import mesh as jmesh  # noqa: E402
from medgp_tpu_torch.data import cohort as tcohort  # noqa: E402
from medgp_tpu_torch.infer import map_train as tmap  # noqa: E402
from medgp_tpu_torch.infer.large_train import pad_observations  # noqa: E402
from medgp_tpu_torch.infer.online import online_impute, unique_times  # noqa: E402
from medgp_tpu_torch.models import gp as tgp  # noqa: E402
from medgp_tpu_torch.models import params as tparams  # noqa: E402
from medgp_tpu_torch.parallel import bucketing as tbucket  # noqa: E402
from medgp_tpu_torch.parallel import launch as tlaunch  # noqa: E402
from medgp_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from medgp_tpu_torch.parallel import runner as trunner  # noqa: E402
from medgp_tpu_torch.utils import hbm  # noqa: E402
from tests import torch_mp_worker as worker  # noqa: E402
from tests.test_nlml import random_theta  # noqa: E402
from tests.test_torch_multiprocess import finish, spawn  # noqa: E402
from tests.test_varem import synth_lmcsm_patient  # noqa: E402

W = 4
LARGE_P = 4
LOSS_REL = 1e-2
ULP_SPREAD_X = 4.0  # as tests/test_torch_train.py
F64_REL = 1e-6  # as tests/test_torch_train.py
MODE_REL = 1e-5
KDE_TOL = 1e-6
VALUE_REL = 1e-5
GRAD_TOL = 2e-3


def _inputs():
    """The worker's inputs, from seeds: tests/test_mesh.py's population
    (16 patients of LMC-SM(1, 2, 1), two folds), the JAX restart draws of
    tests/test_multiprocess.py, and a large patient of 64 observations of
    LMC-SM(2, 2, 1) with a theta."""
    rng = np.random.default_rng(718)
    spec = jparams.LMCSMSpec(*worker.SPEC_ARGS)
    B = 16
    pop_theta = rng.normal(size=(B, spec.n_hyp)).astype(np.float32)
    pop_flags = (rng.uniform(size=B) > 0.25).astype(np.float32)
    pop_flags[:4] = 1.0
    pop_cv = rng.integers(0, 2, size=B).astype(np.int32)
    pop_cv[:4] = [0, 0, 1, 1]
    inits = np.array(jinits.random_inits(jax.random.key(0), spec,
                                           jinits.default_bounds(spec), 4))
    lrng = np.random.default_rng(11)
    lspec = jparams.LMCSMSpec(2, 2, 1)
    d = synth_lmcsm_patient(lrng, lspec, n=64)
    b = hbm.large_block_plan(64, 0, 2, blocks=LARGE_P)[1]
    tp, yp, mp, maskp = pad_observations(*(np.asarray(x) for x in (d.t, d.y, d.meta)),
                                         LARGE_P * b)
    return dict(
        n_folds=2, pop_theta=pop_theta, pop_flags=pop_flags, pop_cv=pop_cv, inits=inits,
        large_spec=np.asarray([2, 2, 1]), large_blocks=LARGE_P,
        large_theta=random_theta(lrng, lspec).astype(np.float32),
        large_t=tp, large_y=yp, large_meta=mp, large_mask=maskp,
    ), d


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    inp, patient = _inputs()
    np.savez(root / "in.npz", **inp)
    log_path = str(root / "world.log")
    proc, log = spawn(W, ["mesh", str(root / "in.npz"), str(root)], log_path)

    # the JAX package on its 8-device mesh meanwhile
    spec = jparams.LMCSMSpec(*worker.SPEC_ARGS)
    mesh = jmesh.cohort_mesh()
    data = jgp.PatientData(*(jnp.asarray(x) for x in worker.cohort_batch()))
    jtrain, *jmoved = (
        jmesh.sharded_train_step(spec, mesh, jnp.asarray(x), prior_mode=2, top_iters=2,
                                 sub_opt_iter=8)(data)
        for x in (inp["inits"], np.nextafter(inp["inits"], np.inf),
                  np.nextafter(inp["inits"], -np.inf)))
    top, sub = worker.MESH_TRAIN_BUDGETS["float64"]
    with jax.enable_x64():
        data64 = jgp.PatientData(*(jnp.asarray(x.astype(np.float64) if x.dtype.kind == "f" else x)
                                   for x in worker.cohort_batch()))
        jtrain64 = jax.tree.map(np.asarray, jmesh.sharded_train_step(
            spec, mesh, jnp.asarray(inp["inits"].astype(np.float64)), prior_mode=2,
            top_iters=top, sub_opt_iter=sub)(data64))
    jmodes = jmesh.population_noise_modes_by_fold(spec, mesh, 2)(
        *(jnp.asarray(inp[k]) for k in ("pop_theta", "pop_flags", "pop_cv")))
    jmode = jmesh.population_noise_mode(spec, mesh)(
        *(jnp.asarray(inp[k]) for k in ("pop_theta", "pop_flags")))
    lspec = jparams.LMCSMSpec(2, 2, 1)
    jargs = (patient.t, patient.y, patient.meta, patient.mask)
    jth = jnp.asarray(inp["large_theta"])
    jval, jok = jmesh.large_patient_nlml(lspec, mesh)(jth, *jargs)
    jdiff = jmesh.large_patient_nlml_diff(lspec, mesh)
    jdv, jgrad = jax.value_and_grad(lambda th: jdiff(th, *jargs)[0])(jth)

    finish(proc, log, log_path)
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(W)]
    return dict(
        inp=inp, root=root, ranks=ranks,
        jtrain=jax.tree.map(np.asarray, jtrain), jtrain64=jtrain64, jmodes=np.asarray(jmodes),
        jmode=np.asarray(jmode),
        jmoved=[np.asarray(m.loss) for m in jmoved],
        jlarge=(float(jval), bool(jok), float(jdv), np.asarray(jgrad)),
    )


# --- the collective functions, over 4 ranks ------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_train_step_matches_jax_and_one_device(case, dtype):
    got = {k: case["ranks"][0][f"train_{k}_{dtype}"]
           for k in ("theta", "loss", "flag", "n_evals", "init_theta")}
    assert got["flag"].all()
    if dtype == "float64":
        want = case["jtrain64"]
        assert want.flag.all()
        np.testing.assert_array_equal(got["init_theta"], want.init_theta)
        np.testing.assert_allclose(got["loss"], want.loss, rtol=F64_REL)
        err = np.abs(got["theta"] - want.theta).max(axis=1)
        assert (err <= F64_REL * np.abs(want.theta).max(axis=1)).all(), err
    else:
        want = case["jtrain"]
        assert want.flag.all()
        spread = np.max([np.abs(m - want.loss) for m in case["jmoved"]], axis=0)
        bound = np.maximum(LOSS_REL * np.abs(want.loss), ULP_SPREAD_X * spread)
        assert (np.abs(got["loss"] - want.loss) <= bound).all(), (got["loss"], want.loss, spread)
        # where JAX moves under 1% with its inits, the bound is the 1%
        assert list(np.nonzero(spread <= LOSS_REL * np.abs(want.loss))[0]) == [6], spread
    spec = tparams.LMCSMSpec(*worker.SPEC_ARGS)
    dt = getattr(np, dtype)
    top, sub = worker.MESH_TRAIN_BUDGETS[dtype]
    one = tmap.train_one_patient(
        spec, tgp.PatientData(*(torch.as_tensor(x.astype(dt) if x.dtype.kind == "f" else x)
                                for x in worker.cohort_batch())),
        torch.as_tensor(case["inp"]["inits"].astype(dt)), prior_mode=2, eta=0.01,
        beta_lam=0.01, top_iters=top, sub_opt_iter=sub)
    np.testing.assert_array_equal(got["theta"], one.theta.numpy())
    np.testing.assert_array_equal(got["loss"], one.loss.numpy())
    np.testing.assert_array_equal(got["n_evals"], one.n_evals.numpy())


@pytest.mark.parametrize("which", ["noise_modes", "noise_mode"])
def test_population_noise_modes_match_jax(case, which):
    """`population_noise_modes_by_fold` (every fold and all) and
    `population_noise_mode` (all), on every rank alike."""
    want = case["jmodes"] if which == "noise_modes" else case["jmode"]
    assert want.shape == ((3, 2) if which == "noise_modes" else (2,))
    for rank in case["ranks"]:
        np.testing.assert_allclose(rank[which], want, rtol=MODE_REL)
        np.testing.assert_array_equal(rank[which], case["ranks"][0][which])


def test_large_patient_nlml_matches_jax(case):
    jval, jok, _, _ = case["jlarge"]
    for rank in case["ranks"]:
        assert bool(rank["large_ok"]) and jok
        assert float(rank["large_value"]) == pytest.approx(jval, rel=VALUE_REL)


def test_large_patient_nlml_diff_matches_jax(case):
    _, _, jdv, jgrad = case["jlarge"]
    scale = np.abs(jgrad).max()
    for rank in case["ranks"]:
        assert float(rank["large_diff_value"]) == pytest.approx(jdv, rel=VALUE_REL)
        assert np.abs(rank["large_grad"] - jgrad).max() <= GRAD_TOL * scale


def test_host_shard_over_ranks_matches_jax(case):
    pans = [f"p{i}" for i in range(10)]
    costs = [(i + 1) ** 3 for i in range(10)]
    got = [list(r["host_shard"]) for r in case["ranks"]]
    assert got == [jlaunch.host_shard(pans, costs, process_index=r, process_count=W)
                   for r in range(W)]
    assert sorted(sum(got, [])) == sorted(pans)


def test_per_rank_metrics_files(case):
    for r, rank in enumerate(case["ranks"]):
        name = "metrics.jsonl" if r == 0 else f"metrics.p{r}.jsonl"
        assert str(rank["metrics_path"]) == str(case["root"] / "log" / name)
        with open(str(rank["metrics_path"])) as f:
            (rec,) = [json.loads(x) for x in f]
        assert (rec["process"], rec["stage"], rec["rank"]) == (r, "probe", r)


# --- the population statistics, here --------------------------------------

def _kde_cases():
    rng = np.random.default_rng(3)
    xs = rng.lognormal(size=16).astype(np.float32)
    flags = {
        "all": np.ones(16), "some": (rng.uniform(size=16) > 0.4) * 1.0,
        "one": np.eye(16)[5], "none": np.zeros(16),
        "ties": np.ones(16),
    }
    out = {k: (xs, f.astype(np.float32)) for k, f in flags.items()}
    out["ties"] = (np.repeat(xs[:4], 4), out["ties"][1])
    return out


@pytest.mark.parametrize("which", ["all", "some", "one", "none", "ties"])
def test_masked_kde_mode_and_percentile_match_jax(which):
    xs, flags = _kde_cases()[which]
    want = float(jmesh.masked_weighted_kde_mode(jnp.asarray(xs), jnp.asarray(flags)))
    got = tmesh.masked_weighted_kde_mode(torch.as_tensor(xs), torch.as_tensor(flags))
    if which == "none":
        assert np.isnan(want) and torch.isnan(got)
    else:
        assert got.item() == pytest.approx(want, rel=KDE_TOL)
    for q in (25.0, 50.0, 75.0):
        want = float(jmesh._masked_percentile(jnp.asarray(xs), jnp.asarray(flags), q))
        got = tmesh._masked_percentile(torch.as_tensor(xs), torch.as_tensor(flags), q)
        if which != "none":
            assert got.item() == pytest.approx(want, rel=KDE_TOL)


def test_masked_kde_mode_batches_over_leading_axes():
    cases = _kde_cases()
    xs = torch.as_tensor(np.stack([c[0] for c in cases.values()]))
    fl = torch.as_tensor(np.stack([c[1] for c in cases.values()]))
    got = tmesh.masked_weighted_kde_mode(xs, fl)
    for i in range(len(cases)):
        one = tmesh.masked_weighted_kde_mode(xs[i], fl[i])
        assert (torch.isnan(one) and torch.isnan(got[i])) or got[i] == one


# --- host copies, exactly ----------------------------------------------------

def test_bucketing_matches_jax_exactly():
    ns = [100, 5000, 200, 4800, 150, 5100, 90, 4700, 3]
    for q in (1, 5):
        assert [tbucket.patient_cost(n, q) for n in ns] == [jbucket.patient_cost(n, q) for n in ns]
    costs = [jbucket.patient_cost(n) for n in ns]
    for k in (1, 2, 3, 4):
        got, want = tbucket.balance_shards(costs, k), jbucket.balance_shards(costs, k)
        assert [list(x) for x in got] == [list(x) for x in want]
        assert tbucket.shard_imbalance(costs, got) == jbucket.shard_imbalance(costs, want)
    pans = [f"p{i}" for i in range(10)]
    c = [(i + 1) ** 3 for i in range(10)]
    for pc in (1, 3, 4):
        for pi in range(pc):
            assert tlaunch.host_shard(pans, c, process_index=pi, process_count=pc) == \
                jlaunch.host_shard(pans, c, process_index=pi, process_count=pc)
    assert tlaunch.host_shard(pans) == pans  # no process group: one rank


def test_pad_batch_to_matches_jax_exactly():
    t, y, meta, mask = worker.build_cohort()
    want = jmesh.pad_batch_to(jgp.PatientData(*(jnp.asarray(x) for x in (t, y, meta, mask))), 12)
    got = tmesh.pad_batch_to(tgp.PatientData(*(torch.as_tensor(x) for x in (t, y, meta, mask))), 12)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, str(w.dtype))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    same = tgp.PatientData(*(torch.as_tensor(x) for x in (t, y, meta, mask)))
    assert tmesh.pad_batch_to(same, 8) is same


@pytest.mark.parametrize("multiple", [1, 2, 4])
def test_pack_patients_batch_multiple_matches_jax_exactly(multiple):
    rng = np.random.default_rng(9)
    ns = [40, 60, 130, 140, 150, 300, 310, 600, 90, 200, 250, 700, 20]
    jrecs, trecs = [], []
    for i, n in enumerate(ns):
        t = np.sort(rng.uniform(0, 100, n)).astype(np.float32)
        y = rng.normal(size=n).astype(np.float32)
        m = rng.integers(0, 2, n).astype(np.int32)
        jrecs.append(jcohort.PatientRecord(f"p{i}", t, y, m))
        trecs.append(tcohort.PatientRecord(f"p{i}", t, y, m))
    want = jcohort.pack_patients(jrecs, max_batch=4, batch_multiple=multiple)
    got = tcohort.pack_patients(trecs, max_batch=4, batch_multiple=multiple, device="cpu")
    assert [b.pans for b in got] == [b.pans for b in want]
    for g, w in zip(got, want):
        assert g.n_max == w.n_max
        for k in ("t", "y", "meta", "mask"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
    if multiple > 1:
        assert all(len(b) % multiple == 0 for b in got[:-1] if b.n_max != got[-1].n_max)


# --- all-masked dummy rows ----------------------------------------------------

def test_all_masked_rows_leave_real_rows_alone():
    """A bucket padded with all-masked dummies (`pad_batch_to`) trains and
    tests its real rows to the same bits and evaluation counts; a dummy's
    NLML is +inf (not NaN) at the first jitter multiplier, and it comes
    out untrained."""
    spec = tparams.LMCSMSpec(*worker.SPEC_ARGS)
    t, y, meta, mask = (torch.as_tensor(x[:3]) for x in worker.cohort_batch())
    data = tgp.PatientData(t, y, meta, mask)
    padded = tmesh.pad_batch_to(data, 5)
    inits = torch.as_tensor(np.array(jinits.random_inits(
        jax.random.key(0), jparams.LMCSMSpec(*worker.SPEC_ARGS),
        jinits.default_bounds(jparams.LMCSMSpec(*worker.SPEC_ARGS)), 4)))
    kw = dict(prior_mode=2, top_iters=2, sub_opt_iter=8)
    a = tmap.train_one_patient(spec, data, inits, **kw)
    b = tmap.train_one_patient(spec, padded, inits, **kw)
    for k in ("theta", "loss", "init_theta", "flag", "n_evals"):
        np.testing.assert_array_equal(getattr(b, k)[:3].numpy(), getattr(a, k).numpy(), err_msg=k)
    assert not b.flag[3:].any() and torch.isinf(b.loss[3:]).all()
    value, res = tgp.nlml_fn(spec, padded)(b.init_theta)
    assert torch.isinf(value[3:]).all() and not torch.isnan(value).any()
    assert res.mult.tolist() == [1] * 5
    ut = np.zeros((5, 32), np.float32)
    uv = np.zeros((5, 32), bool)
    for i in range(3):
        ut[i], uv[i] = unique_times(t[i].numpy(), mask[i].numpy(), pad_to=32)
    theta = torch.as_tensor(random_theta(np.random.default_rng(1), spec).astype(np.float32))
    for update in (False, True):
        one = online_impute(spec, theta, data, torch.as_tensor(ut[:3]), torch.as_tensor(uv[:3]),
                            update=update)
        pad = online_impute(spec, theta, padded, torch.as_tensor(ut), torch.as_tensor(uv),
                            update=update)
        for k, x in one._asdict().items():
            np.testing.assert_array_equal(getattr(pad, k)[:3].numpy(), x.numpy(), err_msg=k)
        assert not pad.valid[3:].any()


# --- launch, policy ------------------------------------------------------------

def test_backend_rule_and_single_rank_init():
    assert tlaunch.default_backend("cuda") == "nccl"
    assert tlaunch.default_backend("cpu") == "gloo"
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        tlaunch.init_distributed(backend="nccl", world_size=2, rank=0, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tlaunch.init_distributed(backend="mpi", world_size=2, rank=0, device="cpu")
    tlaunch.init_distributed(world_size=1)  # a world of one starts no group
    assert not torch.distributed.is_initialized()
    assert tlaunch.rank_device("cpu") == torch.device("cpu")


def test_mesh_policy_without_a_group():
    assert trunner.mesh_or_none(None, torch.device("cpu")) is None
    assert trunner.mesh_or_none(False, torch.device("cpu")) is None
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        trunner.mesh_or_none(True, torch.device("cpu"))


def test_scheduler_launcher_variants(tmp_path):
    """The JAX package's three flavours and headers (tests/test_aux.py:
    157-205), with a torchrun of the port's `run` as the run line."""
    sh = tlaunch.write_slurm_launcher(str(tmp_path / "run.sh"), "/x/exp_setup.json",
                                      num_hosts=4, gpus_per_host=8)
    body = open(sh).read()
    assert "#SBATCH -N 4" in body and "#SBATCH --ntasks-per-node=1" in body
    assert "#SBATCH --gpus-per-node=8" in body
    assert "srun torchrun --nnodes 4 --nproc-per-node 8" in body
    assert "-m medgp_tpu_torch.cli.main run --cfg /x/exp_setup.json --alg gmm" in body
    assert os.access(sh, os.X_OK)

    pbs = tlaunch.write_scheduler_launcher(
        str(tmp_path / "run_pbs.sh"), "/x/exp_setup.json", num_hosts=2,
        scheduler="pbs", time_limit="12:00:00", gpus_per_host=4,
    )
    body = open(pbs).read()
    assert "#PBS -l select=2:ncpus=1:ngpus=4" in body and "walltime=12:00:00" in body
    assert "#PBS -V" in body and "torchrun --nnodes 2 --nproc-per-node 4" in body
    assert "medgp_tpu_torch.cli.main run" in body

    seq = tlaunch.write_scheduler_launcher(
        str(tmp_path / "run_seq.sh"), "/x/exp_setup.json", num_hosts=1,
        scheduler="sequential", extra_cmd=["echo done"], memory="8G",
    )
    body = open(seq).read()
    assert "#SBATCH" not in body and "#PBS" not in body
    assert "torchrun --standalone --nproc-per-node 1" in body and "echo done" in body
    assert os.access(seq, os.X_OK)

    with pytest.raises(NotImplementedError):
        tlaunch.write_scheduler_launcher(str(tmp_path / "x.sh"), "/x", 1, scheduler="lsf")


def test_port_imports_no_jax():
    """The mesh layer and the worker stand alone on a machine without JAX."""
    code = ("import sys; import medgp_tpu_torch.parallel.mesh, medgp_tpu_torch.parallel.launch, "
            "medgp_tpu_torch.cli.main, tests.torch_mp_worker; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'medgp_tpu.'))"
            " or m == 'medgp_tpu']; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    res = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.dirname(os.path.abspath(worker.__file__))),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
