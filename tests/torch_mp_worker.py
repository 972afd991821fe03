"""One rank of a `torch.distributed` world (gloo, CPU) for the multi-rank
tests of the port (tests/test_torch_mesh.py, tests/test_torch_multiprocess.py).

    torchrun --standalone --nproc-per-node W tests/torch_mp_worker.py MODE IN.npz OUT_DIR [CFG ...]

`torchrun` sets RANK, WORLD_SIZE and the rendezvous; every rank runs the
same scenarios in the same order (the collectives must match) and saves
what it got to OUT_DIR/rank{r}.npz for the pytest parent to compare with a
one-rank run and with the JAX package. MODE is

  * "mesh": the collective functions of parallel/mesh.py on the inputs of
    IN.npz (population noise modes, the sharded train step in float32
    and float64, the row-sharded large-patient NLML and gradient), `host_shard` and the
    per-rank metrics file;
  * "cohort": the CLI `run` on CFG[0], then `train_cohort`,
    `test_cohort` (both modes) with the mesh on CFG[1] and `hmc_cohort`
    with each sampler on CFG[0]'s trained patients, each rank planning
    from its own memory budget (`plan_budgets`), and the row-sharded
    value+gradient with the size of every tensor it makes.

Every rank joins the process group first (`init_distributed`, gloo on the
CPU), so the CLI finds it, and leaves it at the end.

It imports nothing of JAX.
"""

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

N_PATIENTS, N_OBS = 8, 16
SPEC_ARGS = (1, 2, 1)  # Q, D, R
LARGE_N, LARGE_BLOCKS = 256, 8
HMC = dict(num_chains=2, num_warmup=4, num_samples=4, num_leapfrog=4)
# hmc_cohort's budgets by sampler (VI: 4 ADVI steps, 4 draws)
SAMPLER_RUNS = {
    "hmc": HMC,
    "nuts": dict(num_chains=2, num_warmup=4, num_samples=4, max_depth=3),
    "vi": dict(num_warmup=4, num_samples=4),
}


def build_cohort():
    """tests/mp_worker.py's cohort: 8 patients of 16 observations."""
    rng = np.random.default_rng(718)
    ts, ys, metas = [], [], []
    for _ in range(N_PATIENTS):
        t = np.sort(rng.uniform(0, 72, size=N_OBS))
        meta = rng.integers(0, SPEC_ARGS[1], size=N_OBS)
        meta[:4] = [0, 1, 0, 1]
        y = np.sin(0.3 * t) + 0.1 * rng.normal(size=N_OBS)
        ts.append(t)
        ys.append(y)
        metas.append(meta)
    return (
        np.asarray(ts, np.float32), np.asarray(ys, np.float32),
        np.asarray(metas, np.int32), np.ones((N_PATIENTS, N_OBS), np.float32),
    )


def cohort_batch():
    """`build_cohort` padded to 32 observations (K3's block) by mask-0
    entries, as a bucket pads it."""
    return tuple(np.pad(x, ((0, 0), (0, 32 - N_OBS))) for x in build_cohort())


BUCKET_N = 128  # the bucket of every patient (data/cohort.py:bucket_edges)
# one train patient of that bucket (utils/hbm.py:train_batch_cap)
BUCKET_UNIT = 4 * 6 * 4 * BUCKET_N ** 2
BUCKET_LOW, BUCKET_HIGH = BUCKET_UNIT, 16 * BUCKET_UNIT
LARGE_LOW, LARGE_HIGH = 700_000, 4_000_000
LARGE_PLAN_LOW = (8, 32)  # large_block_plan(LARGE_N, LARGE_LOW, 1, world=1, 2 or 4)


def plan_budgets(rank, world):
    """The CPU budgets (utils/hbm.py:CPU_BUDGET_BYTES) of `cohort_results`'
    direct calls, (buckets, large patient), which differ by rank: the last
    rank has the least. At BUCKET_LOW the train, test and sampler caps
    bind (train and sampler buckets of W patients, test buckets of 3), at
    BUCKET_HIGH none does; at LARGE_LOW the large patient takes
    LARGE_PLAN_LOW at any world, at LARGE_HIGH fewer, wider blocks. So
    ranks that planned each from its own budget would form other buckets
    and blocks than their neighbours. One rank (world 1) packs its
    buckets from the default budget (None) and plans the large patient
    from LARGE_LOW."""
    if world == 1:
        return None, LARGE_LOW
    low = rank == world - 1
    return (BUCKET_LOW if low else BUCKET_HIGH), (LARGE_LOW if low else LARGE_HIGH)


@contextlib.contextmanager
def cpu_budget(nbytes):
    """utils/hbm.py's CPU budget set to nbytes (None: left as it is)."""
    from medgp_tpu_torch.utils import hbm

    old = hbm.CPU_BUDGET_BYTES
    hbm.CPU_BUDGET_BYTES = old if nbytes is None else nbytes
    try:
        yield
    finally:
        hbm.CPU_BUDGET_BYTES = old


# varEM (top_iters, sub_opt_iter) of the "mesh" sharded train step by
# dtype: float64 runs one warm round, as tests/test_torch_train.py holds
# float64 training; beyond it the trajectories of this cohort part even
# in float64 (the JAX package's sharded and vmapped steps by up to 0.41
# of a loss at 2 x 8)
MESH_TRAIN_BUDGETS = {"float32": (2, 8), "float64": (1, 5)}

OPT = dict(random_init_num=4, top_iteration_num=2, iteration_num_per_update=8)


def stage(root):
    """The cohort of `build_cohort` in the reference format under
    root/data, and two experiments of LMC-SM(1, 2, 1) at OPT's budgets
    with two folds: "cli" on all 8 patients, "api" on the first 7 (so a
    world of 2 or 4 pads its bucket with an all-masked dummy), with a mode
    kernel for fold -1. Returns (cli exp_setup.json, api exp_setup.json)."""
    from medgp_tpu_torch.config.experiment import ExperimentConfig, generate_experiment
    from medgp_tpu_torch.data import formats
    from medgp_tpu_torch.data.cohort import PatientRecord
    from medgp_tpu_torch.data.synthetic import write_reference_format_cohort
    from medgp_tpu_torch.models.params import LMCSMSpec

    t, y, meta, _ = build_cohort()
    recs = [PatientRecord(f"p{i}", t[i], y[i], meta[i]) for i in range(N_PATIENTS)]
    paths = []
    for name, rr in (("cli", recs), ("api", recs[:-1])):
        write_reference_format_cohort(os.path.join(root, "data", name), rr, [18, 19])
        cfg = generate_experiment(
            data_root=os.path.join(root, "data"), exp_root=os.path.join(root, "exp"),
            cohort=name, feature_list=[18, 19], Q=SPEC_ARGS[0], R=SPEC_ARGS[2],
            cv_fold_num=2, exp_prefix=name, opt_config=OPT,
        )
        paths.append(os.path.join(cfg.exp_top_dir, "config", "exp_setup.json"))
    spec = LMCSMSpec(*SPEC_ARGS)
    theta = np.random.default_rng(0).normal(size=spec.n_hyp) * 0.3
    theta[:spec.n_lik] = np.log(0.3)
    formats.write_mode_kernel(ExperimentConfig.from_json(paths[1]).exp_kernel_dir, -1, "gmm",
                              theta, SPEC_ARGS[0])
    return tuple(paths)


def large_case():
    """A random patient of LARGE_N observations (tests/test_torch_large_
    train.py's memory case), padded for LARGE_BLOCKS row blocks, and a
    theta, both from a seed."""
    from medgp_tpu_torch.infer.large_train import pad_observations
    from medgp_tpu_torch.models.params import LMCSMSpec

    rng = np.random.default_rng(2)
    spec = LMCSMSpec(*SPEC_ARGS)
    t = np.sort(rng.uniform(0, 72, LARGE_N))
    meta = rng.integers(0, spec.D, LARGE_N)
    y = rng.normal(size=LARGE_N)
    args = tuple(torch.as_tensor(a) for a in pad_observations(t, y, meta, LARGE_BLOCKS * 32))
    theta = rng.normal(size=spec.n_hyp) * 0.3
    theta[:spec.n_lik] = np.log(0.3)
    return spec, args, torch.as_tensor(theta.astype(np.float32))[None]


def large_record():
    """large_case's patient as a record (its observations unpadded)."""
    from medgp_tpu_torch.data.cohort import PatientRecord

    _, (t, y, meta, mask), _ = large_case()
    n = int(mask.sum())
    return PatientRecord("big", t[:n].numpy(), y[:n].numpy(), meta[:n].numpy())


def large_value_and_grad(mesh):
    """(value, gradient, the largest tensor any op made) of the row-sharded
    objective under the hier-gamma prior."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from medgp_tpu_torch.models.priors import hier_gamma_prior
    from medgp_tpu_torch.parallel.mesh import large_patient_objective

    class Sizes(TorchDispatchMode):
        largest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for x in torch.utils._pytree.tree_leaves(out):
                if isinstance(x, torch.Tensor):
                    self.largest = max(self.largest, x.numel())
            return out

    spec, args, theta = large_case()
    f = large_patient_objective(spec, LARGE_BLOCKS, *args,
                                prior=hier_gamma_prior(spec, beta_lam=0.01), mesh=mesh)
    with Sizes() as sizes:
        v, g, ok = f(theta)
    assert bool(ok)
    return v.numpy(), g.numpy(), sizes.largest


def run_mesh(inp, out):
    from medgp_tpu_torch.models.gp import PatientData
    from medgp_tpu_torch.models.params import LMCSMSpec
    from medgp_tpu_torch.parallel.launch import host_shard
    from medgp_tpu_torch.parallel.mesh import (
        cohort_mesh, large_patient_nlml, large_patient_nlml_diff, local_rows,
        population_noise_mode, population_noise_modes_by_fold, sharded_train_step,
    )
    from medgp_tpu_torch.utils.metrics import MetricsWriter

    mesh = cohort_mesh("cpu")
    spec = LMCSMSpec(*SPEC_ARGS)
    res = {}

    fn = population_noise_modes_by_fold(spec, mesh, int(inp["n_folds"]))
    res["noise_modes"] = fn(*(local_rows(mesh, torch.as_tensor(inp[k]))
                              for k in ("pop_theta", "pop_flags", "pop_cv"))).numpy()
    res["noise_mode"] = population_noise_mode(spec, mesh)(
        *(local_rows(mesh, torch.as_tensor(inp[k])) for k in ("pop_theta", "pop_flags"))).numpy()

    for dtype in (np.float32, np.float64):
        top, sub = MESH_TRAIN_BUDGETS[np.dtype(dtype).name]
        step = sharded_train_step(spec, mesh, torch.as_tensor(inp["inits"].astype(dtype)),
                                  prior_mode=2, top_iters=top, sub_opt_iter=sub)
        tr = step(PatientData(*(torch.as_tensor(x.astype(dtype) if x.dtype.kind == "f" else x)
                                for x in cohort_batch())))
        tag = np.dtype(dtype).name
        res.update({f"train_{k}_{tag}": getattr(tr, k).numpy()
                    for k in ("theta", "loss", "flag", "n_evals", "init_theta")})

    lspec = LMCSMSpec(*(int(x) for x in inp["large_spec"]))
    blocks = int(inp["large_blocks"])
    args = [torch.as_tensor(inp[k]) for k in ("large_t", "large_y", "large_meta", "large_mask")]
    theta = torch.as_tensor(inp["large_theta"])
    v, ok = large_patient_nlml(lspec, blocks, mesh=mesh)(theta, *args)
    th = theta.clone().requires_grad_()
    vd, okd = large_patient_nlml_diff(lspec, blocks, mesh=mesh)(th, *args)
    vd.backward()
    res.update(large_value=v.numpy(), large_ok=bool(ok), large_diff_value=vd.detach().numpy(),
               large_grad=th.grad.numpy())

    res["host_shard"] = np.asarray(host_shard([f"p{i}" for i in range(10)],
                                              [(i + 1) ** 3 for i in range(10)]))
    writer = MetricsWriter(os.path.join(out, "log", "metrics.jsonl"), run_id="mesh")
    writer.write("probe", rank=mesh.rank)
    res["metrics_path"] = np.asarray(writer.path)
    np.savez(os.path.join(out, f"rank{mesh.rank}.npz"), **res)


def cohort_results(cfg_cli, cfg_api, mesh_of):
    """The CLI `run` on cfg_cli, then, each within its rank's budget
    (`plan_budgets`), `train_cohort` (not written; also the large patient
    alone), `test_cohort` (both modes) on cfg_api and `hmc_cohort` with
    each sampler of SAMPLER_RUNS on cfg_cli's trained patients, and the
    large value+gradient: a dict of arrays. `mesh_of()` gives the mesh, or
    None: then every call runs on one device (the samplers on whole
    buckets), the one-rank run the tests compare with."""
    from medgp_tpu_torch.cli.main import main as cli
    from medgp_tpu_torch.config.experiment import ExperimentConfig
    from medgp_tpu_torch.data.cohort import load_cohort
    from medgp_tpu_torch.parallel.runner import hmc_cohort, test_cohort, train_cohort

    cli(["run", "--cfg", cfg_cli, "--device", "cpu"])
    mesh = mesh_of()
    use_mesh = True if mesh is not None else None
    buckets, large = plan_budgets(*((0, 1) if mesh is None else (mesh.rank, mesh.world)))
    res = {}
    cfg = ExperimentConfig.from_json(cfg_api)
    recs = load_cohort(cfg.data_dir, cfg.pans(), cfg.feature_list)
    with cpu_budget(buckets):
        tr = train_cohort(cfg, recs, write=False, device="cpu", use_mesh=use_mesh)
    for pan, r in tr.items():
        for k in ("theta", "loss", "flag"):
            res[f"train/{pan}/{k}"] = np.asarray(r[k])
    # a patient of LARGE_N observations above the large-patient threshold
    big = large_record()
    with cpu_budget(large):
        lg = train_cohort(cfg, [big], write=False, device="cpu", use_mesh=use_mesh,
                          large_threshold=LARGE_N - 1)
    for k in ("theta", "loss", "flag", "blocks", "block_rows"):
        res[f"large_train/{k}"] = np.asarray(lg[big.pan][k])
    with cpu_budget(buckets):
        te = test_cohort(cfg, recs, device="cpu", use_mesh=use_mesh)
    for pan, r in te.items():
        for mode, d in r.items():
            for k in ("pred", "error", "ci", "var"):
                res[f"test/{pan}/{mode}/{k}"] = d[k]
    cfg_run = ExperimentConfig.from_json(cfg_cli)
    run_recs = load_cohort(cfg_run.data_dir, cfg_run.pans(), cfg_run.feature_list)
    for sampler, kw in SAMPLER_RUNS.items():
        with cpu_budget(buckets):
            hm = hmc_cohort(cfg_run, run_recs, write=False, device="cpu", use_mesh=use_mesh,
                            sampler=sampler, **kw)
        for pan, r in hm.items():
            res[f"{sampler}/{pan}/samples"] = r["samples"]
    v, g, largest = large_value_and_grad(mesh)
    res.update(large_value=v, large_grad=g, large_largest=largest)
    return res


if __name__ == "__main__":
    from medgp_tpu_torch.parallel.launch import init_distributed
    from medgp_tpu_torch.parallel.mesh import cohort_mesh

    mode, inp_path, out_dir = sys.argv[1:4]
    init_distributed(device="cpu")
    try:
        if mode == "mesh":
            run_mesh(dict(np.load(inp_path)), out_dir)
        else:
            got = cohort_results(*sys.argv[4:6], lambda: cohort_mesh("cpu"))
            np.savez(os.path.join(out_dir, f"rank{os.environ['RANK']}.npz"), **got)
    finally:
        torch.distributed.destroy_process_group()
    print(f"rank {os.environ.get('RANK')} done", flush=True)
