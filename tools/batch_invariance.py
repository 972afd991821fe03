"""Whether the train path gives a patient the same bits in any batch, on
the card: chip_smoke.py's 64-patient cohort at canonical width, one
bucket at a time.

    python3 tools/batch_invariance.py      # on a CUDA card; ~3 minutes

For each bucket (n = 128, 256, 512) it compares, bitwise, rows of the full
bucket against the same rows evaluated in smaller batches:

  * the objective+gradient (`models/gp.py:objective_and_grad` through
    `idx` subsets of 1, 2, B/2 and B-1 rows, as SCG evaluates its active
    rows), and op by op at a batch of one (the gram, the noise, K3's L and
    alpha, the NLML value, the log prior, K4, B = A A^T + diag(kappa));
  * SCG's per-row dot product over the H hypers (`infer/scg.py:_dot`) at
    1, 2, B/2 and B-1 rows;
  * the bucket's two halves (the second padded with an all-masked dummy,
    as two ranks train it) against the whole: the restart screen
    (`screen_inits`, B S against B/2 S systems), SCG without a prior from
    the screen's best restart (`scg_minimize`), and `train_one_patient`
    (the screen and hier-gamma varEM);
  * `train_one_patient` on the halves again with SCG's `_dot` replaced by
    one sum per row, which no batch size can reorder;
  * at n = 128, where the first two parted: every objective evaluation of
    the whole bucket's training and of its halves' is recorded per
    patient (`Recorder`), and for each patient the first evaluation where
    the runs part is named, "optimizer" where SCG / varEM handed the
    objective other inputs, "objective" where the same inputs gave other
    outputs; at the first "objective" one, the evaluation is replayed op
    by op in both batches (`replay`), with `_dot` as it is and per row.

Prints one line per bucket of (equal, largest absolute difference) pairs
and writes them to .chip_smoke/batch_invariance.json.
"""
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from medgp_tpu_torch.data.cohort import load_cohort, pack_patients  # noqa: E402
from medgp_tpu_torch.data.inits import random_inits  # noqa: E402
from medgp_tpu_torch.infer import map_train as tmap  # noqa: E402
from medgp_tpu_torch.infer import scg, varem  # noqa: E402
from medgp_tpu_torch.models import gp  # noqa: E402
from medgp_tpu_torch.models.priors import hier_gamma_prior, log_prior  # noqa: E402
from medgp_tpu_torch.ops import cuda_build, cuda_chol  # noqa: E402
from medgp_tpu_torch.parallel.mesh import pad_batch_to  # noqa: E402
from medgp_tpu_torch.parallel.runner import batch_data  # noqa: E402


def eq(a, b):
    return bool(torch.equal(a, b)), float((a.double() - b.double()).abs().max())


def row_dot(a, b):
    """`scg._dot` as one reduction per row: the same order at any batch."""
    return torch.stack([torch.sum(a[i] * b[i]) for i in range(a.shape[0])])


def pad_batch_to_rows(x, h):
    """x (k, H) padded to h rows with copies of its first row."""
    return torch.cat([x, x[:1].expand(h - x.shape[0], -1)])


def halves(fn, data, B, dev):
    """fn on rows 0..h-1 and h..B-1 of data (h = ceil(B / 2), the second
    padded to h with an all-masked dummy, as two ranks run a bucket),
    each result's tensor fields concatenated and cut to B rows."""
    h = (B + 1) // 2
    parts = [fn(pad_batch_to(data.rows(torch.arange(s, min(s + h, B), device=dev)), h))
             for s in (0, h)]
    return type(parts[0])(*(torch.cat([getattr(p, k) for p in parts])[:B]
                            if isinstance(getattr(parts[0], k), torch.Tensor) else None
                            for k in parts[0]._fields))


def probe_bucket(spec, b, inits, prior, kw, dev):
    """The comparisons of the module docstring on one bucket: a dict of
    (equal, largest absolute difference) pairs."""
    B = len(b)
    data = batch_data(b, dev)
    th = inits[torch.arange(B, device=dev) % inits.shape[0]]
    f = gp.objective_and_grad(spec, data, prior)
    v, g, _ = f(th)
    r = {}
    for m in (1, 2, B // 2, B - 1):
        vm, gm, _ = f(th[:m], torch.arange(m, device=dev))
        r[f"objective idx size {m}"] = (eq(vm, v[:m]), eq(gm, g[:m]))
    one = data.rows(torch.arange(1, device=dev))
    K = gp.noiseless_gram(spec, th, data, masked=True)
    K1 = gp.noiseless_gram(spec, th[:1], one, masked=True)
    r["gram"] = eq(K1, K[:1])
    nv = gp.noise_variance(spec, th, data.meta)
    nv1 = gp.noise_variance(spec, th[:1], one.meta)
    r["noise_variance"] = eq(nv1, nv[:1])
    L, a, ld = cuda_chol.chol_solve(K, nv, data.y)
    L1, a1, ld1 = cuda_chol.chol_solve(K1, nv1, one.y)
    r["chol L/alpha"] = (eq(L1, L[:1]), eq(a1, a[:1]))
    val, _ = gp.nlml_fn(spec, data, prior)(th)
    val1, _ = gp.nlml_fn(spec, one, prior)(th[:1])
    r["nlml_fn value"] = eq(val1, val[:1])
    r["log_prior"] = eq(log_prior(prior, th[:1]), log_prior(prior, th)[:1])
    c = torch.ones(B, device=dev)
    r["qmat"] = eq(cuda_chol.qmat(L1, ld1, a1, c[:1]), cuda_chol.qmat(L, ld, a, c)[:1])
    p, p1 = spec.unpack(th), spec.unpack(th[:1])
    r["coregional_B"] = eq(spec.coregional_B(p1["A"], p1["kappa"]),
                           spec.coregional_B(p["A"], p["kappa"])[:1])
    for m in (1, 2, B // 2, B - 1):
        r[f"scg _dot rows {m}"] = eq(scg._dot(g[:m], th[:m]), scg._dot(g, th)[:m])
    screen = tmap.screen_inits(spec, data, inits)
    screen_h = halves(lambda d: tmap.screen_inits(spec, d, inits), data, B, dev)
    r["screen halves best_loss"] = eq(screen_h.best_loss, screen.best_loss)
    r["screen halves best_theta"] = eq(screen_h.best_theta, screen.best_theta)

    def scg_of(d, x0):
        return scg.scg_minimize(gp.objective_and_grad(spec, d, None), x0, 40)

    x0 = screen.best_theta
    h = (B + 1) // 2
    whole = scg_of(data, x0)
    parts = [scg_of(pad_batch_to(data.rows(torch.arange(s, min(s + h, B), device=dev)), h),
                    pad_batch_to_rows(x0[s:s + h], h)) for s in (0, h)]
    r["scg halves x"] = eq(torch.cat([p.x for p in parts])[:B], whole.x)
    full = tmap.train_one_patient(spec, data, inits, **kw)
    part = halves(lambda d: tmap.train_one_patient(spec, d, inits, **kw), data, B, dev)
    r["train halves theta"] = eq(part.theta, full.theta)
    r["train halves evals"] = part.n_evals.tolist() == full.n_evals.tolist()
    own = scg._dot
    scg._dot = row_dot
    try:
        full = tmap.train_one_patient(spec, data, inits, **kw)
        part = halves(lambda d: tmap.train_one_patient(spec, d, inits, **kw), data, B, dev)
    finally:
        scg._dot = own
    r["train halves theta, _dot per row"] = eq(part.theta, full.theta)
    return r


class Recorder:
    """Wraps `objective_and_grad` so that every evaluation is kept, per
    patient of `data` (known by its t row), with its batch."""

    def __init__(self, data, B):
        self.ids = {data.t[i].cpu().numpy().tobytes(): i for i in range(B)}
        self.log = {}

    def wrap(self, make):
        def made(spec, d, pr=None, max_retries=10):
            f = make(spec, d, pr, max_retries)

            def g(x, idx=None):
                v, gr, ok = f(x, idx)
                dd = d if idx is None else d.rows(idx)
                pp = pr if pr is None or idx is None else pr.rows(idx)
                for j in range(dd.t.shape[0]):
                    p = self.ids.get(dd.t[j].cpu().numpy().tobytes())
                    if p is not None:
                        self.log.setdefault(p, []).append(dict(
                            x=x[j].clone(), v=v[j].clone(), g=gr[j].clone(), j=j,
                            xs=x.clone(), d=dd, pr=pp))
                return v, gr, ok

            return g

        return made


def replay(spec, ev):
    """The recorded evaluation `ev` op by op: its patient's row of each."""
    xs, d, pr, j = ev["xs"], ev["d"], ev["pr"], ev["j"]
    out = dict(gram=gp.noiseless_gram(spec, xs, d, masked=True)[j],
               noise=gp.noise_variance(spec, xs, d.meta)[j])
    th = xs.detach().requires_grad_()
    with torch.enable_grad():
        value, res = gp.nlml_fn(spec, d, None)(th)
        (g,) = torch.autograd.grad(torch.where(res.ok, res.nlml, torch.zeros_like(value)).sum(),
                                   th)
        out.update(nlml=value[j].detach(), mult=res.mult[j], nlml_grad=g[j])
        if pr is not None:
            lp = log_prior(pr, th)
            (gp_,) = torch.autograd.grad(lp.sum(), th)
            out.update(log_prior=lp[j].detach(), log_prior_grad=gp_[j])
    return out


def first_parting(spec, b, inits, kw, dev, row_dot_on):
    """Train the bucket whole and by halves with every evaluation recorded;
    per patient, where the two runs first part (see the module
    docstring)."""
    data = batch_data(b, dev)
    B = len(b)
    own_make, own_dot = varem.objective_and_grad, scg._dot
    logs = []
    try:
        if row_dot_on:
            scg._dot = row_dot
        for split in (False, True):
            rec = Recorder(data, B)
            varem.objective_and_grad = rec.wrap(own_make)
            if split:
                halves(lambda d: tmap.train_one_patient(spec, d, inits, **kw), data, B, dev)
            else:
                tmap.train_one_patient(spec, data, inits, **kw)
            logs.append(rec.log)
    finally:
        varem.objective_and_grad, scg._dot = own_make, own_dot
    out, replayed = {}, None
    for p in range(B):
        a, h = logs[0].get(p, []), logs[1].get(p, [])
        where = ["same", min(len(a), len(h))]
        for k, (ea, eh) in enumerate(zip(a, h)):
            if not torch.equal(ea["x"], eh["x"]):
                where = ["optimizer", k]
                break
            if not (torch.equal(ea["v"], eh["v"]) and torch.equal(ea["g"], eh["g"])):
                where = ["objective", k, ea["xs"].shape[0], eh["xs"].shape[0]]
                if replayed is None:
                    ra, rh = replay(spec, ea), replay(spec, eh)
                    replayed = dict(patient=p, evaluation=k, rows=where[2:],
                                    **{op: eq(ra[op], rh[op]) for op in ra})
                break
        out[f"patient {p}"] = where
    out["replayed"] = replayed
    return out


def main():
    if not torch.cuda.is_available():
        print("batch_invariance: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    shutil.rmtree(cs.WORK, ignore_errors=True)
    os.makedirs(cs.WORK)
    t0 = time.time()
    cuda_build.build_library()
    print("build", time.time() - t0, flush=True)
    _, cfg, _, _ = cs.stage_cohort()
    spec = cfg.spec()
    recs = load_cohort(cfg.data_dir, cfg.pans(), cfg.feature_list)
    inits = random_inits(cfg.random_seed, spec, cfg.bounds(), cfg.random_init_num).to(dev)
    prior = hier_gamma_prior(spec, beta_lam=cfg.beta_lam, device=dev)
    kw = dict(prior_mode=cfg.prior_index, eta=cfg.eta, beta_lam=cfg.beta_lam,
              top_iters=cfg.top_iteration_num, sub_opt_iter=cfg.iteration_num_per_update)
    report = {}
    for b in pack_patients(recs, max_batch=128, device=dev):
        r = probe_bucket(spec, b, inits, prior, kw, dev)
        if b.n_max == 128:
            for on in (False, True):
                r[f"first parting, _dot per row: {on}"] = first_parting(
                    spec, b, inits, kw, dev, on)
        report[f"n_max={b.n_max} B={len(b)}"] = r
        print(f"n_max={b.n_max} B={len(b)}: {json.dumps(r)}", flush=True)
    with open(os.path.join(cs.WORK, "batch_invariance.json"), "w") as f:
        json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
