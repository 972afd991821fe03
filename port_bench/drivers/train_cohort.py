"""Unit: one `parallel/runner.train_cohort` call on a shard of the cohort.

Set-up draws the cohort from the seed (`benchlib.cohort`), splits it into
shards of `shard_patients` with the same spread of lengths, and warms the
train path on a few patients of every bucket length the shards use. The
window cycles through the shards; a patient counts as done when its flag
is true and its theta is finite, else as failed.

The check (`check`) recomputes with the float64 reference
(`reference/lmcsm.py`, `reference/varem.py`):
  * objective_value_gap, objective_grad_gap: the objective and its
    gradient at the thetas where the window's varEM/SCG evaluated them
    (rows kept by `benchlib.taps.ObjectiveTap` from a seeded share of the
    calls, one from each half of the call's batch), at the jitter
    multiplier the program's factorization used and under the prior the
    program's varEM held in that round (its psi scales and clamps: the
    E-step that made them is checked by the replay below). Per row,
    value: |v - v64| / max(1, |v64|); gradient: max |g - g64| / max
    |g64|. Rows are grouped by bucket length and batch half; the number is
    the largest over the groups of the `row_quantile` quantile within
    each (a few rows at ill-conditioned points carry float32's own error,
    whatever the kernels do). Any row that is no patient of the cohort
    fails both;
  * screen_pick_gap: for patients drawn from the seed, the restart the
    screen picked against the best of the restart set by float64 NLML:
    (nlml64(init) - min_s nlml64(restart_s)) / max(1, |min|);
  * step_change_gap: for the same patients, the first trial step of the
    first M-step (the line search's first point, x0 - g0 / (1 + |g0|^2),
    which carries the gradient as the optimizer gets it), taken from the
    program's call by the tap, against the reference's from the same
    start: per leaf of theta (noise, A, mu, v, kappa) the norm of the
    change from the start, |n - n64| / max(n64, the median leaf's n64),
    the largest over the leaves and the patients;
  * estep_gap: the prior variance of A that the program's first E-step
    set (the second round's prior, read by the tap) against the
    reference's E-step from the program's own start of that round:
    max |psi - psi64| / median psi64, the largest over the patients;
  * fit_change_gap: varEM replayed in float64 by the reference, all of
    it, from the restart the program picked: the change from it per leaf
    as above, the program's trained theta against the replay's, the
    median over the patients (float32 and float64 line searches part ways
    over 200 evaluations, so a few patients' fits end elsewhere).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from benchlib.cohort import interleaved_shards, make_cohort
from benchlib.taps import ObjectiveTap
from reference import lmcsm, varem

MIN_ROWS = 8         # objective rows the check needs in all
MIN_GROUP_ROWS = 6   # rows a group of one bucket length and batch half needs to be read
ROW_CHUNK = 32       # rows the reference recomputes at once


class Driver:
    work_unit = "patients"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg_json, self.traffic = ctx.config, ctx.traffic
        c = self.cfg_json
        self.Q, self.D, self.R = c["Q"], c["D"], c["R"]
        self.outputs = {}   # pan -> (theta, init_theta) of patients trained
        self.patients = {}  # pan -> benchlib.cohort.Patient
        self.tap = None
        self.unit_seconds = []

    # ------------------------------------------------------------------
    def _experiment(self):
        from medgp_tpu_torch.config.experiment import ExperimentConfig

        c, work = self.cfg_json, self.ctx.workdir
        return ExperimentConfig(
            data_dir=os.path.join(work, "data"), exp_top_dir=work,
            exp_log_dir=os.path.join(work, "log"),
            exp_train_dir=os.path.join(work, "train"),
            kernel="LMC-SM", kernel_index=7, prior="hier-gamma", prior_index=2,
            Q=self.Q, D=self.D, R=self.R,
            feature_index="".join(f"{f} " for f in c["feature_index"]),
            eta=c["eta"], beta_lam=c["beta_lam"],
            random_init_num=c["random_init_num"], random_seed=c["random_seed"],
            top_iteration_num=c["top_iteration_num"],
            iteration_num_per_update=c["iteration_num_per_update"],
            online_learn_rate=c["online_learn_rate"],
            online_momentum=c["online_momentum"],
        )

    def _records(self, pats):
        from medgp_tpu_torch.data.cohort import PatientRecord

        return [PatientRecord(pan=p.pan, t=p.t, y=p.y, meta=p.meta) for p in pats]

    def setup(self):
        from medgp_tpu_torch.parallel import runner

        self.runner = runner
        tr = self.traffic
        pats, _ = make_cohort(
            self.ctx.seed, self.Q, self.D, self.R, tr["n_patients"], tr["n_clusters"],
            tr["n_obs"], tr["t_max_hours"], device=self.ctx.device,
        )
        self.patients = {p.pan: p for p in pats}
        self.shards = [self._records(s) for s in interleaved_shards(pats, tr["shard_patients"])]
        self.exp = self._experiment()
        # warm-up: a few patients of every bucket length the shards use,
        # each bucket length alone, so every shape is met before the window
        per = int(tr["warmup_patients_per_bucket"])
        warm = {}
        for r in self.shards[0]:
            edge = 128
            while edge < r.n_obs:
                edge *= 2
            if len(warm.setdefault(edge, [])) < per:
                warm[edge].append(r)
        for group in warm.values():
            runner.train_cohort(self.exp, group, write=False, device=self.ctx.device)

    def open_window(self):
        every = int(self.traffic["check"]["objective_calls_every"])
        self.tap = ObjectiveTap(self.ctx.seed, every).__enter__()

    def close_window(self):
        self.tap.__exit__(None, None, None)

    def unit(self, i):
        """Run unit i; returns (done, failed) patients."""
        shard = self.shards[i % len(self.shards)]
        t0 = time.perf_counter()
        out = self.runner.train_cohort(self.exp, shard, write=False, device=self.ctx.device)
        self.unit_seconds.append(time.perf_counter() - t0)
        done = failed = 0
        for pan, r in out.items():
            good = bool(r["flag"]) and bool(np.all(np.isfinite(r["theta"])))
            done += good
            failed += not good
            if good:
                self.outputs[pan] = (np.asarray(r["theta"]), np.asarray(r["init_theta"]))
        return done, failed

    def release(self):
        self.kept_rows = self.tap.host_rows() if self.tap is not None else []
        self.kept_starts = self.tap.host_starts() if self.tap is not None else []
        self.tap = None
        self.shards = None

    # ------------------------------------------------------------------
    def _match(self, row):
        """The patient whose observations fill this padded row, or None;
        the row must hold them in order, then zeros."""
        n = int(round(float(row["mask"].sum())))
        for p in self._by_len.get(n, ()):
            if np.array_equal(p.t, row["t"][:n]) and np.array_equal(p.y, row["y"][:n]) \
                    and np.array_equal(p.meta, row["meta"][:n]) \
                    and not row["mask"][n:].any() and not row["t"][n:].any():
                return p
        return None

    def check(self, dtype=torch.float64, tf32=False):
        """[(name, value, limit)] of the window's outputs against the
        reference computed in `dtype` (the control: float32 with TF32)."""
        dev = self.ctx.device
        limits = self.traffic["check"]["limits"]
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            res = {**self._row_numbers(dev, dtype), **self._fit_numbers(dev, dtype)}
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        return [(k, v, limits[k]) for k, v in res.items()]

    def _data(self, pats, dev, dt=torch.float64):
        """(t, y, meta, mask) of patients, padded to the longest."""
        n = max(len(p.t) for p in pats)
        t = torch.zeros((len(pats), n), dtype=torch.float64)
        y = torch.zeros_like(t)
        meta = torch.zeros((len(pats), n), dtype=torch.int64)
        mask = torch.zeros((len(pats), n), dtype=torch.bool)
        for i, p in enumerate(pats):
            k = len(p.t)
            t[i, :k], y[i, :k] = torch.as_tensor(p.t).double(), torch.as_tensor(p.y).double()
            meta[i, :k], mask[i, :k] = torch.as_tensor(p.meta), True
        return t.to(dev, dt), y.to(dev, dt), meta.to(dev), mask.to(dev)

    def _row_numbers(self, dev, dtype, ref_dtype=torch.float64):
        """objective_value_gap, objective_grad_gap: the rows the tap kept,
        recomputed; per group of rows of one bucket length and one half of
        the batch, the `row_quantile` quantile of each row's gap; the
        number is the largest over the groups of MIN_GROUP_ROWS rows or
        more."""
        Q, D, R = self.Q, self.D, self.R
        self._by_len = {}
        for p in self.patients.values():
            self._by_len.setdefault(len(p.t), []).append(p)
        rows, stray = [], False
        for row in self.kept_rows:
            if not bool(row["ok"]):
                continue
            p = self._match(row)
            if p is None:
                stray = True  # a row that is no patient of the cohort
            else:
                rows.append((row, p))
        keys = ("active", "exp_tf", "ptype", "loc", "scale")

        def evaluate(chunk, dt):
            pats = [p for _, p in chunk]
            th = torch.as_tensor(np.stack([r["theta"] for r, _ in chunk]), device=dev).to(dt)
            if "prior_active" in chunk[0][0]:
                pr = {k: torch.as_tensor(np.stack([r["prior_" + k] for r, _ in chunk]), device=dev)
                      for k in keys}
                pr["loc"], pr["scale"] = pr["loc"].to(dt), pr["scale"].to(dt)
            else:
                pr = None
            mult = torch.as_tensor([1.0 if r["mult"] is None else float(r["mult"])
                                    for r, _ in chunk], device=dev, dtype=dt)
            return lmcsm.objective_and_grad(th, *self._data(pats, dev, dt), Q, D, R, pr, mult)

        groups = {}
        for s in range(0, len(rows), ROW_CHUNK):
            chunk = rows[s:s + ROW_CHUNK]
            v_ref, g_ref, ok_ref = evaluate(chunk, ref_dtype)
            if dtype == ref_dtype:
                v = torch.as_tensor(np.array([float(r["value"]) for r, _ in chunk]), device=dev)
                g = torch.as_tensor(np.stack([r["grad"] for r, _ in chunk]), device=dev).double()
            else:  # the control: the reference in `dtype`, in the program's place
                v, g, _ = evaluate(chunk, dtype)
                v, g = v.double(), g.double()
            vgap = (v - v_ref).abs() / v_ref.abs().clamp(min=1.0)
            ggap = (g - g_ref).abs().amax(1) / g_ref.abs().amax(1).clamp(min=1e-30)
            inf = torch.full_like(vgap, math.inf)
            vgap, ggap = torch.where(ok_ref, vgap, inf), torch.where(ok_ref, ggap, inf)
            for (r, _), a, b in zip(chunk, vgap.tolist(), ggap.tolist()):
                key = (len(r["t"]), int(r["half"]))
                groups.setdefault(key, ([], []))
                groups[key][0].append(a)
                groups[key][1].append(b)
        q = float(self.traffic["check"]["row_quantile"])
        read = {k: g for k, g in groups.items() if len(g[0]) >= MIN_GROUP_ROWS}
        if stray or len(rows) < MIN_ROWS or not read:
            vgap = ggap = math.inf
        else:
            vgap = max(float(np.quantile(g[0], q)) for g in read.values())
            ggap = max(float(np.quantile(g[1], q)) for g in read.values())
        self.detail = dict(
            rows=len(rows), groups={f"{n}/{h}": [len(g[0]), float(np.quantile(g[0], q)),
                                                 float(np.quantile(g[1], q))]
                                    for (n, h), g in sorted(groups.items())},
            jittered=int(sum(r["mult"] is not None and float(r["mult"]) > 1 for r, _ in rows)))
        return {"objective_value_gap": vgap, "objective_grad_gap": ggap}

    def _fit_numbers(self, dev, dtype, ref_dtype=torch.float64):
        """screen_pick_gap, step_change_gap, estep_gap and fit_change_gap
        for patients drawn from the seed (see the module's docstring)."""
        c = self.cfg_json
        Q, D, R = self.Q, self.D, self.R
        rng = np.random.default_rng([int(self.ctx.seed) & 0xFFFFFFFF, int(self.ctx.seed) >> 32, 11])
        pans = sorted(self.outputs)
        k = min(int(self.traffic["check"]["screen_patients"]), len(pans))
        names = ("screen_pick_gap", "step_change_gap", "estep_gap", "fit_change_gap")
        if not k:
            return dict.fromkeys(names, math.inf)
        chosen = [pans[i] for i in sorted(rng.choice(len(pans), size=k, replace=False))]
        pats = [self.patients[p] for p in chosen]
        data = self._data(pats, dev)
        leaves = _leaves(Q, D, R)
        a_sl = leaves[1]

        # the screen's pick against the best of the restart set
        inits = lmcsm.random_inits(c["random_seed"], Q, D, R, c["random_init_num"]).to(dev)
        S = inits.shape[0]
        sgap = 0.0
        for i, pan in enumerate(chosen):
            one = [x[i:i + 1].expand(S, -1) for x in data]
            vals = lmcsm.nlml(inits.double(), *one, Q, D, R)[0]
            best = float(vals.min())
            if dtype == ref_dtype:
                init = torch.as_tensor(self.outputs[pan][1], device=dev)[None]
                picked = float(lmcsm.nlml(init, *[x[:1] for x in one], Q, D, R)[0][0])
            else:  # the control picks by its own NLML
                cv = lmcsm.nlml(inits.to(dtype), *[x.to(dtype) if x.is_floating_point() else x
                                                   for x in one], Q, D, R)[0]
                cv = torch.where(torch.isfinite(cv), cv, torch.full_like(cv, math.inf))
                picked = float(vals[int(torch.argmin(cv))])
            sgap = max(sgap, (picked - best) / max(1.0, abs(best)))

        # the first trial step of the first M-step, and the first E-step,
        # from the program's own start of each round
        step_at, round2 = self._starts(set(chosen))
        prior0 = varem.hier_gamma_prior(Q, D, R, c["beta_lam"], np.float64)
        theta0 = np.stack([self.outputs[p][1] for p in chosen]).astype(np.float64)
        stepgap = egap = 0.0
        have = [i for i, p in enumerate(chosen) if p in step_at]
        if len(have) < len(chosen) or len(round2) < len(chosen):
            stepgap = egap = math.inf  # a patient whose rounds the tap did not see
        if have:
            x0 = np.stack([step_at[chosen[i]][0] for i in have])
            idx = torch.as_tensor(have, device=dev)
            pr0 = {k: torch.as_tensor(np.stack([x] * len(have)), device=dev) for k, x in prior0.items()}

            def first_step(dt):
                pr = {k: (x.to(dt) if x.is_floating_point() else x) for k, x in pr0.items()}
                _, g, _ = varem.objective(torch.as_tensor(x0, device=dev).to(dt),
                                          *[x[idx].to(dt) if x.is_floating_point() else x[idx]
                                            for x in data], Q, D, R, pr)
                g = g.double().cpu().numpy()
                return x0 - g / (1.0 + (g * g).sum(1, keepdims=True))
            x1_ref = first_step(ref_dtype)
            g_ref = x0 - x1_ref  # the gradient, times a positive step per patient
            gn = np.array([[np.linalg.norm(g_ref[j, sl]) for sl in leaves] for j in range(len(have))])
            self.detail["least_leaf_grad_share"] = float(np.min(gn / np.median(gn, axis=1, keepdims=True)))
            x1 = (np.stack([step_at[chosen[i]][1] for i in have]) if dtype == ref_dtype
                  else first_step(dtype))
            stepgap = max(stepgap, max(_leaf_gap(x1[j] - x0[j], x1_ref[j] - x0[j], leaves)
                                       for j in range(len(have))))
        one = np.ones((Q, D, R))
        for pan, (th, scale) in round2.items():
            a = th[a_sl].reshape(Q, D, R)
            psi_ref = varem.e_step(one, one, np.ones((Q, R)), a.astype(np.float64), c["eta"])[0]
            psi = (scale[a_sl].reshape(Q, D, R).astype(np.float64) if dtype == ref_dtype else
                   varem.e_step(one.astype(np.float32), one.astype(np.float32),
                                np.ones((Q, R), np.float32), a.astype(np.float32), c["eta"])[0])
            egap = max(egap, float(np.max(np.abs(psi - psi_ref)) /
                                   max(np.median(psi_ref), 1e-300)))

        # the fit: varEM replayed in float64 from the restart the program picked
        obs = [(p.t, p.y, p.meta) for p in pats]
        args = (Q, D, R, c["eta"], c["beta_lam"], c["top_iteration_num"],
                c["iteration_num_per_update"])
        ref = varem.fit(theta0, obs, *args, ref_dtype, dev)
        if dtype == ref_dtype:
            got = np.stack([self.outputs[p][0] for p in chosen]).astype(np.float64)
        else:  # the control: the replay in `dtype`, in the program's place
            got = np.stack([r[0] for r in varem.fit(theta0, obs, *args, dtype, dev)]).astype(np.float64)
        want = np.stack([r[0] for r in ref]).astype(np.float64)
        change = [_leaf_gap(got[i] - theta0[i], want[i] - theta0[i], leaves)
                  if ref[i][2] and np.all(np.isfinite(got[i])) else math.inf
                  for i in range(len(pats))]
        self.detail.update(fit_change=change, step_patients=len(have), estep_patients=len(round2))
        return dict(screen_pick_gap=sgap, step_change_gap=stepgap, estep_gap=egap,
                    fit_change_gap=float(np.median(change)))

    def _starts(self, chosen):
        """From the tap's starts, for the patients in `chosen`: {pan: (theta
        at the first call, theta at the second)} of the first varEM round
        of the patient's first unit, and {pan: (theta at the start, the
        prior's scale)} of its second round (the next start that holds
        the patient)."""
        step_at, round2, seen = {}, {}, {}
        for st in self.kept_starts:
            if st["prior"] is None or not st["calls"]:
                continue
            (th0, i0), call1 = st["calls"][0], (st["calls"][1] if len(st["calls"]) > 1 else None)
            for pos, row in enumerate(range(len(st["t"])) if i0 is None else i0):
                p = self._match(dict(t=st["t"][row], y=st["y"][row], meta=st["meta"][row],
                                     mask=st["mask"][row]))
                if p is None or p.pan not in chosen:
                    continue
                k = seen[p.pan] = seen.get(p.pan, 0) + 1
                if k == 1 and call1 is not None:
                    th1, i1 = call1
                    at = row if i1 is None else np.nonzero(i1 == row)[0]
                    if np.size(at):
                        step_at[p.pan] = (th0[pos].astype(np.float64),
                                          th1[int(np.ravel(at)[0])].astype(np.float64))
                elif k == 2:
                    round2[p.pan] = (th0[pos].astype(np.float64),
                                     st["prior"][0][row].astype(np.float64))
        return step_at, round2


def _leaf_gap(d, d_ref, leaves):
    """The largest over the leaves of theta of |n - n_ref| / max(n_ref, the
    median leaf's n_ref), n the norm of a change `d` on the leaf."""
    n = np.array([np.linalg.norm(d[sl]) for sl in leaves])
    n_ref = np.array([np.linalg.norm(d_ref[sl]) for sl in leaves])
    return float(np.max(np.abs(n - n_ref) / np.maximum(n_ref, max(np.median(n_ref), 1e-300))))


def _leaves(Q, D, R):
    """The slices of theta's leaves: noise, A, mu, v, kappa."""
    a = D + Q * D * R
    return [slice(0, D), slice(D, a), slice(a, a + Q), slice(a + Q, a + 2 * Q),
            slice(a + 2 * Q, a + 2 * Q + Q * D)]
