"""Unit: one `parallel/runner.train_cohort` call on one long patient, which
the runner routes by `large_patient_threshold` to the row-blocked path
(`infer/large_train.py:train_one_large_patient`): the restart screen, then
varEM over the blocked objective.

Set-up draws a pool of `pool_patients` patients of exactly the
configuration's `n_obs` observations on the card (`benchlib.cohort`,
from the seed) and warms the path on the first of them: one screen call
and one value+gradient at that length, through the same functions the
unit calls; it trains no patient. The window takes the pool's patients in
turn, one a unit; a patient counts as done when its flag is true and its
theta is finite, else as failed.

`LargeTap` taps the names `large_train` looks up while the window is open:
for a seeded 1/`objective_calls_every` of the blocked objective's calls
(every such call, from a seeded offset) it keeps theta, the value, the
gradient, the ok flag and the jitter multiplier of the factorization
(`mesh._factor_with_retry`); of every objective built (one per varEM
round) it keeps the patient's data as the program passed it, the prior,
the theta and value of every call, and the first call's jitter
multiplier.

The check recomputes with the float64 reference, dense and assembled by
row blocks (`reference/large.py` over `reference/lmcsm.py`):
  * large_objective_value_gap: the kept calls, at the prior of their round
    and at the program's jitter multiplier, |v - v64| / max(1, |v64|),
    the largest over the calls;
  * large_objective_grad_gap: at those calls, the program's gradient
    error max |g - g64| in units of the error of the reference computed
    in float32 with TF32 off at the same point, max |g32 - g64| (taken as
    at least GRAD_FLOOR max |g64|), the largest over the calls. Where a
    trajectory is ill-conditioned the float64 gradient is small against
    float32's rounding and any float32 evaluation is off by a share of
    it; the float32 reference's error grows with it, so the ratio does
    not. A call on data that is no patient of the pool, or no call kept
    at all, fails both;
  * large_screen_pick_gap: per trained patient, the float64 NLML of the
    restart the screen picked against the best of the restart set:
    (nlml64(init) - min_s nlml64(restart_s)) / max(1, |min|);
  * large_step_change_gap: per trained patient, the first trial step of
    its first varEM round (the line search's first point,
    x0 - g0 / (1 + |g0|^2), the program's second call) against the
    reference's from the same start and prior, rounded to float32 as the
    program stores it: of the step d = x1 - x0, |e| / |d64| with e the
    part of each element's difference past one float32 ulp of x1. At
    n = 16,384 |g0| is near 1e5 and the step near 1e-5, a few dozen ulps
    of theta in its largest elements, so a step that differs from the
    reference's by far less than an ulp still rounds the other way now
    and then; a per-leaf comparison (d24-train's step_change_gap) would
    read that rounding;
  * large_estep_gap: per trained patient, the A prior variances of its
    second varEM round against the reference's E-step
    (`reference/varem.py:e_step`) from the program's theta at that round's
    start: max |psi - psi64| / median psi64;
  * large_result_gap: per trained patient, the returned theta and loss
    against the last varEM round: the call c of that round whose value
    is the returned loss (SCG returns the value of a point it
    evaluated); the returned theta against c's theta, with the A
    elements that are zero in the result (the last E-step's clamps) set
    to zero in c's too, as the change from the round's first point x0
    per leaf of theta (noise, A, mu, v, kappa),
    |n - n_c| / max(n_c, the median leaf's n_c); the loss
    against the float64 objective at c under the round's prior (NLML
    minus log prior), |loss - f64(c)| / max(1, |f64(c)|); the rise
    (f64(c) - f64(x0)) / max(1, |f64(x0)|); and 1 where a round took no
    step (c is x0, or the second round starts where the first did). The
    largest of the four. A result that is not the point the loss was
    valued at, a loss that is not the objective there, or a round that
    ended above its start or where it began reads high; no matching
    call reads inf.
A replay of the whole fit in float64 (d24-train's fit_change_gap) would
take some 200 dense evaluations at n = 16,384, minutes on the card, so
this check has none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from benchlib.cohort import make_cohort
from drivers.train_cohort import Driver as CohortDriver
from drivers.train_cohort import _leaf_gap, _leaves
from reference import large, lmcsm, varem

PRIOR_FIELDS = ("active", "exp_tf", "ptype", "loc", "scale")
GRAD_FLOOR = 1e-6  # the least float32 gradient error counted, a share of max |g64|


class LargeTap:
    """Taps on `large_train.large_patient_objective` and
    `mesh._factor_with_retry` for as long as it is open (see the module's
    docstring). Keeping a call is a few device copies and no host sync."""

    def __init__(self, seed: int, every: int):
        rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 7])
        self.every = max(1, int(every))
        self.offset = int(rng.integers(self.every))
        self.builds = []
        self.rows = []
        self.calls = 0
        self._mult = None
        self._patched = []

    def __enter__(self):
        from medgp_tpu_torch.infer import large_train
        from medgp_tpu_torch.parallel import mesh

        orig_obj, orig_factor = large_train.large_patient_objective, mesh._factor_with_retry
        tap = self

        def factor_with_retry(*a, **k):
            mult, fac, ok = orig_factor(*a, **k)
            tap._mult = mult
            return mult, fac, ok

        def large_patient_objective(spec, blocks, t, y, meta, mask, prior=None, *a, **k):
            f = orig_obj(spec, blocks, t, y, meta, mask, prior, *a, **k)
            build = dict(data=(t, y, meta, mask), calls=[], first_mult=None,
                         prior=None if prior is None else
                         tuple(getattr(prior, name).clone() for name in PRIOR_FIELDS))
            tap.builds.append(build)
            b = len(tap.builds) - 1

            def tapped(theta, idx=None):
                tap._mult = None
                v, g, ok = f(theta, idx)
                if not build["calls"]:
                    build["first_mult"] = tap._mult
                build["calls"].append((theta[0].detach().clone(), v[0].detach().clone()))
                if tap.calls % tap.every == tap.offset:
                    tap.rows.append(dict(build=b, theta=theta[0].detach().clone(),
                                         value=v[0].detach().clone(), grad=g[0].detach().clone(),
                                         ok=ok[0].clone(), mult=tap._mult))
                tap.calls += 1
                return v, g, ok
            return tapped

        for mod, attr, new in ((mesh, "_factor_with_retry", factor_with_retry),
                               (large_train, "large_patient_objective", large_patient_objective)):
            self._patched.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, new)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._patched):
            setattr(mod, attr, orig)
        self._patched.clear()
        return False

    def host(self):
        """(builds, rows) as numpy."""
        def np_(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        builds = []
        for b in self.builds:
            thetas = torch.stack([th for th, _ in b["calls"]]) if b["calls"] else None
            values = torch.stack([v for _, v in b["calls"]]) if b["calls"] else None
            builds.append(dict(data=tuple(np_(x) for x in b["data"]), first_mult=np_(b["first_mult"]),
                               thetas=np_(thetas), values=np_(values),
                               prior=None if b["prior"] is None else
                               tuple(np_(x) for x in b["prior"])))
        return builds, [{k: np_(v) for k, v in r.items()} for r in self.rows]


@contextlib.contextmanager
def _tf32(on):
    """Matrix products in TF32 (on) or in full float32 (off) inside."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class Driver:
    work_unit = "patients"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg_json, self.traffic = ctx.config, ctx.traffic
        c = self.cfg_json
        self.Q, self.D, self.R = c["Q"], c["D"], c["R"]
        self.outputs = {}   # pan -> (init_theta, theta, loss) of the patients trained
        self.tap = None
        self.unit_seconds = []
        self.detail = {}

    def _experiment(self):
        """The cohort cells' experiment, at the configuration's threshold."""
        return dataclasses.replace(CohortDriver._experiment(self),
                                   large_patient_threshold=self.cfg_json["large_patient_threshold"])

    def setup(self):
        from medgp_tpu_torch.data.cohort import PatientRecord
        from medgp_tpu_torch.data.inits import random_inits
        from medgp_tpu_torch.infer.large_train import pad_observations
        from medgp_tpu_torch.models.priors import hier_gamma_prior
        from medgp_tpu_torch.parallel import mesh, runner
        from medgp_tpu_torch.utils.hbm import device_bytes, large_block_plan

        self.runner = runner
        tr, n, dev = self.traffic, int(self.cfg_json["n_obs"]), self.ctx.device
        if n <= int(self.cfg_json["large_patient_threshold"]):
            raise ValueError(f"n_obs {n} does not exceed the large-patient threshold")
        # one patient's gram at a time: four at n = 16,384 in float64 would
        # take most of the card
        self.pool, _ = make_cohort(self.ctx.seed, self.Q, self.D, self.R, tr["pool_patients"],
                                   tr["n_clusters"], (n, n + 1), tr["t_max_hours"],
                                   device=dev, chunk=1, prefix="big")
        self.records = [PatientRecord(pan=p.pan, t=p.t, y=p.y, meta=p.meta) for p in self.pool]
        self.exp = self._experiment()
        # warm-up: one screen value and one value+gradient at the pool's
        # length, on the block plan the unit will take
        spec, p = self.exp.spec(), self.pool[0]
        P, _, n_pad = large_block_plan(n, device_bytes(dev), spec.Q)
        args = tuple(torch.as_tensor(a, device=dev)
                     for a in pad_observations(p.t, p.y, p.meta, n_pad))
        theta = random_inits(self.exp.random_seed, spec, self.exp.bounds(), 1).to(dev)
        mesh.large_patient_screen(spec, P)(theta, *args)
        prior = hier_gamma_prior(spec, self.exp.beta_lam, torch.float32, dev)
        mesh.large_patient_objective(spec, P, *args, prior=prior)(theta)

    def open_window(self):
        self.tap = LargeTap(self.ctx.seed, self.traffic["check"]["objective_calls_every"])
        self.tap.__enter__()

    def close_window(self):
        self.tap.__exit__(None, None, None)

    def unit(self, i):
        """Run unit i; returns (done, failed) patients."""
        rec = self.records[i % len(self.records)]
        t0 = time.perf_counter()
        out = self.runner.train_cohort(self.exp, [rec], write=False, device=self.ctx.device)
        self.unit_seconds.append(time.perf_counter() - t0)
        r = out[rec.pan]
        good = bool(r["flag"]) and bool(np.all(np.isfinite(r["theta"])))
        if good:
            self.outputs[rec.pan] = (np.asarray(r["init_theta"]), np.asarray(r["theta"]),
                                     float(r["loss"]))
        return int(good), int(not good)

    def release(self):
        self.builds, self.kept_rows = self.tap.host() if self.tap is not None else ([], [])
        self.tap = None

    # ------------------------------------------------------------------
    def _patient_of(self, build):
        """The pool's patient whose observations the build's data holds, in
        order and then mask-0 zeros; else None."""
        t, y, meta, mask = build["data"]
        for p in self.pool:
            n = len(p.t)
            if len(t) >= n and np.array_equal(t[:n], p.t) and np.array_equal(y[:n], p.y) \
                    and np.array_equal(meta[:n], p.meta) and np.all(mask[:n] == 1) \
                    and not mask[n:].any() and not t[n:].any():
                return p
        return None

    def _data(self, p, dt):
        dev = self.ctx.device
        return (torch.as_tensor(p.t, device=dev).to(dt)[None],
                torch.as_tensor(p.y, device=dev).to(dt)[None],
                torch.as_tensor(p.meta, device=dev).long()[None],
                torch.ones((1, len(p.t)), device=dev, dtype=torch.bool))

    def _prior(self, build, dt):
        """The build's prior as the reference takes it, in `dt`; None
        without one."""
        if build["prior"] is None:
            return None
        pr = {k: torch.as_tensor(x, device=self.ctx.device)
              for k, x in zip(PRIOR_FIELDS, build["prior"])}
        pr["loc"], pr["scale"] = pr["loc"].to(dt), pr["scale"].to(dt)
        return pr

    def _objective(self, theta, p, build, dt, mult=None):
        """The reference's (value, gradient (H,) float64, ok) at `theta`
        on patient p under the build's prior, in `dt`."""
        dev = self.ctx.device
        th = torch.as_tensor(theta, device=dev).to(dt)[None]
        m = None if mult is None else torch.tensor([float(mult)], device=dev, dtype=dt)
        v, g, ok = large.objective_and_grad(th, *self._data(p, dt), self.Q, self.D, self.R,
                                            self._prior(build, dt), m)
        return float(v[0]), g[0].double(), bool(ok[0])

    def _value(self, theta, p, build, dt):
        """The reference's NLML minus log prior at `theta` on patient p
        under the build's prior, in `dt`; inf where it does not factor."""
        th = torch.as_tensor(theta, device=self.ctx.device).to(dt)[None]
        v, ok = large.nlml(th, *self._data(p, dt), self.Q, self.D, self.R)
        pr = self._prior(build, dt)
        if pr is not None:
            v = v - lmcsm.log_prior(th, pr)
        return float(v[0]) if bool(ok[0]) else math.inf

    def check(self, dtype=torch.float64, tf32=False):
        """[(name, value, limit)] of the window's outputs against the
        reference computed in `dtype` (the control: float32 with TF32)."""
        limits = self.traffic["check"]["limits"]
        self.detail = {}
        with _tf32(False):
            res = {**self._row_numbers(dtype, tf32), **self._patient_numbers(dtype, tf32)}
        return [(k, v, limits[k]) for k, v in res.items()]

    def _row_numbers(self, dtype, tf32, ref=torch.float64):
        """large_objective_value_gap, large_objective_grad_gap."""
        pats = [self._patient_of(b) for b in self.builds]
        vgaps, ggaps, rel, rel32, stray, jittered = [], [], [], [], False, 0
        for row in self.kept_rows:
            if not bool(row["ok"]):
                continue
            build, p = self.builds[row["build"]], pats[row["build"]]
            if p is None:
                stray = True
                continue
            jittered += row["mult"] > 1
            v64, g64, ok64 = self._objective(row["theta"], p, build, ref, row["mult"])
            # the yardstick: the reference in float32, TF32 off
            _, g32, _ = self._objective(row["theta"], p, build, torch.float32, row["mult"])
            if dtype == ref:
                v, g = float(row["value"]), torch.as_tensor(row["grad"], device=g64.device).double()
            else:  # the control: the reference in `dtype`, in the program's place
                with _tf32(tf32):
                    v, g, _ = self._objective(row["theta"], p, build, dtype, row["mult"])
            if not ok64:
                vgaps.append(math.inf)
                ggaps.append(math.inf)
                continue
            scale = float(g64.abs().max())
            err, err32 = float((g - g64).abs().max()), float((g32 - g64).abs().max())
            vgaps.append(abs(v - v64) / max(1.0, abs(v64)))
            ggaps.append(err / max(err32, GRAD_FLOOR * scale, 1e-300))
            rel.append(err / max(scale, 1e-300))
            rel32.append(err32 / max(scale, 1e-300))
        self.detail.update(rows=len(vgaps), calls=len(self.kept_rows), jittered=int(jittered),
                           value_gaps=vgaps, grad_gaps=ggaps, grad_rel=rel, grad_rel32=rel32)
        if stray or not vgaps:
            return dict(large_objective_value_gap=math.inf, large_objective_grad_gap=math.inf)
        return dict(large_objective_value_gap=_max(vgaps), large_objective_grad_gap=_max(ggaps))

    def _patient_numbers(self, dtype, tf32, ref=torch.float64):
        """large_screen_pick_gap, large_step_change_gap, large_estep_gap
        and large_result_gap of every patient trained."""
        c, dev, Q, D, R = self.cfg_json, self.ctx.device, self.Q, self.D, self.R
        names = ("large_screen_pick_gap", "large_step_change_gap", "large_estep_gap",
                 "large_result_gap")
        if not self.outputs:
            return dict.fromkeys(names, math.inf)
        by_pan = {p.pan: p for p in self.pool}
        restarts = min(int(c["random_init_num"]), self.exp.large_patient_restarts)
        inits = lmcsm.random_inits(c["random_seed"], Q, D, R, restarts).to(dev)
        leaves = _leaves(Q, D, R)
        a_sl = leaves[1]
        one = np.ones((Q, D, R))
        starts = {}  # pan -> the builds (varEM rounds) on that patient, in order
        for b in self.builds:
            p = self._patient_of(b)
            if p is not None:
                starts.setdefault(p.pan, []).append(b)
        gap = dict.fromkeys(names, 0.0)
        steps, results = [], []
        for pan, (init, theta, loss) in self.outputs.items():
            p = by_pan[pan]
            data64 = self._data(p, ref)
            vals = torch.stack([large.nlml(th[None].to(ref), *data64, Q, D, R)[0][0]
                                for th in inits])
            best = float(vals.min())
            if dtype == ref:
                picked = float(large.nlml(torch.as_tensor(init, device=dev)[None], *data64,
                                          Q, D, R)[0][0])
            else:  # the control picks by its own NLML
                data = self._data(p, dtype)
                with _tf32(tf32):
                    cv = torch.stack([large.nlml(th[None].to(dtype), *data, Q, D, R)[0][0]
                                      for th in inits])
                cv = torch.where(torch.isfinite(cv), cv, torch.full_like(cv, math.inf))
                picked = float(vals[int(torch.argmin(cv))])
            gap["large_screen_pick_gap"] = max(gap["large_screen_pick_gap"],
                                               (picked - best) / max(1.0, abs(best)))

            rounds = starts.get(pan, [])
            if len(rounds) < 2 or any(r["prior"] is None or r["thetas"] is None for r in rounds) \
                    or len(rounds[0]["thetas"]) < 2:
                # a patient whose rounds the tap did not see
                gap.update(large_step_change_gap=math.inf, large_estep_gap=math.inf,
                           large_result_gap=math.inf)
                continue

            # the first trial step of the first round, as float32 stores it
            r0 = rounds[0]
            x0 = r0["thetas"][0]

            def first_point(dt):
                g = self._objective(x0, p, r0, dt, r0["first_mult"])[1].cpu().numpy()
                return x0 + (-g / (1.0 + g @ g)).astype(np.float32)
            x1_ref = first_point(ref)
            if dtype == ref:
                x1 = r0["thetas"][1]
            else:
                with _tf32(tf32):
                    x1 = first_point(dtype)
            ulp = np.spacing(np.maximum(np.abs(x1), np.abs(x1_ref))).astype(np.float64)
            past = np.maximum(np.abs(x1.astype(np.float64) - x1_ref) - ulp, 0.0)
            d_ref = x1_ref.astype(np.float64) - x0
            steps.append((float(np.linalg.norm(past) / max(np.linalg.norm(d_ref), 1e-300)),
                          float(np.linalg.norm(d_ref))))
            gap["large_step_change_gap"] = max(gap["large_step_change_gap"], steps[-1][0])

            # the first E-step, from the program's start of the second round
            a = rounds[1]["thetas"][0][a_sl].reshape(Q, D, R)
            psi_ref = varem.e_step(one, one, np.ones((Q, R)), a.astype(np.float64), c["eta"])[0]
            scale = rounds[1]["prior"][PRIOR_FIELDS.index("scale")].reshape(-1)
            psi = (scale[a_sl].reshape(Q, D, R).astype(np.float64) if dtype == ref else
                   varem.e_step(one.astype(np.float32), one.astype(np.float32),
                                np.ones((Q, R), np.float32), a.astype(np.float32), c["eta"])[0])
            gap["large_estep_gap"] = max(gap["large_estep_gap"], float(
                np.max(np.abs(psi - psi_ref)) / max(np.median(psi_ref), 1e-300)))

            # the result against the last round: the call valued at the loss
            last = rounds[-1]
            hit = np.flatnonzero(last["values"] == np.float32(loss))
            if not hit.size:
                results.append(None)
                gap["large_result_gap"] = math.inf
                continue
            x0l, xc = (x.astype(np.float64) for x in (last["thetas"][0], last["thetas"][hit[-1]]))
            # A elements the last E-step clamped are zero in the result
            xc[a_sl] = np.where(theta[a_sl] == 0, 0.0, xc[a_sl])
            # the first round's E-step zeroes A elements at the second's start
            r1, r2 = rounds[0]["thetas"][0], rounds[1]["thetas"][0]
            stalled = np.array_equal(xc, x0l) or bool(np.all((r2 == r1) | (r2 == 0)))
            f_c, f_start = self._value(xc, p, last, ref), self._value(x0l, p, last, ref)
            if dtype != ref:  # the control: its own value at that point
                with _tf32(tf32):
                    loss = self._value(xc, p, last, dtype)
            results.append((_leaf_gap(theta - x0l, xc - x0l, leaves),
                            abs(loss - f_c) / max(1.0, abs(f_c)),
                            (f_c - f_start) / max(1.0, abs(f_start)), float(stalled)))
            gap["large_result_gap"] = max(gap["large_result_gap"], *results[-1])
        self.detail.update(patients=len(self.outputs), builds=len(self.builds),
                           step_change_and_norm=steps,
                           result_theta_loss_rise_stall=results)
        return gap


def _max(values):
    """The largest of `values`, inf where it is not a number."""
    x = float(np.max(np.asarray(values, np.float64)))
    return x if not math.isnan(x) else math.inf
