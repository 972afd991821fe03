"""Taps on the objective the program evaluates in its timed path.

`ObjectiveTap` wraps `medgp_tpu_torch.models.gp.objective_and_grad` in
every module of the program that holds it, and `nlml_fn` in the model
module, for as long as it is open. For a share of the objective calls,
drawn from the run's seed on the host, it keeps a row of what the call
took and gave from each half of the call's batch (one row where the batch
is one patient): theta, the patient's padded data, its prior, the value,
the gradient, the ok flag, the jitter multiplier the factorization used,
and which half of the batch the row was in. Of every objective it builds
(one per bucket and varEM round) it also keeps the batch's data and
prior and the thetas of the first two calls, with their rows: the start
of that round and the first trial step of its line search. Keeping a row
is a few device copies and no host sync; the rows are read once the
window has closed, and the reference recomputes them.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


MAX_STARTS = 4096


class ObjectiveTap:
    def __init__(self, seed: int, every: int, max_rows: int = 4096):
        self.rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 7])
        self.every = max(1, int(every))
        self.max_rows = max_rows
        self.rows = []
        self.starts = []
        self.calls = 0
        self._mult = None
        self._patched = []

    def __enter__(self):
        from medgp_tpu_torch.models import gp

        orig_obj, orig_nlml = gp.objective_and_grad, gp.nlml_fn
        tap = self

        def nlml_fn(*a, **k):
            loss = orig_nlml(*a, **k)

            def tapped(theta):
                value, res = loss(theta)
                tap._mult = res.mult
                return value, res
            return tapped

        def objective_and_grad(spec, data, prior=None, max_retries=10):
            f = orig_obj(spec, data, prior, max_retries)
            start = dict(data=data, prior=None if prior is None else (
                prior.scale.clone(), prior.ptype.clone()), calls=[])
            if len(tap.starts) < MAX_STARTS:
                tap.starts.append(start)

            def tapped(theta, idx=None):
                tap._mult = None
                if len(start["calls"]) < 2:
                    start["calls"].append((theta.detach().clone(),
                                           None if idx is None else idx.clone()))
                v, g, ok = f(theta, idx)
                tap.calls += 1
                k = theta.shape[0]
                if k and len(tap.rows) < tap.max_rows and tap.rng.random() < 1.0 / tap.every:
                    h = k // 2
                    tap._keep(theta, idx, data, prior, v, g, ok, int(tap.rng.integers(k - h)) + h, 1)
                    if h:
                        tap._keep(theta, idx, data, prior, v, g, ok, int(tap.rng.integers(h)), 0)
                return v, g, ok
            return tapped

        self._patch(gp, "nlml_fn", orig_nlml, nlml_fn)
        for mod in list(sys.modules.values()):
            name = getattr(mod, "__name__", "") or ""
            if name.split(".")[0] == "medgp_tpu_torch" and \
                    getattr(mod, "objective_and_grad", None) is orig_obj:
                self._patch(mod, "objective_and_grad", orig_obj, objective_and_grad)
        return self

    def _patch(self, mod, attr, orig, new):
        setattr(mod, attr, new)
        self._patched.append((mod, attr, orig))

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._patched):
            setattr(mod, attr, orig)
        self._patched.clear()
        return False

    def _keep(self, theta, idx, data, prior, v, g, ok, pos, half):
        row = pos if idx is None else idx[pos]
        rec = dict(
            half=torch.tensor(half),
            theta=theta[pos].detach().clone(), value=v[pos].detach().clone(),
            grad=g[pos].detach().clone(), ok=ok[pos].clone(),
            mult=None if self._mult is None else self._mult[pos].clone(),
            t=data.t[row].clone(), y=data.y[row].clone(),
            meta=data.meta[row].clone(), mask=data.mask[row].clone(),
        )
        if prior is not None:
            batched = prior.active.dim() == 2
            for name in ("active", "exp_tf", "ptype", "loc", "scale"):
                x = getattr(prior, name)
                rec["prior_" + name] = (x[row] if batched else x).clone()
        self.rows.append(rec)

    def host_rows(self):
        """The kept rows as numpy (one device-to-host copy each)."""
        out = []
        for r in self.rows:
            out.append({k: (None if v is None else v.cpu().numpy()) for k, v in r.items()})
        return out

    def host_starts(self):
        """The kept starts as numpy: t, y, meta, mask (P, n), the prior's
        scale and type code (P, H) or None, and calls [(theta (k, H), the
        k rows of the batch they are, or None for all)]."""
        out = []
        for st in self.starts:
            d = st["data"]
            out.append(dict(
                t=d.t.cpu().numpy(), y=d.y.cpu().numpy(), meta=d.meta.cpu().numpy(),
                mask=d.mask.cpu().numpy(),
                prior=None if st["prior"] is None else tuple(x.cpu().numpy() for x in st["prior"]),
                calls=[(th.cpu().numpy(), None if i is None else i.cpu().numpy())
                       for th, i in st["calls"]]))
        return out
