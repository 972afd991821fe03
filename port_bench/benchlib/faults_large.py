"""Faults planted under the row-blocked large-patient path, to show that the
check of `drivers/train_large.py` catches them. Used by the fault test
(tests/test_pb_large.py) and by calibrate_large.py's upper readings; no
run of the benchmark plants one.

`benchlib/faults.py` patches the dense path (`gp.nlml_fn`,
`map_train.screen_inits`, `map_train.varem_train`), which the large path
never calls: `infer/large_train.py` imports `varem_train`,
`large_patient_screen` and `large_patient_objective` by name. So these
faults are patched in `large_train` itself (varEM's SCG in `varem`), with
the same four meanings and two more:

  * unchanged: the result's theta is its start, and varEM's E-step
    returns its state as it was;
  * unchanged_theta: the result's theta is its start, all else as it was;
  * stalled: every varEM round's SCG returns its start and the value
    there, as an optimizer that never accepts a step;
  * half: the blocked objective leaves out the last row block's terms in
    value and gradient (its observations are masked out);
  * altered: every value of the blocked objective comes out 1e-3 of
    itself too high;
  * screen: the restart screen keeps the second-best restart.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "unchanged_theta", "stalled", "half", "altered", "screen")


@contextlib.contextmanager
def planted(name):
    from medgp_tpu_torch.infer import large_train
    from medgp_tpu_torch.infer import varem as varem_mod

    saved = []

    def patch(mod, attr, new):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)

    if name in ("unchanged", "unchanged_theta"):
        orig = large_train.varem_train

        def varem_train(spec, data, theta0, *a, **k):
            return orig(spec, data, theta0, *a, **k)._replace(theta=theta0.clone())
        patch(large_train, "varem_train", varem_train)

    if name == "unchanged":
        def e_step(spec, st, a, fixed):
            return st, torch.zeros(a.shape, dtype=torch.bool, device=a.device)
        patch(varem_mod, "e_step", e_step)
    elif name in ("half", "altered"):
        orig = large_train.large_patient_objective

        def large_patient_objective(spec, blocks, t, y, meta, mask, prior=None, *a, **k):
            if name == "half":
                mask = mask.clone()
                mask[-(t.shape[0] // blocks):] = 0
            f = orig(spec, blocks, t, y, meta, mask, prior, *a, **k)
            if name == "half":
                return f

            def faulty(theta, idx=None):
                v, g, ok = f(theta, idx)
                return v + 1e-3 * v.abs(), g, ok
            return faulty
        patch(large_train, "large_patient_objective", large_patient_objective)
    elif name == "screen":
        orig = large_train.large_patient_screen

        def large_patient_screen(*a, **k):
            screen = orig(*a, **k)

            def second_best(thetas, *data):
                vals, oks = screen(thetas, *data)
                if vals.shape[0] > 1:
                    vals = vals.clone()
                    vals[torch.argmin(vals)] = float("inf")
                return vals, oks
            return second_best
        patch(large_train, "large_patient_screen", large_patient_screen)
    elif name == "stalled":
        orig = varem_mod.scg_minimize

        def scg_minimize(f, x0, max_evals):
            res = orig(f, x0, max_evals)
            return res._replace(x=x0.clone(), fx=f(x0)[0])
        patch(varem_mod, "scg_minimize", scg_minimize)
    elif name not in (None, "unchanged_theta"):
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    try:
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)
