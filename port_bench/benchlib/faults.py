"""Faults planted under the timed path, to show that the check catches
them. Used by the fault test (tests/test_pb_faults.py) and by
calibrate.py's upper readings; no run of the benchmark plants one.

  * unchanged: training returns each patient's starting theta, varEM's
    E-step returns its state as it was, and the online loop's hyper
    updates leave theta as it was (a step that returns its state
    unchanged);
  * half: the objective leaves out the second half of every batch it is
    given (their gradients are zero, their values as computed);
  * altered: every objective value comes out 1e-3 of itself too high, and
    every online prediction 0.01 too high (an answer altered where it is
    produced);
  * screen: the restart screen keeps each patient's second-best restart.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half", "altered", "screen")


@contextlib.contextmanager
def planted(name):
    from medgp_tpu_torch.infer import map_train, online
    from medgp_tpu_torch.infer import varem as varem_mod
    from medgp_tpu_torch.models import gp

    saved = []

    def patch(mod, attr, new):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)

    if name == "unchanged":
        orig = map_train.varem_train

        def varem_train(spec, data, theta0, *a, **k):
            return orig(spec, data, theta0, *a, **k)._replace(theta=theta0.clone())
        patch(map_train, "varem_train", varem_train)

        def e_step(spec, st, a, fixed):
            return st, torch.zeros(a.shape, dtype=torch.bool, device=a.device)
        patch(varem_mod, "e_step", e_step)
        orig_obj = online.objective_and_grad

        def objective_and_grad(*a, **k):
            f = orig_obj(*a, **k)

            def frozen(theta, idx=None):
                v, g, ok = f(theta, idx)
                return v, torch.zeros_like(g), ok
            return frozen
        patch(online, "objective_and_grad", objective_and_grad)
    elif name in ("half", "altered"):
        orig = gp.nlml_fn

        def nlml_fn(*a, **k):
            loss = orig(*a, **k)

            def faulty(theta):
                value, res = loss(theta)
                if name == "half":
                    h = value.shape[0] // 2
                    value = torch.cat([value[:h], value[h:].detach()])
                else:
                    value = value + 1e-3 * value.detach().abs()
                return value, res
            return faulty
        patch(gp, "nlml_fn", nlml_fn)
        if name == "altered":
            orig_pred = online._predict_from_history

            def predict(*a, **k):
                pred, err, ci, var = orig_pred(*a, **k)
                return pred + 0.01, err + 0.01, ci, var
            patch(online, "_predict_from_history", predict)
    elif name == "screen":
        orig = map_train.screen_inits

        def screen_inits(spec, data, thetas, max_retries=10):
            res = orig(spec, data, thetas, max_retries)
            P, S = data.t.shape[0], thetas.shape[0]
            with torch.no_grad():
                v = torch.stack([
                    orig(spec, data, thetas[s:s + 1], max_retries).best_loss for s in range(S)
                ], dim=1)
                second = torch.argsort(v, dim=1)[:, min(1, S - 1)]
            return res._replace(best_theta=thetas[second],
                                best_loss=v.gather(1, second[:, None])[:, 0])
        patch(map_train, "screen_inits", screen_inits)
    elif name is not None:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    try:
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)
