"""Scaled conjugate gradients with Wolfe-Powell line search, batched.

Counterpart of ``medgp_tpu/infer/scg.py`` (itself the reference's
medgpc/src/util/c_optimizer_scg.cpp, a port of Rasmussen's minimize.m):
cubic extrapolation, cubic/quadratic interpolation, Polak-Ribiere
direction updates, slope-ratio step guessing, restart to steepest descent
on line-search failure; only the function-evaluation-budget mode.

The JAX package minimizes a batch by `vmap` over nested `lax.while_loop`s
whose bodies freeze each element once its own predicate is false
(`_masked_while`, scg.py:53-72). Here the batch is explicit and the
nesting is the same, loop for loop: the outer iteration, the extrapolation
loop and its evaluate-until-finite loop, then the interpolation loop. Each
loop runs while its predicate holds for any element, and each pass
gathers the elements whose own predicate holds, runs the body on them
alone (the objective is evaluated for those patients only), and scatters
the result back: what `vmap(scg_minimize)` computes, per element. A failed
evaluation (ok false, non-finite value or gradient) reports +inf, which
halves the step as the reference does (c_optimizer_scg.cpp:125-128).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from medgp_tpu_torch.utils import metrics

# Line-search constants (c_optimizer_scg.cpp:37-42).
_INT = 0.1     # don't reevaluate within this fraction of the current bracket
_EXT = 3.0     # maximum extrapolation factor
_MAX = 20      # max function evaluations per line search
_RATIO = 10.0  # maximum allowed slope ratio
_SIG = 0.1
_RHO = _SIG / 2.0
_EPS = 2.0 ** -52

Objective = Callable[
    [torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
]
State = Dict[str, torch.Tensor]


class SCGResult(NamedTuple):
    x: torch.Tensor        # (P, H) optimized parameters
    fx: torch.Tensor       # (P,) final objective value
    n_evals: torch.Tensor  # (P,) int32 objective evaluations consumed
    ok: torch.Tensor       # (P,) bool: some evaluation succeeded


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _take(st: State, idx: torch.Tensor) -> State:
    return {k: v[idx] for k, v in st.items()}


def _put(st: State, idx: torch.Tensor, sub: State) -> State:
    return {k: v.index_put((idx,), sub[k]) for k, v in st.items()}


def _while(pred, body, st: State) -> State:
    """Run `body` on the elements whose `pred` holds until it holds for
    none; `body(sub, idx)` takes and returns the gathered elements, `idx`
    their positions in `st`."""
    while True:
        idx = torch.nonzero(pred(st)).squeeze(-1)
        if idx.numel() == 0:
            return st
        st = _put(st, idx, body(_take(st, idx), idx))


def _where(c, a, b):
    return torch.where(c[:, None] if a.dim() == 2 else c, a, b)


def scg_minimize(f: Objective, x0: torch.Tensor, max_evals: int) -> SCGResult:
    """Minimize each row of `x0` (P, H) within `max_evals` evaluations.

    `f(x (k, H), idx (k,)) -> (value (k,), grad (k, H), ok (k,))` evaluates
    the objectives of elements `idx` at `x`; ok = False or a non-finite
    value marks a failed evaluation. The call is the span `medgp.scg`
    (utils/metrics.py): its self time is the line search's own work,
    outside the objective's calls."""
    with metrics.span("medgp.scg"):
        return _minimize(f, x0, max_evals)


def _minimize(f: Objective, x0: torch.Tensor, max_evals: int) -> SCGResult:
    P = x0.shape[0]
    dev, dtype = x0.device, x0.dtype
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)

    def evaluate(x, idx):
        v, g, ok = f(x, idx)
        bad = ~ok | ~torch.isfinite(v)
        return torch.where(bad, inf, v), g, ~bad

    f0, df0, ok0 = evaluate(x0, torch.arange(P, device=dev))
    s = -df0
    d0 = -_dot(s, s)
    st = dict(
        i=torch.ones(P, dtype=torch.int32, device=dev),  # the first evaluation counts
        X=x0.clone(), fX=f0, df0=df0, s=s, d0=d0, x3=1.0 / (1.0 - d0),
        obj_flag=ok0,
    )

    def outer_body(o: State, gidx: torch.Tensor) -> State:
        i = o["i"] + 1  # outer-iteration tick (c_optimizer_scg.cpp:88)
        X, fX, df0, s, d0 = o["X"], o["fX"], o["df0"], o["s"], o["d0"]
        M = torch.clamp(max_evals - i, max=_MAX)
        z = torch.zeros_like(fX)

        # ---- extrapolation: bracket a minimum along s ----
        def ex_body(ex: State, e: torch.Tensor) -> State:
            Xe, se = X[e], s[e]

            def ev_body(ev: State, k: torch.Tensor) -> State:
                f3, df3, okk = evaluate(
                    Xe[k] + ev["x3"][:, None] * se[k], gidx[e][k]
                )
                okk = okk & torch.all(torch.isfinite(df3), dim=-1)
                return dict(
                    x3=torch.where(okk, ev["x3"], (ex["x2"][k] + ev["x3"]) / 2.0),
                    f3=f3, df3=df3, M=ev["M"] - 1, i=ev["i"] + 1,
                    obj_flag=okk, success=okk,
                )

            ev = _while(
                lambda ev: ~ev["success"] & (ev["M"] > 0), ev_body,
                dict(x3=ex["x3"], f3=ex["f3"], df3=ex["df3"], M=ex["M"],
                     i=ex["i"], obj_flag=ex["obj_flag"],
                     success=torch.zeros_like(ex["done"])),
            )
            x3, f3, df3, Mn = ev["x3"], ev["f3"], ev["df3"], ev["M"]
            fXe, d0e = fX[e], d0[e]

            better = f3 < ex["F0"]
            X0 = _where(better, Xe + x3[:, None] * se, ex["X0"])
            F0 = torch.where(better, f3, ex["F0"])
            dF0 = _where(better, df3, ex["dF0"])
            d3 = _dot(df3, se)
            done = (d3 > _SIG * d0e) | (f3 > fXe + x3 * _RHO * d0e) | (Mn <= 0)

            # cubic extrapolation for the next trial point
            x1, f1, d1 = ex["x2"], ex["f2"], ex["d2"]
            x2, f2, d2 = x3, f3, d3
            A = 6.0 * (f1 - f2) + 3.0 * (d2 + d1) * (x2 - x1)
            B = 3.0 * (f2 - f1) - (2.0 * d1 + d2) * (x2 - x1)
            temp = B * B - A * d1 * (x2 - x1)
            sq = torch.sqrt(torch.clamp(temp, min=0.0))
            x3_cand = x1 - d1 * (x2 - x1) ** 2 / (B + sq)
            bad = (
                (temp < 0) | torch.isnan(x3_cand) | torch.isinf(x3_cand)
                | (x3_cand < 0)
            )
            x3n = torch.where(bad, x2 * _EXT, x3_cand)
            x3n = torch.minimum(x3n, x2 * _EXT)
            x3n = torch.maximum(x3n, x2 + _INT * (x2 - x1))
            return dict(
                x1=torch.where(done, ex["x1"], x1),
                f1=torch.where(done, ex["f1"], f1),
                d1=torch.where(done, ex["d1"], d1),
                x2=torch.where(done, ex["x2"], x2),
                f2=torch.where(done, ex["f2"], f2),
                d2=torch.where(done, ex["d2"], d2),
                x3=torch.where(done, x3, x3n),
                f3=f3, d3=d3, df3=df3, M=Mn, i=ev["i"],
                X0=X0, F0=F0, dF0=dF0, obj_flag=ev["obj_flag"], done=done,
            )

        ex = _while(
            lambda ex: ~ex["done"], ex_body,
            dict(x1=z, f1=fX, d1=d0, x2=z, f2=fX, d2=d0, x3=o["x3"], f3=fX,
                 d3=d0, df3=df0, M=M, i=i, X0=X, F0=fX, dF0=df0,
                 obj_flag=o["obj_flag"], done=torch.zeros_like(o["obj_flag"])),
        )

        # ---- interpolation: refine inside the bracket ----
        def not_converged(ins: State) -> torch.Tensor:
            return (torch.abs(ins["d3"]) > -_SIG * d0) | (
                ins["f3"] > fX + ins["x3"] * _RHO * d0
            )

        def in_body(ins: State, k: torch.Tensor) -> State:
            Xk, sk, fXk, d0k = X[k], s[k], fX[k], d0[k]
            upper = (ins["d3"] > 0) | (ins["f3"] > fXk + ins["x3"] * _RHO * d0k)
            x4 = torch.where(upper, ins["x3"], ins["x4"])
            f4 = torch.where(upper, ins["f3"], ins["f4"])
            d4 = torch.where(upper, ins["d3"], ins["d4"])
            x2 = torch.where(upper, ins["x2"], ins["x3"])
            f2 = torch.where(upper, ins["f2"], ins["f3"])
            d2 = torch.where(upper, ins["d2"], ins["d3"])

            # quadratic (f4 > fX) or cubic interpolation
            denom_q = f4 - f2 - d2 * (x4 - x2)
            x3_quad = x2 - (0.5 * d2 * (x4 - x2) ** 2) / denom_q
            A = 6.0 * (f2 - f4) / (x4 - x2) + 3.0 * (d4 + d2)
            B = 3.0 * (f4 - f2) - (2.0 * d2 + d4) * (x4 - x2)
            disc = B * B - A * d2 * (x4 - x2) ** 2
            x3_cub = x2 + (torch.sqrt(torch.clamp(disc, min=0.0)) - B) / A
            x3_cub = torch.where(disc < 0, (x2 + x4) / 2.0, x3_cub)
            x3n = torch.where(f4 > fXk, x3_quad, x3_cub)
            x3n = torch.where(
                torch.isnan(x3n) | torch.isinf(x3n), (x2 + x4) / 2.0, x3n
            )
            x3n = torch.maximum(
                torch.minimum(x3n, x4 - _INT * (x4 - x2)), x2 + _INT * (x4 - x2)
            )

            f3, df3, okk = evaluate(Xk + x3n[:, None] * sk, gidx[k])
            okk = okk & torch.all(torch.isfinite(df3), dim=-1)
            better = okk & (f3 < ins["F0"])
            return dict(
                x2=x2, f2=f2, d2=d2, x3=x3n, f3=f3, d3=_dot(df3, sk),
                x4=x4, f4=f4, d4=d4, df3=df3, M=ins["M"] - 1, i=ins["i"] + 1,
                X0=_where(better, Xk + x3n[:, None] * sk, ins["X0"]),
                F0=torch.where(better, f3, ins["F0"]),
                dF0=_where(better, df3, ins["dF0"]),
                obj_flag=okk,
            )

        ins = dict(
            x2=ex["x2"], f2=ex["f2"], d2=ex["d2"], x3=ex["x3"], f3=ex["f3"],
            d3=ex["d3"], x4=ex["x3"], f4=ex["f3"], d4=ex["d3"], df3=ex["df3"],
            M=ex["M"], i=ex["i"], X0=ex["X0"], F0=ex["F0"], dF0=ex["dF0"],
            obj_flag=ex["obj_flag"],
        )
        ins = _while(lambda ins: not_converged(ins) & (ins["M"] > 0), in_body, ins)

        # ---- accept / reject the line search ----
        x3, f3, df3 = ins["x3"], ins["f3"], ins["df3"]
        accept = (
            ins["obj_flag"] & (torch.abs(ins["d3"]) < -_SIG * d0)
            & (f3 < fX + x3 * _RHO * d0)
        )
        # accepted: Polak-Ribiere direction update
        X_a = X + x3[:, None] * s
        s_a = ((_dot(df3, df3) - _dot(df3, df0)) / _dot(df0, df0))[:, None] * s - df3
        d0_a = _dot(df3, s_a)
        grad_asc = d0_a > 0
        s_a = _where(grad_asc, -df3, s_a)
        d0_a = torch.where(grad_asc, -_dot(s_a, s_a), d0_a)
        ratio = torch.tensor(_RATIO, dtype=dtype, device=dev)
        x3_a = x3 * torch.minimum(ratio, d0 / (d0_a - _EPS))
        # rejected: restart from the best point, steepest descent
        s_r = -ins["dF0"]
        d0_r = -_dot(s_r, s_r)
        return dict(
            i=ins["i"],
            X=_where(accept, X_a, ins["X0"]),
            fX=torch.where(accept, f3, ins["F0"]),
            df0=_where(accept, df3, ins["dF0"]),
            s=_where(accept, s_a, s_r),
            d0=torch.where(accept, d0_a, d0_r),
            x3=torch.where(accept, x3_a, 1.0 / (1.0 - d0_r)),
            obj_flag=ins["obj_flag"],
        )

    # If the very first evaluation failed, the reference still enters the
    # loop; f0 = inf makes any successful step an improvement.
    st = _while(lambda st: st["i"] < max_evals, outer_body, st)
    return SCGResult(
        x=st["X"], fx=st["fX"], n_evals=st["i"],
        ok=ok0 | torch.isfinite(st["fX"]),
    )
