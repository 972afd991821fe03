"""The row-blocked NLML of one large LMC-SM patient, its gradient, its
restart screen and its MAP objective, on one device.

Counterpart of the large-patient half of ``medgp_tpu/parallel/mesh.py``
(`large_patient_nlml`, `large_patient_nlml_diff`,
`large_patient_objective`, `large_patient_screen`), which row-shards the
patient over a device mesh: device d holds row block d of the gram, and a
right-looking blocked Cholesky walks the blocks with collectives between
them. Here the P row blocks of width b (n = P b) are walked on one device,
so the block structure, and every value, is the JAX program's on a mesh
of P devices.

Memory. The gram is never held whole: row block l is a (b, (l+1) b)
tensor, the lower block triangle only, and the factorization overwrites
it with row block l of L. So L costs n (n + b) / 2 values, and every
workspace is a block column of at most (n, b) values (utils/hbm.py:
`large_block_plan` sizes b from this rule).

Kernels. Each diagonal block A_kk is factored by K3
(`cuda_chol.chol_solve`, one (b, b) matrix, zero noise) and inverted by K5
(`cuda_chol.tri_inv`); the panel, the forward substitution and every
solve of the backward are products with the stored L_kk^{-1}. The gram
rows (`ops/gram.py:cross_gram_lmcsm`), the trailing updates and the panel
products are PyTorch, as the JAX program computes them in XLA outside any
Pallas kernel.

Block exchange. The JAX program moves blocks between devices at five
places: the all_gather of a block column (the panel), the psum broadcast
of a residual block of y, the psum broadcast of a row block of L, the
all_gather of L's column blocks (the backward substitutions) and the psum
of the theta cotangent. On one device each is a slice or the identity,
and each is one of the small functions below (`_gather_column`,
`_set_column`, `_row`, `_reduce`), so that a row-sharded form over
`torch.distributed` replaces those functions only.

Inputs are padded to n = P b with b a multiple of K3's 32-wide block, by
mask-0 identity rows (`infer/large_train.py:pad_observations`); the NLML
does not depend on the padding, since n_eff = sum(mask).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch

from medgp_tpu_torch.models.gp import noise_variance
from medgp_tpu_torch.models.params import REF_PI, LMCSMSpec
from medgp_tpu_torch.models.priors import PriorSpec, log_prior
from medgp_tpu_torch.ops import cuda_chol
from medgp_tpu_torch.ops.gram import cross_gram_lmcsm

Rows = List[torch.Tensor]  # row block l: (b, (l + 1) b)


def block_width(n: int, blocks: int) -> int:
    """b for n = `blocks` b padded rows; raises unless b is a multiple of
    K3's block (`cuda_chol.BLOCK`)."""
    b, rem = divmod(n, blocks)
    if rem or b % cuda_chol.BLOCK:
        raise ValueError(
            f"large patient: n = {n} is not {blocks} blocks of a multiple of "
            f"{cuda_chol.BLOCK} rows (pad with infer/large_train.py:pad_observations)"
        )
    return b


# --- block exchange: slices on one device --------------------------------

def _gather_column(rows: Rows, k: int, b: int, first: int) -> torch.Tensor:
    """Block column k of row blocks first..P-1, stacked: ((P - first) b, b)
    (JAX: the all_gather of a block column)."""
    return torch.cat([r[:, k * b:(k + 1) * b] for r in rows[first:]])


def _set_column(rows: Rows, k: int, b: int, first: int, col: torch.Tensor) -> None:
    """Write a stacked block column back into row blocks first..P-1."""
    for i, r in enumerate(rows[first:]):
        r[:, k * b:(k + 1) * b] = col[i * b:(i + 1) * b]


def _row(rows: Rows, k: int) -> torch.Tensor:
    """Row block k of L (JAX: its psum broadcast from device k)."""
    return rows[k]


def _reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum of every device's part of a cotangent (JAX: psum)."""
    return x


# --- the factorization ----------------------------------------------------

def _gram_rows(spec: LMCSMSpec, nat, theta, mult, t, meta, mask, b) -> Rows:
    """The lower block triangle of K + mult diag(noise) + diag(1 - mask),
    masked, by row blocks (mesh.py:360-374, 707-719 in the JAX package)."""
    P = t.shape[0] // b
    rows = []
    for l in range(P):
        lo, hi = l * b, (l + 1) * b
        K = cross_gram_lmcsm(
            t[None, lo:hi], meta[None, lo:hi], t[None, :hi], meta[None, :hi],
            nat["B"], nat["mu"], nat["v"],
        )[0]
        K *= mask[lo:hi, None] * mask[None, :hi]
        nv = _noise(spec, theta, meta[lo:hi]) * mask[lo:hi]
        K[:, lo:hi].diagonal().add_(mult * nv + (1.0 - mask[lo:hi]))
        rows.append(K)
    return rows


def _noise(spec: LMCSMSpec, theta: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """Per-observation noise variance of theta (H,), by the batched form of
    `noise_variance`, whose one-hot product has a deterministic backward."""
    return noise_variance(spec, theta[None], meta[None])[0]


def _natural(spec: LMCSMSpec, theta: torch.Tensor):
    """theta (H,) -> the gram's parameters with a batch axis of 1."""
    p = spec.unpack(theta)
    return dict(B=spec.coregional_B(p["A"], p["kappa"])[None],
                mu=p["mu"][None], v=p["v"][None])


class Factor(NamedTuple):
    rows: Rows            # row block l of L: (b, (l + 1) b)
    linv: torch.Tensor    # (P, b, b) L_kk^{-1}
    z: torch.Tensor       # (n,) L^{-1} (y * mask)
    zsq: torch.Tensor     # () ||z||^2
    logdet: torch.Tensor  # () sum log diag(L)


def _factorize(rows: Rows, y: torch.Tensor, b: int) -> Factor:
    """Right-looking blocked Cholesky with the forward substitution fused,
    in place over `rows` (mesh.py:724-758 in the JAX package): for each k,
    K3 factors A_kk and K5 inverts L_kk, the panel is S = C L_kk^{-T}, the
    trailing rows lose S_i S_j^T, and z_k = L_kk^{-1} y_k. Only the nonzero
    ranges are multiplied. A failed block (K3's NaN pivot) makes zsq and
    logdet NaN; nothing is read back here."""
    P = len(rows)
    dtype, dev = y.dtype, y.device
    zeros = torch.zeros((1, b), dtype=dtype, device=dev)
    linv = torch.empty((P, b, b), dtype=dtype, device=dev)
    yres = y.clone()
    z = torch.empty_like(y)
    zsq = torch.zeros((), dtype=dtype, device=dev)
    logdet = torch.zeros((), dtype=dtype, device=dev)
    for k in range(P):
        lo, hi = k * b, (k + 1) * b
        Akk = rows[k][:, lo:hi].contiguous()[None]
        L, _, linvd = cuda_chol.chol_solve(Akk, zeros, zeros)
        linv[k] = cuda_chol.tri_inv(L, linvd)[0]
        rows[k][:, lo:hi] = L[0]
        zk = linv[k] @ yres[lo:hi]
        z[lo:hi] = zk
        zsq = zsq + torch.sum(zk * zk)
        logdet = logdet + torch.sum(torch.log(torch.diagonal(L[0])))
        if k + 1 == P:
            break
        S = _gather_column(rows, k, b, k + 1) @ linv[k].T
        _set_column(rows, k, b, k + 1, S)
        yres[hi:] -= S @ zk
        for i in range(k + 1, P):
            Si = S[(i - k - 1) * b:(i - k) * b]
            rows[i][:, hi:(i + 1) * b].addmm_(Si, S[:(i - k) * b].T, alpha=-1.0)
    return Factor(rows, linv, z, zsq, logdet)


def _factor_with_retry(spec, theta, t, y, meta, mask, b, max_retries):
    """The jitter retry over the whole factorization, mult = 1 ..
    1 + max_retries (mesh.py:764-777): one host read of ok per attempt.
    Returns (mult, Factor, ok)."""
    nat = _natural(spec, theta)
    y = y * mask
    fac = None
    for mult in range(1, max_retries + 2):
        fac = None  # the last attempt's rows are freed before the next
        fac = _factorize(_gram_rows(spec, nat, theta, mult, t, meta, mask, b), y, b)
        ok = bool(torch.isfinite(fac.zsq) & torch.isfinite(fac.logdet))
        if ok:
            break
    return mult, fac, ok


def _nlml(fac: Factor, mask: torch.Tensor, ok: bool) -> torch.Tensor:
    dtype = mask.dtype
    if not ok:
        return torch.tensor(math.inf, dtype=dtype, device=mask.device)
    n_eff = torch.sum(mask)
    return 0.5 * fac.zsq + fac.logdet + 0.5 * n_eff * math.log(2.0 * REF_PI)


def _back_substitute(fac: Factor, b: int) -> torch.Tensor:
    """alpha = L^{-T} z by blocks, k = P-1 .. 0 (mesh.py:462-477)."""
    P = len(fac.rows)
    r = fac.z.clone()
    for k in range(P - 1, -1, -1):
        lo, hi = k * b, (k + 1) * b
        ak = fac.linv[k].T @ r[lo:hi]
        r[lo:hi] = ak
        if k:
            r[:lo] -= _row(fac.rows, k)[:, :lo].T @ ak
    return r


def _inverse_column(fac: Factor, l: int, b: int) -> torch.Tensor:
    """Block column l of K^{-1} from block row l down: ((P - l) b, b).

    L W = E_l by forward substitution over blocks l..P-1 (W is zero above
    block l, and W_l = L_ll^{-1}), then L^T Z = W by backward substitution
    from block P-1 up to block l, in place over W (mesh.py:501-532, which
    solves for every block of the column)."""
    P = len(fac.rows)
    m = P - l
    W = torch.empty((m * b, b), dtype=fac.linv.dtype, device=fac.linv.device)
    W[:b] = fac.linv[l]
    for k in range(l + 1, P):
        i = k - l
        W[i * b:(i + 1) * b] = -(fac.linv[k] @ (_row(fac.rows, k)[:, l * b:k * b] @ W[:i * b]))
    for k in range(P - 1, l - 1, -1):
        i = k - l
        Zk = fac.linv[k].T @ W[i * b:(i + 1) * b]
        W[i * b:(i + 1) * b] = Zk
        if i:
            W[:i * b].addmm_(_row(fac.rows, k)[:, l * b:k * b].T, Zk, alpha=-1.0)
    return W


def _gram_tile_vjp(spec, th, t, meta, wrt, ct, i, l, b, mult):
    """The cotangent `ct` (b, b) of gram tile (i, l), pulled back to `wrt`
    (theta and/or t) by one `torch.autograd.grad`; on the diagonal tile
    (`mult` given) also through the noise at the forward's multiplier."""
    ri, cl = slice(i * b, (i + 1) * b), slice(l * b, (l + 1) * b)
    nat = _natural(spec, th)
    outs = [cross_gram_lmcsm(t[None, ri], meta[None, ri], t[None, cl], meta[None, cl],
                             nat["B"], nat["mu"], nat["v"])[0]]
    cts = [ct]
    if mult is not None and th.requires_grad:
        outs.append(_noise(spec, th, meta[cl]))
        cts.append(mult * torch.diagonal(ct))
    return torch.autograd.grad(outs, wrt, cts, allow_unused=True)


class LargeNLML(torch.autograd.Function):
    """(nlml, ok) of one padded patient by blocks, differentiable in theta,
    t and y (mesh.py:487-595 in the JAX package; mask's cotangent is 0 by
    declaration, meta gets none).

    Forward: the blocked factorization with its jitter retry; it keeps the
    multiplier, the ragged L, every L_kk^{-1} and alpha (by blocked back
    substitution).

    Backward: the Q-matrix identity dNLML/dK = 1/2 (K^{-1} - alpha alpha^T)
    (c_inference_exact.cpp:168-172), one block column l at a time: K^{-1}'s
    block column l from block row l down (`_inverse_column`), then
    Qbar = gbar/2 (Z - alpha alpha_l^T) on those rows, counted twice below
    the diagonal block (K and Qbar are symmetric, so the lower block
    triangle carries the whole sum), masked; then one `torch.autograd.grad`
    per (b, b) tile of those rows of the gram (`cross_gram_lmcsm`), and of
    the diagonal block's noise at the forward's multiplier. Only one tile's
    graph is alive at a time, so autograd keeps O(Q b^2) values, not
    O(Q n b).

    Flops of the backward, n = P b: the solves of block column l take
    about 2 (P - l)^2 b^3 (forward and backward substitution, each
    restricted to blocks >= l), which sums to 2/3 n^3 + O(n^2 b) over l,
    against n^3/3 for the forward; the gram's backward is O(Q n^2 / 2).
    """

    @staticmethod
    def forward(ctx, theta, t, y, meta, mask, spec, b, max_retries):
        mult, fac, ok = _factor_with_retry(spec, theta, t, y, meta, mask, b, max_retries)
        nlml = _nlml(fac, mask, ok)
        ctx.spec, ctx.b, ctx.mult, ctx.ok = spec, b, mult, ok
        if ok:
            ctx.fac = fac
            ctx.alpha = _back_substitute(fac, b)
        ctx.save_for_backward(theta, t, meta, mask)
        okt = torch.tensor(ok, device=mask.device)
        ctx.mark_non_differentiable(okt)
        return nlml, okt

    @staticmethod
    def backward(ctx, gbar, _gok):
        theta, t, meta, mask = ctx.saved_tensors
        need_th, need_t, need_y = ctx.needs_input_grad[:3]
        th_bar = torch.zeros_like(theta) if need_th else None
        t_bar = torch.zeros_like(t) if need_t else None
        y_bar = torch.zeros_like(t) if need_y else None
        mask_bar = torch.zeros_like(mask) if ctx.needs_input_grad[4] else None
        if not ctx.ok or gbar is None:
            return th_bar, t_bar, y_bar, None, mask_bar, None, None, None
        spec, b, fac, alpha = ctx.spec, ctx.b, ctx.fac, ctx.alpha
        if need_y:
            y_bar = gbar * alpha * mask
        if need_th or need_t:
            P = len(fac.rows)
            with torch.enable_grad():
                th = theta.detach().requires_grad_(need_th)
                tt = t.detach().requires_grad_(need_t)
                wrt = [x for x, need in ((th, need_th), (tt, need_t)) if need]
                acc = [torch.zeros_like(x) for x in wrt]
                for l in range(P):
                    lo, hi = l * b, (l + 1) * b
                    # Qbar's block column l, in place over K^{-1}'s
                    Qbar = _inverse_column(fac, l, b)
                    Qbar.addr_(alpha[lo:], alpha[lo:hi], alpha=-1.0)
                    Qbar.mul_(0.5 * gbar)
                    Qbar[b:] *= 2.0
                    Qbar.mul_(mask[lo:, None]).mul_(mask[None, lo:hi])
                    for i in range(P - l):
                        grads = _gram_tile_vjp(spec, th, tt, meta, wrt, Qbar[i * b:(i + 1) * b],
                                               l + i, l, b, ctx.mult if i == 0 else None)
                        acc = [a if g is None else a + g for a, g in zip(acc, grads)]
                    del Qbar
            acc = [_reduce(a) for a in acc]
            if need_th:
                th_bar = acc.pop(0)
            if need_t:
                t_bar = acc.pop(0)
        return th_bar, t_bar, y_bar, None, mask_bar, None, None, None


def large_patient_nlml(spec: LMCSMSpec, blocks: int, max_retries: int = 10):
    """Value-only NLML of one padded patient over `blocks` row blocks:
    `call(theta (H,), t, y, meta, mask) -> (nlml (), ok () bool)`, +inf
    where every jitter multiplier failed (mesh.py:644-794)."""

    def call(theta, t, y, meta, mask):
        mask = mask.to(t.dtype)
        b = block_width(t.shape[0], blocks)
        with torch.no_grad():
            _, fac, ok = _factor_with_retry(spec, theta, t, y, meta, mask, b, max_retries)
            nlml = _nlml(fac, mask, ok)
        return nlml, torch.tensor(ok, device=t.device)

    return call


def large_patient_nlml_diff(spec: LMCSMSpec, blocks: int, max_retries: int = 10):
    """`call(theta (H,), t, y, meta, mask) -> (nlml (), ok ())`,
    differentiable in theta, t and y through `LargeNLML` (mesh.py:318)."""

    def call(theta, t, y, meta, mask):
        mask = mask.to(t.dtype)
        b = block_width(t.shape[0], blocks)
        return LargeNLML.apply(theta, t, y, meta, mask, spec, b, max_retries)

    return call


def large_patient_objective(
    spec: LMCSMSpec,
    blocks: int,
    t: torch.Tensor,
    y: torch.Tensor,
    meta: torch.Tensor,
    mask: torch.Tensor,
    prior: Optional[PriorSpec] = None,
    max_retries: int = 10,
    base=None,
):
    """`f(theta (1, H), idx=None) -> (value (1,), grad (1, H), ok (1,))`
    over one padded patient (mesh.py:601-641), the batched signature of
    `models/gp.py:objective_and_grad` with k = 1, for `scg_minimize` and
    `varem_train(objective_factory=...)`. value = NLML - log prior; the
    gradient is multiplied by the prior's grad_mask; ok also needs
    sum(mask) > 2 and a finite gradient, and a failed evaluation reads
    +inf with a zero gradient. `base` reuses a `large_patient_nlml_diff`
    callable."""
    if base is None:
        base = large_patient_nlml_diff(spec, blocks, max_retries)
    enough = bool(torch.sum(mask) > 2)

    def f(theta, idx=None):
        with torch.enable_grad():
            th = theta.detach().requires_grad_()
            v, ok = base(th[0], t, y, meta, mask)
            v = v.reshape(1)
            if prior is not None:
                v = v - log_prior(prior, th).reshape(1)
            if bool(ok):
                (g,) = torch.autograd.grad(v.sum(), th)
            else:
                g = torch.zeros_like(th)
        if prior is not None:
            g = g * prior.grad_mask()
        okv = ok.reshape(1) & enough & torch.all(torch.isfinite(g), dim=-1)
        g = torch.where(okv[:, None], g, torch.zeros_like(g))
        v = torch.where(okv, v.detach(), torch.full_like(v, math.inf))
        return v, g, okv

    return f


def large_patient_screen(spec: LMCSMSpec, blocks: int, max_retries: int = 10):
    """`screen(thetas (S, H), t, y, meta, mask) -> (values (S,), oks (S,))`:
    S value-only evaluations, one after another, so only one
    factorization's workspace is live at a time (mesh.py:797-824); failed
    ones read +inf."""
    base = large_patient_nlml(spec, blocks, max_retries)

    def screen(thetas, t, y, meta, mask):
        vals, oks = zip(*(base(th, t, y, meta, mask) for th in thetas))
        vals, oks = torch.stack(vals), torch.stack(oks)
        vals = torch.where(oks & torch.isfinite(vals), vals, torch.full_like(vals, math.inf))
        return vals, oks

    return screen
