"""The LMC-SM MAP objective as one autograd node, `LMCSMObjective`, and
its two hand-written kernels: the θ prologue and the gradient epilogue
(``csrc/theta.cuh``), each with its plain twin.

value(theta) = NLML(theta) - log prior(theta), +inf where the
factorization failed or the patient has <= 2 observations, for the LMC-SM
kernel with the zero mean and a prior without KDE samples (or none). It is
the composition of `models/gp.py:nlml_fn` for other specs and priors
(`noiseless_gram` + `masked_nlml` + `log_prior` under autograd), computed
with the same arithmetic in the same precision, so autograd walks one
node where it walked about fifty:

  forward:  the prologue (B_q, mu, v, the masked noise and y, the log
            prior, the valid count), K1 (`cuda_gram.gram_lmcsm_fused`,
            masked), K3 through `nlml.jittered_chol_solve` (its retries,
            its one `nonzero` sync and `mult` unchanged), then the NLML
            value as `nlml.masked_nlml` and `gp.nlml_fn` take it;
  backward: K4 (`cuda_chol.qmat`, coef = d_value / 2 on ok rows), K2
            (`cuda_gram.gram_lmcsm_bwd`), then the epilogue: dtheta from
            dB, dmu, dv, K4's diagonal times the jitter multiplier, theta
            and the prior, each row's prior term scaled by its d_value and
            every row zeroed where it is not ok. Each backward counts its
            rows as `objective.fused_systems` (utils/metrics.py).

Each kernel wrapper takes the device of its inputs as the choice: CPU
tensors go to the plain twin, CUDA tensors to the kernel (or an error),
with no fallback from one to the other; every launch on the card counts
`theta_prologue.launches` / `theta_epilogue.launches`.
"""

from __future__ import annotations

import math

import torch

from medgp_tpu_torch.models.params import REF_PI, LMCSMSpec
from medgp_tpu_torch.models.priors import PriorSpec, log_prior, log_prior_grad
from medgp_tpu_torch.ops import cuda_build, cuda_chol, cuda_gram
from medgp_tpu_torch.ops.nlml import jittered_chol_solve
from medgp_tpu_torch.utils import metrics

# (sum m) / 2 log(2 pi) of `masked_nlml`, as one factor: halving is exact,
# so n_eff * HALF_LOG_2PI has the bits of 0.5 * n_eff * log(2 pi)
HALF_LOG_2PI = 0.5 * math.log(2.0 * REF_PI)
PRIOR_FIELDS = ("active", "exp_tf", "ptype", "loc", "scale")
_PRIOR_DTYPES = (torch.bool, torch.bool, torch.int32, torch.float32, torch.float32)


def fusable(spec, prior: PriorSpec | None) -> bool:
    """Whether `LMCSMObjective` serves this spec and prior: the LMC-SM
    kernel with the zero mean, and no prior or one without KDE samples,
    shared (H,) or batched (k, H)."""
    return (
        isinstance(spec, LMCSMSpec)
        and spec.n_mean == 0
        and (prior is None or prior.kde_samples is None)
    )


def _prior_args(prior, k, H, dev):
    """The prior's five fields as kernel pointers (all None without a
    prior) and its row stride: 0 shared, H batched."""
    if prior is None:
        return [None] * len(PRIOR_FIELDS), 0
    batched = prior.active.dim() == 2
    fields = [getattr(prior, name) for name in PRIOR_FIELDS]
    for name, x, dt in zip(PRIOR_FIELDS, fields, _PRIOR_DTYPES):
        cuda_build.require(x, "prior." + name, dt, (k, H) if batched else (H,), dev)
    return [x.data_ptr() for x in fields], H if batched else 0


def theta_prologue_plain(theta, y, meta, mask, prior, spec: LMCSMSpec):
    """Plain PyTorch prologue, the composition's own ops: `spec.unpack`,
    `coregional_B`, sigma^2 of each observation's output, `log_prior`."""
    p = spec.unpack(theta)
    m = mask.to(theta.dtype)
    B = spec.coregional_B(p["A"], p["kappa"])
    s2 = p["noise_std"] ** 2
    noise = torch.gather(s2, -1, meta.long()) * m
    if prior is None:
        lp = torch.zeros(theta.shape[:-1], dtype=theta.dtype, device=theta.device)
    else:
        lp = log_prior(prior, theta)
    return (B.contiguous(), p["mu"].contiguous(), p["v"].contiguous(), noise, y * m, lp,
            torch.sum(m, dim=-1))


def theta_prologue(theta, y, meta, mask, prior, spec: LMCSMSpec):
    """theta (k, H) float32, y / meta / mask (k, n) and a prior (None, (H,)
    or (k, H) fields) -> B (k, Q, D, D), mu and v (k, Q), noise = sigma^2
    _{meta_i} mask_i and y_eff = y_i mask_i (k, n), the log prior over the
    active normal and Laplace hypers (k,), and n_eff = sum mask (k,)."""
    if theta.device.type == "cpu":
        return theta_prologue_plain(theta, y, meta, mask, prior, spec)
    if theta.device.type != "cuda":
        raise ValueError(f"theta_prologue: unsupported device {theta.device}")
    k, H = theta.shape
    n = y.shape[-1]
    Q, D, R = spec.Q, spec.D, spec.R
    dev, f32 = theta.device, torch.float32
    theta = theta.contiguous()
    cuda_build.require(theta, "theta", f32, (k, spec.n_hyp), dev)
    cuda_build.require(y, "y", f32, (k, n), dev)
    cuda_build.require(meta, "meta", torch.int32, (k, n), dev)
    cuda_build.require(mask, "mask", f32, (k, n), dev)
    pptr, stride = _prior_args(prior, k, H, dev)
    B = torch.empty((k, Q, D, D), dtype=f32, device=dev)
    mu = torch.empty((k, Q), dtype=f32, device=dev)
    v = torch.empty((k, Q), dtype=f32, device=dev)
    noise = torch.empty((k, n), dtype=f32, device=dev)
    y_eff = torch.empty((k, n), dtype=f32, device=dev)
    lp = torch.empty((k,), dtype=f32, device=dev)
    n_eff = torch.empty((k,), dtype=f32, device=dev)
    out = (B, mu, v, noise, y_eff, lp, n_eff)
    if k == 0 or n == 0:
        return out
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        code = lib.medgp_theta_prologue(
            theta.data_ptr(), y.data_ptr(), meta.data_ptr(), mask.data_ptr(), *pptr,
            *(x.data_ptr() for x in out), k, n, Q, D, R, stride,
            cuda_build.stream_of(theta),
        )
    cuda_build.check_launch(code, "theta_prologue")
    metrics.count("theta_prologue.launches")
    return out


def theta_epilogue_plain(theta, dB, dmu, dv, dKm, mult, meta, mask, d_value, ok, prior,
                         spec: LMCSMSpec):
    """Plain PyTorch epilogue, the kernel's closed forms: dA = (dB + dB^T) A,
    d log kappa = diag(dB) kappa, d log mu = dmu mu, d log v = dv v,
    d log sigma_d = 2 sigma_d^2 sum_{meta_i = d} mult dKm_ii mask_i, less
    d_value times `log_prior_grad`; rows not ok are 0."""
    k = theta.shape[0]
    p = spec.unpack(theta)
    m = mask.to(theta.dtype)
    dA = (dB + dB.mT) @ p["A"]
    dkappa = torch.diagonal(dB, dim1=-2, dim2=-1) * p["kappa"]
    dnoise = (mult.to(theta.dtype)[:, None] * torch.diagonal(dKm, dim1=-2, dim2=-1)) * m
    onehot = torch.nn.functional.one_hot(meta.long(), spec.D).to(theta.dtype)
    ds2 = (dnoise[:, None, :] @ onehot).squeeze(1)
    g = torch.cat([
        2.0 * p["noise_std"] ** 2 * ds2, dA.reshape(k, -1), dmu * p["mu"], dv * p["v"],
        dkappa.reshape(k, -1),
    ], dim=-1)
    if prior is not None:
        g = g - d_value[:, None] * log_prior_grad(prior, theta)
    return torch.where(ok[:, None], g, torch.zeros_like(g))


def theta_epilogue(theta, dB, dmu, dv, dKm, mult, meta, mask, d_value, ok, prior,
                   spec: LMCSMSpec):
    """theta (k, H) float32, K2's dB (k, Q, D, D), dmu and dv (k, Q), K4's
    dKm (k, n, n) (its diagonal is read), the jitter multiplier (k,)
    int32, meta / mask (k, n), d_value (k,), ok (k,) bool and the prior ->
    dtheta (k, H)."""
    if theta.device.type == "cpu":
        return theta_epilogue_plain(theta, dB, dmu, dv, dKm, mult, meta, mask, d_value, ok,
                                    prior, spec)
    if theta.device.type != "cuda":
        raise ValueError(f"theta_epilogue: unsupported device {theta.device}")
    k, H = theta.shape
    n = meta.shape[-1]
    Q, D = spec.Q, spec.D
    dev, f32 = theta.device, torch.float32
    theta, d_value = theta.contiguous(), d_value.contiguous()
    cuda_build.require(theta, "theta", f32, (k, spec.n_hyp), dev)
    cuda_build.require(dB, "dB", f32, (k, Q, D, D), dev)
    cuda_build.require(dmu, "dmu", f32, (k, Q), dev)
    cuda_build.require(dv, "dv", f32, (k, Q), dev)
    cuda_build.require(dKm, "dKm", f32, (k, n, n), dev)
    cuda_build.require(mult, "mult", torch.int32, (k,), dev)
    cuda_build.require(meta, "meta", torch.int32, (k, n), dev)
    cuda_build.require(mask, "mask", f32, (k, n), dev)
    cuda_build.require(d_value, "d_value", f32, (k,), dev)
    cuda_build.require(ok, "ok", torch.bool, (k,), dev)
    pptr, stride = _prior_args(prior, k, H, dev)
    dtheta = torch.empty((k, H), dtype=f32, device=dev)
    if k == 0 or n == 0:
        return dtheta
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        code = lib.medgp_theta_epilogue(
            theta.data_ptr(), dB.data_ptr(), dmu.data_ptr(), dv.data_ptr(), dKm.data_ptr(),
            mult.data_ptr(), meta.data_ptr(), mask.data_ptr(), d_value.data_ptr(),
            ok.data_ptr(), *pptr, dtheta.data_ptr(), k, n, Q, D, spec.R, stride,
            cuda_build.stream_of(theta),
        )
    cuda_build.check_launch(code, "theta_epilogue")
    metrics.count("theta_epilogue.launches")
    return dtheta


class LMCSMObjective(torch.autograd.Function):
    """(value, nlml, L, alpha, ok, mult) of a padded batch: theta (k, H),
    `data` a PatientData (k, n), the prior None, (H,) or (k, H). value is
    the MAP loss nlml - log prior, +inf where ok is false or the patient
    has <= 2 observations; nlml, L, alpha, ok and mult are the fields of
    `nlml.NLMLResult` and carry no gradient. See the module's docstring."""

    @staticmethod
    def forward(ctx, theta, spec, data, prior, max_retries):
        ctx.set_materialize_grads(False)
        t, y, meta, mask = data
        B, mu, v, noise, y_eff, lp, n_eff = theta_prologue(theta, y, meta, mask, prior, spec)
        Km = cuda_gram.gram_lmcsm_fused(t, meta, B, mu, v, mask=mask)
        L, alpha, linvd, ok, mult = jittered_chol_solve(Km, y_eff, noise, max_retries)
        del Km
        logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        quad = torch.sum(y_eff * alpha, dim=-1)
        nlml = torch.where(ok, 0.5 * quad + logdet + n_eff * HALF_LOG_2PI, math.inf)
        live = ok & (n_eff > 2)
        value = torch.where(live, nlml if prior is None else nlml - lp, math.inf)
        ctx.save_for_backward(theta, B, mu, v, L, linvd, alpha, live, mult)
        ctx.spec, ctx.data, ctx.prior = spec, data, prior
        ctx.mark_non_differentiable(nlml, L, alpha, ok, mult)
        return value, nlml, L, alpha, ok, mult

    @staticmethod
    def backward(ctx, d_value, *_):
        if d_value is None:
            return None, None, None, None, None
        theta, B, mu, v, L, linvd, alpha, live, mult = ctx.saved_tensors
        t, _y, meta, mask = ctx.data
        dKm = cuda_chol.qmat(L, linvd, alpha, torch.where(live, 0.5 * d_value, 0.0))
        dB, dmu, dv = cuda_gram.gram_lmcsm_bwd(dKm, t, meta, B, mu, v, mask)
        g = theta_epilogue(theta, dB, dmu, dv, dKm, mult, meta, mask, d_value, live,
                           ctx.prior, ctx.spec)
        metrics.count("objective.fused_systems", theta.shape[0])
        return g, None, None, None, None
