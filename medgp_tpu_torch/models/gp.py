"""Model assembly: flat theta -> MAP objective and its gradient, posterior.

Counterpart of ``medgp_tpu/models/gp.py``. Patients carry an explicit
leading batch dimension where JAX vmaps: `data` tensors are (B, n), and
theta is either one shared (H,) vector (the test stage's mode kernel) or
one (B, H) row per patient (training, online updates).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from medgp_tpu_torch.models.params import KernelSpec, LMCSMSpec, SESpec, SMSpec
from medgp_tpu_torch.models.priors import PriorSpec, log_prior
from medgp_tpu_torch.ops import cuda_gram
from medgp_tpu_torch.ops.gram import (
    cross_gram_lmcsm, diag_lmcsm, gram_se, gram_sm, sm_base, squared_dist,
)
from medgp_tpu_torch.ops.nlml import (
    NLMLResult, Posterior, mask_gram, masked_nlml, predict,
)
from medgp_tpu_torch.ops.objective import LMCSMObjective, fusable
from medgp_tpu_torch.utils import metrics


class PatientData(NamedTuple):
    """A padded batch of patients; every tensor is (B, n_max)."""

    t: torch.Tensor     # float32 timestamps (hours since admission)
    y: torch.Tensor     # float32 z-normalized observations
    meta: torch.Tensor  # int32 output index in [0, D); 0 on padding
    mask: torch.Tensor  # float32 {0, 1} validity

    @property
    def n_obs(self) -> torch.Tensor:
        return torch.sum(self.mask, dim=-1)

    def rows(self, idx: torch.Tensor) -> "PatientData":
        return PatientData(*(x[idx] for x in self))


def _per_patient(x: torch.Tensor, batched: bool, Bt: int) -> torch.Tensor:
    """A natural parameter (...) of a shared theta as (Bt, ...), or of a
    per-patient theta as it is; contiguous for the kernels."""
    return (x if batched else x.expand(Bt, *x.shape)).contiguous()


def noiseless_gram(
    spec: KernelSpec,
    theta: torch.Tensor,
    data: PatientData,
    masked: bool = False,
) -> torch.Tensor:
    """(B, n, n) noiseless gram of every patient under theta (H,) or (B, H).

    The LMC-SM gram goes through K1 (`cuda_gram.gram_lmcsm_fused`: the CUDA
    kernel for tensors on the card, its plain twin on the CPU), and, when
    autograd needs its gradient, through `cuda_gram.GramLMCSM`, whose
    backward is K2. With `masked=True` the result carries mask_gram
    semantics (zero padded rows/cols, unit diagonal there), fused into K1's
    epilogue."""
    p = spec.unpack(theta)
    mask = data.mask if masked else None
    batched = theta.dim() == 2
    Bt = data.t.shape[0]
    if isinstance(spec, LMCSMSpec):
        B = spec.coregional_B(p["A"], p["kappa"])
        args = (
            data.t, data.meta, _per_patient(B, batched, Bt),
            _per_patient(p["mu"], batched, Bt), _per_patient(p["v"], batched, Bt),
        )
        if torch.is_grad_enabled() and theta.requires_grad:
            return cuda_gram.GramLMCSM.apply(*args, mask)
        return cuda_gram.gram_lmcsm_fused(*args, mask=mask)
    if isinstance(spec, SESpec):
        ls, sc = p["lengthscale"], p["scale"]
        if batched:
            ls, sc = ls[:, None], sc[:, None, None]
        K = gram_se(data.t, ls, sc)
    elif isinstance(spec, SMSpec):
        K = gram_sm(data.t, p["w"], p["mu"], p["v"])
    else:
        raise TypeError(f"unsupported spec {spec!r}")
    return K if mask is None else mask_gram(K, mask)


def noise_variance(
    spec: KernelSpec, theta: torch.Tensor, meta: torch.Tensor
) -> torch.Tensor:
    """Per-observation Gaussian noise variance sigma^2: per output for
    LMC-SM (c_likelihood_gaussianMO.cpp:43-65), one sigma^2 for SE/SM."""
    s2 = spec.unpack(theta)["noise_std"] ** 2
    if isinstance(spec, LMCSMSpec):
        if theta.dim() == 2:
            # a one-hot product, not a gather: the same values (one nonzero
            # per row), and its backward is a matmul where a gather's is a
            # scatter-add whose float atomics sum in another order per run
            oh = torch.nn.functional.one_hot(meta.long(), spec.D).to(s2.dtype)
            return (oh @ s2[:, :, None]).squeeze(-1)
        return s2[meta.long()]
    return torch.broadcast_to(s2[..., :1], meta.shape)


def nlml_fn(
    spec: KernelSpec,
    data: PatientData,
    prior: Optional[PriorSpec] = None,
    max_retries: int = 10,
):
    """Build `loss(theta (B, H)) -> (nlml_map (B,), NLMLResult)` for a padded
    batch: exact-inference NLML (c_inference_exact.cpp:29-152) minus the
    log-prior (c_inference_prior.cpp:59-151); +inf where the factorization
    failed or the patient has <= 2 observations (c_objective_one.cpp:51).

    The LMC-SM kernel with the zero mean and a prior without KDE samples
    (or none) takes one autograd node, `ops/objective.py:LMCSMObjective`,
    for a (B, H) theta; every other spec, mean, prior or theta shape takes
    the composition below under autograd. On the fused path only `value`
    carries a gradient: its NLMLResult fields carry none (the posterior
    paths, which need one through L or alpha, call `masked_nlml`)."""
    fused = fusable(spec, prior)

    def loss(theta):
        if fused and theta.dim() == 2:
            value, nlml, L, alpha, ok, mult = LMCSMObjective.apply(
                theta, spec, data, prior, max_retries
            )
            return value, NLMLResult(nlml=nlml, ok=ok, L=L, alpha=alpha, mult=mult)
        K = noiseless_gram(spec, theta, data, masked=True)
        nv = noise_variance(spec, theta, data.meta)
        mean = spec.mean_vector(theta, data.meta)
        res = masked_nlml(
            K, data.y, nv, data.mask, mean=mean, max_retries=max_retries,
            pre_masked=True,
        )
        value = res.nlml
        if prior is not None:
            value = value - log_prior(prior, theta)
        ok = res.ok & (data.n_obs > 2)
        value = torch.where(ok, value, torch.full_like(value, float("inf")))
        return value, res

    return loss


def objective_and_grad(
    spec: KernelSpec,
    data: PatientData,
    prior: Optional[PriorSpec] = None,
    max_retries: int = 10,
):
    """`f(theta (k, H), idx=None) -> (value (k,), grad (k, H), ok (k,))`.

    `idx` (k,) selects the patients of `data` (and the rows of a batched
    `prior`) that the k thetas belong to; None means all of them. One
    backward pass serves the batch: each value's cotangent is 1 where the
    element is ok and 0 where it failed, so an inf never reaches autograd.
    The gradient is masked by the prior's `grad_mask` (clamped hypers do
    not move) and zeroed where the evaluation failed, is not finite, or
    the patient has <= 2 observations (gp.py:141-162 in the JAX package).

    Each call is the span `medgp.objective`, with `.forward` (K1, K3 and
    the jitter loop; on the fused path the θ prologue first) and
    `.backward` (the autograd call: K4, K2; on the fused path the θ
    epilogue last) inside it (utils/metrics.py)."""
    gmask = None if prior is None else prior.grad_mask()

    def f(theta, idx=None):
        with metrics.span("medgp.objective"):
            d, pr, gm = data, prior, gmask
            if idx is not None:
                d = data.rows(idx)
                if pr is not None and pr.active.dim() == 2:
                    pr, gm = pr.rows(idx), gm[idx]
            with torch.enable_grad():
                th = theta.detach().requires_grad_()
                with metrics.span("medgp.objective.forward"):
                    value, res = nlml_fn(spec, d, pr, max_retries)(th)
                    ok = res.ok & (d.n_obs > 2)
                with metrics.span("medgp.objective.backward"):
                    (g,) = torch.autograd.grad(value, th, ok.to(value.dtype))
            if gm is not None:
                g = g * gm
            ok = ok & torch.all(torch.isfinite(g), dim=-1)
            g = torch.where(ok[:, None], g, 0.0)
            return value.detach(), g, ok

    return f


def _posterior_parts(spec, theta, train, t2, meta2, max_retries):
    Bt = train.t.shape[0]
    batched = theta.dim() == 2
    p = spec.unpack(theta)
    K = noiseless_gram(spec, theta, train)
    nv = noise_variance(spec, theta, train.meta)
    mean = spec.mean_vector(theta, train.meta)
    res = masked_nlml(K, train.y, nv, train.mask, mean=mean, max_retries=max_retries)
    if isinstance(spec, LMCSMSpec):
        B = _per_patient(spec.coregional_B(p["A"], p["kappa"]), batched, Bt)
        Ks = cross_gram_lmcsm(
            train.t, train.meta, t2, meta2, B,
            _per_patient(p["mu"], batched, Bt), _per_patient(p["v"], batched, Bt),
        )
        kss = diag_lmcsm(meta2, B)
    elif isinstance(spec, SESpec):
        ls, sc = p["lengthscale"], p["scale"]
        if batched:
            ls, sc = ls[:, None], sc[:, None]
        rsq = squared_dist(train.t / ls, t2 / ls)
        Ks = (sc**2)[..., None] * torch.exp(-0.5 * rsq)
        kss = torch.broadcast_to(sc**2, t2.shape)
    elif isinstance(spec, SMSpec):
        w, mu, v = p["w"], p["mu"], p["v"]
        rsq = squared_dist(train.t, t2)
        Ks = torch.zeros_like(rsq)
        for q in range(spec.Q):
            Ks = Ks + w[..., q, None, None] * sm_base(
                rsq, mu[..., q, None, None], v[..., q, None, None]
            )
        kss = torch.broadcast_to(torch.sum(w, dim=-1, keepdim=True), t2.shape)
    else:
        raise TypeError(f"unsupported spec {spec!r}")
    nv2 = noise_variance(spec, theta, meta2)
    mean2 = spec.mean_vector(theta, meta2)
    post = predict(res.L, res.alpha, Ks, kss, nv2, train.mask, mean_test=mean2)
    return post, res, Ks


def posterior_at(
    spec: KernelSpec,
    theta: torch.Tensor,
    train: PatientData,
    t2: torch.Tensor,
    meta2: torch.Tensor,
    max_retries: int = 10,
) -> Posterior:
    """Train on `train` (B, n) and predict at (t2, meta2) (B, m), as
    GP_Regression.train + .predict (gp_regression.cpp:102-213)."""
    return _posterior_parts(spec, theta, train, t2, meta2, max_retries)[0]


def parsed_posterior_at(
    spec: KernelSpec,
    theta: torch.Tensor,
    train: PatientData,
    t2: torch.Tensor,
    meta2: torch.Tensor,
    max_retries: int = 10,
):
    """Posterior plus the per-source-output decomposition of its mean,
    contribution_d[j] = sum_{k: meta_k = d} Ks[k, j] alpha_k
    (gp_regression.cpp:216-320 `parsed_predict`).
    Returns (Posterior, contributions (B, D, m))."""
    if not isinstance(spec, LMCSMSpec):
        raise TypeError("parsed prediction is defined for the LMC-SM kernel")
    post, res, Ks = _posterior_parts(spec, theta, train, t2, meta2, max_retries)
    onehot = torch.nn.functional.one_hot(train.meta.long(), spec.D).to(Ks.dtype)
    weighted = Ks * (res.alpha * train.mask.to(Ks.dtype))[..., :, None]
    return post, torch.einsum("bnd,bnm->bdm", onehot, weighted)
