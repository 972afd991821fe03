"""Per-hyperparameter prior registry and the hierarchical-gamma setup.

Counterpart of ``medgp_tpu/models/priors.py``. A `PriorSpec` is a
struct-of-arrays over the flat theta (length H): an active flag, an
exp-transform flag, a type code and two parameters per hyper. The fields
may carry leading batch dimensions (one prior per patient, as varEM keeps
them); `log_prior` broadcasts them against theta (..., H). Type codes
(medgpc/src/prior/c_prior.h:50-53):

    -1 = none, 0 = clamped, 1 = normal(loc, VARIANCE), 2 = laplace(loc, b),
     3 = Gaussian KDE over samples (bandwidth in `scale`)

Log-densities (c_prior.cpp:383-421), evaluated at exp(theta) where the
exp flag is set:
    normal : lp = -(x-m)^2 / (2*var) - log(2*pi*var)/2
    laplace: lp = -|x-m|/b - log(2*b)

The hierarchical-gamma prior for LMC-SM (c_prior.cpp:222-279): A-elements
Normal(0, psi) with psi re-linked by varEM, mu and v unregularized
(exp-transformed), kappa Laplace(0, beta_lam) on exp(theta), noise
unregularized. A clamped hyper (type 0) has its gradient zeroed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from medgp_tpu_torch.models.params import REF_PI, LMCSMSpec, cov_slices

PRIOR_NONE = -1
PRIOR_CLAMP = 0
PRIOR_NORMAL = 1
PRIOR_LAPLACE = 2
PRIOR_KDE = 3


class PriorSpec(NamedTuple):
    active: torch.Tensor     # (..., H) bool
    exp_tf: torch.Tensor     # (..., H) bool: hyper is exp-transformed
    ptype: torch.Tensor      # (..., H) int32 type code
    loc: torch.Tensor        # (..., H) float
    scale: torch.Tensor      # (..., H) float: variance, b or bandwidth
    kde_samples: Optional[torch.Tensor] = None  # (H, S) padded KDE samples
    kde_mask: Optional[torch.Tensor] = None     # (H, S) sample validity

    @property
    def n_hyp(self) -> int:
        return self.active.shape[-1]

    def grad_mask(self) -> torch.Tensor:
        """1.0 where the hyper may move, 0.0 where clamped
        (c_inference_prior.cpp:75-77,101-104 force dnlml := 0)."""
        clamped = self.active & (self.ptype == PRIOR_CLAMP)
        return 1.0 - clamped.to(self.scale.dtype)

    def rows(self, idx: torch.Tensor) -> "PriorSpec":
        """The priors of batch elements `idx` of a batched prior (..., H)."""
        per = [x[idx] for x in self[:5]]
        return PriorSpec(*per, self.kde_samples, self.kde_mask)

    def expand(self, batch: int) -> "PriorSpec":
        """One copy per batch element: (H,) fields -> (batch, H)."""
        per = [x.expand(batch, -1).clone() for x in self[:5]]
        return PriorSpec(*per, self.kde_samples, self.kde_mask)


def empty_prior(n_hyp: int, dtype=torch.float32, device="cpu") -> PriorSpec:
    """All hypers unregularized (prior mode 0)."""
    return PriorSpec(
        active=torch.zeros(n_hyp, dtype=torch.bool, device=device),
        exp_tf=torch.zeros(n_hyp, dtype=torch.bool, device=device),
        ptype=torch.full((n_hyp,), PRIOR_NONE, dtype=torch.int32, device=device),
        loc=torch.zeros(n_hyp, dtype=dtype, device=device),
        scale=torch.ones(n_hyp, dtype=dtype, device=device),
    )


def hier_gamma_prior(
    spec: LMCSMSpec, beta_lam: float = 0.5, dtype=torch.float32, device="cpu"
) -> PriorSpec:
    """Initial prior state for the hierarchical-gamma sparse LMC-SM setup:
    Normal(0, psi = 1) on A (init_cov_varEM(_, 1.0), c_prior.cpp:234) and
    Laplace(0, beta_lam) on kappa (c_prior.cpp:264-272)."""
    H = spec.n_hyp
    sl = cov_slices(spec)
    active = np.zeros(H, bool)
    exp_tf = np.zeros(H, bool)
    ptype = np.full(H, PRIOR_NONE, np.int32)
    scale = np.ones(H)

    active[sl["a"]] = True
    ptype[sl["a"]] = PRIOR_NORMAL
    exp_tf[sl["mu"]] = True
    exp_tf[sl["v"]] = True
    active[sl["kappa"]] = True
    exp_tf[sl["kappa"]] = True
    ptype[sl["kappa"]] = PRIOR_LAPLACE
    scale[sl["kappa"]] = beta_lam

    return PriorSpec(
        active=torch.as_tensor(active, device=device),
        exp_tf=torch.as_tensor(exp_tf, device=device),
        ptype=torch.as_tensor(ptype, device=device),
        loc=torch.zeros(H, dtype=dtype, device=device),
        scale=torch.as_tensor(scale, dtype=dtype, device=device),
    )


def log_prior(prior: PriorSpec, theta: torch.Tensor) -> torch.Tensor:
    """Sum of log prior densities over active, non-clamped hypers,
    theta (..., H) -> (...).

    The unselected branches are computed with sanitized parameters, so
    the backward pass never meets a division by zero or log(0)."""
    h = torch.where(prior.exp_tf, torch.exp(theta), theta)
    use_normal = prior.ptype == PRIOR_NORMAL
    use_laplace = prior.ptype == PRIOR_LAPLACE
    one = torch.ones_like(prior.scale)

    var_safe = torch.where(use_normal, torch.clamp(prior.scale, min=1e-300), one)
    b_safe = torch.where(use_laplace, torch.clamp(prior.scale, min=1e-300), one)
    diff = h - prior.loc

    lp_normal = -(diff * diff) / (2.0 * var_safe) - 0.5 * torch.log(
        2.0 * REF_PI * var_safe
    )
    lp_laplace = -torch.abs(diff) / b_safe - torch.log(2.0 * b_safe)
    zero = torch.zeros_like(lp_normal)
    lp = torch.where(use_normal, lp_normal, zero) + torch.where(
        use_laplace, lp_laplace, zero
    )

    if prior.kde_samples is not None:
        # Gaussian KDE (c_prior.cpp:165-194 `prior_lik_kde`):
        # p(x) = sum_s N((x - x_s) / bw) / (n * bw)
        use_kde = prior.ptype == PRIOR_KDE
        bw = torch.where(use_kde, torch.clamp(prior.scale, min=1e-30), one)
        z = (h[..., None] - prior.kde_samples) / bw[..., None]
        m = prior.kde_mask.to(z.dtype)
        dens = torch.sum(
            torch.exp(-0.5 * z * z) / np.sqrt(2.0 * REF_PI) * m, dim=-1
        )
        n_s = torch.clamp(torch.sum(m, dim=-1), min=1.0)
        # sanitize the unselected branch BEFORE the log: non-KDE rows have
        # dens == 0, and log(0) would put 0 * inf = NaN into the gradient
        dens = torch.where(use_kde, torch.clamp(dens, min=1e-30), torch.ones_like(dens))
        lp_kde = torch.log(dens / (n_s * bw))
        lp = lp + torch.where(use_kde, lp_kde, zero)

    sel = prior.active & (prior.ptype > PRIOR_CLAMP)
    return torch.sum(torch.where(sel, lp, zero), dim=-1)


def log_prior_grad(prior: PriorSpec, theta: torch.Tensor) -> torch.Tensor:
    """d log_prior / d theta (..., H) in closed form, for priors without
    KDE samples: -(h - m) / var (normal) and -sign(h - m) / b (Laplace,
    0 at h = m as autograd's abs gives), times h where the hyper is
    exp-transformed; 0 on every other hyper."""
    if prior.kde_samples is not None:
        raise ValueError("log_prior_grad: KDE priors take log_prior under autograd")
    h = torch.where(prior.exp_tf, torch.exp(theta), theta)
    use_normal = prior.ptype == PRIOR_NORMAL
    use_laplace = prior.ptype == PRIOR_LAPLACE
    one = torch.ones_like(prior.scale)
    var_safe = torch.where(use_normal, torch.clamp(prior.scale, min=1e-300), one)
    b_safe = torch.where(use_laplace, torch.clamp(prior.scale, min=1e-300), one)
    diff = h - prior.loc
    zero = torch.zeros_like(diff)
    g = torch.where(use_normal, -diff / var_safe, zero) + torch.where(
        use_laplace, -torch.sign(diff) / b_safe, zero
    )
    g = torch.where(prior.exp_tf, g * h, g)
    return torch.where(prior.active & (use_normal | use_laplace), g, zero)


def set_kde_prior(
    prior: PriorSpec,
    index: int,
    samples,
    bandwidth: float,
    max_samples: int | None = None,
) -> PriorSpec:
    """Attach a KDE prior (type 3) to one hyper of an (H,) prior; samples
    are padded into the (H, S) buffer shared by all KDE-prior hypers."""
    dtype, device = prior.loc.dtype, prior.loc.device
    samples = torch.as_tensor(samples, dtype=dtype, device=device).reshape(-1)
    k = samples.shape[0]
    S = max_samples or k
    H = prior.n_hyp
    kde_samples, kde_mask = prior.kde_samples, prior.kde_mask
    if kde_samples is None or kde_samples.shape[-1] < S:
        old_s = 0 if kde_samples is None else kde_samples.shape[-1]
        new_samples = torch.zeros((H, S), dtype=dtype, device=device)
        new_mask = torch.zeros((H, S), dtype=torch.bool, device=device)
        if old_s:
            new_samples[:, :old_s] = kde_samples
            new_mask[:, :old_s] = kde_mask
        kde_samples, kde_mask = new_samples, new_mask
    else:
        kde_samples, kde_mask = kde_samples.clone(), kde_mask.clone()
    active, ptype, scale = prior.active.clone(), prior.ptype.clone(), prior.scale.clone()
    active[index] = True
    ptype[index] = PRIOR_KDE
    scale[index] = bandwidth
    kde_samples[index, :k] = samples
    kde_mask[index, :k] = True
    return prior._replace(
        active=active, ptype=ptype, scale=scale,
        kde_samples=kde_samples, kde_mask=kde_mask,
    )


def clamp_a_elements(
    prior: PriorSpec, spec: LMCSMSpec, a_clamp_flat: torch.Tensor
) -> PriorSpec:
    """Clamp the A-elements flagged in `a_clamp_flat` (..., Q*D*R bool):
    varEM when psi -> 0 (c_optimizer_varEM.cpp:151-155), and the test
    stage for A-elements exactly 0 in the mode kernel (c_prior.cpp:118-140
    `init_test_prior`)."""
    sl = cov_slices(spec)
    clamp_full = torch.zeros_like(prior.active)
    clamp_full[..., sl["a"]] = a_clamp_flat.to(torch.bool)
    ptype = torch.where(
        clamp_full, torch.full_like(prior.ptype, PRIOR_CLAMP), prior.ptype
    )
    return prior._replace(active=prior.active | clamp_full, ptype=ptype)


def set_a_variance(
    prior: PriorSpec, spec: LMCSMSpec, psi_flat: torch.Tensor
) -> PriorSpec:
    """Re-link the Normal variance on A-elements to the varEM psi
    (c_optimizer_varEM.cpp:157-158)."""
    sl = cov_slices(spec)
    scale, loc = prior.scale.clone(), prior.loc.clone()
    scale[..., sl["a"]] = psi_flat.to(scale.dtype)
    loc[..., sl["a"]] = 0.0
    return prior._replace(scale=scale, loc=loc)
