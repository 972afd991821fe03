"""Patients over ranks, and one large patient's rows over ranks.

Counterpart of ``medgp_tpu/parallel/mesh.py``. The JAX package shards a
padded bucket over a device mesh with `shard_map`; here the mesh is the
`torch.distributed` world, one process per GPU (parallel/launch.py), and
a `CohortMesh` names this process's group, world, rank, device and
backend.

Cohort part (mesh.py:37-170 in the JAX package). A bucket padded to a
multiple of the world W with all-masked dummy patients (`pad_batch_to`)
is split into W contiguous slices; rank r runs slice r through the
single-device function (`train_one_patient`, `online_impute`, a sampler)
and the results are all-gathered, so every rank ends with the whole
bucket. The collective helpers (`all_gather`, `broadcast`, `all_reduce`)
move CUDA tensors through host memory on a gloo group, which has no
all-gather for them; the group's backend decides that.

Population statistics (mesh.py:173-315): the density-weighted KDE mode of
each output's noise over the flagged patients of each CV fold, from one
all-gather, in float32 on the rank's device as the JAX package computes
it; NaN for a fold with no flagged patient.

Large patient (mesh.py:318-824). The NLML of one padded LMC-SM patient,
its gradient, its restart screen and its MAP objective over P row blocks
of width b (n = P b). The gram is never held whole: row block l is a
(b, (l+1) b) tensor, the lower block triangle only, and the factorization
overwrites it with row block l of L. Without a mesh the P blocks are
walked on one device. Over a mesh of W ranks (W divides P), rank r holds
the row blocks l = r (mod W) only: about n (n + W b) / (2 W) values of L,
while the P diagonal-block inverses (P b^2 = n b values), z and alpha are
replicated. Cyclic ownership spreads the right-looking trailing updates
evenly; at P = W it is the JAX package's layout. The block exchanges:

  * the diagonal block k: its owner factors A_kk by K3
    (`cuda_chol.chol_solve`, one (b, b) matrix, zero noise) and inverts
    L_kk by K5 (`cuda_chol.tri_inv`), then broadcasts L_kk^{-1} and
    log diag(L_kk);
  * block column k below the diagonal (`_gather_column`): all-gathered
    from its owners, so every rank forms the panel S = C L_kk^{-T} and
    the forward substitution z_k = L_kk^{-1} y_k itself; each owner then
    writes its rows of the panel (`_set_column`) and updates its trailing
    rows;
  * the back substitution for alpha: the owner of row block k broadcasts
    its product L_k^T alpha_k;
  * the backward: rank r forms K^{-1}'s block column l = g + r of each
    group g of W columns, which needs L's row blocks below l: each is
    broadcast from its owner (`_row`) once in the group's forward sweep
    and once in its backward sweep; rank r then pulls back the (b, b)
    gram tiles of that column, and every rank's tile cotangents are
    all-gathered and summed in the one-device order (`_sum_tiles`), so
    the gradient has one device's bits at the same P.

The scalars zsq and logdet are replicated by construction; ok is
all-reduced (its minimum), so every rank takes the same jitter-retry
decision. Without a mesh every exchange is a slice, and the arithmetic is
the one-device walk's op for op; at W = 1 the mesh path runs the same ops
through the collectives.

Inputs are padded to n = P b with b a multiple of K3's 32-wide block, by
mask-0 identity rows (`infer/large_train.py:pad_observations`); the NLML
does not depend on the padding, since n_eff = sum(mask).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from medgp_tpu_torch.infer.map_train import TrainResult, train_one_patient
from medgp_tpu_torch.models.gp import PatientData, noise_variance
from medgp_tpu_torch.models.params import REF_PI, KernelSpec, LMCSMSpec
from medgp_tpu_torch.models.priors import PriorSpec, log_prior
from medgp_tpu_torch.ops import cuda_chol
from medgp_tpu_torch.ops.gram import cross_gram_lmcsm
from medgp_tpu_torch.utils import metrics
from medgp_tpu_torch.utils.hbm import device_bytes


# --------------------------------------------------------------------------
# the mesh and its collectives
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CohortMesh:
    """This process's place in the `torch.distributed` world."""

    group: object          # the process group (the default world)
    world: int
    rank: int
    device: torch.device   # this rank's device
    backend: str           # "nccl" or "gloo"


def cohort_mesh(device: torch.device | str = "cuda") -> CohortMesh:
    """The mesh of the initialized default process group, with this rank
    on `device` (parallel/launch.py:init_distributed or
    torch.distributed.init_process_group starts the group)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "cohort_mesh: no torch.distributed process group (start one with "
            "parallel/launch.py:init_distributed, or run under torchrun)"
        )
    group = dist.group.WORLD
    return CohortMesh(
        group=group, world=dist.get_world_size(group), rank=dist.get_rank(group),
        device=torch.device(device), backend=str(dist.get_backend(group)),
    )


def _staged(mesh: CohortMesh, x: torch.Tensor) -> bool:
    """A CUDA tensor on a gloo group travels through host memory."""
    return mesh.backend == "gloo" and x.is_cuda


def _wire(mesh: CohortMesh, x: torch.Tensor) -> torch.Tensor:
    """x as sent: on the host when staged, bool as uint8, contiguous."""
    x = x.to(torch.uint8) if x.dtype == torch.bool else x
    return (x.cpu() if _staged(mesh, x) else x).contiguous()


def _unwire(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(device=like.device, dtype=like.dtype)


def all_gather(mesh: CohortMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's x (the same shape on each), concatenated along dim 0 in
    rank order, on every rank (JAX: all_gather(tiled=True))."""
    src = _wire(mesh, x)
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    return _unwire(torch.cat(parts), x)


def broadcast(mesh: CohortMesh, x: Optional[torch.Tensor], src: int, shape=None,
              dtype=torch.float32) -> torch.Tensor:
    """Rank `src`'s x on every rank; the others pass None and the shape and
    dtype to receive into (JAX: the psum of a tensor that is zero but on
    one device)."""
    like = x if mesh.rank == src else torch.empty(shape, dtype=dtype, device=mesh.device)
    buf = _wire(mesh, like)
    dist.broadcast(buf, src, group=mesh.group)
    return x if mesh.rank == src else _unwire(buf, like)


def all_reduce(mesh: CohortMesh, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of every rank's x, on every rank (JAX: psum)."""
    buf = _wire(mesh, x).clone()
    dist.all_reduce(buf, op=op, group=mesh.group)
    return _unwire(buf, x)


def barrier(mesh: Optional[CohortMesh]) -> None:
    """Wait for every rank (no-op without a mesh); on a CUDA device the
    rank's stream is synchronized first."""
    if mesh is None:
        return
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    all_reduce(mesh, torch.zeros(1, device=mesh.device))


def gather_rows(mesh: CohortMesh, res):
    """A result of the local slice, every tensor field with a leading row
    axis all-gathered along it (nested NamedTuples too); scalars and host
    values stay the local ones."""
    if isinstance(res, torch.Tensor):
        return all_gather(mesh, res) if res.dim() else res
    if isinstance(res, tuple) and hasattr(res, "_fields"):
        return type(res)(*(gather_rows(mesh, x) for x in res))
    return res


def take_rows(res, B: int):
    """The first B rows of every tensor field with a leading row axis (the
    real patients of a padded batch), nested NamedTuples too."""
    if isinstance(res, torch.Tensor):
        return res[:B] if res.dim() else res
    if isinstance(res, tuple) and hasattr(res, "_fields"):
        return type(res)(*(take_rows(x, B) for x in res))
    return res


def local_rows(mesh: CohortMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous slice of the leading axis, whose size the
    world divides (JAX: PartitionSpec(axis))."""
    B = x.shape[0]
    if B % mesh.world:
        raise ValueError(f"a batch of {B} rows does not split over {mesh.world} ranks")
    m = B // mesh.world
    return x[mesh.rank * m:(mesh.rank + 1) * m]


def _split(mesh: CohortMesh, x):
    """`local_rows` of a tensor, field by field of a NamedTuple (the
    samplers' `Streams` too); any other argument passes as it is."""
    if isinstance(x, torch.Tensor):
        return local_rows(mesh, x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_split(mesh, v) for v in x))
    return x


def min_free_bytes(mesh: CohortMesh) -> int:
    """The least free device memory of any rank (`utils/hbm.py:
    device_bytes`), so that every rank plans the same buckets and row
    blocks from it: in the JAX package one process plans for every device.
    A collective: every rank calls it at the same point."""
    free = torch.tensor([device_bytes(mesh.device)], dtype=torch.int64, device=mesh.device)
    return int(all_reduce(mesh, free, dist.ReduceOp.MIN)[0])


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_batch_to(batch: PatientData, b_target: int) -> PatientData:
    """Pad the patient axis with all-masked dummies so it shards evenly."""
    pad = b_target - batch.t.shape[0]
    if pad == 0:
        return batch
    return PatientData(*(
        torch.cat([a, torch.zeros((pad,) + a.shape[1:], dtype=a.dtype, device=a.device)])
        for a in batch
    ))


# --------------------------------------------------------------------------
# sharded cohort steps
# --------------------------------------------------------------------------

def sharded(fn, mesh: CohortMesh, n_rep_args: int = 0):
    """`call(*args)`: the first `n_rep_args` arguments are replicated, the
    rest are split over the ranks along their leading axis, which the
    world divides (`_split`); each rank runs `fn` on its slices and every
    tensor field of the result is all-gathered (mesh.py:55-166 in the JAX
    package)."""

    def call(*args):
        rep, arr = args[:n_rep_args], args[n_rep_args:]
        return gather_rows(mesh, fn(*rep, *(_split(mesh, x) for x in arr)))

    return call


def sharded_train_step(
    spec: KernelSpec,
    mesh: CohortMesh,
    inits: torch.Tensor,
    prior_mode: int = 2,
    eta: float = 0.01,
    beta_lam: float = 0.01,
    top_iters: int = 2,
    sub_opt_iter: int = 10,
) -> Callable[[PatientData], TrainResult]:
    """`step(batch) -> TrainResult` of the whole batch: each rank trains
    its slice (`train_one_patient`, looked up when the step runs)."""
    return sharded(lambda batch: train_one_patient(
        spec, batch, inits, prior_mode=prior_mode, eta=eta, beta_lam=beta_lam,
        top_iters=top_iters, sub_opt_iter=sub_opt_iter), mesh)


def sharded_test_step(run_one, mesh: CohortMesh, n_rep_args: int = 0):
    """`fn(*rep_args, t, y, meta, mask, ut, uv)` of `run_one` (a partial of
    `online_impute`): the fold's mode theta and test prior replicated."""
    return sharded(run_one, mesh, n_rep_args)


def sharded_sampler_step(run_one, mesh: CohortMesh):
    """`fn(theta0, t, y, meta, mask, streams)` of `run_one` (a partial of a
    sampler): each rank samples its slice of the rows with its slice of
    the per-patient streams, as the JAX package splits per-row keys."""
    return sharded(run_one, mesh)


# --------------------------------------------------------------------------
# cross-patient population statistics
# --------------------------------------------------------------------------

def _masked_percentile(xs: torch.Tensor, flags: torch.Tensor, q: float) -> torch.Tensor:
    """Percentile q (linear interpolation, numpy's default) of the flagged
    entries of xs (..., B) along the last axis: masked entries sort to
    +inf, and the rank comes from the flagged count (mesh.py:173-186).
    xs and flags broadcast against each other."""
    xs, flags = torch.broadcast_tensors(xs, flags)
    B = xs.shape[-1]
    s = torch.sort(torch.where(flags > 0, xs, torch.full_like(xs, math.inf)), dim=-1).values
    n_ok = torch.sum(flags > 0, dim=-1)
    rank = (q / 100.0) * (n_ok.to(xs.dtype) - 1.0)
    lo = torch.clamp(torch.floor(rank).to(torch.int64), 0, B - 1)
    hi = torch.clamp(lo + 1, 0, B - 1)
    w = rank - lo.to(xs.dtype)
    x_lo = torch.gather(s, -1, lo[..., None])[..., 0]
    x_hi = torch.gather(s, -1, hi[..., None])[..., 0]
    x_hi = torch.where(hi < n_ok, x_hi, x_lo)  # the rank may land on the last entry
    return x_lo * (1.0 - w) + x_hi * w


def masked_weighted_kde_mode(xs: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Density-weighted KDE mode (Silverman bandwidth) of the flagged
    entries of xs (..., B) along the last axis (mesh.py:189-222; the
    reference's medgpc/clustering/mode_estimate.py:438-450): the first
    flagged entry where one is flagged, NaN where none is. xs and flags
    broadcast against each other."""
    xs, flags = torch.broadcast_tensors(xs, flags)
    dtype = xs.dtype
    f = (flags > 0).to(dtype)
    n_ok = torch.sum(f, dim=-1)
    n1 = torch.clamp(n_ok, min=1.0)
    mean = torch.sum(xs * f, dim=-1) / n1
    var = torch.sum(f * (xs - mean[..., None]) ** 2, dim=-1) / torch.clamp(n_ok - 1.0, min=1.0)
    std = torch.sqrt(var)
    iqr = (_masked_percentile(xs, flags, 75.0) - _masked_percentile(xs, flags, 25.0)) / 1.349
    sigma = torch.where(iqr > 0, torch.minimum(std, iqr), std)
    first = torch.argmax(f, dim=-1, keepdim=True)  # first flagged entry
    x_first = torch.gather(xs, -1, first)[..., 0]
    sigma = torch.where(sigma > 0, sigma, torch.clamp(torch.abs(x_first), min=1.0) * 1e-6)
    bw = 0.9 * sigma * n1 ** (-0.2)
    z = (xs[..., :, None] - xs[..., None, :]) / bw[..., None, None]
    dens = torch.sum(torch.exp(-0.5 * z * z) * f[..., None, :], dim=-1) / (
        n1 * bw * math.sqrt(2.0 * math.pi))[..., None]
    wsum = torch.sum(f * dens, dim=-1)
    mode = torch.where(wsum > 0, torch.sum(f * xs * dens, dim=-1) / wsum,
                       torch.sum(f * xs, dim=-1) / n1)
    mode = torch.where(n_ok == 1, x_first, mode)
    return torch.where(n_ok == 0, torch.full_like(mode, math.nan), mode)


def population_noise_mode(spec: LMCSMSpec, mesh: CohortMesh):
    """`fn(thetas, flags) -> (D,)` log noise modes over every rank's
    patients: thetas (b_local, H) and flags (b_local,) are this rank's
    slice; one all-gather assembles the population and every rank
    evaluates the masked KDE mode per output (mesh.py:225-263)."""
    D = spec.n_lik

    def fn(thetas, flags):
        noise = all_gather(mesh, torch.exp(thetas[:, :D].to(torch.float32)))
        fl = all_gather(mesh, flags.to(torch.float32))
        return torch.log(masked_weighted_kde_mode(noise.T, fl[None, :]))

    return fn


def population_noise_modes_by_fold(spec: LMCSMSpec, mesh: CohortMesh, n_folds: int):
    """`fn(thetas, flags, cv) -> (n_folds + 1, D)` log noise modes: row f
    keeps the flagged patients with cv != f, the last row (fold -1) all of
    them. The inputs are this rank's slice; one all-gather of (noise,
    flag, cv) rows serves every fold (mesh.py:266-315). In float32: the
    host path (cluster/mode.py) runs in float64, and the two agree within
    ~2e-3 relative."""
    D = spec.n_lik

    def fn(thetas, flags, cv):
        rows = torch.cat([
            torch.exp(thetas[:, :D].to(torch.float32)),
            flags.to(torch.float32)[:, None], cv.to(torch.float32)[:, None],
        ], dim=1)
        rows = all_gather(mesh, rows)
        noise, fl, cv_all = rows[:, :D].T, rows[:, D], rows[:, D + 1].to(torch.int32)
        folds = torch.arange(n_folds + 1, dtype=torch.int32, device=rows.device)
        keep = torch.where((folds < n_folds)[:, None], cv_all[None, :] != folds[:, None],
                           torch.ones_like(cv_all[None, :], dtype=torch.bool))
        flags_f = fl[None, :] * keep.to(torch.float32)                   # (F+1, B)
        return torch.log(masked_weighted_kde_mode(noise[None], flags_f[:, None, :]))

    return fn


# --------------------------------------------------------------------------
# the large patient: block layout and exchange
# --------------------------------------------------------------------------

Rows = List[Optional[torch.Tensor]]  # row block l: (b, (l + 1) b), None where not held


def block_width(n: int, blocks: int, mesh: Optional[CohortMesh] = None) -> int:
    """b for n = `blocks` b padded rows; raises unless b is a multiple of
    K3's block (`cuda_chol.BLOCK`) and the world divides the blocks."""
    b, rem = divmod(n, blocks)
    if rem or b % cuda_chol.BLOCK:
        raise ValueError(
            f"large patient: n = {n} is not {blocks} blocks of a multiple of "
            f"{cuda_chol.BLOCK} rows (pad with infer/large_train.py:pad_observations)"
        )
    if mesh is not None and blocks % mesh.world:
        raise ValueError(f"large patient: {blocks} row blocks over {mesh.world} ranks")
    return b


def _owner(mesh: Optional[CohortMesh], l: int) -> int:
    return 0 if mesh is None else l % mesh.world


def _owns(mesh: Optional[CohortMesh], l: int) -> bool:
    return mesh is None or l % mesh.world == mesh.rank


def _gather_column(rows: Rows, k: int, b: int, first: int, mesh) -> torch.Tensor:
    """Block column k of row blocks first..P-1, stacked: ((P - first) b, b).
    Over a mesh each rank sends its own blocks of the range (padded to the
    same count) and the gathered pieces are put back in block order."""
    P = len(rows)
    if mesh is None:
        return torch.cat([r[:, k * b:(k + 1) * b] for r in rows[first:]])
    W = mesh.world
    m = -(-(P - first) // W)
    mine = [rows[i][:, k * b:(k + 1) * b] for i in range(first, P) if _owns(mesh, i)]
    mine += [_held(rows).new_zeros((b, b))] * (m - len(mine))
    got = all_gather(mesh, torch.cat(mine)).reshape(W, m, b, b)
    # rank (first + q) % W holds blocks first + q + j W, j = 0, 1, ...
    got = got[[(first + q) % W for q in range(W)]].transpose(0, 1)
    return got.reshape(m * W * b, b)[:(P - first) * b]


def _set_column(rows: Rows, k: int, b: int, first: int, col: torch.Tensor) -> None:
    """Write a stacked block column back into the held row blocks of
    first..P-1."""
    for i in range(first, len(rows)):
        if rows[i] is not None:
            rows[i][:, k * b:(k + 1) * b] = col[(i - first) * b:(i - first + 1) * b]


def _row(rows: Rows, k: int, c0: int, c1: int, mesh) -> torch.Tensor:
    """Columns c0:c1 of row block k of L, broadcast from its owner (JAX:
    the psum broadcast of a row block); the owner uses its own view."""
    part = rows[k][:, c0:c1] if rows[k] is not None else None
    if mesh is None:
        return part
    held = _held(rows)
    return broadcast(mesh, part, _owner(mesh, k), shape=(held.shape[0], c1 - c0),
                     dtype=held.dtype)


def _held(rows: Rows) -> torch.Tensor:
    """A row block this rank holds (each rank holds at least one)."""
    return next(r for r in rows if r is not None)


def _tile_counts(P: int, W: int) -> List[int]:
    """Gram tiles of each rank's block columns in the backward: rank r's
    columns are l = r, r + W, ..., each with the P - l tiles of rows
    l..P-1."""
    return [sum(P - l for l in range(r, P, W)) for r in range(W)]


def _sum_tiles(tiles, like, P: int, mesh) -> List[torch.Tensor]:
    """Every rank's tile cotangents summed in the one-device order: column
    l = 0..P-1, its tiles from row block l down, each added to a running
    sum from zero. `tiles` holds this rank's, in its own order, one list
    (a cotangent per input in `like`) per tile. Each rank's are
    all-gathered (padded to the largest count), so every rank gets one
    device's bits (JAX: psum, in the collective's order)."""
    W = mesh.world
    counts = _tile_counts(P, W)
    m = counts[0]
    out = []
    for j, x in enumerate(like):
        mine = [t[j].reshape(-1) for t in tiles]
        mine += [x.new_zeros(x.numel())] * (m - len(mine))
        got = all_gather(mesh, torch.stack(mine)).reshape(W, m, -1)
        acc, pos = torch.zeros_like(x), [0] * W
        for l in range(P):
            r = l % W
            for _ in range(P - l):
                acc = acc + got[r, pos[r]].reshape(x.shape)
                pos[r] += 1
        out.append(acc)
    return out


# --- the factorization ----------------------------------------------------

def _gram_rows(spec: LMCSMSpec, nat, theta, mult, t, meta, mask, b, mesh) -> Rows:
    """The held row blocks of the lower block triangle of K + mult
    diag(noise) + diag(1 - mask), masked (mesh.py:360-374, 707-719 in the
    JAX package); None for the blocks another rank holds."""
    P = t.shape[0] // b
    rows: Rows = []
    for l in range(P):
        if not _owns(mesh, l):
            rows.append(None)
            continue
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
    rows: Rows            # row block l of L: (b, (l + 1) b), None where not held
    linv: torch.Tensor    # (P, b, b) L_kk^{-1}, replicated
    z: torch.Tensor       # (n,) L^{-1} (y * mask), replicated
    zsq: torch.Tensor     # () ||z||^2
    logdet: torch.Tensor  # () sum log diag(L)


def _diag_block(rows: Rows, k: int, b: int, mesh):
    """(L_kk^{-1}, log diag(L_kk)) of diagonal block k: its owner factors
    A_kk by K3, inverts L_kk by K5 and writes L_kk into its row block; over
    a mesh it broadcasts the two."""
    lo, hi = k * b, (k + 1) * b
    linv_k = log_diag = None
    if rows[k] is not None:
        zeros = rows[k].new_zeros((1, b))
        L, _, linvd = cuda_chol.chol_solve(rows[k][:, lo:hi].contiguous()[None], zeros, zeros)
        linv_k = cuda_chol.tri_inv(L, linvd)[0]
        rows[k][:, lo:hi] = L[0]
        log_diag = torch.log(torch.diagonal(L[0]))
    if mesh is None:
        return linv_k, log_diag
    both = None if linv_k is None else torch.cat([linv_k, log_diag[None]])
    both = broadcast(mesh, both, _owner(mesh, k), shape=(b + 1, b), dtype=_held(rows).dtype)
    return both[:b], both[b]


def _factorize(rows: Rows, y: torch.Tensor, b: int, mesh=None) -> Factor:
    """Right-looking blocked Cholesky with the forward substitution fused,
    in place over the held `rows` (mesh.py:724-758 in the JAX package):
    for each k, K3 factors A_kk and K5 inverts L_kk, the panel is
    S = C L_kk^{-T}, the trailing rows lose S_i S_j^T, and z_k =
    L_kk^{-1} y_k. Only the nonzero ranges are multiplied. A failed block
    (K3's NaN pivot) makes zsq and logdet NaN; nothing is read back here."""
    P = len(rows)
    dtype, dev = y.dtype, y.device
    linv = torch.empty((P, b, b), dtype=dtype, device=dev)
    yres = y.clone()
    z = torch.empty_like(y)
    zsq = torch.zeros((), dtype=dtype, device=dev)
    logdet = torch.zeros((), dtype=dtype, device=dev)
    for k in range(P):
        lo, hi = k * b, (k + 1) * b
        linv[k], log_diag = _diag_block(rows, k, b, mesh)
        zk = linv[k] @ yres[lo:hi]
        z[lo:hi] = zk
        zsq = zsq + torch.sum(zk * zk)
        logdet = logdet + torch.sum(log_diag)
        if k + 1 == P:
            break
        S = _gather_column(rows, k, b, k + 1, mesh) @ linv[k].T
        _set_column(rows, k, b, k + 1, S)
        yres[hi:] -= S @ zk
        for i in range(k + 1, P):
            if rows[i] is None:
                continue
            Si = S[(i - k - 1) * b:(i - k) * b]
            rows[i][:, hi:(i + 1) * b].addmm_(Si, S[:(i - k) * b].T, alpha=-1.0)
    return Factor(rows, linv, z, zsq, logdet)


def _factor_with_retry(spec, theta, t, y, meta, mask, b, max_retries, mesh=None):
    """The jitter retry over the whole factorization, mult = 1 ..
    1 + max_retries (mesh.py:764-777): one host read of ok per attempt,
    over a mesh the minimum of every rank's. Returns (mult, Factor, ok).
    The span `medgp.large.factor`; every attempt counts one
    `large.factorizations`, every attempt after the first one
    `large.retry_factorizations`."""
    with metrics.span("medgp.large.factor"):
        nat = _natural(spec, theta)
        y = y * mask
        fac = None
        for mult in range(1, max_retries + 2):
            fac = None  # the last attempt's rows are freed before the next
            metrics.count("large.factorizations")
            if mult > 1:
                metrics.count("large.retry_factorizations")
            fac = _factorize(_gram_rows(spec, nat, theta, mult, t, meta, mask, b, mesh),
                             y, b, mesh)
            ok = torch.isfinite(fac.zsq) & torch.isfinite(fac.logdet)
            if mesh is not None:
                ok = all_reduce(mesh, ok.to(torch.float32).reshape(1), dist.ReduceOp.MIN)[0] > 0
            ok = bool(ok)
            if ok:
                break
        return mult, fac, ok


def _nlml(fac: Factor, mask: torch.Tensor, ok: bool) -> torch.Tensor:
    dtype = mask.dtype
    if not ok:
        return torch.tensor(math.inf, dtype=dtype, device=mask.device)
    n_eff = torch.sum(mask)
    return 0.5 * fac.zsq + fac.logdet + 0.5 * n_eff * math.log(2.0 * REF_PI)


def _back_substitute(fac: Factor, b: int, mesh=None) -> torch.Tensor:
    """alpha = L^{-T} z by blocks, k = P-1 .. 0 (mesh.py:462-477),
    replicated: the owner of row block k broadcasts L_k^T alpha_k."""
    P = len(fac.rows)
    r = fac.z.clone()
    for k in range(P - 1, -1, -1):
        lo, hi = k * b, (k + 1) * b
        ak = fac.linv[k].T @ r[lo:hi]
        r[lo:hi] = ak
        if k:
            upd = fac.rows[k][:, :lo].T @ ak if fac.rows[k] is not None else None
            if mesh is not None:
                upd = broadcast(mesh, upd, _owner(mesh, k), shape=(lo,), dtype=r.dtype)
            r[:lo] -= upd
    return r


def _inverse_column(fac: Factor, l: int, g: int, b: int, mesh=None) -> torch.Tensor:
    """Block column l of K^{-1} from block row l down: ((P - l) b, b).

    L W = E_l by forward substitution over blocks l..P-1 (W is zero above
    block l, and W_l = L_ll^{-1}), then L^T Z = W by backward substitution
    from block P-1 up to block l, in place over W (mesh.py:501-532, which
    solves for every block of the column). The ranks of one group of
    columns g..g+W-1 (l = g + rank; g = l without a mesh) walk the row
    blocks below g together: each sweep broadcasts each of them once."""
    P = len(fac.rows)
    W = torch.empty(((P - l) * b, b), dtype=fac.linv.dtype, device=fac.linv.device)
    W[:b] = fac.linv[l]
    for k in range(g + 1, P):
        Lk = _row(fac.rows, k, g * b, k * b, mesh)
        if k > l:
            i = k - l
            W[i * b:(i + 1) * b] = -(fac.linv[k] @ (Lk[:, (l - g) * b:] @ W[:i * b]))
    for k in range(P - 1, g, -1):
        Lk = _row(fac.rows, k, g * b, k * b, mesh)
        if k >= l:
            i = k - l
            Zk = fac.linv[k].T @ W[i * b:(i + 1) * b]
            W[i * b:(i + 1) * b] = Zk
            if i:
                W[:i * b].addmm_(Lk[:, (l - g) * b:].T, Zk, alpha=-1.0)
    if l == g:
        W[:b] = fac.linv[l].T @ W[:b]
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
    multiplier, the held row blocks of L, every L_kk^{-1} and alpha (by
    blocked back substitution).

    Backward: the Q-matrix identity dNLML/dK = 1/2 (K^{-1} - alpha alpha^T)
    (c_inference_exact.cpp:168-172), one block column l at a time (over a
    mesh, column g + rank of each group g of W columns): K^{-1}'s block
    column l from block row l down (`_inverse_column`), then
    Qbar = gbar/2 (Z - alpha alpha_l^T) on those rows, counted twice below
    the diagonal block (K and Qbar are symmetric, so the lower block
    triangle carries the whole sum), masked; then one `torch.autograd.grad`
    per (b, b) tile of those rows of the gram (`cross_gram_lmcsm`), and of
    the diagonal block's noise at the forward's multiplier, on the rank
    that formed the column. Only one tile's graph is alive at a time, so
    autograd keeps O(Q b^2) values, not O(Q n b). Over a mesh the tiles'
    theta and t cotangents are summed in one rank's order (`_sum_tiles`).

    Flops of the backward, n = P b: the solves of block column l take
    about 2 (P - l)^2 b^3 (forward and backward substitution, each
    restricted to blocks >= l), which sums to 2/3 n^3 + O(n^2 b) over l,
    against n^3/3 for the forward; the gram's backward is O(Q n^2 / 2).
    Over W ranks each forms P / W columns.
    """

    @staticmethod
    def forward(ctx, theta, t, y, meta, mask, spec, b, max_retries, mesh):
        mult, fac, ok = _factor_with_retry(spec, theta, t, y, meta, mask, b, max_retries, mesh)
        nlml = _nlml(fac, mask, ok)
        ctx.spec, ctx.b, ctx.mult, ctx.ok, ctx.mesh = spec, b, mult, ok, mesh
        if ok:
            ctx.fac = fac
            ctx.alpha = _back_substitute(fac, b, mesh)
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
        none = (None,) * 4
        if not ctx.ok or gbar is None:
            return (th_bar, t_bar, y_bar, None, mask_bar) + none
        spec, b, fac, alpha, mesh = ctx.spec, ctx.b, ctx.fac, ctx.alpha, ctx.mesh
        if need_y:
            y_bar = gbar * alpha * mask
        if need_th or need_t:
            P = len(fac.rows)
            world, rank = (1, 0) if mesh is None else (mesh.world, mesh.rank)
            with torch.enable_grad():
                th = theta.detach().requires_grad_(need_th)
                tt = t.detach().requires_grad_(need_t)
                wrt = [x for x, need in ((th, need_th), (tt, need_t)) if need]
                acc = [torch.zeros_like(x) for x in wrt]
                tiles = []  # over a mesh, this rank's tile cotangents
                for g in range(0, P, world):
                    l = g + rank
                    lo, hi = l * b, (l + 1) * b
                    # Qbar's block column l, in place over K^{-1}'s
                    Qbar = _inverse_column(fac, l, g, b, mesh)
                    Qbar.addr_(alpha[lo:], alpha[lo:hi], alpha=-1.0)
                    Qbar.mul_(0.5 * gbar)
                    Qbar[b:] *= 2.0
                    Qbar.mul_(mask[lo:, None]).mul_(mask[None, lo:hi])
                    for i in range(P - l):
                        grads = _gram_tile_vjp(spec, th, tt, meta, wrt, Qbar[i * b:(i + 1) * b],
                                               l + i, l, b, ctx.mult if i == 0 else None)
                        if mesh is None:
                            acc = [a if g_ is None else a + g_ for a, g_ in zip(acc, grads)]
                        else:  # a tile with no path to an input adds zeros
                            tiles.append([torch.zeros_like(x) if g_ is None else g_
                                          for x, g_ in zip(wrt, grads)])
                    del Qbar
            if mesh is not None:
                acc = _sum_tiles(tiles, acc, P, mesh)
            if need_th:
                th_bar = acc.pop(0)
            if need_t:
                t_bar = acc.pop(0)
        return (th_bar, t_bar, y_bar, None, mask_bar) + none


def large_patient_nlml(spec: LMCSMSpec, blocks: int, max_retries: int = 10,
                       mesh: Optional[CohortMesh] = None):
    """Value-only NLML of one padded patient over `blocks` row blocks:
    `call(theta (H,), t, y, meta, mask) -> (nlml (), ok () bool)`, +inf
    where every jitter multiplier failed (mesh.py:644-794); every rank of
    `mesh` passes the whole patient and holds its own row blocks."""

    def call(theta, t, y, meta, mask):
        mask = mask.to(t.dtype)
        b = block_width(t.shape[0], blocks, mesh)
        with torch.no_grad():
            _, fac, ok = _factor_with_retry(spec, theta, t, y, meta, mask, b, max_retries, mesh)
            nlml = _nlml(fac, mask, ok)
        return nlml, torch.tensor(ok, device=t.device)

    return call


def large_patient_nlml_diff(spec: LMCSMSpec, blocks: int, max_retries: int = 10,
                            mesh: Optional[CohortMesh] = None):
    """`call(theta (H,), t, y, meta, mask) -> (nlml (), ok ())`,
    differentiable in theta, t and y through `LargeNLML` (mesh.py:318)."""

    def call(theta, t, y, meta, mask):
        mask = mask.to(t.dtype)
        b = block_width(t.shape[0], blocks, mesh)
        return LargeNLML.apply(theta, t, y, meta, mask, spec, b, max_retries, mesh)

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
    mesh: Optional[CohortMesh] = None,
):
    """`f(theta (1, H), idx=None) -> (value (1,), grad (1, H), ok (1,))`
    over one padded patient (mesh.py:601-641), the batched signature of
    `models/gp.py:objective_and_grad` with k = 1, for `scg_minimize` and
    `varem_train(objective_factory=...)`. value = NLML - log prior; the
    gradient is multiplied by the prior's grad_mask; ok also needs
    sum(mask) > 2 and a finite gradient, and a failed evaluation reads
    +inf with a zero gradient. `base` reuses a `large_patient_nlml_diff`
    callable. Over a mesh every rank gets the same value and gradient.
    Each call is the span `medgp.large.objective`, its blocked gradient
    the span `medgp.large.backward`, and counts one `large.evaluations`."""
    if base is None:
        base = large_patient_nlml_diff(spec, blocks, max_retries, mesh)
    enough = bool(torch.sum(mask) > 2)

    def f(theta, idx=None):
        metrics.count("large.evaluations")
        with metrics.span("medgp.large.objective"):
            with torch.enable_grad():
                th = theta.detach().requires_grad_()
                v, ok = base(th[0], t, y, meta, mask)
                v = v.reshape(1)
                if prior is not None:
                    v = v - log_prior(prior, th).reshape(1)
                if bool(ok):
                    with metrics.span("medgp.large.backward"):
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


def large_patient_screen(spec: LMCSMSpec, blocks: int, max_retries: int = 10,
                         mesh: Optional[CohortMesh] = None):
    """`screen(thetas (S, H), t, y, meta, mask) -> (values (S,), oks (S,))`:
    S value-only evaluations, one after another, so only one
    factorization's workspace is live at a time (mesh.py:797-824); failed
    ones read +inf. Each call is the span `medgp.large.screen` and counts
    S `large.screen_values`."""
    base = large_patient_nlml(spec, blocks, max_retries, mesh)

    def screen(thetas, t, y, meta, mask):
        metrics.count("large.screen_values", thetas.shape[0])
        with metrics.span("medgp.large.screen"):
            vals, oks = zip(*(base(th, t, y, meta, mask) for th in thetas))
            vals, oks = torch.stack(vals), torch.stack(oks)
            vals = torch.where(oks & torch.isfinite(vals), vals, torch.full_like(vals, math.inf))
            return vals, oks

    return screen
