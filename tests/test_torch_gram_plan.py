"""K1's launch plan and tile walk (medgp_tpu_torch/csrc/gram.cuh), on the CPU.

`cuda_gram.gram_plan(batch, n) -> (tile, items_per_cta, ctas)` is the only
source of K1's launch geometry: each CTA walks a contiguous run of
items_per_cta lower-triangle 64x64 tile pairs of one matrix, row-major over
(I, J) with I >= J, and the C entry refuses a plan with
ctas != batch * ceil(pairs / items_per_cta). These tests hold the plan to
that contract, walk the CTAs with the kernel's own index arithmetic, and
hold a plain-torch mirror of the kernel's tile walk (lower tiles by the
rank-2 identity on the shifted t, mirrored into the upper triangle) against
the Pallas gram kernel in interpret mode and the XLA gram + mask_gram of
the JAX package. The mirror lives here only: the port's CPU path is the
plain twin, and the CUDA kernel is compared with the twin on the card by
chip_smoke.py.

Tolerance rtol 1e-4, atol 1e-5, as tests/test_torch_gram.py states: the
Pallas kernel's own bound against the XLA gram; both sides are float32
with the phase 2 pi mu |t_i - t_j| rounded in a different order.
"""

import math
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from medgp_tpu.models import params as jparams  # noqa: E402
from medgp_tpu.ops import pallas_gram  # noqa: E402
from medgp_tpu.ops.gram import gram_lmcsm as jax_gram_lmcsm  # noqa: E402
from medgp_tpu.ops.nlml import mask_gram as jax_mask_gram  # noqa: E402
from medgp_tpu_torch.models.params import REF_PI  # noqa: E402
from medgp_tpu_torch.ops import cuda_gram  # noqa: E402

BATCHES = (0, 1, 6, 29, 32, 128, 464, 5000)
ORDERS = (128, 200, 256, 512, 2048)
TWO_WAVES = 2 * cuda_gram.GRAM_SMS * cuda_gram.GRAM_CTAS_PER_SM
PLAN_TARGET = cuda_gram.GRAM_WAVES * cuda_gram.GRAM_SMS * cuda_gram.GRAM_CTAS_PER_SM


def _pairs(n):
    T = math.ceil(n / cuda_gram.GRAM_TILE)
    return T * (T + 1) // 2


@pytest.mark.parametrize("n", ORDERS)
@pytest.mark.parametrize("batch", BATCHES)
def test_gram_plan_invariants(batch, n):
    tile, per, ctas = cuda_gram.gram_plan(batch, n)
    pairs = _pairs(n)
    assert tile == cuda_gram.GRAM_TILE == 64
    if batch == 0:
        assert ctas == 0
        return
    assert 1 <= per <= pairs
    runs = -(-pairs // per)
    # the C entry's consistency check, and every tile pair in exactly one
    # run: the runs of a matrix tile [0, pairs) with none empty
    assert ctas == batch * runs
    assert (runs - 1) * per < pairs <= runs * per
    if batch * pairs >= TWO_WAVES:
        assert ctas >= TWO_WAVES  # at least two waves of CTAs
    if batch * pairs < PLAN_TARGET:
        assert per == 1 and ctas == batch * pairs  # small batch: one item a CTA


def _walk(batch, n, per, ctas):
    """The kernel's CTA -> (matrix, I, J) walk (gram_lmcsm_kernel): first
    item from the float square root, corrected, then J += 1, wrapping to
    the next row of tiles."""
    pairs = _pairs(n)
    runs = -(-pairs // per)
    seen = []
    for cta in range(ctas):
        b = cta // runs
        k0 = (cta - b * runs) * per
        k1 = min(k0 + per, pairs)
        I = int((np.sqrt(np.float32(8.0 * k0 + 1.0), dtype=np.float32) - 1.0) * 0.5)
        while I > 0 and I * (I + 1) // 2 > k0:
            I -= 1
        while (I + 1) * (I + 2) // 2 <= k0:
            I += 1
        J = k0 - I * (I + 1) // 2
        for _ in range(k0, k1):
            seen.append((b, I, J))
            J += 1
            if J > I:
                I, J = I + 1, 0
    return seen


@pytest.mark.parametrize("batch,n", [
    (1, 512), (6, 128), (29, 512), (32, 200), (464, 512), (2, 2048), (6, 2048),
    (128, 2048), (5000, 128),
])
def test_plan_walk_covers_every_lower_tile_pair_once(batch, n):
    _, per, ctas = cuda_gram.gram_plan(batch, n)
    seen = _walk(batch, n, per, ctas)
    T = math.ceil(n / 64)
    want = {(b, I, J) for b in range(batch) for I in range(T) for J in range(I + 1)}
    assert len(seen) == len(want) and set(seen) == want


def mirror_gram(t, meta, B, mu, v, mask=None, tile=64):
    """Plain-torch mirror of K1's tile walk: t shifted by min(t) over the
    row (padding included), each lower tile pair (I >= J) from the
    per-point cos and sin of 2 pi mu_q t (rank-2 identity), components in
    ascending order, the mask_gram epilogue, then the tile written to its
    place and transposed into (J, I); a diagonal tile's upper half is its
    lower half transposed."""
    Bt, n = t.shape
    Q = B.shape[1]
    ts = t - t.min(dim=1, keepdim=True).values
    rows = torch.arange(Bt)[:, None, None]
    K = torch.empty((Bt, n, n), dtype=t.dtype)
    T = math.ceil(n / tile)
    for I in range(T):
        r = slice(I * tile, min(n, (I + 1) * tile))
        for J in range(I + 1):
            c = slice(J * tile, min(n, (J + 1) * tile))
            ti, tj = ts[:, r], ts[:, c]
            d = ti[:, :, None] - tj[:, None, :]
            rsq = d * d
            acc = torch.zeros_like(rsq)
            for q in range(Q):
                ph_i = (2.0 * REF_PI) * mu[:, q, None] * ti
                ph_j = (2.0 * REF_PI) * mu[:, q, None] * tj
                cc = (torch.cos(ph_i)[:, :, None] * torch.cos(ph_j)[:, None, :]
                      + torch.sin(ph_i)[:, :, None] * torch.sin(ph_j)[:, None, :])
                coef = B[:, q][rows, meta[:, r].long()[:, :, None],
                               meta[:, c].long()[:, None, :]]
                e = -2.0 * (REF_PI * v[:, q, None, None]) ** 2
                acc = acc + coef * (cc * torch.exp(e * rsq))
            if mask is not None:
                mi, mj = mask[:, r], mask[:, c]
                gi = torch.arange(r.start, r.stop)[:, None]
                gj = torch.arange(c.start, c.stop)[None, :]
                acc = acc * (mi[:, :, None] * mj[:, None, :]) + torch.where(
                    gi == gj, 1.0 - mi[:, :, None], torch.zeros(()))
            if I == J:
                acc = torch.tril(acc) + torch.tril(acc, -1).mT
            K[:, r, c] = acc
            K[:, c, r] = acc.mT
    return K


Q, D, R, BATCH = 2, 3, 1, 3


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 168, size=(BATCH, n)), axis=1).astype(np.float32)
    meta = rng.integers(0, D, size=(BATCH, n)).astype(np.int32)
    mask = np.ones((BATCH, n), np.float32)
    mask[0, n - n // 5:] = 0.0
    mask[2, n // 2:] = 0.0
    t[mask == 0] = 0.0
    meta[mask == 0] = 0
    A = (rng.normal(size=(Q, D, R)) * 0.4).astype(np.float32)
    mu = (1.0 / rng.uniform(12, 72, size=Q)).astype(np.float32)
    v = (1.0 / (2 * np.pi * rng.uniform(6, 72, size=Q))).astype(np.float32)
    kappa = rng.uniform(0.01, 0.05, size=(Q, D)).astype(np.float32)
    return t, meta, mask, A, mu, v, kappa


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("n", [128, 200, 256])
def test_mirror_tile_walk_matches_pallas_and_xla(n, masked):
    t, meta, mask, A, mu, v, kappa = _inputs(21 + n, n)
    spec = jparams.LMCSMSpec(Q, D, R)
    B = np.asarray(spec.coregional_B(jnp.asarray(A), jnp.asarray(kappa)))
    Bb = np.broadcast_to(B, (BATCH, Q, D, D))
    mub, vb = np.broadcast_to(mu, (BATCH, Q)), np.broadcast_to(v, (BATCH, Q))
    got = mirror_gram(
        torch.as_tensor(t), torch.as_tensor(meta), torch.as_tensor(Bb.copy()),
        torch.as_tensor(mub.copy()), torch.as_tensor(vb.copy()),
        torch.as_tensor(mask) if masked else None,
    ).numpy()
    assert np.array_equal(got, got.transpose(0, 2, 1))

    pallas = np.asarray(pallas_gram._gram_fwd_batched(
        jnp.asarray(t), jnp.asarray(meta), jnp.asarray(Bb), jnp.asarray(mub),
        jnp.asarray(vb), jnp.asarray(mask) if masked else None,
    ))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-5)

    hyp = [jnp.asarray(x) for x in (A, mu, v, kappa)]

    def one(tb, mb, kb):
        K = jax_gram_lmcsm(spec, tb, mb, *hyp)
        return jax_mask_gram(K, kb) if masked else K

    xla = np.asarray(jax.vmap(one)(t, meta, mask))
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-5)


def _c_fwd_smem_bytes(Q, D):
    """gram.cuh's gram_fwd_smem_floats in bytes, evaluated from the
    header's own constants and return expression -> (kFwdTile, bytes)."""
    src = (pathlib.Path(cuda_gram.__file__).parents[1] / "csrc" / "gram.cuh").read_text()
    tile = int(re.search(r"constexpr int kFwdTile = (\d+);", src).group(1))
    stage = re.search(r"constexpr int kFwdStage = ([^;]+);", src).group(1)
    expr = re.search(r"gram_fwd_smem_floats\(int Q, int D\) \{\s*return ([^;]+);",
                     src).group(1)
    env = {"kFwdTile": tile, "Q": Q, "D": D}
    env["kFwdStage"] = eval(stage, {}, env)
    return tile, 4 * eval(expr, {}, env)


@pytest.mark.parametrize("D", [24, 48, 64])
def test_fwd_shared_memory_fits_a_block(D):
    """The wrapper's size of K1's dynamic shared memory at Q = 5 is the one
    the C entry reserves (gram.cuh gram_fwd_smem_floats), and fits the
    bytes the wrapper allows up to D = 64 (chip_smoke.py runs D = 48 and 64
    on the card)."""
    tile, nbytes = _c_fwd_smem_bytes(5, D)
    assert cuda_gram.GRAM_TILE == tile
    assert cuda_gram.fwd_smem_bytes(5, D) == nbytes
    assert cuda_gram.fwd_smem_bytes(5, D) <= cuda_gram.SMEM_BYTES
