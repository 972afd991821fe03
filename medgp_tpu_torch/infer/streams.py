"""Counter-based random streams for the samplers, one per (patient, chain).

The JAX package gives every row of a sampler bucket its own key
(medgp_tpu/parallel/runner.py:530-531) and splits it per chain, per
transition and per tree step, so a patient's draws do not depend on the
device that runs it or on its batch mates. Here every draw is a pure
function of five integers, evaluated by Philox4x32-10 (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011):

  * key word 0: the seed (its low 32 bits);
  * key word 1: the patient's key, its index in the cohort's `cfg.pans()`
    order (PAD_KEY for a padding row);
  * counter word 0: the element, a column within the draw;
  * counter word 1: the step, a transition (HMC, NUTS) or an ADVI step;
  * counter word 2: the chain;
  * counter word 3: the slot, one per purpose (the constants below).

A draw at a position is the same whenever and wherever it is evaluated, so
a row that has finished its NUTS tree and skips a draw leaves its stream
where it was. uint32 words are held in int64 tensors; a 32 x 32-bit
product is split into 16-bit halves of one factor, so nothing overflows
int64, and the integer bits are the same on the CPU and on the card.
Uniforms take the top 24 bits of a word; normals come from two uniforms by
Box-Muller.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import torch

MASK32 = 0xFFFFFFFF
PAD_KEY = MASK32  # a padding row's key: no cohort index reaches it

# Philox4x32 multipliers and Weyl key increments (Random123)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10

# slots: one per purpose of a draw within a step
START = 0          # a chain's start jitter
HMC_MOMENTUM = 1
HMC_STEPS = 2      # the jittered leapfrog count
HMC_ACCEPT = 3
NUTS_MOMENTUM = 4
NUTS_DIRECTION = 5  # per doubling
NUTS_SUBTREE = 6    # per leaf of the tree (multinomial sampling)
NUTS_ACCEPT = 7     # per doubling (biased progressive sampling)
VI_EPS = 8          # the step's Monte Carlo draws
VI_DRAWS = 9        # the final draws from q


class Streams(NamedTuple):
    """The random streams of k sampler rows: row i draws from (seed,
    key[i], chain[i]). `key` and `chain` are (k,) int64 on the rows'
    device; a NamedTuple of tensors, so `parallel/mesh.py` splits it over
    ranks with the rows."""
    seed: int
    key: torch.Tensor
    chain: torch.Tensor


def patient_streams(seed: int, keys, device=None) -> Streams:
    """One stream per patient (chain 0): `keys` are the patients' cohort
    indices (or PAD_KEY)."""
    key = torch.as_tensor(keys, dtype=torch.int64, device=device)
    return Streams(int(seed), key, torch.zeros_like(key))


def with_chains(s: Streams, num_chains: int) -> Streams:
    """Each patient's stream repeated for `num_chains` chains, in the
    (patient, chain) row order of the samplers' batches."""
    chain = torch.arange(num_chains, dtype=torch.int64, device=s.key.device)
    return Streams(
        s.seed, s.key.repeat_interleave(num_chains), chain.repeat(s.key.shape[0])
    )


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product of the constant m and
    the uint32 words x, with every partial product below 2^49."""
    lo16, hi16 = m & 0xFFFF, m >> 16
    t1 = x * lo16
    t2 = x * hi16
    mid = t1 + ((t2 & 0xFFFF) << 16)
    return (t2 >> 16) + (mid >> 32), mid & MASK32


def philox(c0, c1, c2, c3, k0, k1) -> List[torch.Tensor]:
    """Philox4x32-10 of the counter (c0, c1, c2, c3) under the key
    (k0, k1): uint32 words in int64 tensors (or Python ints) that
    broadcast together. Returns the four output words."""
    c = [torch.as_tensor(x, dtype=torch.int64) for x in (c0, c1, c2, c3)]
    k0, k1 = (torch.as_tensor(x, dtype=torch.int64) for x in (k0, k1))
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + _W0) & MASK32
            k1 = (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(_M0, c[0])
        hi1, lo1 = _mulhilo(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def words(s: Streams, step: int, blocks: Sequence[Tuple[int, int]]):
    """The first two output words of every position (element j, `step`,
    the row's chain, slot) for each (slot, n) of `blocks`, j < n, from one
    Philox evaluation over all of them: a list of ((k, n), (k, n)) int64
    pairs, in the order of `blocks`."""
    dev = s.key.device
    elem = torch.cat([torch.arange(n, dtype=torch.int64, device=dev) for _, n in blocks])
    slot = torch.cat([torch.full((n,), sl, dtype=torch.int64, device=dev) for sl, n in blocks])
    w = philox(elem[None, :], int(step) & MASK32, s.chain[:, None], slot[None, :],
               s.seed & MASK32, s.key[:, None])
    w0, w1 = (torch.broadcast_to(x, (s.key.shape[0], elem.shape[0])) for x in w[:2])
    out, at = [], 0
    for _, n in blocks:
        out.append((w0[:, at:at + n], w1[:, at:at + n]))
        at += n
    return out


def uniform(w: torch.Tensor, dtype) -> torch.Tensor:
    """Uniforms on [0, 1) from the top 24 bits of the words w (exact in
    float32)."""
    return (w >> 8).to(dtype) * (1.0 / (1 << 24))


def below(w: torch.Tensor, m: int) -> torch.Tensor:
    """Integers on 0..m-1 from the top 24 bits of w, by an exact integer
    product (each value's share within m / 2^24 of 1/m)."""
    return ((w >> 8) * m) >> 24


def normal(w0: torch.Tensor, w1: torch.Tensor, dtype) -> torch.Tensor:
    """Standard normals by Box-Muller, sqrt(-2 log u1) cos(2 pi u2), with
    u1 in (0, 1] and u2 in [0, 1) from the top 24 bits of w0 and w1."""
    u1 = ((w0 >> 8) + 1).to(dtype) * (1.0 / (1 << 24))
    u2 = uniform(w1, dtype)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
