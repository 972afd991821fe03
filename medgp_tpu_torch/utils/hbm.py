"""Device memory budgets, derived from the card the port runs on.

Counterpart of ``medgp_tpu/utils/hbm.py`` and of
``medgp_tpu/infer/map_train.py:adaptive_screen_chunk``, whose caps were
scaled from one datapoint on a 16 GiB TPU. Nothing of that carries over:
here every budget is a share of the memory that ``torch.cuda.mem_get_info``
reports free on the device when the budget is asked for. Each cap counts
the (n, n) float32 arrays live per system at its stage's peak:

  * Patient grams of one bucket may take 1/8 of free memory:
    `bucket_cap(n)` = free / 8 / (4 n^2) patients.
  * One chunk of test-stage systems, one per (patient, timestamp) pair, may
    take 1/4: 6 live arrays per pair (the gathered gram, the mask_gram
    product and its temporaries, L, L^{-1} and its square), so
    `test_chunk_pairs(n)` = free / 4 / (6 * 4 n^2).
  * One chunk of the restart screen, one system per (restart, patient)
    pair, value only, may take 1/4: 3 live arrays per pair (the masked gram
    from K1, L from K3, and the retry's re-factored copy), so
    `screen_chunk_systems(n)` = free / 4 / (3 * 4 n^2).
  * One train bucket's objective+gradient evaluation may take 1/4: 6 live
    arrays per patient (the masked gram and L kept for the backward, K4's
    L^{-1} workspace and its output dK, and the retry's copies), so
    `train_batch_cap(n)` = free / 4 / (6 * 4 n^2) patients.

The rest is left to PyTorch's caching allocator and to the kernels'
other outputs. Over several ranks the caps that decide a bucket's size
(`bucket_cap`, `train_batch_cap`) and the large patient's blocks take the
least free memory of any rank (`parallel/mesh.py:min_free_bytes`), so
that every rank plans the same shapes; the chunk caps split a rank's own
slice and read its own device. A large patient (parallel/mesh.py) has its own plan,
`large_block_plan`, from the rule in its docstring. Host (CPU) runs use
the plain PyTorch versions of the kernels and a fixed budget of
CPU_BUDGET_BYTES.
"""

from __future__ import annotations

import torch

CPU_BUDGET_BYTES = 2 << 30
GRAM_SHARE = 8
TEST_SHARE = 4
TEST_BUFFERS_PER_PAIR = 6
SCREEN_SHARE = 4
SCREEN_BUFFERS_PER_SYSTEM = 3
TRAIN_SHARE = 4
TRAIN_BUFFERS_PER_PATIENT = 6


def device_bytes(device: torch.device | str) -> int:
    """Free memory on `device` in bytes (CPU: the fixed host budget)."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free)
    return CPU_BUDGET_BYTES


def _systems(device, share: int, buffers: int, n: int, free: int | None = None) -> int:
    per = buffers * 4 * n * n
    free = device_bytes(device) if free is None else free
    return max(1, free // share // max(per, 1))


def bucket_cap(n_max: int, device: torch.device | str, free: int | None = None) -> int:
    """Largest batch of one n_max bucket whose grams fit their share of
    `free` bytes (default: the device's free memory now)."""
    return _systems(device, GRAM_SHARE, 1, n_max, free)


def test_chunk_pairs(n: int, device: torch.device | str) -> int:
    """(patient, timestamp) systems per test-stage chunk at bucket length n."""
    return _systems(device, TEST_SHARE, TEST_BUFFERS_PER_PAIR, n)


def screen_chunk_systems(n: int, device: torch.device | str) -> int:
    """(restart, patient) systems per restart-screen chunk at length n."""
    return _systems(device, SCREEN_SHARE, SCREEN_BUFFERS_PER_SYSTEM, n)


def train_batch_cap(n: int, device: torch.device | str, free: int | None = None) -> int:
    """Patients per train bucket at length n (of `free` bytes, as
    `bucket_cap`)."""
    return _systems(device, TRAIN_SHARE, TRAIN_BUFFERS_PER_PATIENT, n, free)


LARGE_BLOCK_MAX = 4096  # the largest n at which K3 and K5 were held and timed
LARGE_SHARE = 0.9       # of the free bytes; the rest is the allocator's rounding
# (n, b) float32 workspaces live beside L at the peak: the last row block
# of the gram while cross_gram_lmcsm builds it (the row, its squared
# distance and the accumulating sum, and per component the B_q entries,
# the distance, the cosine and exponential and their products: about 7)
# and the mask product; then the panel and its product, and in the
# backward the block column of K^{-1} that becomes Qbar in place.
LARGE_WORKSPACES = 8
# (b, b) tiles that autograd keeps through one gram tile of the backward:
# per component the cosine's argument, the cosine, the exponential, the
# B_q entries and their product; shared, the squared distance, the
# distance, the time differences and the gradient's temporaries.
LARGE_TILE_BUFFERS_PER_COMPONENT = 5
LARGE_TILE_BUFFERS_SHARED = 8
# over several ranks, (n, b) buffers of the block-column all-gather (the
# rank's pieces, the gathered parts and their concatenation, the reordered
# copy) and the received row block of the backward
LARGE_EXCHANGE_WORKSPACES = 5


def large_patient_bytes(n_pad: int, b: int, components: int, world: int = 1) -> int:
    """Device bytes on one rank of one value+gradient of a padded large
    patient of n_pad = P b rows row-sharded over `world` ranks
    (parallel/mesh.py), all float32: the rank's row blocks of L's lower
    block triangle, at most n_pad (n_pad / world + b) / 2 values (rank
    world - 1 holds blocks world - 1, 2 world - 1, ...); the P
    diagonal-block inverses, P b^2; LARGE_WORKSPACES (n_pad, b) workspaces,
    LARGE_EXCHANGE_WORKSPACES more over several ranks; and the gram tile's
    autograd buffers, (LARGE_TILE_BUFFERS_PER_COMPONENT * components +
    LARGE_TILE_BUFFERS_SHARED) (b, b) tiles. At world 1 L takes
    n_pad (n_pad + b) / 2 values."""
    P = n_pad // b
    tiles = LARGE_TILE_BUFFERS_PER_COMPONENT * components + LARGE_TILE_BUFFERS_SHARED
    work = LARGE_WORKSPACES + (LARGE_EXCHANGE_WORKSPACES if world > 1 else 0)
    return 4 * (n_pad * (n_pad // world + b) // 2 + P * b * b + work * n_pad * b
                + tiles * b * b)


def large_block_plan(n: int, free_bytes: int, components: int = 5, blocks=None,
                     world: int = 1):
    """(P, b, n_pad) for a large patient of n observations with `components`
    LMC-SM components, row-sharded over `world` ranks with `free_bytes`
    free on each: P row blocks of b rows, P a multiple of `world`, b a
    multiple of K3's 32-wide block and at most LARGE_BLOCK_MAX, n_pad =
    P b >= n.

    For the largest b_max <= LARGE_BLOCK_MAX (a multiple of 32) that fits,
    P = ceil(n / b_max) rounded up to a multiple of `world`, b =
    round_up(ceil(n / P), 32) and n_pad = P b; it fits when
    `large_patient_bytes(n_pad, b, components, world)` is within
    LARGE_SHARE of `free_bytes`. So a rank's share of L takes about
    n_pad (n_pad / world + b) / 2 values and every workspace O(n b).
    `blocks` fixes P instead (tests, parity checks). Raises when even
    b = 32 does not fit."""
    def ceil_div(a, c):
        return -(-a // c)

    def plan(P):
        b = ceil_div(ceil_div(n, P), 32) * 32
        return P, b, P * b

    if blocks is not None:
        return plan(int(blocks))
    budget = LARGE_SHARE * free_bytes
    for b_max in range(LARGE_BLOCK_MAX, 31, -32):
        P, b, n_pad = plan(ceil_div(ceil_div(n, b_max), world) * world)
        if large_patient_bytes(n_pad, b, components, world) <= budget:
            return P, b, n_pad
    raise MemoryError(
        f"large patient of {n} observations: "
        f"{large_patient_bytes(n + 32 * world, 32, components, world)} bytes a rank at "
        f"b = 32 exceed {LARGE_SHARE} of the {free_bytes} free"
    )
