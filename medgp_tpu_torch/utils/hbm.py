"""Device memory budgets, derived from the card the port runs on.

Counterpart of ``medgp_tpu/utils/hbm.py``, whose caps were scaled from one
datapoint on a 16 GiB TPU. Nothing of that carries over: here every budget
is a share of the memory that ``torch.cuda.mem_get_info`` reports free on
the device when the budget is asked for.

  * Patient grams of one bucket, (B, n, n) float32, may take 1/8 of free
    memory: `bucket_cap(n)` = free / 8 / (4 n^2) patients.
  * One chunk of test-stage systems, one per (patient, timestamp) pair, may
    take 1/4 of free memory. A pair holds up to TEST_BUFFERS_PER_PAIR live
    (n, n) float32 arrays at the peak of a chunk (the gathered gram, the
    mask_gram product and its temporaries, L, L^{-1} and its square), so
    `test_chunk_pairs(n)` = free / 4 / (6 * 4 n^2).

The rest is left to PyTorch's caching allocator and to the kernels'
other outputs. Host (CPU) runs use the plain PyTorch versions of the
kernels and a fixed budget of CPU_BUDGET_BYTES.
"""

from __future__ import annotations

import torch

CPU_BUDGET_BYTES = 2 << 30
GRAM_SHARE = 8
TEST_SHARE = 4
TEST_BUFFERS_PER_PAIR = 6


def device_bytes(device: torch.device | str) -> int:
    """Free memory on `device` in bytes (CPU: the fixed host budget)."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free)
    return CPU_BUDGET_BYTES


def bucket_cap(n_max: int, device: torch.device | str) -> int:
    """Largest batch of one n_max bucket whose grams fit their share."""
    per_patient = 4 * n_max * n_max
    return max(1, device_bytes(device) // GRAM_SHARE // max(per_patient, 1))


def test_chunk_pairs(n: int, device: torch.device | str) -> int:
    """(patient, timestamp) systems per test-stage chunk at bucket length n."""
    per_pair = TEST_BUFFERS_PER_PAIR * 4 * n * n
    return max(1, device_bytes(device) // TEST_SHARE // max(per_pair, 1))
