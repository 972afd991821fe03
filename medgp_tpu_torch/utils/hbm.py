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
other outputs. Host (CPU) runs use the plain PyTorch versions of the
kernels and a fixed budget of CPU_BUDGET_BYTES.
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


def _systems(device, share: int, buffers: int, n: int) -> int:
    per = buffers * 4 * n * n
    return max(1, device_bytes(device) // share // max(per, 1))


def bucket_cap(n_max: int, device: torch.device | str) -> int:
    """Largest batch of one n_max bucket whose grams fit their share."""
    return _systems(device, GRAM_SHARE, 1, n_max)


def test_chunk_pairs(n: int, device: torch.device | str) -> int:
    """(patient, timestamp) systems per test-stage chunk at bucket length n."""
    return _systems(device, TEST_SHARE, TEST_BUFFERS_PER_PAIR, n)


def screen_chunk_systems(n: int, device: torch.device | str) -> int:
    """(restart, patient) systems per restart-screen chunk at length n."""
    return _systems(device, SCREEN_SHARE, SCREEN_BUFFERS_PER_SYSTEM, n)


def train_batch_cap(n: int, device: torch.device | str) -> int:
    """Patients per train bucket at length n."""
    return _systems(device, TRAIN_SHARE, TRAIN_BUFFERS_PER_PATIENT, n)
