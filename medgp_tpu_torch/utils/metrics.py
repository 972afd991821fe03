"""Structured metrics: one JSONL writer per run.

Counterpart of ``medgp_tpu/utils/metrics.py``: every stage appends typed
scalar records to one metrics.jsonl; an array becomes its mean, median and
95th percentile (`{key}_mean`, `_p50`, `_p95`). Every record carries
`process`, the rank of this process in the `torch.distributed` group (0
without one); rank r > 0 writes metrics.p{r}.jsonl beside it, since
concurrent appends to one file can interleave mid-line.

Spans and counters, one process-wide table that the per-bucket records
carry (parallel/runner.py writes the difference of two snapshots into each
`train` / `test` record):
  * `span(name)` times a region while a profiler is on
    (`torch.autograd._profiler_enabled()`): it opens a host range of the
    same name (`_RecordFunctionFast`, an operator's scope), so the region
    is named on the profiler's clock, and adds to `calls.<name>`,
    `span_s.<name>` (its seconds) and `self_s.<name>` (its seconds less
    those of the spans opened inside it on the same thread). With no
    profiler on it does nothing but that check. A `record_function` is a
    user annotation, which the profiler also draws as a range on the
    device's timeline, where it would read as device time;
  * `count(name, k)` adds k to the integer counter `name`, always: the
    kernels' wrappers count `<k>.systems` (the batch of every call) and
    `<k>.launches` (the card's launches), k1..k5, the jitter loop
    `k3.retry_systems`, the fused objective's backward
    `objective.fused_systems` (ops/objective.py:LMCSMObjective, the rows
    of every backward it runs), and its two kernels'
    `theta_prologue.launches` / `theta_epilogue.launches` (card only,
    present from their first launch).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch._C._profiler import _RecordFunctionFast

_table: Dict[str, float] = defaultdict(int)
# autograd's device thread runs the backward's kernels, and counts them
_lock = threading.Lock()
_local = threading.local()
_profiler_enabled = torch.autograd._profiler_enabled


def count(name: str, k: int = 1) -> None:
    """Add k to the process-wide counter `name`."""
    with _lock:
        _table[name] += k


class span:
    """`with span("medgp.x"):` a named region, timed while a profiler is
    on (see the module's docstring)."""

    __slots__ = ("name", "rf", "t0", "inner")

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        if not _profiler_enabled():
            return self
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.inner = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.rf is None:
            return False
        dt = time.perf_counter() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].inner += dt
        with _lock:
            _table["calls." + self.name] += 1
            _table["span_s." + self.name] += dt
            _table["self_s." + self.name] += dt - self.inner
        self.rf.__exit__(*exc)
        self.rf = None
        return False


def snapshot() -> Dict[str, float]:
    """A copy of the cumulative table of spans and counters."""
    with _lock:
        return dict(_table)


def since(before: Dict[str, float]) -> Dict[str, float]:
    """What the table gained after the snapshot `before`: every entry the
    table has now, less its value then."""
    return {k: v - before.get(k, 0) for k, v in snapshot().items()}


# The kernels' counters, present (as 0) in every record from the start.
for _k in ("k1", "k2", "k3", "k4", "k5"):
    count(_k + ".systems", 0)
    count(_k + ".launches", 0)
count("k3.retry_systems", 0)
count("objective.fused_systems", 0)


class MetricsWriter:
    def __init__(self, path: Optional[str], run_id: str = "run"):
        self.run_id = run_id
        self.process = dist.get_rank() if dist.is_initialized() else 0
        if path and self.process:
            root, ext = os.path.splitext(path)
            path = f"{root}.p{self.process}{ext}"
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def write(self, stage: str, **scalars: Any) -> Dict[str, Any]:
        rec = dict(ts=time.time(), run=self.run_id, process=self.process, stage=stage)
        for k, v in scalars.items():
            if isinstance(v, (np.ndarray, list, tuple)):
                a = np.asarray(v, float).ravel()
                if a.size:
                    rec[f"{k}_mean"] = float(np.nanmean(a))
                    rec[f"{k}_p50"] = float(np.nanpercentile(a, 50))
                    rec[f"{k}_p95"] = float(np.nanpercentile(a, 95))
                continue
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec
