"""Structured metrics: one JSONL writer per run.

Counterpart of ``medgp_tpu/utils/metrics.py``: every stage appends typed
scalar records to one metrics.jsonl; an array becomes its mean, median and
95th percentile (`{key}_mean`, `_p50`, `_p95`). Every record carries
`process`, the rank of this process in the `torch.distributed` group (0
without one); rank r > 0 writes metrics.p{r}.jsonl beside it, since
concurrent appends to one file can interleave mid-line.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch.distributed as dist


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
