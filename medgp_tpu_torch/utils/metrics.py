"""Structured metrics: one JSONL writer per run.

Counterpart of ``medgp_tpu/utils/metrics.py``: every stage appends typed
scalar records to one metrics.jsonl; an array becomes its mean, median and
95th percentile (`{key}_mean`, `_p50`, `_p95`). The port runs as one
process, so every record carries process 0, the field the JAX package's
readers expect.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


class MetricsWriter:
    def __init__(self, path: Optional[str], run_id: str = "run"):
        self.path = path
        self.run_id = run_id
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def write(self, stage: str, **scalars: Any) -> Dict[str, Any]:
        rec = dict(ts=time.time(), run=self.run_id, process=0, stage=stage)
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
