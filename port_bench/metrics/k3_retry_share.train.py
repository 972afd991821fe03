"""K3 systems factored again by the jitter loop (`ops/nlml.py:
jittered_chol_solve`) as a share of all K3 systems in the traced train
window: Σ `k3.retry_systems` over Σ `k3.systems` of its `train`
records."""

from benchlib import records


def read(r):
    recs = records.stage(r, "train")
    return records.share(records.total(recs, "k3.retry_systems"),
                         records.total(recs, "k3.systems"))
