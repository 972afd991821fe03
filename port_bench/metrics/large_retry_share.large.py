"""Blocked factorizations of the large patient made again by the jitter
loop (`parallel/mesh.py:_factor_with_retry`) as a share of all of them in
the traced window: Σ `large.retry_factorizations` over Σ
`large.factorizations` of its `train_large` records."""

from benchlib import records


def read(r):
    recs = records.stage(r, "train_large")
    return records.share(records.total(recs, "large.retry_factorizations"),
                         records.total(recs, "large.factorizations"))
