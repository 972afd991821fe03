"""The objective systems whose gradient took the fused LMC-SM objective
(`ops/objective.py:LMCSMObjective`, one autograd node) as a share of all
objective systems with a gradient in the traced train window: Σ
`objective.fused_systems` over Σ `k4.systems` of its `train` records (K4
runs once per objective system with a gradient, on either path)."""

from benchlib import records


def read(r):
    recs = records.stage(r, "train")
    return records.share(records.total(recs, "objective.fused_systems"),
                         records.total(recs, "k4.systems"))
