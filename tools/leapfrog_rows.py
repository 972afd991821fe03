#!/usr/bin/env python3
"""Per row, how far a 16-step leapfrog trajectory through the kernels and
through the float32 twins ends from the float64 twins' on the card, over
several draws of chain starts and momenta: chip_smoke.py's
`sampler_potential_and_leapfrog` repeated, every row printed.

    python3 tools/leapfrog_rows.py [--seeds 44 0 1 2 3 4 5 6] [--generator]

It stages and trains chip_smoke.py's 64-patient cohort (`stage_cohort`,
CLI `train`), then on the n=512 bucket (29 patients x 4 chains) draws the
starts and momenta from the streams at each seed (`--generator` adds the
draws of a `torch.Generator` seeded 44, the smoke's inputs before the
streams) and prints one JSON line per draw: each row's dU error of the
kernels and of the float32 twins against the float64 twins (over the
row's scale), and the same for theta at the trajectory's end, then the
rows where one float32 path stays within THETA_REL and the other does
not, and for each patient on a chain of which the twins leave THETA_REL
its worst row through each path and whether the kernels' stays within
the smoke's bound for it (the larger of THETA_ILL_REL and the twins'
worst). It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from medgp_tpu_torch.infer import streams as st  # noqa: E402
from medgp_tpu_torch.infer.hmc import _leapfrog, make_potential, repeat_rows  # noqa: E402
from medgp_tpu_torch.models.gp import PatientData  # noqa: E402
from medgp_tpu_torch.ops import cuda_build  # noqa: E402


def errors(spec, prior, rows, th, p, steps=16, eps=2e-4):
    """Per row: (dU error kernels, float32 twins; theta error kernels,
    float32 twins), each against the float64 twins over the row's scale."""
    gmask = prior.grad_mask()
    rows64 = PatientData(rows.t.double(), rows.y.double(), rows.meta, rows.mask.double())

    def run(data, th, p):
        pg = make_potential(spec, data, prior)
        u, g = pg(th)
        step = torch.full((th.shape[0],), eps, dtype=th.dtype, device=th.device)
        end = _leapfrog(pg, th, p, g * gmask, u, step, torch.ones_like(th), steps, steps,
                        gmask.to(th.dtype))[0]
        return g, end

    g, end = run(rows, th, p)
    with cs.twins():
        gt, end_t = run(rows, th, p)
        g64, end64 = run(rows64, th.double(), p.double())

    def row_err(x, ref):
        return ((x.double() - ref).abs().amax(-1) / ref.abs().amax(-1)).cpu().tolist()

    return row_err(g, g64), row_err(gt, g64), row_err(end, end64), row_err(end_t, end64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[cs.SEED, 0, 1, 2, 3, 4, 5, 6])
    ap.add_argument("--generator", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("leapfrog_rows: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    cuda_build.build_library()
    os.makedirs(cs.WORK, exist_ok=True)
    cfg_path, cfg, _, _ = cs.stage_cohort()
    cs.cli(["train", "--cfg", cfg_path, "--device", str(dev)])
    chains = 4
    spec, b, data, theta0, prior = cs.sampler_bucket(cfg, dev, chains)
    gmask = prior.grad_mask()
    rows = repeat_rows(data, chains)
    draws = []
    for seed in args.seeds:
        s = st.patient_streams(seed, range(theta0.shape[0]), dev)
        th = cs.chain_starts(theta0, s, chains, gmask).reshape(-1, spec.n_hyp)
        ((w0, w1),) = st.words(st.with_chains(s, chains), 0, ((st.HMC_MOMENTUM, spec.n_hyp),))
        draws.append((f"streams seed {seed}", th, st.normal(w0, w1, th.dtype)))
    if args.generator:
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        jitter = 0.01 * torch.randn((theta0.shape[0], chains, spec.n_hyp), generator=gen,
                                    device=dev) * gmask
        th = (theta0[:, None, :] + jitter).reshape(-1, spec.n_hyp)
        draws.append((f"generator seed {cs.SEED}", th,
                      torch.randn(th.shape, generator=gen, device=dev)))
    for name, th, p in draws:
        ek, et, tk, tt = errors(spec, prior, rows, th, p)
        # chip_smoke.py's rule: a patient on a chain of which the twins
        # leave THETA_REL holds every chain within the larger of
        # THETA_ILL_REL and the twins' worst on the patient
        ill = {}
        for i in range(len(tk)):
            k, t = ill.get(i // chains, (0.0, 0.0))
            ill[i // chains] = (max(k, tk[i]), max(t, tt[i]))
        ill = {pat: kt for pat, kt in ill.items() if kt[1] > cs.THETA_REL}
        split = [dict(row=(i // chains, i % chains), ek=ek[i], et=et[i], tk=tk[i], tt=tt[i])
                 for i in range(len(tk)) if (tk[i] > cs.THETA_REL) != (tt[i] > cs.THETA_REL)]
        print(json.dumps(dict(
            draws=name, rows=len(tk), theta_rel=cs.THETA_REL,
            kernels_over=sum(x > cs.THETA_REL for x in tk),
            twins_over=sum(x > cs.THETA_REL for x in tt),
            max_tk=max(tk), max_tt=max(tt), split=split,
            ill_patients={pat: dict(tk=k, tt=t, bound=max(cs.THETA_ILL_REL, t),
                                    held=k <= max(cs.THETA_ILL_REL, t))
                          for pat, (k, t) in ill.items()},
            over_any=[dict(row=(i // chains, i % chains), ek=ek[i], et=et[i], tk=tk[i], tt=tt[i])
                      for i in range(len(tk)) if max(tk[i], tt[i]) > cs.THETA_REL],
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
