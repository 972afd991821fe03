"""Unit: one `parallel/runner.test_cohort` call in mode `mean_w_update` on a
shard of the cohort, with fold -1's mode kernel.

Set-up draws the cohort from the seed (`benchlib.cohort`), writes the
mode kernel that the traffic names (a ground-truth cluster kernel of the
cohort, at full width) as fold -1's mode-kernel file, splits the cohort
into shards of `shard_patients` with the same spread of lengths, and warms
the test path on a few patients of every bucket length. The work is the
predictions made: one per observation of a patient whose flag is true;
a patient whose flag is false counts its observations as failed.

The check (`check`) replays the online loop for patients drawn from the
seed with the float64 reference (`reference/lmcsm.py:
online_with_updates`), from the same mode kernel and its test prior, on
its own: every hyper update and every leave-one-out prediction.
  * pred_gap: |pred - pred64| / sqrt(var64), its `obs_quantile` quantile
    over each patient's observations, the largest over the patients;
  * var_gap: |var - var64| / var64, the same.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchlib.cohort import interleaved_shards, make_cohort
from benchlib.stats import summary
from reference import lmcsm

MODE = "mean_w_update"


class Driver:
    work_unit = "predictions"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg_json, self.traffic = ctx.config, ctx.traffic
        c = self.cfg_json
        self.Q, self.D, self.R = c["Q"], c["D"], c["R"]
        self.outputs = {}
        self.unit_seconds = []

    def _experiment(self):
        from medgp_tpu_torch.config.experiment import ExperimentConfig

        c, work = self.cfg_json, self.ctx.workdir
        return ExperimentConfig(
            data_dir=os.path.join(work, "data"), exp_top_dir=work,
            exp_log_dir=os.path.join(work, "log"),
            exp_test_dir=os.path.join(work, "test"),
            exp_kernel_dir=os.path.join(work, "kernel"),
            kernel="LMC-SM", kernel_index=7, prior="hier-gamma", prior_index=2,
            Q=self.Q, D=self.D, R=self.R,
            feature_index="".join(f"{f} " for f in c["feature_index"]),
            eta=c["eta"], beta_lam=c["beta_lam"],
            online_learn_rate=c["online_learn_rate"], online_momentum=c["online_momentum"],
        )

    def setup(self):
        from medgp_tpu_torch.data import formats
        from medgp_tpu_torch.data.cohort import PatientRecord
        from medgp_tpu_torch.parallel import runner

        self.runner = runner
        tr = self.traffic
        pats, thetas = make_cohort(
            self.ctx.seed, self.Q, self.D, self.R, tr["n_patients"], tr["n_clusters"],
            tr["n_obs"], tr["t_max_hours"], device=self.ctx.device,
        )
        self.patients = {p.pan: p for p in pats}
        # the mode kernel both sides get: float32, as the test stage reads it
        self.mode_theta = thetas[int(tr["mode_cluster"])].astype(np.float32)
        self.exp = self._experiment()
        for d in (self.exp.exp_test_dir, self.exp.exp_kernel_dir):
            os.makedirs(d, exist_ok=True)
        formats.write_mode_kernel(self.exp.exp_kernel_dir, -1, "gmm",
                                  self.mode_theta.astype(np.float64), self.Q)

        def records(ps):
            return [PatientRecord(pan=p.pan, t=p.t, y=p.y, meta=p.meta) for p in ps]
        self.shards = [records(s) for s in interleaved_shards(pats, tr["shard_patients"])]
        per = int(tr["warmup_patients_per_bucket"])
        warm = {}
        for r in self.shards[0]:
            edge = 128
            while edge < r.n_obs:
                edge *= 2
            if len(warm.setdefault(edge, [])) < per:
                warm[edge].append(r)
        for group in warm.values():
            runner.test_cohort(self.exp, group, modes=(MODE,), device=self.ctx.device)

    def open_window(self):
        pass

    def close_window(self):
        pass

    def unit(self, i):
        shard = self.shards[i % len(self.shards)]
        t0 = time.perf_counter()
        out = self.runner.test_cohort(self.exp, shard, modes=(MODE,), device=self.ctx.device)
        self.unit_seconds.append(time.perf_counter() - t0)
        done = failed = 0
        for r in shard:
            res = out[r.pan][MODE]
            if res.get("flag"):
                done += len(res["pred"])
                self.outputs[r.pan] = (np.asarray(res["pred"]), np.asarray(res["var"]))
            else:
                failed += r.n_obs
        return done, failed

    def release(self):
        self.shards = None

    def check(self, dtype=torch.float64, tf32=False):
        limits = self.traffic["check"]["limits"]
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            res = self._numbers(dtype)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        return [(k, v, limits[k]) for k, v in res.items()]

    def _replay(self, pans, dtype):
        """The reference's (pred, var) of these patients, in `dtype`."""
        dev, Q, D, R = self.ctx.device, self.Q, self.D, self.R
        ps = [self.patients[p] for p in pans]
        n = max(len(p.t) for p in ps)
        B = len(ps)
        t = torch.zeros((B, n), dtype=torch.float32)
        y = torch.zeros((B, n), dtype=torch.float32)
        meta = torch.zeros((B, n), dtype=torch.int64)
        mask = torch.zeros((B, n), dtype=torch.bool)
        for i, p in enumerate(ps):
            k = len(p.t)
            t[i, :k], y[i, :k] = torch.as_tensor(p.t), torch.as_tensor(p.y)
            meta[i, :k], mask[i, :k] = torch.as_tensor(p.meta), True
        mode = torch.as_tensor(self.mode_theta, device=dev).to(dtype)
        H = mode.shape[0]
        a = slice(D, D + Q * D * R)
        clamp = torch.zeros(H, dtype=torch.bool, device=dev)
        clamp[a] = mode[a] == 0
        prior = dict(active=clamp, exp_tf=torch.zeros_like(clamp),
                     ptype=torch.where(clamp, lmcsm.PRIOR_CLAMP, -1).to(dev),
                     loc=torch.zeros(H, dtype=dtype, device=dev),
                     scale=torch.ones(H, dtype=dtype, device=dev))
        c = self.cfg_json
        pred, var, _ = lmcsm.online_with_updates(
            mode, t.to(dev), y.to(dev), meta.to(dev), mask.to(dev), Q, D, R, prior,
            c["online_learn_rate"], c["online_momentum"])
        out = {}
        for i, p in enumerate(ps):
            k = len(p.t)
            order = np.argsort(p.t, kind="stable")
            out[p.pan] = (pred[i, :k].double().cpu().numpy()[order],
                          var[i, :k].double().cpu().numpy()[order])
        return out

    def _numbers(self, dtype):
        rng = np.random.default_rng([int(self.ctx.seed) & 0xFFFFFFFF, int(self.ctx.seed) >> 32, 13])
        pans = sorted(self.outputs)
        k = min(int(self.traffic["check"]["patients"]), len(pans))
        if not k:
            return dict(pred_gap=float("inf"), var_gap=float("inf"))
        chosen = [pans[i] for i in sorted(rng.choice(len(pans), size=k, replace=False))]
        ref = self._replay(chosen, torch.float64)
        got = ({p: self.outputs[p] for p in chosen} if dtype == torch.float64
               else self._replay(chosen, dtype))
        pg, vg = [], []
        for p in chosen:
            (pr, vr), (pp, vp) = ref[p], got[p]
            if pp.shape != pr.shape:
                return dict(pred_gap=float("inf"), var_gap=float("inf"))
            pg.append(np.abs(pp - pr) / np.sqrt(vr))
            vg.append(np.abs(vp - vr) / vr)
        q = float(self.traffic["check"]["obs_quantile"])
        pq = [float(np.quantile(x, q)) for x in pg]
        vq = [float(np.quantile(x, q)) for x in vg]
        self.detail = dict(pred=summary(np.concatenate(pg)), var=summary(np.concatenate(vg)),
                           pred_by_patient=pq, var_by_patient=vq)
        return dict(pred_gap=max(pq), var_gap=max(vq))
