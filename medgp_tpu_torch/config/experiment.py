"""Typed experiment configuration, compatible with the reference's
exp_setup.json.

Counterpart of ``medgp_tpu/config/experiment.py``. Field names, their
order and the directory layout are the JAX package's, so an experiment
generated by either package drives the other and the files written by
`generate_experiment` are byte-identical.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

from medgp_tpu_torch.data import formats
from medgp_tpu_torch.data.inits import HypBounds, default_bounds
from medgp_tpu_torch.models.params import KernelSpec, LMCSMSpec, SESpec, SMSpec

KERNEL_CODES = {"LMC-SM": 7, "SE": 0, "SM": 8}  # run_exp_generator.py:79
PRIOR_CODES = {"hier-gamma": 2, "None": 0}      # run_exp_generator.py:93


@dataclasses.dataclass
class ExperimentConfig:
    # paths
    data_dir: str
    exp_top_dir: str
    exp_cfg_dir: str = ""
    exp_log_dir: str = ""
    exp_train_dir: str = ""
    exp_test_dir: str = ""
    exp_script_dir: str = ""
    exp_kernel_dir: str = ""
    exp_figure_dir: str = ""
    cohort_id_list: str = "cohort_hadm_match.txt"
    hyp_bound_file: str = "hyp_bound.txt"
    cv_assign_file: str = ""

    # model
    kernel: str = "LMC-SM"
    kernel_index: int = 7
    prior: str = "hier-gamma"
    prior_index: int = 2
    Q: int = 5
    D: int = 24
    R: int = 8
    feature_index: str = ""  # space-separated global feature ids + trailing space
    eta: float = 0.01
    beta_lam: float = 0.01

    # optimization / CV
    cv_fold_num: int = 10
    random_init_num: int = 1000
    random_seed: int = 718
    top_iteration_num: int = 40
    iteration_num_per_update: int = 30
    online_learn_rate: float = 1e-5
    online_momentum: float = 0.9

    # outlier-large LMC-SM patients (trained by row blocks, infer/large_train.py)
    large_patient_threshold: int = 8192
    large_patient_restarts: int = 64

    @property
    def feature_list(self) -> List[int]:
        return [int(x) for x in self.feature_index.split()]

    def spec(self) -> KernelSpec:
        if self.kernel_index == 7:
            return LMCSMSpec(self.Q, self.D, self.R)
        if self.kernel_index == 0:
            return SESpec()
        if self.kernel_index == 8:
            return SMSpec(self.Q)
        raise ValueError(f"unsupported kernel_index {self.kernel_index}")

    def test_spec(self, newQ: int) -> KernelSpec:
        """Spec with the clustered mixture count (c_experiment.cpp:179-196)."""
        if self.kernel_index == 7:
            return LMCSMSpec(newQ, self.D, self.R)
        if self.kernel_index == 8:
            return SMSpec(newQ)
        return self.spec()

    def bounds(self) -> HypBounds:
        """The experiment's hyp_bound.txt (float32), or the defaults."""
        path = os.path.join(self.exp_cfg_dir, self.hyp_bound_file)
        if os.path.exists(path):
            lb, ub = formats.read_hyp_bounds(path, self.spec().n_hyp)
            return HypBounds(lb=lb.astype(np.float32), ub=ub.astype(np.float32))
        return default_bounds(self.spec())

    def pans(self) -> List[str]:
        path = os.path.join(self.data_dir, self.cohort_id_list)
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]

    def cv_assign(self) -> np.ndarray:
        return np.atleast_1d(np.loadtxt(self.cv_assign_file, dtype=int))

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=4)

    @classmethod
    def from_json(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            d = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def experiment_name(
    prefix: str, kernel: str, prior_index: int, Q: int, R: int,
    eta: float, feature_list: List[int],
) -> str:
    """run_exp_generator.py:101-120 naming rule."""
    kidx = KERNEL_CODES[kernel]
    if kernel == "LMC-SM":
        if prior_index == 2:
            return f"{prefix}_k{kidx}_q{Q}_r{R}_p{prior_index}_e{eta:2.2f}"
        return f"{prefix}_k{kidx}_q{Q}_r{R}_p{prior_index}"
    if kernel == "SM":
        return f"{prefix}_f{feature_list[0]}_k{kidx}_q{Q}"
    return f"{prefix}_f{feature_list[0]}_k{kidx}"


def generate_experiment(
    data_root: str,
    exp_root: str,
    cohort: str,
    feature_list: List[int],
    kernel: str = "LMC-SM",
    prior: str = "hier-gamma",
    Q: int = 5,
    R: int = 8,
    eta: float = 0.01,
    beta_lam: float = 0.01,
    cv_fold_num: int = 10,
    cv_seed: int = 718,
    exp_prefix: str = "exp_0000",
    opt_config: Optional[dict] = None,
    cohort_id_list: str = "cohort_hadm_match.txt",
) -> ExperimentConfig:
    """Create the experiment directory tree, exp_setup.json, hyp_bound.txt
    and the seeded cv_assign.txt (the run_exp_generator equivalent)."""
    opt_config = dict(opt_config or {})
    prior_index = PRIOR_CODES[str(prior)]
    if kernel in ("SE", "SM") and prior_index != 0:
        prior, prior_index = "None", 0  # run_exp_generator.py:112-115

    name = experiment_name(
        exp_prefix, kernel, prior_index, Q, R, eta, feature_list
    )
    top = os.path.join(exp_root, name)
    dirs = {
        k: os.path.join(top, k.split("_")[1])
        for k in (
            "exp_cfg_dir", "exp_log_dir", "exp_train_dir", "exp_test_dir",
            "exp_script_dir", "exp_kernel_dir", "exp_figure_dir",
        )
    }
    dirs["exp_cfg_dir"] = os.path.join(top, "config")
    for d in [top, *dirs.values()]:
        os.makedirs(d, exist_ok=True)

    cfg = ExperimentConfig(
        data_dir=os.path.join(data_root, cohort),
        exp_top_dir=top,
        cohort_id_list=cohort_id_list,
        kernel=kernel,
        kernel_index=KERNEL_CODES[kernel],
        prior=str(prior),
        prior_index=prior_index,
        Q=Q,
        D=len(feature_list),
        R=R,
        feature_index="".join(f"{f} " for f in feature_list),
        eta=eta,
        beta_lam=beta_lam,
        cv_fold_num=cv_fold_num,
        random_init_num=int(opt_config.get("random_init_num", 1000)),
        random_seed=int(opt_config.get("random_seed", 718)),
        top_iteration_num=int(opt_config.get("top_iteration_num", 40)),
        iteration_num_per_update=int(
            opt_config.get("iteration_num_per_update", 30)
        ),
        online_learn_rate=float(opt_config.get("online_learn_rate", 1e-5)),
        online_momentum=float(opt_config.get("online_momentum", 0.9)),
        **dirs,
    )

    bounds = default_bounds(cfg.spec(), opt_config)
    formats.write_hyp_bounds(
        os.path.join(cfg.exp_cfg_dir, cfg.hyp_bound_file), bounds.lb, bounds.ub
    )

    # seeded CV assignment (run_exp_generator.py:174-180)
    pans = cfg.pans()
    rs = np.random.RandomState(cv_seed)
    cv = np.mod(rs.permutation(len(pans)), cv_fold_num).astype(int)
    cfg.cv_assign_file = os.path.join(cfg.exp_cfg_dir, "cv_assign.txt")
    np.savetxt(cfg.cv_assign_file, cv, delimiter="\n", fmt="%d")

    cfg.to_json(os.path.join(cfg.exp_cfg_dir, "exp_setup.json"))
    return cfg
