"""Multi-process launch: one process per GPU over `torch.distributed`.

Counterpart of ``medgp_tpu/parallel/launch.py``. The JAX package runs one
process per host that sees every device of the host; PyTorch's idiom is one
process per GPU, started by `torchrun`, which sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT in each process's environment:

  * `init_distributed()` joins the process group from that environment (or
    from explicit arguments), over NCCL for a CUDA device and gloo for the
    CPU; a world of one process starts no group;
  * `rank_device()` maps a device name to this rank's device: "cuda" is
    cuda:LOCAL_RANK (modulo the visible cards, so that several ranks may
    share one card over gloo);
  * `host_shard()` splits the cohort over ranks for IO-bound work, while
    `parallel/mesh.py` shards each bucket's patients over the ranks;
  * `write_scheduler_launcher()` emits one batch script for the whole run,
    whose run line is a `torchrun` of `medgp_tpu_torch.cli.main run`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from medgp_tpu_torch.parallel.bucketing import balance_shards

BACKENDS = ("nccl", "gloo")
RDZV_PORT = 29500


def world_from_env() -> int:
    """The world size `torchrun` set (1 outside it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device(name: str | torch.device = "cuda") -> torch.device:
    """This rank's device: "cuda" without an index is cuda:LOCAL_RANK
    modulo the visible cards; anything else is returned as given."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def default_backend(device: torch.device | str) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: torch.device | str = "cpu",
) -> None:
    """Join the process group of this run (medgp_tpu/parallel/launch.py:
    26-43). World size, rank and the rendezvous come from the `torchrun`
    environment unless given (init_method "env://"); returns at once for a
    world of one process or when the group exists. `backend` defaults to
    NCCL for a CUDA `device` and gloo for the CPU; gloo on a CUDA device
    runs only when passed here, NCCL on the CPU is refused."""
    world_size = world_from_env() if world_size is None else int(world_size)
    if world_size <= 1 or dist.is_initialized():
        return
    device = torch.device(device)
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} (use one of {BACKENDS})")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, not {device}; use gloo on the CPU")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = int(os.environ.get("RANK", "0")) if rank is None else int(rank)
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
    )


def host_shard(
    pans: Sequence[str],
    costs: Optional[Sequence[float]] = None,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[str]:
    """This rank's patients, cost-balanced over ranks (LPT, deterministic);
    rank and world come from `torch.distributed` unless given."""
    on = dist.is_initialized()
    pi = (dist.get_rank() if on else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if on else 1) if process_count is None else process_count
    if pc == 1:
        return list(pans)
    costs = np.ones(len(pans)) if costs is None else np.asarray(costs, float)
    shards = balance_shards(costs, pc)
    return [pans[i] for i in shards[pi]]


def write_scheduler_launcher(
    path: str,
    exp_cfg: str,
    num_hosts: int,
    scheduler: str = "slurm",
    partition: Optional[str] = None,
    time_limit: str = "4:00:00",
    memory: Optional[str] = None,
    alg: str = "gmm",
    extra_cmd: Optional[Sequence[str]] = None,
    gpus_per_host: int = 1,
) -> str:
    """One scheduler script for the whole run in the reference's three
    flavours, slurm / pbs / sequential (hpc.py:4-37 `write_scheduler_sh`),
    one job for all patients. The run line starts `gpus_per_host`
    processes on each host with `torchrun`, one per GPU; the first host
    of the allocation is the rendezvous. `sequential` is a plain shell
    wrapper for one host without a scheduler."""
    run = f"-m medgp_tpu_torch.cli.main run --cfg {exp_cfg} --alg {alg}"
    multi = (
        f"torchrun --nnodes {num_hosts} --nproc-per-node {gpus_per_host} "
        "--rdzv-backend c10d --rdzv-endpoint {head}:" + str(RDZV_PORT)
    )
    lines = ["#!/bin/bash"]
    if scheduler == "slurm":
        lines += [
            f"#SBATCH -N {num_hosts}",
            "#SBATCH --ntasks-per-node=1",
            f"#SBATCH --gpus-per-node={gpus_per_host}",
            f"#SBATCH -t {time_limit}",
        ]
        if memory:
            lines.append(f"#SBATCH --mem={memory}")
        if partition:
            lines.append(f"#SBATCH -p {partition}")
        head = "$(scontrol show hostnames $SLURM_JOB_NODELIST | head -n 1)"
        launch = "srun " + multi.format(head=head) + " --rdzv-id $SLURM_JOB_ID " + run
    elif scheduler == "pbs":
        lines += [
            f"#PBS -l select={num_hosts}:ncpus=1:ngpus={gpus_per_host}",
            f"#PBS -l walltime={time_limit}",
            "#PBS -V",
        ]
        launch = multi.format(head="$(head -n 1 $PBS_NODEFILE)") + " " + run
    elif scheduler == "sequential":
        launch = f"torchrun --standalone --nproc-per-node {gpus_per_host} {run}"
    else:
        raise NotImplementedError(
            f"scheduler {scheduler!r} (use slurm | pbs | sequential)"
        )
    lines += [
        "",
        "# one process per GPU; torchrun sets each one's rank and device",
        launch,
    ]
    for cc in extra_cmd or ():
        lines.append(str(cc))
    lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    os.chmod(path, 0o775)
    return path


def write_slurm_launcher(
    path: str,
    exp_cfg: str,
    num_hosts: int,
    partition: Optional[str] = None,
    time_limit: str = "4:00:00",
    alg: str = "gmm",
    gpus_per_host: int = 1,
) -> str:
    """Slurm convenience wrapper around :func:`write_scheduler_launcher`."""
    return write_scheduler_launcher(
        path, exp_cfg, num_hosts, scheduler="slurm", partition=partition,
        time_limit=time_limit, alg=alg, gpus_per_host=gpus_per_host,
    )
