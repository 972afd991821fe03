r"""Multi-GPU launch of the PyTorch port, the counterpart of
examples/launch_pod.py.

The reference fans out one Slurm job per patient (run_exp_generator.py:
213-263, train_della.sh); here one job runs the whole cohort: one process
per GPU, started by `torchrun`, each a rank of one `torch.distributed`
group. Every bucket's patients are sharded over the ranks, rank 0 writes
the files and clusters, and each fold's noise modes come from one
all-gather (`python -m medgp_tpu_torch.cli.main run`).

On one host, one process per card:

    torchrun --standalone --nproc-per-node 8 \
        medgp_tpu_torch/examples/launch_pod.py --cfg .../exp_setup.json

On several hosts, write a Slurm script that starts `torchrun` on each
(`--num-hosts` hosts of `--gpus-per-host` cards; the first host of the
allocation is the rendezvous) and submit it:

    python3 medgp_tpu_torch/examples/launch_pod.py --cfg .../exp_setup.json \
        --emit-slurm pod.sh --num-hosts 4 --gpus-per-host 8
    sbatch pod.sh

It runs on the CUDA cards and stops without one; `--device cpu` (with the
gloo backend) runs the kernels' plain twins on the CPU.
"""

import argparse
import os
import sys

import torch
import torch.distributed as dist

try:
    from medgp_tpu_torch.parallel.launch import (
        BACKENDS, init_distributed, rank_device, write_slurm_launcher,
    )
except ModuleNotFoundError:  # run from a source checkout without an install
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from medgp_tpu_torch.parallel.launch import (
        BACKENDS, init_distributed, rank_device, write_slurm_launcher,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--alg", default="gmm")
    ap.add_argument("--emit-slurm", metavar="PATH",
                    help="write an sbatch script instead of running")
    ap.add_argument("--num-hosts", type=int, default=4)
    ap.add_argument("--gpus-per-host", type=int, default=1,
                    help="processes (one per GPU) that torchrun starts on each host")
    ap.add_argument("--device", default="cuda",
                    help="cuda (this rank's card) or cpu (the kernels' plain twins)")
    ap.add_argument("--dist-backend", default=None, choices=BACKENDS,
                    help="default: nccl on the cards, gloo on the CPU")
    args = ap.parse_args(argv)

    if args.emit_slurm:
        path = write_slurm_launcher(
            args.emit_slurm, args.cfg, num_hosts=args.num_hosts, alg=args.alg,
            gpus_per_host=args.gpus_per_host,
        )
        print(path)
        return

    device = rank_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "launch_pod: no CUDA device (torch.cuda.is_available() is false); "
            "pass --device cpu to run on the CPU"
        )
    init_distributed(backend=args.dist_backend, device=device)  # none for one process
    from medgp_tpu_torch.cli.main import main as cli_main

    try:
        cli_main(["run", "--cfg", args.cfg, "--alg", args.alg, "--device", args.device])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
