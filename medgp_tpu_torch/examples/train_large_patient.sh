#!/bin/bash
# Train an outlier-large patient (the reference's 10k-100k-observation Slurm
# tier, scripts/slurm_della.json:51-61) with the PyTorch port, the
# counterpart of examples/train_large_patient.sh. LMC-SM patients with
# n_obs above the threshold (default 8192, the config's
# large_patient_threshold) leave the buckets and train by row blocks of
# L's lower block triangle, with K3 and K5 on every diagonal block
# (parallel/mesh.py), so no (n, n) gram is held; under torchrun the blocks
# are sharded over the ranks. Runs on the CUDA card; `--device cpu` after
# the threshold runs the plain twins on the CPU.
set -euo pipefail

CFG=${1:?usage: train_large_patient.sh <exp_setup.json> [threshold] [train arguments...]}
THRESH=${2:-8192}
shift $(( $# < 2 ? $# : 2 ))
PYTHON=${PYTHON:-python3}

# --restarts 64: the screen budget for large patients
# (cfg.large_patient_restarts caps it)
"$PYTHON" -m medgp_tpu_torch.cli.main train --cfg "$CFG" \
  --large-threshold "$THRESH" --restarts 64 "$@"
