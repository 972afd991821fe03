#!/bin/bash
# The full pipeline with the PyTorch port in one process on one CUDA card:
# train -> kernclust -> test (both modes) -> eval, the fused counterpart of
# the reference's run_train_all.sh -> run_kernclust_all.sh ->
# run_test_all.sh -> run_eval_all.sh Slurm fan-out (examples/run_pipeline.sh).
# Without a card it stops; `--device cpu` runs the kernels' plain twins on
# the CPU. Further arguments go to `run` (e.g. --sampler hmc, --device cpu).
# Several cards: launch_pod.py under torchrun.
set -euo pipefail

CFG=${1:?usage: run_pipeline.sh /path/to/exp_setup.json [run arguments...]}
shift
PYTHON=${PYTHON:-python3}
"$PYTHON" -m medgp_tpu_torch.cli.main run --cfg "$CFG" --alg gmm "$@"
