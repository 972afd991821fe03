#!/bin/bash
# Canonical experiment generation with the PyTorch port, the counterpart of
# examples/gen_example.sh (the reference's scripts/gen_medgpc_example.sh):
# LMC-SM, hierarchical-gamma prior, Q=5, R=8, eta=0.01, beta_lambda=0.01,
# GMM clustering, 10-fold CV, seed 718. Host-only: it writes the experiment
# directory and its exp_setup.json, and touches no device.
#
# Expects the cohort produced by the MIMIC-III ETL
# (medgp_tpu_torch.data.mimic_etl or write_reference_format_cohort) under
# $DATA_ROOT/heart_failure. Further arguments go to `generate`.
set -euo pipefail

DATA_ROOT=${DATA_ROOT:-/data/medgp}
EXP_ROOT=${EXP_ROOT:-/exp/medgp}
PYTHON=${PYTHON:-python3}
HERE=$(dirname "$0")

"$PYTHON" -m medgp_tpu_torch.cli.main generate \
  --data-root "$DATA_ROOT" --exp-root "$EXP_ROOT" --cohort heart_failure \
  --feature-config "$HERE/feature_all.json" \
  --opt-config "$HERE/opt_prior2.json" \
  --kernel LMC-SM --prior hier-gamma \
  --Q 5 --R 8 --eta 0.01 --beta-lam 0.01 \
  --cv-fold-num 10 --cv-seed 718 --exp-prefix jmlr "$@"
