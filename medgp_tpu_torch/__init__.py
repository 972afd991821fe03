"""PyTorch + CUDA port of medgp_tpu for NVIDIA Hopper (H100).

The module layout mirrors ``medgp_tpu/``: each module here is the
counterpart of the JAX module at the same path. This package imports
``torch`` and never ``jax`` or ``medgp_tpu`` (which would pull in jax); the
host code the port needs is carried here in its own copy.

Ported so far: the train stage (restart screen, hier-gamma varEM over
SCG, or SCG alone; per-bucket checkpoints; CLI ``train``), kernel
clustering (GMM + BIC and the KDE mode kernels; CLI ``kernclust``), the
test stage in both modes (online one-step-ahead imputation with a given
mode kernel, ``mean_wo_update`` and ``mean_w_update``), evaluation (CLI
``eval``), the posterior samplers (HMC, NUTS and ADVI over the GP hypers,
with their diagnostics; CLI ``hmc``) and the fused ``run`` (with
``--sampler``), with all five TPU kernels written by hand in CUDA
(``csrc/``): the LMC-SM gram (K1) and its backward (K2), the fused
Cholesky + solve (K3), the NLML's Q-matrix cotangent (K4) and the
triangular inverse (K5), and the row-blocked path for LMC-SM patients
above the large-patient threshold (``parallel/mesh.py``,
``infer/large_train.py``: K3 and K5 on every diagonal block), the cohort
sharded over several devices (``parallel/``, ``torch.distributed``), and
the host-only modules: the MIMIC-III ETL without pandas
(``data/mimic_etl.py``), the native cohort loader (``runtime/``, built with
g++ on first use) and the kernel summaries and plots (``visualization/``).
"""

import torch

# The port computes in full float32 on the card. PyTorch's float32 matmul is
# already full precision by default, but convolutions default to TF32 (about
# three decimal digits), which the factorization tolerances (L to 1e-5,
# alpha and L^{-1} to 1e-4) would not survive. Both are set here, where the
# port initialises, so no path of the port runs in TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
