"""PyTorch + CUDA port of medgp_tpu for NVIDIA Hopper (H100).

The module layout mirrors ``medgp_tpu/``: each module here is the
counterpart of the JAX module at the same path. This package imports
``torch`` and never ``jax`` or ``medgp_tpu`` (which would pull in jax); the
host code the port needs is carried here in its own copy.

Ported so far: the train stage (restart screen, hier-gamma varEM over
SCG, or SCG alone; CLI ``train``) and the test stage in both modes (online
one-step-ahead imputation with a given mode kernel, ``mean_wo_update``
and ``mean_w_update``), with all five TPU kernels written by hand in CUDA
(``csrc/``): the LMC-SM gram (K1) and its backward (K2), the fused
Cholesky + solve (K3), the NLML's Q-matrix cotangent (K4) and the
triangular inverse (K5). Not yet: clustering, evaluation, the samplers,
the row-blocked path for large patients, checkpoints, several devices.
"""

import torch

# The port computes in full float32 on the card. PyTorch's float32 matmul is
# already full precision by default, but convolutions default to TF32 (about
# three decimal digits), which the factorization tolerances (L to 1e-5,
# alpha and L^{-1} to 1e-4) would not survive. Both are set here, where the
# port initialises, so no path of the port runs in TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
