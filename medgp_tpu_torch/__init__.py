"""PyTorch + CUDA port of medgp_tpu for NVIDIA Hopper (H100).

The module layout mirrors ``medgp_tpu/``: each module here is the
counterpart of the JAX module at the same path. This package imports
``torch`` and never ``jax`` or ``medgp_tpu`` (which would pull in jax); the
host code the port needs is carried here in its own copy.

Ported so far: the test stage in ``mean_wo_update`` mode (online
one-step-ahead imputation with a given mode kernel), with the three TPU
kernels on its path written by hand in CUDA (``csrc/``): the LMC-SM gram
(K1), the fused Cholesky + solve (K3) and the triangular inverse (K5).
"""

import torch

# The port computes in full float32 on the card. PyTorch's float32 matmul is
# already full precision by default, but convolutions default to TF32 (about
# three decimal digits), which the factorization tolerances (L to 1e-5,
# alpha and L^{-1} to 1e-4) would not survive. Both are set here, where the
# port initialises, so no path of the port runs in TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
