"""Hand-written Hopper kernels, each beside its plain PyTorch version:

  K1 ``gql_update``        (``csrc/gql_update.cu``)       Alg. 5 recurrence
  K2 ``bell_matvec``       (``csrc/bell.cu``)             blocked-ELL SpMV
  K3 ``fused_step_dense``  (``csrc/dense_step.cu``)       fused step, dense A
  K4 ``fused_step_bell``   (``csrc/bell.cu``)             fused step, BELL A
  K5 ``bell_matvec_mrhs``  (``csrc/bell_mrhs.cu``)        blocked-ELL SpMM
  K6 ``fused_matvec``      (``csrc/bilinear_matvec.cu``)  y = A x, x^T A x
  K7 ``flash_attention``   (``csrc/flash_attention.cu``)  attention forward

``ops`` routes a CPU tensor to the plain version and a CUDA tensor to the
kernel (or raises). Kernels build at first CUDA use (``_build``); nothing
is compiled or imported from ``triton``/``nvcc`` when the package loads.
"""
from . import ops  # noqa: F401
from .ops import LAUNCHES, reset_launches  # noqa: F401
