"""The oracles of the kernels (counterpart of ``repro.kernels.ref``): one
name per kernel, bound to that kernel's plain PyTorch version. Nothing
here computes anything of its own.

``fused_matvec``, ``bell_matvec``, ``gql_update`` and
``flash_attention`` are the reference module's names; the port adds the
three kernels that the reference holds to other oracles in its tests
(``bell_matvec_mrhs``, ``fused_step_dense``, ``fused_step_bell``).
"""
from __future__ import annotations

from .bilinear_matvec import fused_matvec_plain as fused_matvec
from .flash_attention import flash_attention_plain as flash_attention
from .gql_update import gql_update_plain as gql_update
from .lanczos_step import fused_step_bell_plain as fused_step_bell
from .lanczos_step import fused_step_dense_plain as fused_step_dense
from .spmv_bell import bell_matvec_mrhs_plain as bell_matvec_mrhs
from .spmv_bell import bell_matvec_plain as bell_matvec

__all__ = ["fused_matvec", "bell_matvec", "bell_matvec_mrhs", "gql_update",
           "fused_step_dense", "fused_step_bell", "flash_attention"]
