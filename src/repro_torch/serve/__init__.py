"""Serving, PyTorch port (counterpart of ``repro.serve``): the
quadrature-serving ``BIFEngine`` and the KV-cache block rankers of
``kv_select``. The LLM ``Engine`` waits for the LLM substrate."""
from .engine import BIFEngine, BIFRequest, flush_trace_count  # noqa: F401
from .kv_select import BlockRanker, apply_block_mask, pool_keys, \
    rank_blocks, select_diverse_blocks  # noqa: F401
