"""Serving, PyTorch port (counterpart of ``repro.serve``): the
quadrature-serving ``BIFEngine`` and the KV-cache block rankers of
``kv_select``, and the LLM ``Engine`` (prefill and decode with KV
caches) of the dense family."""
from .engine import BIFEngine, BIFRequest, Engine, Request, \
    flush_trace_count, generate_trace_count  # noqa: F401
from .kv_select import BlockRanker, apply_block_mask, pool_keys, \
    rank_blocks, select_diverse_blocks  # noqa: F401
