"""Optimizers (counterpart of ``repro.optim``; gradient compression waits
for data-parallel training, ROADMAP Queue 1)."""
from .adamw import AdamW, AdamWState, warmup_cosine  # noqa: F401
