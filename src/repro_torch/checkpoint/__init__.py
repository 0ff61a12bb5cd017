"""Checkpoints on the reference's layout (counterpart of
``repro.checkpoint``)."""
from . import io  # noqa: F401
