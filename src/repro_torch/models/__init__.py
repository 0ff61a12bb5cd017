"""The LLM substrate's models, dense family (counterpart of
``repro.models``)."""
from . import attention, common, losses, model  # noqa: F401
from .model import LM, decode_step, init_model, loss_fn, make_caches, \
    prefill, value_and_grad  # noqa: F401
