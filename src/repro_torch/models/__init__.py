"""The LLM substrate's models, dense family (counterpart of
``repro.models``)."""
from . import attention, common, losses, model  # noqa: F401
from .model import LM, init_model, loss_fn, value_and_grad  # noqa: F401
