"""The training loop and the GQL spectral monitor (counterpart of
``repro.train``)."""
from .loop import LoopConfig, LoopResult, train  # noqa: F401
from .monitor import (condition_number_bounds, fisher_proxy_bounds,  # noqa
                      gradient_sketch, logdet_bounds, make_monitor)
