"""Logical-axis placement rules of the port (counterpart of
``repro.sharding``): the model plan, the lane plan, and the activation
constraints."""
from .api import (Plan, activation_context, constrain,  # noqa: F401
                  lane_plan, lane_sharding, param_shardings, param_specs,
                  placements, spec_for_param, tp_plan)
