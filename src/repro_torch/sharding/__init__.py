"""Logical-axis placement rules of the port (counterpart of
``repro.sharding``): the lane plan only."""
from .api import Plan, lane_plan, lane_sharding  # noqa: F401
