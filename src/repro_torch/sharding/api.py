"""Logical-axis placement for the quadrature lanes (counterpart of
``repro.sharding.api``'s ``Plan`` / ``lane_plan`` / ``lane_sharding``).

A ``Plan`` maps logical axis names to mesh axes. The lane plan maps the
``lanes`` axis, the leading axis of stacked queries, masks and
thresholds, onto the 1-D mesh of ``launch.make_lane_mesh``; every other
axis, and the operator's shared leaves, are replicated. The model plans
(``tp_plan`` and the parameter rules) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Plan:
    """Logical axis -> mesh axis (or None: replicated)."""
    rules: dict

    def mesh_axes(self, logical: Optional[str]):
        return self.rules.get(logical) if logical else None


def lane_plan(mesh_axis: str = "lanes") -> Plan:
    """The plan of the lane axis (DESIGN.md Sec. 7): ``lanes`` on the
    lane mesh's axis, everything else replicated."""
    return Plan(rules={"lanes": mesh_axis})


def lane_sharding(mesh, *, ndim: int = 2, plan: Optional[Plan] = None):
    """The placement of a lane-stacked (K, ...) array of rank ``ndim`` on
    ``mesh``: a tuple with one entry per mesh dimension, ``Shard(0)``
    (the leading lane dim split over the lane axis, trailing dims whole)
    where the plan maps ``lanes`` to that dimension, ``Replicate()``
    elsewhere. The form ``torch.distributed.tensor.distribute_tensor``
    takes."""
    from torch.distributed.tensor import Replicate, Shard

    if ndim < 1:
        raise ValueError(f"a lane-stacked array has ndim >= 1, got {ndim}")
    plan = lane_plan() if plan is None else plan
    axis = plan.mesh_axes("lanes")
    names = mesh.mesh_dim_names or ()
    if axis is not None and axis not in names:
        raise ValueError(f"the plan puts lanes on {axis!r}, which is not "
                         f"an axis of the mesh {names}")
    return tuple(Shard(0) if name == axis else Replicate()
                 for name in names)
