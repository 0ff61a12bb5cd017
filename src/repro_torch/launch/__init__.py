"""Process-group and mesh set-up for the port's multi-device lanes
(counterpart of ``repro.launch.mesh``'s lane mesh), and the one-card
training launcher (``launch.train``, ``launch.steps``)."""
from .mesh import init_lane_group, make_lane_mesh  # noqa: F401
