"""Process-group and mesh set-up for the port's multi-device lanes
(counterpart of ``repro.launch.mesh``'s lane mesh), and the one-card
training and serving launchers (``launch.train``, ``launch.serve``,
``launch.steps``) and the input-shape table (``launch.shapes``)."""
from .mesh import init_lane_group, make_lane_mesh  # noqa: F401
