"""Process-group and mesh set-up (counterpart of ``repro.launch.mesh``:
the model meshes and the lane mesh), the training and serving launchers
(``launch.train``, ``launch.serve``, ``launch.steps``) and the
input-shape table (``launch.shapes``)."""
from .mesh import (data_axes_for, init_lane_group,  # noqa: F401
                   make_host_mesh, make_lane_mesh, make_production_mesh)
