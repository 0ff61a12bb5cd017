"""Process-group and mesh set-up (counterpart of ``repro.launch.mesh``:
the model meshes and the lane mesh), the training and serving launchers
(``launch.train``, ``launch.serve``, ``launch.steps``), the input-shape
table (``launch.shapes``), the dry-run of every (arch x shape) cell on a
fake 256- or 512-rank mesh (``launch.dryrun``) and the roofline report
over its records (``launch.roofline``)."""
from .mesh import (data_axes_for, init_lane_group,  # noqa: F401
                   make_host_mesh, make_lane_mesh, make_production_mesh)
