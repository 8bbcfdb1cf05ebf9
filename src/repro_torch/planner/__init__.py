"""Auto-sharding planner (port of ``repro/planner/``).

Public surface: enumerate the (pipe × data × model) layout space
(:func:`enumerate_layouts`), price and rank it with no trace beyond one
base query (:class:`LayoutPlanner` → :class:`LayoutPlan`), each layout's
mesh vetted by :func:`repro_torch.launch.mesh.validate_mesh_spec`;
the launcher's ``--auto-mesh`` builds the chosen one
(:func:`repro_torch.launch.mesh.make_mesh`) over the job's ranks.
CLI: ``python -m repro_torch.planner plan|explain``.
"""

from repro_torch.planner.layouts import MeshLayout, enumerate_layouts
from repro_torch.planner.planner import (
    LayoutDecision,
    LayoutPlan,
    LayoutPlanner,
    LayoutRefusal,
)

__all__ = [
    "MeshLayout",
    "enumerate_layouts",
    "LayoutDecision",
    "LayoutRefusal",
    "LayoutPlan",
    "LayoutPlanner",
]
