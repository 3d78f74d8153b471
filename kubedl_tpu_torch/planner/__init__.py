"""Auto-parallelism planner: model description + slice topology -> MeshSpec.

AMP-style (PAPERS.md: arXiv 2210.07297): enumerate (data, fsdp, sequence,
tensor) layouts over the slice's chips, price each against an analytical
cost model of the ICI/DCN fabric, prune memory-infeasible candidates, and
rank by modeled step time. The winning layout rides the existing
``KUBEDL_MESH_AXES`` env contract into the workers; the engine stamps a
``Planned`` condition/event and re-plans on elastic resize (docs/planning.md).

The port of ``kubedl_tpu/planner/``: pure Python (no tensor work), safe
inside the operator; slices are the port's node shapes
(``kubedl_tpu_torch/api/topology.py``). It prices step time and HBM,
not money.
"""

from kubedl_tpu_torch.planner.costmodel import (  # noqa: F401
    CostBreakdown,
    ModelDesc,
    MODEL_ZOO,
    estimate,
)
from kubedl_tpu_torch.planner.planner import Plan, PlanError, dp_baseline, plan  # noqa: F401
from kubedl_tpu_torch.planner.search import enumerate_layouts, search  # noqa: F401
