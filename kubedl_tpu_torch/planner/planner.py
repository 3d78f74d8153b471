"""plan(): the one-call entry the TPUJob controller uses.

The port of ``kubedl_tpu/planner/planner.py``: the same ``Plan`` (with
its annotation and summary), ``PlanError`` messages, baseline and search,
on the port's node shapes.

Wraps the search with timing, the naive pure-data-parallel baseline
comparison (the contract: the chosen layout is never modeled slower than
naive DP, and strictly beats it whenever DP is memory-infeasible), and an
annotation-friendly serialization the engine stamps on the job so a plan
is computed once per (topology, world size) — an elastic resize changes
the world size and naturally invalidates the cached verdict.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Optional

from kubedl_tpu_torch.api.topology import MeshSpec, SliceTopology
from kubedl_tpu_torch.planner.costmodel import (
    CostBreakdown, ModelDesc, estimate,
)
from kubedl_tpu_torch.planner.search import SearchResult, search


class PlanError(Exception):
    """No memory-feasible layout exists for this model on this slice
    shape; the engine fails the job with reason PlanInfeasible."""


@dataclass
class Plan:
    """The planner's verdict for one (model, topology, world size)."""

    mesh: MeshSpec
    topology: str
    num_slices: int
    step_time_ms: float
    compute_ms: float
    comm_ms: float
    #: comm still on the critical path after the sharded-update overlap
    #: hides part of the gradient collective (== comm_ms when overlap is
    #: not priced); step_time_ms = compute_ms + exposed_comm_ms
    exposed_comm_ms: float
    hbm_gib: float
    #: modeled step time of the naive pure-data-parallel layout; None when
    #: DP is infeasible (memory or batch divisibility) on this shape
    baseline_dp_ms: Optional[float]
    candidates_evaluated: int
    plan_ms: float  # host wall time plan() spent

    def to_annotation(self) -> str:
        """Compact JSON for the planned-mesh annotation (the re-plan cache
        key is (topology, slices))."""
        return json.dumps({
            "axes": self.mesh.to_env(),
            "topology": self.topology,
            "slices": self.num_slices,
            "step_ms": round(self.step_time_ms, 3),
            "hbm_gib": round(self.hbm_gib, 3),
        }, sort_keys=True)

    def summary(self) -> str:
        base = (
            f"dp baseline {self.baseline_dp_ms:.1f} ms"
            if self.baseline_dp_ms is not None
            else "dp baseline infeasible"
        )
        return (
            f"mesh [{self.mesh.to_env()}] on {self.num_slices}x"
            f"{self.topology}: predicted step {self.step_time_ms:.1f} ms "
            f"({self.compute_ms:.1f} compute + {self.exposed_comm_ms:.1f} "
            f"exposed of {self.comm_ms:.1f} comm), "
            f"{self.hbm_gib:.1f} GiB/chip HBM; {base}; "
            f"{self.candidates_evaluated} candidates in {self.plan_ms:.1f} ms"
        )


def dp_baseline(
    model: ModelDesc,
    topo: SliceTopology,
    num_slices: int = 1,
    efficiency: Optional[float] = None,
) -> CostBreakdown:
    """Price the naive layout planning replaces: pure data parallel over
    every chip (replica across slices) — exactly what
    ``MeshSpec.for_slice`` defaults to."""
    mesh = MeshSpec.for_slice(topo, num_slices=num_slices)
    cost = estimate(model, topo, mesh, num_slices, efficiency=efficiency)
    if cost.feasible and model.global_batch % (topo.chips * num_slices):
        # structurally illegal (each gradient replica needs >= 1 sequence):
        # the search would never emit it, so the baseline must not claim it
        cost.feasible = False
        cost.reason = (
            f"global_batch {model.global_batch} not divisible by "
            f"{topo.chips * num_slices} data-parallel ranks"
        )
    return cost


def plan(
    model: ModelDesc,
    topo: SliceTopology,
    num_slices: int = 1,
    efficiency: Optional[float] = None,
) -> Plan:
    """Search the layout space and return the best feasible plan.

    ``efficiency`` overrides the cost model's flops-efficiency constant —
    the controller passes ``calibrated_flops_efficiency()[0]`` so
    admission-time estimates track measured bench MFU. Raises
    :class:`PlanError` when nothing fits — the model cannot train on this
    slice shape under any supported sharding.
    """
    t0 = time.perf_counter()
    errs = model.validate()
    if errs:
        raise PlanError("; ".join(errs))
    res: SearchResult = search(
        model, topo, max(num_slices, 1), efficiency=efficiency
    )
    plan_ms = (time.perf_counter() - t0) * 1e3
    if not res.ranked:
        worst = min(
            (c.hbm_gib for c in res.infeasible), default=0.0
        )
        raise PlanError(
            f"no memory-feasible layout for {model.num_params():,} params "
            f"on {max(num_slices, 1)}x{topo.name} "
            f"({topo.hbm_gib_per_chip} GiB/chip; best candidate still "
            f"needs {worst:.1f} GiB/chip)"
        )
    best = res.best
    base = dp_baseline(model, topo, max(num_slices, 1), efficiency=efficiency)
    return Plan(
        mesh=best.mesh,
        topology=topo.name,
        num_slices=max(num_slices, 1),
        step_time_ms=best.step_ms,
        compute_ms=best.compute_ms,
        comm_ms=best.comm_ms,
        exposed_comm_ms=best.exposed_comm_ms,
        hbm_gib=best.hbm_gib,
        baseline_dp_ms=base.step_ms if base.feasible else None,
        candidates_evaluated=res.evaluated,
        plan_ms=plan_ms,
    )


__all__ = ["Plan", "PlanError", "dp_baseline", "plan"]
