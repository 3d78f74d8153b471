"""Layout search: enumerate mesh factorizations, prune, rank.

The port of ``kubedl_tpu/planner/search.py``, rule for rule: the same
candidate order, pruning, simplicity slack and rank keys, so the same
model on the same slice ranks the same layouts first.

The candidate space is every factorization of the slice's chips into the
``MeshSpec.AXIS_ORDER`` batch/model axes the trainer supports today —
(data, fsdp, sp, tensor) — with multislice handled by pinning the
``replica`` axis to ``num_slices``: DCN-crossing axes may only be
outermost, and the slice boundary IS the outermost stride of the device
grid, so exactly one axis (replica, first in AXIS_ORDER) may span it.

Pruning is structural (divisibility the trainer would reject anyway) then
physical (per-chip HBM); survivors are ranked by modeled step time with a
deterministic tie-break that prefers simpler, more data-parallel layouts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from kubedl_tpu_torch.api.topology import MeshSpec, SliceTopology
from kubedl_tpu_torch.planner.costmodel import (
    CostBreakdown, ModelDesc, estimate,
)


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _structurally_valid(
    model: ModelDesc, data: int, fsdp: int, sp: int, tensor: int,
    num_slices: int,
) -> bool:
    dp_total = num_slices * data * fsdp
    # every gradient replica needs at least one whole sequence per step
    if model.global_batch % dp_total:
        return False
    # megatron splits attention heads / ffn columns across tensor ranks
    if model.hidden and tensor > 1 and model.hidden % tensor:
        return False
    # ring attention splits the sequence
    if sp > 1 and model.seq_len % sp:
        return False
    # fsdp shards the parameter pytree leaf-wise; one chip per shard floor
    if model.hidden and fsdp > 1 and model.hidden % fsdp:
        return False
    return True


def enumerate_layouts(
    model: ModelDesc, topo: SliceTopology, num_slices: int = 1
) -> List[MeshSpec]:
    """All structurally-valid factorizations of ``num_slices x chips``.

    The replica axis is exactly ``num_slices`` (DCN only ever carries the
    outermost axis); the per-slice chips factor into data/fsdp/sp/tensor.
    """
    chips = topo.chips
    out: List[MeshSpec] = []
    for data in _divisors(chips):
        rem_d = chips // data
        for fsdp in _divisors(rem_d):
            rem_f = rem_d // fsdp
            for sp in _divisors(rem_f):
                tensor = rem_f // sp
                if not _structurally_valid(
                    model, data, fsdp, sp, tensor, num_slices
                ):
                    continue
                axes = {}
                if num_slices > 1:
                    axes["replica"] = num_slices
                axes["data"] = data
                if fsdp > 1:
                    axes["fsdp"] = fsdp
                if sp > 1:
                    axes["sp"] = sp
                if tensor > 1:
                    axes["tensor"] = tensor
                out.append(MeshSpec(axes=axes))
    return out


@dataclass
class SearchResult:
    #: feasible candidates, best (lowest modeled step time) first
    ranked: List[CostBreakdown] = field(default_factory=list)
    #: every candidate priced, including memory-infeasible ones
    evaluated: int = 0
    #: infeasible candidates kept for diagnostics (reason populated)
    infeasible: List[CostBreakdown] = field(default_factory=list)

    @property
    def best(self) -> CostBreakdown:
        return self.ranked[0]


#: A layout must beat the simplest alternative by MORE than this to win:
#: within max(1% of best, 0.5 ms) every candidate is "as fast as the
#: best" and the tie-break below picks the simplest — the cost model's
#: µs-scale noise must never talk a job out of plain data parallelism.
SLACK_RELATIVE = 0.01
SLACK_ABS_MS = 0.5


def _simplicity_key(c: CostBreakdown):
    ax = c.mesh.axes
    model_axes = sum(
        1 for a in ("fsdp", "sp", "tensor") if ax.get(a, 1) > 1
    )
    # fewer model-parallel axes, then more data parallelism, then the
    # smaller tensor degree — deterministic regardless of enumeration order
    return (
        model_axes, -ax.get("data", 1),
        ax.get("tensor", 1), ax.get("fsdp", 1), ax.get("sp", 1),
        round(c.step_ms, 6),
    )


def _rank_key(c: CostBreakdown):
    return (round(c.step_ms, 6),) + _simplicity_key(c)


def search(
    model: ModelDesc,
    topo: SliceTopology,
    num_slices: int = 1,
    efficiency: Optional[float] = None,
) -> SearchResult:
    """Enumerate, price, prune, rank. ``efficiency`` overrides the cost
    model's MODEL_FLOPS_EFFICIENCY (bench-calibrated MFU at admission)."""
    res = SearchResult()
    for mesh in enumerate_layouts(model, topo, num_slices):
        cost = estimate(model, topo, mesh, num_slices, efficiency=efficiency)
        res.evaluated += 1
        (res.ranked if cost.feasible else res.infeasible).append(cost)
    res.ranked.sort(key=_rank_key)
    if res.ranked:
        # simplest-within-slack wins the top spot (see SLACK_* above)
        best_ms = res.ranked[0].step_ms
        cut = max(best_ms * (1 + SLACK_RELATIVE), best_ms + SLACK_ABS_MS)
        near = [c for c in res.ranked if c.step_ms <= cut]
        near.sort(key=_simplicity_key)
        rest = [c for c in res.ranked if c not in near]
        res.ranked = near + rest
    return res


__all__ = ["enumerate_layouts", "SearchResult", "search", "SLACK_RELATIVE",
           "SLACK_ABS_MS"]
