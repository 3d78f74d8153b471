"""Per-device peak rates the trainer reads for MFU and its step-time floor,
and the logical mesh a job asks for.

The port's own small counterpart of what the trainer needs from
``kubedl_tpu/api/topology.py``: ``peak_flops_for_device_kind`` and
``hbm_bandwidth_for_device_kind`` (``:153-160``), keyed by the CUDA device
name
(``torch.cuda.get_device_name``). The values are NVIDIA data-sheet
figures for the H100 SXM at its full 700 W power limit: 989 TFLOP/s dense
bf16 on the tensor cores and 3.35 TB/s of HBM3. Anything else, the CPU
included, is 0.0 (MFU and the floor are then not computed). And a copy of
:class:`MeshSpec` (``:173-231``), the ``KUBEDL_MESH_AXES`` hint's parser.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

#: (substring of the device name, peak dense bf16 FLOP/s, HBM bytes/s)
#: — NVIDIA H100 SXM data sheet
_DEVICE_KINDS = (
    ("H100 80GB HBM3", 989e12, 3.35e12),
    ("H100 SXM", 989e12, 3.35e12),
)


def _lookup(kind: str, column: int) -> float:
    for sub, *rates in _DEVICE_KINDS:
        if sub.lower() in (kind or "").lower():
            return rates[column]
    return 0.0


def peak_flops_for_device_kind(kind: str) -> float:
    """Per-device peak dense bf16 FLOP/s (MFU accounting); 0.0 if unknown."""
    return _lookup(kind, 0)


def hbm_bandwidth_for_device_kind(kind: str) -> float:
    """Per-device memory bandwidth in bytes/s (the step-time floor); 0.0
    if unknown."""
    return _lookup(kind, 1)


@dataclass
class MeshSpec:
    """Logical mesh laid over one or more slices: the ``KUBEDL_MESH_AXES``
    env hint (``"data=2,tensor=4"``), which
    :mod:`kubedl_tpu_torch.parallel.mesh` turns into process groups. Axis
    order is outermost-first: the axes that cross hosts (replica, data)
    first, the bandwidth-hungry ones (tensor) last."""

    axes: Dict[str, int] = field(default_factory=dict)

    #: outermost-first. "sp" = sequence/context parallel, "pipe" =
    #: pipeline stages, "expert" = MoE expert parallel.
    AXIS_ORDER = ("replica", "data", "fsdp", "pipe", "expert", "sp", "tensor")

    def size(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= v
        return n

    def ordered(self) -> List[Tuple[str, int]]:
        known = [(a, self.axes[a]) for a in self.AXIS_ORDER if a in self.axes]
        extra = [(a, v) for a, v in self.axes.items()
                 if a not in self.AXIS_ORDER]
        return known + extra

    def to_env(self) -> str:
        return ",".join(f"{a}={v}" for a, v in self.ordered())

    @classmethod
    def from_env(cls, s: str) -> "MeshSpec":
        axes: Dict[str, int] = {}
        for part in filter(None, (p.strip() for p in s.split(","))):
            k, _, v = part.partition("=")
            axes[k] = int(v)
        return cls(axes=axes)


__all__ = ["peak_flops_for_device_kind", "hbm_bandwidth_for_device_kind",
           "MeshSpec"]
