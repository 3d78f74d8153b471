"""Node-shape catalog, per-device peak rates and logical mesh specs.

The port of ``kubedl_tpu/api/topology.py``, with the same interface:
:class:`SliceTopology` (``host_mesh`` / ``coordinates``),
``SLICE_CATALOG``, :func:`get_slice`, :func:`peak_flops_for_device_kind`
and :func:`hbm_bandwidth_for_device_kind` (read off the catalog, keyed by
the CUDA device name, ``torch.cuda.get_device_name``), :class:`MeshSpec`
(the ``KUBEDL_MESH_AXES`` hint; ``for_slice``) and
:func:`validate_mesh_for_slice`.

What a "slice" is here: one NVLink domain of NVIDIA H100 SXM cards, the
unit the planner lays a mesh over (the reference's ICI domain). One host
holds eight cards joined all to all by NVLink (the DGX H100 layout), so
``h100-1`` / ``-2`` / ``-4`` / ``-8`` are one host's cards; several nodes
are ``num_slices``, whose outermost ``replica`` axis crosses InfiniBand
as the reference's crosses DCN. ``ici_gbps`` is then the card's NVLink
rate and ``dcn_gbps`` its share of the InfiniBand fabric. The reference's
``cpu-1`` / ``cpu-8`` stand-ins stay for tests and local clusters; its
TPU generations are not the port's hardware and are left out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class SliceTopology:
    """One atomically-schedulable slice (here: one NVLink domain)."""

    name: str  # e.g. "h100-8"
    chips: int
    hosts: int  # processes' hosts per slice
    chips_per_host: int
    physical_mesh: Tuple[int, ...]  # device grid, e.g. (8,)
    #: Per-device peak dense bf16 TFLOP/s — MFU accounting, not scheduling.
    peak_bf16_tflops: float = 989.0
    hbm_gib_per_chip: float = 79.18
    #: Per-device HBM bandwidth GB/s (data sheet) — the step-time floor.
    hbm_gbps: float = 3350.0
    #: Per-device bandwidth GB/s inside the slice, one direction — prices
    #: intra-slice collectives in the planner's cost model
    #: (kubedl_tpu_torch/planner/costmodel.py).
    ici_gbps: float = 450.0
    #: Per-device bandwidth GB/s between slices — prices the slice-crossing
    #: (replica) axis, the only one allowed to cross.
    dcn_gbps: float = 50.0

    @property
    def total_devices(self) -> int:
        return self.chips

    def coordinates(self, host_index: int) -> Tuple[int, ...]:
        """Host coordinate within the slice's host grid (row-major)."""
        hosts_mesh = self.host_mesh()
        coord = []
        rem = host_index
        for dim in reversed(hosts_mesh):
            coord.append(rem % dim)
            rem //= dim
        return tuple(reversed(coord))

    def host_mesh(self) -> Tuple[int, ...]:
        """Host grid: physical mesh divided by the per-host device block
        (the reference's rule: factors of 2 peeled round-robin across the
        dims, last dim first, then any remainder)."""
        rem = self.chips_per_host
        dims = list(self.physical_mesh)
        i = len(dims) - 1
        stuck = 0
        while rem > 1 and stuck < len(dims):
            if dims[i] % 2 == 0:
                dims[i] //= 2
                rem //= 2
                stuck = 0
            else:
                stuck += 1
            i = (i - 1) % len(dims)
        if rem > 1:  # non-power-of-two remainder: divide any divisible dim
            for j, d in enumerate(dims):
                g = math.gcd(d, rem)
                dims[j] //= g
                rem //= g
        return tuple(dims)


#: Catalog of schedulable slice shapes.
SLICE_CATALOG: Dict[str, SliceTopology] = {}


def _register(*topos: SliceTopology) -> None:
    for t in topos:
        SLICE_CATALOG[t.name] = t


#: The H100 SXM figures, from NVIDIA's H100 data sheet (SXM part, dense
#: rates at the 700 W limit): 989 TFLOP/s bf16 on the tensor cores, 3.35
#: TB/s of HBM3, NVLink 4 at 900 GB/s a card, 450 each way; and the DGX
#: H100 layout: eight cards a host on NVLink, one 400 Gb/s InfiniBand NIC
#: a card (50 GB/s) between hosts. HBM: the 80 GB card's capacity as
#: ``torch.cuda.get_device_properties(0).total_memory`` reports it on an
#: "NVIDIA H100 80GB HBM3" (85,017,493,504 bytes = 79.18 GiB;
#: ``chip_smoke.py`` phase 35c holds it within 2 % of the card's).
H100_SXM = dict(peak_bf16_tflops=989.0, hbm_gib_per_chip=79.18,
                hbm_gbps=3350.0, ici_gbps=450.0, dcn_gbps=50.0)

_register(
    SliceTopology("h100-1", 1, 1, 1, (1,), **H100_SXM),
    SliceTopology("h100-2", 2, 1, 2, (2,), **H100_SXM),
    SliceTopology("h100-4", 4, 1, 4, (4,), **H100_SXM),
    SliceTopology("h100-8", 8, 1, 8, (8,), **H100_SXM),
    # CPU stand-in used by tests / kind-style local clusters (the
    # reference's entries, value for value)
    SliceTopology("cpu-1", 1, 1, 1, (1,), 0.5, 8.0, 50.0, 1.0, 0.5),
    SliceTopology("cpu-8", 8, 8, 1, (8,), 0.5, 8.0, 50.0, 1.0, 0.5),
)


#: device-name substrings (as ``torch.cuda.get_device_name`` reports them)
#: -> catalog generation token
_DEVICE_KIND_ALIASES = {
    "h100 80gb hbm3": "h100",
    "h100 sxm": "h100",
}


def _catalog_lookup(kind: str, getter) -> float:
    """Resolve a device name to a per-device spec value via the slice
    catalog (the single source of hardware numbers); 0.0 for the CPU and
    unknown kinds."""
    kind = (kind or "").lower()
    gens = {t.name.split("-")[0]: getter(t) for t in SLICE_CATALOG.values()}
    for sub, gen in _DEVICE_KIND_ALIASES.items():
        if sub in kind and gen in gens:
            return gens[gen]
    return 0.0


def peak_flops_for_device_kind(kind: str) -> float:
    """Per-device peak dense bf16 FLOP/s (MFU accounting); 0.0 if unknown."""
    return _catalog_lookup(kind, lambda t: t.peak_bf16_tflops * 1e12)


def hbm_bandwidth_for_device_kind(kind: str) -> float:
    """Per-device memory bandwidth in bytes/s (the step-time floor); 0.0
    if unknown."""
    return _catalog_lookup(kind, lambda t: t.hbm_gbps * 1e9)


def get_slice(name: str) -> SliceTopology:
    try:
        return SLICE_CATALOG[name]
    except KeyError:
        raise KeyError(
            f"unknown slice type {name!r}; known: {sorted(SLICE_CATALOG)}"
        ) from None


@dataclass
class MeshSpec:
    """Logical mesh laid over one or more slices: the ``KUBEDL_MESH_AXES``
    env hint (``"data=2,tensor=4"``), which
    :mod:`kubedl_tpu_torch.parallel.mesh` turns into process groups. Axis
    order is outermost-first: the axes that cross slices (replica, data)
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

    @classmethod
    def for_slice(
        cls, topo: SliceTopology, tensor: int = 1, num_slices: int = 1
    ) -> "MeshSpec":
        """Default mesh: pure data parallel over the devices, optionally
        carving a tensor axis out of the fastest dimension; several slices
        add an outer replica axis."""
        chips = topo.chips * num_slices
        if chips % tensor:
            raise ValueError(f"tensor={tensor} does not divide {chips} chips")
        axes: Dict[str, int] = {}
        if num_slices > 1:
            axes["replica"] = num_slices
            chips //= num_slices
        axes["data"] = chips // tensor
        if tensor > 1:
            axes["tensor"] = tensor
        return cls(axes=axes)


def validate_mesh_for_slice(
    mesh: MeshSpec, topo: SliceTopology, num_slices: int = 1
) -> Optional[str]:
    """Return an error message if the logical mesh cannot tile the slice
    (checked at admission, so a bad mesh is rejected on submit)."""
    for axis, size in mesh.axes.items():
        if axis not in MeshSpec.AXIS_ORDER:
            return (
                f"unknown mesh axis {axis!r}; known axes: "
                + ", ".join(MeshSpec.AXIS_ORDER)
            )
        if size < 1:
            return f"mesh axis {axis}={size} must be >= 1"
    want = topo.chips * num_slices
    if mesh.size() != want:
        return f"mesh covers {mesh.size()} devices but topology has {want} chips"
    return None


__all__ = ["SliceTopology", "SLICE_CATALOG", "H100_SXM", "get_slice",
           "peak_flops_for_device_kind", "hbm_bandwidth_for_device_kind",
           "MeshSpec", "validate_mesh_for_slice"]
