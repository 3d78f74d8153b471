"""Per-device peak rates the trainer reads for MFU and its step-time floor.

The port's own small counterpart of what the trainer needs from
``kubedl_tpu/api/topology.py:153-160`` (``peak_flops_for_device_kind``
and ``hbm_bandwidth_for_device_kind``), keyed by the CUDA device name
(``torch.cuda.get_device_name``). The values are NVIDIA data-sheet
figures for the H100 SXM at its full 700 W power limit: 989 TFLOP/s dense
bf16 on the tensor cores and 3.35 TB/s of HBM3. Anything else, the CPU
included, is 0.0 (MFU and the floor are then not computed).
"""

from __future__ import annotations

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


__all__ = ["peak_flops_for_device_kind", "hbm_bandwidth_for_device_kind"]
