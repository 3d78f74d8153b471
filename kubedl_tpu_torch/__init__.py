"""PyTorch / CUDA port of kubedl-tpu for NVIDIA Hopper (H100).

The JAX package ``kubedl_tpu`` stays the reference; this package mirrors
its layout (``models/``, ``serving/``, ...) so every counterpart sits at
the same relative path. It imports ``torch``, numpy and the standard
library only — never ``jax`` and nothing of ``kubedl_tpu``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU with ``device="cpu"``; with no CUDA device and no explicit
CPU request they raise instead of falling back.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The port's device rule: ``None`` means CUDA, and a CUDA device that
    does not exist raises — the CPU runs only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["resolve_device"]
