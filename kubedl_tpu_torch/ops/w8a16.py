"""Weight-only int8 matmul (W8A16): ``y = h @ deq(w)`` without ever
writing the dequantized weight.

The reference gets this pass from XLA, not from a Pallas kernel: its
``h @ deq(w)`` (``kubedl_tpu/models/llama.py:300-304``, ``:332-337``)
fuses ``convert + scale`` into the dot, so device memory reads one byte
a weight. Dequantize-then-``torch.matmul`` would read one byte, write
two and read two again, and int8 would serve slower than bf16; so the
port writes the fused pass by hand (``csrc/w8a16.cu``).

What it computes, for ``h [..., K]`` and an int8 leaf ``(q8, s8)``::

    W[k, n] = float(q8[k, n]) * float(s8[n])   # exact in float32,
              rounded once to h's dtype          # = deq(w, h.dtype)
    y[..., n] = sum_k h[..., k] * W[k, n]      # fp32 sums, y in h's dtype

``q8`` is int8 ``[K, N]`` with ``s8`` bf16 ``[1, N]`` (a layer weight,
its scale over the contraction axis), or, with ``transposed``, int8
``[N, K]`` with ``s8 [N, 1]`` read as its transpose (a tied embedding as
the lm head: per-row scales). For bf16 ``h`` the product runs on the
tensor cores (``mma.sync`` bf16 on the bf16-rounded weight, fp32 sums);
for float32 ``h`` the weight stays the exact float32 product and the
FMAs are float32 (no TF32). That is what the reference computes where it
runs compiled (its engine jits every model function): XLA's excess
precision drops ``deq``'s bf16 rounding when a float32 dot consumes it —
except through the tied head, ``deq(embed).T``, where the compiled
reference keeps the bf16 rounding; so does the port (``transposed``).

Two implementations behind :func:`w8a16_matmul`, picked by where the
tensors live: CPU tensors take the plain version
(:func:`plain_w8a16_matmul`, ``h @ deq(w)``), CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import torch

#: op calls that launched the kernel (one per call), read by a run to
#: show its main path went through it
LAUNCHES = {"w8a16": 0}

#: the kernel loads 16-byte chunks: K and N must be multiples of 16
ALIGN = 16


def deq_weight(q8: torch.Tensor, s8: torch.Tensor, dtype,
               transposed: bool = False) -> torch.Tensor:
    """The dequantized weight ``[K, N]``: the exact product rounded once
    to ``dtype`` (through bf16 for the tied head, see above)."""
    w = q8.to(torch.float32) * s8.to(torch.float32)
    if transposed:
        return w.to(torch.bfloat16).to(dtype).T
    return w.to(dtype)


def plain_w8a16_matmul(h: torch.Tensor, q8: torch.Tensor, s8: torch.Tensor,
                       transposed: bool = False) -> torch.Tensor:
    """The plain version: dequantize to ``h``'s dtype, then matmul."""
    return h @ deq_weight(q8, s8, h.dtype, transposed)


def _dtype_code(dtype) -> int:
    return 1 if dtype == torch.bfloat16 else 0


def _check(h, q8, s8, transposed):
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w8a16: h must be bf16 or float32, got {h.dtype}")
    if q8.dtype != torch.int8 or s8.dtype != torch.bfloat16:
        raise ValueError(
            f"w8a16: want int8 q8 and bf16 s8, got {q8.dtype} / {s8.dtype}")
    if q8.dim() != 2:
        raise ValueError(f"w8a16: q8 must be 2-D, got {tuple(q8.shape)}")
    N, K = q8.shape if transposed else (q8.shape[1], q8.shape[0])
    want_s = (N, 1) if transposed else (1, N)
    if tuple(s8.shape) != want_s:
        raise ValueError(f"w8a16: s8 must be {want_s}, got {tuple(s8.shape)}")
    if h.shape[-1] != K:
        raise ValueError(f"w8a16: h's last dim {h.shape[-1]} != K={K}")
    for name, t in (("h", h), ("q8", q8), ("s8", s8)):
        if t.device != h.device:
            raise ValueError(f"w8a16: {name} on {t.device}, h on {h.device}")
    return N, K


def _cuda_launch(h, q8, s8, transposed):
    from kubedl_tpu_torch.ops.build import check_launch, load_w8a16_kernels

    N, K = _check(h, q8, s8, transposed)
    if K % ALIGN or N % ALIGN:
        raise ValueError(
            f"w8a16 kernel needs K and N multiples of {ALIGN}, got K={K}, "
            f"N={N}")
    if not (q8.is_contiguous() and s8.is_contiguous()):
        raise ValueError("w8a16 kernel needs contiguous q8 and s8")
    lead = h.shape[:-1]
    h2 = h.reshape(-1, K).contiguous()
    if h2.data_ptr() % 16:  # a view at an odd offset: the kernel loads 16 B
        h2 = h2.clone()
    if q8.data_ptr() % 16:
        raise ValueError("w8a16 kernel needs q8 aligned to 16 bytes")
    M = h2.shape[0]
    y = torch.empty((M, N), dtype=h.dtype, device=h.device)
    if M == 0:
        return y.reshape(*lead, N)
    lib = load_w8a16_kernels()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.kdl_w8a16_matmul(
            h2.data_ptr(), q8.data_ptr(), s8.data_ptr(), y.data_ptr(),
            M, N, K, int(bool(transposed)), _dtype_code(h.dtype), stream,
        )
    check_launch(err, "w8a16_matmul")
    LAUNCHES["w8a16"] += 1
    return y.reshape(*lead, N)


def w8a16_matmul(h: torch.Tensor, q8: torch.Tensor, s8: torch.Tensor,
                 transposed: bool = False) -> torch.Tensor:
    """``h @ deq((q8, s8))`` (see the module docstring): the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if h.device.type == "cuda":
        return _cuda_launch(h, q8, s8, transposed)
    if h.device.type != "cpu":
        raise ValueError(f"unsupported device {h.device}")
    _check(h, q8, s8, transposed)
    return plain_w8a16_matmul(h, q8, s8, transposed)


__all__ = ["w8a16_matmul", "plain_w8a16_matmul", "deq_weight", "LAUNCHES"]
