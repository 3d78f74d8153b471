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
the lm head: per-row scales). For float32 ``h`` the weight stays the
exact float32 product and the FMAs are float32 (no TF32). That is what
the reference computes where it runs compiled (its engine jits every
model function): XLA's excess precision drops ``deq``'s bf16 rounding
when a float32 dot consumes it — except through the tied head,
``deq(embed).T``, where the compiled reference keeps the bf16 rounding;
so does the port (``transposed``).

Two implementations behind :func:`w8a16_matmul`, picked by where the
tensors live: CPU tensors take the plain version
(:func:`plain_w8a16_matmul`, ``h @ deq(w)``), CUDA tensors launch a
kernel or raise. Three routes, by :func:`w8a16_route` (mirrored by the
source's ``route_of``):

- ``"decode"`` (bf16, at most :data:`DECODE_MAX_M` rows): the swapped
  product ``y^T = W^T h^T`` on ``mma.sync`` over a ring of ``cp.async``
  copies: bound by the weight's bytes;
- ``"prefill"`` (bf16, more rows): ``wgmma`` with the dequantized weight
  as A from registers and ``h`` TMA-loaded as B: bound by the tensor
  cores;
- ``"cuda_core"`` (float32): float32 FMAs.

Where the tiles alone would leave SMs idle, a bf16 route splits K
(:func:`w8a16_split_plan`): float32 partials in a workspace the wrapper
allocates (once a stream), summed in split order by a second kernel, so
the same inputs give the same bits on every call.

Both bf16 routes dequantize with integer and bit operations (the int8
byte in a float32 magic number, the bf16 half taken, one bf16x2 multiply
by the scale), which gives ``deq_weight``'s bits exactly; see
``csrc/w8a16.cu``.
"""

from __future__ import annotations

import functools

import torch

from kubedl_tpu_torch.ops.build import (
    check_launch, float_workspace, load_w8a16_kernels, stream_handle,
)

#: op calls that launched a kernel (one per call), and per route, read by
#: a run to show its main path went through them
LAUNCHES = {"w8a16": 0, "w8a16_decode": 0, "w8a16_prefill": 0,
            "w8a16_cuda_core": 0}

#: the kernels load 16-byte chunks: K and N must be multiples of 16
ALIGN = 16

CUDA_CORE, DECODE, PREFILL = "cuda_core", "decode", "prefill"
#: route codes of the C entry points
_ROUTE_CODE = {CUDA_CORE: 0, DECODE: 1, PREFILL: 2}
_ROUTE_KEY = {r: f"w8a16_{r}" for r in _ROUTE_CODE}  # its LAUNCHES key
#: rows of bf16 h up to which the decode route is taken (the source's
#: kDecodeMaxM): decode's M=8 and speculative verify's 8 x 5 = 40 rows
DECODE_MAX_M = 64
#: the decode kernel's tile: weight columns a CTA, k rows a pipeline
#: stage (K-slices are multiples of it), h rows a CTA (the grid's z
#: covers more)
DEC_BN, DEC_BK, DEC_ROWS = 128, 128, 64
#: the prefill kernel's tile: weight columns a CTA, k a pipeline stage,
#: and its h rows, 128 up to PRE_WIDE_M rows of h and 256 above (the
#: source's kPreWideM), with the CTAs an SM holds at each
PRE_BN, PRE_BK, PRE_WIDE_M = 128, 64, 128
_PRE_TILE = {128: 2, 256: 1}  # rows a CTA -> CTAs an SM
#: SMs of an H100 SXM: the split plans fill them
SM_COUNT = 132


def w8a16_route(M: int, N: int, K: int, dtype,
                transposed: bool = False) -> str:
    """The kernel a CUDA call takes: ``"cuda_core"`` for float32 ``h``;
    for bf16 ``"decode"`` up to :data:`DECODE_MAX_M` rows, ``"prefill"``
    above. The same for both layouts and every ``N``, ``K``. Mirrors the
    source's ``route_of``."""
    del N, K, transposed
    if dtype != torch.bfloat16:
        return CUDA_CORE
    return DECODE if M <= DECODE_MAX_M else PREFILL


@functools.lru_cache(maxsize=4096)
def w8a16_split_plan(M: int, N: int, K: int, route: str = DECODE) -> tuple:
    """``(splits, k_slice, ws_shape)`` of a bf16 call on ``route``: ``K``
    cut into ``splits`` slices of ``k_slice`` (a multiple of the route's
    k-step, :data:`DEC_BK` or :data:`PRE_BK`; the last slice ends at
    ``K``, none is empty). Decode: enough slices that the grid of column
    strips x slices covers the SMs once, but no more than keeps the
    float32 partials (``splits * M * N * 4`` bytes) within the weight's
    ``K * N``. Prefill: as many as the SMs hold beside the grid's tiles
    (none once the tiles fill them). The workspace is float32
    ``ws_shape`` (empty with one slice: the kernel writes ``y`` itself).
    Shapes only, never data."""
    if route == DECODE:
        step = DEC_BK
        tiles = -(-N // DEC_BN) * -(-M // DEC_ROWS)
        want = min(-(-SM_COUNT // tiles), K // (4 * M))
    elif route == PREFILL:
        step = PRE_BK
        rows = 128 if M <= PRE_WIDE_M else 256
        tiles = -(-N // PRE_BN) * -(-M // rows)
        want = SM_COUNT * _PRE_TILE[rows] // tiles
    else:
        raise ValueError(f"w8a16: no split plan for route {route!r}")
    ksteps = -(-K // step)
    per = -(-ksteps // max(1, min(ksteps, want)))
    splits = -(-ksteps // per)
    return splits, per * step, ((splits, M, N) if splits > 1 else (0,))


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
    if q8.device != h.device or s8.device != h.device:
        raise ValueError(f"w8a16: q8 on {q8.device}, s8 on {s8.device}, h "
                         f"on {h.device}")
    return N, K


_LIB: list = []  # the kernel library, once loaded
#: the split-K workspace of each (device, stream): one allocation less a
#: call on the host-bound decode step
_WS: dict = {}


def _cuda_launch(h, q8, s8, transposed, route):
    if h.device.index != torch.cuda.current_device():
        with torch.cuda.device(h.device):  # the kernels launch on it
            return _cuda_launch(h, q8, s8, transposed, route)
    N, K = _check(h, q8, s8, transposed)
    if K % ALIGN or N % ALIGN:
        raise ValueError(
            f"w8a16 kernel needs K and N multiples of {ALIGN}, got K={K}, "
            f"N={N}")
    if not (q8.is_contiguous() and s8.is_contiguous()):
        raise ValueError("w8a16 kernel needs contiguous q8 and s8")
    if q8.data_ptr() % 16 or s8.data_ptr() % 4:
        raise ValueError("w8a16 kernel needs q8 aligned to 16 bytes and s8 "
                         "to 4")
    # h and y are read as row-major [M, K] and [M, N] whatever h's rank
    h2 = h if h.is_contiguous() else h.contiguous()
    if h2.data_ptr() % 16:  # a view at an odd offset: the kernels load 16 B
        h2 = h2.clone()
    M = h2.numel() // K
    y = torch.empty((*h.shape[:-1], N), dtype=h.dtype, device=h.device)
    if M == 0:
        return y
    want = w8a16_route(M, N, K, h.dtype, transposed)
    route = want if route is None else route
    if (route == CUDA_CORE) != (want == CUDA_CORE):
        raise ValueError(f"w8a16: route {route!r} cannot take {h.dtype} h")
    splits, k_slice, _ = ((1, K, None) if route == CUDA_CORE
                          else w8a16_split_plan(M, N, K, route))
    stream = stream_handle(h.device)
    ws = (float_workspace(_WS, h.device, stream, splits * M * N).data_ptr()
          if splits > 1 else None)
    if not _LIB:
        _LIB.append(load_w8a16_kernels())
    err = _LIB[0].kdl_w8a16_matmul(
        h2.data_ptr(), q8.data_ptr(), s8.data_ptr(), y.data_ptr(), ws, M, N,
        K, int(bool(transposed)), int(h.dtype == torch.bfloat16),
        _ROUTE_CODE[route], splits, k_slice, stream,
    )
    if err:
        check_launch(err, f"w8a16_matmul ({route})")
    LAUNCHES["w8a16"] += 1
    LAUNCHES[_ROUTE_KEY[route]] += 1
    return y


def w8a16_matmul(h: torch.Tensor, q8: torch.Tensor, s8: torch.Tensor,
                 transposed: bool = False, route=None) -> torch.Tensor:
    """``h @ deq((q8, s8))`` (see the module docstring): a kernel for
    CUDA tensors, the plain version for CPU tensors. ``route`` forces a
    bf16 kernel (``"decode"`` or ``"prefill"``) in place of
    :func:`w8a16_route`'s; for the card's tests and smoke run only."""
    if route is not None and route not in _ROUTE_CODE:
        raise ValueError(f"w8a16: unknown route {route!r}")
    if h.device.type == "cuda":
        return _cuda_launch(h, q8, s8, transposed, route)
    if h.device.type != "cpu":
        raise ValueError(f"unsupported device {h.device}")
    _check(h, q8, s8, transposed)
    return plain_w8a16_matmul(h, q8, s8, transposed)


__all__ = ["w8a16_matmul", "plain_w8a16_matmul", "deq_weight",
           "w8a16_route", "w8a16_split_plan", "LAUNCHES", "CUDA_CORE",
           "DECODE", "PREFILL", "DECODE_MAX_M"]
