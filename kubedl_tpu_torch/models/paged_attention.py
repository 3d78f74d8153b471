"""Blocked paged attention: attend against the KV block pool directly.

Port of ``kubedl_tpu/models/paged_attention.py``. The gather path
(`llama._paged_view`) materializes each row's logical
``[B, MB*BS, KV, hd]`` cache view via ``pool[bt]`` before dense
attention; this module walks the block table instead, folding the pool
through an online softmax so the logical view never exists.

Two implementations behind ONE interface (:func:`paged_attention`),
picked by where the tensors live — never by a fallback:

- **plain** (CPU tensors): a PyTorch port of the reference's
  ``_lax_paged_attention`` (chunks of C blocks, C = the largest divisor
  of MB with C*BS <= tile keys, folded with :func:`_online_fold`) and
  ``_fused_write_lax``. The CPU tests hold it against the JAX function,
  and ``chip_smoke.py`` holds the kernels against it on the card.
- **kernel** (CUDA tensors): CUDA C++ written for Hopper
  (``csrc/paged_attention.cu``) behind two entry points,
  ``paged_attention_blocked`` (replaces the TPU ``_blocked_kernel``) and
  ``paged_attention_fused`` (replaces ``_fused_kernel``). Which kernel a
  call launches is a static route, :func:`paged_route` (the source's
  ``route_of`` is the same table), with no fallback between routes: a
  CUDA tensor launches its route's kernel or raises.

  - ``"split_k"``: every fused decode call, and any blocked call with
    R = S*group < 64 query rows a kv-head. Keys are split into
    :func:`split_plan` ranges, one CTA each (flash decoding); the splits'
    float32 partials (m, l, acc) go to a workspace the wrapper allocates
    and a second small kernel merges them (:func:`combine_splits` is the
    plain version of that merge). The plan depends on shapes only: the
    wrapper reads no device value, so a decode segment never syncs.
  - ``"tensor_core"``: bf16 prefill at hd 64/128 with R >= 64, the block
    size a multiple of 8 dividing 64 and the GQA group dividing 64: wgmma
    on TMA-staged tiles, each 64-key tile gathered block by block.
  - ``"cuda_core"``: the rest (float32 prefill, hd 256 prefill, other
    block sizes or groups).

Numerics contract (copied from the reference; the kernels keep it):

- Query s of row b sits at global position
  ``posq = min(starts[b] + s, MB*BS - 1)`` and sees pool keys at
  ``t <= posq``. For a decode step (S=1) that is ``t <= starts[b]``:
  the CURRENT token's K/V is attended — it was written into the pool at
  ``starts[b]`` before (or, fused, inside) the attention call. A
  reference that masks ``t < starts`` is off by one key.
- Masked scores are -1e30 and the running max is clamped at -1e29, so a
  FULLY masked chunk contributes exact zeros (``exp(-1e30 + 1e29)``
  underflows to 0.0) instead of ``exp(-1e30 - (-1e30)) = 1``. That is
  also what lets garbage in trash/unowned blocks contribute exactly 0.
- Softmax accumulates in float32; the output is ``acc / max(l, 1e-30)``
  cast to q's dtype. The online softmax reorders the reduction, so
  results are fp-close (~1e-6 in f32), not bit-identical, to the gather
  oracle; greedy tokens agree.

Fused KV write (decode, S=1): ``new_k``/``new_v`` ([B, KV, hd]) are
written at ``(bt[b, starts//BS], starts % BS)`` and ``(out, k_pool,
v_pool)`` is returned. Unlike the reference (which returns donated
copies), the port updates the pools IN PLACE and returns the same
tensors. Rows own their blocks exclusively; vacant rows all point at
the trash block 0, where colliding writes are garbage by contract.

The read-only ``self_k``/``self_v``/``self_mask`` verify modes belong to
speculative decoding, which is not ported yet: they raise
``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
#: running-max floor: a fully masked chunk folds in as exact zeros
M_FLOOR = -1e29

#: keys folded per plain-path step (the reference's measured default)
DEFAULT_TILE = 256

#: launches per entry point, counted by the wrappers where they launch (one
#: per op call, however many CUDA kernels the call runs) — a run reads them
#: to show its main path really went through the kernels
LAUNCHES = {"blocked": 0, "fused": 0}
#: the same op calls by the route they took (see :func:`paged_route`)
SPLIT_K, TENSOR_CORE, CUDA_CORE = "split_k", "tensor_core", "cuda_core"
ROUTE_LAUNCHES = {SPLIT_K: 0, TENSOR_CORE: 0, CUDA_CORE: 0}

#: head dims the CUDA kernels are compiled for
KERNEL_HEAD_DIMS = (64, 128, 256)
#: head dims whose bf16 prefill takes the tensor-core kernel
TENSOR_CORE_HEAD_DIMS = (64, 128)
#: the tensor-core kernel's keys a K/V tile: whole pool blocks, so the
#: block size divides it; the GQA group divides it too, so each 64-row
#: query tile holds whole sequence positions
TC_TILE_KEYS = 64
#: query rows (S*group) a kv-head from which a blocked call leaves split-K
SPLIT_MAX_ROWS = 64

#: SMs of an H100 SXM: the split-K grid is sized to fill them twice over
SM_COUNT = 132
#: split lengths are multiples of this (every split-K stage's key count
#: divides it) ...
SPLIT_QUANTUM = 32
#: ... and about this long when the key range, not the SM count, decides
SPLIT_TARGET_KEYS = 256


def paged_route(dtype, head_dim: int, S: int, group: int,
                block_size: int, fused: bool = False) -> str:
    """The kernel a CUDA call takes: ``"split_k"`` for a fused decode call
    or fewer than 64 query rows a kv-head; ``"tensor_core"`` for bf16 at
    hd 64/128 whose block size is a multiple of 8 dividing 64 and whose
    group divides 64; ``"cuda_core"`` for the rest. Mirrors the source's
    ``route_of``."""
    if fused or S * group < SPLIT_MAX_ROWS:
        return SPLIT_K
    if (dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS
            and block_size % 8 == 0 and TC_TILE_KEYS % block_size == 0
            and TC_TILE_KEYS % group == 0):
        return TENSOR_CORE
    return CUDA_CORE


def split_plan(max_s: int, rows_kv: int) -> tuple:
    """``(nsplit, split_len)`` for a split-K call over ``max_s = MB*BS``
    logical positions and ``rows_kv = B*KV`` (row, kv-head) pairs: enough
    splits that the grid covers the SMs at least twice (where the key
    range allows it) and at most about ``SPLIT_TARGET_KEYS`` keys a split;
    lengths in multiples of ``SPLIT_QUANTUM``. Shapes only, never data."""
    want = max(-(-2 * SM_COUNT // max(rows_kv, 1)),
               -(-max_s // SPLIT_TARGET_KEYS))
    split_len = max(SPLIT_QUANTUM,
                    max_s // want // SPLIT_QUANTUM * SPLIT_QUANTUM)
    return -(-max_s // split_len), split_len


def blocks_per_chunk(num_blocks: int, block_size: int,
                     tile: int = DEFAULT_TILE) -> int:
    """Largest divisor C of ``num_blocks`` with C*block_size <= tile
    (>= 1 even when a single block exceeds the tile)."""
    best = 1
    for c in range(1, num_blocks + 1):
        if num_blocks % c == 0 and c * block_size <= tile:
            best = c
    return best


def _online_fold(m, l, acc, s, vb):
    """One online-softmax step: fold masked scores ``s`` [B,KV,G,S,T]
    (-1e30 where invalid) and values ``vb`` [B,T,KV,hd] into the running
    (max, sum, acc) triple. The -1e29 clamp makes a fully masked chunk
    contribute exact zeros."""
    m_new = torch.clamp(torch.maximum(m, s.amax(dim=-1)), min=M_FLOOR)
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bkgst,btkh->bkgsh", p, vb)
    return m_new, l_new, acc_new


def plain_paged_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k_pool: torch.Tensor,  # [NB, BS, KV, hd]
    v_pool: torch.Tensor,
    bt: torch.Tensor,  # [B, MB] int32
    starts: torch.Tensor,  # [B] int32
    tile: int = DEFAULT_TILE,
) -> torch.Tensor:
    """The plain PyTorch version of the blocked kernel (port of the
    reference's ``_lax_paged_attention`` without the read-only modes).
    Runs on any device; float32 accumulation."""
    B, S, H, hd = q.shape
    BS, KV = k_pool.shape[1], k_pool.shape[2]
    MB = bt.shape[1]
    max_s = MB * BS
    group = H // KV
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qg = q.reshape(B, S, KV, group, hd).float()
    posq = torch.clamp(
        starts.long()[:, None] + torch.arange(S, device=dev)[None, :],
        max=max_s - 1,
    )
    C = blocks_per_chunk(MB, BS, tile)
    NC = MB // C
    btc = bt.long().reshape(B, NC, C)
    m = torch.full((B, KV, group, S), M_FLOOR, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, group, S, hd), dtype=torch.float32, device=dev)
    for c in range(NC):
        btj = btc[:, c]  # [B, C]
        kb = k_pool[btj].reshape(B, C * BS, KV, hd).float()
        vb = v_pool[btj].reshape(B, C * BS, KV, hd).float()
        s = torch.einsum("bskgh,btkh->bkgst", qg, kb) * scale
        t = c * (C * BS) + torch.arange(C * BS, device=dev)
        valid = t[None, None, :] <= posq[:, :, None]  # [B, S, C*BS]
        s = torch.where(valid[:, None, None], s, NEG_INF)
        m, l, acc = _online_fold(m, l, acc, s, vb)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def plain_split_partials(q, k_pool, v_pool, bt, starts, split_len: int):
    """The plain version of the split-K kernel's first pass: for each
    split of ``split_len`` logical positions, the online-softmax state
    (m, l, acc) over that split's keys alone, in float32 and base e —
    ``m``/``l`` [B, KV, group, S, N], ``acc`` [B, KV, group, S, N, hd]. A
    split with no visible key is the empty partial (-1e29, 0, 0)."""
    B, S, H, hd = q.shape
    BS, KV = k_pool.shape[1], k_pool.shape[2]
    MB = bt.shape[1]
    max_s = MB * BS
    group = H // KV
    dev = q.device
    qg = q.reshape(B, S, KV, group, hd).float()
    posq = torch.clamp(
        starts.long()[:, None] + torch.arange(S, device=dev)[None, :],
        max=max_s - 1,
    )
    kf = k_pool[bt.long()].reshape(B, max_s, KV, hd).float()
    vf = v_pool[bt.long()].reshape(B, max_s, KV, hd).float()
    ms, ls, accs = [], [], []
    for lo in range(0, max_s, split_len):
        t = torch.arange(lo, min(lo + split_len, max_s), device=dev)
        s = torch.einsum("bskgh,btkh->bkgst", qg, kf[:, t]) / math.sqrt(hd)
        valid = t[None, None, :] <= posq[:, :, None]
        s = torch.where(valid[:, None, None], s, NEG_INF)
        m = torch.full((B, KV, group, S), M_FLOOR, dtype=torch.float32,
                       device=dev)
        m, l, acc = _online_fold(m, torch.zeros_like(m),
                                 torch.zeros(m.shape + (hd,), device=dev),
                                 s, vf[:, t])
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    return (torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2))


def combine_splits(m, l, acc):
    """The plain version of the split-K merge: partials ``m``/``l``
    [..., N] and ``acc`` [..., N, hd] (base e, as :func:`_online_fold`
    keeps them; the kernel's are base 2) folded into ``acc / max(l,
    1e-30)`` [..., hd] under the same -1e29 clamp, so an empty partial
    adds exact zeros."""
    mm = torch.clamp(m.amax(dim=-1), min=M_FLOOR)
    w = torch.exp(m - mm[..., None])
    l_sum = (l * w).sum(dim=-1)
    a_sum = (acc * w[..., None]).sum(dim=-2)
    return a_sum / torch.clamp(l_sum, min=1e-30)[..., None]


def plain_fused_write(k_pool, v_pool, bt, starts, new_k, new_v):
    """The plain version of the fused kernel's write: land row b's step
    K/V at ``(bt[b, starts//BS], starts % BS)``, IN PLACE. A plain copy,
    so a row that owns its write block ends bit-identical to a scatter."""
    B = starts.shape[0]
    BS = k_pool.shape[1]
    st = starts.long()
    blk = bt.long()[torch.arange(B, device=bt.device), st // BS]
    off = st % BS
    k_pool[blk, off] = new_k
    v_pool[blk, off] = new_v
    return k_pool, v_pool


# ---- CUDA kernels ----------------------------------------------------------

def _check_kernel_inputs(q, k_pool, v_pool, bt, starts, extra=()):
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged attention kernel takes bf16 or f32, got {q.dtype}")
    B, S, H, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"paged attention kernel supports head_dim {KERNEL_HEAD_DIMS}, "
            f"got {hd}"
        )
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4 \
            or k_pool.shape[3] != hd:
        raise ValueError(
            f"pool shapes {tuple(k_pool.shape)} / {tuple(v_pool.shape)} "
            f"do not fit q {tuple(q.shape)}"
        )
    KV = k_pool.shape[2]
    if H % KV != 0:
        raise ValueError(f"n_heads {H} not a multiple of n_kv_heads {KV}")
    if bt.dim() != 2 or bt.shape[0] != B or starts.shape != (B,):
        raise ValueError("bt must be [B, MB] and starts [B]")
    for name, t in (("bt", bt), ("starts", starts)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    dev = q.device
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("bt", bt), ("starts", starts)) + tuple(extra):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if t.is_floating_point() and t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")


def _dtype_code(dtype) -> int:
    return 1 if dtype == torch.bfloat16 else 0


def _cuda_launch(q, k_pool, v_pool, bt, starts, new_k=None, new_v=None):
    """One op call on the card: the route's kernel (split-K: the split
    kernel and the merge), launched on the current stream without a
    device read; the fused call updates the pools in place."""
    from kubedl_tpu_torch.ops.build import check_launch, load_kernels

    fused = new_k is not None
    extra = (("new_k", new_k), ("new_v", new_v)) if fused else ()
    _check_kernel_inputs(q, k_pool, v_pool, bt, starts, extra=extra)
    B, S, H, hd = q.shape
    NB, BS, KV, _ = k_pool.shape
    MB = bt.shape[1]
    if fused and (new_k.shape != (B, KV, hd) or new_v.shape != (B, KV, hd)):
        raise ValueError(
            f"new_k/new_v must be [B, KV, hd] = {(B, KV, hd)}, got "
            f"{tuple(new_k.shape)} / {tuple(new_v.shape)}"
        )
    route = paged_route(q.dtype, hd, S, H // KV, BS, fused)
    lib = load_kernels()
    out = torch.empty_like(q)
    ws, nsplit, split_len = None, 0, 0
    if route == SPLIT_K:
        nsplit, split_len = split_plan(MB * BS, B * KV)
        ws = torch.empty((B, KV, nsplit, S * (H // KV), hd + 2),
                         dtype=torch.float32, device=q.device)
    ws_ptr = None if ws is None else ws.data_ptr()
    dims = (NB, BS, MB, nsplit, split_len, _dtype_code(q.dtype))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if fused:
            err = lib.kdl_paged_attention_fused(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                bt.data_ptr(), starts.data_ptr(), new_k.data_ptr(),
                new_v.data_ptr(), ws_ptr, out.data_ptr(),
                B, H, KV, hd, *dims, stream,
            )
        else:
            err = lib.kdl_paged_attention_blocked(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                bt.data_ptr(), starts.data_ptr(), ws_ptr, out.data_ptr(),
                B, S, H, KV, hd, *dims, stream,
            )
    name = "fused" if fused else "blocked"
    check_launch(err, f"paged_attention_{name} ({route})")
    LAUNCHES[name] += 1
    ROUTE_LAUNCHES[route] += 1
    return out


def paged_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k_pool: torch.Tensor,  # [NB, BS, KV, hd] (one layer's pool)
    v_pool: torch.Tensor,
    bt: torch.Tensor,  # [B, MB] int32 block table
    starts: torch.Tensor,  # [B] int32 first query's global position
    *,
    self_k: Optional[torch.Tensor] = None,
    self_v: Optional[torch.Tensor] = None,
    self_mask: Optional[torch.Tensor] = None,
    new_k: Optional[torch.Tensor] = None,  # [B, KV, hd] fused decode write
    new_v: Optional[torch.Tensor] = None,
):
    """Blocked paged attention over the pool — returns [B, S, H, hd], or
    ``(out, k_pool, v_pool)`` when ``new_k``/``new_v`` carry a fused
    decode-step KV write (S must be 1; the write lands at ``starts`` and
    the pools are updated in place).

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel of :func:`paged_route` or raise (see the module docstring for
    the masking and -1e29 clamp contract every route keeps)."""
    if self_k is not None or self_v is not None or self_mask is not None:
        raise NotImplementedError(
            "read-only self_k/self_v/self_mask verify modes belong to "
            "speculative decoding, which a later port slice brings"
        )
    if (new_k is None) != (new_v is None):
        raise ValueError("new_k and new_v go together")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if new_k is not None:
        if q.shape[1] != 1:
            raise ValueError(
                f"fused KV write is decode-only (S=1), got S={q.shape[1]}"
            )
        if q.is_cuda:
            out = _cuda_launch(q, k_pool, v_pool, bt, starts, new_k, new_v)
            return out, k_pool, v_pool
        plain_fused_write(k_pool, v_pool, bt, starts, new_k, new_v)
        out = plain_paged_attention(q, k_pool, v_pool, bt, starts)
        return out, k_pool, v_pool
    if q.is_cuda:
        return _cuda_launch(q, k_pool, v_pool, bt, starts)
    return plain_paged_attention(q, k_pool, v_pool, bt, starts)


__all__ = [
    "paged_attention",
    "paged_route",
    "split_plan",
    "plain_paged_attention",
    "plain_split_partials",
    "combine_splits",
    "plain_fused_write",
    "blocks_per_chunk",
    "DEFAULT_TILE",
    "LAUNCHES",
    "ROUTE_LAUNCHES",
    "KERNEL_HEAD_DIMS",
    "TENSOR_CORE_HEAD_DIMS",
]
