"""Flash attention for training: forward and backward, PyTorch + CUDA.

Port of ``kubedl_tpu/ops/flash_attention.py``. The public function
:func:`flash_attention` keeps the reference's signature and its
``[B, S, H, hd]`` layout (q) / ``[B, S, KV, hd]`` (k, v), GQA by head
grouping, and its routes: a ``mask``, or a sequence length that
:func:`fit_block` cannot tile, goes to the dense oracle
(``models.llama.attention``); everything else goes to the kernels. The
block arguments decide only that route (and ``interpret`` is accepted
and ignored): the CUDA kernels use their own tiles.

Four kernels, each a ``torch.library`` custom op whose CUDA
implementation launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``) and whose CPU implementation is the plain
PyTorch version beside it. A CUDA tensor launches the kernel or raises;
there is no fallback. Being operators (not ctypes calls inside an
``autograd.Function``) is what lets a selective-checkpoint policy save
the forward's outputs, so remat never re-runs the forward kernel
(``models.llama.remat_policy_for``):

==================  ========================================  ===========
op                  computes                                  replaces
==================  ========================================  ===========
``flash_fwd``       (out, lse)                                ``_fwd_kernel``
``flash_bwd_fused`` (dq, dk, dv), dk/dv summed over the group ``_bwd_fused_kernel``
``flash_bwd_dq``    dq                                        ``_bwd_dq_kernel``
``flash_bwd_dkdv``  per-q-head (dk_h, dv_h)                   ``_bwd_dkdv_kernel``
==================  ========================================  ===========

Kernel design by route (:func:`tensor_core_route`, a static table, the
same for all four operators): bf16 at hd 64 and 128 launches the
tensor-core kernels (wgmma on TMA-staged bf16 tiles), for which the
wrapper allocates the rotated-q/k and row-stats workspaces (and the
fused route's dq sums); float32 at every hd and bf16 at hd 256 launch
the CUDA-core kernels.

Numerics contract (the reference's; kernels and plain versions keep it,
and a kernel redesign must too):

- Scores are ``(q . k) / sqrt(hd) * log2(e)`` in float32; the softmax
  runs in base 2 (``exp2``). Masked scores are -1e30. Causal: query i
  sees keys j <= i.
- ``lse`` is BASE-2, ``m + log2(max(l, 1e-30))``, float32, shaped
  ``[B, H, Sq, 1]``; the backward consumes it as it is
  (``P = exp2(s - lse)``). ``out = acc / max(l, 1e-30)`` in q's type.
- Backward: ``D = rowsum(dO * O)`` and ``dP = dO . V^T`` in float32;
  ``dS = P (dP - D)`` is rounded to q's type before the dq/dk products,
  and ``P`` to dO's type before the dv product. The fused route sums
  dk/dv over the GQA group in float32 and rounds once; the split route
  rounds each q-head's dk_h/dv_h and then sums the group (as the
  reference does outside its kernel).
- Fused RoPE (``rope_cos``/``rope_sin``): q/k arrive PRE-rope; they are
  rotated in float32 (split halves) and rounded back to their type
  before any product, and the backward returns gradients with respect
  to the PRE-rope q/k by the inverse rotation, in float32, before the
  cast.

Backward route: the reference's predicate, unchanged, with its two
constants kept as module attributes (a test may monkeypatch them):
fused while the TPU kernel's whole-sequence dk+dv scratch
(``Sk * hd * 8`` bytes) fits ``_FUSED_BWD_SCRATCH_BYTES``, and, above
``_FUSED_BWD_SMALL_TILE_BYTES``, only if ``fit_block(Sk, 512)`` tiles;
else the split pair.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
LOG2E = math.log2(math.e)

#: the reference's cap on its fused backward's whole-sequence dk+dv
#: scratch (Sk * hd * 8 bytes); above it the split pair is used
_FUSED_BWD_SCRATCH_BYTES = 8 << 20
#: above this scratch size the fused route also needs fit_block(Sk, 512)
_FUSED_BWD_SMALL_TILE_BYTES = 2 << 20

#: launches per CUDA kernel, counted by the wrappers where they launch —
#: a run reads them to show its main path really went through the kernels
LAUNCHES = {"flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkdv": 0}

#: head dims the CUDA kernels are compiled for
KERNEL_HEAD_DIMS = (64, 128, 256)
#: head dims whose bf16 kernels take the tensor cores (wgmma, TMA), for
#: every operator; float32 at every hd and bf16 at hd 256 take the
#: CUDA-core ones. The source's ``TcRoute`` is the same table.
TENSOR_CORE_HEAD_DIMS = (64, 128)
#: the tensor-core backward's q tile: its workspaces pad Sq to a multiple
_TC_BWD_BQ = 64


# ---- routing (copied from the reference: same shapes, same route) ----------

def fit_block(seq_len: int, want: int) -> int:
    """Largest legal block <= ``want`` for this sequence length: the whole
    sequence if it fits in one block, else the largest multiple-of-128
    divisor. 0 = no legal block — the caller falls back to the dense
    oracle."""
    if seq_len <= want:
        return seq_len
    for b in range(min(want, seq_len), 127, -128):
        if b % 128 == 0 and seq_len % b == 0:
            return b
    return 0


def supports(seq_len: int, block_q: int = 1024, block_k: int = 1024) -> bool:
    """Whether a legal tiling exists for this shape."""
    return fit_block(seq_len, block_q) > 0 and fit_block(seq_len, block_k) > 0


def bwd_route(seq_k: int, head_dim: int) -> str:
    """``"fused"`` or ``"split"``: the reference's ``_bwd_pallas``
    predicate (read at call time, so a monkeypatched constant counts)."""
    scratch_bytes = seq_k * head_dim * 8
    fused_ok = scratch_bytes <= _FUSED_BWD_SCRATCH_BYTES
    if fused_ok and scratch_bytes > _FUSED_BWD_SMALL_TILE_BYTES:
        fused_ok = fit_block(seq_k, 512) > 0
    return "fused" if fused_ok else "split"


# ---- plain versions ---------------------------------------------------------

def _rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 inverse: bool = False) -> torch.Tensor:
    """Split-halves rotation of ``x`` [B, S, N, hd] by the tables' first S
    rows, in float32, cast back to x's type; ``inverse`` rotates by -θ
    (the transpose), which turns post-rope gradients into pre-rope ones."""
    S = x.shape[1]
    c = cos[:S].float()[None, :, None, :]
    s = sin[:S].float()[None, :, None, :]
    if inverse:
        s = -s
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def _scores(q, k, causal):
    """Base-2 scores [B, KV, G, Sq, Sk] in float32 (-1e30 where masked)
    and the visibility mask (None when nothing is masked)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    s = s * (1.0 / math.sqrt(hd) * LOG2E)
    vis = None
    if causal:
        vis = (torch.arange(Sq, device=q.device)[:, None]
               >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(vis, s, NEG_INF)
    return s, vis


def _rotated(q, k, cos, sin):
    if cos is None:
        return q, k
    return _rope_rotate(q, cos, sin), _rope_rotate(k, cos, sin)


def _plain_fwd(q, k, v, cos, sin, causal):
    """Plain version of ``flash_fwd``: (out [B,Sq,H,hd] in q's type, lse
    [B,H,Sq,1] base-2 float32)."""
    B, Sq, H, hd = q.shape
    q, k = _rotated(q, k, cos, sin)
    s, vis = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    if vis is not None:
        p = torch.where(vis, p, 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    pv = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype).float(), v.float())
    lt = l[..., 0].permute(0, 3, 1, 2)[..., None]  # [B, Sq, KV, G, 1]
    out = (pv / lt).reshape(B, Sq, H, hd).to(q.dtype)
    lse = (m + torch.log2(l)).reshape(B, H, Sq, 1)
    return out, lse.contiguous()


def _grad_terms(q, k, v, cos, sin, out, lse, dout, causal):
    """Shared by the plain backward versions: rotated q/k and, in
    float32, P (from lse) and dS = P (dP - D) with the reference's
    roundings; P is [B, KV, G, Sq, Sk]."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qr, kr = _rotated(q, k, cos, sin)
    s, vis = _scores(qr, kr, causal)
    p = torch.exp2(s - lse.reshape(B, KV, H // KV, Sq, 1))
    if vis is not None:
        p = torch.where(vis, p, 0.0)
    do32 = dout.float()
    d = (do32 * out.float()).sum(-1)  # [B, Sq, H]
    d = d.permute(0, 2, 1).reshape(B, KV, H // KV, Sq, 1)
    dp = torch.einsum("bskgh,btkh->bkgst",
                      do32.reshape(B, Sq, KV, H // KV, hd), v.float())
    ds = (p * (dp - d)).to(q.dtype).float()
    return qr, kr, p, ds


def _plain_bwd_fused(q, k, v, cos, sin, out, lse, dout, causal):
    """Plain version of ``flash_bwd_fused``: (dq, dk, dv), dk/dv summed
    over the GQA group in float32 and rounded once."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qr, kr, p, ds = _grad_terms(q, k, v, cos, sin, out, lse, dout, causal)
    dog = dout.float().reshape(B, Sq, KV, H // KV, hd)
    dv = torch.einsum("bkgst,bskgh->btkh", p.to(dout.dtype).float(), dog)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kr.float()) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds,
                      qr.float().reshape(B, Sq, KV, H // KV, hd)) * scale
    dq = dq.reshape(B, Sq, H, hd)
    if cos is not None:
        dq = _rope_rotate(dq, cos, sin, inverse=True)
        dk = _rope_rotate(dk, cos, sin, inverse=True)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _plain_bwd_dq(q, k, v, cos, sin, out, lse, dout, causal):
    """Plain version of ``flash_bwd_dq``."""
    B, Sq, H, hd = q.shape
    _, kr, _, ds = _grad_terms(q, k, v, cos, sin, out, lse, dout, causal)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kr.float()) / math.sqrt(hd)
    dq = dq.reshape(B, Sq, H, hd)
    if cos is not None:
        dq = _rope_rotate(dq, cos, sin, inverse=True)
    return dq.to(q.dtype)


def _plain_bwd_dkdv_per_head(q, k, v, cos, sin, out, lse, dout, causal):
    """Plain version of ``flash_bwd_dkdv``: per-q-head (dk_h, dv_h)
    [B, Sk, H, hd] in k's / v's type, dk_h inverse-rotated per head."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    Sk = k.shape[1]
    qr, _, p, ds = _grad_terms(q, k, v, cos, sin, out, lse, dout, causal)
    dog = dout.float().reshape(B, Sq, KV, H // KV, hd)
    dv_h = torch.einsum("bkgst,bskgh->btkgh", p.to(dout.dtype).float(), dog)
    dk_h = torch.einsum("bkgst,bskgh->btkgh", ds,
                        qr.float().reshape(B, Sq, KV, H // KV, hd))
    dk_h = (dk_h / math.sqrt(hd)).reshape(B, Sk, H, hd)
    if cos is not None:
        dk_h = _rope_rotate(dk_h, cos, sin, inverse=True)
    return dk_h.to(k.dtype), dv_h.reshape(B, Sk, H, hd).to(v.dtype)


# ---- CUDA kernels ------------------------------------------------------------

def _check_cuda_inputs(q, k, v, cos, sin, extra=()):
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash attention kernel takes bf16 or f32, got {q.dtype}")
    B, Sq, H, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash attention kernels are built for head_dim "
            f"{KERNEL_HEAD_DIMS}, got {hd}"
        )
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(
            f"k/v {tuple(k.shape)} / {tuple(v.shape)} do not fit q "
            f"{tuple(q.shape)}"
        )
    tensors = [("q", q), ("k", k), ("v", v)] + list(extra)
    if cos is not None:
        if cos.shape != sin.shape or cos.shape[0] < max(Sq, k.shape[1]) \
                or cos.shape[1] != hd // 2:
            raise ValueError(
                f"rope tables {tuple(cos.shape)} do not cover "
                f"{max(Sq, k.shape[1])} positions x {hd // 2}"
            )
        tensors += [("cos", cos), ("sin", sin)]
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.float32 if name in ("cos", "sin", "lse") else q.dtype
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}, expected {want}")


def tensor_core_route(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the four operators launch their tensor-core kernels for
    this input type and head width (a static table, not a fallback: each
    route launches its kernel or raises)."""
    return dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS


def _rope_workspaces(q, k, cos):
    """The tensor-core route's rotated q / k (written by the kernels'
    RoPE pre-pass), or None where that route or rope is off."""
    if cos is None or not tensor_core_route(q.dtype, q.shape[3]):
        return None, None
    return torch.empty_like(q), torch.empty_like(k)


def _launch(fn_name: str, counter: str, q, k, v, cos, sin, causal, ptrs):
    from kubedl_tpu_torch.ops.build import check_launch, load_flash_kernels

    lib = load_flash_kernels()
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rope = cos is not None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn_name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            cos.data_ptr() if rope else None, sin.data_ptr() if rope else None,
            *[None if t is None else t.data_ptr() for t in ptrs],
            B, Sq, Sk, H, KV, hd, int(causal), int(rope),
            1 if q.dtype == torch.bfloat16 else 0, stream,
        )
    check_launch(err, counter)
    LAUNCHES[counter] += 1


def _cuda_fwd(q, k, v, cos, sin, causal):
    _check_cuda_inputs(q, k, v, cos, sin)
    B, Sq, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    q_rot, k_rot = _rope_workspaces(q, k, cos)
    _launch("kdl_flash_fwd", "flash_fwd", q, k, v, cos, sin, causal,
            (out, lse, q_rot, k_rot))
    return out, lse


def _check_bwd_inputs(q, k, v, cos, sin, out, lse, dout):
    B, Sq, H, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (B, H, Sq, 1):
        raise ValueError("out/dout must match q and lse be [B, H, Sq, 1]")
    _check_cuda_inputs(q, k, v, cos, sin,
                       extra=(("out", out), ("lse", lse), ("dout", dout)))


def _stats_workspace(q):
    """The tensor-core backward's {lse, D} per q row, [B, H, Sq padded to
    the q tile, 2] float32 (written whole by the kernels' pre-pass), or
    None on the CUDA-core route."""
    B, Sq, H, hd = q.shape
    if not tensor_core_route(q.dtype, hd):
        return None
    sq_pad = -(-Sq // _TC_BWD_BQ) * _TC_BWD_BQ
    return torch.empty((B, H, sq_pad, 2), dtype=torch.float32,
                       device=q.device)


def _cuda_bwd_fused(q, k, v, cos, sin, out, lse, dout, causal):
    _check_bwd_inputs(q, k, v, cos, sin, out, lse, dout)
    B, Sq, H, hd = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    q_rot, k_rot = _rope_workspaces(q, k, cos)
    stats = _stats_workspace(q)
    if stats is not None:
        # zeroed by the pre-pass: the dq sums, [B, H, Sq padded, hd]
        dq_ws = torch.empty((B, H, stats.shape[2], hd), **f32)
    else:
        dq_ws = torch.zeros(q.shape, **f32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch("kdl_flash_bwd_fused", "flash_bwd_fused", q, k, v, cos, sin,
            causal, (out, lse, dout, q_rot, k_rot, stats, dq_ws, dq, dk, dv))
    return dq, dk, dv


def _cuda_bwd_dq(q, k, v, cos, sin, out, lse, dout, causal):
    _check_bwd_inputs(q, k, v, cos, sin, out, lse, dout)
    q_rot, k_rot = _rope_workspaces(q, k, cos)
    stats = _stats_workspace(q)
    dq = torch.empty_like(q)
    _launch("kdl_flash_bwd_dq", "flash_bwd_dq", q, k, v, cos, sin, causal,
            (out, lse, dout, q_rot, k_rot, stats, dq))
    return dq


def _cuda_bwd_dkdv(q, k, v, cos, sin, out, lse, dout, causal):
    _check_bwd_inputs(q, k, v, cos, sin, out, lse, dout)
    B, Sk = k.shape[:2]
    shape = (B, Sk, q.shape[2], q.shape[3])
    q_rot, k_rot = _rope_workspaces(q, k, cos)
    stats = _stats_workspace(q)
    dk_h = torch.empty(shape, dtype=k.dtype, device=q.device)
    dv_h = torch.empty(shape, dtype=v.dtype, device=q.device)
    _launch("kdl_flash_bwd_dkdv", "flash_bwd_dkdv", q, k, v, cos, sin,
            causal, (out, lse, dout, q_rot, k_rot, stats, dk_h, dv_h))
    return dk_h, dv_h


# ---- operators: CPU = the plain version, CUDA = the kernel -----------------

Tensor = torch.Tensor
OptTensor = Optional[torch.Tensor]


@torch.library.custom_op("kubedl_tpu::flash_fwd", mutates_args=(),
                         device_types="cpu")
def flash_fwd(q: Tensor, k: Tensor, v: Tensor, cos: OptTensor,
              sin: OptTensor, causal: bool) -> Tuple[Tensor, Tensor]:
    return _plain_fwd(q, k, v, cos, sin, causal)


@torch.library.custom_op("kubedl_tpu::flash_bwd_fused", mutates_args=(),
                         device_types="cpu")
def flash_bwd_fused(q: Tensor, k: Tensor, v: Tensor, cos: OptTensor,
                    sin: OptTensor, out: Tensor, lse: Tensor, dout: Tensor,
                    causal: bool) -> Tuple[Tensor, Tensor, Tensor]:
    return _plain_bwd_fused(q, k, v, cos, sin, out, lse, dout, causal)


@torch.library.custom_op("kubedl_tpu::flash_bwd_dq", mutates_args=(),
                         device_types="cpu")
def flash_bwd_dq(q: Tensor, k: Tensor, v: Tensor, cos: OptTensor,
                 sin: OptTensor, out: Tensor, lse: Tensor, dout: Tensor,
                 causal: bool) -> Tensor:
    return _plain_bwd_dq(q, k, v, cos, sin, out, lse, dout, causal)


@torch.library.custom_op("kubedl_tpu::flash_bwd_dkdv", mutates_args=(),
                         device_types="cpu")
def flash_bwd_dkdv(q: Tensor, k: Tensor, v: Tensor, cos: OptTensor,
                   sin: OptTensor, out: Tensor, lse: Tensor, dout: Tensor,
                   causal: bool) -> Tuple[Tensor, Tensor]:
    return _plain_bwd_dkdv_per_head(q, k, v, cos, sin, out, lse, dout,
                                    causal)


flash_fwd.register_kernel("cuda")(_cuda_fwd)
flash_bwd_fused.register_kernel("cuda")(_cuda_bwd_fused)
flash_bwd_dq.register_kernel("cuda")(_cuda_bwd_dq)
flash_bwd_dkdv.register_kernel("cuda")(_cuda_bwd_dkdv)


def flash_backward(q, k, v, cos, sin, out, lse, dout, causal):
    """The backward dispatcher (the reference's ``_bwd_pallas``): the
    fused kernel, or the split pair whose per-q-head dk/dv are summed
    over the GQA group here, outside the kernel."""
    dout = dout.contiguous()
    if bwd_route(k.shape[1], q.shape[3]) == "fused":
        return flash_bwd_fused(q, k, v, cos, sin, out, lse, dout, causal)
    dq = flash_bwd_dq(q, k, v, cos, sin, out, lse, dout, causal)
    dk_h, dv_h = flash_bwd_dkdv(q, k, v, cos, sin, out, lse, dout, causal)
    B, Sk, H, hd = dk_h.shape
    KV = k.shape[2]
    dk = dk_h.reshape(B, Sk, KV, H // KV, hd).sum(3).to(k.dtype)
    dv = dv_h.reshape(B, Sk, KV, H // KV, hd).sum(3).to(v.dtype)
    return dq, dk, dv


def _fwd_setup(ctx, inputs, output):
    q, k, v, cos, sin, causal = inputs
    out, lse = output
    ctx.causal = causal
    ctx.save_for_backward(q, k, v, cos, sin, out, lse)


def _fwd_backward(ctx, dout, _dlse):
    q, k, v, cos, sin, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_backward(q, k, v, cos, sin, out, lse, dout,
                                ctx.causal)
    return dq, dk, dv, None, None, None


flash_fwd.register_autograd(_fwd_backward, setup_context=_fwd_setup)


# ---- the public function -----------------------------------------------------

def _dense_fallback(q, k, v, causal, mask, rope_cos, rope_sin):
    from kubedl_tpu_torch.models.llama import apply_rope, attention

    if rope_cos is not None:  # fallbacks must still apply the rotary
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
    return attention(q, k, v, causal=causal, mask=mask)


def flash_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, KV, hd]
    v: torch.Tensor,
    causal: bool = True,
    mask: Optional[torch.Tensor] = None,
    block_q: int = 1024,
    block_k: int = 1024,
    bwd_block_q: int = 1024,
    bwd_block_k: int = 1024,
    interpret: Optional[bool] = None,
    rope_cos: Optional[torch.Tensor] = None,  # [>= S, hd/2]: RoPE fused
    rope_sin: Optional[torch.Tensor] = None,  # (q/k arrive PRE-rope)
) -> torch.Tensor:
    """Drop-in for ``models.llama.attention`` (same layout; differentiable).
    A ``mask``, or a length no block fits, takes the dense oracle; all
    else the ``flash_fwd`` operator, whose backward is the fused kernel
    or the split pair (:func:`bwd_route`). ``interpret`` exists for
    signature parity and is ignored."""
    del interpret
    if mask is not None:
        return _dense_fallback(q, k, v, causal, mask, rope_cos, rope_sin)
    S = q.shape[1]
    if not all(fit_block(S, b) for b in (block_q, block_k, bwd_block_q,
                                         bwd_block_k)):
        return _dense_fallback(q, k, v, causal, None, rope_cos, rope_sin)
    cos = sin = None
    if rope_cos is not None:
        cos = rope_cos.float().contiguous()
        sin = rope_sin.float().contiguous()
    out, _ = flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), cos,
                       sin, causal)
    return out


def mesh_axes(mesh) -> dict:
    """``{axis: size}`` of a mesh given as None, such a mapping, or an
    object with such a ``.shape`` mapping."""
    if mesh is None:
        return {}
    axes = mesh if isinstance(mesh, dict) else getattr(mesh, "shape", {})
    return {str(k): int(v) for k, v in dict(axes).items()}


def mesh_size(mesh) -> int:
    """Devices in a mesh (see :func:`mesh_axes`)."""
    return math.prod(mesh_axes(mesh).values())


def make_flash_attention(mesh=None, batch_axes=("replica", "data", "fsdp"),
                         head_axis: str = "tensor", block_q: int = 1024,
                         block_k: int = 1024,
                         interpret: Optional[bool] = None):
    """The trainer's attention function on one device: :func:`flash_attention`
    with ``.fused_rope = True`` (callers pass q/k PRE-rope plus the
    tables). A mesh of more than one device raises: sharded attention
    belongs to the multi-chip port slice."""
    del batch_axes, head_axis, interpret
    if mesh_size(mesh) > 1:
        raise ValueError(
            "a mesh of more than one device is not ported yet: sharded "
            "flash attention belongs to the multi-chip port slice"
        )

    def direct(q, k, v, causal=True, mask=None, rope_cos=None,
               rope_sin=None):
        return flash_attention(q, k, v, causal=causal, mask=mask,
                               block_q=block_q, block_k=block_k,
                               rope_cos=rope_cos, rope_sin=rope_sin)

    direct.fused_rope = True
    return direct


__all__ = [
    "flash_attention", "make_flash_attention", "flash_backward", "fit_block",
    "supports", "bwd_route", "mesh_axes", "mesh_size", "flash_fwd", "flash_bwd_fused",
    "flash_bwd_dq", "flash_bwd_dkdv", "LAUNCHES", "KERNEL_HEAD_DIMS",
    "TENSOR_CORE_HEAD_DIMS", "tensor_core_route", "NEG_INF", "LOG2E",
]
