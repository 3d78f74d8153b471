"""Ring and Ulysses attention: sequence (context) parallelism over the
``sp`` mesh axis, the port of ``kubedl_tpu/parallel/ring.py``.

Each rank of the ``sp`` axis holds one block of the sequence: its
queries, keys and values ``[B, S/n, H, hd]``. :func:`ring_attention`
passes the K/V blocks around the ring (``parallel/mesh.py::shift``, the
reference's ``lax.ppermute``, whose backward is the inverse shift) while
a float32 online-softmax accumulator folds each visiting block in;
:func:`ulysses_attention` trades the sequence split for a head split with
one ``all_to_all`` each way and runs the plain attention locally. The
per-block products are ``torch.matmul`` (einsum), as in the reference,
which computes them outside any Pallas kernel.

RoPE is applied by the caller with GLOBAL positions (the rank's block
offset), so the blocks compose without position bookkeeping here.

Numerics: float32 scores, accumulator and row statistics; masked scores
-1e30; causal by global block offset (query i sees keys j <= i). A
block that lies wholly above the diagonal is computed all the same (an
exact no-op, as in the reference): skipping it would leave its shift
out of that rank's backward, whose inverse shift the other ranks wait
for. One difference in idiom, not in value: the running max is a
constant of the backward (the softmax does not depend on it); the last
tick's shift, whose blocks nothing reads, is not made.
"""

from __future__ import annotations

import math

import torch

from kubedl_tpu_torch.parallel.mesh import all_to_all, shift

NEG_INF = -1e30


def _block_scores(q: torch.Tensor, k: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """q [B, Sq, H, hd], k [B, Sk, H, hd] -> float32 [B, H, Sq, Sk]."""
    return torch.einsum("bshd,bthd->bhst", q, k).float() * scale


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis_name: str = "sp",
                   causal: bool = True) -> torch.Tensor:
    """Blockwise ring attention over ``axis_name`` of ``mesh`` (a
    ``ProcessMesh``). q [B, S_local, H, hd], k/v [B, S_local, KV, hd];
    GQA K/V are repeated up to H heads per visiting block, after the
    shift (the ring carries KV heads, not H)."""
    n = mesh.shape[axis_name]
    idx = mesh.coords[axis_name]
    B, Sl, H, hd = q.shape
    group = H // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    rows = idx * Sl + torch.arange(Sl, device=q.device)  # global positions
    acc = torch.zeros((B, H, Sl, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sl), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for t in range(n):
        j = (idx - t) % n  # which global block this k/v shard is
        kb = k_blk.repeat_interleave(group, 2) if group > 1 else k_blk
        vb = v_blk.repeat_interleave(group, 2) if group > 1 else v_blk
        s = _block_scores(q, kb, scale)  # [B, H, Sl, Sl]
        if causal:
            cols = j * Sl + torch.arange(Sl, device=q.device)
            s = torch.where((rows[:, None] >= cols[None, :])[None, None],
                            s, NEG_INF)
        m_new = torch.maximum(m, s.detach().amax(dim=-1))
        # fully-masked-so-far rows keep m at NEG_INF; exp() stays finite
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhst,bthd->bhsd", p.to(vb.dtype), vb)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
        if t < n - 1:  # every rank shifts alike: the backward's
            # inverse shifts pair up only if no rank drops a block
            k_blk = shift(k_blk, mesh, axis_name)
            v_blk = shift(v_blk, mesh, axis_name)
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # [B, H, Sl, hd]
    return out.transpose(1, 2).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis_name: str = "sp",
                      causal: bool = True) -> torch.Tensor:
    """DeepSpeed-Ulysses: one ``all_to_all`` turns the sequence-sharded,
    head-whole q/k/v into sequence-whole, head-sharded ones, the plain
    attention (``models.llama.attention``) runs on this rank's heads, and
    a second ``all_to_all`` restores the sequence split. H and KV must
    divide by the axis size."""
    from kubedl_tpu_torch.models.llama import attention

    n = mesh.shape[axis_name]
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"ulysses attention needs the heads ({q.shape[2]}) "
                         f"and KV heads ({k.shape[2]}) divisible by "
                         f"{axis_name}={n}")
    q, k, v = (all_to_all(t, mesh, axis_name, 2, 1) for t in (q, k, v))
    out = attention(q, k, v, causal=causal)  # [B, S, H/n, hd]
    return all_to_all(out, mesh, axis_name, 1, 2)


def make_context_attention(mesh, sp_axis: str = "sp",
                           batch_axes=("replica", "data", "fsdp"),
                           head_axis: str = "tensor", impl: str = "ring",
                           causal: bool = True):
    """The trainer's attention on a mesh with an ``sp`` axis above 1
    (``mesh`` a ``ProcessMesh``): ring or Ulysses attention on this rank's
    rows and heads (it holds only those, so the batch and head axes need
    nothing here), with the ``llama.attention`` signature. None when the
    mesh has no ``sp`` axis above 1; an unknown ``impl`` raises."""
    del batch_axes, head_axis
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown context-parallel impl {impl!r}; "
                         "expected 'ring' or 'ulysses'")
    if dict(getattr(mesh, "shape", {}) or {}).get(sp_axis, 1) <= 1:
        return None
    fn = ring_attention if impl == "ring" else ulysses_attention
    make_causal = causal

    def attn_fn(q, k, v, causal=None, mask=None):
        # the recurrence is fixed at build time: reject a call that asks
        # for other semantics (None = the build-time value)
        if mask is not None:
            raise ValueError(
                "ring/ulysses attention does not support arbitrary masks; "
                "use the dense oracle or flash_attention for masked paths"
            )
        if causal is not None and causal != make_causal:
            raise ValueError(
                f"context attention was built with causal={make_causal}; "
                f"got causal={causal} at call time"
            )
        return fn(q, k, v, mesh, sp_axis, make_causal)

    return attn_fn


__all__ = ["ring_attention", "ulysses_attention", "make_context_attention",
           "NEG_INF"]
