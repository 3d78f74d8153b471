"""Llama-3-family decoder in PyTorch: the training forward and loss, and
the paged-KV serving path.

Port of ``kubedl_tpu/models/llama.py`` (config, presets, init, building
blocks, the training path of ``:39-90`` and ``:415-606``, the paged
functions of ``:849-1614`` with speculative verify and the prefix-cache
block ops, and the contiguous functions of ``:711-1000``, which also run
over a serving mesh: ``serving_shardings`` and :class:`ServingSplit`,
the counterpart of ``:611-660``). Parameters are a plain
dict with the reference's names and stacked ``[L, in, out]`` shapes, so
a checkpoint moves between the packages without transposes
(:func:`params_from_numpy` carries a JAX tree across).

Differences in idiom, not in math:

- ``lax.scan`` over layers and steps becomes a Python loop, and
  ``jax.checkpoint(body, policy)`` a per-layer non-reentrant
  ``torch.utils.checkpoint`` with a selective policy of the same meaning
  (:func:`remat_policy_for`); projections
  stay ``torch.matmul`` (the reference left them to XLA outside any
  Pallas kernel).
- The paged functions update the cache dict and its pools IN PLACE and
  return the same dict (the reference returns donated copies).
- Randomness comes from an explicit ``torch.Generator``: the init and the
  Gumbel sampling noise differ from ``jax.random`` streams for the same
  seed, so cross-framework tests carry the JAX parameters across.

Paged exactness contract (the reference's): every paged function computes
the same attention math as dense attention over the gathered
``[B, MB*BS, KV, hd]`` view, where view position t is logical position
t; masked positions (beyond each row's position) hold garbage that
contributes an exact 0.0 through the -1e30 mask. Block-table entries a
row does not own point at the trash block 0: writes from vacant rows and
padded prefill positions land there and are never read.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from kubedl_tpu_torch.models import paged_attention as blocked_attention
from kubedl_tpu_torch.ops import w8a16
from kubedl_tpu_torch.parallel.mesh import (
    ShardSpec, copy_to, gather_dim, gather_replicated, reduce_from,
)

Params = Dict[str, Any]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    #: checkpoint each layer (trade flops for device memory)
    remat: bool = True
    #: what the layer checkpoint saves (see :func:`remat_policy_for`):
    #: "dots_flash" (matmul outputs AND the flash forward's out/lse — the
    #: default: without them the backward re-runs the forward kernel every
    #: layer), "flash_rope", "flash", "dots", "dots_attn", "nothing",
    #: "attn", "attn_flash"
    remat_policy: str = "dots_flash"
    #: compute the LM loss over sequence chunks of this many positions
    #: (0 = whole sequence at once), so the [B, S, V] float32 logits never
    #: exist at once
    loss_chunk: int = 0
    #: tie lm_head to the embedding table (smaller models do)
    tie_embeddings: bool = False
    #: fuse the QKV (and gate/up) projections into single matmuls at use
    #: (concat-at-use: the parameter tree is unchanged)
    fuse_projections: bool = False
    # -- Gemma-family knobs (same decoder skeleton, different details) -----
    #: MLP activation: "silu" (Llama SwiGLU) or "gelu" (Gemma GeGLU, tanh)
    act: str = "silu"
    #: RMSNorm uses (1 + weight) (Gemma)
    norm_plus_one: bool = False
    #: scale embeddings by sqrt(dim) at input (Gemma)
    embed_scale: bool = False
    #: fixed head dim decoupled from dim/n_heads (Gemma: 256); 0 = dim/heads
    head_dim_fixed: int = 0
    #: zero-init the residual output projections (wo, w_down) of layers
    #: with index >= this value (0 = off)
    zero_init_deep_from: int = 0

    @property
    def head_dim(self) -> int:
        return self.head_dim_fixed or self.dim // self.n_heads

    def num_params(self) -> int:
        hd = self.head_dim
        per_layer = (
            self.dim * (self.n_heads * hd)  # wq
            + 2 * self.dim * (self.n_kv_heads * hd)  # wk, wv
            + (self.n_heads * hd) * self.dim  # wo
            + 3 * self.dim * self.ffn_dim  # gate, up, down
            + 2 * self.dim  # norms
        )
        embed = self.vocab_size * self.dim
        head = 0 if self.tie_embeddings else self.dim * self.vocab_size
        return embed + self.n_layers * per_layer + head + self.dim

    def flops_per_token(self) -> float:
        """Approximate training FLOPs/token (fwd+bwd ~= 6*N)."""
        return 6.0 * self.num_params()


# ---- presets ---------------------------------------------------------------

LLAMA3_8B = LlamaConfig()
LLAMA3_1B = LlamaConfig(
    vocab_size=128256, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
    ffn_dim=8192, tie_embeddings=True,
)
BENCH_350M = LlamaConfig(
    vocab_size=32768, dim=1024, n_layers=24, n_heads=16, n_kv_heads=8,
    ffn_dim=4096, max_seq=2048, loss_chunk=0, remat_policy="flash_rope",
)
TINY = LlamaConfig(
    vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
    max_seq=128, dtype=torch.float32, remat=False,
)
#: Gemma-2B: MQA, head_dim 256, GeGLU, (1+w) norms, sqrt(dim)-scaled tied
#: embeddings
GEMMA_2B = LlamaConfig(
    vocab_size=256000, dim=2048, n_layers=18, n_heads=8, n_kv_heads=1,
    ffn_dim=16384, max_seq=8192, rope_theta=10000.0, tie_embeddings=True,
    act="gelu", norm_plus_one=True, embed_scale=True, head_dim_fixed=256,
)
TINY_DEEP = dataclasses.replace(TINY, n_layers=4, zero_init_deep_from=2)
TINY_GEMMA = LlamaConfig(
    vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=1, ffn_dim=128,
    max_seq=128, dtype=torch.float32, remat=False, tie_embeddings=True,
    act="gelu", norm_plus_one=True, embed_scale=True, head_dim_fixed=32,
)

PRESETS = {
    "llama3-8b": LLAMA3_8B,
    "llama3-1b": LLAMA3_1B,
    "bench-350m": BENCH_350M,
    "gemma-2b": GEMMA_2B,
    "tiny-gemma": TINY_GEMMA,
    "tiny": TINY,
    "tiny-deep": TINY_DEEP,
}


def preset(name: str) -> LlamaConfig:
    return PRESETS[name]


# ---- init ------------------------------------------------------------------

#: rows drawn per call, so an 8B init never holds a whole f32 leaf
_INIT_CHUNK_ELEMS = 1 << 26


def _dense(shape, fan_in: int, cfg: LlamaConfig, generator: torch.Generator,
           device) -> torch.Tensor:
    """N(0, 1/fan_in) in float32, cast to the config dtype — the
    reference's distribution, drawn chunk by chunk along the leading
    dims to bound the float32 temporary."""
    out = torch.empty(shape, dtype=cfg.dtype, device=device)
    flat = out.view(-1, shape[-1])
    rows = max(1, _INIT_CHUNK_ELEMS // shape[-1])
    for r in range(0, flat.shape[0], rows):
        n = min(rows, flat.shape[0] - r)
        chunk = torch.randn((n, shape[-1]), generator=generator,
                            dtype=torch.float32, device=device)
        flat[r:r + n] = (chunk / math.sqrt(fan_in)).to(cfg.dtype)
    return out


def _param_tree(cfg: LlamaConfig, dense, norm) -> Params:
    """The reference's parameter tree (``llama.py:240-256``), each leaf
    made by ``dense(name, shape, fan_in)`` or ``norm(name, shape)`` in the
    reference's order (``name``: the leaf's path, ``"layers/wq"``)."""
    hd = cfg.head_dim
    L, D, Fd, V = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.vocab_size
    H, KV = cfg.n_heads, cfg.n_kv_heads
    params: Params = {
        "embed": dense("embed", (V, D), D),
        "layers": {
            "attn_norm": norm("layers/attn_norm", (L, D)),
            "wq": dense("layers/wq", (L, D, H * hd), D),
            "wk": dense("layers/wk", (L, D, KV * hd), D),
            "wv": dense("layers/wv", (L, D, KV * hd), D),
            "wo": dense("layers/wo", (L, H * hd, D), H * hd),
            "mlp_norm": norm("layers/mlp_norm", (L, D)),
            "w_gate": dense("layers/w_gate", (L, D, Fd), D),
            "w_up": dense("layers/w_up", (L, D, Fd), D),
            "w_down": dense("layers/w_down", (L, Fd, D), Fd),
        },
        "final_norm": norm("final_norm", (D,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense("lm_head", (D, V), D)
    return params


def llama_init(cfg: LlamaConfig, generator: torch.Generator,
               device, shard: Optional["TrainShard"] = None) -> Params:
    """Seeded random init with the reference's distributions and tree
    (``llama.py:229-264``). ``generator`` must live on ``device``. With a
    ``shard`` (anything with ``local(name, leaf)``: a :class:`TrainShard`,
    a serving split's sink), each leaf is cut as it is drawn (the stream,
    and so every value, is the one-rank init's)."""

    def keep(name, t):
        return t if shard is None else shard.local(name, t)

    def dense(name, shape, fan_in):
        t = _dense(shape, fan_in, cfg, generator, device)
        if cfg.zero_init_deep_from and name in ("layers/wo", "layers/w_down"):
            t[cfg.zero_init_deep_from:] = 0  # before any cut of the leaf
        return keep(name, t)

    def norm(name, shape):
        fill = torch.zeros if cfg.norm_plus_one else torch.ones
        return keep(name, fill(shape, dtype=cfg.dtype, device=device))

    return _param_tree(cfg, dense, norm)


def param_like(cfg: LlamaConfig, device="meta") -> Params:
    """The parameter tree's shapes and dtypes as empty tensors (``meta``:
    no memory) — what a checkpoint restore fills."""

    def empty(_name, shape, _fan_in=None):
        return torch.empty(shape, dtype=cfg.dtype, device=device)

    return _param_tree(cfg, empty, empty)


def params_from_numpy(tree: Params, cfg: LlamaConfig, device) -> Params:
    """Carry a parameter tree of numpy arrays (e.g. the JAX package's
    params through ``np.asarray``) into the port's tree, as OWNED copies
    in the config dtype on ``device`` (``torch.from_numpy`` would share
    the host buffer). bf16 arrays go through float32, which is exact."""

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        t = torch.tensor(np.asarray(node, np.float32))
        return t.to(device=device, dtype=cfg.dtype)

    return walk(tree)


# ---- weight-only int8 (serving) ---------------------------------------------

#: weights quantized for serving (norms stay float: tiny and sensitive)
_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
#: elements a quantization pass takes at once (bounds its float32 copy)
_QUANT_CHUNK_ELEMS = 1 << 26


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q8" in w


def map_leaves(fn, tree):
    """``fn`` over every tensor of a nested dict (an int8 leaf's q8 and
    s8 included)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _quant_block(a: torch.Tensor, axis: int):
    a = a.float()
    s = torch.amax(torch.abs(a), dim=axis, keepdim=True) / 127.0
    s = torch.clamp(s, min=1e-8)
    q = torch.clamp(torch.round(a / s), -127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


def _quant_leaf(w: torch.Tensor, axis: int = -2) -> Dict[str, torch.Tensor]:
    """Symmetric int8 with the scale reduced over ``axis`` (the
    reference's ``_quant_leaf``): -2 for matmul weights (a per-output-
    column scale over the contraction axis, which the W8A16 kernel folds
    into the product), -1 for the embedding (per-token rows). ``q`` is
    rounded from the float32 scale before that scale is cast to bf16, as
    in the reference; round half to even in both. Done in slices along an
    axis the reduction does not cross, so the float32 copy stays small."""
    axis = axis % w.dim()
    along = 0 if axis != 0 else w.dim() - 1
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s_shape = list(w.shape)
    s_shape[axis] = 1
    s = torch.empty(s_shape, dtype=torch.bfloat16, device=w.device)
    per = max(1, _QUANT_CHUNK_ELEMS // max(1, w.numel() // w.shape[along]))
    for lo in range(0, w.shape[along], per):
        hi = min(lo + per, w.shape[along])
        qb, sb = _quant_block(w.narrow(along, lo, hi - lo), axis)
        q.narrow(along, lo, hi - lo).copy_(qb)
        s.narrow(along, lo, hi - lo).copy_(sb)
    return {"q8": q, "s8": s}


def quantize_params(params: Params, cfg: LlamaConfig) -> Params:
    """Weight-only int8 for the serving paths: the embedding (per row),
    the lm head and every layer matmul quantize; norms stay in their
    float dtype. Training never sees quantized params."""
    out: Params = dict(params)
    out["embed"] = _quant_leaf(params["embed"], axis=-1)
    if "lm_head" in params:
        out["lm_head"] = _quant_leaf(params["lm_head"])
    layers = dict(params["layers"])
    for key in _QUANT_KEYS:
        layers[key] = _quant_leaf(layers[key])
    out["layers"] = layers
    return out


def leaf_path(key: str) -> str:
    """A checkpoint leaf key (``['params']['layers']['wq']``) as the
    parameter tree's path (``layers/wq``)."""
    names = re.findall(r"\['([^']*)'\]", key)
    if names and names[0] == "params":
        names = names[1:]
    return "/".join(names)


def quantize_leaf_named(path: str, t: torch.Tensor):
    """:func:`quantize_params` for one leaf, by its path (``layers/wq``):
    what a restore or a serving split applies to each leaf as it lands,
    so the float tree is never held whole."""
    names = path.split("/")
    if len(names) >= 2 and names[-2] == "layers" and names[-1] in _QUANT_KEYS:
        return _quant_leaf(t)
    if names[-1] == "embed":
        return _quant_leaf(t, axis=-1)
    if names[-1] == "lm_head":
        return _quant_leaf(t)
    return t


def quantize_leaf_at(key: str, t: torch.Tensor):
    """:func:`quantize_leaf_named` by a checkpoint leaf key
    (``['params']['layers']['wq']``)."""
    return quantize_leaf_named(leaf_path(key), t)


def deq(w, dtype=None) -> torch.Tensor:
    """Dequantize an int8 leaf (``{"q8", "s8"}``): the exact product
    ``q8 * s8`` (float32 holds it exactly) rounded once to ``dtype``,
    by default the scale's bf16 — the reference's ``deq``. Identity for
    raw tensors.

    A float32 consumer takes the product unrounded (``dtype`` float32):
    that is what the reference computes where it runs compiled (its
    engine jits every model function), because XLA's excess precision
    (``xla_allow_excess_precision``, on by default) drops the bf16
    rounding of ``deq``'s product when the next op widens it to float32
    again — except through the tied head, see ``ops/w8a16.py``."""
    if is_quantized(w):
        return w8a16.deq_weight(w["q8"], w["s8"],
                                w["s8"].dtype if dtype is None else dtype,
                                bool(w.get("transposed", False)))
    return w


def params_nbytes(params) -> int:
    """Bytes the parameter tree holds on its device (a serving split's
    list of rank trees: the sum over the ranks)."""
    if isinstance(params, (list, tuple)):
        return sum(params_nbytes(p) for p in params)
    n = 0

    def add(t):
        nonlocal n
        n += t.numel() * t.element_size()
        return t

    map_leaves(add, params)
    return n


# ---- building blocks -------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float,
            plus_one: bool = False) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    w = weight.float()
    if plus_one:  # Gemma convention: weight is a residual around 1
        w = w + 1.0
    return (x * w).to(dtype)


def _act(cfg: LlamaConfig):
    if cfg.act == "silu":
        return F.silu
    return functools.partial(F.gelu, approximate="tanh")


@functools.lru_cache(maxsize=32)
def _rope_cached(head_dim: int, theta: float, seq_len: int,
                 device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    inv = 1.0 / (theta ** exps)
    t = torch.arange(seq_len, dtype=torch.float32)
    ang = torch.outer(t, inv)  # [S, hd/2]
    return torch.cos(ang).to(device), torch.sin(ang).to(device)


def rope_table(head_dim: int, theta: float, seq_len: int,
               device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [seq_len, head_dim/2] in float32 (computed on the
    host, cached per device: they are constants of the config)."""
    return _rope_cached(head_dim, float(theta), int(seq_len),
                        str(torch.device(device)))


def rope_freqs(cfg: LlamaConfig, seq_len: int,
               device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    return rope_table(cfg.head_dim, cfg.rope_theta, seq_len, device)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Split-halves rotation with tables already broadcast to x's rank."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; tables [S, hd/2]. The interleaved convention
    folded to split halves (equivalent under a fixed permutation of head
    dims; consistent between q and k)."""
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference attention (the numerics oracle): fp32 softmax, GQA via
    head grouping, -1e30 masking. q [B,S,H,hd], k/v [B,T,KV,hd]; ``mask``
    broadcasts against [B, KV, G, S, T]."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    group = H // KV
    qg = q.reshape(B, S, KV, group, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = scores / math.sqrt(hd)
    if causal:
        idx = torch.arange(S, device=q.device)
        cmask = idx[:, None] >= idx[None, :]
        scores = torch.where(cmask[None, None, None], scores, -1e30)
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, hd)


def gather_embed(embed, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """Token embedding lookup; an int8 embed gathers q8 rows and their
    per-row scales (the embed quantizes per row, see `_quant_leaf`) and
    forms the product as :func:`deq` does, rounded once to ``dtype``
    (default: the scale's bf16)."""
    t = tokens.long()
    if is_quantized(embed):
        return deq({"q8": embed["q8"][t], "s8": embed["s8"][t]}, dtype)
    return embed[t]


def lm_head_of(params: Params, cfg: LlamaConfig):
    """The head as :func:`_mm` takes it: ``[D, V]``, or an int8 leaf (a
    tied int8 embed as ``{"q8", "s8", "transposed": True}``)."""
    if not cfg.tie_embeddings:
        return params["lm_head"]
    e = params["embed"]
    if is_quantized(e):
        return {"q8": e["q8"], "s8": e["s8"], "transposed": True}
    return e.T


def _mm(h: torch.Tensor, w) -> torch.Tensor:
    """Every weight consumer of the serving path: ``h @ w`` for a raw
    tensor, ``h @ deq(w)`` for an int8 leaf — the W8A16 kernel on the
    card, its plain version on the CPU (``ops/w8a16.py``)."""
    if is_quantized(w):
        return w8a16.w8a16_matmul(h, w["q8"], w["s8"],
                                  bool(w.get("transposed", False)))
    return h @ w


def _embed_in(params: Params, tokens: torch.Tensor, cfg: LlamaConfig):
    x = gather_embed(params["embed"], tokens, cfg.dtype).to(cfg.dtype)
    if cfg.embed_scale:  # Gemma scales inputs by sqrt(dim)
        x = x * math.sqrt(cfg.dim)
    return x


def _layer(params: Params, i: int) -> Params:
    return {k: map_leaves(lambda a: a[i], v)
            for k, v in params["layers"].items()}


def _mlp(x: torch.Tensor, lp: Params, cfg: LlamaConfig,
         tp=None) -> torch.Tensor:
    """The MLP half of a block. ``tp``: ``(mesh, axes)`` of a tensor split
    (this rank's ffn columns; Megatron's f before, g after)."""
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps, cfg.norm_plus_one)
    if tp:
        h = copy_to(h, *tp)
    gate = _act(cfg)(_mm(h, lp["w_gate"]).float()).to(h.dtype)
    out = _mm(gate * _mm(h, lp["w_up"]), lp["w_down"])
    return x + (reduce_from(out, *tp) if tp else out)


def _last_logits(params, x, lengths, cfg):
    """Head matmul only at each row's last valid position (V is large)."""
    idx = torch.clamp(lengths.long() - 1, min=0)
    x_last = x[torch.arange(x.shape[0], device=x.device), idx]  # [B, D]
    return _mm(x_last, lm_head_of(params, cfg)).float()


# ---- training forward: remat policies, blocks, loss -------------------------

@torch.library.custom_op("kubedl_tpu::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """A named copy of ``x`` that a remat policy can save by its name (the
    counterpart of ``jax.ad_checkpoint.checkpoint_name``; a policy sees
    operators, never tensors). Only emitted for names the active policy
    saves, so it costs one copy of exactly what is kept."""
    return x.clone()


checkpoint_name.register_autograd(
    lambda ctx, grad: (grad, None),
    setup_context=lambda ctx, inputs, output: None,
)

#: name -> (saves matmul outputs, names saved), with the meaning of the
#: reference's jax.checkpoint policy of the same name
_REMAT_POLICIES = {
    "dots": (True, ()),
    "nothing": (False, ()),
    "attn": (False, ("attn_out",)),
    "dots_attn": (True, ("attn_out",)),
    "flash": (False, ("flash_out", "flash_lse")),
    "flash_rope": (False, ("flash_out", "flash_lse", "rope_out", "attn_v")),
    "attn_flash": (False, ("attn_out", "flash_out", "flash_lse")),
    "dots_flash": (True, ("flash_out", "flash_lse")),
}


def remat_policy_for(name: str):
    """Map a config string to a selective-checkpoint policy function for
    ``torch.utils.checkpoint.create_selective_checkpoint_contexts``.

    "dots" saves the matmul outputs (``aten.mm``: products without batch
    dims, like ``dots_with_no_batch_dims_saveable``), "nothing" nothing;
    the other names save the tensors tagged with those names
    (:func:`checkpoint_name`) and/or, for "flash_out"/"flash_lse", the
    outputs of the ``kubedl_tpu::flash_fwd`` operator (out and lse
    together). PyTorch replays the whole layer in the backward and skips
    only the saved operators, so a saved name spares the kernel launch,
    not the (cheap) ops that fed it. The returned function carries the
    saved names as ``.names``. An unknown name raises."""
    from torch.utils.checkpoint import CheckpointPolicy

    import kubedl_tpu_torch.ops.flash_attention  # noqa: F401 (registers flash_fwd)

    try:
        saves_dots, names = _REMAT_POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown remat_policy {name!r}") from None
    dots = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    flash_fwd = torch.ops.kubedl_tpu.flash_fwd.default
    tag = torch.ops.kubedl_tpu.checkpoint_name.default

    def policy(ctx, op, *args, **kwargs):
        if (saves_dots and op in dots) \
                or (op == flash_fwd and "flash_out" in names) \
                or (op == tag and args[1] in names):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    policy.names = names
    return policy


def _tag(x: torch.Tensor, name: str, names) -> torch.Tensor:
    return checkpoint_name(x, name) if name in names else x


def _block(x: torch.Tensor, lp: Params, cfg: LlamaConfig, cos, sin,
           attn_fn=None, names=(), tp=None) -> torch.Tensor:
    """One decoder block (the reference's ``_block``). With an
    ``attn_fn`` that has ``fused_rope``, q/k go in PRE-rope with the
    tables; otherwise RoPE is applied here. ``names`` are the tags the
    active remat policy saves. Head and ffn counts come from the WEIGHT
    shapes, so under a tensor split (``tp``: ``(mesh, axes)``, the
    reference's ``tp_axis``) the block runs this rank's H/tp query heads,
    KV/tp KV heads and ffn/tp columns, and the outputs of ``wo`` and
    ``w_down`` are all-reduced over the axes (the reference's psums at
    ``llama.py:478`` and ``:492``)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    po = cfg.norm_plus_one
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps, po)
    if tp:
        h = copy_to(h, *tp)
    n_heads = lp["wq"].shape[-1] // hd
    n_kv = lp["wk"].shape[-1] // hd
    if cfg.fuse_projections:
        # one [D, (H+2KV)*hd] matmul; autograd slices the grad back apart
        qkv = h @ torch.cat([lp["wq"], lp["wk"], lp["wv"]], dim=1)
        dq_w, dkv_w = n_heads * hd, n_kv * hd
        q = qkv[..., :dq_w].reshape(B, S, n_heads, hd)
        k = qkv[..., dq_w:dq_w + dkv_w].reshape(B, S, n_kv, hd)
        v = qkv[..., dq_w + dkv_w:].reshape(B, S, n_kv, hd)
    else:
        q = (h @ lp["wq"]).reshape(B, S, n_heads, hd)
        k = (h @ lp["wk"]).reshape(B, S, n_kv, hd)
        v = (h @ lp["wv"]).reshape(B, S, n_kv, hd)
    if getattr(attn_fn, "fused_rope", False):
        q = _tag(q, "rope_out", names)
        k = _tag(k, "rope_out", names)
        v = _tag(v, "attn_v", names)
        attn = attn_fn(q, k, v, rope_cos=cos, rope_sin=sin)
    else:
        q = _tag(apply_rope(q, cos, sin), "rope_out", names)
        k = _tag(apply_rope(k, cos, sin), "rope_out", names)
        v = _tag(v, "attn_v", names)
        attn = (attn_fn or attention)(q, k, v)
    attn = _tag(attn.reshape(B, S, n_heads * hd), "attn_out", names)
    attn_out = attn @ lp["wo"]  # row-parallel: partial sums under tp
    x = x + (reduce_from(attn_out, *tp) if tp else attn_out)
    if not cfg.fuse_projections:
        return _mlp(x, lp, cfg, tp)
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps, po)
    Fd = lp["w_gate"].shape[-1]
    g_u = h @ torch.cat([lp["w_gate"], lp["w_up"]], dim=1)
    gate = _act(cfg)(g_u[..., :Fd].float()).to(h.dtype)
    return x + (gate * g_u[..., Fd:]) @ lp["w_down"]


def llama_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                 attn_fn=None) -> torch.Tensor:
    """tokens [B, S] -> final-norm hidden states [B, S, D]. The layer
    loop is a Python loop; with ``cfg.remat`` each layer runs under a
    non-reentrant ``torch.utils.checkpoint`` whose selective policy is
    ``remat_policy_for(cfg.remat_policy)``."""
    S = tokens.shape[1]
    x = _embed_in(params, tokens, cfg)
    cos, sin = rope_freqs(cfg, S, device=x.device)
    x, _ = remat_layers(_block, x, params["layers"], cfg.remat,
                        cfg.remat_policy, cfg, cos, sin, attn_fn)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_plus_one)


def llama_forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                  attn_fn=None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] (float32)."""
    x = llama_hidden(params, tokens, cfg, attn_fn)
    return (x @ lm_head_of(params, cfg)).float()


def llama_loss(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
               attn_fn=None) -> torch.Tensor:
    """Next-token cross entropy over tokens[:, 1:] (the forward runs on
    the full sequence). With ``cfg.loss_chunk`` the head matmul and
    softmax run chunk by chunk."""
    if cfg.loss_chunk:
        x = llama_hidden(params, tokens, cfg, attn_fn)
        return chunked_next_token_nll(x, lm_head_of(params, cfg), tokens,
                                      cfg.loss_chunk)
    return next_token_nll(llama_forward(params, tokens, cfg, attn_fn), tokens)


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL: logits [B, S, V] (full sequence) scored against
    tokens shifted by one."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = tokens[:, 1:].long()
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def _chunk_nll_sum(xc, head, tc):
    logp = torch.log_softmax((xc @ head).float(), dim=-1)
    return -logp.gather(-1, tc.long()[..., None]).sum()


def chunked_next_token_nll(x: torch.Tensor, head: torch.Tensor,
                           tokens: torch.Tensor, chunk: int) -> torch.Tensor:
    """Same mean NLL as :func:`next_token_nll` over sequence chunks: each
    chunk's logits are recomputed in the backward (checkpointed, nothing
    saved), so peak loss memory is [B, chunk, V]."""
    from torch.utils.checkpoint import checkpoint

    B, S = tokens.shape
    n_pos = S - 1
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, n_pos, chunk):
        c1 = min(c0 + chunk, n_pos)
        total = total + checkpoint(_chunk_nll_sum, x[:, c0:c1], head,
                                   tokens[:, c0 + 1:c1 + 1],
                                   use_reentrant=False)
    return total / (B * n_pos)


# ---- model sharding: fsdp, the Megatron tensor split, sp ---------------------

def param_pspecs(cfg: LlamaConfig) -> Params:
    """Megatron tensor split + fsdp, stacked-layer aware: the reference's
    rules (``llama.py:267``) as a tree of tuples, one mesh-axis name (or
    None) a dimension. Column-parallel (output dim on "tensor"): wq/wk/wv,
    w_gate/w_up; row-parallel (input dim on "tensor"): wo, w_down; fsdp
    shards the other matmul dim. Embedding: vocab on tensor, dim on fsdp;
    the untied head: dim on fsdp, vocab on tensor."""
    specs: Params = {
        "embed": ("tensor", "fsdp"),
        "layers": {
            "attn_norm": (None, None),
            "wq": (None, "fsdp", "tensor"),
            "wk": (None, "fsdp", "tensor"),
            "wv": (None, "fsdp", "tensor"),
            "wo": (None, "tensor", "fsdp"),
            "mlp_norm": (None, None),
            "w_gate": (None, "fsdp", "tensor"),
            "w_up": (None, "fsdp", "tensor"),
            "w_down": (None, "tensor", "fsdp"),
        },
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("fsdp", "tensor")
    return specs


def _at(tree, name: str):
    for part in name.split("/"):
        tree = tree[part]
    return tree


def named_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` of a nested dict, keys sorted (the reference's
    tree order); a path joins the keys with "/" (``"layers/wq"``)."""
    for k in sorted(tree):
        name = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            yield from named_leaves(tree[k], name + "/")
        else:
            yield name, tree[k]


def prune_specs(specs: Params, names) -> Dict[str, tuple]:
    """A tree of specs by leaf path, an axis the mesh does not name
    (``names``) dropped (the reference's ``_prune_spec``)."""
    return {path: tuple(a if a in names else None for a in spec)
            for path, spec in named_leaves(specs)}


#: mesh axis -> the config fields it must divide (the reference's
#: ``_validate_pipe_divisibility`` order: pipe, tensor, expert; then what
#: the port's own layout splits: the vocabulary over tensor, the width
#: over fsdp)
_DIVIDES = (("pipe", ("n_layers",)),
            ("tensor", ("n_heads", "n_kv_heads", "ffn_dim")),
            ("expert", ("n_experts",)),
            ("tensor", ("vocab_size",)),
            ("fsdp", ("dim",)))


def check_divisible(cfg, mesh) -> None:
    """Raise the reference's ``ValueError`` when an axis above 1 does not
    split a dimension it shards evenly."""
    for axis, attrs in _DIVIDES:
        n = mesh.shape.get(axis, 1)
        for attr in attrs:
            val = getattr(cfg, attr, None)
            if n > 1 and val is not None and val % n:
                raise ValueError(f"{attr}={val} not divisible by {axis}={n}")


class TrainShard:
    """This rank's part of a model sharded over the ``fsdp``, ``tensor``,
    ``sp``, ``expert`` and ``pipe`` axes of a ``ProcessMesh``, and (for
    Llama) the training loss that runs on it; ``models/moe.py``'s
    ``MoEShard`` is the switch-MoE family's.

    Each leaf is held as the region its spec gives this rank's
    coordinates: ``specs``, a tree of specs (default :func:`param_pspecs`;
    the trainer passes the pipe layout of the reference's
    ``_pipe_pspecs`` in pipeline mode), axes the mesh does not name
    dropped, as the reference's ``_prune_spec`` does. The forward
    gathers each stacked layer's fsdp shards when its block runs (inside
    the layer's remat, so
    a recompute gathers them again; the gradient is reduce-scattered back
    to the shard), runs this rank's heads and ffn columns with the
    Megatron all-reduces (``_block``'s ``tp``), and, with ``sp``, this
    rank's block of the sequence with RoPE at global positions through
    the context attention (``parallel/ring.py``). The embedding and the
    head are GATHERED whole (fsdp, then the vocab over tensor, whose
    gradient is this rank's block: every tensor rank runs the same
    head on the same inputs), so the loss is the plain log-softmax over
    the whole vocabulary; no vocab-parallel logsumexp.

    :meth:`loss` returns this rank's share of the global mean: the sum of
    its valid positions' NLL over the mean count a batch rank scores
    (``rows * (S - 1) / sp``), so the mean over the batch-like ranks
    (replica x data x fsdp x sp) of these is the reference's loss and
    the sum of their gradients, over that count, its gradient."""

    def __init__(self, cfg, mesh, specs: Optional[Params] = None) -> None:
        self.cfg, self.mesh = cfg, mesh
        #: leaf path -> its pruned spec
        self.specs = prune_specs(param_pspecs(cfg) if specs is None
                                 else specs, set(mesh.axis_names))
        on = lambda a: mesh.shape.get(a, 1) > 1  # noqa: E731
        #: ``(mesh, axes)`` of the tensor split, or None
        self.tp = (mesh, ("tensor",)) if on("tensor") else None
        #: ``(mesh, axes)`` of the expert split, or None
        self.ep = (mesh, ("expert",)) if on("expert") else None
        self.fsdp = on("fsdp")
        self.sp = mesh.shape.get("sp", 1)
        check_divisible(cfg, mesh)

    # ---- layout ---------------------------------------------------------------

    def region(self, name: str, shape) -> Optional[ShardSpec]:
        """Where this rank's shard of leaf ``name`` (global ``shape``)
        sits; None for a leaf no axis above 1 splits. ``write``: the
        shard's first replica (coordinate 0 on every axis above 1 that
        does not split the leaf) saves it."""
        mesh, spec = self.mesh, self.specs[name]
        split = [a for a in spec if a and mesh.shape.get(a, 1) > 1]
        if not split:
            return None
        starts, stops = [], []
        for a, n in zip(spec, shape):
            k = n // mesh.shape[a] if a in split else n
            c = mesh.coords[a] if a in split else 0
            starts.append(c * k)
            stops.append((c + 1) * k)
        write = all(mesh.coords[a] == 0 for a in mesh.active(mesh.axis_names)
                    if a not in split)
        return ShardSpec(tuple(shape), tuple(starts), tuple(stops), write)

    def regions(self, like: Params) -> list:
        """:meth:`region` of every leaf of ``like``, in tree order."""
        return [self.region(name, tuple(t.shape)) for name, t in named_leaves(like)]

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole leaf ``t`` (an owned copy)."""
        r = self.region(name, tuple(t.shape))
        return t if r is None else r.take(t).clone()

    def shard(self, params: Params) -> Params:
        """A global parameter tree to this rank's shards."""
        return _map_named(params, self.local)

    def assemble(self, params: Params) -> Params:
        """This rank's shards back to the global tree (every rank calls
        it: the shards are all-gathered)."""
        from kubedl_tpu_torch.parallel.mesh import _gather

        def whole(name, t):
            for d, a in enumerate(self.specs[name]):
                if a and self.mesh.shape.get(a, 1) > 1:
                    t = _gather(self.mesh, t, (a,), d)
            return t.contiguous()

        with torch.no_grad():
            return _map_named(params, whole)

    # ---- the forward ----------------------------------------------------------

    def gather_whole(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """A non-layer leaf (embedding, head) whole: fsdp gathered, then
        the tensor split gathered for a computation every tensor rank
        repeats."""
        spec = self.specs[name]
        for d, a in enumerate(spec):
            if a == "fsdp" and self.fsdp:
                t = gather_dim(t, self.mesh, ("fsdp",), d)
        for d, a in enumerate(spec):
            if a == "tensor" and self.tp:
                t = gather_replicated(t, self.mesh, ("tensor",), d)
        return t

    def gather_layer(self, lp: Params) -> Params:
        """One layer's slices, each fsdp-gathered (tensor stays split)."""
        if not self.fsdp:
            return lp
        out = {}
        for key, t in lp.items():
            spec = self.specs[f"layers/{key}"][1:]
            out[key] = gather_dim(t, self.mesh, ("fsdp",), spec.index("fsdp")) \
                if "fsdp" in spec else t
        return out

    def _layer_block(self, x, lp, cos, sin, attn_fn, names):
        return _block(x, self.gather_layer(lp), self.cfg, cos, sin, attn_fn,
                      names, self.tp)

    def loss(self, params: Params, tokens: torch.Tensor,
             attn_fn=None) -> torch.Tensor:
        """This rank's share of the mean next-token NLL (see the class
        docstring). ``tokens``: this rank's rows; with sp, its block of
        the sequence and one more column, the next block's first token
        (a pad on the last block, whose last position scores nothing)."""
        cfg = self.cfg
        rows = tokens.shape[0]
        if self.sp > 1:
            inp, tgt = tokens[:, :-1], tokens[:, 1:]
            Sl = inp.shape[1]
            S = Sl * self.sp
            off = self.mesh.coords["sp"] * Sl
            valid = Sl - (off + Sl == S)
        else:
            inp, tgt = tokens, tokens[:, 1:]
            Sl = S = inp.shape[1]
            off, valid = 0, S - 1
        embed = self.gather_whole(params["embed"], "embed")
        x = embed[inp.long()].to(cfg.dtype)
        if cfg.embed_scale:
            x = x * math.sqrt(cfg.dim)
        cos, sin = rope_freqs(cfg, off + Sl, device=x.device)
        cos, sin = cos[off:], sin[off:]
        x, _ = remat_layers(self._layer_block, x, params["layers"], cfg.remat,
                            cfg.remat_policy, cos, sin, attn_fn)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_plus_one)
        head = embed.T if cfg.tie_embeddings else \
            self.gather_whole(params["lm_head"], "lm_head")
        xs, ts = x[:, :valid], tgt[:, :valid]
        if cfg.loss_chunk:  # chunks within this rank's block
            total = torch.zeros((), dtype=torch.float32, device=x.device)
            for c0 in range(0, valid, cfg.loss_chunk):
                c1 = min(c0 + cfg.loss_chunk, valid)
                total = total + checkpoint(_chunk_nll_sum, xs[:, c0:c1], head,
                                           ts[:, c0:c1], use_reentrant=False)
        else:
            total = _chunk_nll_sum(xs, head, ts)
        return total / (rows * (S - 1) / self.sp)


def remat_layers(step, x, layer_params: Params, remat: bool,
                 policy_name: str, *args):
    """``x = step(x, layer i, *args, names)`` over the stacked
    ``layer_params`` (as many layers as their ``attn_norm`` has rows),
    each layer a non-reentrant ``torch.utils.checkpoint`` whose selective
    policy is ``remat_policy_for(policy_name)`` when ``remat`` (``names``:
    the tags it saves; ``()`` without remat). ``step`` returns ``x`` or
    ``(x, aux)``. Returns ``x`` and the list of auxes (empty when ``step``
    returns none)."""
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts,
    )

    auxes = []
    policy = remat_policy_for(policy_name) if remat else None
    ctx_fn = functools.partial(create_selective_checkpoint_contexts, policy)
    for i in range(layer_params["attn_norm"].shape[0]):
        lp = {k: map_leaves(lambda a: a[i], v) for k, v in
              layer_params.items()}
        if remat:
            out = checkpoint(step, x, lp, *args, policy.names,
                             use_reentrant=False, context_fn=ctx_fn)
        else:
            out = step(x, lp, *args, ())
        if isinstance(out, tuple):
            x, aux = out
            auxes.append(aux)
        else:
            x = out
    return x, auxes


def pipeline_hooks(cfg: LlamaConfig, shard: TrainShard):
    """The family's adapter for the GPipe pipeline (the reference's
    ``pipeline_hooks``, ``llama.py:662``): embed / rope / the stage body /
    head + loss, on ``shard``'s layout (its gathers of the embedding and
    the head). The stage runs this rank's slice of the stacked layers
    under the config's remat policy, with the Megatron split inside when
    ``tp`` is given."""
    from kubedl_tpu_torch.parallel.pipeline import PipelineHooks

    def embed(params, tokens):
        e = shard.gather_whole(params["embed"], "embed")
        x = e[tokens.long()].to(cfg.dtype)
        return x * math.sqrt(cfg.dim) if cfg.embed_scale else x

    def make_stage(attn_fn, cos, sin, tp=None, ep=None):
        del ep

        def step(x, lp, names):
            return _block(x, lp, cfg, cos, sin, attn_fn, names, tp)

        def stage_fn(layer_params, x):
            x, _ = remat_layers(step, x, layer_params, cfg.remat,
                                cfg.remat_policy)
            return x, torch.zeros((), dtype=torch.float32, device=x.device)

        return stage_fn

    def head_loss(params, h, tokens, aux_mean):
        del aux_mean
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.norm_plus_one)
        head = shard.gather_whole(params["embed"], "embed").T \
            if cfg.tie_embeddings else \
            shard.gather_whole(params["lm_head"], "lm_head")
        if cfg.loss_chunk:
            return chunked_next_token_nll(h, head, tokens, cfg.loss_chunk)
        return next_token_nll((h @ head).float(), tokens)

    return PipelineHooks(
        embed=embed,
        rope=lambda S, device: rope_freqs(cfg, S, device=device),
        make_stage=make_stage, head_loss=head_loss, n_layers=cfg.n_layers)


def _map_named(tree: Params, fn, prefix: str = "") -> Params:
    return {k: _map_named(v, fn, f"{prefix}{k}/") if isinstance(v, dict)
            else fn(f"{prefix}{k}", v) for k, v in tree.items()}


# ---- paged KV (block-table serving path) -----------------------------------

def merge_chain_tokens(last: torch.Tensor, ids: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Graft prefill-sampled first tokens ``ids`` [B] into a device token
    chain ``last`` [B, 1] where ``mask`` [B] is True (rows just
    prefilled); other rows keep their chain token."""
    return torch.where(mask[:, None], ids[:, None], last)


def init_paged_cache(cfg: LlamaConfig, batch: int, max_seq: int,
                     num_blocks: int, block_size: int, device) -> Params:
    """Paged serving cache: K/V pools ``[L, NB, BS, KV, hd]`` + per-row
    positions + the ``[B, MB]`` block table (all entries start at the
    trash block 0). ``max_seq`` must be a multiple of ``block_size``."""
    if max_seq % block_size != 0:
        raise ValueError(
            f"max_seq {max_seq} not a multiple of block_size {block_size}"
        )
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "bt": torch.zeros((batch, max_seq // block_size), dtype=torch.int32,
                          device=device),
    }


def _paged_view(pool: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Gather one layer's pool [NB, BS, KV, hd] through the block table
    [B, MB] into the logical [B, MB*BS, KV, hd] view (the gather oracle)."""
    B, MB = bt.shape
    BS = pool.shape[1]
    return pool[bt.long()].reshape(B, MB * BS, pool.shape[2], pool.shape[3])


def _check_kv_attention(kv_attention: str) -> None:
    if kv_attention not in ("gather", "blocked"):
        raise ValueError(
            f"kv_attention must be 'gather' or 'blocked', got "
            f"{kv_attention!r}"
        )


def paged_decode_step_batched(
    params: Params, cache: Params, tokens: torch.Tensor, cfg: LlamaConfig,
    kv_attention: str = "gather",
) -> Tuple[torch.Tensor, Params]:
    """One decode step for every row: write the step's K/V at
    ``(bt[b, pos//BS], pos%BS)`` and attend ``t <= pos`` (the current
    token included). ``"gather"`` scatters, then runs dense masked
    attention over the gathered view (the oracle); ``"blocked"`` hands
    the step's K/V to the fused kernel, which writes and attends in one
    launch per layer. Returns float32 logits [B, V] and the cache,
    updated in place (pools, and ``pos`` advanced by one, clamped)."""
    _check_kv_attention(kv_attention)
    B = tokens.shape[0]
    hd = cfg.head_dim
    dev = tokens.device
    pos = cache["pos"]
    bt = cache["bt"]
    BS = cache["k"].shape[2]
    max_s = bt.shape[1] * BS
    pos_l = pos.long()
    x = _embed_in(params, tokens, cfg)  # [B, 1, D]
    cos, sin = rope_freqs(cfg, max_s, device=dev)
    cos_t = cos[pos_l][:, None, None, :]
    sin_t = sin[pos_l][:, None, None, :]
    valid = torch.arange(max_s, device=dev)[None, :] <= pos_l[:, None]
    mask = valid[:, None, None, None, :]
    blk = bt.long()[torch.arange(B, device=dev), pos_l // BS]
    off = pos_l % BS
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        ckp, cvp = cache["k"][i], cache["v"][i]
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps, cfg.norm_plus_one)
        q = _rotate(_mm(h, lp["wq"]).reshape(B, 1, cfg.n_heads, hd), cos_t, sin_t)
        k = _rotate(_mm(h, lp["wk"]).reshape(B, 1, cfg.n_kv_heads, hd),
                    cos_t, sin_t)
        v = _mm(h, lp["wv"]).reshape(B, 1, cfg.n_kv_heads, hd)
        if kv_attention == "blocked":
            attn, _, _ = blocked_attention.paged_attention(
                q, ckp, cvp, bt, pos, new_k=k[:, 0], new_v=v[:, 0]
            )
        else:
            ckp[blk, off] = k[:, 0]
            cvp[blk, off] = v[:, 0]
            attn = attention(q, _paged_view(ckp, bt), _paged_view(cvp, bt),
                             causal=False, mask=mask)
        x = x + _mm(attn.reshape(B, 1, cfg.n_heads * hd), lp["wo"])
        x = _mlp(x, lp, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_plus_one)
    logits = _mm(x[:, 0], lm_head_of(params, cfg)).float()
    cache["pos"] = torch.clamp(pos + 1, max=max_s - 1).to(torch.int32)
    return logits, cache


def paged_decode_segment(
    params: Params,
    cache: Params,
    tokens: torch.Tensor,  # [B, 1] first input token per row
    temps: torch.Tensor,  # [B] sampling temperature; <= 0 = greedy
    generator: Optional[torch.Generator],
    cfg: LlamaConfig,
    n_steps: int,
    greedy: bool = False,
    kv_attention: str = "gather",
    nonfinite: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """``n_steps`` decode steps with on-device sampling: each step's
    sampled ids feed the next step without leaving the device. Greedy is
    argmax; sampled rows (temps > 0) take Gumbel-max over
    ``logits / temp`` with noise from ``generator`` (on the cache's
    device), one draw per step shared by the batch. ``nonfinite`` (an
    int64 scalar on the device), when given, accumulates the count of
    non-finite logits without a host sync. Returns (ids [B, n_steps],
    last ids [B, 1], cache)."""
    toks = tokens
    out = []
    for _ in range(n_steps):
        logits, cache = paged_decode_step_batched(
            params, cache, toks, cfg, kv_attention=kv_attention
        )
        if nonfinite is not None:
            nonfinite += (~torch.isfinite(logits)).sum()
        if greedy:
            z = logits
        else:
            g = -torch.log(torch.empty_like(logits).exponential_(
                generator=generator))
            z = torch.where(
                temps[:, None] > 0.0,
                logits / torch.clamp(temps[:, None], min=1e-4) + g,
                logits,
            )
        toks = torch.argmax(z, dim=-1).to(torch.int32)[:, None]
        out.append(toks[:, 0])
    return torch.stack(out, dim=1), toks, cache


def _paged_suffix_forward(
    params: Params,
    cache: Params,
    tokens: torch.Tensor,  # [B, S] right-padded suffix tokens
    lengths: torch.Tensor,  # [B] suffix lengths; 0 = row untouched
    starts: torch.Tensor,  # [B] per-row global start offset
    cfg: LlamaConfig,
    kv_attention: str = "gather",
    self_contained: bool = False,
    positions: Optional[torch.Tensor] = None,  # [B, S] per-token positions
    self_mask: Optional[torch.Tensor] = None,  # [B, S, S] in-suffix mask
) -> Tuple[torch.Tensor, Params]:
    """Shared body of paged prefill and speculative verify: run suffix
    tokens at global positions ``starts[b] + s`` (offset causal mask
    ``t <= starts[b] + s``), scattering their K/V into each row's blocks
    before attending. Pad positions (``s >= lengths[b]``) and inactive
    rows write to the trash block. Returns (final-norm hidden states
    [B, S, D], cache updated in place).

    ``self_contained=True`` is the READ-ONLY scoring mode behind
    :func:`paged_verify_multi` / :func:`paged_verify_tree`: the pool is
    never written; each query attends committed history ``t < starts``
    merged with the suffix's own fresh K/V under an in-suffix causal mask
    (or ``self_mask[b, s, t]``), the same key set the write path would
    see. ``positions`` overrides the consecutive layout ``starts[b] + s``
    (trie nodes of one depth share a RoPE angle). Both are read-only-mode
    only; the returned cache is the input cache, untouched."""
    _check_kv_attention(kv_attention)
    if (positions is not None or self_mask is not None) \
            and not self_contained:
        raise ValueError("positions/self_mask require self_contained=True")
    B, S = tokens.shape
    hd = cfg.head_dim
    dev = tokens.device
    bt = cache["bt"]
    BS = cache["k"].shape[2]
    max_s = bt.shape[1] * BS
    starts = starts.to(device=dev, dtype=torch.int32).contiguous()
    lengths_l = lengths.long()
    active = lengths_l > 0
    x = _embed_in(params, tokens, cfg)
    cos_full, sin_full = rope_freqs(cfg, max_s, device=dev)
    ar = torch.arange(S, device=dev)
    if positions is None:
        posq = torch.clamp(starts.long()[:, None] + ar[None, :],
                           max=max_s - 1)
    else:
        posq = torch.clamp(positions.long(), max=max_s - 1)
    cos_t = cos_full[posq][:, :, None, :]
    sin_t = sin_full[posq][:, :, None, :]
    tpos = torch.arange(max_s, device=dev)
    if self_contained:
        # pool history (t < starts) ++ the in-suffix block: the key set
        # the write path exposes, without the writes
        hist = (tpos[None, None, :] < starts.long()[:, None, None]).expand(
            B, S, max_s)
        if self_mask is None:
            own = (ar[None, :] <= ar[:, None])[None].expand(B, S, S)
        else:
            own = self_mask.bool()
        mask = torch.cat([hist, own], dim=-1)[:, None, None]
    else:
        mask = (tpos[None, None, :]
                <= posq[:, :, None])[:, None, None]  # [B, 1, 1, S, T]
    writable = active[:, None] & (ar[None, :] < lengths_l[:, None])
    rows = torch.arange(B, device=dev)[:, None]
    blk = torch.where(writable, bt.long()[rows, posq // BS], 0)
    off = posq % BS
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        ckp, cvp = cache["k"][i], cache["v"][i]
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps, cfg.norm_plus_one)
        q = _rotate(_mm(h, lp["wq"]).reshape(B, S, cfg.n_heads, hd), cos_t, sin_t)
        k = _rotate(_mm(h, lp["wk"]).reshape(B, S, cfg.n_kv_heads, hd),
                    cos_t, sin_t)
        v = _mm(h, lp["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
        if not self_contained:
            ckp[blk, off] = k
            cvp[blk, off] = v
        if kv_attention == "blocked":
            if self_contained:
                attn = blocked_attention.paged_attention(
                    q, ckp, cvp, bt, starts, self_k=k, self_v=v,
                    self_mask=self_mask)
            else:
                attn = blocked_attention.paged_attention(q, ckp, cvp, bt,
                                                         starts)
        elif self_contained:
            attn = attention(
                q, torch.cat([_paged_view(ckp, bt), k], dim=1),
                torch.cat([_paged_view(cvp, bt), v], dim=1),
                causal=False, mask=mask)
        else:
            attn = attention(q, _paged_view(ckp, bt), _paged_view(cvp, bt),
                             causal=False, mask=mask)
        x = x + _mm(attn.reshape(B, S, cfg.n_heads * hd), lp["wo"])
        x = _mlp(x, lp, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_plus_one)
    if self_contained:
        return x, cache
    new_pos = torch.clamp(starts.long() + lengths_l, max=max_s - 1)
    cache["pos"] = torch.where(active, new_pos,
                               cache["pos"].long()).to(torch.int32)
    return x, cache


def paged_prefill_batched(
    params: Params, cache: Params, tokens: torch.Tensor,
    lengths: torch.Tensor, cfg: LlamaConfig,
) -> Tuple[torch.Tensor, Params]:
    """Whole prompts from position 0 in one forward: last-token logits
    [B, V] + the cache (updated in place). Prompts attend only their own
    fresh K/V, so attention is the dense causal oracle (no pool read, no
    kernel), exactly as in the reference; only the cache write differs
    from a contiguous prefill (scatter into blocks; pad positions and
    inactive rows write to the trash block)."""
    B, S = tokens.shape
    hd = cfg.head_dim
    dev = tokens.device
    bt = cache["bt"]
    BS = cache["k"].shape[2]
    max_s = bt.shape[1] * BS
    lengths_l = lengths.long()
    active = lengths_l > 0
    x = _embed_in(params, tokens, cfg)
    cos, sin = rope_freqs(cfg, S, device=dev)
    ar = torch.arange(S, device=dev)
    posw = torch.clamp(ar, max=max_s - 1)
    writable = active[:, None] & (ar[None, :] < lengths_l[:, None])
    blk = torch.where(writable, bt.long()[:, posw // BS], 0)  # [B, S]
    off = (posw % BS)[None, :].expand(B, S)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps, cfg.norm_plus_one)
        q = apply_rope(_mm(h, lp["wq"]).reshape(B, S, cfg.n_heads, hd), cos, sin)
        k = apply_rope(_mm(h, lp["wk"]).reshape(B, S, cfg.n_kv_heads, hd),
                       cos, sin)
        v = _mm(h, lp["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
        attn = attention(q, k, v, causal=True)
        x = x + _mm(attn.reshape(B, S, cfg.n_heads * hd), lp["wo"])
        x = _mlp(x, lp, cfg)
        cache["k"][i][blk, off] = k
        cache["v"][i][blk, off] = v
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_plus_one)
    logits = _last_logits(params, x, lengths, cfg)
    new_pos = torch.clamp(lengths_l, max=max_s - 1)
    cache["pos"] = torch.where(active, new_pos,
                               cache["pos"].long()).to(torch.int32)
    return logits, cache


def paged_prefill_from(
    params: Params, cache: Params, tokens: torch.Tensor,
    lengths: torch.Tensor, starts: torch.Tensor, cfg: LlamaConfig,
    kv_attention: str = "gather",
) -> Tuple[torch.Tensor, Params]:
    """Suffix prefill at per-row ``starts`` (a chunk of a long prompt, or
    the tail after a cached prefix): last-token logits + cache. With
    ``kv_attention="blocked"`` every layer's attention is one launch of
    the blocked kernel."""
    x, cache = _paged_suffix_forward(
        params, cache, tokens, lengths, starts, cfg,
        kv_attention=kv_attention,
    )
    return _last_logits(params, x, lengths, cfg), cache


def paged_verify(
    params: Params, cache: Params,
    tokens: torch.Tensor,  # [B, S]: [last accepted token, draft_1..draft_k]
    lengths: torch.Tensor,  # [B] k+1 for verifying rows, 0 = untouched
    starts: torch.Tensor,  # [B] row position before the verify
    cfg: LlamaConfig, kv_attention: str = "gather",
) -> Tuple[torch.Tensor, Params]:
    """Speculative verify: score a draft-extended suffix in ONE forward
    (the write path: with ``"blocked"`` every layer launches the blocked
    kernel at S = k+1) and return the target's greedy ids [B, S] —
    ``ids[b, j]`` is the argmax after consuming ``tokens[b, j]``. The
    host accepts the longest agreeing draft prefix plus the bonus token;
    rejected-suffix K/V stays in the row's blocks beyond the rolled-back
    position (the engine rewinds its pos mirror and frees the blocks)."""
    x, cache = _paged_suffix_forward(
        params, cache, tokens, lengths, starts, cfg,
        kv_attention=kv_attention,
    )
    logits = _mm(x, lm_head_of(params, cfg)).float()  # [B, S, V]
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def paged_verify_multi(
    params: Params, cache: Params,
    tokens: torch.Tensor,  # [B, N, S]: N candidate suffixes per row
    lengths: torch.Tensor,  # [B] suffix length (shared by a row's candidates)
    starts: torch.Tensor,  # [B] row position before the verify
    cfg: LlamaConfig, kv_attention: str = "gather",
) -> torch.Tensor:
    """Score N candidate continuations per row in ONE read-only forward:
    the target's greedy ids [B, N, S]. Candidates are flattened to B*N
    rows SHARING each row's block table and start — legal only because
    the self-contained suffix forward never writes the pool. The host
    re-runs :func:`paged_verify` on the winner alone."""
    B, N, S = tokens.shape

    def rep(a):
        return a.repeat_interleave(N, dim=0)

    flat = {"k": cache["k"], "v": cache["v"], "pos": rep(cache["pos"]),
            "bt": rep(cache["bt"])}
    x, _ = _paged_suffix_forward(
        params, flat, tokens.reshape(B * N, S), rep(lengths), rep(starts),
        cfg, kv_attention=kv_attention, self_contained=True,
    )
    logits = _mm(x, lm_head_of(params, cfg)).float()
    return torch.argmax(logits, dim=-1).to(torch.int32).reshape(B, N, S)


def paged_verify_tree(
    params: Params, cache: Params,
    tokens: torch.Tensor,  # [B, M] trie-node tokens (node 0 = last accepted)
    positions: torch.Tensor,  # [B, M] global position of each node
    tree_mask: torch.Tensor,  # [B, M, M] bool: node m sees node t
    lengths: torch.Tensor,  # [B] live node count; 0 = row untouched
    starts: torch.Tensor,  # [B] row position before the verify
    cfg: LlamaConfig, kv_attention: str = "gather",
) -> torch.Tensor:
    """Score a prefix trie of draft continuations in ONE read-only
    forward: the target's greedy ids [B, M], ``ids[b, m]`` the argmax
    after consuming node m along its root path. ``tree_mask[b, m, t]``
    is True exactly when t is m or an ancestor of m, and ``positions[b,
    m] = starts[b] + depth(m)``; each node then attends committed history
    plus its own root path, the key set a chain verify of that path
    sees. Nothing here writes the pool."""
    x, _ = _paged_suffix_forward(
        params, cache, tokens, lengths, starts, cfg,
        kv_attention=kv_attention, self_contained=True,
        positions=positions, self_mask=tree_mask,
    )
    logits = _mm(x, lm_head_of(params, cfg)).float()
    return torch.argmax(logits, dim=-1).to(torch.int32)


def copy_kv_block(cache: Params, src, dst) -> Params:
    """Copy one block's K/V across all layers (``src`` -> ``dst``), IN
    PLACE. The copy-on-write primitive: the engine calls it when a row
    must append inside a SHARED block (the partial tail of a grafted
    prefix), so the write lands in a private copy and the prefix entry's
    block stays immutable for its other readers."""
    src, dst = int(src), int(dst)
    cache["k"][:, dst] = cache["k"][:, src]
    cache["v"][:, dst] = cache["v"][:, src]
    return cache


def paged_graft_prefix(cache: Params, k: torch.Tensor, v: torch.Tensor,
                       row, length) -> Params:
    """Scatter an array-payload prefix entry's K/V ([L, P, KV, hd]) into
    ``row``'s blocks at positions [0, P) and set its pos to ``length``,
    IN PLACE. Block-ref entries never need this (the engine splices the
    block table host-side); it serves entries holding materialized
    arrays. Pad positions beyond the row's blocks hit trash-block table
    entries and vanish."""
    L, P, KV, hd = k.shape
    bt = cache["bt"]
    BS = cache["k"].shape[2]
    dev = cache["k"].device
    posw = torch.clamp(torch.arange(P, device=dev), max=bt.shape[1] * BS - 1)
    blk = bt[int(row)].long()[posw // BS]  # [P]
    off = posw % BS
    cache["k"][:, blk, off] = k.to(cache["k"].dtype)
    cache["v"][:, blk, off] = v.to(cache["v"].dtype)
    cache["pos"][int(row)] = int(length)
    return cache


def export_kv_blocks(cache: Params,
                     blocks) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather ``blocks``' K/V payloads out of the pool for a disaggregated
    handoff: (k, v) each [L, n_blocks, BS, KV, hd]. A fresh gather, not a
    view: queued on the stream, it holds the blocks' contents as of this
    point, whatever later writes or frees do to them."""
    idx = torch.as_tensor(blocks, dtype=torch.long).to(cache["k"].device)
    return cache["k"][:, idx], cache["v"][:, idx]


def import_kv_blocks(cache: Params, k: torch.Tensor, v: torch.Tensor,
                     blocks) -> Params:
    """Write a handoff's K/V payloads ([L, n, BS, KV, hd]) into ``blocks``
    of this pool, IN PLACE (an indexed write on the stream; the inverse
    of :func:`export_kv_blocks`). The block ids come from the adopter's
    own allocator: block numbering never survives the transfer, only the
    payloads and the logical table order do. Host payloads reach the
    card through pinned memory, without a stream sync."""
    dev = cache["k"].device
    idx = torch.as_tensor(blocks, dtype=torch.long).to(dev)

    def onto(t):
        if t.device != dev and dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        return t.to(device=dev, dtype=cache["k"].dtype)

    cache["k"][:, idx] = onto(k)
    cache["v"][:, idx] = onto(v)
    return cache


# ---- contiguous KV cache (the model drafts' path and kv_layout="contiguous") --

def init_cache(cfg: LlamaConfig, batch: int, max_seq: int,
               device="cpu") -> Params:
    """Contiguous cache with ONE shared position (:func:`decode_step`'s):
    K/V ``[L, B, max_seq, KV, hd]`` + a 0-d ``pos``."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: LlamaConfig) -> Tuple[torch.Tensor, Params]:
    """One decode step of every row at the cache's shared ``pos``: tokens
    [B, 1] -> (logits [B, V], cache). K/V go in at ``pos`` and the rows
    attend ``t <= pos``; RoPE reads ``cfg.max_seq``'s table. ``pos``
    clamps where the reference's dynamic slices clamp (the table at
    ``max_seq - 1``, the write at ``T - 1``) and advances unclamped. The
    cache is updated in place; nothing is read back to the host."""
    B = tokens.shape[0]
    hd = cfg.head_dim
    dev = tokens.device
    pos = cache["pos"].long()
    max_s = cache["k"].shape[2]
    x = _embed_in(params, tokens, cfg)
    cos, sin = rope_freqs(cfg, cfg.max_seq, device=dev)
    pt = torch.clamp(pos, 0, cfg.max_seq - 1).reshape(1)
    cos_t, sin_t = cos[pt], sin[pt]  # [1, hd/2]
    pw = torch.clamp(pos, 0, max_s - 1).reshape(1)
    valid = (torch.arange(max_s, device=dev) <= pos)[None, None, None, :]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps, cfg.norm_plus_one)
        q = apply_rope(_mm(h, lp["wq"]).reshape(B, 1, cfg.n_heads, hd),
                       cos_t, sin_t)
        k = apply_rope(_mm(h, lp["wk"]).reshape(B, 1, cfg.n_kv_heads, hd),
                       cos_t, sin_t)
        v = _mm(h, lp["wv"]).reshape(B, 1, cfg.n_kv_heads, hd)
        ck = cache["k"][i].index_copy_(1, pw, k)
        cv = cache["v"][i].index_copy_(1, pw, v)
        attn = attention(q, ck, cv, causal=False, mask=valid)
        x = x + _mm(attn.reshape(B, 1, cfg.n_heads * hd), lp["wo"])
        x = _mlp(x, lp, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_plus_one)
    logits = _mm(x[:, 0], lm_head_of(params, cfg)).float()
    cache["pos"] = (pos + 1).to(torch.int32)
    return logits, cache


# ---- serving over a mesh: the contiguous functions' split ---------------------

def serving_shardings(params: Params, cfg: LlamaConfig, mesh) -> Params:
    """The reference's ``serving_shardings`` (``llama.py:611``) as a tree
    of specs mirroring ``params`` (one mesh-axis name or None a
    dimension): :func:`param_pspecs` pruned to ``mesh.axis_names``; an
    int8 leaf's ``q8`` takes the weight's spec and its ``s8`` the same
    with every dimension of size 1 (the reduced axis) unsharded."""
    pspecs = param_pspecs(cfg)
    names = set(mesh.axis_names)

    def prune(spec):
        return tuple(a if a in names else None for a in spec)

    def leaf(w, spec):
        return _leaf_serving_spec(w, prune(spec))

    out: Params = {
        "embed": leaf(params["embed"], pspecs["embed"]),
        "final_norm": prune(pspecs["final_norm"]),
        "layers": {k: leaf(params["layers"][k], pspecs["layers"][k])
                   for k in params["layers"]},
    }
    if "lm_head" in params:
        out["lm_head"] = leaf(params["lm_head"], pspecs["lm_head"])
    return out


def _leaf_serving_spec(w, spec: tuple):
    """A (pruned) weight spec as leaf ``w`` takes it: an int8 leaf's
    ``q8`` as the weight, its ``s8`` with every size-1 dimension whole."""
    if is_quantized(w):
        return {"q8": spec, "s8": tuple(None if w["s8"].shape[i] == 1 else a
                                        for i, a in enumerate(spec))}
    return spec


class _Whole:
    """The unsharded model as a split of one rank: what the contiguous
    functions run when no :class:`ServingSplit` is given (the same ops
    as a plain forward; every method is the identity or the unsharded
    lookup)."""

    n = 1

    @staticmethod
    def heads(j, cfg):
        return cfg.n_heads, cfg.n_kv_heads

    @staticmethod
    def to(t, j):
        return t

    @staticmethod
    def sum(parts):
        return parts[0]

    @staticmethod
    def layer(params, j, i):
        return _layer(params, i)

    @staticmethod
    def embed(params, tokens, cfg):
        return _embed_in(params, tokens, cfg)

    @staticmethod
    def final_norm(params):
        return params["final_norm"]

    @staticmethod
    def logits(params, x, cfg):
        return _mm(x, lm_head_of(params, cfg)).float()

    @staticmethod
    def attn_kv(j, t):
        return t

    @staticmethod
    def part(t, j):
        return t

    @staticmethod
    def pack(parts):
        return parts[0]

    @staticmethod
    def kv(cache, name, j):
        return cache[name]


_WHOLE = _Whole()


class ServingSplit:
    """The contiguous serving functions over a serving mesh
    (``parallel/mesh.py::ServingMesh``): the reference's
    ``shard_serving_params`` and its jitted model functions under that
    sharding (``llama.py:611-1000``), as one process runs them.

    Layout. Every rank holds its region of each leaf by
    :func:`serving_shardings` (:meth:`cut`, reusing ``ShardSpec``), with
    one exception: the Megatron ``tensor`` split cuts ``wk`` / ``wv`` by
    whole KV heads. Where ``n_kv_heads`` divides by ``tensor`` that is the
    reference's layout; otherwise (Gemma-2B's one KV head over four
    ranks) each rank holds the KV heads its q heads read (``kv = h //
    group``), replicated across the ranks that share them, where the
    reference cuts the flat ``KV * hd`` columns inside a head. So q / o
    split by heads, gate / up by columns and down by rows, the embedding
    and the head by vocabulary rows; ``fsdp`` splits the other matmul
    dimension. Axes that shard no serving leaf (data, replica, sp,
    expert, pipe) hold whole copies of their group's shards, as the
    reference's pruned specs do (copies on one device share storage).

    Compute. The ranks at coordinate 0 of every axis but ``tensor`` (one
    a tensor coordinate) compute every row of the batch: each runs its
    q heads and KV heads, its ffn columns and its vocabulary rows, and
    holds its KV heads' contiguous cache. An ``fsdp`` split is gathered
    onto them at use, a layer at a time. The other ranks hold their
    copies and compute nothing (their results would be the same bits).
    The row-parallel products (``wo``, ``w_down``) and the
    vocabulary-split embedding (each rank looks up its rows, zeros
    elsewhere) are summed on the lead rank in rank order in the
    activation dtype, so every rank reads the same bits of the next
    activation; the head's logits are gathered before sampling."""

    def __init__(self, cfg: LlamaConfig, mesh) -> None:
        self.cfg, self.mesh = cfg, mesh
        self.tp = mesh.shape.get("tensor", 1)
        self.fsdp = mesh.shape.get("fsdp", 1)
        for axis, attrs in (("tensor", ("n_heads", "ffn_dim", "vocab_size")),
                            ("fsdp", ("dim",))):
            n = mesh.shape.get(axis, 1)
            for attr in attrs:
                if n > 1 and getattr(cfg, attr) % n:
                    raise ValueError(f"{attr}={getattr(cfg, attr)} not "
                                     f"divisible by {axis}={n}")
        #: leaf path -> its pruned spec
        self.specs = prune_specs(param_pspecs(cfg), set(mesh.axis_names))
        #: the computing ranks, one a tensor coordinate, and their devices
        self.ranks = [mesh.rank({"tensor": t}) for t in range(self.tp)]
        self.n = len(self.ranks)
        self.devices = [mesh.devices[r] for r in self.ranks]
        self.lead = self.devices[0]
        H, KV = cfg.n_heads, cfg.n_kv_heads
        group, hl = H // KV, H // self.tp
        #: KV heads cut evenly over tensor (the reference's layout)
        self.kv_even = KV % self.tp == 0
        #: per tensor coordinate: the KV heads [lo, hi) it holds, and the
        #: index of each of its q heads' KV head among them when the
        #: grouping is not uniform (else None)
        self.kv_heads, self._kv_index = [], []
        for t in range(self.tp):
            heads = range(t * hl, (t + 1) * hl)
            lo, hi = heads[0] // group, heads[-1] // group + 1
            idx = [h // group - lo for h in heads]
            per = hl // (hi - lo)
            uniform = per * (hi - lo) == hl and idx == [
                e for e in range(hi - lo) for _ in range(per)]
            self.kv_heads.append((lo, hi))
            self._kv_index.append(None if uniform else torch.tensor(idx))

    # ---- layout -------------------------------------------------------------

    def region(self, path: str, spec, shape, rank: int):
        """Where rank ``rank``'s shard of leaf ``path`` (one tensor of
        it, of global ``shape``, laid out by ``spec``) sits; None when it
        holds the whole tensor."""
        c = self.mesh.coords[rank]
        starts, stops = [], []
        for a, n in zip(spec, shape):
            size = self.mesh.shape.get(a, 1) if a else 1
            if size <= 1:
                starts.append(0)
                stops.append(n)
            elif a == "tensor" and path in ("layers/wk", "layers/wv") \
                    and not self.kv_even:
                lo, hi = self.kv_heads[c["tensor"]]
                hd = n // self.cfg.n_kv_heads
                starts.append(lo * hd)
                stops.append(hi * hd)
            else:
                k = n // size
                starts.append(c[a] * k)
                stops.append((c[a] + 1) * k)
        if all(a == 0 and b == n for a, b, n in zip(starts, stops, shape)):
            return None
        return ShardSpec(tuple(shape), tuple(starts), tuple(stops))

    def cut(self, path: str, w) -> list:
        """Leaf ``path`` (a tensor, or an int8 ``{"q8", "s8"}`` leaf) cut
        into every rank's shard on the rank's device: owned copies, so
        the whole leaf can go. Ranks that hold the same region on one
        device share it."""
        spec = _leaf_serving_spec(w, self.specs[path])
        made: Dict[tuple, torch.Tensor] = {}

        def piece(t, sp, r):
            reg = self.region(path, sp, tuple(t.shape), r)
            dev = self.mesh.devices[r]
            key = (id(t), None if reg is None else reg.index, str(dev))
            if key not in made:
                made[key] = t.to(dev) if reg is None else reg.take(t).to(
                    device=dev, memory_format=torch.contiguous_format,
                    copy=True)
            return made[key]

        out = []
        for r in range(self.mesh.size):
            if is_quantized(w):
                out.append({"q8": piece(w["q8"], spec["q8"], r),
                            "s8": piece(w["s8"], spec["s8"], r)})
            else:
                out.append(piece(w, spec, r))
        return out

    def shard(self, params: Params) -> list:
        """A whole (possibly int8) tree -> each rank's tree of shards."""

        def walk(node, prefix):
            if isinstance(node, dict) and not is_quantized(node):
                return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
            return self.cut(prefix[:-1], node)

        return self.ranks_of(walk(params, ""))

    def ranks_of(self, tree) -> list:
        """A tree whose leaves are :meth:`cut` lists -> a list of rank
        trees."""

        def pick(node, r):
            if isinstance(node, dict):
                return {k: pick(v, r) for k, v in node.items()}
            return node[r]  # a cut list (of tensors or int8 leaves)

        return [pick(tree, r) for r in range(self.mesh.size)]

    def sink(self, quantize: bool):
        """A ``shard`` for :func:`llama_init` (``local(name, leaf)``):
        each leaf quantized when asked, then cut, as it is drawn; the
        init's tree then goes through :meth:`ranks_of`."""
        split = self

        class _Sink:
            @staticmethod
            def local(name, t):
                return split.cut(name, quantize_leaf_named(name, t)
                                 if quantize else t)

        return _Sink()

    # ---- the forward's view of the split ----------------------------------------

    def heads(self, j: int, cfg: LlamaConfig):
        """(q heads, KV heads) computing rank ``j`` runs."""
        lo, hi = self.kv_heads[j]
        return cfg.n_heads // self.tp, hi - lo

    def to(self, t: torch.Tensor, j: int) -> torch.Tensor:
        return t.to(self.devices[j])

    def sum(self, parts) -> torch.Tensor:
        return self.mesh.sum(parts, self.lead)

    def leaf(self, params: list, j: int, path: str, i: Optional[int] = None):
        """Computing rank ``j``'s leaf ``path`` (layer ``i`` of a stacked
        leaf), its fsdp shards gathered onto the rank's device."""
        r = self.ranks[j]

        def pick(tree):
            t = _at(tree, path)
            return t if i is None else map_leaves(lambda a: a[i], t)

        w = pick(params[r])
        spec = self.specs[path]
        if self.fsdp <= 1 or "fsdp" not in spec:
            return w
        d = spec.index("fsdp") - (i is not None)
        parts = [pick(params[p]) for p in self.mesh.along(r, "fsdp")]
        dev = self.devices[j]
        if not is_quantized(w):
            return self.mesh.gather(parts, d, dev)
        s8 = w["s8"] if w["s8"].shape[d] == 1 else self.mesh.gather(
            [p["s8"] for p in parts], d, dev)
        return {"q8": self.mesh.gather([p["q8"] for p in parts], d, dev),
                "s8": s8}

    def layer(self, params: list, j: int, i: int) -> Params:
        return {k: self.leaf(params, j, f"layers/{k}", i)
                for k in params[self.ranks[j]]["layers"]}

    def embed(self, params: list, tokens: torch.Tensor, cfg: LlamaConfig):
        """The vocabulary-split embedding: each rank looks up the tokens
        in its rows (zeros for the others), the ranks' rows summed."""
        vl = cfg.vocab_size // self.tp
        parts = []
        for j, r in enumerate(self.ranks):
            local = self.to(tokens, j).long() - self.mesh.coords[r].get(
                "tensor", 0) * vl
            inside = (local >= 0) & (local < vl)
            rows = gather_embed(self.leaf(params, j, "embed"),
                                local.clamp(0, vl - 1), cfg.dtype)
            rows = rows.to(cfg.dtype)
            parts.append(torch.where(inside[..., None], rows,
                                     rows.new_zeros(())))
        x = self.sum(parts)
        if cfg.embed_scale:
            x = x * math.sqrt(cfg.dim)
        return x

    def final_norm(self, params: list) -> torch.Tensor:
        return params[self.ranks[0]]["final_norm"]

    def logits(self, params: list, x: torch.Tensor,
               cfg: LlamaConfig) -> torch.Tensor:
        """Each rank's vocabulary block of the head, gathered."""
        parts = []
        for j in range(self.n):
            if cfg.tie_embeddings:
                e = self.leaf(params, j, "embed")
                head = {"q8": e["q8"], "s8": e["s8"], "transposed": True} \
                    if is_quantized(e) else e.T
            else:
                head = self.leaf(params, j, "lm_head")
            parts.append(_mm(self.to(x, j), head).float())
        return self.mesh.gather(parts, -1, self.lead)

    def attn_kv(self, j: int, t: torch.Tensor) -> torch.Tensor:
        """Rank ``j``'s K or V heads ``[B, T, KVl, hd]`` in the layout its
        q heads read: as held, or one head a q head when the grouping is
        not uniform."""
        idx = self._kv_index[j]
        return t if idx is None else t[:, :, idx.to(t.device)]

    @staticmethod
    def part(t, j: int):
        return t[j]

    @staticmethod
    def pack(parts) -> list:
        return list(parts)

    @staticmethod
    def kv(cache: Params, name: str, j: int) -> torch.Tensor:
        return cache[name][j]

    def describe(self, params: list, cache: Optional[Params] = None) -> Dict:
        """The mesh, each rank's device, weight bytes and KV bytes (the
        computing ranks hold the cache)."""
        kv = [0] * self.mesh.size
        if cache is not None:
            for j, r in enumerate(self.ranks):
                kv[r] = sum(cache[f][j].numel() * cache[f][j].element_size()
                            for f in ("k", "v"))
        return dict(self.mesh.describe(),
                    computing_ranks=list(self.ranks),
                    kv_heads=[list(h) for h in self.kv_heads],
                    weight_bytes=[params_nbytes(p) for p in params],
                    kv_bytes=kv)


# ---- the contiguous functions (one rank, or a ServingSplit) ----------------------

def init_batched_cache(cfg: LlamaConfig, batch: int, max_seq: int,
                       device="cpu", split: Optional[ServingSplit] = None
                       ) -> Params:
    """Contiguous continuous-batching cache with PER-ROW positions:
    K/V ``[L, B, max_seq, KV, hd]`` + ``pos`` [B]. With a ``split``, K/V
    are lists, one a computing rank on its device holding its KV heads,
    and ``pos`` lives on the lead rank."""
    if split is None:
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        }
    kv = {"k": [], "v": []}
    for j, dev in enumerate(split.devices):
        shape = (cfg.n_layers, batch, max_seq, split.heads(j, cfg)[1],
                 cfg.head_dim)
        for f in kv:
            kv[f].append(torch.zeros(shape, dtype=cfg.dtype, device=dev))
    return dict(kv, pos=torch.zeros((batch,), dtype=torch.int32,
                                    device=split.lead))


def _row_update(cache_layer: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Write ``new`` [B, S, KV, hd] into ``cache_layer`` [B, T, KV, hd] at
    per-row offset ``pos`` [B], IN PLACE — the reference's vmapped
    ``dynamic_update_slice``, whose start clamps to ``T - S``."""
    B, S = new.shape[:2]
    T = cache_layer.shape[1]
    dev = cache_layer.device
    start = torch.clamp(pos.long(), min=0, max=T - S)
    idx = start[:, None] + torch.arange(S, device=dev)[None, :]
    cache_layer[torch.arange(B, device=dev)[:, None], idx] = new
    return cache_layer


def _split_layer(split, params, i: int, x: torch.Tensor, cfg: LlamaConfig,
                 attend) -> torch.Tensor:
    """Layer ``i`` of the contiguous functions on every computing rank of
    ``split``: ``attend(j, q, k, v)`` takes rank ``j``'s q / k / v (its
    heads, PRE-rope), writes its cache and returns its attention output
    ``[B, S, Hl, hd]``; the ``wo`` and ``w_down`` partials are summed."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    po = cfg.norm_plus_one
    lps = [split.layer(params, j, i) for j in range(split.n)]
    parts = []
    for j, lp in enumerate(lps):
        H, KV = split.heads(j, cfg)
        h = rmsnorm(split.to(x, j), lp["attn_norm"], cfg.norm_eps, po)
        q = _mm(h, lp["wq"]).reshape(B, S, H, hd)
        k = _mm(h, lp["wk"]).reshape(B, S, KV, hd)
        v = _mm(h, lp["wv"]).reshape(B, S, KV, hd)
        attn = attend(j, q, k, v)
        parts.append(_mm(attn.reshape(B, S, H * hd), lp["wo"]))
    x = x + split.sum(parts)
    parts = []
    for j, lp in enumerate(lps):
        h = rmsnorm(split.to(x, j), lp["mlp_norm"], cfg.norm_eps, po)
        gate = _act(cfg)(_mm(h, lp["w_gate"]).float()).to(h.dtype)
        parts.append(_mm(gate * _mm(h, lp["w_up"]), lp["w_down"]))
    return x + split.sum(parts)


def decode_step_batched(params, cache: Params, tokens: torch.Tensor,
                        cfg: LlamaConfig,
                        split: Optional[ServingSplit] = None
                        ) -> Tuple[torch.Tensor, Params]:
    """One decode step over the contiguous cache with per-row positions:
    tokens [B, 1] -> (logits [B, V], cache). Row b writes its K/V at
    ``pos[b]`` and attends ``t <= pos[b]``; pos advances by one
    (clamped). The cache is updated in place. ``split``: the params and
    the cache are a :class:`ServingSplit`'s."""
    sp = split or _WHOLE
    pos = cache["pos"]
    pos_l = pos.long()
    max_s = sp.kv(cache, "k", 0).shape[2]
    x = sp.embed(params, tokens, cfg)  # [B, 1, D]
    cos, sin = rope_freqs(cfg, max_s, device=x.device)
    cos_t = cos[pos_l][:, None, None, :]
    sin_t = sin[pos_l][:, None, None, :]
    valid = torch.arange(max_s, device=x.device)[None, :] <= pos_l[:, None]
    mask = valid[:, None, None, None, :]

    for i in range(cfg.n_layers):
        def attend(j, q, k, v):
            c, s_ = sp.to(cos_t, j), sp.to(sin_t, j)
            p = sp.to(pos, j)
            ck = _row_update(sp.kv(cache, "k", j)[i], _rotate(k, c, s_), p)
            cv = _row_update(sp.kv(cache, "v", j)[i], v, p)
            return attention(_rotate(q, c, s_), sp.attn_kv(j, ck),
                             sp.attn_kv(j, cv), causal=False,
                             mask=sp.to(mask, j))

        x = _split_layer(sp, params, i, x, cfg, attend)
    x = rmsnorm(x, sp.final_norm(params), cfg.norm_eps, cfg.norm_plus_one)
    logits = sp.logits(params, x[:, 0], cfg)
    cache["pos"] = torch.clamp(pos + 1, max=max_s - 1).to(torch.int32)
    return logits, cache


def decode_segment(
    params, cache: Params,
    tokens: torch.Tensor,  # [B, 1] first input token per row
    temps: torch.Tensor,  # [B] sampling temperature; <= 0 = greedy
    generator: Optional[torch.Generator], cfg: LlamaConfig, n_steps: int,
    greedy: bool = False, nonfinite: Optional[torch.Tensor] = None,
    split: Optional[ServingSplit] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """``n_steps`` contiguous decode steps with on-device sampling, as
    :func:`paged_decode_segment` over the paged cache (``nonfinite`` as
    there). Returns (ids [B, n_steps], last ids [B, 1], cache)."""
    toks = tokens
    out = []
    for _ in range(n_steps):
        logits, cache = decode_step_batched(params, cache, toks, cfg, split)
        if nonfinite is not None:
            nonfinite += (~torch.isfinite(logits)).sum()
        if greedy:
            z = logits
        else:
            g = -torch.log(torch.empty_like(logits).exponential_(
                generator=generator))
            z = torch.where(
                temps[:, None] > 0.0,
                logits / torch.clamp(temps[:, None], min=1e-4) + g,
                logits,
            )
        toks = torch.argmax(z, dim=-1).to(torch.int32)[:, None]
        out.append(toks[:, 0])
    return torch.stack(out, dim=1), toks, cache


def prefill_batched(params, cache: Params, tokens: torch.Tensor,
                    lengths: torch.Tensor, cfg: LlamaConfig,
                    split: Optional[ServingSplit] = None
                    ) -> Tuple[torch.Tensor, Params]:
    """Whole prompts from position 0 into the contiguous cache in one
    forward: last-token logits [B, V] + the cache (in place). Rows with
    ``lengths[b] == 0`` keep their K/V and pos; active rows take K/V at
    [0, S) (pad positions hold garbage that later steps overwrite)."""
    sp = split or _WHOLE
    S = tokens.shape[1]
    max_s = sp.kv(cache, "k", 0).shape[2]
    lengths_l = lengths.long()
    active = lengths_l > 0
    x = sp.embed(params, tokens, cfg)
    cos, sin = rope_freqs(cfg, S, device=x.device)
    sel = active[:, None, None, None]

    for i in range(cfg.n_layers):
        def attend(j, q, k, v):
            c, s_ = sp.to(cos, j), sp.to(sin, j)
            q, k = apply_rope(q, c, s_), apply_rope(k, c, s_)
            attn = attention(q, sp.attn_kv(j, k), sp.attn_kv(j, v),
                             causal=True)
            selj = sp.to(sel, j)
            ck, cv = sp.kv(cache, "k", j)[i], sp.kv(cache, "v", j)[i]
            ck[:, :S] = torch.where(selj, k, ck[:, :S])
            cv[:, :S] = torch.where(selj, v, cv[:, :S])
            return attn

        x = _split_layer(sp, params, i, x, cfg, attend)
    x = rmsnorm(x, sp.final_norm(params), cfg.norm_eps, cfg.norm_plus_one)
    idx = torch.clamp(lengths_l - 1, min=0)
    x_last = x[torch.arange(x.shape[0], device=x.device), idx]  # [B, D]
    logits = sp.logits(params, x_last, cfg)
    new_pos = torch.clamp(lengths_l, max=max_s - 1)
    cache["pos"] = torch.where(active, new_pos,
                               cache["pos"].long()).to(torch.int32)
    return logits, cache


# ---- prefix KV reuse on the contiguous cache --------------------------------

def copy_prefix_into_row(cache: Params, k, v, row: int, length: int,
                         split: Optional[ServingSplit] = None) -> Params:
    """Graft a cached prefix's K/V (``[L, P, KV, hd]``, P >= ``length``
    the entry's padded bucket; with a ``split``, a list of each computing
    rank's) into batch row ``row`` at offset 0 and set its ``pos`` to
    ``length``, IN PLACE. The pad tail lands at positions >= pos, masked
    until later writes replace it (the garbage-beyond-pos contract every
    contiguous prefill keeps)."""
    sp = split or _WHOLE
    for j in range(sp.n):
        kj, vj = sp.part(k, j), sp.part(v, j)
        ck, cv = sp.kv(cache, "k", j), sp.kv(cache, "v", j)
        P = kj.shape[1]
        ck[:, row, :P] = kj.to(ck.dtype)
        cv[:, row, :P] = vj.to(cv.dtype)
    cache["pos"][row] = int(length)
    return cache


def extract_prefix_from_row(cache: Params, row: int, p_len: int,
                            split: Optional[ServingSplit] = None):
    """The first ``p_len`` cached K/V positions of batch row ``row``, each
    ``[L, p_len, KV, hd]`` (with a ``split``, a list of each computing
    rank's): a new prefix-cache entry. Copies (queued on the stream
    behind the prefill that filled them), never views: the live cache is
    updated in place afterwards."""
    sp = split or _WHOLE
    return tuple(sp.pack([sp.kv(cache, f, j)[:, row, :p_len].clone()
                          for j in range(sp.n)]) for f in ("k", "v"))


def prefill_batched_from(params, cache: Params, tokens: torch.Tensor,
                         lengths: torch.Tensor, starts: torch.Tensor,
                         cfg: LlamaConfig,
                         split: Optional[ServingSplit] = None
                         ) -> Tuple[torch.Tensor, Params]:
    """Suffix prefill on the contiguous cache: row b's tokens take global
    positions ``[starts[b], starts[b] + lengths[b])`` (RoPE there too),
    their K/V go in at ``starts[b]`` (the start clamped to ``T - S``, as
    the reference's ``dynamic_update_slice``), and the queries attend the
    FULL cache row under the offset causal mask ``t <= starts[b] + s``,
    so a grafted prefix is seen. ``starts == 0`` is whole-prompt prefill.
    Rows with ``lengths[b] == 0`` keep their K/V and pos. Last-token
    logits [B, V] + the cache (in place)."""
    sp = split or _WHOLE
    B, S = tokens.shape
    max_s = sp.kv(cache, "k", 0).shape[2]
    lengths_l = lengths.long()
    active = lengths_l > 0
    starts_l = starts.long()
    x = sp.embed(params, tokens, cfg)
    dev = x.device
    cos_full, sin_full = rope_freqs(cfg, max_s, device=dev)
    posq = torch.clamp(starts_l[:, None] + torch.arange(S, device=dev)[None],
                       max=max_s - 1)  # [B, S] global query positions
    cos_t = cos_full[posq][:, :, None, :]
    sin_t = sin_full[posq][:, :, None, :]
    mask = (torch.arange(max_s, device=dev)[None, None, :]
            <= posq[:, :, None])[:, None, None]  # [B, 1, 1, S, T]
    sel = active[:, None, None, None]
    rows = torch.arange(B, device=dev)[:, None]
    idx = (torch.clamp(starts_l, 0, max_s - S)[:, None]
           + torch.arange(S, device=dev)[None])  # [B, S] write positions

    for i in range(cfg.n_layers):
        def attend(j, q, k, v):
            c, s_ = sp.to(cos_t, j), sp.to(sin_t, j)
            rj, ij, selj = sp.to(rows, j), sp.to(idx, j), sp.to(sel, j)
            ck, cv = sp.kv(cache, "k", j)[i], sp.kv(cache, "v", j)[i]
            # inactive rows keep their K/V bit for bit (mid-decode
            # neighbours)
            ck[rj, ij] = torch.where(selj, _rotate(k, c, s_), ck[rj, ij])
            cv[rj, ij] = torch.where(selj, v, cv[rj, ij])
            return attention(_rotate(q, c, s_), sp.attn_kv(j, ck),
                             sp.attn_kv(j, cv), causal=False,
                             mask=sp.to(mask, j))

        x = _split_layer(sp, params, i, x, cfg, attend)
    x = rmsnorm(x, sp.final_norm(params), cfg.norm_eps, cfg.norm_plus_one)
    last = torch.clamp(lengths_l - 1, min=0)
    logits = sp.logits(params, x[torch.arange(B, device=dev), last], cfg)
    new_pos = torch.clamp(starts_l + lengths_l, max=max_s - 1)
    cache["pos"] = torch.where(active, new_pos,
                               cache["pos"].long()).to(torch.int32)
    return logits, cache


__all__ = [
    "LlamaConfig", "preset", "PRESETS", "llama_init", "params_from_numpy",
    "remat_policy_for", "checkpoint_name", "llama_hidden", "llama_forward",
    "llama_loss", "next_token_nll", "chunked_next_token_nll",
    "rmsnorm", "rope_table", "rope_freqs", "apply_rope", "attention",
    "gather_embed", "lm_head_of", "merge_chain_tokens", "init_paged_cache",
    "paged_decode_step_batched", "paged_decode_segment",
    "paged_prefill_batched", "paged_prefill_from", "paged_verify",
    "paged_verify_multi", "paged_verify_tree", "copy_kv_block",
    "paged_graft_prefix", "init_batched_cache", "decode_step_batched",
    "decode_segment", "prefill_batched", "param_like", "quantize_params",
    "quantize_leaf_at", "deq", "is_quantized", "map_leaves",
    "params_nbytes", "export_kv_blocks", "import_kv_blocks",
    "init_cache", "decode_step", "copy_prefix_into_row",
    "extract_prefix_from_row", "prefill_batched_from", "param_pspecs",
    "serving_shardings", "ServingSplit", "leaf_path", "quantize_leaf_named",
    "prune_specs", "check_divisible", "TrainShard", "remat_layers",
    "pipeline_hooks",
]
