"""Llama-3-family decoder in PyTorch: the training forward and loss, and
the paged-KV serving path.

Port of ``kubedl_tpu/models/llama.py`` (config, presets, init, building
blocks, the training path of ``:39-90`` and ``:415-606``, and the paged
functions of ``:849-1468``). Parameters are a plain
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
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from kubedl_tpu_torch.models import paged_attention as blocked_attention

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


def llama_init(cfg: LlamaConfig, generator: torch.Generator,
               device) -> Params:
    """Seeded random init with the reference's distributions and tree
    (``llama.py:229-264``). ``generator`` must live on ``device``."""
    hd = cfg.head_dim
    L, D, Fd, V = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.vocab_size
    H, KV = cfg.n_heads, cfg.n_kv_heads

    def dense(shape, fan_in):
        return _dense(shape, fan_in, cfg, generator, device)

    def norm(shape):
        fill = torch.zeros if cfg.norm_plus_one else torch.ones
        return fill(shape, dtype=cfg.dtype, device=device)

    params: Params = {
        "embed": dense((V, D), D),
        "layers": {
            "attn_norm": norm((L, D)),
            "wq": dense((L, D, H * hd), D),
            "wk": dense((L, D, KV * hd), D),
            "wv": dense((L, D, KV * hd), D),
            "wo": dense((L, H * hd, D), H * hd),
            "mlp_norm": norm((L, D)),
            "w_gate": dense((L, D, Fd), D),
            "w_up": dense((L, D, Fd), D),
            "w_down": dense((L, Fd, D), Fd),
        },
        "final_norm": norm((D,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((D, V), D)
    if cfg.zero_init_deep_from:
        for name in ("wo", "w_down"):
            params["layers"][name][cfg.zero_init_deep_from:] = 0
    return params


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


def gather_embed(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embed[tokens.long()]


def lm_head_of(params: Params, cfg: LlamaConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _embed_in(params: Params, tokens: torch.Tensor, cfg: LlamaConfig):
    x = gather_embed(params["embed"], tokens).to(cfg.dtype)
    if cfg.embed_scale:  # Gemma scales inputs by sqrt(dim)
        x = x * math.sqrt(cfg.dim)
    return x


def _layer(params: Params, i: int) -> Params:
    return {k: v[i] for k, v in params["layers"].items()}


def _mlp(x: torch.Tensor, lp: Params, cfg: LlamaConfig) -> torch.Tensor:
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps, cfg.norm_plus_one)
    gate = _act(cfg)((h @ lp["w_gate"]).float()).to(h.dtype)
    return x + (gate * (h @ lp["w_up"])) @ lp["w_down"]


def _last_logits(params, x, lengths, cfg):
    """Head matmul only at each row's last valid position (V is large)."""
    idx = torch.clamp(lengths.long() - 1, min=0)
    x_last = x[torch.arange(x.shape[0], device=x.device), idx]  # [B, D]
    return (x_last @ lm_head_of(params, cfg)).float()


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
           attn_fn=None, names=()) -> torch.Tensor:
    """One decoder block (the reference's ``_block`` on one device). With
    an ``attn_fn`` that has ``fused_rope``, q/k go in PRE-rope with the
    tables; otherwise RoPE is applied here. ``names`` are the tags the
    active remat policy saves."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    po = cfg.norm_plus_one
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps, po)
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
    x = x + attn @ lp["wo"]
    if not cfg.fuse_projections:
        return _mlp(x, lp, cfg)
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
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts,
    )

    S = tokens.shape[1]
    x = _embed_in(params, tokens, cfg)
    cos, sin = rope_freqs(cfg, S, device=x.device)
    if cfg.remat:
        policy = remat_policy_for(cfg.remat_policy)
        ctx_fn = functools.partial(create_selective_checkpoint_contexts,
                                   policy)
        for i in range(cfg.n_layers):
            x = checkpoint(_block, x, _layer(params, i), cfg, cos, sin,
                           attn_fn, policy.names, use_reentrant=False,
                           context_fn=ctx_fn)
    else:
        for i in range(cfg.n_layers):
            x = _block(x, _layer(params, i), cfg, cos, sin, attn_fn)
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
        q = _rotate((h @ lp["wq"]).reshape(B, 1, cfg.n_heads, hd), cos_t, sin_t)
        k = _rotate((h @ lp["wk"]).reshape(B, 1, cfg.n_kv_heads, hd),
                    cos_t, sin_t)
        v = (h @ lp["wv"]).reshape(B, 1, cfg.n_kv_heads, hd)
        if kv_attention == "blocked":
            attn, _, _ = blocked_attention.paged_attention(
                q, ckp, cvp, bt, pos, new_k=k[:, 0], new_v=v[:, 0]
            )
        else:
            ckp[blk, off] = k[:, 0]
            cvp[blk, off] = v[:, 0]
            attn = attention(q, _paged_view(ckp, bt), _paged_view(cvp, bt),
                             causal=False, mask=mask)
        x = x + attn.reshape(B, 1, cfg.n_heads * hd) @ lp["wo"]
        x = _mlp(x, lp, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_plus_one)
    logits = (x[:, 0] @ lm_head_of(params, cfg)).float()
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
) -> Tuple[torch.Tensor, Params]:
    """Run suffix tokens at global positions ``starts[b] + s`` (offset
    causal mask ``t <= starts[b] + s``), scattering their K/V into each
    row's blocks before attending. Pad positions (``s >= lengths[b]``)
    and inactive rows write to the trash block. Write path only (the
    read-only verify modes come with speculation). Returns (final-norm
    hidden states [B, S, D], cache updated in place)."""
    _check_kv_attention(kv_attention)
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
    posq = torch.clamp(starts.long()[:, None] + ar[None, :], max=max_s - 1)
    cos_t = cos_full[posq][:, :, None, :]
    sin_t = sin_full[posq][:, :, None, :]
    mask = (torch.arange(max_s, device=dev)[None, None, :]
            <= posq[:, :, None])[:, None, None]  # [B, 1, 1, S, T]
    writable = active[:, None] & (ar[None, :] < lengths_l[:, None])
    rows = torch.arange(B, device=dev)[:, None]
    blk = torch.where(writable, bt.long()[rows, posq // BS], 0)
    off = posq % BS
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        ckp, cvp = cache["k"][i], cache["v"][i]
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps, cfg.norm_plus_one)
        q = _rotate((h @ lp["wq"]).reshape(B, S, cfg.n_heads, hd), cos_t, sin_t)
        k = _rotate((h @ lp["wk"]).reshape(B, S, cfg.n_kv_heads, hd),
                    cos_t, sin_t)
        v = (h @ lp["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
        ckp[blk, off] = k
        cvp[blk, off] = v
        if kv_attention == "blocked":
            attn = blocked_attention.paged_attention(q, ckp, cvp, bt, starts)
        else:
            attn = attention(q, _paged_view(ckp, bt), _paged_view(cvp, bt),
                             causal=False, mask=mask)
        x = x + attn.reshape(B, S, cfg.n_heads * hd) @ lp["wo"]
        x = _mlp(x, lp, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_plus_one)
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
        q = apply_rope((h @ lp["wq"]).reshape(B, S, cfg.n_heads, hd), cos, sin)
        k = apply_rope((h @ lp["wk"]).reshape(B, S, cfg.n_kv_heads, hd),
                       cos, sin)
        v = (h @ lp["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
        attn = attention(q, k, v, causal=True)
        x = x + attn.reshape(B, S, cfg.n_heads * hd) @ lp["wo"]
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


__all__ = [
    "LlamaConfig", "preset", "PRESETS", "llama_init", "params_from_numpy",
    "remat_policy_for", "checkpoint_name", "llama_hidden", "llama_forward",
    "llama_loss", "next_token_nll", "chunked_next_token_nll",
    "rmsnorm", "rope_table", "rope_freqs", "apply_rope", "attention",
    "gather_embed", "lm_head_of", "merge_chain_tokens", "init_paged_cache",
    "paged_decode_step_batched", "paged_decode_segment",
    "paged_prefill_batched", "paged_prefill_from",
]
