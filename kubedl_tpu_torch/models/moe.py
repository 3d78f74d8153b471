"""Switch-MoE transformer in PyTorch: the port of ``kubedl_tpu/models/moe.py``.

Top-1 routing with a capacity factor and the Switch load-balancing aux
loss, on the Llama building blocks (``models/llama.py``: rmsnorm, RoPE,
attention, the loss), so the attention path is the flagship model's and
takes the same flash operators. Config, presets, the parameter tree
(stacked ``[L, ...]`` leaves, experts as ``[L, E, ...]``) and the FLOPs
formula are the reference's, so checkpoints and MFU mean the same in both
packages.

Dispatch is by index, not by the reference's dense one-hot einsums.
The reference builds three ``[T, E, cap]`` float32 tensors so that XLA
sees static shapes (1.34 GB each at ``bench-moe``'s T = 16,384), and
contracts them in float32 einsums (2·T·E·cap·D flops apiece). Each token
sits in at most one (expert, slot) pair, so every element of those
contractions is one product plus exact zeros: copying the token's row
into its slot, and the slot's row back to the token, computes the same
bits (:func:`moe_ffn`). Shapes stay static (``cap`` is a Python int), so
nothing syncs the host. The slot of each token comes from a running
count; both moves are index copies into fresh zeros whose targets are
all distinct (a dropped token, and an empty slot, get a spare row of their
own), so the forward has no ``index_add_`` and no atomics, and the
backward of each is a gather: a step is bit-identical run to run.
:func:`moe_ffn_plain` keeps the
reference's one-hot formula line for line as the plain version the
tests and ``chip_smoke.py`` hold the index dispatch against; nothing on
the main path calls it.

One device only: expert and tensor parallelism (``ep_axis`` /
``tp_axis``), ``param_pspecs`` and ``pipeline_hooks`` belong to the
multi-chip port slice; an ``ep_axis`` or ``tp_axis`` raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from kubedl_tpu_torch.models.llama import (
    _dense, _layer, apply_rope, attention, next_token_nll, params_from_numpy,
    remat_policy_for, rmsnorm, rope_table,
)

Params = Dict[str, Any]

MULTI_CHIP = "the multi-chip port slice"


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32768
    dim: int = 1024
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 8
    n_experts: int = 8
    ffn_dim: int = 2048
    max_seq: int = 2048
    #: per-expert token capacity = capacity_factor * tokens / n_experts
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: bool = True
    #: see llama.remat_policy_for — "dots_flash" keeps the flash kernel's
    #: residuals saved so backward never re-runs the forward kernel
    remat_policy: str = "dots_flash"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def num_params(self) -> int:
        hd = self.head_dim
        per_layer = (
            self.dim * (self.n_heads * hd)
            + 2 * self.dim * (self.n_kv_heads * hd)
            + (self.n_heads * hd) * self.dim
            + self.dim * self.n_experts  # router
            + 2 * self.n_experts * self.dim * self.ffn_dim  # w_in, w_out
            + 2 * self.dim  # norms
        )
        return (
            self.vocab_size * self.dim  # embed
            + self.n_layers * per_layer
            + self.dim  # final norm
            + self.dim * self.vocab_size  # lm_head
        )

    def flops_per_token(self) -> float:
        """Training FLOPs/token ~= 6 * activated params (top-1 routing
        activates one expert of n_experts per token)."""
        hd = self.head_dim
        per_layer_active = (
            self.dim * (self.n_heads * hd)
            + 2 * self.dim * (self.n_kv_heads * hd)
            + (self.n_heads * hd) * self.dim
            + self.dim * self.n_experts
            + 2 * self.dim * self.ffn_dim  # one expert's w_in + w_out
        )
        active = (
            self.vocab_size * self.dim
            + self.n_layers * per_layer_active
            + self.dim * self.vocab_size
        )
        return 6.0 * active


TINY_MOE = MoEConfig(
    vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=4, n_experts=4,
    ffn_dim=128, max_seq=128, dtype=torch.float32, remat=False,
)

#: bench-scale MoE: 12 layers, 8 experts, GQA 16 q-heads over 8 kv-heads
BENCH_MOE = MoEConfig(
    vocab_size=32768, dim=1024, n_layers=12, n_heads=16, n_kv_heads=8,
    n_experts=8, ffn_dim=2048, max_seq=2048,
)

PRESETS = {"tiny-moe": TINY_MOE, "bench-moe": BENCH_MOE}


def preset(name: str) -> MoEConfig:
    """The preset of that name; an unknown name raises ``KeyError``."""
    return PRESETS[name]


# ---- parameters ------------------------------------------------------------

def _param_tree(cfg: MoEConfig, dense, norm) -> Params:
    """The reference's parameter tree (``moe.py:116-141``), each leaf made
    by ``dense(shape, fan_in)`` or ``norm(shape)``."""
    hd = cfg.head_dim
    L, D, Fd, E, V = (cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.n_experts,
                      cfg.vocab_size)
    return {
        "embed": dense((V, D), D),
        "layers": {
            "attn_norm": norm((L, D)),
            "wq": dense((L, D, cfg.n_heads * hd), D),
            "wk": dense((L, D, cfg.n_kv_heads * hd), D),
            "wv": dense((L, D, cfg.n_kv_heads * hd), D),
            "wo": dense((L, cfg.n_heads * hd, D), cfg.n_heads * hd),
            "mlp_norm": norm((L, D)),
            "router": dense((L, D, E), D),
            "w_in": dense((L, E, D, Fd), D),
            "w_out": dense((L, E, Fd, D), Fd),
        },
        "final_norm": norm((D,)),
        "lm_head": dense((D, V), D),
    }


def moe_init(cfg: MoEConfig, generator: torch.Generator, device) -> Params:
    """Seeded random init with the reference's fan-in scaling and tree.
    ``generator`` must live on ``device``."""

    def dense(shape, fan_in):
        return _dense(shape, fan_in, cfg, generator, device)

    def norm(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    return _param_tree(cfg, dense, norm)


def param_like(cfg: MoEConfig, device="meta") -> Params:
    """The parameter tree's shapes and dtypes as empty tensors."""

    def empty(shape, _fan_in=None):
        return torch.empty(shape, dtype=cfg.dtype, device=device)

    return _param_tree(cfg, empty, empty)


# ---- the switch layer ----------------------------------------------------------

def _reject_parallel(ep_axis, tp_axis) -> None:
    if ep_axis is not None or tp_axis is not None:
        raise ValueError(
            f"expert / tensor parallelism (ep_axis={ep_axis!r}, "
            f"tp_axis={tp_axis!r}) belongs to {MULTI_CHIP}")


def capacity(cfg: MoEConfig, tokens: int, n_experts: int) -> int:
    """Per-expert slots for ``tokens`` routed tokens (the microbatch's
    B*S), in Python floats as the reference computes it."""
    return max(1, int(cfg.capacity_factor * tokens / n_experts))


def route(xt: torch.Tensor, router_w: torch.Tensor, cap: int):
    """Top-1 routing of ``xt`` [T, D]: ``(probs [T, E] float32, gate [T],
    choice [T] int64, pos [T] int64, keep [T] bool)``. The logits are
    ``xt @ router_w`` in the operands' type, then float32; ``choice`` is
    the first maximal probability; ``pos`` is the count of earlier tokens
    (flattened row-major order) with the same choice; a token at
    ``pos >= cap`` is dropped."""
    E, T = router_w.shape[-1], xt.shape[0]
    probs = torch.softmax((xt @ router_w).float(), dim=-1)
    # amax spreads a tie's gradient evenly, as jnp.max does
    gate = probs.amax(dim=-1)
    choice = probs.argmax(dim=-1)
    # the running count as ONE scan over the expert-major [E, T] flattening
    # (a scan down the T axis of [T, E] runs E threads, one per column):
    # row e's count starts after the tokens of experts before e
    hit = torch.arange(E, device=xt.device)[:, None] == choice[None, :]
    run = hit.flatten().cumsum(0).view(E, T)
    run = run - (run[:, -1:] - hit.sum(dim=1, keepdim=True))
    pos = run.gather(0, choice[None, :])[0] - 1
    return probs, gate, choice, pos, pos < cap


def _aux_loss(probs: torch.Tensor, choice: torch.Tensor) -> torch.Tensor:
    """Switch load balancing: E * sum_e fraction_tokens_e * mean_prob_e."""
    E = probs.shape[-1]
    onehot = (choice[:, None] == torch.arange(E, device=probs.device)).float()
    return E * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))


def _experts(xe: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """The expert FFNs on their slots, [E, cap, D] -> [E, cap, D]: plain
    batched products (the reference leaves them to XLA outside any Pallas
    kernel), silu in float32."""
    h = F.silu(torch.bmm(xe, w_in).float())
    return torch.bmm(h.to(dtype), w_out)


def moe_ffn(
    x: torch.Tensor,  # [B, S, D]
    router_w: torch.Tensor,  # [D, E]
    w_in: torch.Tensor,  # [E, D, F]
    w_out: torch.Tensor,  # [E, F, D]
    cfg: MoEConfig,
    ep_axis: Optional[str] = None,
    tp_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 switch layer with index dispatch. Returns (out, aux_loss).

    Bit for bit the reference's forward (``moe.py:165-229``): slot (e, c)
    holds row ``x[t]`` of the c-th token routed to e (float32, rounded to
    ``cfg.dtype``), empty slots hold zeros, and token t gets back
    ``ye[e, c].float() * gate[t]`` rounded to ``x.dtype``, or exactly 0
    when dropped. Both moves are index copies into fresh zeros, every
    target distinct (spare rows past the real ones take a dropped
    token's row and an empty slot's), so their backward is a gather: no
    scatter-add, whose runs of one repeated index serialize."""
    _reject_parallel(ep_axis, tp_axis)
    B, S, D = x.shape
    E = router_w.shape[-1]
    T = B * S
    cap = capacity(cfg, T, E)
    xt = x.reshape(T, D)
    probs, gate, choice, pos, keep = route(xt, router_w, cap)

    # token -> flat slot e*cap + c; a dropped token gets a spare row of
    # its own past the E*cap real slots
    n_slots = E * cap
    tok = torch.arange(T, device=x.device)
    slot = torch.where(keep, choice * cap + pos, n_slots + tok)
    xe = xt.new_zeros(n_slots + T, D).index_copy_(0, slot, xt)[:n_slots]
    # the reference's float32 product rounded to cfg.dtype: a float
    # row widens exactly, so one cast rounds the same
    ye = _experts(xe.view(E, cap, D).to(cfg.dtype), w_in, w_out, cfg.dtype)
    # slot -> its token, or a spare row past T for an empty slot
    back = (T + torch.arange(n_slots + T, device=x.device)).index_copy(
        0, slot, tok)[:n_slots]
    yt = ye.new_zeros(T + n_slots, D).index_copy_(
        0, back, ye.view(n_slots, D))[:T]
    yt = yt.float() * gate[:, None]
    return yt.reshape(B, S, D).to(x.dtype), _aux_loss(probs, choice)


def moe_ffn_plain(
    x: torch.Tensor,
    router_w: torch.Tensor,
    w_in: torch.Tensor,
    w_out: torch.Tensor,
    cfg: MoEConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`moe_ffn`: the reference's dense one-hot
    dispatch and combine, line for line, as float32 einsums over
    ``[T, E, cap]`` tensors (the expert products are :func:`_experts`,
    shared). Tests and ``chip_smoke.py`` hold the index dispatch against
    it; the main path never calls it."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    T = B * S
    cap = capacity(cfg, T, E)
    xt = x.reshape(T, D)

    logits = (xt @ router_w).float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate = probs.amax(dim=-1)  # [T]
    choice = probs.argmax(dim=-1)  # [T]
    onehot = F.one_hot(choice, E).float()  # [T, E]

    pos_in_expert = (torch.cumsum(onehot, dim=0) - 1.0) * onehot  # [T, E]
    keep = (pos_in_expert < cap) & (onehot > 0)
    # jax.nn.one_hot gives a zero row past cap; torch's raises, so clamp
    # (those rows are masked by keep below either way)
    slot = F.one_hot(pos_in_expert.long().clamp(max=cap - 1), cap).float()
    dispatch = torch.where(keep[..., None], slot, 0.0)  # [T, E, cap]
    combine = dispatch * gate[:, None, None]

    xe = torch.einsum("td,tec->ecd", xt.float(), dispatch).to(cfg.dtype)
    ye = _experts(xe, w_in, w_out, cfg.dtype)  # [E, cap, D]
    yt = torch.einsum("ecd,tec->td", ye.float(), combine)

    frac = onehot.mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = E * torch.sum(frac * mean_prob)
    return yt.reshape(B, S, D).to(x.dtype), aux


# ---- the model ---------------------------------------------------------------

def _block(x: torch.Tensor, lp: Params, cfg: MoEConfig, cos, sin,
           attn_fn=None, tp_axis: Optional[str] = None,
           ep_axis: Optional[str] = None):
    """One decoder block: attention as the Llama block's (q/k PRE-rope
    with the tables into an ``attn_fn`` that has ``fused_rope``), then
    the switch layer. Returns (x, aux)."""
    _reject_parallel(ep_axis, tp_axis)
    B, S, _ = x.shape
    hd = cfg.head_dim
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    n_heads = lp["wq"].shape[-1] // hd
    n_kv = lp["wk"].shape[-1] // hd
    q = (h @ lp["wq"]).reshape(B, S, n_heads, hd)
    k = (h @ lp["wk"]).reshape(B, S, n_kv, hd)
    v = (h @ lp["wv"]).reshape(B, S, n_kv, hd)
    if getattr(attn_fn, "fused_rope", False):
        attn = attn_fn(q, k, v, rope_cos=cos, rope_sin=sin)
    else:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = (attn_fn or attention)(q, k, v)
    x = x + attn.reshape(B, S, n_heads * hd) @ lp["wo"]
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    ffn, aux = moe_ffn(h, lp["router"], lp["w_in"], lp["w_out"], cfg)
    return x + ffn, aux


def moe_forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
                attn_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] float32, mean aux loss).
    ``attn_fn`` swaps the attention implementation, as in llama_forward.
    With ``cfg.remat`` each layer runs under the selective checkpoint of
    ``llama_hidden`` (``remat_policy_for(cfg.remat_policy)``)."""
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts,
    )

    S = tokens.shape[1]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    cos, sin = rope_table(cfg.head_dim, cfg.rope_theta, S, device=x.device)
    auxes = []
    if cfg.remat:
        ctx_fn = functools.partial(create_selective_checkpoint_contexts,
                                   remat_policy_for(cfg.remat_policy))
        for i in range(cfg.n_layers):
            x, aux = checkpoint(_block, x, _layer(params, i), cfg, cos, sin,
                                attn_fn, use_reentrant=False,
                                context_fn=ctx_fn)
            auxes.append(aux)
    else:
        for i in range(cfg.n_layers):
            x, aux = _block(x, _layer(params, i), cfg, cos, sin, attn_fn)
            auxes.append(aux)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"]).float()
    return logits, torch.stack(auxes).mean()


def moe_loss(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
             attn_fn=None) -> torch.Tensor:
    logits, aux = moe_forward(params, tokens, cfg, attn_fn)
    return next_token_nll(logits, tokens) + cfg.aux_loss_weight * aux


__all__ = [
    "MoEConfig", "TINY_MOE", "BENCH_MOE", "PRESETS", "preset", "moe_init",
    "param_like", "params_from_numpy", "capacity", "route", "moe_ffn",
    "moe_ffn_plain", "moe_forward", "moe_loss",
]
