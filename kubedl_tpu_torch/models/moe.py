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

Across processes (``parallel/mesh.py``'s ``ProcessMesh``):
:func:`param_pspecs` is the reference's layout (expert leaves over
``expert``, the dense ones over ``fsdp`` / ``tensor`` as in Llama), which
:class:`MoEShard` holds and trains on; :func:`moe_ffn`'s ``ep_axis``
routes on the full E and dispatches only the tokens routed to this
rank's experts, ``tp_axis`` splits every expert's ffn columns, and the
partial outputs are summed over ``expert``, then ``tensor``, in float32;
:class:`BatchRouting` spans the ranks that hold other tokens of the same
microbatch (the data axes and ``sp``), so routing keeps the reference's
global ``(b, s)`` order; :func:`pipeline_hooks` is the GPipe stage
adapter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from kubedl_tpu_torch.models.llama import (
    TrainShard, _chunk_nll_sum, _dense, apply_rope, attention,
    next_token_nll, params_from_numpy, remat_layers, rmsnorm, rope_table,
)
from kubedl_tpu_torch.parallel.mesh import SEQUENCE_AXIS, copy_to, reduce_from

Params = Dict[str, Any]


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
    by ``dense(name, shape, fan_in)`` or ``norm(name, shape)`` in the
    reference's order (``name``: the leaf's path, ``"layers/w_in"``)."""
    hd = cfg.head_dim
    L, D, Fd, E, V = (cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.n_experts,
                      cfg.vocab_size)
    return {
        "embed": dense("embed", (V, D), D),
        "layers": {
            "attn_norm": norm("layers/attn_norm", (L, D)),
            "wq": dense("layers/wq", (L, D, cfg.n_heads * hd), D),
            "wk": dense("layers/wk", (L, D, cfg.n_kv_heads * hd), D),
            "wv": dense("layers/wv", (L, D, cfg.n_kv_heads * hd), D),
            "wo": dense("layers/wo", (L, cfg.n_heads * hd, D),
                        cfg.n_heads * hd),
            "mlp_norm": norm("layers/mlp_norm", (L, D)),
            "router": dense("layers/router", (L, D, E), D),
            "w_in": dense("layers/w_in", (L, E, D, Fd), D),
            "w_out": dense("layers/w_out", (L, E, Fd, D), Fd),
        },
        "final_norm": norm("final_norm", (D,)),
        "lm_head": dense("lm_head", (D, V), D),
    }


def moe_init(cfg: MoEConfig, generator: torch.Generator, device,
             shard: Optional[TrainShard] = None) -> Params:
    """Seeded random init with the reference's fan-in scaling and tree.
    ``generator`` must live on ``device``. With a ``shard`` each leaf is
    cut to this rank's region as it is drawn (the values are the one-rank
    init's)."""

    def keep(name, t):
        return t if shard is None else shard.local(name, t)

    def dense(name, shape, fan_in):
        return keep(name, _dense(shape, fan_in, cfg, generator, device))

    def norm(name, shape):
        return keep(name, torch.ones(shape, dtype=cfg.dtype, device=device))

    return _param_tree(cfg, dense, norm)


def param_like(cfg: MoEConfig, device="meta") -> Params:
    """The parameter tree's shapes and dtypes as empty tensors."""

    def empty(_name, shape, _fan_in=None):
        return torch.empty(shape, dtype=cfg.dtype, device=device)

    return _param_tree(cfg, empty, empty)


def param_pspecs(cfg: MoEConfig) -> Params:
    """The reference's layout (``moe.py:144``) as a tree of tuples, one
    mesh-axis name (or None) a dimension: the expert leaves over
    "expert" (and their ffn columns over "tensor"), the dense ones over
    fsdp / tensor as in the Llama rules; the router is split over fsdp
    only."""
    del cfg
    return {
        "embed": ("tensor", "fsdp"),
        "layers": {
            "attn_norm": (None, None),
            "wq": (None, "fsdp", "tensor"),
            "wk": (None, "fsdp", "tensor"),
            "wv": (None, "fsdp", "tensor"),
            "wo": (None, "tensor", "fsdp"),
            "mlp_norm": (None, None),
            "router": (None, "fsdp", None),
            "w_in": (None, "expert", "fsdp", "tensor"),
            "w_out": (None, "expert", "tensor", "fsdp"),
        },
        "final_norm": (None,),
        "lm_head": ("fsdp", "tensor"),
    }


# ---- the switch layer ----------------------------------------------------------

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
    router_w: torch.Tensor,  # [D, E] (always the FULL expert count)
    w_in: torch.Tensor,  # [E(, local), D, F(, local)]
    w_out: torch.Tensor,  # [E(, local), F(, local), D]
    cfg: MoEConfig,
    ep_axis=None,
    tp_axis=None,
    dp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 switch layer with index dispatch. Returns (out, aux_loss).

    Bit for bit the reference's forward (``moe.py:165-229``): slot (e, c)
    holds row ``x[t]`` of the c-th token routed to e (float32, rounded to
    ``cfg.dtype``), empty slots hold zeros, and token t gets back
    ``ye[e, c].float() * gate[t]`` rounded to ``x.dtype``, or exactly 0
    when dropped. Both moves are index copies into fresh zeros, every
    target distinct (spare rows past the real ones take a dropped
    token's row and an empty slot's), so their backward is a gather: no
    scatter-add, whose runs of one repeated index serialize.

    ``ep_axis`` / ``tp_axis``: ``(mesh, axes)`` of the expert and tensor
    splits (the reference's axis names, with the mesh that runs their
    collectives). Routing runs on the full E on every rank;
    ``w_in`` / ``w_out`` hold this rank's ``E / ep`` experts (from expert
    ``mesh.index(axes) * E / ep``), whose ffn columns ``tp_axis`` splits
    (``w_in`` column-parallel, ``w_out`` row-parallel); the rank
    dispatches only the tokens routed to its experts. The partial outputs
    are summed over the expert axes, then the tensor axes, in float32
    before the cast, as the reference's ``psum``s. The token rows and
    the gates enter that expert-local region through Megatron's f
    (``copy_to``: their gradients are summed over both splits there),
    while the routing and the aux loss, which every rank computes whole,
    stay outside it, so no gradient is summed twice. Every rank issues
    the sums, also with no token routed to its experts.

    ``dp`` (a :class:`BatchRouting`): ``x`` is this rank's part of a
    microbatch split over data-parallel ranks (rows) and ``sp`` ranks
    (blocks of the sequence), and the layer keeps the reference's global
    semantics, as its sharded step computes them: the capacity of the
    whole microbatch, each token's place in its expert's queue counted
    over every token before it in the global ``(b, s)`` order
    (:meth:`BatchRouting.offsets`), and the aux loss's token fractions
    over every rank. The aux loss returned is this rank's share, scaled
    so that the mean over ranks is the global value and its gradient the
    global one."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    T = B * S
    cap = capacity(cfg, T * (dp.size if dp else 1), E)
    xt = x.reshape(T, D)
    probs, gate, choice, pos, keep = route(xt, router_w, cap)
    c = cap
    if dp is not None:
        row = torch.arange(T, device=x.device) // S
        hits = torch.bincount(row * E + choice, minlength=B * E).view(B, E)
        keep = pos + dp.offsets(hits)[row, choice] < cap
        c = min(cap, T)  # a kept token's local place is below both
    El, e0 = w_in.shape[0], 0
    if ep_axis is not None:  # this rank's experts [e0, e0 + El)
        mesh, axes = ep_axis
        e0 = mesh.index(mesh.active(axes)) * El
        keep = keep & (choice >= e0) & (choice < e0 + El)
    split = [p for p in (ep_axis, tp_axis) if p is not None]
    xd, gd = xt, gate
    if split:
        mesh = split[0][0]
        axes = tuple(a for _, ax in split for a in ax)
        xd, gd = copy_to(xt, mesh, axes), copy_to(gate, mesh, axes)

    # token -> flat slot (e - e0)*c + place; a dropped token (or one routed
    # to another rank's expert) gets a spare row of its own past the El*c
    # real slots
    n_slots = El * c
    tok = torch.arange(T, device=x.device)
    slot = torch.where(keep, (choice - e0) * c + pos, n_slots + tok)
    xe = xd.new_zeros(n_slots + T, D).index_copy_(0, slot, xd)[:n_slots]
    # the reference's float32 product rounded to cfg.dtype: a float
    # row widens exactly, so one cast rounds the same
    ye = _experts(xe.view(El, c, D).to(cfg.dtype), w_in, w_out, cfg.dtype)
    # slot -> its token, or a spare row past T for an empty slot
    back = (T + torch.arange(n_slots + T, device=x.device)).index_copy(
        0, slot, tok)[:n_slots]
    yt = ye.new_zeros(T + n_slots, D).index_copy_(
        0, back, ye.view(n_slots, D))[:T]
    yt = yt.float() * gd[:, None]
    for part in split:  # expert, then tensor, as the reference's psums
        yt = reduce_from(yt, *part)
    if dp is None:
        aux = _aux_loss(probs, choice)
    else:
        onehot = (choice[:, None] == torch.arange(E, device=x.device))
        frac = dp.sum(onehot.sum(dim=0).float()) / (T * dp.size)
        aux = E * torch.sum(frac * probs.sum(dim=0)) / T
    return yt.reshape(B, S, D).to(x.dtype), aux


def block_offsets(every: torch.Tensor, dp_index: int,
                  block: int) -> torch.Tensor:
    """The exact integer scan of the routing across ranks. ``every``
    ``[dp, sp, rows, E]``: each routing rank's per-row, per-expert hit
    counts, gathered in rank order (data-parallel index major, sequence
    block minor). Returns ``[rows, E]``: for each row of rank
    ``(dp_index, block)``, the tokens routed to each expert before the
    row's first token in the global ``(b, s)`` order (every token of the
    rows before it, the other data ranks' rows included, then the
    earlier blocks of its own row), less the tokens of this rank's
    earlier rows, which the local running count of :func:`route`
    already holds. So ``pos + offsets[row, choice]`` is a token's place
    in the one-device queue."""
    dp, sp, rows, E = every.shape
    g = every.permute(0, 2, 1, 3).reshape(dp * rows * sp, E)
    before = (g.cumsum(0) - g).view(dp, rows, sp, E)[dp_index, :, block]
    mine = every[dp_index, block]
    return before - (mine.cumsum(0) - mine)


class BatchRouting:
    """What :func:`moe_ffn` needs of the ranks that hold other tokens of
    the same microbatch (``mesh``: a
    :class:`~kubedl_tpu_torch.parallel.mesh.ProcessMesh`, ``axes``: the
    data-like axes and ``sp``; those above 1 count): their count, the
    queue offsets of this rank's rows (one all-gather of its per-row hit
    counts) and a sum over them. Every rank issues each collective, also
    when no token is routed to its experts."""

    def __init__(self, mesh, axes) -> None:
        self.mesh, self.axes = mesh, mesh.active(tuple(axes))
        self.size = mesh.size(self.axes)
        on_sp = SEQUENCE_AXIS in self.axes
        self.sp = mesh.shape[SEQUENCE_AXIS] if on_sp else 1
        self.dp_index = mesh.index(tuple(a for a in self.axes
                                         if a != SEQUENCE_AXIS))
        self.block = mesh.coords[SEQUENCE_AXIS] if on_sp else 0

    def offsets(self, hits: torch.Tensor) -> torch.Tensor:
        """``hits`` [rows, E]: this rank's tokens per row and expert ->
        :func:`block_offsets` of this rank, from every rank's counts."""
        every = hits.new_empty(self.size * hits.numel())
        self.mesh.all_gather(every, hits.reshape(-1).contiguous(), self.axes)
        return block_offsets(
            every.view(self.size // self.sp, self.sp, *hits.shape),
            self.dp_index, self.block)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (no gradient flows through it)."""
        out = t.detach().clone()
        self.mesh.all_reduce(out, self.axes)
        return out


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
           attn_fn=None, tp_axis=None, ep_axis=None, dp=None):
    """One decoder block: attention as the Llama block's (q/k PRE-rope
    with the tables into an ``attn_fn`` that has ``fused_rope``), then
    the switch layer. ``tp_axis`` / ``ep_axis`` / ``dp`` as in
    :func:`moe_ffn`; under ``tp_axis`` the attention runs this rank's
    heads, Megatron's f before the projections and the all-reduce after
    ``wo`` (``moe.py:232``). Returns (x, aux)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    if tp_axis:
        h = copy_to(h, *tp_axis)
    n_heads = lp["wq"].shape[-1] // hd  # local under the tensor split
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
    attn_out = attn.reshape(B, S, n_heads * hd) @ lp["wo"]
    x = x + (reduce_from(attn_out, *tp_axis) if tp_axis else attn_out)
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    ffn, aux = moe_ffn(h, lp["router"], lp["w_in"], lp["w_out"], cfg,
                       ep_axis, tp_axis, dp)
    return x + ffn, aux


def moe_forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
                attn_fn=None, dp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] float32, mean aux loss).
    ``attn_fn`` swaps the attention implementation, as in llama_forward;
    ``dp`` as in :func:`moe_ffn`.
    With ``cfg.remat`` each layer runs under the selective checkpoint of
    ``llama_hidden`` (``remat_policy_for(cfg.remat_policy)``)."""
    S = tokens.shape[1]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    cos, sin = rope_table(cfg.head_dim, cfg.rope_theta, S, device=x.device)

    def step(x, lp, names):
        del names
        return _block(x, lp, cfg, cos, sin, attn_fn, dp=dp)

    x, auxes = remat_layers(step, x, params["layers"], cfg.remat,
                            cfg.remat_policy)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"]).float()
    return logits, torch.stack(auxes).mean()


def moe_loss(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
             attn_fn=None, dp=None) -> torch.Tensor:
    logits, aux = moe_forward(params, tokens, cfg, attn_fn, dp)
    return next_token_nll(logits, tokens) + cfg.aux_loss_weight * aux


# ---- across processes: the sharded model and the pipeline stages -----------------

class MoEShard(TrainShard):
    """This rank's part of a switch-MoE model sharded over the ``fsdp``,
    ``tensor``, ``sp``, ``expert`` and ``pipe`` axes (``specs``: a tree
    of specs, default :func:`param_pspecs`), on :class:`TrainShard`'s
    layout, and the training loss of the unpipelined path on it. ``dp``:
    the routing over the ranks that hold other tokens of the microbatch
    (:class:`BatchRouting`), so that routing spans the whole microbatch
    as the reference's global arrays do."""

    def __init__(self, cfg: MoEConfig, mesh, specs: Optional[Params] = None,
                 dp=None) -> None:
        super().__init__(cfg, mesh,
                         param_pspecs(cfg) if specs is None else specs)
        self.dp = dp

    def _step(self, x, lp, cos, sin, attn_fn, names):
        del names
        return _block(x, self.gather_layer(lp), self.cfg, cos, sin, attn_fn,
                      self.tp, self.ep, self.dp)

    def loss(self, params: Params, tokens: torch.Tensor,
             attn_fn=None) -> torch.Tensor:
        """:func:`moe_loss` on this rank's rows: the embedding and the
        head gathered whole, each layer's fsdp shards gathered as it runs
        (inside its remat), this rank's heads and experts; the aux loss
        is this rank's share (so the mean over the batch ranks is the
        reference's loss). The NLL is the mean over the rows; with sp,
        as :meth:`TrainShard.loss`: ``tokens`` is this rank's block of
        the sequence and the next block's first token, RoPE runs at
        global positions, the attention is the trainer's context
        attention, and the NLL is this rank's share of the global
        mean."""
        cfg = self.cfg
        rows = tokens.shape[0]
        inp = tokens[:, :-1] if self.sp > 1 else tokens
        Sl = inp.shape[1]
        off = self.mesh.coords[SEQUENCE_AXIS] * Sl if self.sp > 1 else 0
        x = self.gather_whole(params["embed"], "embed")[inp.long()]
        x = x.to(cfg.dtype)
        cos, sin = rope_table(cfg.head_dim, cfg.rope_theta, off + Sl,
                              device=x.device)
        x, auxes = remat_layers(self._step, x, params["layers"], cfg.remat,
                                cfg.remat_policy, cos[off:], sin[off:],
                                attn_fn)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        head = self.gather_whole(params["lm_head"], "lm_head")
        aux = cfg.aux_loss_weight * torch.stack(auxes).mean()
        if self.sp == 1:
            return next_token_nll((x @ head).float(), tokens) + aux
        S = Sl * self.sp
        valid = Sl - (off + Sl == S)  # the last block's final position
        nll = _chunk_nll_sum(x[:, :valid], head, tokens[:, 1:valid + 1])
        return nll / (rows * (S - 1) / self.sp) + aux


def pipeline_hooks(cfg: MoEConfig, shard: TrainShard):
    """The GPipe adapter (the reference's ``pipeline_hooks``,
    ``moe.py:292``): the stage body runs this rank's slice of the stacked
    layers under the remat policy, with the expert and tensor splits
    inside, and returns the sum of its layers' aux losses. Routing,
    capacity and the aux loss are per microbatch and per data rank, as
    inside the reference's ``shard_map``."""
    from kubedl_tpu_torch.parallel.pipeline import PipelineHooks

    def embed(params, tokens):
        e = shard.gather_whole(params["embed"], "embed")
        return e[tokens.long()].to(cfg.dtype)

    def make_stage(attn_fn, cos, sin, tp=None, ep=None):
        def step(x, lp, names):
            del names
            return _block(x, lp, cfg, cos, sin, attn_fn, tp, ep)

        def stage_fn(layer_params, x):
            x, auxes = remat_layers(step, x, layer_params, cfg.remat,
                                    cfg.remat_policy)
            return x, torch.stack(auxes).sum().float()

        return stage_fn

    def head_loss(params, h, tokens, aux_mean):
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        head = shard.gather_whole(params["lm_head"], "lm_head")
        logits = (h @ head).float()
        return next_token_nll(logits, tokens) + cfg.aux_loss_weight * aux_mean

    return PipelineHooks(
        embed=embed,
        rope=lambda S, device: rope_table(cfg.head_dim, cfg.rope_theta, S,
                                          device=device),
        make_stage=make_stage, head_loss=head_loss, n_layers=cfg.n_layers)


__all__ = [
    "MoEConfig", "TINY_MOE", "BENCH_MOE", "PRESETS", "preset", "moe_init",
    "param_like", "param_pspecs", "params_from_numpy", "capacity", "route",
    "moe_ffn", "moe_ffn_plain", "moe_forward", "moe_loss",
    "BatchRouting", "block_offsets", "MoEShard", "pipeline_hooks",
]
