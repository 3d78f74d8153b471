"""The trainer: the port of ``kubedl_tpu/training/trainer.py``.

Eager PyTorch, one device a process: the train step runs forward and
backward through the model family's loss, then the optimizer updates the
parameters IN PLACE (the reference donates its state buffers to a jitted
step; here the state dict keeps the same tensors and rewrites them).

What the port keeps of the reference, and how:

- ``TrainConfig`` has every field of the reference; ``init_rng_impl`` is
  accepted and unused (a ``torch.Generator`` has one implementation).
- :func:`make_optimizer` is a plain-PyTorch port of the optax chain
  ``clip_by_global_norm -> adamw(warmup_cosine_decay_schedule)``, step
  for step: optax counts from 0, so the FIRST update runs at
  ``lr = schedule(0)`` (0.0 with the trainer's warmup); the first moment
  ``mu`` is kept in ``opt_moment_dtype`` but the second moment ``nu`` in
  the PARAMETERS' dtype (bf16 for bf16 models); weight decay applies to
  every leaf, norms included. The update itself is one operator
  (``ops/adamw.py``, a hand-written kernel on CUDA) that computes what
  the reference's COMPILED step computes, bf16 roundings included.
- Data parallelism over processes (a ``replica`` / ``data`` mesh from
  ``parallel/mesh.py``, one rank a device): every rank reads the same
  global batch and trains on its rows of each microbatch; the gradients
  are reduced over the ranks. ``shard_update`` on a data axis above 1 is
  the reference's ZeRO-style sharded update (``_update_shardings``):
  reduce-scatter, the update of this rank's shard of params and moments
  (which exist only as shards), all-gather; ``overlap_comm`` with
  ``grad_accum > 1`` issues each microbatch's reduce-scatters
  asynchronously, one a bucket of ``training/buckets.py``'s plan, as
  soon as its backward is done. Otherwise the gradients are all-reduced
  and every rank runs the full update. See :meth:`Trainer.train_step`.
- ``fit`` keeps the reference's timing discipline: the clock after the
  first step and at the end stops on a scalar ``.item()`` of the loss, a
  true barrier; steps between logs issue no host sync on one process
  (the data-parallel step reduces its loss over the ranks every step,
  and gloo on the card stages through the host). Summary keys with no
  counterpart here (``warm_compile_s`` and the other ahead-of-time
  compile keys, ``flash_trace_count``) are None; ``flash_launches`` and
  ``adamw_launches`` carry the kernels' launch counts instead (a rank is
  a process of its own), ``dist_backend`` and ``collective_ms`` the
  collectives'.
- ``fit(ckpt_dir=...)`` saves the train state every ``ckpt_every`` steps
  and at the end (asynchronously with ``ckpt_async``), in the reference's
  tree and format (each rank its shards), so either package resumes the
  other's job.

- The model sharded across processes: on a mesh whose ``fsdp``,
  ``tensor``, ``sp``, ``expert`` or ``pipe`` axes are above 1 (alone or
  with ``data`` / ``replica``) each rank holds its shards of every leaf
  by the family's ``param_pspecs`` (``models/llama.py::TrainShard``,
  ``models/moe.py::MoEShard``, which also run the sharded forward: fsdp
  gathers, the Megatron split, ring / Ulysses attention over ``sp``,
  this rank's experts), its moments are shards of those (cut
  again over ``data`` by the reference's update rule), the gradients
  are summed over the ranks that hold other tokens, and the global norm
  counts a leaf that several ranks hold alike once.
- Pipeline mode (a ``pipe`` axis above 1): the reference's
  ``_pipe_pspecs`` (the stacked ``layers`` leaves split their leading
  dimension over ``pipe``, keep ``tensor`` / ``expert`` on the inner
  ones and drop ``fsdp``, which becomes a batch axis) and
  ``_make_pipeline_loss``: the embedding, ``microbatches`` (0: 4 x pipe)
  GPipe microbatches through ``parallel/pipeline.py`` (each data rank
  holds its rows of every microbatch, as the reference's ``[M, mb]``
  reshape shards them), then the head and the loss on every stage. The
  update is replicated over the data axes, as the reference's.

Model families: dense Llama (``models/llama.py``) and switch-MoE
(``models/moe.py``: on the unpipelined path routing spans every rank
that holds other tokens of the microbatch, the data axes and ``sp``, in
the reference's global order; in pipeline mode routing is per
microbatch and data rank, as the reference's), through the same
optimizer and flash operators.

- ``fit_ps``: the parameter-service loop (``train_mode: "ps"``), the
  reference's protocol against an in-process
  :class:`~kubedl_tpu_torch.ps.service.ParameterService` or the HTTP
  :class:`~kubedl_tpu_torch.ps.server.PSClient` (either package's tier):
  the params cross to the host as float32 by their keystr names
  (``checkpoint._leaf_items``: the reference's), through two sets of
  pinned buffers on CUDA and one synchronisation a push.

What it rejects with a ValueError, never silently: ``pipe`` with an
``sp`` axis above 1 (the reference's message), and ``fit_ps`` on a model
sharded across processes (each worker pushes its whole model).
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from kubedl_tpu_torch.api.topology import MeshSpec
from kubedl_tpu_torch.models import llama, moe
from kubedl_tpu_torch.ops import flash_attention as fa
from kubedl_tpu_torch.ops.adamw import LAUNCHES as adamw_launches
from kubedl_tpu_torch.ops.adamw import adamw_update
from kubedl_tpu_torch.parallel.mesh import (
    DATA_AXES, SEQUENCE_AXIS, ProcessMesh, ShardSpec, axis_size, build_mesh,
    check_axes, copy_to, local_mesh,
)
from kubedl_tpu_torch.parallel.pipeline import pipeline_apply
from kubedl_tpu_torch.training.buckets import plan_grad_buckets


@dataclass(frozen=True)
class ModelFamily:
    """Adapter the trainer uses to stay model-agnostic: init/loss
    functions plus FLOPs accounting."""

    name: str
    init: Callable[[torch.Generator, torch.device], Any]
    loss: Callable[..., torch.Tensor]  # (params, batch, attn_fn=) -> scalar
    num_params: int
    flops_per_token: float
    vocab_size: int
    #: () -> the parameter tree as ``meta`` tensors (shapes and dtypes)
    like: Callable[[], Any]
    #: () -> the reference's tree of parameter specs (``param_pspecs``);
    #: None: the family cannot be sharded
    pspecs: Optional[Callable[[], Any]] = None
    #: shard -> the GPipe adapter (``PipelineHooks``); None: no pipe axis
    pipeline_hooks: Optional[Callable[[Any], Any]] = None


def llama_family(cfg: llama.LlamaConfig,
                 shard: Optional[llama.TrainShard] = None) -> ModelFamily:
    """``shard``: the model split over the mesh's model axes
    (:class:`~kubedl_tpu_torch.models.llama.TrainShard`): init draws this
    rank's shards and the loss is this rank's share of the global one."""
    if shard is not None:
        return dataclasses.replace(
            llama_family(cfg),
            init=lambda gen, device: llama.llama_init(cfg, gen, device,
                                                      shard),
            loss=lambda params, batch, attn_fn=None: shard.loss(
                params, batch, attn_fn))
    return ModelFamily(
        name="llama",
        init=lambda gen, device: llama.llama_init(cfg, gen, device),
        loss=lambda params, batch, attn_fn=None: llama.llama_loss(
            params, batch, cfg, attn_fn
        ),
        num_params=cfg.num_params(),
        flops_per_token=cfg.flops_per_token(),
        vocab_size=cfg.vocab_size,
        like=lambda: llama.param_like(cfg),
        pspecs=lambda: llama.param_pspecs(cfg),
        pipeline_hooks=lambda sh: llama.pipeline_hooks(cfg, sh),
    )


def moe_family(cfg: moe.MoEConfig, dp=None,
               shard: Optional[moe.MoEShard] = None) -> ModelFamily:
    """``dp``: the ranks a microbatch is split over
    (:class:`~kubedl_tpu_torch.models.moe.BatchRouting`), which the
    switch layer's routing spans; ``shard``: the model split over the
    mesh's model axes (:class:`~kubedl_tpu_torch.models.moe.MoEShard`,
    which routes over its own ``dp``)."""
    if shard is not None:
        return dataclasses.replace(
            moe_family(cfg),
            init=lambda gen, device: moe.moe_init(cfg, gen, device, shard),
            loss=lambda params, batch, attn_fn=None: shard.loss(
                params, batch, attn_fn))
    return ModelFamily(
        name="moe",
        init=lambda gen, device: moe.moe_init(cfg, gen, device),
        loss=lambda params, batch, attn_fn=None: moe.moe_loss(
            params, batch, cfg, attn_fn, dp
        ),
        num_params=cfg.num_params(),
        flops_per_token=cfg.flops_per_token(),
        vocab_size=cfg.vocab_size,
        like=lambda: moe.param_like(cfg),
        pspecs=lambda: moe.param_pspecs(cfg),
        pipeline_hooks=lambda sh: moe.pipeline_hooks(cfg, sh),
    )


def family_for(model_cfg) -> ModelFamily:
    if isinstance(model_cfg, llama.LlamaConfig):
        return llama_family(model_cfg)
    if isinstance(model_cfg, moe.MoEConfig):
        return moe_family(model_cfg)
    if isinstance(model_cfg, ModelFamily):
        return model_cfg
    raise TypeError(f"unknown model config type {type(model_cfg)!r}")


@dataclass(frozen=True)
class TrainConfig:
    model: Any = field(default_factory=lambda: llama.TINY)
    global_batch: int = 8
    seq_len: int = 128
    steps: int = 50
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    #: microbatches per step (gradient accumulation); 1 = off
    grad_accum: int = 1
    #: "auto" (flash on CUDA, dense on the CPU), "dense", or "flash"
    #: (forced: the kernels on CUDA, their plain versions on the CPU)
    attn_impl: str = "auto"
    context_parallel_impl: str = "ring"
    #: GPipe microbatches when the mesh has a "pipe" axis; 0 = auto (4x the
    #: pipe axis size, the classic bubble-amortizing choice)
    microbatches: int = 0
    #: save the train state every N steps in ``fit`` (with a ckpt_dir)
    ckpt_every: int = 0
    ckpt_async: bool = True
    #: dtype of the adam FIRST moment (mu); nu keeps the params' dtype
    opt_moment_dtype: str = "float32"
    init_rng_impl: str = "rbg"
    shard_update: bool = True
    overlap_comm: bool = True
    grad_bucket_mb: float = 4.0
    #: fetch the loss to the host every N steps in ``fit`` (plus the first
    #: and the final step); every fetch is a device barrier
    log_every: int = 0
    long_context_policy: str = "auto"
    long_context_threshold: int = 4096
    seed: int = 0


# ---- optimizer: the optax chain, in plain PyTorch ---------------------------

def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """``optax.warmup_cosine_decay_schedule``: linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` at ``decay_steps``. count -> float."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class AdamW:
    """``optax.chain(clip_by_global_norm(clip), adamw(schedule, b1, b2,
    eps, weight_decay, mu_dtype))`` over a list of parameter tensors, as
    the reference's jitted step computes it.

    State: ``{"count": int, "mu": [...], "nu": [...]}``. ``update``
    rewrites the parameters and the moments in place through
    :func:`kubedl_tpu_torch.ops.adamw.adamw_update` (the fused kernels on
    CUDA, their plain version on the CPU; its docstring states every
    rounding) and returns the global norm of the incoming gradients (a
    float32 device scalar holding the reference's value: bf16-rounded for
    bf16 gradients). Update t+1 runs at ``schedule(t)``, so the first
    moves nothing when the warmup starts from 0."""

    def __init__(self, schedule, grad_clip: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 mu_dtype: torch.dtype = torch.float32) -> None:
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype

    def init(self, leaves: List[torch.Tensor]) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, dtype=self.mu_dtype) for p in leaves],
            "nu": [torch.zeros_like(p) for p in leaves],
        }

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               leaves: List[torch.Tensor],
               sum_partials=None) -> torch.Tensor:
        """``sum_partials``: the sharded update's cross-rank sum of the
        norm's partial sums (``ops/adamw.py::adamw_update``)."""
        lr = self.schedule(state["count"])
        state["count"] += 1
        stats = adamw_update(
            grads, leaves, state["mu"], state["nu"], lr=lr,
            t=state["count"], b1=self.b1, b2=self.b2, eps=self.eps,
            weight_decay=self.weight_decay, clip=self.grad_clip,
            sum_partials=sum_partials)
        return stats[0]


def make_optimizer(cfg: TrainConfig) -> AdamW:
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=cfg.learning_rate,
        warmup_steps=cfg.warmup_steps,
        decay_steps=max(cfg.steps, cfg.warmup_steps + 1),
        end_value=cfg.learning_rate * 0.1,
    )
    return AdamW(schedule, cfg.grad_clip, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=cfg.weight_decay,
                 mu_dtype=_DTYPES[cfg.opt_moment_dtype])


# ---- parameter trees (nested dicts of tensors) -------------------------------

def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in the reference's tree order (dict keys sorted, as
    ``jax.tree_util`` flattens): the optimizer's global norm sums them in
    this order, and the moments' lists follow it."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            filled = {k: walk(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        return next(it)

    return walk(tree)


#: count of host scalar fetches (each a device barrier), as in the reference
SCALAR_FETCHES = 0


def _fetch_scalar(x: torch.Tensor) -> float:
    """True device barrier: bring one scalar to the host."""
    global SCALAR_FETCHES
    SCALAR_FETCHES += 1
    return float(x.item())


def state_bytes_per_device(state, key: str = "opt_state") -> int:
    """Bytes of the optimizer state this device holds, as the reference
    counts its tree: the moments (their shards under the sharded update)
    and the Adam and schedule counts (an int32 scalar each)."""
    opt = state[key]
    return 2 * 4 + sum(t.numel() * t.element_size()
                       for t in opt["mu"] + opt["nu"])


class Trainer:
    """The reference's ``Trainer`` (see the module docstring for what is
    ported and what raises)."""

    def __init__(self, cfg: TrainConfig, mesh=None, device=None) -> None:
        if not isinstance(mesh, ProcessMesh):
            # a mapping of axes (or None): pipe / expert raise, a mesh of
            # many devices needs the job's process group, and a mesh of
            # one device is this process alone
            spec = MeshSpec(fa.mesh_axes(mesh))
            check_axes(spec)
            mesh = build_mesh(spec, device) if spec.size() > 1 \
                else local_mesh(device)
        self.mesh = mesh
        self.device = mesh.device
        #: the data-like axes above 1 and the ranks along them
        self.dp_axes = mesh.active(DATA_AXES)
        self.dp = mesh.size(self.dp_axes)
        #: the axes whose ranks hold distinct tokens (rows, or blocks of
        #: the sequence) and how many ranks that is: a gradient is summed
        #: over them, a loss averaged
        self.batch_axes = mesh.active(DATA_AXES + (SEQUENCE_AXIS,))
        self.batch_ranks = mesh.size(self.batch_axes)
        self.sp = axis_size(mesh, SEQUENCE_AXIS)
        if cfg.global_batch % cfg.grad_accum:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split into grad_accum={cfg.grad_accum}")
        if cfg.global_batch % (cfg.grad_accum * self.dp):
            # each rank's loss is the mean over its rows: the mean over
            # ranks is the global mean only for equal token counts
            raise ValueError(
                f"global_batch {cfg.global_batch}: {cfg.grad_accum} "
                f"microbatches do not split evenly over {self.dp} ranks")
        if cfg.seq_len % self.sp:
            raise ValueError(f"seq_len={cfg.seq_len} not divisible by "
                             f"sp={self.sp}")
        #: GPipe stages, and the microbatches a step's batch (of each
        #: grad_accum microbatch) is cut into (1 without a pipe axis)
        self.pipe = axis_size(mesh, "pipe")
        self.microbatches = cfg.microbatches or 4 * self.pipe \
            if self.pipe > 1 else 1
        model_axes = mesh.active(("fsdp", "pipe", "expert", SEQUENCE_AXIS,
                                  "tensor"))
        if getattr(cfg.model, "fuse_projections", False) and \
                axis_size(mesh, "tensor") > 1:
            # concat-at-use along the column-split dim: the reference
            # turns the fusion off on a tensor-parallel mesh
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, fuse_projections=False))
        self.cfg = cfg
        cfg = self._apply_long_context_policy(cfg)
        base = family_for(cfg.model)
        is_moe = isinstance(cfg.model, moe.MoEConfig)
        # the switch layer's routing spans the ranks that hold other
        # tokens of a microbatch, rows and sequence blocks (in pipeline
        # mode it is per microbatch and data rank)
        routing = moe.BatchRouting(mesh, self.batch_axes) \
            if is_moe and self.batch_ranks > 1 and self.pipe == 1 else None
        #: this rank's part of a model sharded over the model axes
        self.shard: Optional[llama.TrainShard] = None
        #: leaf path -> its spec pruned to the mesh's axis names, or None
        self.specs: Optional[Dict[str, tuple]] = None
        if base.pspecs is not None:
            specs = base.pspecs()
            if self.pipe > 1:
                specs = self._pipe_pspecs(specs, base)
            self.specs = llama.prune_specs(specs, set(mesh.axis_names))
        if model_axes:
            if self.specs is None:
                raise ValueError(f"mesh axes {model_axes}: the model "
                                 f"family {base.name!r} has no param_pspecs")
            if is_moe:
                self.shard = moe.MoEShard(cfg.model, mesh, specs, routing)
                self.family = moe_family(cfg.model, shard=self.shard)
            else:
                self.shard = llama.TrainShard(cfg.model, mesh, specs)
                self.family = llama_family(cfg.model, self.shard)
        else:
            self.family = moe_family(cfg.model, routing) if routing \
                else base
        if self.pipe > 1:
            rows, M = cfg.global_batch // cfg.grad_accum, self.microbatches
            if rows % M:
                raise ValueError(f"global_batch={cfg.global_batch} must "
                                 f"divide into microbatches={M}")
            if rows // M % self.dp:
                raise ValueError(f"a microbatch of {rows // M} rows does "
                                 f"not split over {self.dp} data ranks")
            self.family = dataclasses.replace(
                self.family, loss=self._make_pipeline_loss(base, self.shard))
        self.tx = make_optimizer(cfg)
        like_tree = self.family.like()
        like = tree_leaves(like_tree)
        self.leaf_paths = [name for name, _ in llama.named_leaves(like_tree)]
        self.grad_bucket_plan = plan_grad_buckets(
            [t.numel() * t.element_size() for t in like],
            int(cfg.grad_bucket_mb * 2**20))
        #: per leaf (tree order): where this rank's parameter shard sits in
        #: the global leaf, or None (the leaf is whole here)
        self.param_specs: List[Optional[ShardSpec]] = (
            self.shard.regions(like_tree) if self.shard is not None
            else [None] * len(like))
        #: per leaf: the dimension of this rank's parameter tensor the
        #: sharded update splits over the data axis, or None
        self.update_dims = self._update_dims(like)
        #: the axes the weight update shards over: ("data",) or none
        self.update_axes = ("data",) if any(
            d is not None for d in self.update_dims) else ()
        #: per leaf: where this rank's optimizer moments sit in the global
        #: leaf (the parameter shard, cut again by the update), or None
        self.shard_specs = [self._moment_spec(i, tuple(t.shape))
                            for i, t in enumerate(like)]
        #: per leaf: the axes its gradient is all-reduced over after the
        #: backward (the batch axes, less fsdp where the backward's
        #: reduce-scatter summed it, less data where the update's does)
        self.sum_axes = [self._sum_axes(i) for i in range(len(like))]
        #: per leaf: the expert axes above 1 that do not split it. Every
        #: rank along them runs the leaf's computation on the same tokens
        #: (attention, embedding, head, router), and the flash backward's
        #: dq sums land in a run-to-run order, so its gradient is averaged
        #: over them: the replicas stay bit-identical
        self.replica_axes = [
            tuple(a for a in mesh.active(("expert",))
                  if a not in self._split_axes(i)) for i in range(len(like))]
        #: per leaf: 1.0 where this rank's slice counts in the global
        #: norm (the first of the ranks that hold it alike), else 0.0
        self._norm_keep = [
            float(all(mesh.coords[a] == 0
                      for a in mesh.active(mesh.axis_names)
                      if a not in self._split_axes(i, moments=True)))
            for i in range(len(like))]
        self.attn_impl = "dense"
        self.attn_fn = self._select_attn()
        #: fit_ps's two sets of pinned host buffers (CUDA), by slot
        self._pinned: Dict[int, Dict[str, torch.Tensor]] = {}

    def _pipe_pspecs(self, specs, family: ModelFamily):
        """The reference's pipeline layout (``trainer.py:532``): the
        stacked ``layers`` leaves split their leading dimension over
        "pipe" and keep "tensor" / "expert" on the inner ones (the stage
        body issues those collectives itself), fsdp / sp dropped; the
        other leaves keep their specs. A pipe axis with sp above 1
        raises the reference's message; so does a dimension a mesh axis
        does not divide (``_validate_pipe_divisibility``)."""
        if family.pipeline_hooks is None:
            raise ValueError(f"model family {family.name!r} has no "
                             f"pipeline_hooks")
        if self.sp > 1:
            raise ValueError(
                "pipe axis cannot be combined with a >1 'sp' axis (ring "
                "attention does not cross the GPipe stage boundary); use "
                "pipe x data/fsdp/tensor/expert meshes")
        llama.check_divisible(self.cfg.model, self.mesh)

        def inner(axis):
            return axis if axis in ("tensor", "expert") else None

        out = dict(specs)
        out["layers"] = {k: ("pipe",) + tuple(inner(a) for a in s[1:])
                         for k, s in specs["layers"].items()}
        return out

    def _make_pipeline_loss(self, family: ModelFamily, shard):
        """The reference's GPipe loss (``trainer.py:762``), on this rank:
        the embedding of its rows (every stage looks it up, stage 0 uses
        it, and ``copy_to`` sums its gradient over pipe, so every stage
        holds the same), the microbatches ``[M, rows / M, S, D]`` through
        the stage ring, then the head and the loss on the ring's output,
        on every stage. The aux sum comes back summed over the stages;
        divided by ``n_layers * M`` it is this data rank's share of the
        reference's mean over ``n_layers * M * dp``."""
        hooks = family.pipeline_hooks(shard)
        mesh, M = self.mesh, self.microbatches
        tp, ep = shard.tp, shard.ep

        def loss(params, batch, attn_fn=None):
            rows, S = batch.shape
            cos, sin = hooks.rope(S, batch.device)
            embed = copy_to(params["embed"], mesh, ("pipe",))
            x = hooks.embed(dict(params, embed=embed), batch)
            x_mb = x.reshape(M, rows // M, S, x.shape[-1])
            stage = hooks.make_stage(attn_fn, cos, sin, tp, ep)
            h, aux = pipeline_apply(stage, params["layers"], x_mb, mesh,
                                    "pipe")
            return hooks.head_loss(params, h.reshape(rows, S, -1), batch,
                                   aux / (hooks.n_layers * M))

        return loss

    def _split_axes(self, i: int, moments: bool = False) -> Tuple[str, ...]:
        """The axes above 1 that split leaf ``i`` (its moments: also the
        update's data axis)."""
        axes = set()
        if self.param_specs[i] is not None:
            axes = {a for a in self.shard.specs[self.leaf_paths[i]]
                    if a and axis_size(self.mesh, a) > 1}
        if moments and self.update_dims[i] is not None:
            axes.add("data")
        return self.mesh.active(tuple(axes))

    def _update_dims(self, like) -> List[Optional[int]]:
        """The reference's ``_update_shardings`` (``trainer.py:332``): a
        leaf the bucket plan scatters is split over the data axis on its
        first dimension that divides evenly and that its (pruned) spec
        leaves whole. When the model itself is sharded (fsdp, tensor, sp),
        only the leading, stacked-layer dimension of a ``layers`` leaf may
        take it (the reference's rule against its partitioner's
        miscompile), and the embedding and head none. The replica axis
        keeps whole shards. None everywhere when the update is replicated
        (``shard_update`` off, no data axis above 1, pipeline mode, or
        nothing divides)."""
        pm = self.mesh
        dsize = axis_size(pm, "data")
        if not self.cfg.shard_update or dsize <= 1 or self.pipe > 1:
            return [None] * len(like)
        model_sharded = bool(pm.active(("fsdp", "tensor", SEQUENCE_AXIS,
                                        "expert")))
        specs = self.specs
        paths = self.leaf_paths
        dims: List[Optional[int]] = []
        for i, (t, scatter) in enumerate(zip(like,
                                             self.grad_bucket_plan.scatter)):
            shape = tuple(t.shape)
            spec = specs[paths[i]] if specs else (None,) * len(shape)
            free = [d for d, a in enumerate(spec) if not a]
            if model_sharded:
                free = free[:1] if paths[i].startswith("layers/") and \
                    0 in free else []
            dims.append(next((d for d in free if shape[d] % dsize == 0),
                             None) if scatter else None)
        return dims

    def _moment_spec(self, i: int, shape) -> Optional[ShardSpec]:
        spec, d = self.param_specs[i], self.update_dims[i]
        if spec is None and d is None:
            return None
        if spec is None:
            spec = ShardSpec(shape, (0,) * len(shape), shape)
        if d is not None:
            k = spec.local_shape[d] // axis_size(self.mesh, "data")
            spec = spec.narrow(d, self.mesh.coords["data"] * k, k)
        split = self._split_axes(i, moments=True)
        return dataclasses.replace(spec, write=all(
            self.mesh.coords[a] == 0
            for a in self.mesh.active(self.mesh.axis_names)
            if a not in split))

    def _sum_axes(self, i: int) -> Tuple[str, ...]:
        skip = {"fsdp"} & set(self._split_axes(i))
        if self.update_dims[i] is not None:
            skip.add("data")
        return tuple(a for a in self.batch_axes if a not in skip)

    def _upd(self, p: torch.Tensor, i: int, r: Optional[int] = None):
        """Data rank ``r``'s (default: this rank's) slice of leaf ``i``'s
        parameter-shaped tensor ``p`` under the sharded update (a view;
        ``p`` itself when the leaf's update is not split)."""
        d = self.update_dims[i]
        if d is None:
            return p
        k = p.shape[d] // axis_size(self.mesh, "data")
        r = self.mesh.coords["data"] if r is None else r
        return p.narrow(d, r * k, k)

    def _apply_long_context_policy(self, cfg: TrainConfig) -> TrainConfig:
        """At seq_len >= long_context_threshold a remat'ing Llama config is
        upgraded to the "flash_rope" policy and a chunked loss (the
        reference's pass; any other family is left as it is); what changed
        rides the fit summary."""
        self.long_context_policy_applied = ""
        if (
            cfg.long_context_policy != "auto"
            or cfg.seq_len < cfg.long_context_threshold
            or not isinstance(cfg.model, llama.LlamaConfig)
        ):
            return cfg
        m = cfg.model
        changes: Dict[str, Any] = {}
        if m.remat and m.remat_policy not in ("flash", "flash_rope"):
            changes["remat_policy"] = "flash_rope"
        if m.loss_chunk == 0:
            changes["loss_chunk"] = 512
        if not changes:
            return cfg
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(m, **changes))
        self.cfg = cfg
        self.long_context_policy_applied = ",".join(
            f"{k}={v}" for k, v in sorted(changes.items())
        )
        return cfg

    def _select_attn(self):
        """Pick the attention path once (the reference's order): context
        attention on a mesh with an ``sp`` axis above 1 (ring or Ulysses,
        ``cfg.context_parallel_impl``); else "auto" is flash on CUDA and
        dense on the CPU, and "flash" forces the kernel route (on the CPU
        its operators run their plain versions). Flash runs each rank's
        rows and heads. On CUDA a head dim with no kernel
        (``fa.KERNEL_HEAD_DIMS``) raises under "auto" and "flash" alike."""
        cfg = self.cfg
        from kubedl_tpu_torch.parallel.ring import make_context_attention

        ctx = make_context_attention(self.mesh,
                                     impl=cfg.context_parallel_impl)
        if ctx is not None:
            self.attn_impl = f"context-{cfg.context_parallel_impl}"
            return ctx
        if cfg.attn_impl == "dense":
            return None
        on_cuda = self.device.type == "cuda"
        if cfg.attn_impl == "flash" or (cfg.attn_impl == "auto" and on_cuda):
            if not fa.supports(cfg.seq_len):
                if cfg.attn_impl == "flash":
                    raise ValueError(
                        f"flash attention cannot tile seq_len={cfg.seq_len}"
                    )
                return None
            hd = getattr(cfg.model, "head_dim", None)
            if on_cuda and hd not in fa.KERNEL_HEAD_DIMS:
                # never dense behind the caller's back: the reference runs
                # its kernel here, so say that this one has none
                raise ValueError(
                    f"attn_impl={cfg.attn_impl!r}: the flash kernels are "
                    f"built for head_dim {fa.KERNEL_HEAD_DIMS}, the model's "
                    f"is {hd}; pass attn_impl='dense'")
            self.attn_impl = "flash"
            return fa.make_flash_attention(self.mesh)
        return None

    # ------------------------------------------------------------------

    def init_fn(self, generator: torch.Generator) -> Dict[str, Any]:
        """The whole train state from an explicit generator (on the
        trainer's device): params, optimizer state, step 0. Every rank
        draws the one-rank init's stream and keeps its shards of the
        params (``state["param_shards"]`` says where they sit, when the
        model is sharded); the moments are its shards of the update
        (``opt_state["shards"]``)."""
        params = self.family.init(generator, self.device)
        opt = self.tx.init([self._upd(p, i) for i, p in
                            enumerate(tree_leaves(params))])
        state = {"params": params, "opt_state": opt, "step": 0}
        if any(self.shard_specs):
            opt["shards"] = list(self.shard_specs)
        if any(self.param_specs):
            state["param_shards"] = list(self.param_specs)
        return state

    def init_state(self) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        return self.init_fn(gen)

    def shard_batch(self, batch) -> torch.Tensor:
        """A host batch (numpy) or tensor, on the trainer's device: this
        rank's part of it. A host batch goes up from pinned memory without
        blocking, so the upload does not wait for the previous step (as
        ``device_put`` does not).

        Every rank reads the same global batch; with more than one
        data-parallel rank each keeps, of every microbatch (the batch as
        ``[n, B / n, S]``, n = ``grad_accum``, times ``microbatches`` in
        pipeline mode), the contiguous block of rows the reference's
        batch sharding gives its device: ``[n * B / (n * dp), S]``,
        microbatch-major. With an ``sp`` axis
        each keeps its block of the sequence, S / sp columns, and the
        next-token column after it (the next block's first token; a 0 on
        the last block, which scores one position fewer)."""
        if self.dp > 1:
            n = self.cfg.grad_accum * self.microbatches
            B, S = batch.shape
            b = B // (n * self.dp)
            i = self.mesh.index(self.dp_axes)
            batch = batch.reshape(n, B // n, S)[:, i * b:(i + 1) * b]
            batch = batch.reshape(n * b, S)
        if self.sp > 1:
            Sl = batch.shape[1] // self.sp
            c = self.mesh.coords[SEQUENCE_AXIS]
            if isinstance(batch, torch.Tensor):
                pad = batch.new_zeros((batch.shape[0], 1))
                batch = torch.cat([batch, pad], dim=1)
            else:
                pad = np.zeros((batch.shape[0], 1), batch.dtype)
                batch = np.concatenate([batch, pad], axis=1)
            batch = batch[:, c * Sl:(c + 1) * Sl + 1]
        batch = batch.contiguous() if isinstance(batch, torch.Tensor) \
            else np.ascontiguousarray(batch)
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device)
        host = torch.from_numpy(np.asarray(batch))
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def value_and_grad(self, params, batch: torch.Tensor):
        """(loss, grads as a list in ``tree_leaves(params)`` order)."""
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = self.family.loss(tree_unflatten(params, leaves), batch,
                                    attn_fn=self.attn_fn)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    def train_step(self, state: Dict[str, Any], batch):
        """One optimizer step on this rank's part of ``batch`` (``[grad_accum
        * b, S]`` rows; with sp its block of the sequence), with
        ``grad_accum`` microbatches and the gradients reduced over the
        ranks that hold other tokens; updates ``state`` in place and
        returns it with ``{"loss", "grad_norm"}`` (device scalars: reading
        them is a host sync):

        - the backward itself reduce-scatters an fsdp-split leaf's
          gradient to its shard (``TrainShard``'s gathers), and sums
          nothing over ``tensor`` (a tensor-replicated leaf's gradient is
          the same on every tensor rank);
        - replicated update: every leaf's gradient all-reduced over the
          rest of its batch axes (``sum_axes``: one collective a bucket
          and axes set), their mean taken, the full update of this rank's
          shard of every leaf;
        - a leaf that every expert rank computes alike is averaged over
          them (``replica_axes``), so that a backward kernel's run-to-run
          summation order cannot set the replicas apart;
        - sharded update: each scattered leaf's gradient reduce-scattered
          over the data axis, the update on this rank's slice of params,
          ``mu`` and ``nu`` (the norm's partial sums summed over the mesh
          first), then the params all-gathered. The other axes are
          all-reduced as above. With ``overlap_comm`` and more than one
          microbatch, each microbatch's reduce-scatters are issued,
          asynchronously and one a bucket in backward-readiness order,
          right after its backward, and land in the shard accumulator
          after the next backward.

        The global norm counts a leaf that several ranks hold alike once.
        The loss and the norm returned are the global ones, equal on
        every rank. On one process every collective is the identity."""
        batch = self.shard_batch(batch)
        cfg, pm = self.cfg, self.mesh
        params = state["params"]
        leaves = tree_leaves(params)
        upd = [d is not None for d in self.update_dims]
        n = cfg.grad_accum
        micro = batch.reshape(n, batch.shape[0] // n, batch.shape[1])
        sharded = bool(self.update_axes)
        loss = None
        if sharded and cfg.overlap_comm and n > 1:
            grads = [torch.zeros_like(self._upd(p, i))
                     for i, p in enumerate(leaves)]
            pending: list = []
            for mb in micro:
                l_i, g_i = self.value_and_grad(params, mb)
                loss = l_i if loss is None else loss + l_i
                issued = self._scatter(g_i)
                for a, g, u in zip(grads, g_i, upd):
                    if not u:  # the replicated ones, reduced after
                        a.add_(g)
                self._absorb(pending, grads)
                pending = issued
            self._absorb(pending, grads)
        else:
            for mb in micro:
                l_i, g_i = self.value_and_grad(params, mb)
                if loss is None:
                    loss, grads = l_i, g_i
                else:
                    loss = loss + l_i
                    grads = [a + b for a, b in zip(grads, g_i)]
            if sharded:
                full = grads
                grads = [torch.zeros_like(self._upd(g, i)) if u else g
                         for i, (g, u) in enumerate(zip(full, upd))]
                self._absorb(self._scatter(full), grads)
                del full
        if sharded:
            self._all_reduce_by_axes(grads, range(len(grads)))
        else:
            for idxs in self.grad_bucket_plan.buckets:
                self._all_reduce_by_axes(grads, idxs)
        self._mean_replicas(grads)
        grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
        if n * self.batch_ranks > 1:
            for g in grads:
                g.div_(n * self.batch_ranks)
        loss = (loss / n).reshape(1)
        pm.all_reduce(loss, self.batch_axes)
        loss = loss[0] / self.batch_ranks
        gnorm = self.apply_update(state, grads)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    @torch.no_grad()
    def apply_update(self, state: Dict[str, Any],
                     grads: List[torch.Tensor]) -> torch.Tensor:
        """The optimizer apply alone, in this trainer's update layout, on
        ``state`` in place: ``grads`` (tree order) are the reduced
        gradients, each leaf's whole or, under the sharded update, this
        rank's slice of it (``_upd``); the update of this rank's slices
        of params and moments (the norm's partial sums summed over the
        mesh first), then, sharded, the params all-gathered. Returns the
        global norm (a device scalar). ``train_step`` ends with it, and
        the step bench times it alone (``training/stepbench.py``)."""
        leaves = tree_leaves(state["params"])
        sharded = bool(self.update_axes)
        local = [self._upd(p, i) for i, p in enumerate(leaves)]
        contig = [t if t.is_contiguous() else t.contiguous() for t in local]
        spread = sharded or self.shard is not None
        gnorm = self.tx.update(grads, state["opt_state"], contig,
                               self._sum_partials if spread else None)
        for t, u in zip(local, contig):
            if u is not t:
                t.copy_(u)
        if sharded:
            self._gather(leaves)
        return gnorm

    def _buckets(self) -> List[List[int]]:
        """The bucket plan's buckets, in issue order, cut to the leaves
        this rank updates a slice of."""
        return [b for b in ([i for i in bucket
                             if self.update_dims[i] is not None]
                            for bucket in self.grad_bucket_plan.buckets) if b]

    def _scatter(self, grads) -> list:
        """Issue each bucket's reduce-scatter over the data axis
        (asynchronous): its leaves' rank blocks laid out rank-major, so
        rank r receives the sum of its slices."""
        dsize, issued = axis_size(self.mesh, "data"), []
        for idxs in self._buckets():
            inp = torch.cat([self._upd(grads[i], i, r).reshape(-1)
                             for r in range(dsize) for i in idxs])
            out = inp.new_empty(inp.numel() // dsize)
            issued.append((self.mesh.reduce_scatter(out, inp, ("data",),
                                                     async_op=True),
                           out, idxs))
        return issued

    @staticmethod
    def _absorb(pending: list, acc: List[torch.Tensor]) -> None:
        """Wait for issued reduce-scatters and add them into the shard
        accumulator."""
        for work, out, idxs in pending:
            work.wait()
            off = 0
            for i in idxs:
                k = acc[i].numel()
                acc[i].add_(out[off:off + k].view(acc[i].shape))
                off += k

    def _all_reduce_by_axes(self, grads: List[torch.Tensor], idxs) -> None:
        """Sum the gradients ``idxs`` in place, each over its
        ``sum_axes``: one flat collective for each set of axes."""
        by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for i in idxs:
            by_axes.setdefault(self.sum_axes[i], []).append(grads[i])
        for axes, tensors in by_axes.items():
            self._all_reduce(tensors, axes)

    def _mean_replicas(self, grads: List[torch.Tensor]) -> None:
        """Average each gradient in place over its ``replica_axes``: one
        flat collective for each set of axes."""
        by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for g, axes in zip(grads, self.replica_axes):
            if axes:
                by_axes.setdefault(axes, []).append(g)
        for axes, tensors in by_axes.items():
            self._all_reduce(tensors, axes)
            for t in tensors:
                t.div_(self.mesh.size(axes))

    def _all_reduce(self, tensors: List[torch.Tensor], axes) -> None:
        """Sum ``tensors`` in place over ``axes`` as one flat collective."""
        if not tensors or self.mesh.size(self.mesh.active(axes)) <= 1:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.mesh.all_reduce(flat, axes)
        off = 0
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()

    def _sum_partials(self, sums: torch.Tensor) -> torch.Tensor:
        """The norm's per-leaf partial sums over the mesh: each leaf's
        distinct slices add up, and a slice that several ranks hold alike
        (a leaf whole on every data rank, a norm on every tensor rank,
        any leaf along sp) counts once, from the first of them."""
        pm = self.mesh
        out = (sums * torch.tensor(self._norm_keep,
                                   device=sums.device)).contiguous()
        pm.all_reduce(out, pm.axis_names)
        return out

    def _gather(self, leaves: List[torch.Tensor]) -> None:
        """All-gather the updated slices into every rank's params, one
        collective a bucket."""
        pm, dsize = self.mesh, axis_size(self.mesh, "data")
        issued = []
        for idxs in self._buckets():
            mine = torch.cat([self._upd(leaves[i], i).reshape(-1)
                              for i in idxs])
            out = mine.new_empty(dsize * mine.numel())
            issued.append((pm.all_gather(out, mine, ("data",),
                                         async_op=True), out, idxs))
        for work, out, idxs in issued:
            work.wait()
            rows = out.view(dsize, -1)
            for r in range(dsize):
                off = 0
                for i in idxs:
                    dst = self._upd(leaves[i], i, r)
                    k = dst.numel()
                    dst.copy_(rows[r, off:off + k].view(dst.shape))
                    off += k

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(
        self,
        data: Iterator,
        state: Optional[Dict[str, Any]] = None,
        steps: Optional[int] = None,
        on_step: Optional[Callable[[int, Dict[str, Any]], None]] = None,
        ckpt_dir: Optional[str] = None,
        ckpt_every: Optional[int] = None,
        ckpt_peer: str = "",
        warm_join_timeout: Optional[float] = None,
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Run the loop; returns (state, summary) with the reference's
        metrics (first-step latency, tokens/s, MFU, ...). ``steps`` is the
        TOTAL budget: a state whose step is already k trains steps-k
        more. ``ckpt_dir`` saves the train state (in the reference's tree,
        ``checkpoint.train_state_tree``) every ``ckpt_every`` steps
        (default ``cfg.ckpt_every``) and once at the end, asynchronously
        when ``cfg.ckpt_async`` (the loop pays only the device-to-host
        snapshot; the last write is joined before fit returns);
        ``ckpt_peer`` mirrors completed saves to a peer blob root."""
        from kubedl_tpu_torch.training.checkpoint import (
            AsyncCheckpointer, save_checkpoint, train_state_tree,
        )

        del warm_join_timeout
        steps = steps or self.cfg.steps
        state = state or self.init_state()
        ckpt_every = self.cfg.ckpt_every if ckpt_every is None else ckpt_every
        pm = self.mesh
        rank, nprocs, barrier = pm.rank, pm.world, pm.barrier
        checkpointer: Optional[AsyncCheckpointer] = None
        if ckpt_dir and self.cfg.ckpt_async:
            checkpointer = AsyncCheckpointer(
                ckpt_dir, peer_url=ckpt_peer, process_index=rank,
                nprocs=nprocs, barrier=barrier)
        last_saved_step: Optional[int] = None

        def save(step: int) -> None:
            if checkpointer is not None:
                checkpointer.save(train_state_tree(state), step)
            else:
                save_checkpoint(ckpt_dir, train_state_tree(state), step,
                                process_index=rank, nprocs=nprocs,
                                barrier=barrier)

        t_sync = time.perf_counter()
        self._sync()
        start = int(state["step"])
        pre_loop_sync_s = time.perf_counter() - t_sync
        tokens_per_step = self.cfg.global_batch * self.cfg.seq_len
        comm_before = dict(pm.seconds)
        log_every = self.cfg.log_every
        loss_log: List[Tuple[int, float]] = []
        steps_run = 0
        last_loss_arr = None
        first_loss = None
        first_step_s = 0.0
        ckpt_overhead = 0.0
        t0 = time.perf_counter()
        t_run = t0
        try:
            for i in range(start, steps):
                state, metrics = self.train_step(state, next(data))
                last_loss_arr = metrics["loss"]
                steps_run += 1
                if i == start:
                    first_loss = _fetch_scalar(metrics["loss"])
                    first_step_s = time.perf_counter() - t0
                    t_run = time.perf_counter()
                elif log_every and (i + 1) % log_every == 0 and i + 1 < steps:
                    loss_log.append((i + 1, _fetch_scalar(metrics["loss"])))
                if on_step is not None:
                    on_step(i, metrics)
                if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
                    t_ck = time.perf_counter()
                    save(i + 1)
                    last_saved_step = i + 1
                    ckpt_overhead += time.perf_counter() - t_ck
            if steps_run:
                last_loss = _fetch_scalar(last_loss_arr)
            else:
                last_loss = first_loss = float("nan")
        except BaseException:
            # killed mid-loop (SystemExit 137 from a cancel, a preemption
            # or an injected fault): let the dispatched steps finish, then
            # make the in-flight save durable, so that the restart resumes
            # from it; a secondary failure must not mask the kill
            try:
                self._sync()
            except Exception:
                pass
            if checkpointer is not None:
                try:
                    checkpointer.wait_for_pending()
                except Exception:
                    pass
            raise
        total = time.perf_counter() - t_run - ckpt_overhead
        steady = steps_run - 1
        tps = tokens_per_step * steady / total if total > 0 and steady > 0 \
            else 0.0
        summary: Dict[str, Any] = {
            "warm_compile_join_s": None,
            "warm_compile_s": None,
            "warm_join_timed_out": None,
            "pre_loop_sync_s": pre_loop_sync_s,
            "first_step_seconds": first_step_s,
            "steps": steps_run,
            "total_steps": steps,
            "start_step": start,
            "first_loss": first_loss,
            "final_loss": last_loss,
            "tokens_per_sec": tps,
            "tokens_per_sec_per_chip": tps / nprocs,
            "step_time_ms": total / steady * 1e3 if steady > 0 else 0.0,
            "mfu": self._mfu(tps, nprocs),
            "hbm_floor_ms": self.hbm_floor_ms(),
            "attn_impl": self.attn_impl,
            "model_family": self.family.name,
            "n_params": self.family.num_params,
            "shard_update": bool(self.update_axes),
            "overlap_comm": bool(self.update_axes) and self.cfg.overlap_comm,
            "long_context_policy": self.long_context_policy_applied,
            "grad_buckets": self.grad_bucket_plan.n_buckets,
            "opt_state_bytes_per_device": state_bytes_per_device(state),
            "world": nprocs,
            "mesh": dict(pm.shape),
            "dist_backend": pm.backend or None,
            # host ms a step in each collective, staging included (gloo);
            # None where not timed (one process, or NCCL)
            "collective_ms": {
                k: (v - comm_before.get(k, 0.0)) / steps_run * 1e3
                for k, v in pm.seconds.items()
            } if pm.backend == "gloo" and steps_run
            else None,
            "log_every": log_every,
            "loss_log": loss_log,
            "device": str(self.device),
            "device_kind": self._device_kind(),
            "flash_trace_count": None,
            "flash_launches": dict(fa.LAUNCHES),
            "adamw_launches": dict(adamw_launches),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(self.device)
            if self.device.type == "cuda" else None,
        }
        summary["sanity_violations"] = self.sanity_check(summary)
        if ckpt_dir and steps_run:
            # labelled with the state's real step, not the budget; skipped
            # when the last interval save already wrote that step
            final_step = int(state["step"])
            if last_saved_step != final_step:
                save(final_step)
        if checkpointer is not None:
            # the clean-exit barrier: the caller may publish or exit now
            checkpointer.wait_for_pending()
            summary["ckpt_stall_s"] = checkpointer.stall_seconds
            summary["ckpt_saves"] = checkpointer.saves
        summary["ckpt_async"] = checkpointer is not None
        return state, summary

    # ---- parameter-service mode ---------------------------------------

    def _host_params(self, params, slot: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
        """The params as the wire-format dict the tier shards by:
        ``keystr(path) -> float32 host array`` (the reference's names and
        order). With ``slot`` (0 or 1) on CUDA the arrays are views of
        that set of pinned buffers, filled by asynchronous copies and one
        synchronisation; they hold until the same slot is filled again.
        Otherwise (or on the CPU) each array is a copy of its own."""
        from kubedl_tpu_torch.training.checkpoint import _leaf_items

        if any(self.param_specs):
            raise ValueError(
                "fit_ps pushes each worker's whole model: the params are "
                "sharded across processes on this mesh")
        items = list(_leaf_items(params))
        if slot is None or self.device.type != "cuda":
            return {name: leaf.detach().to("cpu", torch.float32,
                                           copy=True).numpy()
                    for name, leaf in items}
        pinned = self._pinned.setdefault(slot, {})
        for name, leaf in items:
            buf = pinned.get(name)
            if buf is None or buf.shape != leaf.shape:
                buf = pinned[name] = torch.empty(
                    leaf.shape, dtype=torch.float32, pin_memory=True)
            buf.copy_(leaf.detach().float(), non_blocking=True)
        torch.cuda.synchronize(self.device)
        return {name: pinned[name].numpy() for name, _ in items}

    @staticmethod
    def _load_params(params, host: Dict[str, np.ndarray]):
        """Overwrite the params' leaves from a tier snapshot (by keystr
        name), in place, rounded to each leaf's dtype; leaves the snapshot
        does not cover keep their local values. Returns ``params``."""
        from kubedl_tpu_torch.training.checkpoint import _leaf_items

        for name, leaf in _leaf_items(params):
            arr = host.get(name)
            if arr is not None:
                src = torch.from_numpy(np.asarray(arr, dtype=np.float32))
                leaf.copy_(src.reshape(leaf.shape))
        return params

    @staticmethod
    def _deltas(current: Dict[str, np.ndarray],
                anchor: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """``current - anchor`` a leaf (``current`` where the anchor has no
        such leaf), each a new float32 array: IEEE subtraction on the
        host's threads, the bits of the reference's numpy expression."""
        out = {}
        for k, cur in current.items():
            anc = anchor.get(k)
            if anc is None:
                out[k] = cur - np.zeros_like(cur)
            else:
                out[k] = torch.sub(torch.from_numpy(cur),
                                   torch.from_numpy(anc)).numpy()
        return out

    def fit_ps(
        self,
        data: Iterator,
        ps,
        worker_id: str,
        state: Optional[Dict[str, Any]] = None,
        steps: Optional[int] = None,
        on_step: Optional[Callable[[int, Dict[str, Any]], None]] = None,
        push_every: int = 1,
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """The ``train_mode: "ps"`` loop (the reference's
        ``Trainer.fit_ps``): train locally, and every ``push_every`` steps
        (and at the last) push the parameter delta since the last anchor
        to ``ps``, a :class:`~kubedl_tpu_torch.ps.service.ParameterService`
        or the HTTP :class:`~kubedl_tpu_torch.ps.server.PSClient` (the
        same duck type; either package's tier).

        Failure handling is the protocol:

        - ``PushRejected`` (past the staleness bound): the local delta is
          dropped, the worker re-pulls the aggregate and resumes from it;
        - ``PSUnavailable`` / an injected ``ps.push`` or ``ps.pull``
          fault: transient, the anchor is kept, so the delta keeps
          accumulating and rides the next push;
        - ``MemberEvicted``: the worker re-registers and warm-starts from
          the tier's snapshot (the late joiner's path).

        Registration itself warm-starts: the local params are overwritten
        from the snapshot. The optimizer state is left as it is."""
        from kubedl_tpu_torch.chaos import FaultInjected
        from kubedl_tpu_torch.ps.server import PSUnavailable
        from kubedl_tpu_torch.ps.service import MemberEvicted, PushRejected

        steps = steps or self.cfg.steps
        state = state or self.init_state()
        push_every = max(1, int(push_every))
        start = int(state["step"])
        tokens_per_step = self.cfg.global_batch * self.cfg.seq_len
        slot = 0  # the pinned set the anchor's arrays are views of

        def anchor_now():
            nonlocal slot
            slot ^= 1
            return self._host_params(state["params"], slot)

        snapshot, versions = ps.register(worker_id)
        if snapshot:
            self._load_params(state["params"], snapshot)
        anchor = anchor_now()

        pushes = decayed = rejected = dropped = repulls = rejoins = 0
        steps_run = 0
        last_loss_arr = None
        first_loss = None
        first_step_s = 0.0
        t0 = time.perf_counter()
        t_run = t0
        for i in range(start, steps):
            state, metrics = self.train_step(state, next(data))
            last_loss_arr = metrics["loss"]
            steps_run += 1
            if i == start:
                first_loss = _fetch_scalar(metrics["loss"])
                first_step_s = time.perf_counter() - t0
                t_run = time.perf_counter()
            if on_step is not None:
                on_step(i, metrics)
            if (i + 1 - start) % push_every != 0 and i + 1 != steps:
                continue
            current = self._host_params(state["params"], slot ^ 1)
            deltas = self._deltas(current, anchor)
            try:
                res = ps.push(worker_id, i + 1, deltas, versions=versions)
                pushes += 1
                if res.outcome == "decayed":
                    decayed += 1
                versions = list(res.versions)
                # the push moved the head; re-anchor on the local params
                # so the next delta is disjoint from this one
                anchor, slot = current, slot ^ 1
            except PushRejected as e:
                # past the bound: drop the delta, adopt the aggregate
                rejected += 1
                repulls += 1
                try:
                    pulled, versions = ps.pull(worker_id)
                    self._load_params(state["params"], pulled)
                    anchor = anchor_now()
                except (PSUnavailable, FaultInjected):
                    versions = list(e.versions) or versions
            except MemberEvicted:
                rejoins += 1
                snapshot, versions = ps.register(worker_id)
                if snapshot:
                    self._load_params(state["params"], snapshot)
                anchor = anchor_now()
            except (PSUnavailable, FaultInjected):
                # transient drop: keep the anchor, the delta keeps
                # accumulating and rides the next push
                dropped += 1
        if steps_run:
            last_loss = _fetch_scalar(last_loss_arr)
        else:
            last_loss = first_loss = float("nan")
        total = time.perf_counter() - t_run
        steady_steps = steps_run - 1
        tps = (tokens_per_step * steady_steps / total
               if total > 0 and steady_steps > 0 else 0.0)
        summary = {
            "train_mode": "ps",
            "first_step_seconds": first_step_s,
            "steps": steps_run,
            "total_steps": steps,
            "start_step": start,
            "first_loss": first_loss,
            "final_loss": last_loss,
            "tokens_per_sec": tps,
            "tokens_per_sec_per_chip": tps / self.mesh.world,
            "step_time_ms": (total / steady_steps * 1e3
                             if steady_steps > 0 else 0.0),
            "model_family": self.family.name,
            "n_params": self.family.num_params,
            "ps_pushes": pushes,
            "ps_decayed": decayed,
            "ps_rejected": rejected,
            "ps_dropped": dropped,
            "ps_repulls": repulls,
            "ps_rejoins": rejoins,
            "ps_versions": list(versions),
        }
        return state, summary

    # ------------------------------------------------------------------

    def _device_kind(self) -> str:
        if self.device.type != "cuda":
            return "cpu"
        return torch.cuda.get_device_name(self.device)

    def _mfu(self, tokens_per_sec: float, n_chips: int) -> float:
        """Model FLOPs utilization against the device's peak (0.0 where
        the peak is unknown, e.g. on the CPU)."""
        from kubedl_tpu_torch.api.topology import peak_flops_for_device_kind

        peak = peak_flops_for_device_kind(self._device_kind())
        if peak <= 0 or tokens_per_sec <= 0:
            return 0.0
        return self.family.flops_per_token * tokens_per_sec / (peak * n_chips)

    def hbm_floor_ms(self) -> float:
        """Lower bound on step time: one read and one write of the bf16
        params at the device's memory rate."""
        from kubedl_tpu_torch.api.topology import hbm_bandwidth_for_device_kind

        bw = hbm_bandwidth_for_device_kind(self._device_kind())
        if bw <= 0:
            return 0.0
        return 2.0 * self.family.num_params * 2 / bw * 1e3

    def sanity_check(self, summary: Dict[str, Any]) -> List[str]:
        """Hard plausibility gates; returns violations (empty = sane)."""
        v: List[str] = []
        mfu = summary.get("mfu", 0.0)
        if mfu > 1.0:
            v.append(f"mfu {mfu:.3f} > 1.0 is physically impossible")
        floor = self.hbm_floor_ms()
        st = summary.get("step_time_ms", 0.0)
        if floor > 0 and 0 < st < floor:
            v.append(
                f"step_time {st:.3f}ms below HBM param-read floor {floor:.3f}ms"
            )
        steps = summary.get("steps", 0)
        fl, ll = summary.get("first_loss"), summary.get("final_loss")
        if steps >= 8 and fl is not None and ll is not None and not ll < fl:
            v.append(f"loss did not decrease over {steps} steps ({fl} -> {ll})")
        return v


__all__ = [
    "ModelFamily", "llama_family", "moe_family", "family_for", "TrainConfig",
    "AdamW", "make_optimizer", "warmup_cosine_decay_schedule", "Trainer",
    "tree_leaves", "tree_unflatten", "state_bytes_per_device",
]
