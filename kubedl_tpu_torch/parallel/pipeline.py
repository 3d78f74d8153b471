"""Pipeline parallelism: GPipe microbatched stages over the ``pipe`` axis —
the port of ``kubedl_tpu/parallel/pipeline.py``.

The layer stack is split into ``n`` stages along the ``pipe`` axis of a
:class:`~kubedl_tpu_torch.parallel.mesh.ProcessMesh`; each rank holds one
stage's slice of the stacked layer leaves and runs it, and activations go
stage to stage by :func:`~kubedl_tpu_torch.parallel.mesh.shift` (a paired
send / receive over the ``pipe`` group, differentiable). The schedule is
the reference's GPipe fill/drain: with M microbatches the loop runs
``M + n - 1`` ticks and every rank runs its stage and the shift on every
tick, the fill and drain ticks included (their work is discarded, as the
reference's ``jnp.where`` discards it).

The backward is autograd's: each tick's shift has the inverse shift as its
backward, so the backward is itself a pipeline over the reversed ring. It
holds together only if every rank runs the backward of every tick's
shift, in the same order: a rank whose graph leaves one out hangs its
neighbours. So stage 0 takes its input through ``torch.where`` (the
received activation stays in its graph, with a zero gradient), and a
stage's last output, which no shift carries, is tied into the outputs
with a zero weight (:func:`_zero_tie`), which every stage's head reads,
so each tick's work is in every rank's graph. On every rank the backward then
runs the ticks' shifts last to first, each after the stage backward that
feeds it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from kubedl_tpu_torch.parallel.mesh import reduce_from, shift


@dataclass(frozen=True)
class PipelineHooks:
    """What a model family provides to run through the GPipe pipeline
    (``llama.pipeline_hooks`` / ``moe.pipeline_hooks``), as the
    reference's dataclass of the same name."""

    #: embed(params, tokens [B, S]) -> activations [B, S, D]
    embed: Callable
    #: rope(S, device) -> (cos, sin) position tables
    rope: Callable
    #: make_stage(attn_fn, cos, sin, tp=None, ep=None) ->
    #:   stage_fn(layer_params_slice, x) -> (y, aux float32 scalar);
    #:   ``tp`` / ``ep``: ``(mesh, axes)`` of the tensor / expert split
    make_stage: Callable
    #: head_loss(params, h [B, S, D], tokens, aux_mean) -> scalar loss
    head_loss: Callable
    n_layers: int


def _zero_tie(t: torch.Tensor) -> torch.Tensor:
    """A float32 zero whose backward sends ``t`` an exact zero gradient:
    it keeps ``t``'s graph (and the collectives in its backward) alive
    without moving the loss, whatever ``t`` holds."""
    off = torch.zeros((), dtype=torch.bool, device=t.device)
    return torch.where(off, t.float().sum(), 0.0)


def pipeline_apply(stage_fn: Callable, stage_params, x_mb: torch.Tensor,
                   mesh, axis: str = "pipe"):
    """Run microbatches through the stage ring.

    ``x_mb`` [M, mb, ...]: this rank's rows of every microbatch, the same
    on every rank of the ``axis`` group (stage 0 reads it).
    ``stage_fn(stage_params, x) -> (y, aux)`` applies this rank's stage;
    ``aux`` (a float32 scalar, e.g. the MoE load-balancing loss) is summed
    over the valid ticks only. Returns ``(out, aux_sum)``: the last
    stage's outputs [M, mb, ...] and the aux sum over every stage, both
    the same on every rank of the group (the reference's masked ``psum``:
    an all-reduce whose backward passes the gradient through, so the last
    stage takes its outputs' gradient once)."""
    n, idx = mesh.shape[axis], mesh.coords[axis]
    M = x_mb.shape[0]
    first = torch.tensor(idx == 0, device=x_mb.device)
    state = torch.zeros_like(x_mb[0])
    outs = []
    aux = torch.zeros((), dtype=torch.float32, device=x_mb.device)
    last_tick = M + n - 2
    tie = None
    for t in range(last_tick + 1):
        # stage 0 takes microbatch t (clamped in the drain); the others
        # the activation the previous stage handed over last tick
        x = torch.where(first, x_mb[min(t, M - 1)], state)
        y, a = stage_fn(stage_params, x)
        if idx <= t < idx + M:  # a real microbatch, not a fill/drain tick
            aux = aux + a
        if idx == n - 1 and t >= n - 1:  # microbatch t - (n - 1) is done
            outs.append(y)
        if t < last_tick:
            state = shift(y, mesh, axis, 1)
        elif idx != n - 1:
            tie = _zero_tie(y)
    out = torch.stack(outs) if outs else torch.zeros_like(x_mb)
    if tie is not None:
        out = out + tie.to(out.dtype)
    aux = reduce_from(aux.reshape(1), mesh, (axis,))[0]
    return reduce_from(out, mesh, (axis,)), aux


__all__ = ["PipelineHooks", "pipeline_apply"]
