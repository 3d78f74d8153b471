"""Resize math: the port's own copy of ``grad_accum_for_world`` and
``data_parallel_world`` (``kubedl_tpu/elastic/resize.py:33-73``).

The trainer's ``global_batch`` is the per-optimizer-step batch whatever
the world size, and ``grad_accum`` only splits it into sequential
microbatches, so the loss trajectory does not depend on the world size;
what a shrink changes is the memory each device needs: half the
processes means each holds twice the step's tokens.
:func:`grad_accum_for_world` rescales accumulation inversely with the
world size, so the per-device microbatch stays at its tuned size while
the global batch, and the trajectory, are unchanged. (Goodput belongs to
the control plane.)
"""

from __future__ import annotations


def grad_accum_for_world(
    base_grad_accum: int, base_world: int, world: int, global_batch: int
) -> int:
    """Gradient-accumulation factor for ``world`` processes such that the
    per-device microbatch matches the one tuned at ``base_world`` with
    ``base_grad_accum``, while the effective global batch is unchanged.

    Target is ``base_grad_accum * base_world / world`` (shrink => more
    accumulation, grow => less), rounded to the nearest feasible value:
    ``grad_accum`` must divide ``global_batch``, so we walk down from the
    target to the largest divisor (never below 1, never above
    ``global_batch``).
    """
    base_grad_accum = max(int(base_grad_accum), 1)
    base_world = max(int(base_world), 1)
    world = max(int(world), 1)
    global_batch = max(int(global_batch), 1)
    target = max((base_grad_accum * base_world) // world, 1)
    target = min(target, global_batch)
    while target > 1 and global_batch % target != 0:
        target -= 1
    return target


def data_parallel_world(mesh) -> int:
    """Number of gradient replicas a mesh implies: the product of the
    batch-sharding axes (replica x data x fsdp; fsdp shards parameters
    but each rank still consumes its own batch shard). ``mesh`` is a
    :class:`~kubedl_tpu_torch.api.topology.MeshSpec`.

    This is the world size batch semantics care about: when a planner
    owns the mesh, a resize can move devices between data and model axes,
    so the entry rescales by this, not by the raw process count, whenever
    the operator stamped a base data-parallel degree.
    """
    n = 1
    for axis in ("replica", "data", "fsdp"):
        n *= max(int(mesh.axes.get(axis, 1)), 1)
    return n


__all__ = ["grad_accum_for_world", "data_parallel_world"]
