"""Gradient bucketing plan for the overlapped data-parallel step: the
port's own copy of ``kubedl_tpu/training/buckets.py`` (jax-free there
too), the same plan for the same leaf sizes.

The port's trainer (``training/trainer.py``, ``TrainConfig.overlap_comm``)
reads both halves of the plan. With the sharded update and more than one
microbatch, each microbatch's gradients are reduce-scattered as soon as
its backward has produced them, one asynchronous collective a bucket in
issue order, while the next microbatch's backward runs, and the result
accumulates into a dp-times-smaller accumulator:

- Leaves below :data:`MIN_SCATTER_BYTES` accumulate replicated inside the
  loop and are reduced once after it: a per-microbatch collective on a
  few-KB norm vector costs more in launch latency than its bytes save.
  They also keep the replicated update (every rank updates all of them).
- Larger leaves are greedy-packed into issue-order buckets of roughly
  ``bucket_bytes`` each, in backward-readiness order (reverse forward
  order: the last layer's grads are ready first).

Everything here is host-side planning over leaf byte sizes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

#: Leaves smaller than this accumulate replicated inside the microbatch
#: loop and join one trailing scatter after it (see module docstring).
MIN_SCATTER_BYTES = 4 * 1024

#: Default bucket size (``TrainConfig.grad_bucket_mb`` overrides): the
#: DDP-literature sweet spot — big enough to amortize collective launch
#: overhead, small enough that the first bucket is ready early in backward.
DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024


@dataclass(frozen=True)
class GradBucketPlan:
    """Host-side partition of gradient leaves into collective buckets."""

    #: leaf indices grouped into buckets, in collective issue order
    #: (backward readiness: reverse of the forward/tree order)
    buckets: Tuple[Tuple[int, ...], ...]
    #: per-leaf (tree order): scatter inside the microbatch loop?
    scatter: Tuple[bool, ...]
    total_bytes: int
    #: bytes covered by in-loop scatters (the overlappable volume)
    scattered_bytes: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def scattered_fraction(self) -> float:
        return self.scattered_bytes / self.total_bytes if self.total_bytes else 0.0


def plan_grad_buckets(
    leaf_bytes: Sequence[int],
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
    min_scatter_bytes: int = MIN_SCATTER_BYTES,
) -> GradBucketPlan:
    """Partition gradient leaves (by byte size, tree order) into buckets.

    Greedy first-fit in reverse tree order; a leaf larger than
    ``bucket_bytes`` gets its own bucket. Every leaf lands in exactly one
    bucket; only leaves >= ``min_scatter_bytes`` are flagged for in-loop
    scattering.
    """
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be > 0, got {bucket_bytes}")
    buckets: List[Tuple[int, ...]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i in reversed(range(len(leaf_bytes))):
        nb = int(leaf_bytes[i])
        if cur and cur_bytes + nb > bucket_bytes:
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        buckets.append(tuple(cur))
    scatter = tuple(int(nb) >= min_scatter_bytes for nb in leaf_bytes)
    total = sum(int(nb) for nb in leaf_bytes)
    scattered = sum(int(nb) for nb, s in zip(leaf_bytes, scatter) if s)
    return GradBucketPlan(
        buckets=tuple(buckets),
        scatter=scatter,
        total_bytes=total,
        scattered_bytes=scattered,
    )


__all__ = ["GradBucketPlan", "plan_grad_buckets", "MIN_SCATTER_BYTES",
           "DEFAULT_BUCKET_BYTES"]
