"""Sharded parameter-service aggregation (docs/elasticity.md
"Parameter-service mode"): the port's copy of ``kubedl_tpu/ps``, with the
reference's exports. It stands on the port's copies of the object store,
its WAL and leases (``kubedl_tpu_torch/core``), chaos sites and metrics.

The robustness alternative to gang restarts (arXiv 2204.03211 "Elastic
Model Aggregation with Parameter Service"): model parameters are
hash-partitioned across N PS shards; workers train locally and push
parameter deltas / pull fresh shards asynchronously under a bounded-
staleness window, so a preemption storm degrades goodput by exactly the
departed workers' share instead of serializing the whole fleet behind
checkpoint/restore cycles.

- :mod:`kubedl_tpu_torch.ps.shards` — hash partitioning + per-shard state with
  WAL durability (core/wal.py framing) and lease-fenced ownership
  (core/leases.py ``transitions`` token).
- :mod:`kubedl_tpu_torch.ps.service` — the aggregation tier: membership,
  push/pull, bounded staleness with decay weighting, atomic
  commit-or-discard of a departing worker's in-flight contribution,
  shard failover.
- :mod:`kubedl_tpu_torch.ps.server` — HTTP front + thin client for real
  multi-process workers (``KUBEDL_PS_ADDR``).
"""

from kubedl_tpu_torch.ps.service import (
    MemberEvicted,
    PSConfig,
    ParameterService,
    PushRejected,
    PushResult,
    ShardUnavailable,
)
from kubedl_tpu_torch.ps.shards import shard_for

__all__ = [
    "MemberEvicted",
    "PSConfig",
    "ParameterService",
    "PushRejected",
    "PushResult",
    "ShardUnavailable",
    "shard_for",
]
