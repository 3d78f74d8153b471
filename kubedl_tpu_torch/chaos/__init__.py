"""Deterministic chaos layer: seeded fault injection + unified retry
policy. The port's copy of ``kubedl_tpu/chaos`` with the same exports.

See :mod:`kubedl_tpu_torch.chaos.plan` for injection sites and schedules,
and :mod:`kubedl_tpu_torch.chaos.retry` for the shared backoff/budget
policy. ``docs/robustness.md`` documents the contract.
"""

from kubedl_tpu_torch.chaos.plan import (
    FaultInjected,
    FaultPlan,
    FaultSpec,
    TraceEntry,
    active,
    arm,
    check,
    disarm,
    plan_from_config,
    should_fail,
    sites,
)
from kubedl_tpu_torch.chaos.retry import RetryBudgetExhausted, RetryPolicy

__all__ = [
    "FaultInjected",
    "FaultPlan",
    "FaultSpec",
    "TraceEntry",
    "RetryBudgetExhausted",
    "RetryPolicy",
    "active",
    "arm",
    "check",
    "disarm",
    "plan_from_config",
    "should_fail",
    "sites",
]
