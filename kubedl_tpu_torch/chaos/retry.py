"""Shared retry policy: exponential backoff + full jitter + retry budget.
The port's copy of ``kubedl_tpu/chaos/retry.py`` (standard library only).

Every retry loop shares this one policy, so backoff shape, jitter and the
total-sleep budget are a single contract. The budget is the important
part under heavy traffic: a storm of failing calls must not multiply into
unbounded sleeping threads — once a policy instance has spent its budget,
further failures surface immediately.

Full jitter: ``sleep = uniform(0, min(cap, base * 2**attempt))``. Jitter
decorrelates clients that fail in lockstep.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")


class RetryBudgetExhausted(Exception):
    """The policy's total-sleep budget ran out; the last error is chained."""


class RetryPolicy:
    def __init__(
        self,
        max_attempts: int = 5,
        base_delay: float = 0.02,
        max_delay: float = 1.0,
        budget_s: Optional[float] = None,
        rng: Optional[Callable[[float, float], float]] = None,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        if rng is None:
            import random
            rng = random.Random(0xC4A05).uniform
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self._rng = rng
        self._sleep = sleep
        self._lock = threading.Lock()
        self._budget = budget_s  # None = unlimited
        self.retries = 0         # total retries performed (observability)

    def backoff(self, attempt: int) -> float:
        """Full-jitter delay for a 0-based attempt number."""
        cap = min(self.max_delay, self.base_delay * (2 ** attempt))
        return self._rng(0.0, cap)

    def _spend(self, delay: float) -> float:
        """Debit the budget; returns the (possibly clipped) sleepable delay.

        Raises RetryBudgetExhausted when nothing is left."""
        with self._lock:
            self.retries += 1
            if self._budget is None:
                return delay
            if self._budget <= 0.0:
                raise RetryBudgetExhausted(
                    f"retry budget exhausted (spent across {self.retries} retries)"
                )
            delay = min(delay, self._budget)
            self._budget -= delay
            return delay

    def budget_remaining(self) -> Optional[float]:
        with self._lock:
            return self._budget

    def call(
        self,
        fn: Callable[[], T],
        retry_on: Tuple[Type[BaseException], ...] = (Exception,),
        giveup: Optional[Callable[[BaseException], bool]] = None,
    ) -> T:
        """Run ``fn`` with up to ``max_attempts`` tries.

        ``retry_on`` limits which exceptions are retried; ``giveup`` lets a
        caller refuse to retry specific instances (e.g. a 4xx ApiException
        is permanent, a 5xx is transient)."""
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except retry_on as e:
                if giveup is not None and giveup(e):
                    raise
                last = e
                if attempt == self.max_attempts - 1:
                    break
                try:
                    delay = self._spend(self.backoff(attempt))
                except RetryBudgetExhausted as exhausted:
                    raise exhausted from e
                if delay > 0:
                    self._sleep(delay)
        assert last is not None
        raise last
