"""The parameter-service aggregation tier: the port's copy of
``kubedl_tpu/ps/service.py``, float32 numpy in the reference's order
(its snapshots, versions and stats are the reference's bit for bit).

Workers train locally and push parameter deltas; the service aggregates
them into the sharded global model under a bounded-staleness window
(arXiv 2204.03211):

- **staleness** of a push = shard head version − the worker's last-pulled
  version for that shard. Staleness 0 applies at full weight; in-bound
  staleness is decay-weighted (``decay ** staleness``) so late
  contributions still help without dragging the head backward; beyond
  ``max_staleness`` the push is REJECTED — the worker re-pulls and
  continues (its stale delta is discarded, never half-applied).
- **membership is event-driven**, not restart-driven: a preemption notice
  commits the departing worker's staged in-flight contribution atomically
  per shard; the watchdog's silent-death classification discards it and
  evicts the member without touching survivors; a late joiner warm-starts
  from the PS snapshot mid-epoch (``register`` returns it).
- **shard failover** reuses lease fencing: a new owner acquires the
  ``ps-shard-<i>`` lease (``transitions`` bump = new fencing token),
  replays the shard WAL, and deposed-owner writes are refused.

Chaos sites: ``ps.push`` / ``ps.pull`` drop the respective op (workers
retry), ``ps.shard_failover`` kills a live shard's owner mid-run — with
``auto_recover`` the next op fails it over and survivors proceed.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from kubedl_tpu_torch import chaos
from kubedl_tpu_torch.core.store import ObjectStore
from kubedl_tpu_torch.observability.metrics import DEFAULT_PS_METRICS
from kubedl_tpu_torch.observability.tracing import TRACER
from kubedl_tpu_torch.ps.shards import ShardDead, ShardState, shard_for


class PushRejected(Exception):
    """Push beyond the staleness bound: the worker must re-pull. Carries
    the current shard versions so the retry can skip one round trip."""

    def __init__(self, msg: str, versions: Optional[List[int]] = None) -> None:
        super().__init__(msg)
        self.versions = versions or []


class MemberEvicted(Exception):
    """The worker was evicted from the aggregation group (preemption /
    silent death); it must re-register (and warm-start) to continue."""


class ShardUnavailable(Exception):
    """A shard's owner is down and auto-recovery is off; retry after
    ``recover_shard``."""


@dataclass
class PSConfig:
    num_shards: int = 2
    #: bounded staleness window, in aggregate steps per shard
    max_staleness: int = 4
    #: weight = decay ** staleness for in-bound stale pushes
    decay: float = 0.5
    #: flagged stragglers get one extra decay factor on every push —
    #: auditable via the watchdog's StragglerDetected event + gauge
    straggler_decay: float = 0.5
    #: WAL root for shard durability; "" = memory-only (tests)
    wal_root: str = ""
    fsync: str = "always"
    lease_ttl: float = 5.0
    #: fail a dead shard over inline on the next op that needs it
    auto_recover: bool = True
    #: metric/span label
    job: str = "ps"


@dataclass
class PushResult:
    outcome: str                 # "fresh" | "decayed"
    weight: float
    staleness: int
    versions: List[int] = field(default_factory=list)


@dataclass
class _Member:
    worker: str
    pulled: List[int] = field(default_factory=list)
    pushes: int = 0
    straggler: bool = False
    #: staged-but-uncommitted contribution: shard -> (weight, delta)
    inflight: Dict[int, Tuple[float, Dict[str, np.ndarray]]] = field(
        default_factory=dict
    )


class ParameterService:
    """In-process parameter service; :mod:`kubedl_tpu_torch.ps.server` puts an
    HTTP front on this exact object for real multi-process workers."""

    def __init__(
        self,
        initial_params: Dict[str, np.ndarray],
        cfg: Optional[PSConfig] = None,
        store: Optional[ObjectStore] = None,
        metrics=None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.cfg = cfg or PSConfig()
        self.store = store or ObjectStore()
        self.metrics = metrics or DEFAULT_PS_METRICS
        self.clock = clock
        self._lock = threading.RLock()
        self._members: Dict[str, _Member] = {}
        self._evicted: Dict[str, str] = {}  # worker -> reason
        self._gen = 0  # owner-identity generation per failover
        self.shards: List[ShardState] = []
        for i in range(max(self.cfg.num_shards, 1)):
            sh = ShardState(
                i, self.store, wal_dir=self.cfg.wal_root,
                fsync=self.cfg.fsync, lease_ttl=self.cfg.lease_ttl,
                clock=clock,
            )
            sh.open(self._identity(i, 0))
            sh.init_params({
                k: v for k, v in initial_params.items()
                if shard_for(k, self.cfg.num_shards) == i
            })
            self.shards.append(sh)

    def _identity(self, shard_id: int, gen: int) -> str:
        return f"{self.cfg.job}-shard-{shard_id}-gen{gen}"

    # ---- membership ------------------------------------------------------

    def register(self, worker: str) -> Tuple[Dict[str, np.ndarray], List[int]]:
        """Join (or re-join) the aggregation group. Returns the warm-start
        snapshot + versions — a late joiner resumes mid-epoch from the
        aggregated state, not from step 0."""
        with self._lock:
            self._evicted.pop(worker, None)
            self._members[worker] = _Member(worker)
            self.metrics.ps_members.set(float(len(self._members)))
        return self.pull(worker)

    def deregister(self, worker: str, commit_in_flight: bool = True,
                   reason: str = "departed") -> None:
        """Remove a member. A preemption notice commits its staged
        in-flight contribution atomically per shard (the work was real);
        ``commit_in_flight=False`` (silent death) discards it — a dead
        worker's half-pushed delta must not smear into the model."""
        with self._lock:
            m = self._members.pop(worker, None)
            self._evicted[worker] = reason
            if m is not None and m.inflight:
                if commit_in_flight:
                    self._commit_staged(m)
                else:
                    m.inflight.clear()
            self.metrics.ps_members.set(float(len(self._members)))
            self.metrics.ps_evictions.inc(reason=reason)

    def handle_preemption_notice(self, worker: str) -> None:
        """The preemption-notice path: the departing worker's in-flight
        contribution is committed, then the member leaves."""
        self.deregister(worker, commit_in_flight=True, reason="preemption")

    def evict_silent_death(self, worker: str) -> None:
        """The watchdog path: a silently-dead contributor is evicted and
        its in-flight contribution discarded; survivors are untouched."""
        self.deregister(worker, commit_in_flight=False, reason="silent_death")

    def bind_watchdog(self, watchdog, worker_for_pod: Callable[[str], str]) -> None:
        """Subscribe to watchdog firings: silent death / hang on a pod
        evicts the mapped worker from the aggregation group."""

        def on_fire(pod_name: str, reason: str) -> None:
            worker = worker_for_pod(pod_name)
            if worker:
                self.evict_silent_death(worker)

        watchdog.listeners.append(on_fire)

    def mark_straggler(self, worker: str, slow: bool) -> None:
        """Mirror the watchdog's straggler classification: a flagged
        member's pushes take one extra decay factor (the decision is
        auditable via the StragglerDetected job event + gauge)."""
        with self._lock:
            m = self._members.get(worker)
            if m is not None:
                m.straggler = slow

    def members(self) -> List[str]:
        with self._lock:
            return sorted(self._members)

    # ---- pull ------------------------------------------------------------

    def pull(self, worker: str) -> Tuple[Dict[str, np.ndarray], List[int]]:
        chaos.check("ps.pull")
        with self._lock:
            self._maybe_chaos_failover()
            m = self._members.get(worker)
            if m is None:
                raise MemberEvicted(
                    f"{worker}: {self._evicted.get(worker, 'not registered')}"
                )
            with TRACER.span("ps.pull", job=self.cfg.job, worker=worker):
                params: Dict[str, np.ndarray] = {}
                versions: List[int] = []
                for sh in self.shards:
                    self._ensure_alive(sh)
                    v, p = sh.snapshot()
                    versions.append(v)
                    params.update(p)
            m.pulled = list(versions)
            self.metrics.ps_pulls.inc()
            return params, versions

    # ---- push ------------------------------------------------------------

    def push(
        self,
        worker: str,
        step: int,
        deltas: Dict[str, np.ndarray],
        versions: Optional[List[int]] = None,
    ) -> PushResult:
        """Stage + commit one delta push. Raises :class:`PushRejected`
        past the staleness bound (nothing applied), :class:`MemberEvicted`
        for departed workers, :class:`chaos.FaultInjected` on an armed
        ``ps.push`` drop (the worker retries)."""
        chaos.check("ps.push")
        with self._lock:
            self._maybe_chaos_failover()
            m = self._members.get(worker)
            if m is None:
                raise MemberEvicted(
                    f"{worker}: {self._evicted.get(worker, 'not registered')}"
                )
            pulled = list(versions) if versions is not None else list(m.pulled)
            if len(pulled) != len(self.shards):
                pulled = [0] * len(self.shards)
            with TRACER.span("ps.push", job=self.cfg.job, worker=worker,
                             step=step):
                for sh in self.shards:
                    self._ensure_alive(sh)
                staleness = max(
                    sh.version - pulled[sh.shard_id] for sh in self.shards
                )
                staleness = max(staleness, 0)
                if staleness > self.cfg.max_staleness:
                    self.metrics.ps_pushes.inc(outcome="rejected")
                    raise PushRejected(
                        f"{worker}: staleness {staleness} > bound "
                        f"{self.cfg.max_staleness} — re-pull",
                        versions=[sh.version for sh in self.shards],
                    )
                weight = self.cfg.decay ** staleness
                if m.straggler:
                    weight *= self.cfg.straggler_decay
                self.metrics.ps_push_staleness.observe(float(staleness))
                self._stage(m, weight, deltas)
                new_versions = self._commit_staged(m)
            m.pushes += 1
            outcome = "fresh" if staleness == 0 and not m.straggler else "decayed"
            self.metrics.ps_pushes.inc(outcome=outcome)
            return PushResult(
                outcome=outcome, weight=weight,
                staleness=staleness, versions=new_versions,
            )

    def stage_push(
        self, worker: str, deltas: Dict[str, np.ndarray], weight: float = 1.0
    ) -> None:
        """Stage a contribution WITHOUT committing (the window a real push
        occupies between arrival and apply). Departure semantics are
        defined over this window: deregister commits it, eviction
        discards it — per shard, atomically."""
        with self._lock:
            m = self._members.get(worker)
            if m is None:
                raise MemberEvicted(f"{worker}: not registered")
            self._stage(m, weight, deltas)

    def _stage(self, m: _Member, weight: float,
               deltas: Dict[str, np.ndarray]) -> None:
        by_shard: Dict[int, Dict[str, np.ndarray]] = {}
        for k, v in deltas.items():
            by_shard.setdefault(shard_for(k, len(self.shards)), {})[k] = v
        for sid, sub in by_shard.items():
            m.inflight[sid] = (weight, sub)

    def _commit_staged(self, m: _Member) -> List[int]:
        """Apply the member's staged contribution shard by shard — in
        shard-id order (single consistent lock/WAL order), each shard's
        slice applied exactly once or not at all."""
        for sid in sorted(m.inflight):
            sh = self.shards[sid]
            self._ensure_alive(sh)
            weight, sub = m.inflight[sid]
            new_v = sh.apply(m.worker, weight, sub, fence=sh.fence)
            TRACER.record(
                "ps.aggregate", duration=0.0, job=self.cfg.job,
                worker=m.worker, shard=sid, version=new_v, weight=weight,
            )
        m.inflight.clear()
        return [sh.version for sh in self.shards]

    # ---- failover --------------------------------------------------------

    def _maybe_chaos_failover(self) -> None:
        if chaos.should_fail("ps.shard_failover"):
            live = [sh for sh in self.shards if sh.alive]
            if live:
                self.fail_shard(live[0].shard_id)

    def _ensure_alive(self, sh: ShardState) -> None:
        if sh.alive:
            return
        if not self.cfg.auto_recover:
            raise ShardUnavailable(f"shard {sh.shard_id} owner is down")
        self.recover_shard(sh.shard_id)

    def fail_shard(self, shard_id: int) -> None:
        """Kill a shard's owner (crash semantics: lease NOT released, WAL
        handle dies, in-memory state gone)."""
        with self._lock:
            self.shards[shard_id].kill()

    def recover_shard(self, shard_id: int) -> int:
        """Fail the shard over to a fresh owner: wait out the dead
        owner's lease (fake-clock friendly — the shard's clock decides),
        acquire with a bumped fencing token, replay the WAL."""
        from kubedl_tpu_torch.ps.shards import _LeaseHeld

        with self._lock:
            sh = self.shards[shard_id]
            if sh.alive:
                return sh.fence
            self._gen += 1
            deadline = self.clock() + 2 * self.cfg.lease_ttl + 1.0
            while True:
                try:
                    token = sh.open(self._identity(shard_id, self._gen))
                    break
                except _LeaseHeld:
                    if self.clock() >= deadline:
                        raise ShardUnavailable(
                            f"shard {shard_id}: dead owner's lease never "
                            f"expired"
                        )
                    time.sleep(min(self.cfg.lease_ttl / 4.0, 0.05))  # bounded lease-expiry wait on the recovery path
            if not sh.params:
                # memory-only shard (no WAL): survivors' aggregate state
                # for this shard is lost; restart it from zeros at the
                # recovered version so pushes keep flowing
                sh.init_params({})
            self.metrics.ps_shard_failovers.inc()
            return token

    # ---- introspection ---------------------------------------------------

    def versions(self) -> List[int]:
        with self._lock:
            return [sh.version for sh in self.shards]

    def snapshot(self) -> Dict[str, np.ndarray]:
        with self._lock:
            out: Dict[str, np.ndarray] = {}
            for sh in self.shards:
                self._ensure_alive(sh)
                _, p = sh.snapshot()
                out.update(p)
            return out

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "members": sorted(self._members),
                "evicted": dict(self._evicted),
                "versions": [sh.version for sh in self.shards],
                "failovers": sum(sh.failovers for sh in self.shards),
                "shards": len(self.shards),
                "max_staleness": self.cfg.max_staleness,
                "decay": self.cfg.decay,
            }
