"""Deterministic, seed-driven fault injection: the port's copy of
``kubedl_tpu/chaos/plan.py`` (standard library only there as here).

Every layer has a *named injection site* that production code consults
via :func:`check` / :func:`should_fail`. When no plan is armed (the
default, and always the case in production) the calls are a single
module-global ``None`` test. When a :class:`FaultPlan` is armed, each
site follows a seeded schedule so the same seed always produces the same
fault trace. The :data:`SITES` registry is the reference's, whole, so
every drill config written for the reference parses here; the sites the
port consults are the engine's six ``serving.*`` sites, ``remote.request``
(the blob client), ``checkpoint.torn`` (``training/checkpoint.py``),
``trainer.step_stall`` (``training/entry.py``), the parameter service's
``ps.push`` / ``ps.pull`` / ``ps.shard_failover`` (``ps/service.py``) and
the object store's ``store.*`` sites (``core/store.py``, ``core/wal.py``).
The rest belong to the control plane, which stays the reference's.

Injection sites of the registry::

    store.create / store.update / store.delete   ObjectStore writes
    node.heartbeat                               skip a kubelet beat
    elastic.preempt                              preemption notice on a node
    gang.bind                                    reject a slice reservation
    client.http                                  console client transport
    remote.request                               blob-server transport
    serving.dispatch                             device segment dispatch
    serving.canary_dispatch                      non-default-version dispatch tick
    serving.kv_alloc                             KV block allocation failure
    serving.kv_handoff                           KV handoff transfer failure
    serving.chunk_admit                          chunked-prefill admission dispatch
    serving.weight_swap                          corrupt/torn weight load or mid-swap crash
    checkpoint.torn                              die between shard + manifest
    store.wal_append                             torn WAL record (half-write)
    store.wal_fsync                              fail the WAL fsync syscall
    store.wal_group_commit                       fail the batched group-commit fsync
    watchdog.beacon                              freeze a node's beacon publish
    trainer.step_stall                           wedge the training step loop
    router.forward                               replica forward transport failure
    router.probe                                 router health-probe failure
    router.hedge                                 suppress a hedge dispatch
    ps.push                                      drop a parameter-service push
    ps.pull                                      drop a parameter-service pull
    ps.shard_failover                            kill a PS shard's owner mid-run
    shard.lease_renew                            skip a control-plane shard lease renewal beat
    shard.wal_append                             fail a fenced shard WAL append
    federation.heartbeat                         skip a federation member heartbeat beat
    federation.lease_io                          fail a federation member's lease-root IO

Schedules are per-site and deterministic: ``nth(n)`` fails exactly the
n-th call (1-based), ``first(k)`` fails the first k calls, ``prob(p, k)``
fails each of the first k calls with probability p using a RNG seeded from
``(plan.seed, site)``, ``always()`` fails every call, and
``latency(ms, every=n)`` injects a latency spike instead of an error.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


class FaultInjected(Exception):
    """Raised by :func:`check` when the armed plan schedules a fault."""


#: Canonical registry of every injection site, name -> one-line
#: description: the reference's, whole (tests/test_torch_chaos.py holds it
#: equal to the reference's and every site the port consults to it).
SITES: Dict[str, str] = {
    "store.create": "ObjectStore create write",
    "store.update": "ObjectStore update write",
    "store.delete": "ObjectStore delete write",
    "node.heartbeat": "skip a kubelet beat",
    "elastic.preempt": "preemption notice on a node",
    "gang.bind": "reject a slice reservation",
    "client.http": "console client transport",
    "remote.request": "blob-server transport",
    "serving.dispatch": "device segment dispatch",
    "serving.canary_dispatch": "non-default-version dispatch tick",
    "serving.kv_alloc": "KV block allocation failure",
    "serving.kv_handoff": "KV handoff transfer failure",
    "serving.chunk_admit": "chunked-prefill admission dispatch",
    "serving.weight_swap": "corrupt/torn weight load or mid-swap crash",
    "checkpoint.torn": "die between shard + manifest",
    "store.wal_append": "torn WAL record (half-write)",
    "store.wal_fsync": "fail the WAL fsync syscall",
    "store.wal_group_commit": "fail the batched group-commit fsync",
    "watchdog.beacon": "freeze a node's beacon publish",
    "trainer.step_stall": "wedge the training step loop",
    "router.forward": "replica forward transport failure",
    "router.probe": "router health-probe failure",
    "router.hedge": "suppress a hedge dispatch",
    "ps.push": "drop a parameter-service push",
    "ps.pull": "drop a parameter-service pull",
    "ps.shard_failover": "kill a PS shard's owner mid-run",
    "shard.lease_renew": "skip a control-plane shard lease renewal beat",
    "shard.wal_append": "fail a fenced shard WAL append",
    "federation.heartbeat": "skip a federation member heartbeat beat",
    "federation.lease_io": "fail a federation member's lease-root IO",
}


def sites() -> Dict[str, str]:
    """Introspection: every wired injection site with its description
    (a copy — mutating the result never corrupts the registry)."""
    return dict(SITES)


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled behavior at a site. Build via the class helpers."""

    mode: str                      # "nth" | "first" | "prob" | "always" | "latency"
    n: int = 0                     # nth: the 1-based call to fail
    k: int = 0                     # first/prob: number of leading calls in scope
    p: float = 0.0                 # prob: per-call failure probability
    latency_ms: float = 0.0        # latency: spike duration
    every: int = 1                 # latency: spike every n-th call
    exc: Optional[Callable[[str], BaseException]] = None  # exception factory

    @classmethod
    def nth(cls, n: int, exc: Optional[Callable[[str], BaseException]] = None) -> "FaultSpec":
        """Fail exactly the n-th call (1-based) to the site."""
        return cls(mode="nth", n=n, exc=exc)

    @classmethod
    def first(cls, k: int, exc: Optional[Callable[[str], BaseException]] = None) -> "FaultSpec":
        """Fail the first k calls to the site."""
        return cls(mode="first", k=k, exc=exc)

    @classmethod
    def prob(cls, p: float, k: int, exc: Optional[Callable[[str], BaseException]] = None) -> "FaultSpec":
        """Fail each of the first k calls with probability p (seeded)."""
        return cls(mode="prob", p=p, k=k, exc=exc)

    @classmethod
    def always(cls, exc: Optional[Callable[[str], BaseException]] = None) -> "FaultSpec":
        """Fail every call — the poison pill."""
        return cls(mode="always", exc=exc)

    @classmethod
    def latency(cls, ms: float, every: int = 1) -> "FaultSpec":
        """Inject a latency spike (no error) on every n-th call."""
        return cls(mode="latency", latency_ms=ms, every=max(1, every))


@dataclass
class TraceEntry:
    site: str
    call: int          # 1-based call number at the site
    action: str        # "fault" | "latency" | "pass"
    spec_mode: str = ""


class FaultPlan:
    """A seeded schedule of faults across named sites.

    The per-site RNG is derived from ``(seed, site)`` so adding a site or
    reordering calls at one site never perturbs another — same seed,
    same trace, every run.
    """

    def __init__(self, seed: int, sites: Optional[Dict[str, List[FaultSpec]]] = None,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self.seed = seed
        self._sites: Dict[str, List[FaultSpec]] = {}
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._sleep = sleep
        self.trace: List[TraceEntry] = []
        for site, specs in (sites or {}).items():
            for spec in specs:
                self.add(site, spec)

    def add(self, site: str, spec: FaultSpec) -> "FaultPlan":
        self._sites.setdefault(site, []).append(spec)
        return self

    def _rng(self, site: str) -> random.Random:
        if site not in self._rngs:
            self._rngs[site] = random.Random(f"{self.seed}:{site}")
        return self._rngs[site]

    # ---- evaluation ------------------------------------------------------

    def evaluate(self, site: str) -> Tuple[str, Optional[FaultSpec], int]:
        """Advance the site's call counter and decide (action, spec, call#)."""
        with self._lock:
            call = self._calls.get(site, 0) + 1
            self._calls[site] = call
            specs = self._sites.get(site)
            if not specs:
                return ("pass", None, call)
            for spec in specs:
                if spec.mode == "nth" and call == spec.n:
                    hit = "fault"
                elif spec.mode == "first" and call <= spec.k:
                    hit = "fault"
                elif spec.mode == "always":
                    hit = "fault"
                elif spec.mode == "prob" and call <= spec.k:
                    if self._rng(site).random() < spec.p:
                        hit = "fault"
                    else:
                        continue
                elif spec.mode == "latency" and call % spec.every == 0:
                    hit = "latency"
                else:
                    continue
                self.trace.append(TraceEntry(site, call, hit, spec.mode))
                return (hit, spec, call)
            self.trace.append(TraceEntry(site, call, "pass"))
            return ("pass", None, call)

    def calls(self, site: str) -> int:
        with self._lock:
            return self._calls.get(site, 0)

    def faults(self, site: Optional[str] = None) -> int:
        with self._lock:
            return sum(
                1 for t in self.trace
                if t.action == "fault" and (site is None or t.site == site)
            )

    def trace_tuples(self) -> List[Tuple[str, int, str]]:
        """Hashable trace view for determinism assertions."""
        with self._lock:
            return [(t.site, t.call, t.action) for t in self.trace]

    # ---- context manager -------------------------------------------------

    def __enter__(self) -> "FaultPlan":
        arm(self)
        return self

    def __exit__(self, *exc) -> None:
        disarm()


def plan_from_config(cfg: Dict,
                     sleep: Callable[[float], None] = time.sleep,
                     ) -> FaultPlan:
    """Build a :class:`FaultPlan` from a JSON-shaped dict, so a replica
    SUBPROCESS can arm a seeded schedule it cannot receive as an
    in-process context manager (``KUBEDL_SERVE_CONFIG["chaos"]`` — the
    rollout drill seeds a latency fault on a canary replica this way)::

        {"seed": 7, "sites": {"serving.canary_dispatch":
            [{"mode": "latency", "latency_ms": 250, "every": 1}]}}

    Unknown sites and modes raise ``ValueError`` at build time — a
    typo'd drill must fail at arm, not silently never fire."""
    seed = int(cfg.get("seed", 0))
    plan = FaultPlan(seed, sleep=sleep)
    for site, specs in dict(cfg.get("sites") or {}).items():
        if site not in SITES:
            raise ValueError(f"unknown chaos site {site!r}")
        for raw in specs:
            mode = str(raw.get("mode", ""))
            if mode == "latency":
                spec = FaultSpec.latency(float(raw["latency_ms"]),
                                         every=int(raw.get("every", 1)))
            elif mode == "nth":
                spec = FaultSpec.nth(int(raw["n"]))
            elif mode == "first":
                spec = FaultSpec.first(int(raw["k"]))
            elif mode == "prob":
                spec = FaultSpec.prob(float(raw["p"]), int(raw["k"]))
            elif mode == "always":
                spec = FaultSpec.always()
            else:
                raise ValueError(
                    f"unknown chaos spec mode {mode!r} at {site!r}"
                )
            plan.add(site, spec)
    return plan


# ---- module-level registry (the near-zero-cost fast path) ----------------

_PLAN: Optional[FaultPlan] = None


def arm(plan: FaultPlan) -> FaultPlan:
    """Arm a plan globally. Tests should prefer ``with FaultPlan(...) as p:``."""
    global _PLAN
    _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


def active() -> Optional[FaultPlan]:
    return _PLAN


def check(site: str) -> None:
    """Raise :class:`FaultInjected` (or the spec's exception) if the armed
    plan schedules a fault at this site. No-op when disarmed — callers pay
    one global load and a ``None`` test."""
    plan = _PLAN
    if plan is None:
        return
    action, spec, call = plan.evaluate(site)
    if action == "latency":
        plan._sleep(spec.latency_ms / 1000.0)
    elif action == "fault":
        if spec.exc is not None:
            raise spec.exc(site)
        raise FaultInjected(f"chaos: injected fault at {site} (call #{call})")


def should_fail(site: str) -> bool:
    """Bool-returning variant for sites that degrade by return value
    (gang bind rejection, skipped heartbeat) rather than by raising."""
    plan = _PLAN
    if plan is None:
        return False
    action, spec, _ = plan.evaluate(site)
    if action == "latency":
        plan._sleep(spec.latency_ms / 1000.0)
        return False
    return action == "fault"
