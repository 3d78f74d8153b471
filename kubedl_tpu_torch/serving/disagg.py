"""Disaggregated prefill/decode serving: the KV handoff artifact and the
per-tenant QoS arbiter.

The port's copy of ``kubedl_tpu/serving/disagg.py`` (jax-free there as
here). Its one functional change is the payload dtype: numpy names bf16
only through ``ml_dtypes``, so the port carries bf16 payloads as their
``uint16`` bits with ``dtype="bfloat16"`` beside them, writes
``"dtype": "bfloat16"`` in the header as the reference does, and reads
a reference artifact's bf16 payload the same way. The wire bytes are
the reference's for the same fields and payload.

Prefill is compute-bound and batch-friendly; decode is memory-bandwidth-
bound and latency-critical. Running both on every replica forces one
batch geometry onto two regimes — segments cap at 4 steps whenever a
prefill is waiting, and prefill batches fragment around resident decode
rows. Splitting them into pools lets each be sized and scheduled for its
own regime. The transfer unit is the refcounted KV block: a prefill
replica fills a row's blocks, samples the first token, and exports the
block payloads + logical table order + first token as a ``KVHandoff``;
a decode replica adopts it — allocates blocks from its OWN pool
(all-or-nothing, same watermark admission), scatters the payloads in,
and resumes decoding as if it had prefilled the row itself. Greedy
output is bit-identical to the colocated path because the handoff point
is exactly the colocated engine's own prefill/decode seam: first token
from prefill logits, pos = prompt length, next input = first token.

The QoS side: requests carry a tenant (``X-Tenant`` header), tenants map
to classes, and a :class:`WeightedFairQueue` arbitrates dispatch slots —
smooth weighted round-robin across classes for proportional service,
strict shed-lowest-priority-first when the queue overflows. The router
composes this with the engines' own KV-watermark sheds: high classes
get dispatch slots first, so under sustained overload the lowest class
absorbs the 503s.
"""
from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

HANDOFF_MAGIC = b"KVH1"


@dataclass
class KVHandoff:
    """Everything a decode replica needs to resume a prefilled row.

    ``k``/``v`` are [L, n_blocks, block_size, KV_heads, head_dim] host
    arrays — the row's block payloads in LOGICAL table order (block ids
    are allocator-local and never cross the wire). ``pos`` is the number
    of valid positions (== prompt length as fed); ``first_token`` is the
    token sampled from the prefill logits, which the adopter feeds as the
    first decode input exactly like the colocated engine would."""

    model: str
    prompt_ids: List[int]
    first_token: int
    pos: int
    block_size: int
    k: np.ndarray
    v: np.ndarray
    max_tokens: int = 16
    temperature: float = 0.0
    request_id: str = ""
    cache_prefix: bool = False
    ttft_ms: Optional[float] = None
    #: X-Trace-Context header string of the originating trace (parent =
    #: the prefill request span) — lets an adopter with no HTTP header
    #: of its own still attach its spans to the caller's trace
    trace: str = ""
    #: weight version the prefill ran on (docs/serving.md "Model
    #: lifecycle"): the adopter decodes on exactly this version or
    #: rejects the handoff — disagg legs never mix versions. "" keeps
    #: pre-versioning artifacts adoptable (engine default).
    model_version: str = ""
    #: the payload's dtype name on the wire; "" = ``str(k.dtype)``.
    #: "bfloat16" marks ``k``/``v`` as uint16 arrays of bf16 bits
    dtype: str = ""

    @property
    def dtype_name(self) -> str:
        return self.dtype or str(self.k.dtype)

    @property
    def nbytes(self) -> int:
        return int(self.k.nbytes + self.v.nbytes)

    def to_bytes(self) -> bytes:
        """Serialize: magic, u32 header length, JSON header, raw K then V
        buffers (C-order). Dtype/shape ride in the header so the adopter
        validates geometry before touching its allocator."""
        header = json.dumps({
            "model": self.model,
            "prompt_ids": [int(t) for t in self.prompt_ids],
            "first_token": int(self.first_token),
            "pos": int(self.pos),
            "block_size": int(self.block_size),
            "max_tokens": int(self.max_tokens),
            "temperature": float(self.temperature),
            "request_id": self.request_id,
            "cache_prefix": bool(self.cache_prefix),
            "ttft_ms": self.ttft_ms,
            "trace": self.trace,
            "model_version": self.model_version,
            "dtype": self.dtype_name,
            "shape": list(self.k.shape),
        }).encode()
        buf = io.BytesIO()
        buf.write(HANDOFF_MAGIC)
        buf.write(len(header).to_bytes(4, "big"))
        buf.write(header)
        buf.write(np.ascontiguousarray(self.k).tobytes())
        buf.write(np.ascontiguousarray(self.v).tobytes())
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "KVHandoff":
        if data[:4] != HANDOFF_MAGIC:
            raise ValueError("not a KVHandoff artifact (bad magic)")
        hlen = int.from_bytes(data[4:8], "big")
        header = json.loads(data[8:8 + hlen])
        shape = tuple(header["shape"])
        name = header["dtype"]
        # bf16 has no numpy dtype without ml_dtypes: read its bits
        dtype = np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)
        off = 8 + hlen
        size = int(np.prod(shape)) * dtype.itemsize
        if len(data) < off + 2 * size:
            raise ValueError("truncated KVHandoff artifact")
        k = np.frombuffer(data, dtype, count=int(np.prod(shape)),
                          offset=off).reshape(shape)
        v = np.frombuffer(data, dtype, count=int(np.prod(shape)),
                          offset=off + size).reshape(shape)
        return cls(
            model=header["model"],
            prompt_ids=list(header["prompt_ids"]),
            first_token=int(header["first_token"]),
            pos=int(header["pos"]),
            block_size=int(header["block_size"]),
            k=k, v=v,
            max_tokens=int(header["max_tokens"]),
            temperature=float(header["temperature"]),
            request_id=header.get("request_id", ""),
            cache_prefix=bool(header.get("cache_prefix", False)),
            ttft_ms=header.get("ttft_ms"),
            trace=header.get("trace", ""),
            model_version=header.get("model_version", ""),
            dtype=name if name == "bfloat16" else "",
        )


class HandoffError(RuntimeError):
    """A handoff transfer failed mid-flight (export/adopt leg). The
    blocks involved are already released — callers retry or fall back
    to the colocated path; they never clean up allocator state."""


class QoSShed(Exception):
    """Raised by :meth:`WeightedFairQueue.acquire` when a request is shed
    — queue overflow chose it as the lowest-priority victim, or its
    deadline expired while queued. Carries the class for metrics and the
    distinguishable 503 payload."""

    def __init__(self, qos_class: str, why: str = "queue overflow"):
        super().__init__(f"qos shed ({qos_class}): {why}")
        self.qos_class = qos_class
        self.why = why


@dataclass
class QoSClassSpec:
    """One QoS class: ``weight`` sets the dispatch share under contention
    (smooth weighted round-robin), ``priority`` sets shed order — HIGHER
    numbers shed first (priority 0 is the most protected class)."""

    weight: int = 1
    priority: int = 10


class _Waiter:
    __slots__ = ("cls", "event", "shed", "admitted")

    def __init__(self, cls: str):
        self.cls = cls
        self.event = threading.Event()
        self.shed = False
        self.admitted = False


class WeightedFairQueue:
    """Arbitrates a fixed number of concurrent dispatch slots across QoS
    classes. Admission order under contention is smooth weighted
    round-robin (nginx-style: each grant adds ``weight`` to the class's
    credit, the winner pays back the total) — deterministic and
    proportional. Overflow sheds strictly lowest-priority-first: the
    victim is a queued waiter from the worst class, or the arriving
    request itself if it IS the worst class."""

    def __init__(
        self,
        classes: Optional[Dict[str, QoSClassSpec]] = None,
        capacity: int = 8,
        max_queue: int = 64,
        default_class: str = "",
        clock=time.monotonic,
    ):
        self.classes: Dict[str, QoSClassSpec] = dict(classes or {})
        if not self.classes:
            self.classes = {"default": QoSClassSpec()}
        if not default_class or default_class not in self.classes:
            # default to the worst class: unknown tenants never outrank
            # a configured one
            default_class = max(
                self.classes, key=lambda c: (self.classes[c].priority, c)
            )
        self.default_class = default_class
        self.capacity = int(capacity)
        self.max_queue = int(max_queue)
        self._clock = clock
        self._lock = threading.Lock()
        self._active = 0
        self._queues: Dict[str, deque] = {c: deque() for c in self.classes}
        self._credit: Dict[str, float] = {c: 0.0 for c in self.classes}
        self.sheds: Dict[str, int] = {c: 0 for c in self.classes}
        self.admits: Dict[str, int] = {c: 0 for c in self.classes}

    def resolve(self, tenant_or_class: Optional[str],
                tenants: Optional[Dict[str, str]] = None) -> str:
        """Map an ``X-Tenant`` value to a class: explicit tenant map
        first, then a class named literally, else the default class."""
        t = (tenant_or_class or "").strip()
        if tenants and t in tenants and tenants[t] in self.classes:
            return tenants[t]
        if t in self.classes:
            return t
        return self.default_class

    def queue_depths(self) -> Dict[str, int]:
        with self._lock:
            return {c: len(q) for c, q in self._queues.items()}

    def acquire(self, cls: str, timeout_s: float = 30.0) -> str:
        """Block until a dispatch slot is granted; raises :class:`QoSShed`
        on overflow eviction or queue-deadline expiry. Returns the class
        actually charged (callers pass it back to :meth:`release`)."""
        if cls not in self.classes:
            cls = self.default_class
        me = _Waiter(cls)
        with self._lock:
            if self._active < self.capacity and not self._queued_locked():
                self._active += 1
                self.admits[cls] += 1
                return cls
            if self._queued_locked() >= self.max_queue:
                victim = self._worst_locked()
                if victim is None or (
                    self.classes[cls].priority
                    >= self.classes[victim.cls].priority
                ):
                    # the arrival is (at least tied for) the worst class:
                    # it absorbs the shed, queued work keeps its place
                    self.sheds[cls] += 1
                    raise QoSShed(cls)
                self._queues[victim.cls].remove(victim)
                victim.shed = True
                self.sheds[victim.cls] += 1
                victim.event.set()
            self._queues[cls].append(me)
        if not me.event.wait(timeout=max(0.0, timeout_s)):
            with self._lock:
                if not me.admitted and not me.shed:
                    try:
                        self._queues[cls].remove(me)
                    except ValueError:
                        pass
                    self.sheds[cls] += 1
                    raise QoSShed(cls, "queue deadline expired")
        if me.shed:
            raise QoSShed(cls)
        if me.admitted:
            return cls
        # woken between timeout and lock: treat as admitted iff flagged
        with self._lock:
            if me.admitted:
                return cls
            self.sheds[cls] += 1
            raise QoSShed(cls, "queue deadline expired")

    def release(self, cls: str) -> None:
        with self._lock:
            self._active = max(0, self._active - 1)
            self._grant_locked()

    def _queued_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _worst_locked(self) -> Optional[_Waiter]:
        worst = None
        for c, q in self._queues.items():
            if not q:
                continue
            if worst is None or (
                self.classes[c].priority
                > self.classes[worst].priority
            ):
                worst = c
        return self._queues[worst][-1] if worst else None

    def _grant_locked(self) -> None:
        """Smooth weighted round-robin over nonempty classes."""
        while self._active < self.capacity:
            ready = [c for c, q in self._queues.items() if q]
            if not ready:
                return
            total = 0.0
            for c in ready:
                self._credit[c] += self.classes[c].weight
                total += self.classes[c].weight
            pick = max(
                ready,
                key=lambda c: (self._credit[c],
                               -self.classes[c].priority, c),
            )
            self._credit[pick] -= total
            w = self._queues[pick].popleft()
            w.admitted = True
            self._active += 1
            self.admits[pick] += 1
            w.event.set()


def qos_from_config(cfg: Optional[Dict]) -> Optional[WeightedFairQueue]:
    """Build the arbiter from a router-config ``qos`` block::

        {"classes": {"gold":   {"weight": 8, "priority": 0},
                     "bronze": {"weight": 1, "priority": 2}},
         "tenants": {"acme": "gold"},
         "default_class": "bronze", "capacity": 8, "max_queue": 64}
    """
    if not cfg or not isinstance(cfg, dict):
        return None
    classes = {
        name: QoSClassSpec(
            weight=int(spec.get("weight", 1)),
            priority=int(spec.get("priority", 10)),
        )
        for name, spec in (cfg.get("classes") or {}).items()
    }
    return WeightedFairQueue(
        classes=classes,
        capacity=int(cfg.get("capacity", 8)),
        max_queue=int(cfg.get("max_queue", 64)),
        default_class=str(cfg.get("default_class", "")),
    )


class DisaggCoordinator:
    """In-process prefill→adopt pump over engine objects — the local twin
    of the router's two-leg HTTP dispatch, used by tests, the conservation
    suite, and ``bench.py --disagg``. One call = one full request: prefill
    on the prefill engine, serialize/deserialize the handoff (exercising
    the wire format), adopt on the decode engine."""

    def __init__(self, prefill_engine, decode_engine, serialize: bool = True):
        self.prefill = prefill_engine
        self.decode = decode_engine
        self.serialize = serialize

    def generate(self, prompt_ids, max_tokens: int = 16,
                 temperature: float = 0.0, timeout_s: float = 600.0,
                 cache_prefix: bool = False, request_id: str = "",
                 trace=None, model_version: str = "") -> Dict:
        h = self.prefill.prefill_handoff(
            prompt_ids, max_tokens=max_tokens, temperature=temperature,
            timeout_s=timeout_s, cache_prefix=cache_prefix,
            request_id=request_id, trace=trace,
            model_version=model_version,
        )
        if self.serialize:
            h = KVHandoff.from_bytes(h.to_bytes())
        # no explicit trace here: the handoff's embedded header keeps the
        # adopt leg on the same trace (server._arm_trace parses it)
        return self.decode.adopt_handoff(h, timeout_s=timeout_s)
