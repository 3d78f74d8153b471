"""Distributed tracing: trace/span identity, context propagation, ring
buffer, Chrome-trace export and a profiler hook. The port's copy of
``kubedl_tpu/observability/tracing.py`` (standard library only), less
``trace_for_job`` (the control plane's job roots), with ``xprof_trace``
on ``torch.profiler``.

* every span has a ``trace_id``/``span_id``/``parent_id`` so cross-process
  causality survives export;
* a W3C-``traceparent``-style header (``X-Trace-Context``,
  ``00-<32 hex>-<16 hex>-<flags>``) propagates the context over HTTP hops;
* timestamps are anchored to the wall-clock epoch (``time.perf_counter``
  has a per-process epoch), so ``chrome_trace()`` dumps from different
  processes merge on one timeline (``scripts/tracemerge.py``).

A span is two ``perf_counter`` calls, two ``getrandbits`` and one deque
append; disarmed (``enabled = False``) the cost is one attribute test and
a shared null context manager. The engine's spans time the HOST: around
an asynchronous CUDA launch they measure its dispatch, not its device
time, as the reference's spans around an asynchronous XLA dispatch do.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

#: HTTP header carrying the trace context between router/engine/replicas.
TRACE_HEADER = "X-Trace-Context"


def _rand_hex(bits: int) -> str:
    return format(random.getrandbits(bits), "0{}x".format(bits // 4))


def new_trace_id() -> str:
    return _rand_hex(128)


def new_span_id() -> str:
    return _rand_hex(64)


@dataclass(frozen=True)
class TraceContext:
    """One (trace, span) coordinate — what travels in ``X-Trace-Context``.

    ``span_id`` names the SENDER's span: a receiver that starts work under
    this context parents its spans beneath it.
    """

    trace_id: str
    span_id: str
    sampled: bool = True

    def to_header(self) -> str:
        return "00-{}-{}-{}".format(
            self.trace_id, self.span_id, "01" if self.sampled else "00"
        )

    def child(self) -> "TraceContext":
        """A sibling coordinate in the same trace with a fresh span id."""
        return TraceContext(self.trace_id, new_span_id(), self.sampled)


def parse_trace_header(value: Optional[str]) -> Optional[TraceContext]:
    """Parse ``00-<32 hex trace>-<16 hex span>-<2 hex flags>``; None on
    anything malformed (propagation must never 500 a request)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    _ver, tid, sid, flags = parts
    if len(tid) != 32 or len(sid) != 16:
        return None
    try:
        int(tid, 16)
        int(sid, 16)
    except ValueError:
        return None
    return TraceContext(tid.lower(), sid.lower(), flags != "00")


# ---------------------------------------------------------------------------
# Thread-local context stack (nested spans on one thread parent naturally).

_TLS = threading.local()


def _ctx_stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def current_context() -> Optional[TraceContext]:
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


@contextlib.contextmanager
def use_context(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Bind a (parsed) context for the current thread — HTTP handler
    threads use this so everything they run parents under the caller."""
    if ctx is None:
        yield None
        return
    st = _ctx_stack()
    st.append(ctx)
    try:
        yield ctx
    finally:
        st.pop()


@dataclass
class Span:
    name: str
    start: float  # perf_counter seconds (process-local)
    duration: float
    thread: str
    attrs: Dict[str, Any] = field(default_factory=dict)
    trace_id: str = ""
    span_id: str = ""
    parent_id: str = ""
    ts: float = 0.0  # wall-clock epoch seconds (cross-process timebase)


class _NullSpan:
    """Shared do-nothing handle returned while the tracer is disarmed.

    Supports both the context-manager protocol (``span()``) and the
    explicit begin/finish protocol, so call sites never branch on
    ``enabled`` themselves.
    """

    __slots__ = ()
    ctx = None
    span_id = ""

    def __enter__(self) -> Dict[str, Any]:
        return {}

    def __exit__(self, *exc: Any) -> bool:
        return False

    def finish(self, **attrs: Any) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _SpanHandle:
    """Armed span: mints its identity up front (``.ctx`` is valid before
    ``__enter__``, so the caller can serialize it into an outbound header),
    pushes itself on the thread-local stack while open, and records on
    exit. ``begin()/finish()`` is the no-TLS variant for spans that start
    and end on different threads."""

    __slots__ = ("_tracer", "name", "attrs", "ctx", "parent_id", "_t0",
                 "_on_stack")

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        parent: Optional[TraceContext],
        attrs: Dict[str, Any],
    ) -> None:
        if parent is None:
            parent = current_context()
        if parent is not None:
            self.ctx = TraceContext(parent.trace_id, new_span_id(),
                                    parent.sampled)
            self.parent_id = parent.span_id
        else:
            self.ctx = TraceContext(new_trace_id(), new_span_id())
            self.parent_id = ""
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._t0 = time.perf_counter()
        self._on_stack = False

    @property
    def span_id(self) -> str:
        return self.ctx.span_id

    def __enter__(self) -> Dict[str, Any]:
        _ctx_stack().append(self.ctx)
        self._on_stack = True
        self._t0 = time.perf_counter()
        return self.attrs  # callers may add attrs mid-span

    def __exit__(self, *exc: Any) -> bool:
        if self._on_stack:
            st = _ctx_stack()
            if st and st[-1] is self.ctx:
                st.pop()
            self._on_stack = False
        self.finish()
        return False

    def finish(self, **attrs: Any) -> None:
        if attrs:
            self.attrs.update(attrs)
        t0 = self._t0
        self._tracer._record(
            self.name, t0, time.perf_counter() - t0, self.ctx.trace_id,
            self.ctx.span_id, self.parent_id, self.attrs,
        )


def span_to_dict(s: Span) -> Dict[str, Any]:
    return {
        "name": s.name,
        "trace_id": s.trace_id,
        "span_id": s.span_id,
        "parent_id": s.parent_id,
        "ts": s.ts,
        "duration_ms": s.duration * 1e3,
        "thread": s.thread,
        "attrs": s.attrs,
    }


def build_span_tree(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Nest flat span dicts into parent→children trees (the flight-recorder
    response shape). Spans whose parent is absent — including spans
    parented under a remote caller we never saw — become roots. Children
    sort by epoch ``ts`` so the tree reads in causal order."""
    by_id: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        node = dict(s)
        node["children"] = []
        if node.get("span_id"):
            by_id[node["span_id"]] = node
        else:  # identity-less spans can never be parents
            by_id[id(node)] = node  # type: ignore[index]
    roots: List[Dict[str, Any]] = []
    for node in by_id.values():
        parent = by_id.get(node.get("parent_id") or "")
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    def _sort(nodes: List[Dict[str, Any]]) -> None:
        nodes.sort(key=lambda n: n.get("ts") or 0.0)
        for n in nodes:
            _sort(n["children"])
    _sort(roots)
    return roots


class Tracer:
    """Ring-buffered span recorder with trace identity.

    Usage::

        with TRACER.span("reconcile", kind="TPUJob", job="ns/name"):
            ...

        h = TRACER.span("router.forward", parent=ctx, replica=name)
        headers[TRACE_HEADER] = h.ctx.to_header()   # valid before enter
        with h as attrs:
            attrs["status"] = do_forward()
    """

    def __init__(self, capacity: int = 4096) -> None:
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self.enabled = True
        # Per-process anchor pair: epoch ts of any perf_counter reading is
        # anchor_wall + (t - anchor_perf). Captured once so every span in
        # this process shares one consistent mapping.
        self._anchor_wall = time.time()
        self._anchor_perf = time.perf_counter()

    def epoch_of(self, perf_t: float) -> float:
        """Wall-clock epoch seconds for a process-local perf_counter value."""
        return self._anchor_wall + (perf_t - self._anchor_perf)

    def span(self, name: str, parent: Optional[TraceContext] = None,
             **attrs: Any):
        """Context manager measuring a span. Disarmed: one attribute test,
        returns the shared null handle (near-zero, budget-tested)."""
        if not self.enabled:
            return _NULL_SPAN
        return _SpanHandle(self, name, parent, attrs)

    def begin(self, name: str, parent: Optional[TraceContext] = None,
              **attrs: Any):
        """Start a span that will ``finish()`` on a different thread —
        no thread-local stack involvement."""
        if not self.enabled:
            return _NULL_SPAN
        return _SpanHandle(self, name, parent, attrs)

    def record(
        self,
        name: str,
        start: Optional[float] = None,
        duration: float = 0.0,
        trace: Optional[TraceContext] = None,
        parent_id: str = "",
        span_id: str = "",
        wall_ts: Optional[float] = None,
        **attrs: Any,
    ) -> str:
        """Record an already-measured span (scheduler threads measure with
        raw perf_counter and attribute after the fact).

        ``trace`` supplies the trace id and the DEFAULT parent (its
        span_id); ``parent_id`` overrides the parent, ``span_id`` forces
        this span's own id (so sub-spans recorded earlier can already
        point at it). ``wall_ts`` pins the epoch timestamp directly for
        milestone spans anchored to external wall-clock events. Returns
        the span id ("" while disarmed).
        """
        if not self.enabled:
            return ""
        if start is None:
            start = time.perf_counter()
        if trace is not None:
            tid = trace.trace_id
            pid = parent_id or trace.span_id
        else:
            tid = new_trace_id()
            pid = parent_id
        sid = span_id or new_span_id()
        self._record(name, start, duration, tid, sid, pid, attrs,
                     wall_ts=wall_ts)
        return sid

    def _record(
        self,
        name: str,
        t0: float,
        dur: float,
        trace_id: str,
        span_id: str,
        parent_id: str,
        attrs: Dict[str, Any],
        wall_ts: Optional[float] = None,
    ) -> None:
        ts = wall_ts if wall_ts is not None else self.epoch_of(t0)
        with self._lock:
            self._spans.append(
                Span(
                    name=name,
                    start=t0,
                    duration=dur,
                    thread=threading.current_thread().name,
                    attrs=dict(attrs),
                    trace_id=trace_id,
                    span_id=span_id,
                    parent_id=parent_id,
                    ts=ts,
                )
            )

    def tag(self, span_id: str, **attrs: Any) -> bool:
        """Post-hoc attribute update on a recorded span (hedge resolution
        tags winner/loser after both attempts finished). Linear scan —
        called once per hedged request, never on the per-token path."""
        if not span_id:
            return False
        with self._lock:
            for s in reversed(self._spans):
                if s.span_id == span_id:
                    s.attrs.update(attrs)
                    return True
        return False

    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def trace_spans(self, trace_id: str) -> List[Span]:
        """Every retained span belonging to one trace (flight recorder)."""
        with self._lock:
            return [s for s in self._spans if s.trace_id == trace_id]

    def span_tree(self, trace_id: str) -> List[Dict[str, Any]]:
        return build_span_tree(
            [span_to_dict(s) for s in self.trace_spans(trace_id)]
        )

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # ---- aggregation ------------------------------------------------------

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name {count, total_s, max_s} — the quick 'where does
        reconcile time go' answer without exporting anything."""
        agg: Dict[str, Dict[str, float]] = {}
        for s in self.spans():
            a = agg.setdefault(s.name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            a["count"] += 1
            a["total_s"] += s.duration
            a["max_s"] = max(a["max_s"], s.duration)
        return agg

    # ---- export -----------------------------------------------------------

    def chrome_trace(self, pid: int = 1, process_name: str = "") -> str:
        """Chrome trace-event JSON ('X' complete events, µs timebase).

        ``ts`` is wall-clock epoch µs, so dumps from different processes
        (distinct ``pid`` per replica) overlay on one timeline — see
        ``scripts/tracemerge.py``.
        """
        tids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        if process_name:
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": process_name},
            })
        for s in self.spans():
            tid = tids.setdefault(s.thread, len(tids) + 1)
            args = dict(s.attrs)
            if s.trace_id:
                args["trace_id"] = s.trace_id
                args["span_id"] = s.span_id
                args["parent_id"] = s.parent_id
            events.append(
                {
                    "name": s.name,
                    "ph": "X",
                    "ts": (s.ts if s.ts else self.epoch_of(s.start)) * 1e6,
                    "dur": s.duration * 1e6,
                    "pid": pid,
                    "tid": tid,
                    "args": args,
                }
            )
        return json.dumps({"traceEvents": events})

    def dump(self, path: str, pid: int = 1, process_name: str = "") -> None:
        with open(path, "w") as f:
            f.write(self.chrome_trace(pid=pid, process_name=process_name))


#: process-wide default tracer (the engine, router, and manager use this)
TRACER = Tracer()


# ---------------------------------------------------------------------------
# Device-side: a profiler capture around training steps.


@contextlib.contextmanager
def xprof_trace(logdir: str, enabled: bool = True) -> Iterator[None]:
    """Wrap a region in a ``torch.profiler`` capture (host ops, and the
    card's kernels when there is one) whose Chrome trace lands under
    ``logdir`` as ``trace-<pid>-<ms>.json`` — the directory the
    TensorBoard sidecar serves when its config says ``profile: true``.
    No-op when disabled or when the profiler is unavailable (e.g. a
    capture already running)."""
    if not enabled:
        yield
        return
    try:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    except Exception:
        yield
        return
    try:
        yield
    finally:
        try:
            prof.stop()
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                logdir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json"))
        except Exception:
            pass
