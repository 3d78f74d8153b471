"""Prometheus-style metrics, dependency-free: the port's copy of
``kubedl_tpu/observability/metrics.py`` (standard library only) —
``Counter``, ``Gauge``, ``Histogram``, ``MetricsRegistry`` and the serving
engine's family, :class:`ServingMetrics`, and the parameter service's,
:class:`PSMetrics`. The family names, HELP strings, label keys and
buckets are the reference's, letter for letter (the ``kubedl_tpu_serving_``
and ``kubedl_tpu_ps_`` prefixes included): dashboards, alerts and the
router read them. ``JobMetrics``, ``RouterMetrics`` and ``SLOMetrics``
belong to the control plane, which stays the reference's.
Exported in Prometheus text format by :meth:`MetricsRegistry.render`
(``GET /metrics`` on a port replica).
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Tuple

LabelKV = Tuple[Tuple[str, str], ...]


def _labels(labels: Dict[str, str]) -> LabelKV:
    return tuple(sorted(labels.items()))


def _fmt_labels(kv: LabelKV) -> str:
    if not kv:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in kv) + "}"


class Counter:
    def __init__(self, name: str, help_: str) -> None:
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self._values: Dict[LabelKV, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        kv = _labels(labels)
        with self._lock:
            self._values[kv] = self._values.get(kv, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_labels(labels), 0.0)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [
                {"labels": dict(kv), "value": v}
                for kv, v in sorted(self._values.items())
            ]

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            for kv, v in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(kv)} {v}")
        return out


class Gauge:
    """A gauge whose value may be a live callback (the reference's
    running/pending gauges list-and-count on scrape, status_counter.go)."""

    def __init__(self, name: str, help_: str) -> None:
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self._values: Dict[LabelKV, float] = {}
        self._callbacks: Dict[LabelKV, Callable[[], float]] = {}

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_labels(labels)] = value

    def set_function(self, fn: Callable[[], float], **labels: str) -> None:
        with self._lock:
            self._callbacks[_labels(labels)] = fn

    def value(self, **labels: str) -> float:
        kv = _labels(labels)
        with self._lock:
            if kv in self._callbacks:
                return self._callbacks[kv]()
            return self._values.get(kv, 0.0)

    def snapshot(self) -> List[dict]:
        with self._lock:
            items = dict(self._values)
            callbacks = dict(self._callbacks)
        for kv, fn in callbacks.items():
            try:
                items[kv] = fn()
            except Exception:
                continue
        return [
            {"labels": dict(kv), "value": v} for kv, v in sorted(items.items())
        ]

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            items = dict(self._values)
            for kv, fn in self._callbacks.items():
                try:
                    items[kv] = fn()
                except Exception:
                    continue
        for kv, v in sorted(items.items()):
            out.append(f"{self.name}{_fmt_labels(kv)} {v}")
        return out


_DEFAULT_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300, 600)


class Histogram:
    def __init__(
        self, name: str, help_: str, buckets: Tuple[float, ...] = _DEFAULT_BUCKETS
    ) -> None:
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts: Dict[LabelKV, List[int]] = {}
        self._sum: Dict[LabelKV, float] = {}
        self._total: Dict[LabelKV, int] = {}
        #: label-set -> (le-or-"+Inf", trace_id, value, wall ts) — the LAST
        #: exemplar observed, attached to the bucket its value fell into
        #: (OpenMetrics-style: a burning latency histogram links straight
        #: to an offending trace retrievable via /v1/trace)
        self._exemplars: Dict[LabelKV, Tuple[str, str, float, float]] = {}

    def observe(
        self, value: float, exemplar: Optional[str] = None, **labels: str
    ) -> None:
        kv = _labels(labels)
        with self._lock:
            counts = self._counts.setdefault(kv, [0] * len(self.buckets))
            i = bisect_left(self.buckets, value)  # first bucket with value <= le
            if i < len(self.buckets):
                counts[i] += 1
            self._sum[kv] = self._sum.get(kv, 0.0) + value
            self._total[kv] = self._total.get(kv, 0) + 1
            if exemplar:
                le = repr(self.buckets[i]) if i < len(self.buckets) else "+Inf"
                self._exemplars[kv] = (le, str(exemplar), value, time.time())

    def summary(self, **labels: str) -> Tuple[int, float]:
        kv = _labels(labels)
        with self._lock:
            return self._total.get(kv, 0), self._sum.get(kv, 0.0)

    def snapshot(self) -> List[dict]:
        """Structured view for dashboards: per label-set bucket counts
        (non-cumulative), sum and total."""
        with self._lock:
            return [
                {
                    "labels": dict(kv),
                    "buckets": list(self.buckets),
                    "counts": list(counts),
                    "sum": self._sum.get(kv, 0.0),
                    "total": self._total.get(kv, 0),
                }
                for kv, counts in sorted(self._counts.items())
            ]

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for kv, counts in sorted(self._counts.items()):
                ex = self._exemplars.get(kv)
                cum = 0
                for b, c in zip(self.buckets, counts):
                    cum += c
                    lbl = dict(kv)
                    lbl["le"] = repr(b)
                    line = f"{self.name}_bucket{_fmt_labels(_labels(lbl))} {cum}"
                    if ex is not None and ex[0] == repr(b):
                        line += (f' # {{trace_id="{ex[1]}"}} {ex[2]} '
                                 f"{ex[3]:.3f}")
                    out.append(line)
                lbl = dict(kv)
                lbl["le"] = "+Inf"
                line = (
                    f"{self.name}_bucket{_fmt_labels(_labels(lbl))} {self._total[kv]}"
                )
                if ex is not None and ex[0] == "+Inf":
                    line += f' # {{trace_id="{ex[1]}"}} {ex[2]} {ex[3]:.3f}'
                out.append(line)
                out.append(f"{self.name}_sum{_fmt_labels(kv)} {self._sum[kv]}")
                out.append(f"{self.name}_count{_fmt_labels(kv)} {self._total[kv]}")
        return out


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: List[object] = []

    def counter(self, name: str, help_: str) -> Counter:
        m = Counter(name, help_)
        with self._lock:
            self._metrics.append(m)
        return m

    def gauge(self, name: str, help_: str) -> Gauge:
        m = Gauge(name, help_)
        with self._lock:
            self._metrics.append(m)
        return m

    def histogram(self, name: str, help_: str, **kw) -> Histogram:
        m = Histogram(name, help_, **kw)
        with self._lock:
            self._metrics.append(m)
        return m

    def render(self) -> str:
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.extend(m.render())  # type: ignore[attr-defined]
        return "\n".join(lines) + "\n"


class PSMetrics:
    """The parameter-service metric family (``kubedl_tpu_torch/ps``,
    docs/elasticity.md "Parameter-service mode"): asynchronous push/pull
    aggregation accounting — push outcomes by staleness handling, member
    churn, and shard failovers."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self.ps_pushes = r.counter(
            "kubedl_tpu_ps_pushes",
            "Worker delta pushes, by outcome: fresh (staleness 0, full "
            "weight), decayed (in-bound staleness, decay-weighted), "
            "rejected (beyond max_staleness — the worker must re-pull)",
        )
        self.ps_pulls = r.counter(
            "kubedl_tpu_ps_pulls",
            "Shard snapshot pulls served (registration warm-starts "
            "included)",
        )
        self.ps_members = r.gauge(
            "kubedl_tpu_ps_members",
            "Workers currently registered in the aggregation group",
        )
        self.ps_shard_failovers = r.counter(
            "kubedl_tpu_ps_shard_failovers",
            "Shard ownership transfers (lease re-acquired with a bumped "
            "fencing token, state replayed from the shard WAL)",
        )
        self.ps_evictions = r.counter(
            "kubedl_tpu_ps_evictions",
            "Members removed from the aggregation group, by reason: "
            "preemption (notice — in-flight contribution committed), "
            "silent_death (watchdog — in-flight contribution discarded), "
            "departed (clean deregister)",
        )
        self.ps_push_staleness = r.histogram(
            "kubedl_tpu_ps_push_staleness_steps",
            "Aggregate-steps of staleness per accepted push (shard head "
            "version minus the worker's pulled version)",
            buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0),
        )


#: ms-scale buckets for the decode pipeline's per-tick timings (the
#: default seconds-scale buckets would dump every tick into the first one)
_TICK_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                    100.0, 250.0, 500.0)

#: TTFT spans queue wait + prefill + one harvest — ms to seconds scale
_TTFT_MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                    1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


class ServingMetrics:
    """The serving-engine metric family: decode-pipeline accounting
    (dispatch/harvest/host per-tick timings, segment + deferred-harvest
    counters, overlap ratio) plus queue depth — what `/metrics` on a
    predictor pod exports and what `LlamaEngine.stats()` summarizes."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self.segments = r.counter(
            "kubedl_tpu_serving_segments", "Decode segments dispatched"
        )
        self.deferred_harvests = r.counter(
            "kubedl_tpu_serving_deferred_harvests",
            "Segment harvests that overlapped the next in-flight segment",
        )
        self.pipeline_flushes = r.counter(
            "kubedl_tpu_serving_pipeline_flushes",
            "Segment harvests with nothing left in flight (pipeline drains)",
        )
        self.chain_rebuilds = r.counter(
            "kubedl_tpu_serving_chain_rebuilds",
            "Device token chain rebuilt from host tokens",
        )
        self.scheduler_errors = r.counter(
            "kubedl_tpu_serving_scheduler_errors",
            "Scheduler ticks that failed and were recovered",
        )
        self.dispatch_ms = r.histogram(
            "kubedl_tpu_serving_dispatch_ms",
            "Per-tick host time enqueueing prefill/segment work (ms)",
            buckets=_TICK_MS_BUCKETS,
        )
        self.harvest_ms = r.histogram(
            "kubedl_tpu_serving_harvest_ms",
            "Per-tick time blocked in device_get for sampled ids (ms)",
            buckets=_TICK_MS_BUCKETS,
        )
        self.host_ms = r.histogram(
            "kubedl_tpu_serving_host_ms",
            "Per-tick host bookkeeping time (slots/finalize/admission, ms)",
            buckets=_TICK_MS_BUCKETS,
        )
        self.overlap_ratio = r.gauge(
            "kubedl_tpu_serving_overlap_ratio",
            "Fraction of scheduler wall time overlapped with device compute",
        )
        self.queue_depth = r.gauge(
            "kubedl_tpu_serving_queue_depth", "Requests waiting for a slot"
        )
        self.shed_requests = r.counter(
            "kubedl_tpu_serving_shed_requests",
            "Requests rejected 503 by the queue-depth/age load-shedding "
            "budget (the autoscaler treats shed load as backlog)",
        )
        # prefix KV cache family (kubedl_tpu/serving/prefix_cache.py):
        # suffix-only prefill for shared-prompt traffic
        self.prefix_hits = r.counter(
            "kubedl_tpu_serving_prefix_cache_hits",
            "Admissions whose prompt matched a cached prefix (grafted KV)",
        )
        self.prefix_misses = r.counter(
            "kubedl_tpu_serving_prefix_cache_misses",
            "Admissions with no usable cached prefix",
        )
        self.prefix_inserts = r.counter(
            "kubedl_tpu_serving_prefix_cache_inserts",
            "Prefix entries stored after prefill (shared >= min_seen "
            "times, or request-tagged cacheable)",
        )
        self.prefix_evictions = r.counter(
            "kubedl_tpu_serving_prefix_cache_evictions",
            "Prefix entries LRU-evicted to stay under the byte budget",
        )
        self.prefix_tokens_saved = r.counter(
            "kubedl_tpu_serving_prefix_cache_tokens_saved",
            "Prompt tokens NOT prefilled because their KV came from the "
            "prefix cache (counted at suffix-prefill dispatch)",
        )
        self.prefix_bytes = r.gauge(
            "kubedl_tpu_serving_prefix_cache_bytes",
            "Device bytes held by prefix-cache entries (k+v payloads)",
        )
        self.prefix_entries = r.gauge(
            "kubedl_tpu_serving_prefix_cache_entries",
            "Prefix entries currently resident",
        )
        # paged KV family (kubedl_tpu/serving/kv_blocks.py): block-pool
        # occupancy — the autoscaler/router see MEMORY pressure, not
        # just queue depth
        self.kv_blocks_total = r.gauge(
            "kubedl_tpu_serving_kv_blocks_total",
            "Usable KV blocks in the paged pool (excludes the trash block)",
        )
        self.kv_blocks_free = r.gauge(
            "kubedl_tpu_serving_kv_blocks_free",
            "KV blocks on the free list",
        )
        self.kv_blocks_shared = r.gauge(
            "kubedl_tpu_serving_kv_blocks_shared",
            "KV blocks referenced by >= 2 owners (prefix sharing)",
        )
        self.kv_preemptions = r.counter(
            "kubedl_tpu_serving_kv_preemptions",
            "Decoding rows preempted-and-requeued under block exhaustion",
        )
        self.kv_block_sheds = r.counter(
            "kubedl_tpu_serving_kv_block_sheds",
            "Requests rejected 503 because free blocks fell below the "
            "low watermark (hysteresis reopens at the high watermark)",
        )
        # speculative decoding family (kubedl_tpu/serving/speculative.py)
        self.spec_proposed = r.counter(
            "kubedl_tpu_serving_spec_tokens_proposed",
            "Draft tokens proposed to verify forwards",
        )
        self.spec_accepted = r.counter(
            "kubedl_tpu_serving_spec_tokens_accepted",
            "Draft tokens accepted (agreed with the target's greedy argmax)",
        )
        self.spec_acceptance_rate = r.gauge(
            "kubedl_tpu_serving_spec_acceptance_rate",
            "Lifetime accepted/proposed draft-token ratio",
        )
        self.spec_draft_ms = r.histogram(
            "kubedl_tpu_serving_spec_draft_ms",
            "Per-round draft proposal wall time (host ngram lookup or "
            "draft-model forward), ms — labeled by draft kind so model "
            "drafts can be costed against their acceptance gain",
            buckets=_TICK_MS_BUCKETS,
        )
        # disaggregated prefill/decode family (kubedl_tpu/serving/disagg.py):
        # KV-block handoff traffic, labeled direction="export"|"adopt"
        self.handoff_total = r.counter(
            "kubedl_tpu_serving_handoff_total",
            "KV handoffs completed, by direction (export on the prefill "
            "pool, adopt on the decode pool)",
        )
        self.handoff_bytes = r.counter(
            "kubedl_tpu_serving_handoff_bytes",
            "KV payload bytes moved across the prefill->decode handoff "
            "seam, by direction",
        )
        self.handoff_ms = r.histogram(
            "kubedl_tpu_serving_handoff_ms",
            "Per-handoff wall time (export: block gather + device_get + "
            "serialize; adopt: admission + scatter into the local pool), "
            "ms, by direction",
            buckets=_TICK_MS_BUCKETS,
        )
        self.ttft_ms = r.histogram(
            "kubedl_tpu_serving_ttft_ms",
            "Per-request time to first token (admission queue + prefill "
            "+ first sampled id harvested), ms",
            buckets=_TTFT_MS_BUCKETS,
        )
        self.queue_wait_ms = r.histogram(
            "kubedl_tpu_serving_queue_wait_ms",
            "Per-request admission queue wait (enqueue -> batch row "
            "assigned), ms — the TTFT component chunked prefill bounds",
            buckets=_TTFT_MS_BUCKETS,
        )
        self.admission_chunks = r.counter(
            "kubedl_tpu_serving_admission_chunks",
            "Prefill chunk dispatches under chunked admission (one "
            "count per row per chunk, so chunks/rows ~= prompt_len / "
            "prefill_chunk_tokens)",
        )
        # controller-side replica health (the probe-failure satellite:
        # a replica that stops answering its stats probe must SURFACE,
        # not silently drop out of the QPS math)
        self.probe_failures = r.counter(
            "kubedl_tpu_serving_probe_failures",
            "Autoscaler stats-probe failures, by predictor pod",
        )
        self.replicas_not_ready = r.gauge(
            "kubedl_tpu_serving_replicas_not_ready",
            "RUNNING predictor pods whose stats probe has failed "
            "consecutively past the NotReady threshold",
        )


#: Process-wide default for the parameter-service tier (kubedl_tpu_torch/ps).
DEFAULT_PS_METRICS = PSMetrics()
