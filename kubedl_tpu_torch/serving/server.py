"""PyTorch inference server: the serving engine and its HTTP surface.

Port of ``kubedl_tpu/serving/server.py``, both KV layouts
(``kv_layout`` "paged", the default, and "contiguous"):

- GET  /healthz            -> {"status": "ok"}
- GET  /v1/models          -> model metadata
- GET  /v1/stats           -> live counters (same keys where ported)
- GET  /metrics            -> the Prometheus family (``ServingMetrics``)
- GET  /v1/trace[?trace_id=&limit=] -> {"enabled", "spans"}: this
                              replica's retained spans (one trace's)
- POST /v1/generate        -> {"prompt_ids": [...], "max_tokens": N,
                               "temperature": T, "cache_prefix": bool}
                              -> {"token_ids": [...], "latency_ms": ...}
  (``X-Trace-Context`` and ``"debug": {"trace": true}`` trace a request,
  as on /v1/prefill and /v1/adopt: the result carries ``trace_id``, and
  with debug on the request's span tree)
- POST /v1/cancel, /admin/drain
- POST /admin/load_version {"version", "ckpt_dir"}, /admin/activate_version,
  /admin/retire_version {"version"}  -> the version inventory
- POST /v1/prefill  (generate's body) -> the KVH1 handoff (octet-stream)
- POST /v1/adopt    (a KVH1 handoff)  -> generate's result

The JSON bodies are the reference's, so the unchanged router can front a
PyTorch replica. Runs as ``python -m kubedl_tpu_torch.serving.server``
or through :func:`serve_main`; the engine runs on the card unless
``device`` is ``"cpu"``.

What it serves: continuous batching over a block-table KV pool,
whole-prompt and chunked prefill, multi-step decode segments with
on-device sampling in the reference's double-buffered pipeline (segment
N is dispatched before segment N-1's ids are harvested), the prefix
cache (shared prompt prefixes kept as refcounted pool blocks, on by
default at 64 MB), draft-k / verify-1 speculative decoding
(``spec_k > 0``: n-gram, repeat, early-exit and trained zoo model
drafts, multi-candidate and tree verify), preemption under block
exhaustion, shedding, drain and cancel; the model lifecycle (weights
restored from a checkpoint in the reference's format, int8 weight-only
quantization through the W8A16 kernel, versions loaded, activated and
retired while serving) and disaggregated prefill/decode (a row's KV
blocks exported as a ``KVHandoff`` and adopted by another engine);
``serve_main`` serves a local model root or mirrors a remote one (a blob
prefix) first. The contiguous layout (a ``[L, B, max_seq, KV, hd]``
cache, rows reset at admission, prefix entries as K/V copies, the plain
model functions' dense attention) serves the same tick and prefix
cache; speculation, hot swap and the disaggregated roles' handoffs need
the paged layout and raise there, as in the reference. ``mesh_axes``
serves over a mesh, as the reference's target of Gemma-2B on four chips
does: the weights are cut over the mesh's ranks
(``models/llama.py::ServingSplit``, the ranks in this one process,
``parallel/mesh.py::ServingMesh``) and the engine keeps the contiguous
layout with no speculation (the reference's normalization).

Observability and faults, as in the reference: the Prometheus family
(``metrics=``, default a fresh :class:`ServingMetrics`; the per-tick
pipeline fold in :meth:`LlamaEngine._commit_tick`), request tracing
(``TRACER`` spans ``engine.*`` under the caller's ``X-Trace-Context``)
and the six ``serving.*`` chaos sites, with ``serve_main`` arming
``KUBEDL_SERVE_CONFIG["chaos"]``. No metric reads a device value: the
tick stays free of syncs.

The host pos/bt mirrors stay authoritative and are uploaded (copied,
never shared with numpy) before every dispatch, through pinned staging
buffers so that no upload syncs the stream.
"""

from __future__ import annotations

import json
import logging
import math
import os
import statistics
import threading
import time
import urllib.parse
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

from kubedl_tpu_torch import chaos, resolve_device
from kubedl_tpu_torch.api.topology import MeshSpec
from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.models import paged_attention
from kubedl_tpu_torch.observability.metrics import ServingMetrics
from kubedl_tpu_torch.observability.tracing import (
    TRACE_HEADER, TRACER, TraceContext, new_span_id, new_trace_id,
    parse_trace_header, span_to_dict,
)
from kubedl_tpu_torch.parallel.mesh import ServingMesh
from kubedl_tpu_torch.remote.client import download_tree, is_remote_root
from kubedl_tpu_torch.serving.disagg import HandoffError, KVHandoff
from kubedl_tpu_torch.serving.kv_blocks import BlockAllocator
from kubedl_tpu_torch.serving.prefix_cache import PrefixCache
from kubedl_tpu_torch.serving.router_policy import prefix_digest
from kubedl_tpu_torch.serving.speculative import (
    ModelDraft, SpecStats, accept_length, build_tree, make_draft,
)
from kubedl_tpu_torch.training import checkpoint

log = logging.getLogger("kubedl_tpu_torch.serving.server")


class EngineOverloaded(Exception):
    """Queue-depth/age or KV budget exceeded — callers get 503 +
    Retry-After. ``reason`` is "overloaded" (come back after Retry-After)
    or "draining" (this replica is going away: fail over now)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0,
                 reason: str = "overloaded") -> None:
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.reason = reason


class UnknownModelVersion(ValueError):
    """A request named a model version this engine has not loaded — a
    client/config error (400), not overload."""


class _Slot:
    """One in-flight sequence occupying a batch row."""

    def __init__(self, prompt, max_tokens: int, temperature: float,
                 cache_prefix: bool = False, request_id: str = "") -> None:
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.cache_prefix = cache_prefix  # request opted into insertion
        self.request_id = request_id  # non-empty: cancellable via cancel()
        self.fed = 0  # inputs consumed (prompt + generated)
        self.pending = 0  # tokens dispatched on the device, not harvested
        self.cached_len = 0  # prompt tokens grafted from the prefix cache
        #: chunked-prefill progress: prompt tokens whose KV is committed
        #: (grafted prefix + dispatched chunks); -1 = chunking not started
        self.prefill_pos = -1
        self.pinned = None  # PrefixEntry pinned while this row uses it
        self.version = ""
        #: prefill-role slot: ``{"max_tokens": N}``, the decode budget the
        #: handoff carries (the row itself stops after its first token)
        self.handoff: Optional[Dict] = None
        #: decode-role slot: the ``KVHandoff`` it resumes from
        self.adopt: Optional[KVHandoff] = None
        self.ttft_ms: Optional[float] = None
        self.out_ids: list = []
        #: tracing: ``trace`` is the caller's context (X-Trace-Context);
        #: ``span_id`` is this request's PRE-MINTED engine.request id, so
        #: sub-spans recorded before the request span can parent under it
        self.trace: Optional[TraceContext] = None
        self.span_id = ""
        self.prefill_t0: Optional[float] = None
        self.done = threading.Event()
        self.result: Optional[Dict] = None
        self.t0 = time.perf_counter()

    def next_input(self) -> int:
        seq = self.prompt + self.out_ids
        return int(seq[self.fed])


def _host_payload(t: torch.Tensor):
    """A host tensor as a handoff payload: ``(numpy array, dtype name)``,
    bf16 as its uint16 bits named "bfloat16" (the KVH1 wire's dtype)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), ""


def _payload_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A handoff payload as a host tensor (the inverse of
    :func:`_host_payload`)."""
    a = np.ascontiguousarray(arr)
    if not a.flags.writeable:  # a view of the wire bytes
        a = a.copy()
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _pct(vals, q: float) -> float:
    srt = sorted(vals)
    return round(srt[min(len(srt) - 1, int(len(srt) * q))], 3)


class _Copy:
    """A device-to-host copy in flight: :meth:`wait` blocks on its event
    and returns an owned numpy array, then frees the pinned buffer."""

    def __init__(self, entry, event) -> None:
        self._entry = entry
        self._event = event

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        out = self._entry[0].numpy().copy()
        self.discard()
        return out

    def discard(self) -> None:
        """Release the buffer unread; it is reused only once its event
        shows the copy done."""
        self._entry[2] = False


class _Staging:
    """Pinned host buffers for the engine's host<->device copies, so that
    neither direction syncs the stream (a copy from pageable memory
    does). Each buffer carries the event of its last copy and is reused
    only once that event shows the copy done (and, for a download, once
    the host has read it). On the CPU, uploads are owned copies and
    downloads are immediate."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.cuda = device.type == "cuda"
        self._rings: Dict[tuple, list] = {}  # key -> [[buf, event, held]]

    def _acquire(self, shape, dtype) -> list:
        ring = self._rings.setdefault((tuple(shape), dtype), [])
        for entry in ring:
            if not entry[2] and (entry[1] is None or entry[1].query()):
                entry[2] = True
                return entry
        entry = [torch.empty(tuple(shape), dtype=dtype, pin_memory=True),
                 None, True]
        ring.append(entry)
        return entry

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        """A device-OWNED copy of ``arr`` (later edits of the host array
        do not reach it), copied without a stream sync."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if not self.cuda:
            return src.clone()
        entry = self._acquire(src.shape, src.dtype)
        entry[0].copy_(src)
        out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        out.copy_(entry[0], non_blocking=True)
        entry[1] = torch.cuda.Event()
        entry[1].record()
        entry[2] = False
        return out

    def download(self, t: torch.Tensor) -> _Copy:
        """Start copying ``t`` to the host; the stream is not synced."""
        if not self.cuda:
            return _Copy([t.detach().clone(), None, True], None)
        entry = self._acquire(t.shape, t.dtype)
        entry[0].copy_(t, non_blocking=True)
        entry[1] = torch.cuda.Event()
        entry[1].record()
        return _Copy(entry, entry[1])


class LlamaEngine:
    """Continuous-batching decode engine over a paged KV pool: up to
    ``max_batch`` sequences share each forward, a scheduler thread admits
    waiting requests into free rows between ticks, prefill runs whole
    prompts (or ``prefill_chunk_tokens``-sized chunks) and decode runs in
    multi-step segments with on-device sampling — only sampled ids cross
    to the host, once per segment, a tick later (the double-buffered
    pipeline of :meth:`_loop_once`).

    ``kv_attention`` picks the attention implementation of the paged
    forwards: ``"gather"`` (the dense oracle over the gathered view) or
    ``"blocked"`` (the Hopper kernels on the card: the fused decode
    kernel every decode step, the blocked kernel every prefill chunk,
    grafted-suffix prefill and speculative verify). ``prefix_cache_mb >
    0`` keeps shared prompt prefixes as refcounted pool blocks
    (:mod:`~kubedl_tpu_torch.serving.prefix_cache`); ``spec_k > 0``
    decodes greedy rows by draft-k / verify-1 speculation
    (:mod:`~kubedl_tpu_torch.serving.speculative`). ``ckpt_dir`` restores
    the weights from a checkpoint (the reference's format, see
    :mod:`~kubedl_tpu_torch.training.checkpoint`) over the seeded random
    init; ``quantize="int8"`` serves weight-only int8 through the W8A16
    kernel. ``params`` serves a given parameter tree (e.g. one carried
    over with ``llama.params_from_numpy``) instead of the init and the
    restore. ``role`` (prefill / decode / colocated) is advisory, as in
    the reference: every engine serves ``generate``,
    :meth:`prefill_handoff` and :meth:`adopt_handoff`. As in the
    reference, a non-zero ``batch`` takes the place of ``max_batch``, and
    ``kv_low_watermark`` / ``kv_high_watermark`` are the block
    allocator's admission watermarks (kept when a failed tick rebuilds
    it). ``kv_layout="contiguous"`` keeps a ``[L, B, max_seq, KV, hd]``
    cache instead of the pool (no allocator, whole-prompt prefill, the
    dense attention, prefix entries as K/V copies), as the reference's
    contiguous engine; speculation, hot swap and the handoffs raise
    there. ``mesh_axes`` (``{"tensor": 4}``, say) serves over a mesh of
    that many ranks in this process, rank r on ``cuda:(r mod
    device_count)`` (or the CPU): each rank holds its shards of the
    weights (``ServingSplit``, cut as each leaf lands), the tensor ranks
    compute and hold their KV heads' cache, and a paged layout becomes
    contiguous with ``spec_k`` 0, as in the reference; ``stats()["mesh"]``
    says each rank's device, weight bytes and KV bytes. ``metrics`` is
    the engine's :class:`ServingMetrics` (a fresh one by default; a
    caller may pass one to share its registry), as in the reference."""

    #: allowed decode-segment sizes, largest first; segments shrink to 4
    #: whenever requests are waiting (admission latency <= 4 tokens)
    SEGMENT_BUCKETS = (32, 4, 1)

    def __init__(self, preset: str = "tiny", ckpt_dir: str = "",
                 batch: int = 0, max_seq: int = 0, max_batch: int = 4,
                 quantize: str = "", mesh_axes: Optional[Dict] = None,
                 metrics=None,
                 max_queue_depth: int = 64, max_queue_age_s: float = 30.0,
                 prefix_cache_mb: float = 64.0,
                 prefix_min_len: int = 8,
                 kv_layout: str = "paged", kv_block_size: int = 16,
                 kv_blocks: int = 0, kv_low_watermark: float = 0.05,
                 kv_high_watermark: float = 0.15, spec_k: int = 0,
                 spec_draft: str = "ngram",
                 kv_attention: str = "gather",
                 spec_candidates: int = 1,
                 spec_draft_layers: int = 0,
                 spec_tree: bool = False,
                 prefill_chunk_tokens: int = 0,
                 role: str = "colocated",
                 advertise_prefix_len: int = 8,
                 handoff_ttl_s: float = 30.0,
                 model_version: str = "base",
                 device=None, seed: int = 0,
                 params: Optional[Dict] = None) -> None:
        if kv_layout not in ("paged", "contiguous"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if role not in ("", "colocated", "prefill", "decode"):
            raise ValueError(
                f"unknown serving role {role!r} "
                "(have: colocated, prefill, decode)"
            )
        if kv_attention not in ("gather", "blocked"):
            raise ValueError(
                f"unknown kv_attention {kv_attention!r} "
                "(have: gather, blocked)"
            )
        if quantize and quantize != "int8":
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if mesh_axes and kv_layout == "paged":
            # the reference's normalization: mesh serving keeps the
            # contiguous layout (the paged gather reorders attention's
            # reductions under the row-parallel sums) and so no
            # speculation; an explicit contiguous layout with spec_k
            # raises below
            kv_layout = "contiguous"
            spec_k = 0
        self.quantize = quantize
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        self.spec_k = max(0, int(spec_k))
        self.spec_draft = str(spec_draft)
        if self.spec_k and not self._paged:
            raise ValueError(
                "speculative decoding requires kv_layout='paged' (the "
                "verify rollback frees rejected-suffix blocks in place)"
            )
        if self.spec_k and self.spec_draft != "model" \
                and not self.spec_draft.startswith("zoo:"):
            make_draft(self.spec_draft)  # unknown names raise here
        self.spec_candidates = max(1, int(spec_candidates))
        #: tree speculation needs multi-candidate speculation to mean
        #: anything: off otherwise (the reference's normalization)
        self.spec_tree = (bool(spec_tree) and self.spec_k > 0
                          and self.spec_candidates > 1)
        self.device = resolve_device(device)
        #: fleet role, ADVISORY (the reference's): a prefill/decode engine
        #: still serves the full generate path; the role tells the router
        #: how to partition dispatch
        self.role = role or "colocated"
        self.preset_name = preset
        self.handoff_ttl_s = float(handoff_ttl_s)
        #: the paged forwards' attention; contiguous engines run the plain
        #: model functions' dense attention (the reference's normalization)
        self.kv_attention = kv_attention if self._paged else "gather"
        self.advertise_prefix_len = int(advertise_prefix_len)
        self.cfg = llama.preset(preset)
        #: the serving mesh and the contiguous functions' split over it
        #: (None: one device)
        self.mesh: Optional[ServingMesh] = None
        self._split: Optional[llama.ServingSplit] = None
        if mesh_axes:
            self.mesh = ServingMesh(MeshSpec(
                {k: int(v) for k, v in mesh_axes.items()}), self.device)
            self._split = llama.ServingSplit(self.cfg, self.mesh)
            self.device = self._split.lead
            log.info("serving over mesh %s", dict(mesh_axes))
        self.max_seq = max_seq or min(self.cfg.max_seq, 512)
        self.max_batch = batch or max_batch
        bs = max(1, int(kv_block_size))
        self.kv_block_size = bs
        if self._paged:
            # the gathered view is [B, MB * BS]: max_seq rounds UP to
            # whole blocks
            self.max_seq = ((self.max_seq + bs - 1) // bs) * bs
        pct = max(0, int(prefill_chunk_tokens))
        #: chunked prefill: > 0 caps the prompt tokens one tick prefills,
        #: block-aligned so no KV block is written by two dispatches.
        #: Paged only, as in the reference (a contiguous engine prefills
        #: whole prompts)
        self.prefill_chunk_tokens = (
            max(bs, (pct // bs) * bs) if pct and self._paged else 0
        )
        self._default_version = str(model_version) or "base"
        self._seed = int(seed)
        if params is None:
            params = self._build_params(ckpt_dir)
        else:
            if self.quantize == "int8" and not llama.is_quantized(
                    params["embed"]):
                params = llama.quantize_params(params, self.cfg)
            if self._split is not None:
                params = self._split.shard(params)
        self.params = params
        self._versions: Dict[str, object] = {self._default_version: params}
        #: each loaded tree's prefix-cache tag: a negative id that no token
        #: takes, new at every load, put before the prompt in the cache's
        #: keys so that no request grafts KV another tree computed
        self._version_tags: Dict[str, int] = {self._default_version: -1}
        self._next_tag = -2
        #: versions fenced from new requests, evicted once drained
        self._retiring: set = set()
        self._vers_rr = 0
        mb = self.max_seq // bs
        #: bytes one block holds across both pools and all layers — the
        #: unit the prefix cache's budget is charged in
        self._block_bytes = int(
            2 * self.cfg.n_layers * bs * self.cfg.n_kv_heads
            * self.cfg.head_dim
            * torch.tensor([], dtype=self.cfg.dtype).element_size()
        )
        if not self._paged:
            nb = 0
        elif kv_blocks:
            nb = int(kv_blocks)
            if nb < mb + 1:
                raise ValueError(
                    f"kv_blocks={nb} cannot hold one max_seq row "
                    f"({mb} blocks + trash)"
                )
        else:
            # parity sizing: every batch row can reach max_seq, plus
            # headroom for prefix-cache entries capped at one batch's worth
            prefix_blocks = 0
            if prefix_cache_mb > 0:
                prefix_blocks = min(
                    math.ceil(prefix_cache_mb * 1e6 / self._block_bytes),
                    self.max_batch * mb,
                )
            nb = 1 + self.max_batch * mb + prefix_blocks
        self.kv_blocks = nb
        #: the allocator's admission watermarks, kept for its rebuilds
        self._kv_watermarks = dict(low_watermark=kv_low_watermark,
                                   high_watermark=kv_high_watermark)
        #: host-authoritative mirrors of the paged cache's pos/bt —
        #: uploaded (copied) before EVERY dispatch, so rollbacks
        #: (speculative rejection, preemption, vacation) are mirror edits.
        #: A contiguous cache keeps its pos on the device (rows are reset
        #: at admission) and has no allocator.
        self._pos_host = np.zeros((self.max_batch,), np.int32)
        self._bt_host = np.zeros((self.max_batch, mb), np.int32)
        self._row_blocks: list = [[] for _ in range(self.max_batch)]
        self._alloc: Optional[BlockAllocator] = None
        self._cache = self._new_cache()
        #: pinned staging for every host<->device copy (no stream syncs)
        self._staging = _Staging(self.device)
        if self.spec_k:
            if self.spec_draft == "model":
                # early-exit draft carved out of the target's own stacked
                # weights (views, no copies); depth defaults to half
                n_draft = int(spec_draft_layers) or max(
                    1, self.cfg.n_layers // 2)
                self._draft = ModelDraft.from_target(
                    self.params, self.cfg, n_layers=n_draft,
                    max_context=self.max_seq,
                )
            elif self.spec_draft.startswith("zoo:"):
                # a trained small draft shaped by the planner's model zoo;
                # KUBEDL_SPEC_DRAFT_CKPT restores weights saved after
                # distillation (fresh weights propose noise: harmless,
                # just no acceptance)
                ckpt = os.environ.get("KUBEDL_SPEC_DRAFT_CKPT", "")
                self._draft = ModelDraft.from_zoo(
                    self.spec_draft.split(":", 1)[1], self.cfg,
                    ckpt_path=ckpt or None, max_context=self.max_seq,
                    device=self.device,
                )
            else:
                self._draft = make_draft(self.spec_draft)
            self._spec_stats: Optional[SpecStats] = SpecStats()
            #: fixed trie node budget of tree verify
            self._spec_tree_m = 1 + self.spec_candidates * self.spec_k
        else:
            self._draft = None
            self._spec_stats = None
        #: sampling noise: one explicit generator on the engine's device
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        #: running count of non-finite logits (device scalar, no host sync)
        self._nonfinite = torch.zeros((), dtype=torch.int64, device=self.device)
        self._slots: list = [None] * self.max_batch
        self._waiting: "deque[_Slot]" = deque()
        self._cv = threading.Condition()
        #: device-resident prefix KV cache: admission shares the longest
        #: cached prefix's blocks and prefills only the suffix; entries
        #: hold block REFERENCES, which eviction hands back to the
        #: allocator. 0 MB disables it.
        self._pcache: Optional[PrefixCache] = (
            PrefixCache(int(prefix_cache_mb * 1e6), min_len=prefix_min_len,
                        on_evict=(self._paged_entry_evicted if self._paged
                                  else None))
            if prefix_cache_mb > 0 else None
        )
        self._stop = False
        self._draining = False
        self._requests: Dict[str, _Slot] = {}
        #: device-chained feed between segments: (prefill_gen, rows, last
        #: ids [B, 1] on the device), ``rows`` being the rows whose device
        #: token is current; a prefill MERGES its sampled first ids in, so
        #: the next segment's inputs never leave the device
        self._chain: Optional[tuple] = None
        self._prefill_gen = 0
        #: device copy of the per-row temperatures, re-uploaded only when
        #: they change
        self._temps_cache: Optional[tuple] = None
        #: the deferred in-flight decode segment (double buffering):
        #: dispatched one tick, harvested the next
        self._pending: Optional[Dict] = None
        self._stats = {"requests": 0, "tokens_out": 0, "tokens_in": 0,
                       "shed": 0, "drain_rejects": 0,
                       "kv_preemptions": 0, "kv_sheds": 0,
                       "handoffs_out": 0, "handoffs_in": 0,
                       "handoff_failures": 0,
                       "started_at": time.time()}
        #: prefill-role handoffs parked until fetched (or the TTL), each
        #: holding its own references on the row's blocks
        self._handoffs: Dict[str, Dict] = {}
        #: fetch requests for the scheduler thread: (hid, box, event)
        self._export_q: "deque[tuple]" = deque()
        #: exports whose device-to-host copies are in flight
        self._exports: list = []
        #: per-tick pipeline accounting (the reference's keys) plus the
        #: port's decode counters: ``decode_ms_sum`` is each segment's
        #: stream time (CUDA events from its first launch to its last; on
        #: the CPU, where ops run as they are called, its dispatch time)
        self._pipe = {
            "ticks": 0, "segments": 0, "deferred_harvests": 0,
            "flushes": 0, "chain_rebuilds": 0, "errors": 0, "inflight": 0,
            "dispatch_ms_sum": 0.0, "harvest_ms_sum": 0.0,
            "host_ms_sum": 0.0, "tick_ms_sum": 0.0, "overlap_ms_sum": 0.0,
            "prefills": 0, "prefill_chunks": 0, "decode_steps": 0,
            "decode_tokens": 0, "decode_ms_sum": 0.0,
            "spec_rounds": 0, "spec_ms_sum": 0.0, "verify_ms_sum": 0.0,
        }
        self._pipe_recent: "deque[tuple]" = deque(maxlen=2048)
        self.metrics = metrics or ServingMetrics()
        self._prefix_evictions_seen = 0  # metric delta vs pcache stats
        self.max_queue_depth = max(1, int(max_queue_depth))
        self.max_queue_age_s = float(max_queue_age_s)
        self._recent: "deque[float]" = deque(maxlen=100_000)
        self._shed_recent: "deque[float]" = deque(maxlen=100_000)
        self._ttft_recent: "deque[float]" = deque(maxlen=4096)
        self._queue_wait_recent: "deque[float]" = deque(maxlen=4096)
        self.qps_window_s = 60.0
        self._warmup()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="decode-scheduler"
        )
        self._thread.start()

    # -- lifecycle ---------------------------------------------------------

    def _new_cache(self) -> Dict:
        """A fresh device cache of this engine's layout (and, paged, a
        fresh block allocator: every block is free again)."""
        if not self._paged:
            return llama.init_batched_cache(self.cfg, self.max_batch,
                                            self.max_seq, self.device,
                                            split=self._split)
        self._alloc = BlockAllocator(self.kv_blocks, self.kv_block_size,
                                     **self._kv_watermarks)
        return llama.init_paged_cache(
            self.cfg, self.max_batch, self.max_seq, self.kv_blocks,
            self.kv_block_size, self.device)

    @torch.no_grad()
    def _warmup(self) -> None:
        """One decode step over vacant rows before the first request:
        builds the kernels and warms the allocator. Paged, every write
        lands in the trash block and the host mirrors stay authoritative;
        contiguous, the rows' positions go back to 0 (admission resets
        them anyway)."""
        tokens = torch.zeros((self.max_batch, 1), dtype=torch.int32,
                             device=self.device)
        if self._paged:
            logits, self._cache = llama.paged_decode_step_batched(
                self.params, self._cache, tokens, self.cfg,
                kv_attention=self.kv_attention,
            )
        else:
            logits, self._cache = llama.decode_step_batched(
                self.params, self._cache, tokens, self.cfg, self._split)
            self._cache["pos"].zero_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30)

    def drain(self, wait: bool = False, timeout_s: float = 30.0) -> bool:
        """Stop ADMISSION, not work: new requests get a 503 with reason
        "draining" while queued/in-flight requests run to completion."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        if wait:
            return self.wait_drained(timeout_s)
        return True

    def wait_drained(self, timeout_s: float = 30.0) -> bool:
        deadline = time.perf_counter() + timeout_s
        while True:
            with self._cv:
                idle = not self._waiting and all(
                    s is None for s in self._slots
                )
            if idle:
                return True
            if time.perf_counter() >= deadline:
                return False
            time.sleep(0.01)

    @property
    def draining(self) -> bool:
        return self._draining

    # -- the parameter pipeline and versions (hot swap) -------------------

    def _build_params(self, ckpt_dir: str, require_ckpt: bool = False):
        """One servable parameter tree, end to end: checkpoint restore (or
        the seeded random init) and int8 quantization. It runs off the
        dispatch path (at init or in a hot-swap load) and commits nothing:
        a failure leaves every serving version untouched. The restore
        fills a ``meta`` tree leaf by leaf on the device, quantizing each
        leaf as it lands, so the float tree is never held twice; on a
        mesh each leaf is then cut into the ranks' shards (the
        reference's restore -> int8 -> shard order, a leaf at a time), as
        is each leaf of the random init as it is drawn.

        ``require_ckpt`` (hot-swap loads): a version whose artifact is
        missing or torn beyond recovery fails the load — random weights
        under a version id would be a silent model swap. Init keeps the
        reference's permissive behaviour: no checkpoint serves the init.
        The chaos site ``serving.weight_swap`` fires at the top, so an
        injected torn artifact or mid-swap crash tests that contract."""
        chaos.check("serving.weight_swap")
        int8 = self.quantize == "int8"
        split = self._split
        sink = split.sink(int8) if split is not None else None
        step = checkpoint.latest_step(ckpt_dir) if ckpt_dir else None
        if require_ckpt and step is None:
            raise ValueError(f"no checkpoint found under {ckpt_dir!r}")
        if step is not None:
            leaf_fn = llama.quantize_leaf_at if int8 else None
            if sink is not None:
                def leaf_fn(key, t):
                    return sink.local(llama.leaf_path(key), t)
            state = checkpoint.restore_checkpoint(
                ckpt_dir, {"params": llama.param_like(self.cfg)},
                device=self.device, leaf_fn=leaf_fn,
            )
            if state is not None:
                log.info("restored checkpoint from %s", ckpt_dir)
                params = state["params"]
                return params if split is None else split.ranks_of(params)
            if require_ckpt:
                raise ValueError(
                    f"no complete checkpoint step under {ckpt_dir!r} "
                    "(every step torn/incomplete)"
                )
        gen = torch.Generator(device=self.device).manual_seed(self._seed)
        if split is not None:
            return split.ranks_of(llama.llama_init(
                self.cfg, gen, self.device, shard=sink))
        params = llama.llama_init(self.cfg, gen, self.device)
        if int8:
            params = llama.quantize_params(params, self.cfg)
        return params

    def load_version(self, version: str, ckpt_dir: str) -> None:
        """Load another parameter tree beside the serving ones with no
        downtime: the build runs on the caller's thread and only a whole
        restored (and quantized) tree is committed, under the lock. A
        failed load raises and the loaded versions keep serving.
        Idempotent for a loaded version. Paged only, as in the reference."""
        if not self._paged:
            raise ValueError(
                "weight hot-swap requires kv_layout='paged' (per-row "
                "block isolation is what lets rows of the other version "
                "sit a dispatch out safely)"
            )
        version = str(version)
        if not version:
            raise ValueError("model version id must be non-empty")
        with self._cv:
            if version in self._retiring:
                raise ValueError(
                    f"version {version!r} is retiring; wait for eviction "
                    "before reloading it"
                )
            if version in self._versions:
                return
        params = self._build_params(ckpt_dir, require_ckpt=True)
        with self._cv:
            self._versions[version] = params
            self._version_tags[version] = self._next_tag
            self._next_tag -= 1
        log.info("hot-loaded model version %r from %s", version, ckpt_dir)

    def activate_version(self, version: str) -> str:
        """Make a loaded version the default for requests that name none.
        Returns the previous default."""
        version = str(version)
        with self._cv:
            if version not in self._versions or version in self._retiring:
                raise UnknownModelVersion(
                    f"cannot activate {version!r} "
                    f"(loaded: {sorted(self._versions)})"
                )
            prev, self._default_version = self._default_version, version
            self.params = self._versions[version]
        log.info("activated model version %r (was %r)", version, prev)
        return prev

    def retire_version(self, version: str) -> bool:
        """Fence a version from new requests and evict its tree once the
        last row or queued request naming it drains, never mid-flight.
        The default version cannot retire (activate another first).
        Returns False for a version that was never loaded."""
        version = str(version)
        with self._cv:
            if version == self._default_version:
                raise ValueError(
                    f"cannot retire the default version {version!r}; "
                    "activate another version first"
                )
            if version not in self._versions:
                return False
            self._retiring.add(version)
            self._maybe_evict_versions_locked()
        return True

    def versions(self) -> Dict:
        """The live version inventory (/v1/models, stats())."""
        with self._cv:
            rows: Dict[str, int] = {}
            for s in self._slots:
                if s is not None:
                    v = s.version or self._default_version
                    rows[v] = rows.get(v, 0) + 1
            return {
                "default": self._default_version,
                "loaded": sorted(self._versions),
                "retiring": sorted(self._retiring),
                "active_rows": rows,
            }

    def _resolve_version_locked(self, requested: str) -> str:
        """Admission-gate resolution: "" is the default; anything else
        must be a loaded, non-retiring version. Caller holds cv."""
        v = str(requested or "") or self._default_version
        if v not in self._versions or v in self._retiring:
            raise UnknownModelVersion(
                f"unknown or retiring model version {v!r} "
                f"(loaded: {sorted(set(self._versions) - self._retiring)})"
            )
        return v

    def _version_refs_locked(self, version: str) -> int:
        n = sum(
            1 for s in self._slots
            if s is not None and (s.version or self._default_version) == version
        )
        n += sum(
            1 for s in self._waiting
            if (s.version or self._default_version) == version
        )
        return n

    def _maybe_evict_versions_locked(self) -> None:
        """Drop retiring trees whose last referencing row or queue entry
        is gone (drain, then evict). Hooked into admission, which follows
        every row free. Caller holds cv."""
        for v in list(self._retiring):
            if v == self._default_version:
                continue
            if self._version_refs_locked(v) == 0:
                self._versions.pop(v, None)
                self._version_tags.pop(v, None)
                self._retiring.discard(v)
                log.info("evicted retired model version %r", v)

    def _pick_tick_version_locked(self, active) -> str:
        """One version per tick: a dispatch (prefill group, decode
        segment, spec round) never mixes parameter trees. With versions
        co-resident the tick alternates round-robin over those with live
        rows; rows of the others sit the tick out, which is safe because
        the host pos/bt mirrors are authoritative (uploaded before every
        dispatch, so the skipped steps never happened for them) and their
        device chain token is kept (see :meth:`_loop_once`). Caller holds
        cv."""
        vers = sorted({
            (s.version or self._default_version)
            for s in active if s is not None
        })
        if not vers:
            return self._default_version
        if len(vers) == 1:
            return vers[0]
        self._vers_rr = (self._vers_rr + 1) % len(vers)
        return vers[self._vers_rr]

    # -- request path ------------------------------------------------------

    def cancel(self, request_id: str) -> bool:
        """Cancel a request by id: a queued request leaves the queue, an
        in-flight one has its row vacated. Returns False for unknown or
        finished ids."""
        with self._cv:
            slot = self._requests.pop(request_id, None)
            if slot is None or slot.done.is_set():
                return False
            if slot in self._waiting:
                self._waiting.remove(slot)
            self._vacate_locked(slot)
            slot.result = {"error": "cancelled", "cancelled": True}
            slot.done.set()
            self._cv.notify_all()
        return True

    def _vacate_locked(self, slot: _Slot) -> None:
        for i, s in enumerate(self._slots):
            if s is slot:
                self._slots[i] = None
                self._free_row_locked(i)
        # a vacated row must not keep its prefix-cache entry pinned
        self._release_prefix_locked(slot)

    # -- request tracing ----------------------------------------------------

    @staticmethod
    def _arm_trace(slot: _Slot, trace: Optional[TraceContext],
                   debug_trace: bool = False) -> None:
        """Give a slot span identity: the caller sent a context, or asked
        for a flight recording without one (a fresh trace then roots the
        recording). A disarmed tracer leaves the slot untraced: every
        scheduler-side record guards on ``slot.span_id``."""
        if not TRACER.enabled:
            return
        if trace is None and debug_trace:
            trace = TraceContext(new_trace_id(), "")
        if trace is not None:
            slot.trace = trace
            slot.span_id = new_span_id()

    def _trace_admitted_locked(self, s: _Slot, t_adm: float,
                               row: int) -> None:
        """Queue wait (enqueue -> admission start): the stats() sample and
        the metric for EVERY admission, plus the engine.queue_wait /
        engine.admission spans when the request is traced. Caller holds
        cv."""
        wait_ms = (t_adm - s.t0) * 1e3
        self._queue_wait_recent.append(wait_ms)
        self.metrics.queue_wait_ms.observe(wait_ms)
        if not s.span_id:
            return
        now = time.perf_counter()
        TRACER.record("engine.queue_wait", start=s.t0,
                      duration=t_adm - s.t0, trace=s.trace,
                      parent_id=s.span_id)
        TRACER.record("engine.admission", start=t_adm,
                      duration=now - t_adm, trace=s.trace,
                      parent_id=s.span_id, row=row)

    def _trace_request_locked(self, s: _Slot, kind: str) -> None:
        """Close the request span (its id minted at arm time) BEFORE the
        waiter wakes, so a read right after ``done`` sees the whole tree.
        Caller holds cv."""
        if s.span_id:
            TRACER.record("engine.request", start=s.t0,
                          duration=time.perf_counter() - s.t0,
                          trace=s.trace, span_id=s.span_id, kind=kind,
                          tokens=len(s.out_ids))

    @staticmethod
    def _trace_result(slot: _Slot, result: Dict,
                      debug_trace: bool) -> Dict:
        """Stamp the trace id on a finished result; with the flight
        recorder on, attach the request's own span tree."""
        if slot.span_id and slot.trace is not None:
            tid = slot.trace.trace_id
            result.setdefault("trace_id", tid)
            if debug_trace:
                result["trace"] = {
                    "trace_id": tid,
                    "spans": TRACER.span_tree(tid),
                }
        return result

    def generate(self, prompt_ids, max_tokens: int = 16,
                 temperature: float = 0.0, timeout_s: float = 600.0,
                 cache_prefix: bool = False, request_id: str = "",
                 trace: Optional[TraceContext] = None,
                 debug_trace: bool = False,
                 model_version: str = "") -> Dict:
        budget = self.max_seq - 1
        prompt = [int(t) for t in list(prompt_ids)[:budget]]
        if not prompt:
            prompt = [0]
        max_tokens = max(0, min(int(max_tokens), budget - len(prompt)))
        slot = _Slot(prompt, max_tokens, float(temperature),
                     bool(cache_prefix), request_id=request_id)
        slot.version = str(model_version or "")
        self._arm_trace(slot, trace, debug_trace)
        self._enqueue_slot_locked_checks(slot)
        result = self._await_slot(slot, timeout_s)
        with self._cv:
            if request_id:
                self._requests.pop(request_id, None)
            self._stats["requests"] += 1
            self._stats["tokens_in"] += len(prompt)
            self._stats["tokens_out"] += len(result.get("token_ids", []))
            self._recent.append(time.time())
        return self._trace_result(slot, result, debug_trace)

    def _enqueue_slot_locked_checks(self, slot: _Slot) -> None:
        """The admission gate generate(), prefill_handoff() and
        adopt_handoff() share: the slot's version (``slot.version`` holds
        the requested id on entry; unknown or retiring is a 400, not a
        503), drain rejection, queue depth / age shedding and the KV
        watermark, then the queue."""
        with self._cv:
            slot.version = self._resolve_version_locked(slot.version)
            if self._draining:
                self._stats["drain_rejects"] += 1
                raise EngineOverloaded("engine is draining",
                                       retry_after_s=1.0, reason="draining")
            depth = len(self._waiting)
            head_age = (time.perf_counter() - self._waiting[0].t0
                        if self._waiting else 0.0)
            if depth >= self.max_queue_depth or head_age > self.max_queue_age_s:
                self._stats["shed"] += 1
                self._shed_recent.append(time.time())
                self.metrics.shed_requests.inc()
                retry = max(1.0, min(self.max_queue_age_s, 0.25 * depth))
                raise EngineOverloaded(
                    f"queue depth {depth} (budget {self.max_queue_depth}), "
                    f"head age {head_age:.1f}s (budget {self.max_queue_age_s}s)",
                    retry_after_s=retry,
                )
            if self._paged and not self._alloc.admission_open():
                # KV-pool pressure: below the low watermark a queued
                # request cannot be admitted anyway — reject at the door
                self._stats["shed"] += 1
                self._stats["kv_sheds"] += 1
                self._shed_recent.append(time.time())
                self.metrics.shed_requests.inc()
                self.metrics.kv_block_sheds.inc()
                raise EngineOverloaded(
                    f"free KV blocks {self._alloc.free_count}/"
                    f"{self._alloc.total} below low watermark",
                    retry_after_s=1.0,
                )
            self._waiting.append(slot)
            if slot.request_id:
                self._requests[slot.request_id] = slot
            self._cv.notify_all()

    def _await_slot(self, slot: _Slot, timeout_s: float) -> Dict:
        """Wait for a queued slot's result; an abandoned request must not
        keep its queue place or batch row."""
        if not slot.done.wait(timeout=timeout_s):
            with self._cv:
                if slot in self._waiting:
                    self._waiting.remove(slot)
                self._vacate_locked(slot)
        return slot.result or {"error": "timed out", "timed_out": True}

    # -- disaggregated prefill/decode --------------------------------------

    def _finalize_handoff_locked(self, i: int, s: _Slot) -> None:
        """Park row ``i``'s blocks under a fresh handoff id: the handoff
        takes its OWN reference on every block, so the row frees as
        usual and the blocks stay alive until a fetch exports them (or the
        TTL gives up on the transfer). Caller holds cv."""
        import uuid

        hid = uuid.uuid4().hex
        blocks = list(self._row_blocks[i])
        self._alloc.incref(blocks)
        self._handoffs[hid] = {
            "blocks": blocks,
            "pos": int(self._pos_host[i]),
            "prompt": list(s.prompt),
            "first_token": int(s.out_ids[0]),
            "max_tokens": int(s.handoff["max_tokens"]),
            "temperature": float(s.temperature),
            "cache_prefix": bool(s.cache_prefix),
            "request_id": s.request_id,
            "ttft_ms": s.ttft_ms,
            "trace": s.trace,
            "span_id": s.span_id,
            # the adopter decodes on the version the prefill ran on
            "model_version": s.version or self._default_version,
            "t": time.time(),
        }
        ms = (time.perf_counter() - s.t0) * 1e3
        s.result = {
            "handoff_id": hid,
            "first_token": int(s.out_ids[0]),
            "prompt_len": len(s.prompt),
            "pos": int(self._pos_host[i]),
            "latency_ms": round(ms, 2),
            "cached_prefix_len": s.cached_len,
        }
        if s.ttft_ms is not None:
            s.result["ttft_ms"] = round(s.ttft_ms, 3)
        self._stats["handoffs_out"] += 1
        self._slots[i] = None
        self._free_row_locked(i)
        self._release_prefix_locked(s)
        self._trace_request_locked(s, "prefill")
        s.done.set()

    def prefill_handoff(self, prompt_ids, max_tokens: int = 16,
                        temperature: float = 0.0, timeout_s: float = 600.0,
                        cache_prefix: bool = False, request_id: str = "",
                        trace=None, model_version: str = "") -> KVHandoff:
        """Prefill-pool entry: prefill the prompt and sample its first
        token exactly as generate() does, then export the row's KV blocks
        instead of decoding. Returns a :class:`KVHandoff` for a decode
        engine's :meth:`adopt_handoff`; the seam is the colocated engine's
        own prefill/decode seam, so disaggregated greedy output is the
        colocated output. ``trace`` (the caller's context) parents the
        prefill leg's spans, and the handoff carries this request's span
        as its ``trace`` header, so the adopt leg joins the same trace."""
        if not self._paged:
            raise ValueError(
                "disaggregated prefill requires kv_layout='paged'"
            )
        budget = self.max_seq - 1
        prompt = [int(t) for t in list(prompt_ids)[:budget]]
        if not prompt:
            prompt = [0]
        max_tokens = max(0, min(int(max_tokens), budget - len(prompt)))
        if max_tokens < 1:
            raise ValueError(
                "prompt leaves no token budget to hand off "
                f"(len {len(prompt)} of max_seq {self.max_seq})"
            )
        # the prefill row produces only the FIRST token; the request's
        # decode budget rides in the handoff
        slot = _Slot(prompt, 1, float(temperature), bool(cache_prefix),
                     request_id=request_id)
        slot.handoff = {"max_tokens": max_tokens}
        slot.version = str(model_version or "")
        self._arm_trace(slot, trace)
        self._enqueue_slot_locked_checks(slot)
        result = self._await_slot(slot, timeout_s)
        with self._cv:
            if request_id:
                self._requests.pop(request_id, None)
            self._stats["requests"] += 1
            self._stats["tokens_in"] += len(prompt)
            self._recent.append(time.time())
        hid = result.get("handoff_id")
        if hid is None:
            raise HandoffError(result.get("error", "prefill failed"))
        return self.fetch_handoff(hid, timeout_s=min(timeout_s, 60.0))

    def fetch_handoff(self, hid: str, timeout_s: float = 30.0) -> KVHandoff:
        """Export a parked handoff's blocks as a :class:`KVHandoff` and
        release its block references. The gather runs on the scheduler
        thread (the only one issuing device work); this call queues the
        request and waits. Raises :class:`HandoffError` on failure — the
        blocks are freed either way."""
        ev = threading.Event()
        box: Dict = {}
        with self._cv:
            if hid not in self._handoffs:
                raise HandoffError(f"unknown or expired handoff {hid!r}")
            self._export_q.append((hid, box, ev))
            self._cv.notify_all()
        if not ev.wait(timeout=timeout_s):
            raise HandoffError(f"handoff export {hid} timed out")
        if "error" in box:
            raise HandoffError(box["error"])
        return box["handoff"]

    def _gc_handoffs_locked(self) -> None:
        """Free the blocks of parked handoffs older than the TTL (a
        transfer that never came). Caller holds cv."""
        now = time.time()
        for hid in [h for h, rec in self._handoffs.items()
                    if now - rec["t"] > self.handoff_ttl_s]:
            rec = self._handoffs.pop(hid)
            self._alloc.free(rec["blocks"])
            self._stats["handoff_failures"] += 1

    def _device_to_host(self, t: torch.Tensor):
        """``(host tensor, event)``: a non-blocking copy into pinned memory
        and the event that marks it done (no stream sync)."""
        if self.device.type != "cuda":
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _service_exports(self) -> None:
        """Scheduler-thread half of :meth:`fetch_handoff`, at the top of a
        tick: GC expired handoffs, then for each queued fetch gather the
        blocks on the stream (behind the segment that wrote them) and
        start their copy to pinned host memory. The handoff's block
        references go back at once: any later write to those blocks is
        queued behind the gather. :meth:`_finish_exports` completes them
        once the copies are done. The chaos site ``serving.kv_handoff``
        injects a transfer failure here; the blocks are freed on that
        path too."""
        with self._cv:
            if not self._export_q and not self._handoffs:
                return
            self._gc_handoffs_locked()
            work = []
            while self._export_q:
                hid, box, ev = self._export_q.popleft()
                work.append((hid, box, ev, self._handoffs.pop(hid, None)))
        for hid, box, ev, rec in work:
            if rec is None:
                box["error"] = f"unknown or expired handoff {hid!r}"
                ev.set()
                continue
            t0 = time.perf_counter()
            try:
                chaos.check("serving.kv_handoff")
                idx = self._upload(np.asarray(rec["blocks"], np.int64))
                k, v = llama.export_kv_blocks(self._cache, idx)
                self._exports.append((rec, box, ev, self._device_to_host(k),
                                      self._device_to_host(v), t0))
            except Exception as e:
                box["error"] = f"handoff export failed: {e}"
                with self._cv:
                    self._stats["handoff_failures"] += 1
                ev.set()
            finally:
                self._alloc.free(rec["blocks"])

    def _finish_exports(self) -> None:
        """Wait on each in-flight export's copies and hand the fetcher its
        :class:`KVHandoff`. Runs after the tick's dispatch, so the wait
        overlaps device work. The handoff carries its trace as a header
        string (parent: the prefill request's span), so a decode engine
        adopting it with no HTTP header still joins the trace; the export
        metrics and span time the gather's dispatch through the copy."""
        done, self._exports = self._exports, []
        for rec, box, ev, (k, kev), (v, vev), t0 in done:
            try:
                for e in (kev, vev):
                    if e is not None:
                        e.synchronize()
                kp, dtype = _host_payload(k)
                vp, _ = _host_payload(v)
                th = ""
                if rec.get("span_id") and rec.get("trace") is not None:
                    th = TraceContext(rec["trace"].trace_id,
                                      rec["span_id"]).to_header()
                h = KVHandoff(
                    model=self.preset_name,
                    prompt_ids=rec["prompt"],
                    first_token=rec["first_token"],
                    pos=rec["pos"],
                    block_size=self.kv_block_size,
                    k=kp, v=vp,
                    max_tokens=rec["max_tokens"],
                    temperature=rec["temperature"],
                    request_id=rec["request_id"],
                    cache_prefix=rec["cache_prefix"],
                    ttft_ms=rec["ttft_ms"],
                    trace=th,
                    model_version=rec.get("model_version", ""),
                    dtype=dtype,
                )
                box["handoff"] = h
                m = self.metrics
                m.handoff_total.inc(direction="export")
                m.handoff_bytes.inc(h.nbytes, direction="export")
                m.handoff_ms.observe((time.perf_counter() - t0) * 1e3,
                                     direction="export")
                if rec.get("span_id"):
                    TRACER.record("engine.handoff_export", start=t0,
                                  duration=time.perf_counter() - t0,
                                  trace=rec["trace"],
                                  parent_id=rec["span_id"],
                                  nbytes=h.nbytes)
            except Exception as e:
                box["error"] = f"handoff export failed: {e}"
                with self._cv:
                    self._stats["handoff_failures"] += 1
            finally:
                ev.set()

    def adopt_handoff(self, h: KVHandoff, timeout_s: float = 600.0,
                      request_id: str = "",
                      trace: Optional[TraceContext] = None,
                      debug_trace: bool = False) -> Dict:
        """Decode-pool entry: adopt a prefill engine's :class:`KVHandoff`
        — allocate blocks from THIS pool (all-or-nothing, the same
        watermark admission as generate), write the payloads in, and
        resume decoding from the first token. Returns generate()'s result
        shape; greedy streams equal a colocated engine's. An explicit
        ``trace`` (the HTTP header) wins; else the handoff's own embedded
        header keeps a direct engine-to-engine adoption on its trace."""
        if not self._paged:
            raise ValueError(
                "adopting a KV handoff requires kv_layout='paged'"
            )
        if int(h.block_size) != self.kv_block_size:
            raise ValueError(
                f"handoff block_size {h.block_size} != engine "
                f"{self.kv_block_size}"
            )
        pool = self._cache["k"].shape
        if tuple(h.k.shape[0:1]) + tuple(h.k.shape[2:]) != (
            pool[0], pool[2], pool[3], pool[4]
        ):
            raise ValueError(
                f"handoff KV geometry {tuple(h.k.shape)} does not fit pool "
                f"{tuple(pool)} (model mismatch? handoff model={h.model!r})"
            )
        prompt = [int(t) for t in h.prompt_ids]
        budget = self.max_seq - 1
        if len(prompt) >= budget:
            raise ValueError(
                f"handoff prompt len {len(prompt)} exceeds adopter budget "
                f"{budget}"
            )
        max_tokens = max(1, min(int(h.max_tokens), budget - len(prompt)))
        slot = _Slot(prompt, max_tokens, float(h.temperature),
                     bool(h.cache_prefix),
                     request_id=request_id or h.request_id)
        slot.adopt = h
        # version stickiness across the seam: decode on exactly the
        # version that prefilled, or reject the adopt (400)
        slot.version = str(getattr(h, "model_version", "") or "")
        if trace is None:
            trace = parse_trace_header(getattr(h, "trace", ""))
        self._arm_trace(slot, trace, debug_trace)
        self._enqueue_slot_locked_checks(slot)
        result = self._await_slot(slot, timeout_s)
        with self._cv:
            if slot.request_id:
                self._requests.pop(slot.request_id, None)
            self._stats["requests"] += 1
            self._stats["tokens_in"] += len(prompt)
            self._stats["tokens_out"] += len(result.get("token_ids", []))
            self._recent.append(time.time())
        return self._trace_result(slot, result, debug_trace)

    def _admit_row_adopt_locked(self, i: int, slot: _Slot):
        """Admit an adopted slot into row ``i``: allocate the handoff's
        block count from this pool (sharing a prefix-cache match's FULL
        blocks by reference instead of importing them), write the rest of
        the payloads in, and seed the slot at the prefill/decode seam
        (fed = prompt len, out_ids = [first_token], pos = handoff pos).
        Returns True (admitted), None (pool dry: the slot stays queued) or
        False (the import failed: the waiter gets an error, every block
        reference taken here is returned). Caller holds cv."""
        h = slot.adopt
        a = self._alloc
        bs = self.kv_block_size
        n_blocks = int(h.k.shape[1])
        entry, mlen = None, 0
        if self._pcache is not None:
            key = self._prefix_key_locked(slot)
            self._pcache.observe(key)
            entry, mlen = self._pcache.match(key)
        entry_blocks = getattr(entry, "blocks", None) if entry else None
        # only FULL matched blocks are shared: the partial tail comes in
        # with the payload (cheaper than a copy-on-write block copy)
        shared = list(entry_blocks[:mlen // bs]) if entry_blocks else []
        shared = shared[:n_blocks]
        n_alloc = n_blocks - len(shared)
        got = a.alloc(n_alloc)
        if got is None and self._reclaim_prefix_locked():
            got = a.alloc(n_alloc)
        if got is None:
            if entry is not None:
                self._pcache.unpin(entry)
            return None
        a.incref(shared)
        blocks = shared + got
        if chaos.should_fail("serving.kv_handoff"):
            # transfer failure mid-flight: every reference taken above
            # goes straight back, the waiter learns why
            a.free(blocks)
            if entry is not None:
                self._pcache.unpin(entry)
            self._stats["handoff_failures"] += 1
            slot.result = {
                "error": "handoff transfer failed (injected)",
                "handoff_failed": True,
            }
            slot.done.set()
            return False
        t0 = time.perf_counter()
        if got:
            start = len(shared)
            try:
                # the port's class names bf16 bits; the reference's
                # carries an ml_dtypes array, whose str is "bfloat16"
                dtype = getattr(h, "dtype_name", "") or str(h.k.dtype)
                self._cache = llama.import_kv_blocks(
                    self._cache,
                    _payload_tensor(h.k[:, start:n_blocks], dtype),
                    _payload_tensor(h.v[:, start:n_blocks], dtype),
                    self._upload(np.asarray(got, np.int64)),
                )
            except Exception as e:
                a.free(blocks)
                if entry is not None:
                    self._pcache.unpin(entry)
                self._stats["handoff_failures"] += 1
                slot.result = {"error": f"handoff import failed: {e}",
                               "handoff_failed": True}
                slot.done.set()
                return False
        self._row_blocks[i] = blocks
        self._bt_host[i, :] = 0
        self._bt_host[i, :len(blocks)] = blocks
        self._pos_host[i] = min(int(h.pos), self.max_seq - 1)
        slot.fed = len(slot.prompt)
        slot.out_ids = [int(h.first_token)]
        slot.cached_len = len(shared) * bs
        if slot.ttft_ms is None and h.ttft_ms is not None:
            slot.ttft_ms = float(h.ttft_ms)
        self._slots[i] = slot
        # the adopted row's first decode input exists only on the host:
        # a device chain left by the row's previous tenant would feed
        # that tenant's token
        self._chain = None
        if entry is not None:
            self.metrics.prefix_hits.inc()
            # the shares are increfed: no prefill reads through the entry
            self._pcache.unpin(entry)
        elif self._pcache is not None:
            self.metrics.prefix_misses.inc()
        self._stats["handoffs_in"] += 1
        m = self.metrics
        m.handoff_total.inc(direction="adopt")
        m.handoff_bytes.inc(h.nbytes, direction="adopt")
        m.handoff_ms.observe((time.perf_counter() - t0) * 1e3,
                             direction="adopt")
        if slot.span_id:
            TRACER.record("engine.handoff_adopt", start=t0,
                          duration=time.perf_counter() - t0,
                          trace=slot.trace, parent_id=slot.span_id,
                          blocks=len(blocks), shared=len(shared))
        # adopted prompts join this replica's prefix cache
        self._maybe_insert_prefix_locked(i, slot)
        self._maybe_finalize_locked(i, slot)
        return True

    def stats(self) -> Dict:
        """Live serving counters (one snapshot under one lock)."""
        now = time.time()
        with self._cv:
            out = dict(self._stats)
            recent = sum(1 for t in self._recent if t > now - self.qps_window_s)
            shed_recent = sum(
                1 for t in self._shed_recent if t > now - self.qps_window_s
            )
            queued = len(self._waiting)
            active = sum(1 for s in self._slots if s is not None)
            ttft = list(self._ttft_recent)
            qwait = list(self._queue_wait_recent)
            draining = self._draining
            parked_handoffs = len(self._handoffs)
            versions = dict(self._versions)
            default = self._default_version
            tag = self._version_tags[default]
        up = max(now - out["started_at"], 1e-9)
        out.update({
            "role": self.role, "draining": draining,
            "handoffs_parked": parked_handoffs,
            "uptime_s": round(up, 1),
            "qps": round(recent / max(min(self.qps_window_s, up), 1e-9), 3),
            "lifetime_qps": round(out["requests"] / up, 3),
            "active_slots": active, "max_batch": self.max_batch,
            "queued": queued, "shed_recent": shed_recent,
            "device": str(self.device),
        })
        if ttft:
            out["ttft_ms_p50"] = _pct(ttft, 0.5)
            out["ttft_ms_p95"] = _pct(ttft, 0.95)
        if qwait:
            out["queue_wait_ms_p50"] = _pct(qwait, 0.5)
            out["queue_wait_ms_p95"] = _pct(qwait, 0.95)
        if self._pcache is not None:
            out["prefix_cache"] = self._pcache.stats()
            # digests of the default version's cached prefixes (tag
            # stripped), in the hash the router's ring keys on: the router
            # steers repeats here
            adv = set()
            for key in self._pcache.prefix_keys():
                if key[0] != tag:
                    continue
                d = prefix_digest(key[1:], self.advertise_prefix_len)
                if d is not None:
                    adv.add(d)
            out["prefix_cache"]["advertised"] = sorted(adv)
        if self._paged:
            out["kv_blocks"] = self._alloc.stats()
            out["kv_blocks"]["attention_kernel"] = self.kv_attention
            out["kv_blocks"]["role"] = self.role
        if self._split is not None:
            out["mesh"] = self._split.describe(versions[default],
                                               self._cache)
        if self._spec_stats is not None:
            out["speculative"] = self._spec_stats.snapshot()
            out["speculative"]["draft_kind"] = getattr(
                self._draft, "name", self.spec_draft)
            out["speculative"]["candidates"] = self.spec_candidates
        out["pipeline"] = self.pipeline_stats()
        out["kernel_launches"] = dict(paged_attention.LAUNCHES)
        out["nonfinite_logits"] = int(self._nonfinite.item())
        out["versions"] = self.versions()
        out["weights"] = {
            "quantize": self.quantize or "none",
            "bytes": llama.params_nbytes(versions[default]),
            "resident_bytes": sum(llama.params_nbytes(p)
                                  for p in versions.values()),
        }
        return out

    def pipeline_stats(self) -> Dict:
        """Decode-pipeline accounting with the reference's keys: per-tick
        dispatch / harvest / host timings (avg, and p50 over the recent
        window), the overlap ratio (host work done while a segment was in
        flight, over tick time), lifetime segment / harvest counters; and
        the port's decode counters (``decode_steps``, ``decode_tokens``,
        ``ms_per_decode_step``, ``decode_tokens_per_s``, prefill and
        speculation counts: ``prefills`` counts prefill dispatches, whole
        or chunked, ``prefill_chunks`` the rows' chunks in them)."""
        with self._cv:
            p = dict(self._pipe)
            recent = list(self._pipe_recent)
            queued = len(self._waiting)
        out = {k: p[k] for k in ("ticks", "segments", "deferred_harvests",
                                 "flushes", "chain_rebuilds", "errors",
                                 "inflight")}
        out["queued"] = queued
        if p["ticks"]:
            n = p["ticks"]
            out["dispatch_ms_avg"] = round(p["dispatch_ms_sum"] / n, 4)
            out["harvest_ms_avg"] = round(p["harvest_ms_sum"] / n, 4)
            out["host_ms_avg"] = round(p["host_ms_sum"] / n, 4)
            out["tick_ms_avg"] = round(p["tick_ms_sum"] / n, 4)
            out["overlap_ratio"] = round(
                p["overlap_ms_sum"] / max(p["tick_ms_sum"], 1e-9), 4
            )
        if recent:
            med = statistics.median
            out["dispatch_ms_p50"] = round(med([r[0] for r in recent]), 4)
            out["harvest_ms_p50"] = round(med([r[1] for r in recent]), 4)
            out["host_ms_p50"] = round(med([r[2] for r in recent]), 4)
            out["tick_ms_p50"] = round(med([r[3] for r in recent]), 4)
        for k in ("prefills", "prefill_chunks", "decode_steps",
                  "decode_tokens", "decode_ms_sum", "spec_rounds",
                  "spec_ms_sum", "verify_ms_sum"):
            out[k] = p[k]
        if p["decode_steps"]:
            out["ms_per_decode_step"] = round(
                p["decode_ms_sum"] / p["decode_steps"], 4)
        if p["decode_ms_sum"] > 0:
            out["decode_tokens_per_s"] = round(
                p["decode_tokens"] / (p["decode_ms_sum"] / 1e3), 3)
        return out

    # -- prefix cache ------------------------------------------------------

    def _release_prefix_locked(self, slot: _Slot) -> None:
        """Drop a slot's pin on its grafted prefix entry (finalize /
        vacation / error recovery). Idempotent; caller holds cv."""
        if slot.pinned is not None and self._pcache is not None:
            self._pcache.unpin(slot.pinned)
        slot.pinned = None

    def _prefix_key_locked(self, slot: _Slot) -> list:
        """The prefix cache's key for ``slot``'s prompt: its version's
        tag, then the tokens. Entries, observations and matches are per
        loaded tree; an entry's ``length`` stays in prompt tokens.
        Caller holds cv."""
        v = slot.version or self._default_version
        return [self._version_tags[v]] + list(slot.prompt)

    def _maybe_insert_prefix_locked(self, i: int, s: _Slot) -> None:
        """After row ``i``'s prefill completes, store its prompt prefix
        when traffic says it is shared (>= min_seen requests walked it)
        or the request tagged itself cacheable. The entry SHARES the
        row's full prefix blocks by reference; only the partial tail
        block is copied (the row keeps appending inside its own tail).
        The copy is queued on the stream before any later write into the
        row, so it holds this prefill's output. Caller holds cv."""
        if self._pcache is None:
            return
        key = self._prefix_key_locked(s)
        # the candidate's length counts the version tag: less one token
        cand = self._pcache.insert_candidate(key, s.cache_prefix) - 1
        # cap at len-1: a full-prompt entry can never match (a row needs
        # >= 1 suffix token for last-token logits)
        cand = min(cand, len(s.prompt) - 1)
        if cand <= s.cached_len or cand < self._pcache.min_len:
            return
        if not self._paged:
            # the entry is a K/V copy of the row's prefix, padded to a
            # prefill bucket (the pad is masked wherever it is grafted)
            k, v = llama.extract_prefix_from_row(
                self._cache, i, self._prefill_bucket(cand), self._split)
            parts = (k, v) if self._split is None else (*k, *v)
            nbytes = sum(t.numel() * t.element_size() for t in parts)
            if not self._pcache.insert(key[:cand + 1], k, v, cand,
                                       nbytes=nbytes):
                return
        else:
            bs = self.kv_block_size
            full = cand // bs
            row_blocks = self._row_blocks[i]
            blocks = list(row_blocks[:full])
            if cand % bs:
                got = self._alloc.alloc(1)
                if got is None:
                    return  # pool pressure: skip the insert
                self._cache = llama.copy_kv_block(
                    self._cache, row_blocks[full], got[0])
                blocks.append(got[0])
            self._alloc.incref(blocks[:full])
            ok = self._pcache.insert(
                key[:cand + 1], None, None, cand, blocks=tuple(blocks),
                nbytes=len(blocks) * self._block_bytes,
            )
            if not ok:
                self._alloc.free(blocks)  # duplicate/over-budget: undo
                return
        st = self._pcache.stats()
        m = self.metrics
        m.prefix_inserts.inc()
        m.prefix_bytes.set(float(st["bytes"]))
        m.prefix_entries.set(float(st["entries"]))
        ev = st["evictions"] - self._prefix_evictions_seen
        if ev > 0:
            m.prefix_evictions.inc(ev)
        self._prefix_evictions_seen = st["evictions"]

    def _paged_entry_evicted(self, entry) -> None:
        """PrefixCache eviction callback: hand the entry's block
        references back to the allocator (its own lock; never cv)."""
        blocks = getattr(entry, "blocks", None)
        if blocks:
            self._alloc.free(blocks)

    def _reclaim_prefix_locked(self) -> bool:
        """Evict unpinned prefix-cache entries to recover at least one
        block; True when anything came back. Cache entries are an
        optimization, resident rows are work. Paged only."""
        if self._pcache is None or not self._paged:
            return False
        return self._pcache.reclaim(self._block_bytes) > 0

    # -- paged KV bookkeeping (host mirrors + block lifecycle) -------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Upload a host array as a device-OWNED copy (pinned staging, no
        stream sync; later host edits never reach the device copy)."""
        return self._staging.upload(arr)

    def _upload_mirrors(self) -> None:
        """Paged: the host mirrors onto the device before a dispatch (a
        contiguous cache's pos is the device's own)."""
        if self._paged:
            self._cache["pos"] = self._upload(self._pos_host)
            self._cache["bt"] = self._upload(self._bt_host)

    def _free_row_locked(self, i: int) -> None:
        """Return row ``i``'s blocks and point its table at the trash
        block. An in-flight dispatch keeps writing through its own bt
        snapshot, but the stream runs calls in order, so a later owner's
        writes land last. Caller holds cv; no-op in contiguous mode."""
        if not self._paged:
            return
        blocks = self._row_blocks[i]
        if blocks:
            self._alloc.free(blocks)
        self._row_blocks[i] = []
        self._bt_host[i, :] = 0
        self._pos_host[i] = 0

    def _reserve_locked(self, i: int, n_tokens: int) -> bool:
        """Grow row ``i``'s block list to cover ``n_tokens`` cached
        positions (all-or-nothing). Caller holds cv."""
        need = self._alloc.blocks_for(min(int(n_tokens), self.max_seq))
        blocks = self._row_blocks[i]
        if need <= len(blocks):
            return True
        got = self._alloc.alloc(need - len(blocks))
        if got is None:
            return False
        self._bt_host[i, len(blocks):need] = got
        blocks.extend(got)
        return True

    def _trim_row_locked(self, i: int, n_tokens: int) -> None:
        """Free row blocks beyond what ``n_tokens`` cached positions need
        — how a rejected speculative suffix's KV is freed in place."""
        keep = self._alloc.blocks_for(min(int(n_tokens), self.max_seq))
        blocks = self._row_blocks[i]
        if len(blocks) <= keep:
            return
        drop = blocks[keep:]
        del blocks[keep:]
        self._bt_host[i, keep:keep + len(drop)] = 0
        self._alloc.free(drop)

    def _pick_victim_locked(self, held) -> Optional[int]:
        """The YOUNGEST resident row not in ``held`` with nothing in
        flight (``pending`` rows owe tokens to the deferred harvest)."""
        best = None
        for j, s in enumerate(self._slots):
            if s is None or j in held or s.pending or not self._row_blocks[j]:
                continue
            if best is None or s.t0 > self._slots[best].t0:
                best = j
        return best

    def _preempt_locked(self, j: int) -> None:
        """Preempt-and-requeue row ``j`` under block exhaustion: free its
        blocks, reset the slot to its pre-admission state and put it at
        the FRONT of the queue. Greedy requests regenerate the same
        tokens, so preemption never changes greedy output."""
        s = self._slots[j]
        self._slots[j] = None
        self._free_row_locked(j)
        self._release_prefix_locked(s)
        s.fed = 0
        s.cached_len = 0
        s.prefill_pos = -1
        s.out_ids = []
        s.pending = 0
        self._waiting.appendleft(s)
        self._stats["kv_preemptions"] += 1
        self.metrics.kv_preemptions.inc()
        log.warning("KV blocks exhausted: preempted row %d (requeued)", j)

    def _reserve_decode_locked(self, decoding, steps: int):
        """Ensure every decoding row can cache ``steps`` more positions:
        on exhaustion evict unpinned prefix entries first, then preempt
        victims; rows that still cannot grow sit this dispatch out (the
        chaos site ``serving.kv_alloc`` injects the exhaustion once).
        Caller holds cv."""
        out = []
        inject = chaos.should_fail("serving.kv_alloc")
        for i, s in decoding:
            if self._slots[i] is not s:
                continue  # preempted earlier in this very loop
            need = min(int(self._pos_host[i]) + steps, self.max_seq)
            while True:
                if not inject and self._reserve_locked(i, need):
                    out.append((i, s))
                    break
                inject = False  # one injected failure exercises the path
                if self._reclaim_prefix_locked():
                    continue
                victim = self._pick_victim_locked({i} | {j for j, _ in out})
                if victim is None:
                    break
                self._preempt_locked(victim)
        return out

    def _admit_row_locked(self, i: int, slot: _Slot) -> bool:
        """Admit ``slot`` into row ``i``: match the prefix cache, SHARE
        the entry's full blocks by reference (no device copy), copy the
        partial tail block on write, and allocate fresh blocks for the
        suffix plus its first token. All-or-nothing: on pool exhaustion
        every side effect is rolled back and the slot stays queued.
        Caller holds cv."""
        a = self._alloc
        bs = self.kv_block_size
        need_total = a.blocks_for(min(len(slot.prompt) + 1, self.max_seq))
        entry, mlen = None, 0
        if self._pcache is not None:
            key = self._prefix_key_locked(slot)
            self._pcache.observe(key)
            entry, mlen = self._pcache.match(key)
        entry_blocks = getattr(entry, "blocks", None) if entry else None
        shared: list = []
        tail_src = None
        if entry_blocks:
            full = mlen // bs
            shared = list(entry_blocks[:full])
            if mlen % bs:
                tail_src = entry_blocks[full]
        n_alloc = need_total - len(shared)
        t_alloc = time.perf_counter()
        got = a.alloc(n_alloc)
        if got is None and self._reclaim_prefix_locked():
            got = a.alloc(n_alloc)
        if got is None:
            if entry is not None:
                self._pcache.unpin(entry)
            return False
        a.incref(shared)
        blocks = list(shared)
        if tail_src is not None:
            # copy-on-write: the entry's partial tail block is SHARED and
            # this row's suffix prefill appends inside it
            tail_copy = got.pop(0)
            self._cache = llama.copy_kv_block(self._cache, tail_src,
                                              tail_copy)
            blocks.append(tail_copy)
        blocks.extend(got)
        self._row_blocks[i] = blocks
        self._bt_host[i, :] = 0
        self._bt_host[i, :len(blocks)] = blocks
        self._pos_host[i] = mlen
        self._slots[i] = slot
        if slot.span_id:
            TRACER.record("engine.kv_alloc", start=t_alloc,
                          duration=time.perf_counter() - t_alloc,
                          trace=slot.trace, parent_id=slot.span_id,
                          blocks=len(blocks), shared=len(shared))
        if entry is None:
            if self._pcache is not None:
                self.metrics.prefix_misses.inc()
            return True
        self.metrics.prefix_hits.inc()
        slot.cached_len = mlen
        slot.pinned = entry
        if not entry_blocks:
            # array-payload entry (a direct insert): scatter its K/V into
            # the row's fresh blocks through the just-updated table
            self._cache["bt"] = self._upload(self._bt_host)
            self._cache = llama.paged_graft_prefix(
                self._cache, entry.k, entry.v, i, mlen)
        return True

    def _admit_row_contiguous_locked(self, i: int, slot: _Slot) -> None:
        """Admit ``slot`` into row ``i`` of a contiguous cache: reset the
        row's position (stale K/V beyond it is masked) and graft the
        longest cached prefix's K/V into the row now (pos := its length),
        so the prefill dispatch consumes only the suffix. Both writes are
        queued on the stream behind any segment in flight, and within a
        tick prefill is dispatched before decode, so no decode step writes
        inside the grafted span. Caller holds cv."""
        self._slots[i] = slot
        self._trace_admitted_locked(slot, time.perf_counter(), i)
        self._cache["pos"][i] = 0
        if self._pcache is None:
            return
        key = self._prefix_key_locked(slot)
        self._pcache.observe(key)
        entry, mlen = self._pcache.match(key)
        if entry is None:
            self.metrics.prefix_misses.inc()
            return
        self.metrics.prefix_hits.inc()
        self._cache = llama.copy_prefix_into_row(self._cache, entry.k,
                                                 entry.v, i, mlen,
                                                 self._split)
        slot.cached_len = mlen
        slot.pinned = entry

    def _admit_locked(self) -> None:
        # retiring versions evict here: every row free is followed by an
        # admission pass, which then sees the last reference gone
        self._maybe_evict_versions_locked()
        for i in range(self.max_batch):
            if self._slots[i] is None and self._waiting and not self._paged:
                self._admit_row_contiguous_locked(i, self._waiting.popleft())
                continue
            if self._slots[i] is None and self._waiting:
                if not self._alloc.admission_open():
                    break  # below low watermark: hysteresis holds
                head = self._waiting[0]
                t_adm = time.perf_counter()
                if head.adopt is not None:
                    r = self._admit_row_adopt_locked(i, head)
                    if r is None:
                        break  # pool dry: wait for frees
                    self._waiting.popleft()
                    if r:
                        self._trace_admitted_locked(head, t_adm, i)
                    continue  # False: the waiter was failed and woken
                if not self._admit_row_locked(i, head):
                    break  # pool dry: wait for frees / preemption
                self._waiting.popleft()
                self._trace_admitted_locked(head, t_adm, i)

    # -- scheduler ---------------------------------------------------------

    def _loop(self) -> None:
        while True:
            try:
                if self._loop_once():
                    return
            except Exception as e:  # the scheduler must survive a failed
                # tick: fail every in-flight request, keep serving new ones
                log.exception("decode scheduler step failed")
                with self._cv:
                    for i, s in enumerate(self._slots):
                        if s is not None:
                            s.result = {"error": str(e)}
                            self._slots[i] = None
                            self._release_prefix_locked(s)
                            s.done.set()
                    # the cache (and, paged, the allocator) may hold a
                    # failed tick's partial writes: start both afresh
                    self._cache = self._new_cache()
                    self._pos_host[:] = 0
                    self._bt_host[:] = 0
                    self._row_blocks = [[] for _ in range(self.max_batch)]
                    if self._paged and self._pcache is not None:
                        # every entry references the dead pool's blocks:
                        # drop them all (no evict callbacks: the allocator
                        # was just rebuilt). Contiguous entries are K/V
                        # copies of finished prefills: they stay.
                        self._pcache.clear()
                    # parked handoffs reference the dead pool too: fail
                    # every fetch waiting on one
                    self._handoffs.clear()
                    waiters = [(box, ev) for _h, box, ev in self._export_q]
                    waiters += [(rec[1], rec[2]) for rec in self._exports]
                    for box, ev in waiters:
                        box["error"] = "engine recovered from a scheduler error"
                        ev.set()
                    self._export_q.clear()
                    self._exports = []
                    self._reset_pipeline_locked()

    def _reset_pipeline_locked(self) -> None:
        """Drop every piece of pipeline state that may reference a failed
        tick: the device chain, the temperature upload and the deferred
        segment (discarded UNHARVESTED — its slots were failed, no tokens
        are owed); latency accounting restarts so post-recovery stats
        describe the recovered engine. Caller holds cv."""
        self._chain = None
        self._temps_cache = None
        if self._pending is not None:
            self._pending["toks"].discard()
        self._pending = None
        p = self._pipe
        p["errors"] += 1
        p["inflight"] = 0
        p["ticks"] = 0
        for k in ("dispatch_ms_sum", "harvest_ms_sum", "host_ms_sum",
                  "tick_ms_sum", "overlap_ms_sum"):
            p[k] = 0.0
        self._pipe_recent.clear()
        self.metrics.scheduler_errors.inc()
        self.metrics.queue_depth.set(float(len(self._waiting)))

    def _rem(self, s: _Slot) -> int:
        """Remaining token budget for a slot, counting tokens already
        dispatched but not yet harvested (``s.pending``): the pipeline
        schedules from counts — values arrive a tick later."""
        done = len(s.out_ids) + s.pending
        return min(s.max_tokens - done,
                   (self.max_seq - 1) - (len(s.prompt) + done))

    def _maybe_finalize_locked(self, i: int, s: _Slot) -> None:
        """Completion is token-COUNT based; a slot with tokens still in
        flight never finalizes (their values arrive at the next harvest).
        Caller holds cv."""
        if s.pending:
            return
        if s.handoff is not None and s.fed >= len(s.prompt) and s.out_ids:
            # prefill-role slot: park the row's blocks for the handoff
            # instead of decoding
            self._finalize_handoff_locked(i, s)
            return
        if (len(s.out_ids) >= s.max_tokens
                or len(s.prompt) + len(s.out_ids) >= self.max_seq - 1):
            ms = (time.perf_counter() - s.t0) * 1e3
            s.result = {
                "token_ids": s.out_ids,
                "prompt_len": len(s.prompt),
                "latency_ms": round(ms, 2),
                "tokens_per_sec": round(
                    len(s.out_ids) / (ms / 1e3), 2
                ) if ms > 0 else 0.0,
                "cached_prefix_len": s.cached_len,
                "model_version": s.version or self._default_version,
            }
            if s.ttft_ms is not None:
                s.result["ttft_ms"] = round(s.ttft_ms, 3)
            self._slots[i] = None
            self._free_row_locked(i)
            self._release_prefix_locked(s)
            self._trace_request_locked(
                s, "adopt" if s.adopt is not None else "generate")
            s.done.set()

    def _prefill_bucket(self, max_len: int) -> int:
        """Pad prompts to power-of-2 buckets (at most 2x padding)."""
        b = 16
        while b < max_len:
            b <<= 1
        return min(b, self.max_seq)

    @staticmethod
    def segment_size(need: int, cap: int,
                     buckets: tuple = SEGMENT_BUCKETS) -> int:
        """Pick the segment size for a remaining budget of ``need``
        tokens: round UP to the smallest covering bucket when the
        overshoot is at most a quarter of it, else step DOWN to the
        largest bucket below. ``cap`` bounds admission latency."""
        need = max(1, min(int(need), int(cap)))
        up = next((b for b in reversed(buckets) if b >= need), buckets[0])
        if up - need <= up // 4:
            return up
        return next((b for b in buckets if b <= need), 1)

    def _temps_dev(self, temps: np.ndarray) -> torch.Tensor:
        """The per-row temperatures on the device, uploaded only when
        they change."""
        fp = temps.tobytes()
        if self._temps_cache is None or self._temps_cache[0] != fp:
            self._temps_cache = (fp, self._upload(temps))
        return self._temps_cache[1]

    def _sample_logits(self, logits: torch.Tensor,
                       temps: np.ndarray) -> torch.Tensor:
        """First-token sampler on the device (greedy rows take argmax,
        temp > 0 rows Gumbel-max): the [B] int32 ids stay on the device."""
        self._nonfinite += (~torch.isfinite(logits)).sum()
        if np.any(temps > 0.0):
            t = self._upload(temps)
            g = -torch.log(torch.empty_like(logits).exponential_(
                generator=self._gen))
            z = torch.where(t[:, None] > 0.0,
                            logits / torch.clamp(t[:, None], min=1e-4) + g,
                            logits)
        else:
            z = logits
        return torch.argmax(z, dim=-1).to(torch.int32)

    def _graft_chain(self, ids_dev: torch.Tensor, rows) -> None:
        """Merge freshly prefilled rows' first ids into the device token
        chain (``llama.merge_chain_tokens``): the next segment's inputs
        stay on the device across admissions."""
        self._prefill_gen += 1
        rows = tuple(rows)
        if self._chain is not None:
            mask = np.zeros((self.max_batch,), bool)
            mask[list(rows)] = True
            merged = llama.merge_chain_tokens(
                self._chain[2], ids_dev, self._upload(mask))
            self._chain = (self._prefill_gen,
                           tuple(sorted(set(self._chain[1]) | set(rows))),
                           merged)
        else:
            self._chain = (self._prefill_gen, rows, ids_dev[:, None])

    # -- pipeline stages ---------------------------------------------------

    def _harvest_segment(self):
        """Harvest the deferred in-flight decode segment: wait on its
        copy's event, append the ids to each slot, finalize completed
        requests and admit waiters. No-op when nothing is in flight.
        Returns ``(blocked_ms, host_ms)``."""
        pend, self._pending = self._pending, None
        if pend is None:
            return 0.0, 0.0
        t0 = time.perf_counter()
        rows = pend["toks"].wait()  # [B, k]
        t1 = time.perf_counter()
        if pend["ev"] is not None:
            seg_ms = pend["ev"][0].elapsed_time(pend["ev"][1])
        else:
            seg_ms = pend["dispatch_ms"]
        seg_t0 = pend["t0"]
        with self._cv:
            p = self._pipe
            p["inflight"] = 0
            p["decode_steps"] += pend["k"]
            p["decode_ms_sum"] += seg_ms
            for i, s, take in pend["sched"]:
                s.pending -= take
                if self._slots[i] is not s:
                    continue  # vacated (timeout/cancel) mid-segment
                s.out_ids.extend(int(t) for t in rows[i][:take])
                p["decode_tokens"] += take
                if s.span_id and take:
                    # the segment's time is SHARED by its rows (one
                    # batched dispatch); each traced row gets its own span
                    TRACER.record("engine.decode_segment", start=seg_t0,
                                  duration=t1 - seg_t0, trace=s.trace,
                                  parent_id=s.span_id, tokens=take)
                self._maybe_finalize_locked(i, s)
            self._admit_locked()
            self._cv.notify_all()
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    def _harvest_prefill(self, pre, ids_copy):
        """Harvest prefill's device-sampled first ids and record them
        (first tokens, TTFT, prefix pins and inserts). Runs after the
        next decode segment is dispatched, so the wait overlaps device
        work. Returns ``(blocked_ms, host_ms)``."""
        t0 = time.perf_counter()
        ids = ids_copy.wait()
        t1 = time.perf_counter()
        with self._cv:
            for i, s, budgeted in pre:
                if budgeted:
                    s.pending -= 1
                if self._slots[i] is not s:
                    continue  # vacated mid-prefill (pin already released)
                if budgeted and s.ttft_ms is None:
                    s.ttft_ms = (t1 - s.t0) * 1e3
                    self._ttft_recent.append(s.ttft_ms)
                    self.metrics.ttft_ms.observe(s.ttft_ms)
                if budgeted:
                    s.out_ids.append(int(ids[i]))
                if s.span_id:
                    p0 = s.prefill_t0 if s.prefill_t0 is not None else t0
                    TRACER.record("engine.prefill", start=p0,
                                  duration=t1 - p0, trace=s.trace,
                                  parent_id=s.span_id,
                                  prompt_len=len(s.prompt),
                                  cached_len=s.cached_len)
                # the row's prefix KV is self-contained now: the grafted
                # entry no longer needs its pin
                self._release_prefix_locked(s)
                self._maybe_insert_prefix_locked(i, s)
                self._maybe_finalize_locked(i, s)
            self._admit_locked()
            self._cv.notify_all()
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    def _pre_rows_locked(self, sched_final):
        """Mark rows whose prompt is now fully dispatched as decoding rows
        owing one first token. Caller holds cv."""
        pre = []
        for i, s in sched_final:
            if self._slots[i] is not s:
                continue  # vacated mid-prefill
            s.fed = len(s.prompt)
            budgeted = (s.max_tokens > 0 and len(s.prompt) + len(s.out_ids)
                        < self.max_seq - 1)
            if budgeted:
                s.pending += 1
            pre.append((i, s, budgeted))
        return pre

    def _prefill_whole(self, todo, acct: Dict, vp):
        """Whole prompts in one forward: rows without a grafted prefix go
        through ``paged_prefill_batched`` (dense causal attention over the
        fresh K/V); when any row rides a grafted prefix, every row goes
        through the suffix prefill at ``starts = cached_len`` (the blocked
        kernel on the card). First ids stay on the device and join the
        chain. Returns ``(pre, ids_copy)`` for the deferred harvest.

        Contiguous, ``prefill_batched`` / ``prefill_batched_from`` take
        their place, and a graft whose start + bucket would spill past
        ``max_seq`` is dropped (full prefill for that row, the bucket
        recomputed): the write's start would clamp out of place. Paged
        needs no such fix: pad writes go to the trash block."""
        while True:
            bucket = self._prefill_bucket(
                max(len(s.prompt) - s.cached_len for _, s in todo))
            bad = [s for _, s in todo if not self._paged and s.cached_len
                   and s.cached_len + bucket > self.max_seq]
            if not bad:
                break
            with self._cv:
                for s in bad:
                    s.cached_len = 0
                    self._release_prefix_locked(s)
        toks = np.zeros((self.max_batch, bucket), np.int32)
        lens = np.zeros((self.max_batch,), np.int32)
        starts = np.zeros((self.max_batch,), np.int32)
        temps0 = np.zeros((self.max_batch,), np.float32)
        for i, s in todo:
            suffix = s.prompt[s.cached_len:]
            toks[i, :len(suffix)] = suffix
            lens[i] = len(suffix)
            starts[i] = s.cached_len
            temps0[i] = max(float(s.temperature), 0.0)
        self._upload_mirrors()
        t0 = time.perf_counter()
        if np.any(starts > 0):
            if self._paged:
                logits, self._cache = llama.paged_prefill_from(
                    vp, self._cache, self._upload(toks),
                    self._upload(lens), self._upload(starts), self.cfg,
                    kv_attention=self.kv_attention,
                )
            else:
                logits, self._cache = llama.prefill_batched_from(
                    vp, self._cache, self._upload(toks),
                    self._upload(lens), self._upload(starts), self.cfg,
                    self._split)
            saved = int(starts.sum())
            if self._pcache is not None:
                self._pcache.add_tokens_saved(saved)
            self.metrics.prefix_tokens_saved.inc(saved)
        elif self._paged:
            logits, self._cache = llama.paged_prefill_batched(
                vp, self._cache, self._upload(toks),
                self._upload(lens), self.cfg,
            )
        else:
            logits, self._cache = llama.prefill_batched(
                vp, self._cache, self._upload(toks),
                self._upload(lens), self.cfg, self._split,
            )
        ids_dev = self._sample_logits(logits, temps0)
        ids_copy = self._staging.download(ids_dev)
        self._graft_chain(ids_dev, [i for i, _ in todo])
        acct["dispatch_ms"] += (time.perf_counter() - t0) * 1e3
        with self._cv:
            self._pipe["prefills"] += 1
            for i, s in todo:
                # mirror the device's pos update for dispatched rows
                # (vacated rows get reset at readmission)
                self._pos_host[i] = min(int(starts[i]) + int(lens[i]),
                                        self.max_seq - 1)
                s.prefill_t0 = t0  # dispatch start, for engine.prefill
            pre = self._pre_rows_locked(todo)
        return pre, ids_copy

    def _prefill_chunks(self, todo, acct: Dict, vp):
        """Chunked prefill: spend at most ``prefill_chunk_tokens`` prompt
        tokens this tick across the not-yet-prefilled rows, FIFO by
        arrival, from each row's committed position (its grafted prefix
        on the first chunk). Every chunk runs the suffix prefill (the
        blocked kernel on the card); non-final chunks are block-aligned.
        Only rows whose FINAL chunk lands this tick sample a first id and
        join the chain. Returns ``(pre, ids_copy)``."""
        bs = self.kv_block_size
        left = self.prefill_chunk_tokens
        sched = []  # (row, slot, base, take, final)
        for i, s in sorted(todo, key=lambda t: t[1].t0):
            if left <= 0:
                break
            base = s.prefill_pos if s.prefill_pos >= 0 else s.cached_len
            rem = max(0, len(s.prompt) - base)
            take = min(rem, left)
            if take < rem:
                take = (take // bs) * bs
                if take <= 0:
                    break
            sched.append((i, s, base, take, base + take >= len(s.prompt)))
            left -= take
        if not sched:
            return [], None
        # an injected chunk-dispatch fault: the scheduler recovers (fails
        # the in-flight rows, rebuilds the cache) as for a segment fault
        chaos.check("serving.chunk_admit")
        bucket = self._prefill_bucket(
            max(max(t for _i, _s, _b, t, _f in sched), 1))
        toks = np.zeros((self.max_batch, bucket), np.int32)
        lens = np.zeros((self.max_batch,), np.int32)
        starts = np.zeros((self.max_batch,), np.int32)
        temps0 = np.zeros((self.max_batch,), np.float32)
        saved = 0
        for i, s, base, take, _final in sched:
            toks[i, :take] = s.prompt[base:base + take]
            lens[i] = take
            starts[i] = base
            temps0[i] = max(float(s.temperature), 0.0)
            if s.prefill_pos < 0 and s.cached_len:
                saved += s.cached_len  # first chunk rode a grafted prefix
        self._upload_mirrors()
        t0 = time.perf_counter()
        logits, self._cache = llama.paged_prefill_from(
            vp, self._cache, self._upload(toks), self._upload(lens),
            self._upload(starts), self.cfg, kv_attention=self.kv_attention,
        )
        if saved:
            if self._pcache is not None:
                self._pcache.add_tokens_saved(saved)
            self.metrics.prefix_tokens_saved.inc(saved)
        self.metrics.admission_chunks.inc(len(sched))
        final_rows = [(i, s) for i, s, _b, _t, f in sched if f]
        ids_copy = None
        if final_rows:
            ids_dev = self._sample_logits(logits, temps0)
            ids_copy = self._staging.download(ids_dev)
            self._graft_chain(ids_dev, [i for i, _ in final_rows])
        acct["dispatch_ms"] += (time.perf_counter() - t0) * 1e3
        with self._cv:
            self._pipe["prefills"] += 1
            self._pipe["prefill_chunks"] += len(sched)
            for i, s, base, take, _final in sched:
                self._pos_host[i] = min(base + take, self.max_seq - 1)
                if self._slots[i] is s:
                    s.prefill_pos = base + take
                    if s.prefill_t0 is None:
                        s.prefill_t0 = t0  # the first chunk starts it
            pre = self._pre_rows_locked(final_rows)
        return pre, (ids_copy if pre else None)

    def _spec_tick(self, decoding, acct: Dict, vp) -> None:
        """One draft-k / verify-1 round over every greedy decoding row
        (the reference's ``_spec_tick``): the draft proposes k tokens from
        the host context, ``llama.paged_verify`` consumes ``[next_input,
        d1..dk]`` in one forward and returns the target's greedy argmax
        after each input; the longest agreeing prefix plus one bonus token
        is emitted — every emitted token the target's own greedy choice,
        so output is identical to plain decode. The pos mirror then
        rewinds past the rejected suffix and its blocks are freed in
        place. With ``spec_candidates > 1`` the read-only
        ``paged_verify_multi`` (or, with ``spec_tree``, the trie scorer
        ``paged_verify_tree``) picks the winning candidate first, and the
        write-path verify runs on the winner alone."""
        k = self.spec_k
        S = k + 1
        N = self.spec_candidates
        multi = N > 1
        tree = multi and self.spec_tree
        draft_kind = getattr(self._draft, "name", self.spec_draft)
        t_round = time.perf_counter()
        # phase 1 — snapshot contexts under the lock, draft outside it
        with self._cv:
            cand = [
                (i, s, list(s.prompt) + list(s.out_ids), s.next_input())
                for i, s in decoding if self._slots[i] is s
            ]
        if not cand:
            return
        t_d = time.perf_counter()
        if multi:
            cand_lists = [self._draft.propose_candidates(ctx, k, N)
                          for _, _, ctx, _ in cand]
        else:
            cand_lists = [[p] for p in self._draft.propose_batch(
                [ctx for _, _, ctx, _ in cand], k)]
        draft_ms = (time.perf_counter() - t_d) * 1e3
        self._spec_stats.record_draft_ms(draft_ms)
        self.metrics.spec_draft_ms.observe(draft_ms, draft=draft_kind)

        def _pad(drafts, ctx):
            d = [int(t) for t in drafts][:k]
            if len(d) < k:
                pad = d[-1] if d else int(ctx[-1])
                d = d + [pad] * (k - len(d))
            return d

        toks = np.zeros((self.max_batch, S), np.int32)
        lens = np.zeros((self.max_batch,), np.int32)
        starts = np.zeros((self.max_batch,), np.int32)
        cand_toks = (np.zeros((self.max_batch, N, S), np.int32)
                     if multi else None)
        with self._cv:
            rows = []
            for (i, s, ctx, nxt), clists in zip(cand, cand_lists):
                if self._slots[i] is not s:
                    continue
                dl = [_pad(d, ctx) for d in clists[:N]]
                if not dl:
                    dl = [[int(ctx[-1])] * k]
                while len(dl) < N:
                    dl.append(dl[0])
                toks[i, 0] = nxt
                toks[i, 1:] = dl[0]
                lens[i] = S
                starts[i] = self._pos_host[i]
                if multi:
                    cand_toks[i, :, 0] = nxt
                    for c_n, c_d in enumerate(dl):
                        cand_toks[i, c_n, 1:] = c_d
                rows.append((i, s, dl))
            # coverage for S appends per row, preempting on exhaustion;
            # rows the reserve drops sit this verify out
            surviving = self._reserve_decode_locked(
                [(i, s) for i, s, _ in rows], S)
            dmap = {i: d for i, _, d in rows}
            rows = [(i, s, dmap[i]) for i, s in surviving]
            for i in set(dmap) - {i for i, _, _ in rows}:
                lens[i] = 0
        if not rows:
            return
        chaos.check("serving.dispatch")
        self._upload_mirrors()
        t0 = time.perf_counter()
        if tree:
            # trie ranking pass (read-only): candidates sharing a prefix
            # share nodes; the deepest accepted root path becomes the
            # write-path verify's draft
            M = self._spec_tree_m
            toks_tr = np.zeros((self.max_batch, M), np.int32)
            pos_tr = np.zeros((self.max_batch, M), np.int32)
            mask_tr = np.zeros((self.max_batch, M, M), bool)
            mask_tr[:, np.arange(M), np.arange(M)] = True  # inactive rows
            lens_tr = np.zeros((self.max_batch,), np.int32)
            trees = {}
            for i, s, dl in rows:
                tr = build_tree(int(toks[i, 0]), dl, k, M)
                trees[i] = tr
                t_toks, t_dep, t_mask = tr.arrays(M)
                toks_tr[i] = t_toks
                pos_tr[i] = int(starts[i]) + t_dep
                mask_tr[i] = t_mask
                lens_tr[i] = tr.size
            ids_tree = llama.paged_verify_tree(
                vp, self._cache, self._upload(toks_tr),
                self._upload(pos_tr), self._upload(mask_tr),
                self._upload(lens_tr), self._upload(starts), self.cfg,
                kv_attention=self.kv_attention,
            ).cpu().numpy()  # [B, M]
            for i, s, dl in rows:
                path = trees[i].walk(ids_tree[i])
                # the walk leaves the greedy chain only where that chain
                # already mismatched: switching never shortens acceptance
                switched = bool(path) and path != dl[0][:len(path)]
                self._spec_stats.record_candidates(trees[i].size, switched)
                if switched:
                    dl[0] = _pad(path, [toks[i, 0]])
                    toks[i, 1:] = dl[0]
        elif multi:
            ids_multi = llama.paged_verify_multi(
                vp, self._cache, self._upload(cand_toks),
                self._upload(lens), self._upload(starts), self.cfg,
                kv_attention=self.kv_attention,
            ).cpu().numpy()  # [B, N, S]
            for i, s, dl in rows:
                best = 0
                best_a = accept_length(dl[0], ids_multi[i, 0][:k])
                for c_n in range(1, N):
                    a_n = accept_length(dl[c_n], ids_multi[i, c_n][:k])
                    if a_n > best_a:
                        best, best_a = c_n, a_n
                self._spec_stats.record_candidates(N, best != 0)
                if best:
                    dl[0] = dl[best]  # the accept loop reads dl[0]
                    toks[i, 1:] = dl[0]
        t_v = time.perf_counter()
        ids_dev, self._cache = llama.paged_verify(
            vp, self._cache, self._upload(toks), self._upload(lens),
            self._upload(starts), self.cfg, kv_attention=self.kv_attention,
        )
        acct["dispatch_ms"] += (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        ids = ids_dev.cpu().numpy()  # [B, S]
        t2 = time.perf_counter()
        acct["harvest_ms"] += (t2 - t1) * 1e3
        with self._cv:
            for i, s, dl in rows:
                drafts = dl[0]
                a = accept_length(drafts, ids[i][:k])
                if self._slots[i] is not s:
                    continue  # vacated mid-verify; writes land in trash
                take = min(a + 1, self._rem(s))
                s.out_ids.extend(int(t) for t in ids[i][:take])
                s.fed += take
                # rewind past the rejected suffix: the device advanced pos
                # by S, the mirror keeps only accepted history
                self._pos_host[i] = min(int(starts[i]) + take,
                                        self.max_seq - 1)
                self._trim_row_locked(i, int(self._pos_host[i]))
                self._spec_stats.record(k, a, take)
                self.metrics.spec_proposed.inc(k, draft=draft_kind)
                self.metrics.spec_accepted.inc(a, draft=draft_kind)
                if s.span_id:
                    TRACER.record("engine.spec_round", start=t_d,
                                  duration=time.perf_counter() - t_d,
                                  trace=s.trace, parent_id=s.span_id,
                                  k=k, accepted=int(a), emitted=take)
                self._maybe_finalize_locked(i, s)
            p = self._pipe
            p["spec_rounds"] += 1
            p["verify_ms_sum"] += (t2 - t_v) * 1e3
            p["spec_ms_sum"] += (time.perf_counter() - t_round) * 1e3
            self._admit_locked()
            self._cv.notify_all()
        # the verify consumed host-fed tokens: any device chain is stale
        self._chain = None
        acct["segments"] += 1
        acct["host_ms"] += (time.perf_counter() - t2) * 1e3

    def _commit_tick(self, acct: Dict, tick_ms: float) -> None:
        """Fold one tick's accounting into the pipeline stats and the
        metrics: one fold a tick, from host values only (the allocator's
        block walk included, once)."""
        overlap_ms = (acct["dispatch_ms"] + acct["host_ms"]
                      if acct["overlapped"] else 0.0)
        with self._cv:
            p = self._pipe
            p["ticks"] += 1
            p["segments"] += acct["segments"]
            p["deferred_harvests"] += acct["deferred"]
            p["flushes"] += acct["flushes"]
            p["chain_rebuilds"] += acct["rebuilds"]
            p["dispatch_ms_sum"] += acct["dispatch_ms"]
            p["harvest_ms_sum"] += acct["harvest_ms"]
            p["host_ms_sum"] += acct["host_ms"]
            p["tick_ms_sum"] += tick_ms
            p["overlap_ms_sum"] += overlap_ms
            self._pipe_recent.append(
                (acct["dispatch_ms"], acct["harvest_ms"], acct["host_ms"],
                 tick_ms))
            queued = len(self._waiting)
            ratio = p["overlap_ms_sum"] / max(p["tick_ms_sum"], 1e-9)
        m = self.metrics
        if acct["segments"]:
            m.segments.inc(acct["segments"])
        if acct["deferred"]:
            m.deferred_harvests.inc(acct["deferred"])
        if acct["flushes"]:
            m.pipeline_flushes.inc(acct["flushes"])
        if acct["rebuilds"]:
            m.chain_rebuilds.inc(acct["rebuilds"])
        m.dispatch_ms.observe(acct["dispatch_ms"])
        m.harvest_ms.observe(acct["harvest_ms"])
        m.host_ms.observe(acct["host_ms"])
        m.overlap_ratio.set(ratio)
        m.queue_depth.set(float(queued))
        if self._paged:
            st = self._alloc.stats()
            kern = {"attention_kernel": self.kv_attention,
                    "role": self.role}
            m.kv_blocks_total.set(float(st["total"]), **kern)
            m.kv_blocks_free.set(float(st["free"]), **kern)
            m.kv_blocks_shared.set(float(st["shared"]), **kern)
        if self._spec_stats is not None:
            m.spec_acceptance_rate.set(self._spec_stats.acceptance_rate())

    @torch.no_grad()
    def _loop_once(self) -> bool:
        """One tick of the DOUBLE-BUFFERED decode pipeline; returns True
        when the engine is stopping. In steady state (segment N-1 in
        flight on the device):

            dispatch prefill (new rows)        } queued behind N-1, ids
            dispatch decode segment N          } chained ON THE DEVICE
            harvest segment N-1                — waits on N-1's copy ...
            bookkeeping/finalize/admission     } ... then all of this
            harvest prefill first ids          } overlaps N's device time

        Freshly prefilled rows join segment N in the same tick: their
        first ids are merged into the device chain
        (``llama.merge_chain_tokens``). Nothing in the dispatch half reads
        a device value: uploads go through pinned staging and harvests
        wait on recorded events, on the one stream whose order keeps
        segment N behind N-1 (the pools are updated in place). When
        requests are waiting, the in-flight segment is harvested FIRST so
        finished rows free up (bounded admission latency)."""
        with self._cv:
            self._admit_locked()
            while (not self._stop and self._pending is None
                   and not self._export_q and not self._exports
                   and not any(s is not None for s in self._slots)):
                self._gc_handoffs_locked()
                self._cv.wait(timeout=0.2)
                self._admit_locked()
            stop = self._stop
            waiting = bool(self._waiting)
        # handoff exports: gathers queued on the stream before this
        # tick's dispatches, their host copies completed after them
        self._service_exports()
        if stop:
            self._harvest_segment()  # flush: deliver in-flight tokens
            self._finish_exports()
            return True

        t_tick = time.perf_counter()
        acct = {"dispatch_ms": 0.0, "harvest_ms": 0.0, "host_ms": 0.0,
                "overlapped": False, "segments": 0, "deferred": 0,
                "flushes": 0, "rebuilds": 0}
        if waiting and self._pending is not None:
            h, b = self._harvest_segment()
            acct["harvest_ms"] += h
            acct["host_ms"] += b
            acct["flushes"] += 1

        with self._cv:
            self._admit_locked()
            active = list(self._slots)
            # one weight version per tick: every dispatch below uses this
            # tree only; rows of co-resident versions sit the tick out
            tick_version = self._pick_tick_version_locked(active)
            vp = self._versions[tick_version]

        if tick_version != self._default_version:
            # seeded canary degradation: hits only non-default-version
            # ticks, so a drill can degrade a canary while the baseline
            # traffic on the same replica stays healthy
            chaos.check("serving.canary_dispatch")

        def _mine(s: _Slot) -> bool:
            return (s.version or self._default_version) == tick_version

        # ---- prefill DISPATCH (first ids sampled and kept on the device)
        pre: list = []
        ids_copy = None
        todo = [(i, s) for i, s in enumerate(active)
                if s is not None and s.fed == 0 and _mine(s)]
        if todo and self.prefill_chunk_tokens:
            pre, ids_copy = self._prefill_chunks(todo, acct, vp)
        elif todo:
            pre, ids_copy = self._prefill_whole(todo, acct, vp)
        if todo:
            with self._cv:
                active = list(self._slots)

        if self.spec_k and pre:
            # speculative ticks feed the verify window from HOST context:
            # collect first ids now, so fresh rows join this tick's verify
            h, b = self._harvest_prefill(pre, ids_copy)
            acct["harvest_ms"] += h
            acct["host_ms"] += b
            pre, ids_copy = [], None
            with self._cv:
                active = list(self._slots)

        decoding = [
            (i, s) for i, s in enumerate(active)
            if s is not None and s.fed >= len(s.prompt) and self._rem(s) > 0
            and _mine(s)
        ]

        # ---- speculative verify: when every decoding row is greedy;
        # mixed-temperature traffic takes the segment path unchanged
        if decoding and self.spec_k and all(
                float(s.temperature) <= 0.0 for _, s in decoding):
            if self._pending is not None:
                # the draft's host context needs the in-flight tokens
                h, b = self._harvest_segment()
                acct["harvest_ms"] += h
                acct["host_ms"] += b
                acct["flushes"] += 1
                with self._cv:
                    decoding = [(i, s) for i, s in decoding
                                if self._slots[i] is s and self._rem(s) > 0]
            if decoding:
                self._spec_tick(decoding, acct, vp)
            decoding = []

        new_pending = None
        if decoding:
            need = max(self._rem(s) for _, s in decoding)
            with self._cv:
                cap = 4 if self._waiting else self.SEGMENT_BUCKETS[0]
            k = self.segment_size(need, cap)
            temps = np.zeros((self.max_batch,), np.float32)
            for i, s in decoding:
                temps[i] = max(float(s.temperature), 0.0)
            greedy = not np.any(temps > 0.0)
            # feed from the DEVICE chain whenever it covers the rows
            chain_ok = (self._chain is not None
                        and self._chain[0] == self._prefill_gen
                        and {i for i, _ in decoding} <= set(self._chain[1]))
            if chain_ok:
                tokens_dev = self._chain[2]
            else:
                # stale or absent chain: rebuild the feed from HOST tokens;
                # in-flight values must land first
                h, b = self._harvest_segment()
                acct["harvest_ms"] += h
                acct["host_ms"] += b
                if pre:
                    h, b = self._harvest_prefill(pre, ids_copy)
                    acct["harvest_ms"] += h
                    acct["host_ms"] += b
                    pre = []
                acct["flushes"] += 1
                acct["rebuilds"] += 1
                decoding = [(i, s) for i, s in decoding
                            if self._slots[i] is s and self._rem(s) > 0]
                tokens = np.zeros((self.max_batch, 1), np.int32)
                for i, s in decoding:
                    tokens[i, 0] = s.next_input()
                tokens_dev = self._upload(tokens)
        if decoding and self._paged:
            # block growth for the segment's k appends; rows that cannot
            # grow sit this dispatch out (their pos mirror stays put)
            with self._cv:
                decoding = self._reserve_decode_locked(decoding, k)
        if decoding:
            # an injected device fault: raising here exercises _loop's
            # recovery (fail the in-flight rows, rebuild the cache, reset
            # the pipeline, keep serving)
            chaos.check("serving.dispatch")
            temps_dev = self._temps_dev(temps)
            self._upload_mirrors()
            t0 = time.perf_counter()
            ev = None
            if self.device.type == "cuda":
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            if self._paged:
                toks, last, self._cache = llama.paged_decode_segment(
                    vp, self._cache, tokens_dev, temps_dev, self._gen,
                    self.cfg, n_steps=k, greedy=greedy,
                    kv_attention=self.kv_attention,
                    nonfinite=self._nonfinite,
                )
            else:
                # every row of the contiguous cache advances on the
                # device; rows not decoding are reset at readmission
                toks, last, self._cache = llama.decode_segment(
                    vp, self._cache, tokens_dev, temps_dev, self._gen,
                    self.cfg, n_steps=k, greedy=greedy,
                    nonfinite=self._nonfinite, split=self._split,
                )
            if ev is not None:
                ev[1].record()
            toks_copy = self._staging.download(toks)
            dispatch_ms = (time.perf_counter() - t0) * 1e3
            acct["dispatch_ms"] += dispatch_ms
            rows = tuple(i for i, _ in decoding)
            if chain_ok and set(self._chain[1]) - set(rows):
                # rows that sat this segment out (another version's, or
                # rows the reserve dropped) keep their chain token, so the
                # next tick need not rebuild the feed from the host
                mask = np.zeros((self.max_batch,), bool)
                mask[list(rows)] = True
                last = llama.merge_chain_tokens(
                    self._chain[2], last[:, 0], self._upload(mask))
                rows = tuple(sorted(set(self._chain[1]) | set(rows)))
            self._chain = (self._prefill_gen, rows, last)
            sched = []
            with self._cv:
                for i, s in decoding:
                    take = min(k, self._rem(s))
                    s.pending += take
                    s.fed += take
                    sched.append((i, s, take))
                    # scheduled rows advance k steps on the device; rows
                    # NOT scheduled keep their mirror
                    self._pos_host[i] = min(int(self._pos_host[i]) + k,
                                            self.max_seq - 1)
                self._pipe["inflight"] = 1
            new_pending = {"toks": toks_copy, "sched": sched, "k": k,
                           "ev": ev, "dispatch_ms": dispatch_ms, "t0": t0}
            acct["segments"] += 1

        # ---- harvest: segment N-1's ids (then prefill's first ids)
        # while segment N runs on the device — the overlap window
        if self._pending is not None:
            if new_pending is not None:
                acct["overlapped"] = True
                acct["deferred"] += 1
            else:
                acct["flushes"] += 1  # the pipeline drains this tick
            h, b = self._harvest_segment()
            acct["harvest_ms"] += h
            acct["host_ms"] += b
        if pre:
            h, b = self._harvest_prefill(pre, ids_copy)
            acct["harvest_ms"] += h
            acct["host_ms"] += b
        self._finish_exports()
        self._pending = new_pending
        self._commit_tick(acct, (time.perf_counter() - t_tick) * 1e3)
        return False


def make_handler(engine: LlamaEngine, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            log.debug(fmt, *args)

        def _json(self, code: int, payload: dict,
                  headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _shed(self, e: EngineOverloaded) -> None:
            self._json(
                503, {"error": str(e), "shed": True, "reason": e.reason},
                headers={"Retry-After": str(int(e.retry_after_s + 0.999))},
            )

        def do_GET(self):
            path, _, qs = self.path.partition("?")
            if path == "/healthz":
                self._json(200, {"status": "ok"})
            elif path == "/v1/stats":
                self._json(200, engine.stats())
            elif path == "/v1/trace":
                # flight-recorder pull: this replica's retained spans,
                # optionally one trace's (the router and
                # scripts/tracemerge.py read this)
                q = urllib.parse.parse_qs(qs)
                tid = (q.get("trace_id") or [""])[0]
                limit = int((q.get("limit") or ["0"])[0] or 0)
                spans = TRACER.trace_spans(tid) if tid else TRACER.spans()
                if limit > 0:
                    spans = spans[-limit:]
                self._json(200, {
                    "enabled": TRACER.enabled,
                    "spans": [span_to_dict(s) for s in spans],
                })
            elif path == "/metrics":
                body = engine.metrics.registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/v1/models":
                self._json(200, {
                    "models": [{
                        "name": model_name,
                        "max_seq": engine.max_seq,
                        "params": engine.cfg.num_params(),
                        "versions": engine.versions(),
                    }]
                })
            else:
                self._json(404, {"error": "not found"})

        def _read_json(self) -> dict:
            length = int(self.headers.get("Content-Length", "0"))
            return json.loads(self.rfile.read(length) or b"{}")

        def _trace(self):
            """The caller's context from ``X-Trace-Context`` (None when
            absent or malformed: propagation never fails a request)."""
            return parse_trace_header(self.headers.get(TRACE_HEADER))

        def _deadline_s(self):
            """(timeout_s, deadline header or None); None when an expired
            X-Deadline-Ms was answered with 504 already."""
            hdr = self.headers.get("X-Deadline-Ms")
            if hdr is None:
                return 600.0, None
            timeout_s = float(hdr) / 1000.0
            if timeout_s <= 0:
                self._json(504, {"error": "deadline exceeded"})
                return None, hdr
            return timeout_s, hdr

        def _admin(self) -> None:
            """/admin/{load,activate,retire}_version: a failed load leaves
            the serving versions untouched (400 for a bad request or a
            missing / torn artifact, 500 for anything else)."""
            try:
                req = self._read_json()
                version = str(req.get("version", ""))
                if self.path == "/admin/load_version":
                    try:
                        engine.load_version(version,
                                            str(req.get("ckpt_dir", "")))
                    except ValueError as e:
                        self._json(400, {"error": str(e),
                                         "load_failed": True})
                        return
                    except Exception as e:
                        self._json(500, {"error": str(e),
                                         "load_failed": True})
                        return
                    self._json(200, engine.versions())
                elif self.path == "/admin/activate_version":
                    prev = engine.activate_version(version)
                    self._json(200, dict(engine.versions(), previous=prev))
                else:
                    known = engine.retire_version(version)
                    self._json(200, dict(engine.versions(), retired=known))
            except Exception as e:
                self._json(400, {"error": str(e)})

        def _prefill(self) -> None:
            """/v1/prefill: generate's body; answers with the KVH1 bytes."""
            try:
                req = self._read_json()
                timeout_s, _hdr = self._deadline_s()
                if timeout_s is None:
                    return
                h = engine.prefill_handoff(
                    req.get("prompt_ids", []),
                    int(req.get("max_tokens", 16)),
                    float(req.get("temperature", 0.0)),
                    timeout_s=timeout_s,
                    cache_prefix=bool(req.get("cache_prefix", False)),
                    request_id=str(req.get("request_id", "")),
                    trace=self._trace(),
                    model_version=str(req.get("model_version", "")),
                )
                body = h.to_bytes()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except UnknownModelVersion as e:
                self._json(400, {"error": str(e), "unknown_version": True})
            except EngineOverloaded as e:
                self._shed(e)
            except HandoffError as e:
                self._json(502, {"error": str(e), "handoff_failed": True})
            except Exception as e:
                self._json(400, {"error": str(e)})

        def _adopt(self) -> None:
            """/v1/adopt: a KVH1 body; answers with generate's result."""
            try:
                length = int(self.headers.get("Content-Length", "0"))
                h = KVHandoff.from_bytes(self.rfile.read(length))
                timeout_s, hdr = self._deadline_s()
                if timeout_s is None:
                    return
                result = engine.adopt_handoff(h, timeout_s=timeout_s,
                                              trace=self._trace())
                if result.get("handoff_failed"):
                    self._json(502, result)
                    return
                if result.get("timed_out") and hdr is not None:
                    self._json(504, {"error": "deadline exceeded"})
                    return
                self._json(200, result)
            except UnknownModelVersion as e:
                self._json(400, {"error": str(e), "unknown_version": True})
            except EngineOverloaded as e:
                self._shed(e)
            except Exception as e:
                self._json(400, {"error": str(e)})

        def do_POST(self):
            if self.path == "/v1/cancel":
                try:
                    req = self._read_json()
                    ok = engine.cancel(str(req.get("request_id", "")))
                    self._json(200, {"cancelled": ok})
                except Exception as e:
                    self._json(400, {"error": str(e)})
                return
            if self.path == "/admin/drain":
                engine.drain()
                self._json(200, {"draining": True})
                return
            if self.path in ("/admin/load_version", "/admin/activate_version",
                             "/admin/retire_version"):
                self._admin()
                return
            if self.path == "/v1/prefill":
                self._prefill()
                return
            if self.path == "/v1/adopt":
                self._adopt()
                return
            if self.path != "/v1/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                req = self._read_json()
                timeout_s, deadline_hdr = self._deadline_s()
                if timeout_s is None:
                    return
                dbg = req.get("debug")
                result = engine.generate(
                    req.get("prompt_ids", []),
                    int(req.get("max_tokens", 16)),
                    float(req.get("temperature", 0.0)),
                    timeout_s=timeout_s,
                    cache_prefix=bool(req.get("cache_prefix", False)),
                    request_id=str(req.get("request_id", "")),
                    trace=self._trace(),
                    debug_trace=bool(isinstance(dbg, dict)
                                     and dbg.get("trace")),
                    model_version=str(req.get("model_version", "")),
                )
                if result.get("timed_out") and deadline_hdr is not None:
                    self._json(504, {"error": "deadline exceeded"})
                    return
                self._json(200, result)
            except UnknownModelVersion as e:
                self._json(400, {"error": str(e), "unknown_version": True})
            except EngineOverloaded as e:
                self._shed(e)
            except Exception as e:  # serving must not die on a bad request
                self._json(400, {"error": str(e)})

    return Handler


def engine_kwargs(cfg: Dict, ckpt_dir: str) -> Dict:
    """How KUBEDL_SERVE_CONFIG maps onto the engine — the reference's
    keys, defaults and environment fallbacks, plus the port's ``max_seq``,
    ``device`` and ``seed``."""
    return {
        "preset": cfg.get(
            "preset", os.environ.get("KUBEDL_SERVE_PRESET", "tiny")
        ),
        "ckpt_dir": ckpt_dir,
        "max_batch": int(cfg.get("max_batch", 4)),
        "max_seq": int(cfg.get("max_seq", 0)),
        "quantize": cfg.get(
            "quantize", os.environ.get("KUBEDL_SERVE_QUANTIZE", "")
        ),
        "mesh_axes": cfg.get("mesh") or None,
        "max_queue_depth": int(cfg.get("max_queue_depth", 64)),
        "max_queue_age_s": float(cfg.get("max_queue_age_s", 30.0)),
        "prefix_cache_mb": float(cfg.get("prefix_cache_mb", 64.0)),
        "kv_layout": cfg.get(
            "kv_layout", os.environ.get("KUBEDL_SERVE_KV_LAYOUT", "paged")
        ),
        "kv_block_size": int(cfg.get("kv_block_size", 16)),
        "kv_blocks": int(cfg.get("kv_blocks", 0)),
        "spec_k": int(
            cfg.get("spec_k", os.environ.get("KUBEDL_SERVE_SPEC_K", "0"))
        ),
        "spec_draft": cfg.get(
            "spec_draft", os.environ.get("KUBEDL_SERVE_SPEC_DRAFT", "ngram")
        ),
        "kv_attention": cfg.get(
            "kv_attention",
            os.environ.get("KUBEDL_SERVE_KV_ATTENTION", "gather"),
        ),
        "spec_candidates": int(
            cfg.get(
                "spec_candidates",
                os.environ.get("KUBEDL_SERVE_SPEC_CANDIDATES", "1"),
            )
        ),
        "spec_draft_layers": int(cfg.get("spec_draft_layers", 0)),
        "spec_tree": bool(
            cfg.get(
                "spec_tree",
                os.environ.get("KUBEDL_SERVE_SPEC_TREE", "") == "1",
            )
        ),
        "prefill_chunk_tokens": int(
            cfg.get(
                "prefill_chunk_tokens",
                os.environ.get("KUBEDL_SERVE_PREFILL_CHUNK", "0"),
            )
        ),
        "role": cfg.get(
            "role", os.environ.get("KUBEDL_SERVE_ROLE", "colocated")
        ),
        "advertise_prefix_len": int(cfg.get("advertise_prefix_len", 8)),
        "model_version": cfg.get(
            "model_version",
            os.environ.get("KUBEDL_SERVE_MODEL_VERSION", "base"),
        ),
        "device": cfg.get("device", os.environ.get("KUBEDL_SERVE_DEVICE"))
        or None,
        "seed": int(cfg.get("seed", 0)),
    }


def mirror_model_root(root: str) -> str:
    """Mirror a remote model root (a blob prefix) into
    ``<tmp>/kubedl-serve-cache-<uid>/<sha256(root)[:16]>`` and return that
    directory, as the reference's ``serve_main`` does: a predictor may run
    on another host than the trainer that published the version."""
    import hashlib
    import tempfile

    cache = os.path.join(tempfile.gettempdir(),
                         f"kubedl-serve-cache-{os.getuid()}",
                         hashlib.sha256(root.encode()).hexdigest()[:16])
    os.makedirs(cache, exist_ok=True)
    n = download_tree(root, cache)
    log.info("fetched %d blobs from %s", n, root)
    return cache


def serve_main(env: Optional[Dict] = None) -> int:
    """Container entrypoint: build the engine from ``KUBEDL_SERVE_CONFIG``
    and serve until SIGTERM (main thread) or the ``_KUBEDL_CANCEL``
    event in ``env`` is set; either drains gracefully first. The kernel
    build cache (``KUBEDL_COMPILE_CACHE_DIR``) is enabled first."""
    env = env or {}
    for k, v in env.items():
        # changed string values only; the cancel event is not an env var
        if isinstance(v, str) and os.environ.get(k) != v:
            os.environ[k] = v
    from kubedl_tpu_torch.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()  # before the engine's first kernel
    cfg = json.loads(os.environ.get("KUBEDL_SERVE_CONFIG", "{}"))
    ckpt = os.environ.get("KUBEDL_MODEL_PATH", "")
    if is_remote_root(ckpt):
        ckpt = mirror_model_root(ckpt)
    port = int(cfg.get("port", 8080))
    host = cfg.get("host") or os.environ.get("KUBEDL_SERVE_HOST", "127.0.0.1")
    if cfg.get("chaos"):
        # a seeded fault schedule for THIS replica (a drill against
        # subprocess replicas cannot share an in-process plan); same seed,
        # same fault trace. Armed process-wide, as in the reference.
        plan = chaos.plan_from_config(cfg["chaos"])
        chaos.arm(plan)
        log.info("armed chaos plan seed=%d sites=%s", plan.seed,
                 sorted(cfg["chaos"].get("sites") or {}))
    kwargs = engine_kwargs(cfg, ckpt)
    engine = LlamaEngine(**kwargs)
    model_name = cfg.get("model_name", kwargs["preset"])
    server = ThreadingHTTPServer((host, port), make_handler(engine, model_name))
    log.info("serving %s on %s:%d (%s)", model_name, host, port,
             engine.device if engine.mesh is None
             else engine.mesh.describe())
    drain_grace = float(cfg.get("drain_grace_s", 10.0))

    def graceful_stop() -> None:
        engine.drain()
        engine.wait_drained(drain_grace)
        server.shutdown()

    if threading.current_thread() is threading.main_thread():
        import signal

        signal.signal(
            signal.SIGTERM,
            lambda *_: threading.Thread(target=graceful_stop,
                                        daemon=True).start(),
        )
    cancel = env.get("_KUBEDL_CANCEL")
    if cancel is not None:
        def watch():
            cancel.wait()
            graceful_stop()

        threading.Thread(target=watch, daemon=True).start()
    try:
        server.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.close()
    return 0


if __name__ == "__main__":
    import sys

    logging.basicConfig(level=logging.INFO)
    sys.exit(serve_main())
