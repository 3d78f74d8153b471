"""PyTorch inference server: the paged-KV serving engine and its HTTP surface.

Port of ``kubedl_tpu/serving/server.py`` for ``kv_layout="paged"``:

- GET  /healthz            -> {"status": "ok"}
- GET  /v1/models          -> model metadata
- GET  /v1/stats           -> live counters (same keys where ported)
- POST /v1/generate        -> {"prompt_ids": [...], "max_tokens": N,
                               "temperature": T}
                              -> {"token_ids": [...], "latency_ms": ...}
- POST /v1/cancel, /admin/drain

The JSON bodies are the reference's, so the unchanged router can front a
PyTorch replica. Runs as ``python -m kubedl_tpu_torch.serving.server``
or through :func:`serve_main`; the engine runs on the card unless
``device`` is ``"cpu"``.

What this slice serves, and what it rejects: continuous batching over a
block-table KV pool, whole-prompt and chunked prefill, multi-step decode
segments with on-device sampling, preemption under block exhaustion,
shedding, drain and cancel. The prefix cache, speculative decoding,
disaggregated roles, int8 weights, mesh sharding, checkpoint restore,
weight hot-swap and the contiguous layout are later slices: asking for
them raises ``ValueError`` rather than being ignored.

Harvest is SYNCHRONOUS in this slice: a tick dispatches a decode segment
and copies its sampled ids to the host before the next tick (the
reference double-buffers, overlapping the harvest with the next
segment). The host pos/bt mirrors stay authoritative and are uploaded
(copied, never shared with numpy) before every dispatch.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

from kubedl_tpu_torch import resolve_device
from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.models import paged_attention
from kubedl_tpu_torch.serving.kv_blocks import BlockAllocator

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
                 request_id: str = "") -> None:
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.request_id = request_id  # non-empty: cancellable via cancel()
        self.fed = 0  # inputs consumed (prompt + generated)
        #: chunked-prefill progress: prompt tokens whose KV is committed;
        #: -1 = chunking not started
        self.prefill_pos = -1
        self.version = ""
        self.ttft_ms: Optional[float] = None
        self.out_ids: list = []
        self.done = threading.Event()
        self.result: Optional[Dict] = None
        self.t0 = time.perf_counter()

    def next_input(self) -> int:
        seq = self.prompt + self.out_ids
        return int(seq[self.fed])


def _unported(knob: str, slice_name: str) -> ValueError:
    return ValueError(
        f"{knob} is not served by the PyTorch port yet ({slice_name} is a "
        "later port slice)"
    )


def _pct(vals, q: float) -> float:
    srt = sorted(vals)
    return round(srt[min(len(srt) - 1, int(len(srt) * q))], 3)


class LlamaEngine:
    """Continuous-batching decode engine over a paged KV pool: up to
    ``max_batch`` sequences share each forward, a scheduler thread admits
    waiting requests into free rows between ticks, prefill runs whole
    prompts (or ``prefill_chunk_tokens``-sized chunks) and decode runs in
    multi-step segments with on-device sampling — only sampled ids cross
    to the host, once per segment.

    ``kv_attention`` picks the attention implementation of the paged
    forwards: ``"gather"`` (the dense oracle over the gathered view) or
    ``"blocked"`` (the Hopper kernels on the card: the fused decode
    kernel every decode step, the blocked kernel every prefill chunk).
    ``params`` serves a given parameter tree (e.g. one carried over with
    ``llama.params_from_numpy``) instead of the seeded random init."""

    #: allowed decode-segment sizes, largest first; segments shrink to 4
    #: whenever requests are waiting (admission latency <= 4 tokens)
    SEGMENT_BUCKETS = (32, 4, 1)

    def __init__(self, preset: str = "tiny", ckpt_dir: str = "",
                 max_seq: int = 0, max_batch: int = 4,
                 quantize: str = "", mesh_axes: Optional[Dict] = None,
                 max_queue_depth: int = 64, max_queue_age_s: float = 30.0,
                 prefix_cache_mb: float = 0.0,
                 kv_layout: str = "paged", kv_block_size: int = 16,
                 kv_blocks: int = 0, spec_k: int = 0,
                 kv_attention: str = "gather",
                 prefill_chunk_tokens: int = 0,
                 role: str = "colocated",
                 model_version: str = "base",
                 device=None, seed: int = 0,
                 params: Optional[Dict] = None) -> None:
        if kv_layout != "paged":
            if kv_layout == "contiguous":
                raise _unported("kv_layout='contiguous'", "the contiguous cache")
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if role not in ("", "colocated"):
            if role in ("prefill", "decode"):
                raise _unported(f"role={role!r}", "disaggregated serving")
            raise ValueError(
                f"unknown serving role {role!r} "
                "(have: colocated, prefill, decode)"
            )
        if kv_attention not in ("gather", "blocked"):
            raise ValueError(
                f"unknown kv_attention {kv_attention!r} "
                "(have: gather, blocked)"
            )
        if quantize:
            raise _unported(f"quantize={quantize!r}", "int8 weight-only serving")
        if mesh_axes:
            raise _unported("mesh_axes", "sharded (mesh) serving")
        if int(spec_k) > 0:
            raise _unported("spec_k > 0", "speculative decoding")
        if float(prefix_cache_mb) > 0:
            raise _unported("prefix_cache_mb > 0", "the prefix cache")
        if ckpt_dir:
            raise _unported("ckpt_dir", "checkpoint restore")
        self.device = resolve_device(device)
        self.role = "colocated"
        self.kv_attention = kv_attention
        self.cfg = llama.preset(preset)
        self.max_seq = max_seq or min(self.cfg.max_seq, 512)
        self.max_batch = max_batch
        bs = max(1, int(kv_block_size))
        self.kv_block_size = bs
        # the gathered view is [B, MB * BS]: max_seq rounds UP to whole blocks
        self.max_seq = ((self.max_seq + bs - 1) // bs) * bs
        pct = max(0, int(prefill_chunk_tokens))
        #: chunked prefill: > 0 caps the prompt tokens one tick prefills,
        #: block-aligned so no KV block is written by two dispatches
        self.prefill_chunk_tokens = (
            max(bs, (pct // bs) * bs) if pct else 0
        )
        self._default_version = str(model_version) or "base"
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            params = llama.llama_init(self.cfg, gen, self.device)
        self.params = params
        self._versions: Dict[str, object] = {self._default_version: params}
        mb = self.max_seq // bs
        if kv_blocks:
            nb = int(kv_blocks)
            if nb < mb + 1:
                raise ValueError(
                    f"kv_blocks={nb} cannot hold one max_seq row "
                    f"({mb} blocks + trash)"
                )
        else:
            # parity sizing: every batch row can reach max_seq
            nb = 1 + self.max_batch * mb
        self.kv_blocks = nb
        self._alloc = BlockAllocator(nb, bs)
        #: host-authoritative mirrors of the device cache's pos/bt —
        #: uploaded (copied) before EVERY dispatch
        self._pos_host = np.zeros((self.max_batch,), np.int32)
        self._bt_host = np.zeros((self.max_batch, mb), np.int32)
        self._row_blocks: list = [[] for _ in range(self.max_batch)]
        self._cache = llama.init_paged_cache(
            self.cfg, self.max_batch, self.max_seq, nb, bs, self.device
        )
        #: sampling noise: one explicit generator on the engine's device
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        #: running count of non-finite logits (device scalar, no host sync)
        self._nonfinite = torch.zeros((), dtype=torch.int64, device=self.device)
        self._slots: list = [None] * self.max_batch
        self._waiting: "deque[_Slot]" = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._draining = False
        self._requests: Dict[str, _Slot] = {}
        self._stats = {"requests": 0, "tokens_out": 0, "tokens_in": 0,
                       "shed": 0, "drain_rejects": 0,
                       "kv_preemptions": 0, "kv_sheds": 0,
                       "started_at": time.time()}
        self._pipe = {"ticks": 0, "segments": 0, "prefills": 0,
                      "prefill_chunks": 0, "decode_steps": 0,
                      "decode_tokens": 0, "decode_ms_sum": 0.0,
                      "errors": 0}
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

    @torch.no_grad()
    def _warmup(self) -> None:
        """One decode step over vacant rows (all writes land in the trash
        block): builds the kernels and warms the allocator before the
        first request. Host mirrors stay authoritative."""
        tokens = torch.zeros((self.max_batch, 1), dtype=torch.int32,
                             device=self.device)
        logits, self._cache = llama.paged_decode_step_batched(
            self.params, self._cache, tokens, self.cfg,
            kv_attention=self.kv_attention,
        )
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

    # -- versions (hot-swap is a later slice) --------------------------------

    def load_version(self, version: str, ckpt_dir: str) -> None:
        raise _unported("weight hot-swap (load_version)", "the model lifecycle")

    def activate_version(self, version: str) -> str:
        raise _unported("weight hot-swap (activate_version)",
                        "the model lifecycle")

    def retire_version(self, version: str) -> bool:
        raise _unported("weight hot-swap (retire_version)",
                        "the model lifecycle")

    def versions(self) -> Dict:
        with self._cv:
            rows = sum(1 for s in self._slots if s is not None)
        return {"default": self._default_version,
                "loaded": sorted(self._versions), "retiring": [],
                "active_rows": {self._default_version: rows} if rows else {}}

    def _resolve_version_locked(self, requested: str) -> str:
        v = str(requested or "") or self._default_version
        if v not in self._versions:
            raise UnknownModelVersion(
                f"unknown model version {v!r} (loaded: {sorted(self._versions)})"
            )
        return v

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

    def generate(self, prompt_ids, max_tokens: int = 16,
                 temperature: float = 0.0, timeout_s: float = 600.0,
                 request_id: str = "", model_version: str = "") -> Dict:
        budget = self.max_seq - 1
        prompt = [int(t) for t in list(prompt_ids)[:budget]]
        if not prompt:
            prompt = [0]
        max_tokens = max(0, min(int(max_tokens), budget - len(prompt)))
        slot = _Slot(prompt, max_tokens, float(temperature),
                     request_id=request_id)
        with self._cv:
            slot.version = self._resolve_version_locked(model_version)
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
                retry = max(1.0, min(self.max_queue_age_s, 0.25 * depth))
                raise EngineOverloaded(
                    f"queue depth {depth} (budget {self.max_queue_depth}), "
                    f"head age {head_age:.1f}s (budget {self.max_queue_age_s}s)",
                    retry_after_s=retry,
                )
            if not self._alloc.admission_open():
                # KV-pool pressure: below the low watermark a queued
                # request cannot be admitted anyway — reject at the door
                self._stats["shed"] += 1
                self._stats["kv_sheds"] += 1
                self._shed_recent.append(time.time())
                raise EngineOverloaded(
                    f"free KV blocks {self._alloc.free_count}/"
                    f"{self._alloc.total} below low watermark",
                    retry_after_s=1.0,
                )
            self._waiting.append(slot)
            if request_id:
                self._requests[request_id] = slot
            self._cv.notify_all()
        if not slot.done.wait(timeout=timeout_s):
            # an abandoned request must not keep occupying a batch row
            with self._cv:
                if slot in self._waiting:
                    self._waiting.remove(slot)
                self._vacate_locked(slot)
        result = slot.result or {"error": "timed out", "timed_out": True}
        with self._cv:
            if request_id:
                self._requests.pop(request_id, None)
            self._stats["requests"] += 1
            self._stats["tokens_in"] += len(prompt)
            self._stats["tokens_out"] += len(result.get("token_ids", []))
            self._recent.append(time.time())
        return result

    def stats(self) -> Dict:
        """Live serving counters (one snapshot under one lock)."""
        now = time.time()
        with self._cv:
            out = dict(self._stats)
            pipe = dict(self._pipe)
            recent = sum(1 for t in self._recent if t > now - self.qps_window_s)
            shed_recent = sum(
                1 for t in self._shed_recent if t > now - self.qps_window_s
            )
            queued = len(self._waiting)
            active = sum(1 for s in self._slots if s is not None)
            ttft = list(self._ttft_recent)
            qwait = list(self._queue_wait_recent)
            draining = self._draining
        up = max(now - out["started_at"], 1e-9)
        out.update({
            "role": self.role, "draining": draining,
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
        out["kv_blocks"] = self._alloc.stats()
        out["kv_blocks"]["attention_kernel"] = self.kv_attention
        out["kv_blocks"]["role"] = self.role
        pipe["harvest"] = "synchronous"
        if pipe["decode_steps"]:
            pipe["ms_per_decode_step"] = round(
                pipe["decode_ms_sum"] / pipe["decode_steps"], 4
            )
        if pipe["decode_ms_sum"] > 0:
            pipe["decode_tokens_per_s"] = round(
                pipe["decode_tokens"] / (pipe["decode_ms_sum"] / 1e3), 3
            )
        out["pipeline"] = pipe
        out["kernel_launches"] = dict(paged_attention.LAUNCHES)
        out["nonfinite_logits"] = int(self._nonfinite.item())
        out["versions"] = self.versions()
        return out

    # -- paged KV bookkeeping (host mirrors + block lifecycle) -------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Upload a host mirror as a device-OWNED copy (``torch.tensor``
        copies; ``torch.from_numpy`` would alias the live mirror)."""
        return torch.tensor(arr, device=self.device)

    def _upload_mirrors(self) -> None:
        self._cache["pos"] = self._upload(self._pos_host)
        self._cache["bt"] = self._upload(self._bt_host)

    def _free_row_locked(self, i: int) -> None:
        """Return row ``i``'s blocks and point its table at the trash
        block. Caller holds cv."""
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

    def _pick_victim_locked(self, held) -> Optional[int]:
        """The YOUNGEST resident row not in ``held`` (least sunk work)."""
        best = None
        for j, s in enumerate(self._slots):
            if s is None or j in held or not self._row_blocks[j]:
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
        s.fed = 0
        s.prefill_pos = -1
        s.out_ids = []
        self._waiting.appendleft(s)
        self._stats["kv_preemptions"] += 1
        log.warning("KV blocks exhausted: preempted row %d (requeued)", j)

    def _reserve_decode_locked(self, decoding, steps: int):
        """Ensure every decoding row can cache ``steps`` more positions,
        preempting victims when the pool runs dry; rows that still cannot
        grow sit this dispatch out. Caller holds cv."""
        out = []
        for i, s in decoding:
            if self._slots[i] is not s:
                continue  # preempted earlier in this very loop
            need = min(int(self._pos_host[i]) + steps, self.max_seq)
            while True:
                if self._reserve_locked(i, need):
                    out.append((i, s))
                    break
                victim = self._pick_victim_locked({i} | {j for j, _ in out})
                if victim is None:
                    break
                self._preempt_locked(victim)
        return out

    def _admit_row_locked(self, i: int, slot: _Slot) -> bool:
        """Admit ``slot`` into row ``i``: allocate blocks for the prompt
        plus its first token (all-or-nothing). Caller holds cv."""
        need = self._alloc.blocks_for(min(len(slot.prompt) + 1, self.max_seq))
        got = self._alloc.alloc(need)
        if got is None:
            return False
        self._row_blocks[i] = list(got)
        self._bt_host[i, :] = 0
        self._bt_host[i, :len(got)] = got
        self._pos_host[i] = 0
        self._slots[i] = slot
        return True

    def _admit_locked(self) -> None:
        for i in range(self.max_batch):
            if self._slots[i] is None and self._waiting:
                if not self._alloc.admission_open():
                    break  # below low watermark: hysteresis holds
                head = self._waiting[0]
                if not self._admit_row_locked(i, head):
                    break  # pool dry: wait for frees
                self._waiting.popleft()
                wait_ms = (time.perf_counter() - head.t0) * 1e3
                self._queue_wait_recent.append(wait_ms)

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
                            s.done.set()
                    self._cache = llama.init_paged_cache(
                        self.cfg, self.max_batch, self.max_seq,
                        self.kv_blocks, self.kv_block_size, self.device,
                    )
                    self._alloc = BlockAllocator(self.kv_blocks,
                                                 self.kv_block_size)
                    self._pos_host[:] = 0
                    self._bt_host[:] = 0
                    self._row_blocks = [[] for _ in range(self.max_batch)]
                    self._pipe["errors"] += 1

    def _rem(self, s: _Slot) -> int:
        """Remaining token budget for a slot."""
        done = len(s.out_ids)
        return min(s.max_tokens - done,
                   (self.max_seq - 1) - (len(s.prompt) + done))

    def _maybe_finalize_locked(self, i: int, s: _Slot) -> None:
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
                "cached_prefix_len": 0,
                "model_version": s.version or self._default_version,
            }
            if s.ttft_ms is not None:
                s.result["ttft_ms"] = round(s.ttft_ms, 3)
            self._slots[i] = None
            self._free_row_locked(i)
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

    def _sample(self, logits: torch.Tensor, temps: np.ndarray) -> np.ndarray:
        """First-token sampler on the device (greedy rows take argmax,
        temp > 0 rows Gumbel-max); only the [B] ids cross to the host."""
        self._nonfinite += (~torch.isfinite(logits)).sum()
        t = torch.tensor(temps, device=self.device)
        if np.any(temps > 0.0):
            g = -torch.log(torch.empty_like(logits).exponential_(
                generator=self._gen))
            z = torch.where(t[:, None] > 0.0,
                            logits / torch.clamp(t[:, None], min=1e-4) + g,
                            logits)
        else:
            z = logits
        return torch.argmax(z, dim=-1).to(torch.int32).cpu().numpy()

    def _first_tokens_locked(self, rows, ids: np.ndarray) -> None:
        """Record prefill-sampled first tokens for rows whose prompt is
        now fully cached. Caller holds cv."""
        now = time.perf_counter()
        for i, s in rows:
            if self._slots[i] is not s:
                continue  # vacated (timeout/cancel) mid-prefill
            s.fed = len(s.prompt)
            budgeted = (s.max_tokens > 0 and len(s.prompt) + len(s.out_ids)
                        < self.max_seq - 1)
            if budgeted:
                s.out_ids.append(int(ids[i]))
                if s.ttft_ms is None:
                    s.ttft_ms = (now - s.t0) * 1e3
                    self._ttft_recent.append(s.ttft_ms)
            self._maybe_finalize_locked(i, s)

    def _prefill_whole(self, todo) -> None:
        """Whole prompts from position 0 in one forward (dense causal
        attention over the fresh K/V, scatter into the row's blocks)."""
        bucket = self._prefill_bucket(max(len(s.prompt) for _, s in todo))
        toks = np.zeros((self.max_batch, bucket), np.int32)
        lens = np.zeros((self.max_batch,), np.int32)
        temps0 = np.zeros((self.max_batch,), np.float32)
        for i, s in todo:
            toks[i, :len(s.prompt)] = s.prompt
            lens[i] = len(s.prompt)
            temps0[i] = max(float(s.temperature), 0.0)
        self._upload_mirrors()
        logits, self._cache = llama.paged_prefill_batched(
            self.params, self._cache, self._upload(toks), self._upload(lens),
            self.cfg,
        )
        ids = self._sample(logits, temps0)
        with self._cv:
            self._pipe["prefills"] += 1
            for i, s in todo:
                if self._slots[i] is s:
                    self._pos_host[i] = min(len(s.prompt), self.max_seq - 1)
            self._first_tokens_locked(todo, ids)

    def _prefill_chunks(self, todo) -> None:
        """Chunked prefill: spend at most ``prefill_chunk_tokens`` prompt
        tokens this tick across the not-yet-prefilled rows, FIFO by
        arrival. Every chunk runs the suffix prefill at the row's
        committed position (the blocked kernel on the card); non-final
        chunks are block-aligned. Only rows whose FINAL chunk lands this
        tick sample a first token."""
        bs = self.kv_block_size
        left = self.prefill_chunk_tokens
        sched = []  # (row, slot, base, take, final)
        for i, s in sorted(todo, key=lambda t: t[1].t0):
            if left <= 0:
                break
            base = max(s.prefill_pos, 0)
            rem = max(0, len(s.prompt) - base)
            take = min(rem, left)
            if take < rem:
                take = (take // bs) * bs
                if take <= 0:
                    break
            sched.append((i, s, base, take, base + take >= len(s.prompt)))
            left -= take
        if not sched:
            return
        bucket = self._prefill_bucket(max(t for _i, _s, _b, t, _f in sched))
        toks = np.zeros((self.max_batch, bucket), np.int32)
        lens = np.zeros((self.max_batch,), np.int32)
        starts = np.zeros((self.max_batch,), np.int32)
        temps0 = np.zeros((self.max_batch,), np.float32)
        for i, s, base, take, _final in sched:
            toks[i, :take] = s.prompt[base:base + take]
            lens[i] = take
            starts[i] = base
            temps0[i] = max(float(s.temperature), 0.0)
        self._upload_mirrors()
        logits, self._cache = llama.paged_prefill_from(
            self.params, self._cache, self._upload(toks), self._upload(lens),
            self._upload(starts), self.cfg, kv_attention=self.kv_attention,
        )
        final = [(i, s) for i, s, _b, _t, f in sched if f]
        ids = self._sample(logits, temps0) if final else None
        with self._cv:
            self._pipe["prefill_chunks"] += len(sched)
            for i, s, base, take, _final in sched:
                if self._slots[i] is not s:
                    continue  # vacated mid-chunk
                self._pos_host[i] = min(base + take, self.max_seq - 1)
                s.prefill_pos = base + take
            if final:
                self._first_tokens_locked(final, ids)

    def _decode(self, decoding) -> None:
        """One multi-step decode segment over the decoding rows, sampled
        on device; ids are harvested synchronously."""
        need = max(self._rem(s) for _, s in decoding)
        with self._cv:
            cap = 4 if self._waiting else self.SEGMENT_BUCKETS[0]
            k = self.segment_size(need, cap)
            # block growth for the segment's k appends (preempting victims
            # on exhaustion; rows that still cannot grow sit this one out)
            decoding = self._reserve_decode_locked(decoding, k)
        if not decoding:
            return
        temps = np.zeros((self.max_batch,), np.float32)
        tokens = np.zeros((self.max_batch, 1), np.int32)
        for i, s in decoding:
            temps[i] = max(float(s.temperature), 0.0)
            tokens[i, 0] = s.next_input()
        greedy = not np.any(temps > 0.0)
        self._upload_mirrors()
        t0 = time.perf_counter()
        toks, _last, self._cache = llama.paged_decode_segment(
            self.params, self._cache, self._upload(tokens),
            self._upload(temps), self._gen, self.cfg, n_steps=k,
            greedy=greedy, kv_attention=self.kv_attention,
            nonfinite=self._nonfinite,
        )
        rows = toks.cpu().numpy()  # the synchronous harvest
        dt_ms = (time.perf_counter() - t0) * 1e3
        with self._cv:
            p = self._pipe
            p["segments"] += 1
            p["decode_steps"] += k
            p["decode_ms_sum"] += dt_ms
            for i, s in decoding:
                if self._slots[i] is not s:
                    continue  # vacated (timeout/cancel) mid-segment
                take = min(k, self._rem(s))
                self._pos_host[i] = min(int(self._pos_host[i]) + k,
                                        self.max_seq - 1)
                s.fed += take
                s.out_ids.extend(int(t) for t in rows[i][:take])
                p["decode_tokens"] += take
                self._maybe_finalize_locked(i, s)

    @torch.no_grad()
    def _loop_once(self) -> bool:
        """One scheduler tick; returns True when the engine is stopping:
        admit, prefill newly admitted rows (whole or one chunk budget),
        then one decode segment over the decoding rows."""
        with self._cv:
            self._admit_locked()
            while not self._stop and not any(
                s is not None for s in self._slots
            ):
                self._cv.wait(timeout=0.2)
                self._admit_locked()
            if self._stop:
                return True
            active = list(self._slots)
        todo = [(i, s) for i, s in enumerate(active)
                if s is not None and s.fed == 0]
        if todo and self.prefill_chunk_tokens:
            self._prefill_chunks(todo)
        elif todo:
            self._prefill_whole(todo)
        with self._cv:
            self._admit_locked()
            decoding = [
                (i, s) for i, s in enumerate(self._slots)
                if s is not None and s.fed >= len(s.prompt)
                and self._rem(s) > 0
            ]
        if decoding:
            self._decode(decoding)
        with self._cv:
            self._pipe["ticks"] += 1
            self._admit_locked()
            self._cv.notify_all()
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
            path = self.path.partition("?")[0]
            if path == "/healthz":
                self._json(200, {"status": "ok"})
            elif path == "/v1/stats":
                self._json(200, engine.stats())
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
            if self.path != "/v1/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                req = self._read_json()
                timeout_s = 600.0
                deadline_hdr = self.headers.get("X-Deadline-Ms")
                if deadline_hdr is not None:
                    timeout_s = float(deadline_hdr) / 1000.0
                    if timeout_s <= 0:
                        self._json(504, {"error": "deadline exceeded"})
                        return
                result = engine.generate(
                    req.get("prompt_ids", []),
                    int(req.get("max_tokens", 16)),
                    float(req.get("temperature", 0.0)),
                    timeout_s=timeout_s,
                    request_id=str(req.get("request_id", "")),
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
    keys and environment fallbacks. ``prefix_cache_mb`` defaults to 0
    until the prefix cache is ported (the reference defaults to 64)."""
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
        "prefix_cache_mb": float(cfg.get("prefix_cache_mb", 0.0)),
        "kv_layout": cfg.get(
            "kv_layout", os.environ.get("KUBEDL_SERVE_KV_LAYOUT", "paged")
        ),
        "kv_block_size": int(cfg.get("kv_block_size", 16)),
        "kv_blocks": int(cfg.get("kv_blocks", 0)),
        "spec_k": int(
            cfg.get("spec_k", os.environ.get("KUBEDL_SERVE_SPEC_K", "0"))
        ),
        "kv_attention": cfg.get(
            "kv_attention",
            os.environ.get("KUBEDL_SERVE_KV_ATTENTION", "gather"),
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
        "model_version": cfg.get(
            "model_version",
            os.environ.get("KUBEDL_SERVE_MODEL_VERSION", "base"),
        ),
        "device": cfg.get("device", os.environ.get("KUBEDL_SERVE_DEVICE"))
        or None,
        "seed": int(cfg.get("seed", 0)),
    }


def serve_main(env: Optional[Dict] = None) -> int:
    """Container entrypoint: build the engine from ``KUBEDL_SERVE_CONFIG``
    and serve until SIGTERM (main thread) or the ``_KUBEDL_CANCEL``
    event in ``env`` is set; either drains gracefully first."""
    env = env or {}
    for k, v in env.items():
        # changed string values only; the cancel event is not an env var
        if isinstance(v, str) and os.environ.get(k) != v:
            os.environ[k] = v
    cfg = json.loads(os.environ.get("KUBEDL_SERVE_CONFIG", "{}"))
    if cfg.get("chaos"):
        raise _unported("chaos", "fault injection")
    ckpt = os.environ.get("KUBEDL_MODEL_PATH", "")
    port = int(cfg.get("port", 8080))
    host = cfg.get("host") or os.environ.get("KUBEDL_SERVE_HOST", "127.0.0.1")
    kwargs = engine_kwargs(cfg, ckpt)
    engine = LlamaEngine(**kwargs)
    model_name = cfg.get("model_name", kwargs["preset"])
    server = ThreadingHTTPServer((host, port), make_handler(engine, model_name))
    log.info("serving %s on %s:%d (%s)", model_name, host, port, engine.device)
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
