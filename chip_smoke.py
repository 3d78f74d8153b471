"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card
    python3 chip_smoke.py --skip-engine  # without phases 5, 6, 13-19, 22
    python3 chip_smoke.py --skip-train   # without phases 8 to 12, 21, 23-25

Phases (any failure exits non-zero before the final line):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA.
2. build: compiles the port's CUDA sources (kubedl_tpu_torch/csrc) with
   nvcc for sm_90a (``-Xptxas -v``), one nvcc per source started
   together, and prints the build seconds; then, for each tensor-core
   kernel (flash forward, fused backward and the split pair at hd 64,
   128 and 256, paged prefill at hd 64, 128 and 256), its registers and
   spill bytes (ptxas) and its
   count of HGMMA instructions (``cuobjdump -sass``), failing if one has
   none or if a split-pair or hd-256 flash kernel spills; the same for
   the W8A16
   kernels (the
   decode route's instantiations and its split-K combine, the prefill
   route's wgmma kernel), failing if one spills or the prefill kernel
   has no HGMMA; the tensor-core decode's instantiations
   (``paged_decode_mma_kernel<RT>``, RT = 1..8 n8 tiles of query rows):
   registers, spills and HMMA count, failing if one spills or holds no
   HMMA; and the optimizer kernels' registers and spills
   (``csrc/adamw.cu``: the norm, its finish, the update for each
   parameter / first-moment type), failing if one spills.
3. blocked entry vs its plain PyTorch version at the serving shapes
   (Llama-3-8B: B=8, KV=8, group 4, hd 128, BS 16, MB 128, S in {1, 64,
   512}; Gemma-2B: hd 256, KV 1, group 8, S in {1, 8, 64, 512}), ragged
   starts, block boundaries, a poisoned trash block and an all-trash row,
   bf16 and f32, two calls bit-identical, each case's route printed
   (``paged_route``: split-K, tensor cores or CUDA cores); kernel, plain
   and library (SDPA over the gathered view) times (see ``time_ms``: "ms"
   is the call's device time with the host's queueing hidden, "call_ms"
   one call with the queueing in it). Then speculative verify's shapes:
   Llama-3-8B widths at S in {2, 5, 8} (R = S*group < 64: the split-K
   route), bf16 and f32, starts that cross block boundaries and clamp at
   max_s - 1 (``VERIFY_STARTS``), S=5 bf16 timed, and S=5 at Gemma-2B's
   widths: bf16 on the tensor-core decode (R = 40), timed, and f32 on
   split-K; and one hd-64 case.
4. fused decode entry (S=1, KV write fused: split-K at Llama-3-8B's
   widths and in f32, the tensor-core decode at Gemma-2B's bf16) vs
   plain scatter + plain attention: pools bitwise equal outside the trash
   block, outputs within tolerance, a second call on fresh pools
   bit-identical; the first call runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (the decode path must not
   sync); long-context cases (MB=512, 8192 positions) at both widths,
   where the short rows use few splits and Gemma-2B's long rows walk the
   tensor-core decode's ring; the same timings.
5. the engine: ``serve_main`` serving Llama-3-8B (full width and depth,
   seeded random weights; the reference's defaults: the double-buffered
   tick, the prefix cache at 64 MB) on 127.0.0.1, 8 concurrent
   /v1/generate requests (6 greedy, 2 at temperature 0.8, prompts of
   64-1536 tokens, 128 new tokens each); gates on every response, on both
   kernels' launch counts during that run, on a deferred (overlapped)
   harvest and on finite logits; prints ms per decode step, decode
   tokens/s, TTFT p50/p95 and the pipeline's fields; then the same
   requests on a kv_attention="gather" engine, whose greedy-token
   agreement with the blocked run is printed (not gated: bf16 logits of
   random weights have near-ties); then Llama-3-8B width cut to 2 layers
   in float32, where the blocked and gather engines' greedy streams must
   be identical (gated: f32 leaves no near-ties at these logit gaps).
6. profile: the blocked Llama-3-8B engine again, 32 new tokens per
   request, under torch.profiler (device activity only): device time
   and kernel count by category (paged attention by entry point and the
   split-K merge, matmul, other) and the device's busy share of the wall
   time.
7. flash kernels vs their plain PyTorch versions: the llama3-1b training
   shape (B=4, H=32, KV=8, S=2048, hd=64, bf16, causal, with and without
   fused RoPE), Llama-3-8B (hd 128) and Gemma-2B (hd 256) head widths, a
   ragged non-causal S=1000, and float32 at each hd: out and lse against
   the plain forward, the fused backward and the split pair against the
   plain backward and against each other; at the training shape each
   kernel's time (CUDA events, median of 20, L2 flushed; device time and
   call time as in phase 3), the plain
   version's, its bound, and SDPA's forward / backward as the yardstick
   (SDPA's backward is also the split pair's: one call computes dq, dk and
   dv, so it is held against the pair's dq + dk/dv + group sum).
   Gemma-2B's training shape (B=4, H=8, KV=1, S=2048, hd 256, bf16,
   causal, Gemma's RoPE tables, theta 10000) is timed the same way, all
   four operators on the tensor cores; each case prints every operator's
   route. Then the split pair at the long-context training shape (B=1,
   H=32, KV=8, S=32768, hd 64, bf16, causal, RoPE), where ``bwd_route``
   is "split":
   against the plain versions run head by head (one q-head with its
   kv-head a call: one float32 score tensor of all 32 heads would be
   137 GB) and against the tensor-core fused kernel, with the same
   timings; and a head slice (H=4, KV=1, S=16384) through
   ``flash_backward`` with the split route forced, against the plain
   versions run whole. Then the split pair at Gemma-2B's 8192-token
   context (B=1, H=8, KV=1, S=8192, hd 256, bf16, causal, theta 10000),
   where ``bwd_route`` is "split": dq, dk_h, dv_h and the group-summed
   dk/dv against the plain versions run head by head and against the
   tensor-core fused kernel, timed against SDPA's backward and against
   ``flash_backward`` with the fused route forced; at both Gemma-2B
   shapes a MISS line (not a failure) where a kernel of the pair is over
   6x its bound or the pair over 2.5x SDPA's backward. And bench-moe's
   training shape (B=8, H=16, KV=8, S=2048, hd 64, bf16, causal, theta
   10000 RoPE: GQA group 2, phase 25's path), untimed.
8. training: ``train_main`` with KUBEDL_TRAIN_CONFIG={"model":
   "llama3-1b", "global_batch": 4, "seq_len": 2048, "steps": 8} on the
   card, full width and depth, seeded random weights; gates on finite
   losses and grad norms, attn_impl "flash", no sanity violations, 16
   flash_fwd + 16 flash_bwd_fused launches per step and 11 + 1 + 11
   optimizer launches per step (a norm and an update launch for each of
   the 11 leaves, one finish); prints step ms and MFU. Then Trainer.fit on
   one repeated batch must end below its first loss; then two steps with
   the backward forced to the split pair (16 + 16 launches per step).
9. f32 parity: llama3-1b width cut to 2 layers in float32 (TF32 off), one
   train step on the fused and split kernel routes against the dense
   route: losses within 1e-5 relative, gradients and updated params
   within the tolerances stated in ``run_train_f32_parity``.
10. profile: two llama3-1b train steps under torch.profiler: device time
   by category (flash fwd, flash bwd, the flash RoPE pre-pass, the
   optimizer's kernels, matmul, other) and the busy share.
11. long-context training: ``train_main`` with KUBEDL_TRAIN_CONFIG=
   {"model": "llama3-1b", "global_batch": 1, "seq_len": 32768, "steps": 4}
   (full width and depth; the trainer's long-context policy applies
   ``loss_chunk=512,remat_policy=flash_rope``, and ``bwd_route`` is
   "split"); gates on finite losses and grad norms, attn_impl "flash", no
   sanity violations, that policy string, and per step 16 flash_fwd (the
   policy saves the forward's outputs), 16 flash_bwd_dq, 16
   flash_bwd_dkdv and 0 flash_bwd_fused launches; prints step time,
   tokens/s, MFU (6N flops a token: attention's flops left out), peak
   memory, and a one-step profile with the split pair's two kernels as
   their own categories.
12. bf16 gate: llama3-1b width cut to 2 layers, bf16, B=1, S=32768, and
   Gemma-2B width cut to 2 layers, bf16, B=1, S=8192 (hd 256): the loss
   and every gradient leaf of one train step on the split route (the
   route at these lengths) against the same step with the fused route
   forced, within the tolerances stated in ``run_train_bf16_routes``.
13. shared prefix: ``serve_main`` with Llama-3-8B bf16, full depth,
   ``prefix_cache_mb`` 512, whole-prompt prefill: 8 greedy requests share
   a 1024-token system prompt (own 64-256-token suffixes, 64 new tokens);
   two go first (the observation trie stores the shared prompt at their
   prefill), then six graft it. Gates: prefix hits, tokens saved, every
   second-wave row grafting 1024 tokens, blocked launches on the grafted
   suffixes (and none at ``prefix_cache_mb`` 0, whose TTFT on the same
   waves is printed beside); a profiled repeat of the wave gives the
   grafted-suffix prefill's in-model time.
14. speculative: the main engine's config with ``spec_k`` 4 and the
   n-gram draft, then the model draft (``spec_draft_layers`` 4), 8 greedy
   requests x 64 tokens. Gates: verify rounds and blocked launches on the
   split-K route (S = 5); prints acceptance, tokens per verify, ms per
   emitted token, verify ms, and the verify launches' in-model time.
15. f32 greedy identity: Llama-3-8B width cut to 2 layers, float32: the
   prefix cache, ``spec_k`` 4 n-gram, ``spec_k`` 4 with 3 candidates and
   the tree, and the model draft must each give greedy streams IDENTICAL
   to the plain engine's (no prefix cache, no speculation).

16. W8A16 (weight-only int8 matmul, ``csrc/w8a16.cu``) against its plain
   version at Llama-3-8B's shapes (K x N in 4096 x 4096, 4096 x 1024,
   4096 x 14336, 14336 x 4096, 4096 x 128256; M in {1, 8, 40, 64, 512};
   bf16 and float32 h) and a tied [N, K] case at Gemma-2B widths, within
   ``W8_TOL``: bf16 through its static route (``w8a16_route``: decode up
   to 64 rows, prefill above) and through each route forced at every M,
   two calls bit-identical; float32 through the CUDA-core route. At the
   timed cases each timed route's device and call time, the plain
   version (dequantize, then torch.matmul), the dequantize alone, cuBLAS
   bf16 on the unquantized weight and the bound (both routes at M = 40
   and 64); the per-route sums over a decode step (M=8) and a verify
   step (M=40); a MISS line where the decode step's sum is not below
   cuBLAS's or M=512 4096 x 14336 is not below the plain version.
17. int8 engine: ``serve_main`` with ``quantize`` "int8" on phase 5's
   config and requests (Llama-3-8B full width and depth); gates on every
   response, 7 x 32 + 1 W8A16 op calls a decode step, every decode
   step's calls on the decode route and prefill chunks on the prefill
   route, the paged kernels, finite logits and resident weight bytes
   about half of phase 5's; prints ms per decode step and TTFT beside
   phase 5's bf16 ones and beside phase 5's engine run on the same
   requests right before and right after (the steps are host-bound and
   the host's speed drifts within a call), and the W8A16 op calls and
   device ms a decode step: calls counted in a window of pure decode,
   device ms from a profile of the whole wave (the decode kernel at
   M <= 8 and its split-K combine, over those calls). Then
   Llama-3-8B width, 2 layers, float32: the int8 engine's greedy streams
   with the kernel must equal the same engine's with the plain version
   forced (``forced_plain_w8a16``).
18. checkpoints and hot swap: Llama-3-8B width, 4 layers, bf16: two seeds'
   params written by the port's ``save_checkpoint``; ``serve_main`` with
   ``KUBEDL_MODEL_PATH`` restores the first (gated: every restored tensor
   and one prompt's logits equal the in-memory ones); /admin/load_version
   loads the second beside it, requests name each version,
   /admin/activate_version and /admin/retire_version run with rows in
   flight (gated: those rows finish, the retired tree is evicted and
   freed); prints save / load seconds and both fingerprints. Then 2
   layers in float32: a base version and a checkpoint loaded as "v2"
   give each version's greedy streams IDENTICAL to single-version
   engines', interleaved and across activate / retire.
19. disaggregated pair: two ``serve_main`` replicas on the card, role
   prefill and role decode, Llama-3-8B full depth bf16; phase 5's greedy
   requests go /v1/prefill -> KVH1 bytes -> /v1/adopt; gates on every
   response, handoffs_out == handoffs_in and each pool's free blocks;
   prints handoff ms and bytes and the bf16 agreement with phase 5's
   streams (not gated). Then 2 layers in float32: disaggregated greedy
   streams IDENTICAL to the colocated engine's.

22. Gemma-2B: ``serve_main`` with ``GEMMA_SERVE`` (phase 5's config with
   ``gemma-2b``: full width and depth, 18 layers, MQA at hd 256, seeded
   random bf16 weights) on phase 5's kind of traffic; gates in
   ``run_gemma_engine`` (every blocked call on the tensor-core route, the
   hd-256 kernel; every fused call on the tensor-core decode; no
   CUDA-core launch);
   prints TTFT p50/p95, ms a decode step, the routes, and from a profiled
   repeat of the wave the paged kernels' device ms a launch (the decode
   merges in its own launch: no merge kernel) and their share of device
   time. Then Gemma-2B width cut to 2 layers: in bf16,
   ``paged_prefill_from`` over a 512-token chunk at ragged starts with
   the kernel against the plain version forced (``GEMMA_LOGIT_TOL``); in
   float32, the blocked engine's greedy streams identical to the gather
   engine's.

23. Gemma-2B training: ``train_main`` with KUBEDL_TRAIN_CONFIG=
   ``GEMMA_TRAIN_CONFIG`` (``gemma-2b``, full width and depth: 18
   layers, 2,506,172,416 parameters, MQA at hd 256; b4 x s2048, 4 steps,
   ``loss_chunk`` 512; seeded random weights); gates on finite losses and
   grad norms, attn_impl "flash", no sanity violations, 18 flash_fwd + 18
   flash_bwd_fused launches a step and none of the split pair (the
   tensor-core forward and fused backward at hd 256), and phase 8's
   optimizer counts; prints step ms, tokens/s, MFU (6N: attention left
   out) and peak memory; then one step after one unprofiled step under
   torch.profiler: flash's share of device time, its device ms a launch,
   and the busy share.

24. Gemma-2B at its published context: ``train_main`` with
   KUBEDL_TRAIN_CONFIG=``GEMMA_LONG_TRAIN_CONFIG`` (``gemma-2b``, full
   width and depth, b1 x s8192, 4 steps, seeded random weights; the
   long-context policy ``loss_chunk=512,remat_policy=flash_rope``
   applies); checked before the run: ``bwd_route(8192, 256)`` is "split"
   and all four operators take the tensor cores at bf16 hd 256; gates as
   phase 11's (18 flash_fwd, 18 flash_bwd_dq, 18 flash_bwd_dkdv and 0
   flash_bwd_fused launches a step) and phase 8's optimizer counts;
   prints step ms, tokens/s, MFU (6N) and peak memory, then from one step
   after one unprofiled step the split pair's device ms a launch, its
   share of device time and the busy share.

25. MoE training: ``train_main`` with KUBEDL_TRAIN_CONFIG=
   ``MOE_TRAIN_CONFIG`` (``bench-moe``, full width and depth: 12 layers,
   8 experts of ffn 2048, top-1 routing at capacity factor 1.25, GQA 16
   q-heads over 8 kv-heads at hd 64, vocab 32768, bf16, remat
   "dots_flash"; b8 x s2048, 6 steps; seeded random weights, synthetic
   tokens); gates on finite losses and grad norms, attn_impl "flash", no
   sanity violations, an empty long-context policy, 12 flash_fwd + 12
   flash_bwd_fused launches a step and none of the split pair, and a norm
   and an update launch for each of its 12 leaves plus one finish a step;
   prints step ms, tokens/s, MFU (the reference's 6 x active parameters)
   and peak memory. Then ``Trainer.fit`` on one repeated batch must end
   below its first loss; one step after it under torch.profiler: device
   ms by category (flash, matmul, the MoE index passes, the optimizer,
   other), the busy share, and each layer's dropped-token share from one
   forward. Then ``moe_ffn`` (index dispatch) against ``moe_ffn_plain``
   (the reference's one-hot formula) at bench-moe width and 16,384
   tokens: float32 forward bit-identical and gradients within the
   tolerance stated in ``run_moe_dispatch``, bf16 outputs within one ulp,
   both timed. Then bench-moe width cut to 2 layers, float32: one train
   step on the flash route against the dense route with phase 9's gates.
   Then the same bf16 full-depth step run twice from one state (split
   route forced): bit-identical.

20. the optimizer update (``csrc/adamw.cu``) against its plain version on
   Llama-3.2-1B's 11 leaves (seeded, bf16 parameters, float32 first
   moment) at a step that does not clip and one that clips, with the
   gates stated in ``run_adamw_kernels``; prints its device and call ms,
   the bound, the plain version's ms and the closest library calls'
   (``clip_grad_norm_`` + ``torch.optim.AdamW(fused=True)``).
21. the training job's lifecycle: ``train_main`` on Llama-3.2-1B (full
   width and depth, b4 x s2048) with a seeded token file, a save every 2
   steps (async), ``KUBEDL_FAULT_ONCE_AT_STEP`` 3 and
   ``KUBEDL_MODEL_PATH``: the first run exits 137 leaving a complete
   step-2 checkpoint, the second resumes at step 2, runs to step 6 and
   publishes; ``serve_main`` restores the published parameters and
   answers 4 greedy requests on the paged kernels; the beacon shows step
   6; gates in ``run_lifecycle``; prints save, stall, restore and publish
   seconds. Then the identity at 2 layers in float32: the resumed run
   BIT-identical to an in-process chain of 2 steps, save, restore, 4
   steps on a fresh iterator.

Phase 16 runs after phase 4; phase 22, then phases 13-15 and 17-19 after
phase 6 (they are skipped with ``--skip-engine``); phase 20 after phase
7, then phases 23, 24 and 25, and phase 21 after phase 12 (skipped with
``--skip-train``).

Output: the kernels' JSON line, then as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

#: H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

#: Tolerances, max abs error against the plain version on the same inputs.
#: bf16: inputs N(0,1); both sides accumulate in float32 and round the
#: output to bf16 once, so they differ by at most ~1 bf16 ulp of |out| <= 4
#: (2^-6 = 0.0156) after reordered float32 sums: 2e-2.
#: f32: the same math with reordered float32 sums over <= 2048 keys: 1e-5.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}

LLAMA = dict(B=8, KV=8, H=32, hd=128, BS=16, MB=128)
GEMMA = dict(B=8, KV=1, H=8, hd=256, BS=16, MB=128)
STARTS = [0, 15, 16, 47, 300, 1023, 1500, 0]  # row 7: all-trash table
TRASH_ROW = 7
#: the long-context decode case: Llama-3-8B widths over 8192 positions,
#: mostly short rows (most of their splits empty) beside two long ones
LONG = dict(LLAMA, MB=512)
LONG_STARTS = [0, 15, 16, 47, 300, 4095, 8190, 0]
#: and at Gemma-2B's widths over its published 8192-token context (the
#: tensor-core decode's ring: the long rows' ranges exceed two stages)
GEMMA_LONG = dict(GEMMA, MB=512)

#: speculative verify's blocked calls (S = k+1 <= 8, so R = S*group < 64:
#: split-K at Llama-3-8B's widths, the tensor-core decode at Gemma-2B's
#: bf16): starts that cross block boundaries (14 + 5 > 16),
#: sit on one (47 + 1 = 48), end deep in the table and clamp at max_s - 1
#: (2045 + 8 > 2047); row 7 all-trash
VERIFY_STARTS = [14, 15, 30, 47, 300, 1020, 2045, 0]

#: the device phases 16-22 run on (the card; a CPU rehearsal sets "cpu")
DEV = "cuda"

REPLACES = {
    "paged_attention_blocked":
        "kubedl_tpu/models/paged_attention.py:181 _blocked_kernel",
    "paged_attention_fused":
        "kubedl_tpu/models/paged_attention.py:290 _fused_kernel",
}
#: the kernels line's design of a paged route, where a word is too short
PAGED_DESIGNS = {
    "mma_decode": "mma_decode: paged_decode_mma_kernel, one launch; "
                  "mma.sync m16n8k16 on S^T = K.Q^T and O^T = V^T.P^T "
                  "(P by movmatrix.trans), per-row key ranges cut on the "
                  "device, merged in the launch: a cooperative launch whose "
                  "CTAs of a row each merge a slice of its partials",
}
#: a timed case's fields kept beside the kernels line's main case
TIMED_KEYS = ("route", "max_abs_err", "ms", "call_ms", "plain_ms",
              "library_ms", "bound_ms", "bound_by")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---- timing -----------------------------------------------------------------

_flush = None
#: cycles the card spins before a timed call, so that the host has queued
#: the whole call before the start event fires: about 1 ms at the H100's
#: 1.98 GHz boost clock, against 0.05-0.2 ms to queue one call
HIDE_HOST_CYCLES = 2_000_000


def time_ms(fn, reps: int = 20, warmup: int = 3,
            hide_host: bool = True) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn``, with the 50 MB L2
    flushed before each (the engine meets every layer's pool cold). With
    ``hide_host`` the card is kept busy while the host queues the call, so
    the events bracket only the call's device work (its kernels and the
    gaps between them); without it they also take in the host's queueing
    of the call ("call_ms")."""
    global _flush
    if _flush is None:
        _flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        _flush.zero_()
        if hide_host:
            torch.cuda._sleep(HIDE_HOST_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---- inputs and bounds ------------------------------------------------------

def make_case(shape, S, dtype, seed, starts=STARTS):
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, KV, H, hd, BS, MB = (shape[k] for k in ("B", "KV", "H", "hd", "BS", "MB"))
    NB = 1 + B * MB
    kp = torch.randn((NB, BS, KV, hd), generator=g, device="cuda").to(dtype)
    vp = torch.randn((NB, BS, KV, hd), generator=g, device="cuda").to(dtype)
    kp[0] = 37.0  # poisoned trash block: a mask leak would blow the check
    vp[0] = -29.0
    perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
    bt = perm.to(torch.int32).reshape(B, MB).contiguous()
    bt[TRASH_ROW] = 0
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dtype)
    starts = torch.tensor(starts[:B], dtype=torch.int32, device="cuda")
    nk = torch.randn((B, KV, hd), generator=g, device="cuda").to(dtype)
    nv = torch.randn((B, KV, hd), generator=g, device="cuda").to(dtype)
    return q, kp, vp, bt, starts, nk, nv


def bound(shape, S, dtype, fused=False, starts=STARTS):
    """Least time for the work: K/V positions each row's queries can see
    read once (this run's starts), q read and out written once; flops
    4*hd per (query head, visible key), at the input type's peak."""
    B, KV, H, hd, BS, MB = (shape[k] for k in ("B", "KV", "H", "hd", "BS", "MB"))
    max_s = BS * MB
    esz = torch.tensor([], dtype=dtype).element_size()
    keys = vis = 0
    for st in starts[:B]:
        keys += min(st + S - 1, max_s - 1) + 1
        vis += sum(min(st + s, max_s - 1) + 1 for s in range(S))
    nbytes = 2 * keys * KV * hd * esz + 2 * B * S * H * hd * esz
    nbytes += 4 * (B * MB + B)  # block table + starts
    if fused:
        nbytes += 2 * 2 * B * KV * hd * esz  # new K/V read, pool slot written
    flops = 4 * hd * H * vis
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tc_copied_bytes(shape, S, starts=STARTS):
    """Bytes the tensor-core route's CTAs copy into shared memory: each
    CTA's Q tile, and every 64-key K/V tile up to its last visible key
    (each CTA of a row reads the row's K/V again; the bound counts each
    byte once). A CTA holds 128 folded query rows at hd 256, 192 below."""
    B, KV, H, hd, BS, MB = (shape[k] for k in ("B", "KV", "H", "hd", "BS", "MB"))
    group, bq = H // KV, 128 if shape["hd"] == 256 else 192
    R, max_s = S * group, BS * MB
    total = 0
    for st in starts[:B]:
        for r0 in range(0, R, bq):
            n_keys = min(st + (min(r0 + bq, R) - 1) // group, max_s - 1) + 1
            total += KV * 2 * hd * (bq + 2 * 64 * -(-n_keys // 64))
    return total


def sdpa_yardstick(q, kp, vp, bt, starts):
    """One PyTorch call computing the same attention: SDPA over the
    gathered view with the position mask (view built outside the timed
    call). A yardstick only — the port never calls SDPA."""
    import torch.nn.functional as F

    B, S, H, hd = q.shape
    KV = kp.shape[2]
    T = bt.shape[1] * kp.shape[1]
    kv_k = kp[bt.long()].reshape(B, T, KV, hd).transpose(1, 2)
    kv_v = vp[bt.long()].reshape(B, T, KV, hd).transpose(1, 2)
    kv_k = kv_k.repeat_interleave(H // KV, dim=1).contiguous()
    kv_v = kv_v.repeat_interleave(H // KV, dim=1).contiguous()
    qt = q.transpose(1, 2).contiguous()
    posq = torch.clamp(starts.long()[:, None]
                       + torch.arange(S, device="cuda")[None], max=T - 1)
    mask = (torch.arange(T, device="cuda")[None, None, :]
            <= posq[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kv_k, kv_v,
                                                  attn_mask=mask)


# ---- phases 3 and 4 ---------------------------------------------------------

def route_of(pa, shape, S, dtype, fused=False):
    return pa.paged_route(dtype, shape["hd"], S, shape["H"] // shape["KV"],
                          shape["BS"], fused)


def check_blocked(pa, shape, S, dtype, timed: bool, start_list=STARTS):
    q, kp, vp, bt, starts, _, _ = make_case(shape, S, dtype, seed=S + 11,
                                            starts=start_list)
    route = route_of(pa, shape, S, dtype)
    before = pa.ROUTE_LAUNCHES[route]
    out = pa.paged_attention(q, kp, vp, bt, starts)
    again = pa.paged_attention(q, kp, vp, bt, starts)
    torch.cuda.synchronize()
    ref = pa.plain_paged_attention(q, kp, vp, bt, starts)
    err = (out.float() - ref.float()).abs().max().item()
    if not math.isfinite(err) or err > TOL[dtype]:
        fail(f"blocked kernel {shape} S={S} {dtype}: max abs err {err} "
             f"> {TOL[dtype]}")
    if not torch.equal(out, again):
        fail(f"blocked kernel {shape} S={S} {dtype}: two calls differ")
    if pa.ROUTE_LAUNCHES[route] != before + 2:
        fail(f"blocked {shape} S={S} {dtype} did not take route {route}")
    rec = {"route": route, "max_abs_err": err}
    if timed:
        kern = lambda: pa.paged_attention(q, kp, vp, bt, starts)  # noqa: E731
        lib = sdpa_yardstick(q, kp, vp, bt, starts)
        rec["ms"], rec["call_ms"] = time_ms(kern), time_ms(kern, hide_host=False)
        rec["plain_ms"] = time_ms(
            lambda: pa.plain_paged_attention(q, kp, vp, bt, starts), reps=20,
            hide_host=False)
        rec["library_ms"] = time_ms(lib)
        rec["library_call_ms"] = time_ms(lib, hide_host=False)
        rec["bound_ms"], rec["bound_by"] = bound(shape, S, dtype,
                                                 starts=start_list)
        if route == pa.TENSOR_CORE:
            rec["smem_fill_bytes"] = tc_copied_bytes(shape, S, start_list)
    return rec


def check_fused(pa, shape, dtype, timed: bool, start_list=STARTS):
    q, kp, vp, bt, starts, nk, nv = make_case(shape, 1, dtype, seed=97,
                                              starts=start_list)
    kk, vk = kp.clone(), vp.clone()
    route = route_of(pa, shape, 1, dtype, fused=True)
    before = pa.ROUTE_LAUNCHES[route]
    torch.cuda.synchronize()
    # the decode path reads no device value: any sync in the call raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, kk2, vk2 = pa.paged_attention(q, kk, vk, bt, starts,
                                           new_k=nk, new_v=nv)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if kk2.data_ptr() != kk.data_ptr():
        fail("fused kernel did not update the pools in place")
    # a second call on fresh copies of the pools gives the same bits
    again_k, again_v = kp.clone(), vp.clone()
    again, _, _ = pa.paged_attention(q, again_k, again_v, bt, starts,
                                     new_k=nk, new_v=nv)
    torch.cuda.synchronize()
    if pa.ROUTE_LAUNCHES[route] != before + 2:
        fail(f"fused {shape} {dtype} did not take route {route}")
    kr, vr = kp.clone(), vp.clone()
    pa.plain_fused_write(kr, vr, bt, starts, nk, nv)
    # trash block 0 takes colliding garbage writes by contract
    for k_got, v_got in ((kk, vk), (again_k, again_v)):
        if not (torch.equal(k_got[1:], kr[1:])
                and torch.equal(v_got[1:], vr[1:])):
            fail(f"fused kernel pools differ from a scatter {shape} {dtype}")
    own = [b for b in range(shape["B"]) if b != TRASH_ROW]
    if not torch.equal(out[own], again[own]):
        fail(f"fused kernel {shape} {dtype}: two calls differ")
    ref = pa.plain_paged_attention(q, kr, vr, bt, starts)
    err = (out[own].float() - ref[own].float()).abs().max().item()
    if not math.isfinite(err) or err > TOL[dtype]:
        fail(f"fused kernel {shape} {dtype}: max abs err {err} > {TOL[dtype]}")
    rec = {"route": route, "max_abs_err": err, "sync_free": True}
    if timed:
        def kern():
            return pa.paged_attention(q, kk, vk, bt, starts, new_k=nk,
                                      new_v=nv)

        def plain():
            pa.plain_fused_write(kr, vr, bt, starts, nk, nv)
            return pa.plain_paged_attention(q, kr, vr, bt, starts)

        lib = sdpa_yardstick(q, kr, vr, bt, starts)
        rec["ms"], rec["call_ms"] = time_ms(kern), time_ms(kern, hide_host=False)
        rec["plain_ms"] = time_ms(plain, hide_host=False)
        rec["library_ms"] = time_ms(lib)
        rec["library_call_ms"] = time_ms(lib, hide_host=False)
        rec["bound_ms"], rec["bound_by"] = bound(shape, 1, dtype, fused=True,
                                                 starts=start_list)
    return rec


# ---- phase 2: what the compiler made of the tensor-core kernels --------------

#: the tensor-core kernels, by the names ptxas and cuobjdump print: the
#: source each is built from, and its template flags past the head width
#: (flash_bwd_tc_kernel<hd, true> is the fused backward, <hd, false> the
#: split pair's dk/dv)
TC_KERNELS = {"flash_fwd_tc_kernel": ("flash_attention.cu", ("",)),
              "flash_bwd_tc_kernel": ("flash_attention.cu",
                                      (", true", ", false")),
              "flash_bwd_dq_tc_kernel": ("flash_attention.cu", ("",)),
              "paged_prefill_tc_kernel": ("paged_attention.cu", ("",))}
#: the hd-256 tensor-core kernels: Gemma-2B's prefill (serving) and its
#: training paths' forward, fused backward and split pair
TC_KERNELS_HD256 = ("paged_prefill_tc_kernel<256>", "flash_fwd_tc_kernel<256>",
                    "flash_bwd_tc_kernel<256, true>",
                    "flash_bwd_dq_tc_kernel<256>",
                    "flash_bwd_tc_kernel<256, false>")
#: the split pair's tensor-core kernels and the hd-256 flash kernels, which
#: must not spill
NO_SPILL = ("flash_bwd_tc_kernel<64, false>", "flash_bwd_tc_kernel<128, false>",
            "flash_bwd_dq_tc_kernel<64>", "flash_bwd_dq_tc_kernel<128>",
            *TC_KERNELS_HD256[1:])


def _kernel_key(mangled: str):
    """``flash_bwd_tc_kernel<64, true>`` from a mangled name, or None."""
    m = re.search(r"(?<=\d)((?:flash|paged)_[a-z_]+?_kernel)ILi(\d+)E"
                  r"(?:Lb([01])E)?", mangled)
    if m is None or m.group(1) not in TC_KERNELS:
        return None
    flag = {None: "", "1": ", true", "0": ", false"}[m.group(3)]
    return f"{m.group(1)}<{m.group(2)}{flag}>"


def tc_kernel_report(build) -> dict:
    """Registers and spill bytes (ptxas -v, from this run's build) and
    HGMMA count (cuobjdump -sass of the built library) per tensor-core
    kernel instantiation. Fails if one was not found, has no HGMMA, or is
    a split-pair or hd-256 flash kernel and spills."""
    rep = {}
    for src in sorted({src for src, _ in TC_KERNELS.values()}):
        rep.update(_tc_source_report(build, src))
    want = {f"{k}<{hd}{flag}>" for k, (_, flags) in TC_KERNELS.items()
            for flag in flags for hd in (64, 128)}
    want.update(TC_KERNELS_HD256)  # Gemma-2B's
    if not want <= set(rep) or any(rep[k].get("hgmma", 0) == 0 for k in want):
        fail(f"tensor-core kernels missing or without HGMMA: {rep}")
    spills = {k: rep[k] for k in NO_SPILL
              if rep[k].get("spill_stores", 1) or rep[k].get("spill_loads", 1)}
    if spills:
        fail(f"split-pair or hd-256 flash kernels spill: {spills}")
    return rep


def _tc_source_report(build, src, key=_kernel_key) -> dict:
    rep, cur = {}, None
    for line in build.BUILD_LOG.get(src, "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", line)
        if m:
            cur = key(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rep.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rep.setdefault(cur, {})["registers"] = int(m.group(1))
    nvcc = build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    lib = build.build(src)
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass failed: {sass.stderr[-500:]}")
    cur = None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = key(m.group(1))
            if cur:
                rep.setdefault(cur, {})["hgmma"] = 0
        elif cur and "HGMMA" in line:
            rep[cur]["hgmma"] += 1
        elif cur and "HMMA" in line:
            rep[cur]["hmma"] = rep[cur].get("hmma", 0) + 1
    return rep


#: the tensor-core decode's instantiations (RT n8 tiles of query rows),
#: csrc/paged_attention.cu: both products on mma.sync, so each must hold
#: HMMA, and none may spill
MMA_KERNELS = tuple(f"paged_decode_mma_kernel<{rt}>" for rt in range(1, 9))


def _mma_key(mangled: str):
    """``paged_decode_mma_kernel<1>`` from a mangled name, or None."""
    m = re.search(r"paged_decode_mma_kernelILi(\d+)E", mangled)
    return None if m is None else f"paged_decode_mma_kernel<{m.group(1)}>"


def mma_kernel_report(build) -> dict:
    """Registers, spill bytes (ptxas -v) and HMMA count (cuobjdump -sass)
    of each tensor-core decode instantiation. Fails if one was not found,
    spills or holds no HMMA."""
    rep = _tc_source_report(build, "paged_attention.cu", key=_mma_key)
    missing = [k for k in MMA_KERNELS if "registers" not in rep.get(k, {})]
    spills = {k: v for k, v in rep.items()
              if v.get("spill_stores", 1) or v.get("spill_loads", 1)}
    no_hmma = [k for k in MMA_KERNELS if not rep.get(k, {}).get("hmma")]
    if missing or spills or no_hmma:
        fail(f"tensor-core decode kernels: missing {missing}, spilling "
             f"{spills}, without HMMA {no_hmma}: {rep}")
    return rep


#: the W8A16 kernels (csrc/w8a16.cu) phase 2 reports: the decode route's
#: instantiations (n8 tiles of h rows, tied layout), its split-K combine and
#: the prefill route's wgmma kernel; none may spill, and the prefill kernel
#: must hold HGMMA
W8_DECODE_TILES = (1, 2, 5, 8)
W8_KERNELS = (
    [f"w8a16_decode_kernel<{mt}, {t}>" for mt in W8_DECODE_TILES
     for t in ("false", "true")]
    + [f"w8a16_prefill_kernel<{bm}, {t}>" for bm in (128, 256)
       for t in ("false", "true")]
    + [f"w8a16_combine_kernel<{tag}>" for tag in (0,) + W8_DECODE_TILES])


def _w8_key(mangled: str):
    """``w8a16_decode_kernel<8, false>`` from a mangled name, or None."""
    m = re.search(r"(w8a16_[a-z]+_kernel)(?:I(?:Li(\d+)E)?(?:Lb([01])E)?)?",
                  mangled)
    if m is None:
        return None
    args = [a for a in (m.group(2), {"0": "false", "1": "true"}.get(
        m.group(3))) if a]
    name = m.group(1) + (f"<{', '.join(args)}>" if args else "")
    return name if name in W8_KERNELS else None


def w8_kernel_report(build) -> dict:
    """Registers, spill bytes and HGMMA count of the W8A16 kernels (this
    run's ptxas -v and cuobjdump -sass). Fails if one was not found or
    spills, or if the prefill kernel holds no HGMMA."""
    rep = _tc_source_report(build, "w8a16.cu", key=_w8_key)
    missing = [k for k in W8_KERNELS if "registers" not in rep.get(k, {})]
    spills = {k: v for k, v in rep.items()
              if v.get("spill_stores", 1) or v.get("spill_loads", 1)}
    no_hgmma = [k for k in W8_KERNELS if k.startswith("w8a16_prefill")
                and not rep.get(k, {}).get("hgmma")]
    if missing or spills or no_hgmma:
        fail(f"w8a16 kernels: missing {missing}, spilling {spills}, "
             f"prefill without HGMMA {no_hgmma}: {rep}")
    return rep


# ---- phase 7: flash kernels -------------------------------------------------

FLASH_REPLACES = {
    "flash_fwd": "kubedl_tpu/ops/flash_attention.py:120 _fwd_kernel",
    "flash_bwd_fused": "kubedl_tpu/ops/flash_attention.py:480 _bwd_fused_kernel",
    "flash_bwd_dq": "kubedl_tpu/ops/flash_attention.py:314 _bwd_dq_kernel",
    "flash_bwd_dkdv": "kubedl_tpu/ops/flash_attention.py:393 _bwd_dkdv_kernel",
}
#: (label, B, H, KV, S, hd, dtype, causal, rope, timed). The first is the
#: llama3-1b training shape (the main path's); the second Gemma-2B's
#: (phase 23's path: MQA at hd 256); then Llama-3-8B and Gemma-2B head
#: widths, GQA groups 1 and 8 at both hd-64/128 tensor-core widths with
#: and without RoPE, causal and not, ragged lengths, float32 at each hd,
#: and bench-moe's training shape (phase 25's path: GQA group 2 at hd 64,
#: untimed). Every case runs all four kernels (the split pair too).
FLASH_CASES = [
    ("llama3-1b", 4, 32, 8, 2048, 64, torch.bfloat16, True, True, True),
    ("gemma-2b train", 4, 8, 1, 2048, 256, torch.bfloat16, True, True, True),
    ("llama3-1b no-rope", 4, 32, 8, 2048, 64, torch.bfloat16, True, False,
     False),
    ("llama3-8b width", 1, 32, 8, 2048, 128, torch.bfloat16, True, True, False),
    ("hd128 group 1 no-rope", 1, 8, 8, 1024, 128, torch.bfloat16, True,
     False, False),
    ("hd64 group 8 non-causal", 1, 16, 2, 1024, 64, torch.bfloat16, False,
     False, False),
    ("hd128 group 8 ragged S=1000", 1, 8, 1, 1000, 128, torch.bfloat16,
     True, True, False),
    ("hd64 group 1 ragged non-causal", 1, 4, 4, 1000, 64, torch.bfloat16,
     False, True, False),
    ("gemma-2b width", 1, 8, 1, 1024, 256, torch.bfloat16, True, True, False),
    ("ragged S=1000", 2, 8, 2, 1000, 64, torch.bfloat16, False, True, False),
    ("f32 hd64", 1, 8, 2, 512, 64, torch.float32, True, True, False),
    ("f32 hd128 ragged", 1, 4, 1, 1000, 128, torch.float32, False, False,
     False),
    ("f32 hd256", 1, 4, 2, 256, 256, torch.float32, True, True, False),
    # phase 25's path: bench-moe, GQA group 2 at hd 64, theta-10000 RoPE
    ("bench-moe", 8, 16, 8, 2048, 64, torch.bfloat16, True, True, False),
]
#: Tolerances against the plain versions on the same inputs (N(0,1)):
#: out: bf16 2e-2 max abs (both sides sum in float32 and round once to
#: bf16, ~1 ulp of |out| <= 4 after reordered sums); f32 1e-5. lse: 1e-4
#: max abs in both types (float32 sums reordered, |lse| < 30). Gradients,
#: max abs error over max |grad|: f32 1e-4 (the fused dq is summed with
#: float32 atomics in run-to-run order); bf16 2e-2 (dS and P are rounded
#: to bf16 at the same points on both sides, but from float32 values that
#: differ in their last bits, so a rounding may land one bf16 ulp (2^-8)
#: apart before a sum over thousands of keys, and the output is bf16).
FLASH_TOL = {torch.bfloat16: {"out": 2e-2, "lse": 1e-4, "grad": 2e-2},
             torch.float32: {"out": 1e-5, "lse": 1e-4, "grad": 1e-4}}


#: the split backward pair: one SDPA backward is their joint yardstick
PAIR = ("flash_bwd_dq", "flash_bwd_dkdv")
#: RoPE theta by case label: Gemma's and bench-moe's tables (10000) where
#: a case is their training shape, llama3's (500000) elsewhere
FLASH_ROPE_THETA = {"gemma-2b train": 10000.0, "bench-moe": 10000.0}


@contextlib.contextmanager
def forced_route(fa, route):
    """The reference's backward predicate forced to ``route``: the fused
    scratch cap set to 0 ("split", as the reference's own test does) or
    above any length ("fused"); None leaves it as it is."""
    old = fa._FUSED_BWD_SCRATCH_BYTES
    if route is not None:
        fa._FUSED_BWD_SCRATCH_BYTES = 0 if route == "split" else 1 << 62
    try:
        yield
    finally:
        fa._FUSED_BWD_SCRATCH_BYTES = old


def flash_inputs(B, H, KV, S, hd, dtype, rope, seed, theta=500000.0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
    do = randn(B, S, H, hd)
    cos = sin = None
    if rope:  # llama3's tables (theta 500000) unless told otherwise
        from kubedl_tpu_torch.models.llama import rope_table

        cos, sin = rope_table(hd, theta, S, device="cuda")
    return q, k, v, do, cos, sin


def flash_bound(kind, B, H, KV, S, hd, dtype, causal, rope):
    """Least time for the work of one call: each input read once, each
    output written once; flops per visible (query, key) pair and head:
    fwd 4*hd (QK^T, PV), fused bwd 10*hd (QK^T, dO.V^T, dV, dK, dQ), split
    dq 6*hd (QK^T, dO.V^T, dQ), split dk/dv 8*hd (QK^T, dO.V^T, dV, dK)."""
    esz = torch.tensor([], dtype=dtype).element_size()
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    qb, kb, lse_b = B * S * H * hd * esz, B * S * KV * hd * esz, B * H * S * 4
    tables = 2 * S * (hd // 2) * 4 if rope else 0
    ins = {"flash_fwd": qb + 2 * kb}
    bwd_in = 3 * qb + 2 * kb + lse_b  # q, out, dout, k, v, lse
    ins.update(flash_bwd_fused=bwd_in, flash_bwd_dq=bwd_in,
               flash_bwd_dkdv=bwd_in)
    outs = {"flash_fwd": qb + lse_b, "flash_bwd_fused": qb + 2 * kb,
            "flash_bwd_dq": qb, "flash_bwd_dkdv": 2 * qb}
    per_pair = {"flash_fwd": 4, "flash_bwd_fused": 10, "flash_bwd_dq": 6,
                "flash_bwd_dkdv": 8}
    nbytes = ins[kind] + outs[kind] + tables
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = per_pair[kind] * hd * pairs / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _grad_err(got, want):
    """Max abs error over max |want| (inf if not finite)."""
    err = _max_err(got, want)
    scale = want.float().abs().max().item()
    return err / scale if math.isfinite(err) and scale > 0 else float("inf")


def sdpa_flash_yardsticks(q, k, v, do, cos, sin, fa):
    """SDPA forward and its backward on the post-rope inputs ([B, H, S,
    hd] copies made outside the timed calls), causal with GQA: the
    library_ms yardsticks. The port never calls SDPA."""
    import torch.nn.functional as F

    if cos is not None:
        q, k = fa._rope_rotate(q, cos, sin), fa._rope_rotate(k, cos, sin)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    out = fwd()

    def bwd():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    return fwd, bwd


def flash_routes(fa, dtype, hd) -> dict:
    """Each operator's route at (dtype, hd): tensor_core or cuda_core."""
    return {op: "tensor_core" if fa.tensor_core_route(op, dtype, hd)
            else "cuda_core" for op in fa.OPS}


def check_flash_case(fa, case, records):
    """One FLASH_CASES entry: every kernel against its plain version, the
    two backward routes against each other; timings when ``timed``,
    recorded under each operator's name (with ``_hd256`` at hd 256)."""
    label, B, H, KV, S, hd, dtype, causal, rope, timed = case
    tol = FLASH_TOL[dtype]
    q, k, v, do, cos, sin = flash_inputs(
        B, H, KV, S, hd, dtype, rope, seed=S + hd,
        theta=FLASH_ROPE_THETA.get(label, 500000.0))
    out, lse = fa.flash_fwd(q, k, v, cos, sin, causal)
    fused = fa.flash_bwd_fused(q, k, v, cos, sin, out, lse, do, causal)
    dq_s = fa.flash_bwd_dq(q, k, v, cos, sin, out, lse, do, causal)
    dk_h, dv_h = fa.flash_bwd_dkdv(q, k, v, cos, sin, out, lse, do, causal)
    torch.cuda.synchronize()
    split = (dq_s, dk_h.reshape(B, S, KV, H // KV, hd).sum(3).to(dtype),
             dv_h.reshape(B, S, KV, H // KV, hd).sum(3).to(dtype))
    p_out, p_lse = fa._plain_fwd(q, k, v, cos, sin, causal)
    args = (q, k, v, cos, sin, out, lse, do, causal)
    p_grads = fa._plain_bwd_fused(*args)
    p_dq = fa._plain_bwd_dq(*args)
    p_dk_h, p_dv_h = fa._plain_bwd_dkdv_per_head(*args)
    errs = {
        "out": _max_err(out, p_out), "lse": _max_err(lse, p_lse),
        "flash_bwd_fused": max(_grad_err(a, b)
                               for a, b in zip(fused, p_grads)),
        "flash_bwd_dq": _grad_err(dq_s, p_dq),
        "flash_bwd_dkdv": max(_grad_err(dk_h, p_dk_h),
                              _grad_err(dv_h, p_dv_h)),
        "split_vs_plain_fused": max(_grad_err(a, b)
                                    for a, b in zip(split, p_grads)),
        "fused_vs_split": max(_grad_err(a, b) for a, b in zip(fused, split)),
    }
    bad = [n for n in ("out", "lse") if not errs[n] <= tol[n]]
    bad += [n for n in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkdv",
                        "split_vs_plain_fused", "fused_vs_split")
            if not errs[n] <= tol["grad"]]
    if bad:
        fail(f"flash {label} {dtype}: {bad} out of tolerance: "
             f"{json.dumps(errs)}")
    routes = flash_routes(fa, dtype, hd)
    print(f"flash {label} {str(dtype)[6:]} causal={causal} rope={rope}: "
          + json.dumps(errs) + " routes " + json.dumps(routes), flush=True)
    if not timed:
        return
    shape = (B, H, KV, S, hd, dtype, causal, rope)
    # absolute error of each kernel's worst output against its plain version
    abs_errs = {
        "flash_fwd": max(errs["out"], errs["lse"]),
        "flash_bwd_fused": max(_max_err(a, b) for a, b in zip(fused, p_grads)),
        "flash_bwd_dq": _max_err(dq_s, p_dq),
        "flash_bwd_dkdv": max(_max_err(dk_h, p_dk_h), _max_err(dv_h, p_dv_h)),
    }
    sdpa_fwd, sdpa_bwd = sdpa_flash_yardsticks(q, k, v, do, cos, sin, fa)
    # SDPA's backward computes dq, dk and dv in one call: the split pair's
    # yardstick is held against dq + dk/dv + the group sum (flash_backward
    # on the split route), timed once for the pair
    with forced_route(fa, "split"):
        pair_ms = time_ms(lambda: fa.flash_backward(*args), reps=20)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, cos, sin, causal),
                      lambda: fa._plain_fwd(q, k, v, cos, sin, causal),
                      sdpa_fwd),
        "flash_bwd_fused": (lambda: fa.flash_bwd_fused(*args),
                            lambda: fa._plain_bwd_fused(*args), sdpa_bwd),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*args),
                         lambda: fa._plain_bwd_dq(*args), sdpa_bwd),
        "flash_bwd_dkdv": (lambda: fa.flash_bwd_dkdv(*args),
                           lambda: fa._plain_bwd_dkdv_per_head(*args),
                           sdpa_bwd),
    }
    for name, (kern, plain, lib) in calls.items():
        rec = {"max_abs_err": abs_errs[name],
               "max_err_over_max_grad": errs.get(name)}
        rec["ms"] = time_ms(kern, reps=20)
        rec["call_ms"] = time_ms(kern, reps=20, hide_host=False)
        rec["plain_ms"] = time_ms(plain, reps=5, warmup=1, hide_host=False)
        rec["library_ms"] = time_ms(lib, reps=20) if lib else None
        rec["library_call_ms"] = (time_ms(lib, reps=20, hide_host=False)
                                  if lib else None)
        rec["bound_ms"], rec["bound_by"] = flash_bound(name, *shape)
        if name in PAIR:
            rec["pair_ms"] = pair_ms
        rec["shape"] = f"B={B} H={H} KV={KV} S={S} hd={hd} {str(dtype)[6:]}" \
                       f" causal={causal} rope={rope}"
        rec["route"] = routes[name]
        records[name + ("_hd256" if hd == 256 else "")] = rec
        print(f"{name} timed ({label}): " + json.dumps(rec), flush=True)


def run_flash_kernels(fa):
    records = {}
    for case in FLASH_CASES:
        check_flash_case(fa, case, records)
    _free()
    return records


#: the split pair's main-path shape: llama3-1b training at 32k tokens
#: (bwd_route(32768, 64) is "split"), and a head slice of it that the
#: plain versions run whole
LONG_FLASH = ("llama3-1b 32k", 1, 32, 8, 32768, 64, torch.bfloat16, True,
              True)
SLICE_FLASH = ("head slice 16k", 1, 4, 1, 16384, 64, torch.bfloat16, True,
               True)


def timed_once(fn):
    """(fn(), its wall time in ms to a synchronize): one call of a slow
    plain version."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def plain_by_head(fn, q, k, v, cos, sin, out, lse, do, causal):
    """A plain backward version (``_plain_bwd_dq`` or
    ``_plain_bwd_dkdv_per_head``) one q-head at a time, each with its
    kv-head, concatenated on the head axis: the same function, since the
    plain versions mix heads only through the GQA grouping, and one
    head's float32 score tensor (4.3 GB at S=32768) fits the card."""
    H, G = q.shape[2], q.shape[2] // k.shape[2]
    parts = []
    for h in range(H):
        j = h // G
        r = fn(q[:, :, h:h + 1].contiguous(), k[:, :, j:j + 1].contiguous(),
               v[:, :, j:j + 1].contiguous(), cos, sin,
               out[:, :, h:h + 1].contiguous(), lse[:, h:h + 1].contiguous(),
               do[:, :, h:h + 1].contiguous(), causal)
        parts.append(r if isinstance(r, tuple) else (r,))
        _free()
    cat = tuple(torch.cat(xs, dim=2) for xs in zip(*parts))
    return cat if len(cat) > 1 else cat[0]


def group_sum(x, KV, dtype):
    B, S, H, hd = x.shape
    return x.reshape(B, S, KV, H // KV, hd).sum(3).to(dtype)


def long_pair_case(fa, records, case, suffix="", theta=500000.0):
    """The split pair at a long-context ``case`` (bwd_route "split")
    against the plain versions run head by head (one float32 score tensor
    of all heads would not fit the card), its group-summed dk/dv against
    the plain per-head versions' group sums and against the fused kernel
    on the same inputs; then each kernel's time beside its bound, the
    plain versions' (one call), SDPA's backward (the pair's yardstick),
    the pair through ``flash_backward`` and the fused route forced
    through it. The records replace ``records[name + suffix]``, whose
    earlier (S=2048) fields stay under "s2048"."""
    label, B, H, KV, S, hd, dtype, causal, rope = case
    routes = flash_routes(fa, dtype, hd)
    if fa.bwd_route(S, hd) != "split" or \
            set(routes.values()) != {"tensor_core"}:
        fail(f"flash {label}: bwd_route {fa.bwd_route(S, hd)}, routes "
             f"{routes}")
    tol = FLASH_TOL[dtype]["grad"]
    q, k, v, do, cos, sin = flash_inputs(B, H, KV, S, hd, dtype, rope,
                                         seed=S + hd, theta=theta)
    out, lse = fa.flash_fwd(q, k, v, cos, sin, causal)
    args = (q, k, v, cos, sin, out, lse, do, causal)
    dq = fa.flash_bwd_dq(*args)
    dk_h, dv_h = fa.flash_bwd_dkdv(*args)
    fused = fa.flash_bwd_fused(*args)
    torch.cuda.synchronize()
    split = (dq, group_sum(dk_h, KV, dtype), group_sum(dv_h, KV, dtype))
    p_dq, plain_dq_ms = timed_once(
        lambda: plain_by_head(fa._plain_bwd_dq, *args))
    (p_dk_h, p_dv_h), plain_dkdv_ms = timed_once(
        lambda: plain_by_head(fa._plain_bwd_dkdv_per_head, *args))
    errs = {
        "flash_bwd_dq": _grad_err(dq, p_dq),
        "flash_bwd_dkdv": max(_grad_err(dk_h, p_dk_h),
                              _grad_err(dv_h, p_dv_h)),
        "group_sums": max(_grad_err(split[1], group_sum(p_dk_h, KV, dtype)),
                          _grad_err(split[2], group_sum(p_dv_h, KV, dtype))),
        "split_vs_fused": max(_grad_err(a, b) for a, b in zip(split, fused)),
    }
    abs_errs = {"flash_bwd_dq": _max_err(dq, p_dq),
                "flash_bwd_dkdv": max(_max_err(dk_h, p_dk_h),
                                      _max_err(dv_h, p_dv_h))}
    del p_dq, p_dk_h, p_dv_h, split, fused
    _free()
    if not all(e <= tol for e in errs.values()):
        fail(f"flash {label}: out of tolerance {tol}: {json.dumps(errs)}")
    print(f"flash {label} bf16 causal rope (plain by head): "
          + json.dumps(errs) + " routes " + json.dumps(routes), flush=True)
    _, sdpa_bwd = sdpa_flash_yardsticks(q, k, v, do, cos, sin, fa)
    lib_ms = time_ms(sdpa_bwd, reps=20)
    with forced_route(fa, "split"):
        pair_ms = time_ms(lambda: fa.flash_backward(*args), reps=20)
    with forced_route(fa, "fused"):
        fused_ms = time_ms(lambda: fa.flash_backward(*args), reps=20)
    del sdpa_bwd
    _free()
    shape = (B, H, KV, S, hd, dtype, causal, rope)
    calls = {"flash_bwd_dq": (lambda: fa.flash_bwd_dq(*args), plain_dq_ms),
             "flash_bwd_dkdv": (lambda: fa.flash_bwd_dkdv(*args),
                                plain_dkdv_ms)}
    for name, (kern, plain_ms) in calls.items():
        rec = {"max_abs_err": abs_errs[name],
               "max_err_over_max_grad": errs[name],
               "group_sums": errs["group_sums"],
               "split_vs_fused": errs["split_vs_fused"],
               "ms": time_ms(kern, reps=20),
               "call_ms": time_ms(kern, reps=5, warmup=1, hide_host=False),
               "plain_ms": plain_ms, "plain_calls": H,
               "library_ms": lib_ms, "library_call_ms": None,
               "pair_ms": pair_ms, "fused_ms": fused_ms,
               "route": routes[name]}
        rec["bound_ms"], rec["bound_by"] = flash_bound(name, *shape)
        rec["shape"] = f"B={B} H={H} KV={KV} S={S} hd={hd} bf16 " \
                       f"causal={causal} rope={rope}"
        rec["s2048"] = {key: records[name + suffix].get(key) for key in (
            "ms", "call_ms", "plain_ms", "library_ms", "pair_ms",
            "bound_ms", "max_abs_err", "shape", "route")}
        records[name + suffix] = rec
        print(f"{name} timed ({label}): " + json.dumps(rec), flush=True)
    del q, k, v, do, out, lse, dq, dk_h, dv_h, args
    _free()


def run_flash_long(fa, records):
    """Phase 7, long context: the split pair at LONG_FLASH
    (``long_pair_case``); then SLICE_FLASH through ``flash_backward``
    with the split route forced against the plain versions run whole."""
    long_pair_case(fa, records, LONG_FLASH)
    label, B, H, KV, S, hd, dtype, causal, rope = SLICE_FLASH
    tol = FLASH_TOL[dtype]["grad"]
    q, k, v, do, cos, sin = flash_inputs(B, H, KV, S, hd, dtype, rope,
                                         seed=S + hd)
    out, lse = fa.flash_fwd(q, k, v, cos, sin, causal)
    args = (q, k, v, cos, sin, out, lse, do, causal)
    with forced_route(fa, "split"):
        before = dict(fa.LAUNCHES)
        got = fa.flash_backward(*args)
        if fa.LAUNCHES["flash_bwd_dq"] != before["flash_bwd_dq"] + 1 or \
                fa.LAUNCHES["flash_bwd_fused"] != before["flash_bwd_fused"]:
            fail(f"flash {label}: the split route did not run")
    dq = fa.flash_bwd_dq(*args)
    dk_h, dv_h = fa.flash_bwd_dkdv(*args)
    torch.cuda.synchronize()
    errs = {"flash_backward split": max(
        _grad_err(a, b) for a, b in zip(got, fa._plain_bwd_fused(*args)))}
    _free()
    errs["flash_bwd_dq"] = _grad_err(dq, fa._plain_bwd_dq(*args))
    _free()
    p_dk_h, p_dv_h = fa._plain_bwd_dkdv_per_head(*args)
    errs["flash_bwd_dkdv"] = max(_grad_err(dk_h, p_dk_h),
                                 _grad_err(dv_h, p_dv_h))
    del p_dk_h, p_dv_h, got, dq, dk_h, dv_h, args, q, k, v, do, out, lse
    _free()
    if not all(e <= tol for e in errs.values()):
        fail(f"flash {label}: out of tolerance {tol}: {json.dumps(errs)}")
    print(f"flash {label} bf16 causal rope, split forced (plain whole): "
          + json.dumps(errs), flush=True)


#: Gemma-2B at its published 8192-token context (phase 24's shape):
#: bwd_route(8192, 256) is "split", so every backward takes the pair
GEMMA_LONG_FLASH = ("gemma-2b 8k", 1, 8, 1, 8192, 256, torch.bfloat16, True,
                    True)
#: the hd-256 split pair's aims: each kernel within this many times its
#: bound, and the pair (dq + dk/dv + the group sum) within this many times
#: SDPA's backward; a miss prints a MISS line and does not fail the run
PAIR_AIMS = {"bound": 6.0, "library": 2.5}


def pair_aims(label, recs):
    """A MISS line for each of PAIR_AIMS that the split pair's timed
    records ``recs`` (by operator) miss at one shape."""
    for name, rec in recs.items():
        if rec["ms"] > PAIR_AIMS["bound"] * rec["bound_ms"]:
            print(f"MISS: {name} ({label}) {rec['ms']} ms = "
                  f"{rec['ms'] / rec['bound_ms']:.2f}x its bound "
                  f"{rec['bound_ms']} ms (aim {PAIR_AIMS['bound']}x)",
                  flush=True)
    rec = recs[PAIR[0]]
    if rec["pair_ms"] > PAIR_AIMS["library"] * rec["library_ms"]:
        print(f"MISS: the split pair ({label}) {rec['pair_ms']} ms = "
              f"{rec['pair_ms'] / rec['library_ms']:.2f}x SDPA's backward "
              f"{rec['library_ms']} ms (aim {PAIR_AIMS['library']}x)",
              flush=True)


def run_flash_gemma_long(fa, records):
    """Phase 7, Gemma-2B's long context: the split pair at
    GEMMA_LONG_FLASH (``long_pair_case``, Gemma's RoPE tables; all four
    operators on the tensor cores), with a MISS line for each of
    PAIR_AIMS missed at either Gemma-2B shape."""
    pair_aims("gemma-2b train S=2048",
              {name: records[name + "_hd256"] for name in PAIR})
    long_pair_case(fa, records, GEMMA_LONG_FLASH, "_hd256", theta=10000.0)
    pair_aims(GEMMA_LONG_FLASH[0],
              {name: records[name + "_hd256"] for name in PAIR})


# ---- phases 8 to 10: training ------------------------------------------------

#: the slice's main path: Llama-3.2-1B widths and depth, random weights
#: from the seed, synthetic tokens (what a user sets in the env)
TRAIN_CONFIG = {"model": "llama3-1b", "global_batch": 4, "seq_len": 2048,
                "steps": 8, "log_every": 1}


def _reset(fa):
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def train_main_run(fa, llama_mod, config, want_per_step, policy=""):
    """``train_main`` in-process on the card with ``config``. Gates:
    finite loss and grad norm at every step, attn_impl "flash", no sanity
    violations, the long-context policy string ``policy`` ("" = none
    applied), ``want_per_step`` x steps launches of each flash kernel and
    a norm and an update launch a leaf plus one finish a step of the
    optimizer's kernels (counts set to 0 just before the run, read just
    after). Returns the launches and the printed record."""
    from kubedl_tpu_torch.ops import adamw
    from kubedl_tpu_torch.training import entry
    from kubedl_tpu_torch.training.trainer import Trainer, tree_leaves

    metrics = []
    real_step = Trainer.train_step

    def recording_step(self, state, batch):
        state, m = real_step(self, state, batch)
        metrics.append(m)  # device scalars, read after the run
        return state, m

    Trainer.train_step = recording_step
    _reset(fa)
    for k in adamw.LAUNCHES:
        adamw.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        rc = entry.train_main({"KUBEDL_TRAIN_CONFIG": json.dumps(config)})
    finally:
        Trainer.train_step = real_step
    launches = dict(fa.LAUNCHES)
    opt_launches = dict(adamw.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    s = entry.LAST_SUMMARY
    steps = config["steps"]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    layers = llama_mod.preset(config["model"]).n_layers
    if rc != 0 or len(losses) != steps:
        fail(f"train_main rc {rc}, {len(losses)} steps")
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"non-finite loss or grad norm: {losses} {norms}")
    if s["attn_impl"] != "flash" or s["sanity_violations"]:
        fail(f"attn_impl {s['attn_impl']}, sanity {s['sanity_violations']}")
    if s["long_context_policy"] != policy:
        fail(f"long_context_policy {s['long_context_policy']!r} != {policy!r}")
    want = {k: n * layers * steps for k, n in want_per_step.items()}
    if launches != want:
        fail(f"flash launches {launches} != {want} ({layers} layers x "
             f"{steps} steps)")
    # the optimizer: a norm and an update launch a leaf, one finish, a step
    n_leaves = len(tree_leaves(llama_mod.param_like(
        llama_mod.preset(config["model"]))))
    want_opt = {"adamw_norm": n_leaves * steps, "adamw_norm_finish": steps,
                "adamw_update": n_leaves * steps}
    if opt_launches != want_opt:
        fail(f"optimizer launches {opt_launches} != {want_opt} ({n_leaves} "
             f"leaves x {steps} steps)")
    rec = {"config": config, "losses": losses, "grad_norms": norms,
           "step_time_ms": s["step_time_ms"],
           "tokens_per_sec": s["tokens_per_sec"], "mfu": s["mfu"],
           "first_step_seconds": s["first_step_seconds"],
           "hbm_floor_ms": s["hbm_floor_ms"], "n_params": s["n_params"],
           "long_context_policy": s["long_context_policy"],
           "max_memory_allocated_gib": peak / 2**30,
           "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "optimizer_launches": opt_launches,
           "sanity_violations": s["sanity_violations"]}
    _free()
    return launches, rec


def run_train_entry(fa, llama_mod):
    """Phase 8: ``train_main`` at TRAIN_CONFIG: 16 flash_fwd and 16
    flash_bwd_fused launches per step (remat under "dots_flash" never
    re-runs the forward kernel)."""
    launches, rec = train_main_run(
        fa, llama_mod, TRAIN_CONFIG,
        {"flash_fwd": 1, "flash_bwd_fused": 1, "flash_bwd_dq": 0,
         "flash_bwd_dkdv": 0})
    print("train_main llama3-1b (smoke run, not a benchmark): "
          + json.dumps(rec), flush=True)
    return ({k: launches[k] for k in ("flash_fwd", "flash_bwd_fused")},
            rec["optimizer_launches"])


#: phase 23's path: Gemma-2B (18 layers, MQA at hd 256, a 256,000-token
#: tied head) at full width and depth, random weights from the seed,
#: synthetic tokens; ``loss_chunk`` (the reference's own knob) keeps the
#: head from materializing [8192, 256000] float32 logits
GEMMA_TRAIN_CONFIG = {"model": "gemma-2b", "global_batch": 4, "seq_len": 2048,
                      "steps": 4, "log_every": 1, "loss_chunk": 512}
#: the flash operators phase 23 runs at hd 256 (both on the tensor cores)
GEMMA_TRAIN_OPS = ("flash_fwd", "flash_bwd_fused")
#: each operator's profile category and its kernels a launch at hd 256
#: (after the RoPE pre-pass, its own category): the forward kernel; the
#: stats pre-pass, the fused kernel and the dq and dk/dv finishes
GEMMA_PROFILE_KERNELS = {"flash_fwd": ("flash_fwd", 1),
                         "flash_bwd_fused": ("flash_bwd", 4)}


def profile_one_step(fa, model, B, S, seed, label):
    """One train step of ``model`` at B x S after one unprofiled step,
    under torch.profiler (``profile_train_steps``): its record and the
    flash launches of the profiled step."""
    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import TrainConfig, Trainer

    tr = Trainer(TrainConfig(model=model, global_batch=B, seq_len=S,
                             steps=2, warmup_steps=1, attn_impl="flash"))
    state = tr.init_state()
    batch = next(iter(SyntheticTokens(B, S, model.vocab_size, seed=seed)))
    state, _ = tr.train_step(state, batch)
    _reset(fa)
    _, prof = profile_train_steps(tr, state, batch, 1, label)
    launches = dict(fa.LAUNCHES)
    del tr, state, batch
    _free()
    return prof, launches


def run_gemma_train(fa, llama_mod):
    """Phase 23: ``train_main`` at GEMMA_TRAIN_CONFIG: per step 18
    flash_fwd and 18 flash_bwd_fused launches (the tensor-core kernels at
    hd 256; ``bwd_route(2048, 256)`` is "fused") and none of the split
    pair. Then one step (after one unprofiled) under torch.profiler:
    flash's share of the device time and its device ms a launch. MFU is
    the trainer's 6N flops a token, which leaves attention's flops out.
    Returns the launches and the summary the kernels line reads."""
    cfg = GEMMA_TRAIN_CONFIG
    model = dataclasses.replace(llama_mod.preset(cfg["model"]),
                                loss_chunk=cfg["loss_chunk"])
    hd, B, S = model.head_dim, cfg["global_batch"], cfg["seq_len"]
    routes = flash_routes(fa, model.dtype, hd)
    if fa.bwd_route(S, hd) != "fused" or any(
            routes[op] != "tensor_core" for op in GEMMA_TRAIN_OPS):
        fail(f"gemma-2b: bwd_route {fa.bwd_route(S, hd)}, routes {routes}")
    t0 = time.perf_counter()
    launches, rec = train_main_run(
        fa, llama_mod, cfg,
        {"flash_fwd": 1, "flash_bwd_fused": 1, "flash_bwd_dq": 0,
         "flash_bwd_dkdv": 0})
    rec["routes"] = routes
    print("train_main gemma-2b (smoke run, not a benchmark): "
          + json.dumps(rec), flush=True)
    prof, per_step = profile_one_step(fa, model, B, S, 4,
                                      f"{cfg['model']} b{B} s{S}")
    cats, counts = prof["by_category_ms"], prof["by_category_kernels"]
    flash_ms = sum(v for k, v in cats.items() if k.startswith("flash"))
    # device ms a launch in the profiled step, over the launches the
    # profiler saw (it may miss the first kernels of its window); the RoPE
    # pre-pass, which both operators run, on its own
    in_model = {op: cats.get(cat, 0.0) / max(counts.get(cat, 0) // n, 1)
                for op, (cat, n) in GEMMA_PROFILE_KERNELS.items()}
    in_model["flash_rope_per_step"] = cats.get("flash_rope", 0.0)
    summary = {"flash_ms": flash_ms,
               "flash_share": flash_ms / prof["device_ms"]
               if prof["device_ms"] else None,
               "busy_share": prof["busy_share"],
               "in_model_ms": in_model, "profiled_launches": per_step,
               "step_time_ms": rec["step_time_ms"], "mfu": rec["mfu"],
               "tokens_per_sec": rec["tokens_per_sec"],
               "max_memory_allocated_gib": rec["max_memory_allocated_gib"],
               "phase_seconds": time.perf_counter() - t0}
    print("gemma-2b training, flash in the profiled step: "
          + json.dumps(summary), flush=True)
    return {k: launches[k] for k in GEMMA_TRAIN_OPS}, summary


#: the long-context path: Llama-3.2-1B at 32k tokens (published with a
#: 128k context), where the trainer's long-context policy applies and
#: the backward takes the split pair on every layer
LONG_TRAIN_CONFIG = {"model": "llama3-1b", "global_batch": 1,
                     "seq_len": 32768, "steps": 4, "log_every": 1}
LONG_POLICY = "loss_chunk=512,remat_policy=flash_rope"
#: phase 24's path: Gemma-2B at full width and depth at its published
#: 8192-token context, random weights from the seed, synthetic tokens;
#: the trainer's long-context policy applies (``loss_chunk`` 512, remat
#: "flash_rope") and ``bwd_route(8192, 256)`` is "split"
GEMMA_LONG_TRAIN_CONFIG = {"model": "gemma-2b", "global_batch": 1,
                           "seq_len": 8192, "steps": 4, "log_every": 1}


def run_long_context_train(fa, llama_mod):
    """Phase 11: ``train_main`` at LONG_TRAIN_CONFIG. Per step: 16
    flash_fwd ("flash_rope" saves the forward's outputs, so remat never
    re-runs it), 16 flash_bwd_dq, 16 flash_bwd_dkdv, 0 flash_bwd_fused.
    Then one step (after one unprofiled) under torch.profiler. MFU is the
    trainer's 6N flops a token, which leaves attention's flops out."""
    cfg = LONG_TRAIN_CONFIG
    model = llama_mod.preset(cfg["model"])
    if fa.bwd_route(cfg["seq_len"], model.head_dim) != "split":
        fail(f"bwd_route at seq_len {cfg['seq_len']} is not split")
    launches, rec = train_main_run(
        fa, llama_mod, cfg,
        {"flash_fwd": 1, "flash_bwd_fused": 0, "flash_bwd_dq": 1,
         "flash_bwd_dkdv": 1}, policy=LONG_POLICY)
    print("train_main llama3-1b long context (smoke run, not a benchmark): "
          + json.dumps(rec), flush=True)
    B, S = cfg["global_batch"], cfg["seq_len"]
    profile_one_step(fa, model, B, S, 2, f"{cfg['model']} b{B} s{S}")
    return {k: launches[k] for k in PAIR}


def run_gemma_long_train(fa, llama_mod):
    """Phase 24: ``train_main`` at GEMMA_LONG_TRAIN_CONFIG (Gemma-2B at its
    published 8192-token context). Checked before the run:
    ``bwd_route(8192, 256)`` is "split" and all four operators take the
    tensor cores at bf16 hd 256. Per step: 18 flash_fwd ("flash_rope"
    saves the forward's outputs), 18 flash_bwd_dq, 18 flash_bwd_dkdv, 0
    flash_bwd_fused; the long-context policy string. Then one step (after
    one unprofiled) under torch.profiler: the split pair's device ms a
    launch, its share of the device time, and the busy share. MFU is the
    trainer's 6N flops a token, which leaves attention's flops out.
    Returns the launches and the summary the kernels line reads."""
    cfg = GEMMA_LONG_TRAIN_CONFIG
    model = llama_mod.preset(cfg["model"])
    hd, B, S = model.head_dim, cfg["global_batch"], cfg["seq_len"]
    routes = flash_routes(fa, model.dtype, hd)
    if fa.bwd_route(S, hd) != "split" or \
            set(routes.values()) != {"tensor_core"}:
        fail(f"gemma-2b s{S}: bwd_route {fa.bwd_route(S, hd)}, routes "
             f"{routes}")
    t0 = time.perf_counter()
    launches, rec = train_main_run(
        fa, llama_mod, cfg,
        {"flash_fwd": 1, "flash_bwd_fused": 0, "flash_bwd_dq": 1,
         "flash_bwd_dkdv": 1}, policy=LONG_POLICY)
    rec["routes"] = routes
    print("train_main gemma-2b long context (smoke run, not a benchmark): "
          + json.dumps(rec), flush=True)
    prof, per_step = profile_one_step(fa, model, B, S, 5,
                                      f"{cfg['model']} b{B} s{S}")
    cats, counts = prof["by_category_ms"], prof["by_category_kernels"]
    # device ms a launch of each split kernel in the profiled step, over
    # the launches the profiler saw (it may miss the first of its window)
    in_model = {op: cats.get(op, 0.0) / max(counts.get(op, 0), 1)
                for op in PAIR}
    pair_ms = sum(cats.get(op, 0.0) for op in PAIR)
    summary = {"pair_ms": pair_ms,
               "pair_share": pair_ms / prof["device_ms"]
               if prof["device_ms"] else None,
               "busy_share": prof["busy_share"],
               "in_model_ms": in_model, "profiled_launches": per_step,
               "step_time_ms": rec["step_time_ms"], "mfu": rec["mfu"],
               "tokens_per_sec": rec["tokens_per_sec"],
               "max_memory_allocated_gib": rec["max_memory_allocated_gib"],
               "phase_seconds": time.perf_counter() - t0}
    print("gemma-2b long-context training, the split pair in the profiled "
          "step: " + json.dumps(summary), flush=True)
    return {k: launches[k] for k in PAIR}, summary


# ---- phase 25: MoE training ---------------------------------------------------

#: phase 25's path: bench-moe (12 layers, 8 experts of ffn 2048, top-1
#: routing at capacity factor 1.25, GQA 16 q-heads over 8 kv-heads at hd
#: 64, a 32,768-token vocabulary, bf16, remat "dots_flash") at full width
#: and depth, random weights from the seed, synthetic tokens
MOE_TRAIN_CONFIG = {"model": "bench-moe", "global_batch": 8, "seq_len": 2048,
                    "steps": 6, "log_every": 1}
#: the flash operators bench-moe runs (hd 64, S=2048: the fused backward)
MOE_TRAIN_OPS = ("flash_fwd", "flash_bwd_fused")
#: kernels of the MoE layer's index passes, by lower-case name (routing:
#: argmax and the running count's scan; dispatch and combine: the index
#: copies and the gathers of their backward); the embedding's lookup and
#: its gradient (an index kernel and a sorted scatter) are counted here too
MOE_INDEX_KERNELS = ("index", "argmax", "scan", "radixsort", "radix_sort")


def _moe_kernel_group(name: str) -> str:
    cat = _kernel_group(name)
    if cat.startswith("flash"):
        return "flash"
    if cat == "other" and any(k in name.lower() for k in MOE_INDEX_KERNELS):
        return "moe_index"
    return cat


def moe_drop_shares(moe_mod, tr, state, batch):
    """Each layer's share of dropped tokens in one forward of ``state``'s
    parameters on ``batch`` (``moe.route`` wrapped to record ``keep``)."""
    shares = []
    real = moe_mod.route

    def recording(xt, router_w, cap):
        out = real(xt, router_w, cap)
        shares.append(1.0 - out[4].float().mean())
        return out

    moe_mod.route = recording
    try:
        with torch.no_grad():
            tr.family.loss(state["params"], tr.shard_batch(batch),
                           attn_fn=tr.attn_fn)
    finally:
        moe_mod.route = real
    return [float(x) for x in shares]


def run_moe_train(fa, moe_mod):
    """Phase 25, parts 1-3: ``train_main`` at MOE_TRAIN_CONFIG: per step 12
    flash_fwd and 12 flash_bwd_fused launches (the tensor-core kernels at
    hd 64, GQA group 2; ``bwd_route(2048, 64)`` is "fused") and none of
    the split pair, and phase 8's optimizer counts over bench-moe's 12
    leaves; prints step ms, tokens/s, MFU (the reference's 6 x active
    parameters a token) and peak memory. Then ``Trainer.fit`` on one
    repeated batch must end below its first loss; then one step (after
    the fit's) under torch.profiler: device ms by category (flash, matmul,
    the MoE index passes, the optimizer, other), the busy share, and each
    layer's dropped-token share from one forward. Returns the launches
    and the summary the kernels line reads."""
    import itertools

    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import (
        TrainConfig, Trainer, tree_leaves,
    )

    cfg = MOE_TRAIN_CONFIG
    model = moe_mod.preset(cfg["model"])
    hd, B, S = model.head_dim, cfg["global_batch"], cfg["seq_len"]
    routes = flash_routes(fa, model.dtype, hd)
    n_leaves = len(tree_leaves(moe_mod.param_like(model)))
    if fa.bwd_route(S, hd) != "fused" or n_leaves != 12 or any(
            routes[op] != "tensor_core" for op in MOE_TRAIN_OPS):
        fail(f"bench-moe: bwd_route {fa.bwd_route(S, hd)}, routes {routes}, "
             f"{n_leaves} leaves")
    t0 = time.perf_counter()
    launches, rec = train_main_run(
        fa, moe_mod, cfg,
        {"flash_fwd": 1, "flash_bwd_fused": 1, "flash_bwd_dq": 0,
         "flash_bwd_dkdv": 0})
    rec["routes"] = routes
    print("train_main bench-moe (smoke run, not a benchmark): "
          + json.dumps(rec), flush=True)

    tr = Trainer(TrainConfig(model=model, global_batch=B, seq_len=S,
                             steps=8, warmup_steps=1, attn_impl="flash"))
    batch = next(iter(SyntheticTokens(B, S, model.vocab_size, seed=25)))
    state, s = tr.fit(itertools.repeat(batch))
    if not (math.isfinite(s["final_loss"])
            and s["final_loss"] < s["first_loss"]):
        fail(f"bench-moe: repeated batch did not overfit: "
             f"{s['first_loss']} -> {s['final_loss']}")
    print("bench-moe overfit one batch, 8 steps: " + json.dumps({
        "first_loss": s["first_loss"], "final_loss": s["final_loss"],
        "step_time_ms": s["step_time_ms"], "mfu": s["mfu"]}), flush=True)
    drops = moe_drop_shares(moe_mod, tr, state, batch)
    _reset(fa)
    state, prof = profile_train_steps(tr, state, batch, 1,
                                      f"{cfg['model']} b{B} s{S}",
                                      group=_moe_kernel_group)
    per_step = dict(fa.LAUNCHES)
    del tr, state
    _free()
    cats = prof["by_category_ms"]
    summary = {"step_time_ms": rec["step_time_ms"],
               "tokens_per_sec": rec["tokens_per_sec"], "mfu": rec["mfu"],
               "max_memory_allocated_gib": rec["max_memory_allocated_gib"],
               "n_params": rec["n_params"],
               "active_flops_per_token": model.flops_per_token(),
               "device_ms": prof["device_ms"],
               "by_category_ms": cats,
               "shares": {k: v / prof["device_ms"] for k, v in cats.items()}
               if prof["device_ms"] else None,
               "busy_share": prof["busy_share"],
               "dropped_share_by_layer": drops,
               "profiled_launches": per_step,
               "phase_seconds": time.perf_counter() - t0}
    print("bench-moe training, the profiled step: " + json.dumps(summary),
          flush=True)
    return {k: launches[k] for k in MOE_TRAIN_OPS}, summary


def moe_ffn_inputs(model, B, S, dtype, seed):
    """bench-moe's switch-layer operands at B x S tokens: x N(0, 1) plus
    one shared N(0, 1) direction (hidden states share a mean direction,
    which skews the routing as a trained model's is skewed, so queues
    overflow and drop), weights fan-in scaled as the init draws them, and
    a seeded upstream gradient for ``out``."""
    g = torch.Generator(device=DEV).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=DEV)

    D, E, Fd = model.dim, model.n_experts, model.ffn_dim
    x = randn(B, S, D) + randn(D)
    ins = (x, randn(D, E) / math.sqrt(D), randn(E, D, Fd) / math.sqrt(D),
           randn(E, Fd, D) / math.sqrt(Fd))
    return [t.to(dtype) for t in ins], randn(B, S, D).to(dtype)


def _bf16_ulp(x):
    """One bf16 ulp of each |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def run_moe_dispatch(moe_mod):
    """Phase 25, part 4: ``moe_ffn`` (index dispatch) against
    ``moe_ffn_plain`` (the reference's one-hot formula) at bench-moe width
    and T = 8 x 2048 tokens. float32 (TF32 off): the forward BIT-identical
    (every one-hot contraction element is one product plus exact zeros);
    gradients to x, router, w_in and w_out within 1e-5 of each one's max
    |grad|: w_in / w_out see the same products (float32 sums of up to
    2,560 slots that cuBLAS may order differently for the two layouts of
    the upstream gradient), and x / router take the gate's gradient,
    summed over D = 1024 in another order. bf16: outputs within one bf16
    ulp of |out|. Both timed in bf16 (device ms, median of 20): the
    forward and forward + backward, the plain version's as the reference
    formula's cost. Returns the printed record."""
    model = moe_mod.preset("bench-moe")
    B, S = MOE_TRAIN_CONFIG["global_batch"], MOE_TRAIN_CONFIG["seq_len"]
    fns = {"index": moe_mod.moe_ffn, "plain": moe_mod.moe_ffn_plain}
    rep = {"tokens": B * S,
           "cap": moe_mod.capacity(model, B * S, model.n_experts)}

    def run(fn, ins, w, cfg):
        ins = [t.detach().requires_grad_(True) for t in ins]
        out, aux = fn(*ins, cfg)
        grads = torch.autograd.grad((out.float() * w.float()).sum()
                                    + 3.0 * aux, ins)
        return out.detach(), aux.detach(), grads

    f32 = dataclasses.replace(model, dtype=torch.float32)
    ins, w = moe_ffn_inputs(model, B, S, torch.float32, seed=250)
    (o_i, a_i, g_i), (o_p, a_p, g_p) = (run(f, ins, w, f32)
                                        for f in fns.values())
    keep = moe_mod.route(ins[0].reshape(B * S, -1), ins[1], rep["cap"])[4]
    rep["dropped_share"] = 1.0 - keep.float().mean().item()
    rep["f32_forward_bitwise"] = bool(torch.equal(o_i, o_p)
                                      and torch.equal(a_i, a_p))
    rep["f32_grad_err_over_max"] = {
        n: _grad_err(a, b)
        for n, a, b in zip(("x", "router", "w_in", "w_out"), g_i, g_p)}
    del o_i, o_p, g_i, g_p
    _free()
    ins, w = moe_ffn_inputs(model, B, S, torch.bfloat16, seed=251)
    with torch.no_grad():
        o_i, a_i = moe_mod.moe_ffn(*ins, model)
        o_p, a_p = moe_mod.moe_ffn_plain(*ins, model)
    rep["bf16_bitwise"] = bool(torch.equal(o_i, o_p))
    rep["bf16_max_err_over_ulp"] = ((o_i.float() - o_p.float()).abs()
                                    / _bf16_ulp(o_p)).max().item()
    rep["bf16_aux_abs_err"] = abs(a_i.item() - a_p.item())
    del o_i, o_p
    ms = {}
    for name, fn in fns.items():
        with torch.no_grad():
            ms[f"{name}_fwd_ms"] = time_ms(lambda: fn(*ins, model), reps=20)
        ms[f"{name}_fwd_bwd_ms"] = time_ms(lambda: run(fn, ins, w, model),
                                           reps=20)
        _free()
    rep.update(ms)
    print("bench-moe switch layer, index dispatch vs the one-hot formula: "
          + json.dumps(rep), flush=True)
    errs = rep["f32_grad_err_over_max"]
    if not (rep["f32_forward_bitwise"] and max(errs.values()) <= 1e-5
            and rep["bf16_max_err_over_ulp"] <= 1.0
            and rep["bf16_aux_abs_err"] <= 1e-6):
        fail(f"bench-moe index dispatch vs one-hot: {json.dumps(rep)}")
    del ins, w
    _free()
    return rep


def _clone_state(state):
    opt = state["opt_state"]
    return {"params": {k: (v.clone() if isinstance(v, torch.Tensor) else
                           {kk: vv.clone() for kk, vv in v.items()})
                       for k, v in state["params"].items()},
            "opt_state": {"count": opt["count"],
                          "mu": [t.clone() for t in opt["mu"]],
                          "nu": [t.clone() for t in opt["nu"]]},
            "step": state["step"]}


def run_moe_identity(fa, moe_mod):
    """Phase 25, part 6: bench-moe at full width and depth, bf16: after
    one step, the same train step run twice from one state is
    BIT-identical (loss, grad norm, every parameter and moment). The
    backward is forced to the split pair, whose dq stays in registers:
    the fused tensor-core backward adds dq by bulk reduce-adds in
    run-to-run order, which is not the MoE layer's to show."""
    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import (
        TrainConfig, Trainer, tree_leaves,
    )

    model = moe_mod.preset("bench-moe")
    B, S = MOE_TRAIN_CONFIG["global_batch"], MOE_TRAIN_CONFIG["seq_len"]
    tr = Trainer(TrainConfig(model=model, global_batch=B, seq_len=S,
                             steps=4, warmup_steps=1, attn_impl="flash"))
    data = iter(SyntheticTokens(B, S, model.vocab_size, seed=26))
    state, _ = tr.train_step(tr.init_state(), next(data))
    batch = next(data)
    snap = _clone_state(state)
    del state
    runs = []
    with forced_route(fa, "split"):
        for _ in range(2):
            st, m = tr.train_step(_clone_state(snap), batch)
            runs.append((m["loss"], m["grad_norm"], tree_leaves(st["params"])
                         + st["opt_state"]["mu"] + st["opt_state"]["nu"]))
            del st
    (l1, n1, t1), (l2, n2, t2) = runs
    same = all(torch.equal(a, b) for a, b in zip(t1, t2))
    rep = {"loss": [l1.item(), l2.item()],
           "grad_norm": [n1.item(), n2.item()],
           "tensors": len(t1), "state_bitwise": same}
    print("bench-moe step twice from one state (split route): "
          + json.dumps(rep), flush=True)
    if not (torch.equal(l1, l2) and torch.equal(n1, n2) and same):
        fail(f"bench-moe step not reproducible: {json.dumps(rep)}")
    del tr, snap, runs, t1, t2
    _free()


def run_moe_phase(fa, moe_mod):
    """Phase 25: MoE training (see the module docstring). Returns the
    flash launches of its main path and its summary."""
    t0 = time.perf_counter()
    launches, summary = run_moe_train(fa, moe_mod)
    summary["dispatch"] = run_moe_dispatch(moe_mod)
    f32_route_parity(fa, dataclasses.replace(
        moe_mod.preset("bench-moe"), n_layers=2, dtype=torch.float32),
        ("fused",), "bench-moe")
    run_moe_identity(fa, moe_mod)
    summary["phase_seconds"] = time.perf_counter() - t0
    print(f"phase 25 (MoE training): {summary['phase_seconds']:.1f} s",
          flush=True)
    return launches, summary


#: phase 12's configurations: (preset, seq_len), phase 11's and phase
#: 24's, each at a length where the split pair is the route (hd 64 and,
#: MQA with a group of 8, hd 256)
BF16_ROUTE_GATES = tuple((cfg["model"], cfg["seq_len"])
                         for cfg in (LONG_TRAIN_CONFIG,
                                     GEMMA_LONG_TRAIN_CONFIG))


def run_train_bf16_routes(fa, llama_mod, preset, S):
    """Phase 12: ``preset``'s width cut to 2 layers, bf16, B=1, ``S``
    tokens, one seeded init: the loss and gradients of one train step on
    the split route (the route at this length) against the same step with
    the fused route forced. Gates: the loss within 1e-5 relative (both
    routes run the same forward kernels); every gradient leaf within 3e-2
    of its max |grad|. Why 3e-2: the two backward kernels round P and dS
    to bf16 from float32 scores summed in other orders, and the split
    route rounds each q-head's dk/dv to bf16 before the group sum where
    the fused one sums in float32 and rounds once, so dq, dk and dv differ
    by one or two bf16 ulps (2^-8 relative) of the largest element; the
    weight gradients round once more (bf16 products) and layer 0's pass
    through layer 1's backward: about eight ulps of the largest
    gradient."""
    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import TrainConfig, Trainer

    model = dataclasses.replace(llama_mod.preset(preset), n_layers=2)
    if fa.bwd_route(S, model.head_dim) != "split":
        fail(f"bf16 routes {preset}: bwd_route({S}, {model.head_dim}) is "
             f"not split")
    batch = next(iter(SyntheticTokens(1, S, model.vocab_size, seed=3)))
    runs = {}
    for route in ("split", "fused"):
        tr = Trainer(TrainConfig(model=model, global_batch=1, seq_len=S,
                                 steps=1, warmup_steps=0, attn_impl="flash"))
        state = tr.init_state()
        _reset(fa)
        with forced_route(fa, None if route == "split" else "fused"):
            loss, grads = tr.value_and_grad(state["params"],
                                            tr.shard_batch(batch))
        torch.cuda.synchronize()
        runs[route] = (float(loss), grads, dict(fa.LAUNCHES))
        del tr, state
        _free()
    (l_s, g_s, n_s), (l_f, g_f, n_f) = runs["split"], runs["fused"]
    rel = abs(l_s - l_f) / abs(l_f)
    gerr = max(_grad_err(a, b) for a, b in zip(g_s, g_f))
    report = {"loss_split": l_s, "loss_fused": l_f, "loss_rel": rel,
              "grad_err_over_max": gerr, "launches_split": n_s,
              "launches_fused": n_f}
    n = model.n_layers
    if n_s["flash_bwd_dq"] != n or n_s["flash_bwd_dkdv"] != n or \
            n_s["flash_bwd_fused"] != 0 or n_f["flash_bwd_fused"] != n or \
            n_f["flash_bwd_dq"] != 0:
        fail(f"bf16 routes did not run as forced: {json.dumps(report)}")
    if not (math.isfinite(l_s) and rel <= 1e-5 and gerr <= 3e-2):
        fail(f"bf16 2-layer split vs fused: {json.dumps(report)}")
    print(f"bf16 2-layer {preset} width s{S}, split vs fused: "
          + json.dumps(report), flush=True)


def _kernel_group(name: str) -> str:
    if "adamw_" in name:  # the optimizer update: norm, finish, update
        return "adamw"
    if "flash_rope" in name:  # the pre-pass of both flash_fwd and the bwd
        return "flash_rope"
    # the split pair's kernels: the dq ones and the per-q-head dk/dv
    # instantiations (template flag false)
    if "flash_bwd_dq" in name:
        return "flash_bwd_dq"
    if ("flash_bwd_kv_kernel" in name or "flash_bwd_tc_kernel" in name) \
            and "false>" in name:
        return "flash_bwd_dkdv"
    if "flash_fwd" in name:
        return "flash_fwd"
    if "flash_bwd" in name or "flash_dq_finish" in name \
            or "flash_dkv_finish" in name:
        return "flash_bwd"
    return _kernel_category(name)


def run_overfit_and_split(fa, llama_mod):
    """Phase 8, then 10: Trainer.fit on ONE repeated batch for 8 steps
    (warmup 1) must end below its first loss; two steps under
    torch.profiler (device time by category, busy share); then two steps
    with the reference's predicate forced to the split backward (its
    scratch cap monkeypatched to 0, as its own test does): 16 launches of
    each split kernel per step and finite losses."""
    import itertools

    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import TrainConfig, Trainer

    model = llama_mod.preset(TRAIN_CONFIG["model"])
    B, S = TRAIN_CONFIG["global_batch"], TRAIN_CONFIG["seq_len"]
    tr = Trainer(TrainConfig(model=model, global_batch=B, seq_len=S,
                             steps=8, warmup_steps=1, attn_impl="flash"))
    batch = next(iter(SyntheticTokens(B, S, model.vocab_size, seed=1)))
    state, s = tr.fit(itertools.repeat(batch))
    if not (math.isfinite(s["final_loss"]) and s["final_loss"] < s["first_loss"]):
        fail(f"repeated batch did not overfit: {s['first_loss']} -> "
             f"{s['final_loss']}")
    print("overfit one batch, 8 steps: " + json.dumps({
        "first_loss": s["first_loss"], "final_loss": s["final_loss"],
        "step_time_ms": s["step_time_ms"], "mfu": s["mfu"]}), flush=True)

    state, _ = profile_train_steps(tr, state, batch, 2,
                                f"{TRAIN_CONFIG['model']} b{B} s{S}")

    _reset(fa)
    with forced_route(fa, "split"):
        state, s2 = tr.fit(itertools.repeat(batch), state=state,
                           steps=state["step"] + 2)
    launches = dict(fa.LAUNCHES)
    n = 2 * model.n_layers
    want = {"flash_fwd": n, "flash_bwd_fused": 0, "flash_bwd_dq": n,
            "flash_bwd_dkdv": n}
    if launches != want or not math.isfinite(s2["final_loss"]):
        fail(f"split route: launches {launches} != {want}, final loss "
             f"{s2['final_loss']}")
    print("split backward route, 2 steps: " + json.dumps({
        "losses": [s2["first_loss"], s2["final_loss"]],
        "launches": launches}), flush=True)
    del tr, state
    _free()


def profile_train_steps(tr, state, batch, steps, label, group=None):
    """``steps`` train steps under torch.profiler: device time by
    category (``group`` of each kernel's name, by default
    ``_kernel_group``: the split pair's two kernels on their own), the top
    kernels and the device's busy share of the wall time. Returns the
    state and the printed record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = tr.train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cats, counts, top = {}, {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        cat = (group or _kernel_group)(e.key)
        cats[cat] = cats.get(cat, 0.0) + us / 1e3
        counts[cat] = counts.get(cat, 0) + e.count
        top.append((us / 1e3, e.count, e.key[:90]))
    dev_ms = sum(cats.values())
    top.sort(reverse=True)
    rec = {"wall_ms": wall_ms, "device_ms": dev_ms,
           "busy_share": dev_ms / wall_ms if wall_ms else None,
           "by_category_ms": cats, "by_category_kernels": counts,
           "top": [[n, ms, c] for ms, c, n in top[:10]]}
    print(f"profile ({steps} train step(s), {label}): " + json.dumps(rec),
          flush=True)
    if dev_ms == 0.0:
        print("profile: the profiler saw no device time", flush=True)
    return state, rec


def run_train_f32_parity(fa, llama_mod):
    """Phase 9: llama3-1b width cut to 2 layers, float32, TF32 off, one
    seeded init: one train step on each kernel route (fused, split) and on
    the plain route (dense attention), gated by ``f32_route_parity``."""
    model = dataclasses.replace(llama_mod.preset("llama3-1b"), n_layers=2,
                                dtype=torch.float32)
    f32_route_parity(fa, model, ("fused", "split"), "llama3-1b")


def f32_route_parity(fa, model, routes, label):
    """One train step of ``model`` (float32, B=2, S=1024, one seeded init)
    on each kernel route in ``routes`` against the dense route. Gates:
    losses within 1e-5 relative; every gradient leaf within 1e-4 of max
    |grad| (float32 sums reordered, the fused dq by atomics); updated
    params within 2.0001*lr max abs (one Adam step moves an element by at
    most lr(1 + wd|p|); a gradient near zero may flip sign between routes)
    and 1e-3*lr mean abs."""
    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import (
        TrainConfig, Trainer, tree_leaves,
    )

    lr = 3e-4
    kw = dict(model=model, global_batch=2, seq_len=1024, steps=4,
              warmup_steps=0, learning_rate=lr)
    batch = next(iter(SyntheticTokens(2, 1024, model.vocab_size, seed=3)))
    runs = {}
    for route in ("dense",) + tuple(routes):
        tr = Trainer(TrainConfig(attn_impl="dense" if route == "dense"
                                 else "flash", **kw))
        state = tr.init_state()
        old = fa._FUSED_BWD_SCRATCH_BYTES
        if route == "split":
            fa._FUSED_BWD_SCRATCH_BYTES = 0
        try:
            loss, grads = tr.value_and_grad(state["params"],
                                            tr.shard_batch(batch))
            state, m = tr.train_step(state, batch)
        finally:
            fa._FUSED_BWD_SCRATCH_BYTES = old
        runs[route] = (float(loss), grads, tree_leaves(state["params"]),
                       float(m["loss"]), tr.attn_impl)
        del tr, state
        _free()
    ref_loss, ref_grads, ref_params, _, _ = runs["dense"]
    report = {}
    for route in routes:
        loss, grads, params, step_loss, impl = runs[route]
        rel = abs(loss - ref_loss) / abs(ref_loss)
        gerr = max(_grad_err(a, b) for a, b in zip(grads, ref_grads))
        pmax = max(_max_err(a, b) for a, b in zip(params, ref_params))
        pmean = sum((a - b).abs().sum().item()
                    for a, b in zip(params, ref_params)) / \
            sum(p.numel() for p in params)
        report[route] = {"loss_rel": rel, "grad_err_over_max": gerr,
                         "param_max_abs": pmax, "param_mean_abs": pmean,
                         "attn_impl": impl}
        if impl != "flash" or not (rel <= 1e-5 and gerr <= 1e-4
                                   and pmax <= 2.0001 * lr
                                   and pmean <= 1e-3 * lr
                                   and math.isfinite(step_loss)):
            fail(f"f32 parity {label} {route} vs dense: "
                 f"{json.dumps(report)}")
    print(f"f32 2-layer {label} width, kernels vs dense: "
          + json.dumps(report), flush=True)


# ---- phase 20: the optimizer update -------------------------------------------

ADAMW_REPLACES = ("kubedl_tpu/training/trainer.py:193 make_optimizer (the "
                  "optax chain clip_by_global_norm -> adamw, fused by XLA "
                  "into the jitted train step, :675-735; no Pallas kernel)")
#: the optimizer kernels (csrc/adamw.cu) phase 2 reports; none may spill
ADAMW_KERNELS = (("adamw_sumsq_kernel<true>", "adamw_sumsq_kernel<false>",
                  "adamw_norm_finish_kernel")
                 + tuple(f"adamw_update_kernel<{p}, {m}>"
                         for p in ("true", "false") for m in ("true", "false")))
#: gradient scales of phase 20's two steps: Llama-3.2-1B's 1.236e9
#: N(0, s^2) gradients have a global norm of about 35,155 s, so 1.4e-5
#: stays below the clip of 1.0 (about 0.49) and 1e-4 clips (about 3.5)
ADAMW_GRAD_SCALE = {"keep": 1.4e-5, "clip": 1e-4}
ADAMW_HP = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _adamw_key(mangled: str):
    """``adamw_update_kernel<true, false>`` from a mangled name, or None."""
    m = re.search(r"(adamw_[a-z_]+_kernel)(?:I((?:Lb[01]E)+)E)?", mangled)
    if m is None:
        return None
    flags = re.findall(r"Lb([01])E", m.group(2) or "")
    args = ", ".join("true" if f == "1" else "false" for f in flags)
    name = m.group(1) + (f"<{args}>" if args else "")
    return name if name in ADAMW_KERNELS else None


def adamw_kernel_report(build) -> dict:
    """Registers and spill bytes of the optimizer kernels (this run's
    ptxas -v). Fails if one was not found or spills."""
    rep = _tc_source_report(build, "adamw.cu", key=_adamw_key)
    missing = [k for k in ADAMW_KERNELS if "registers" not in rep.get(k, {})]
    spills = {k: v for k, v in rep.items()
              if v.get("spill_stores", 1) or v.get("spill_loads", 1)}
    if missing or spills:
        fail(f"adamw kernels: missing {missing}, spilling {spills}: {rep}")
    return {k: {f: v for f, v in r.items() if f != "hgmma"}
            for k, r in rep.items()}


def adamw_leaves(llama_mod, scale, seed):
    """Llama-3.2-1B's 11 leaves, seeded on the card: bf16 parameters and
    gradients, a float32 first moment, a bf16 second moment."""
    from kubedl_tpu_torch.training.trainer import tree_leaves

    shapes = [tuple(t.shape) for t in tree_leaves(
        llama_mod.param_like(llama_mod.preset("llama3-1b")))]
    g = torch.Generator(device=DEV).manual_seed(seed)

    def rand(shape, std, dtype):
        return (torch.randn(shape, generator=g, device=DEV) * std).to(dtype)

    ps = [rand(s, 0.02, torch.bfloat16) for s in shapes]
    gs = [rand(s, scale, torch.bfloat16) for s in shapes]
    mus = [rand(s, 1e-4, torch.float32) for s in shapes]
    nus = [(torch.rand(s, generator=g, device=DEV) * 1e-8).to(
        torch.bfloat16) for s in shapes]
    return gs, ps, mus, nus


def adamw_bound(gs, ps, mus):
    """(ms, "bytes" or "operations"): the norm reads g once; the update
    reads p, g, mu, nu and writes p, mu, nu, each once; about 24 float32
    operations an element (2 for the norm, 22 in the update) at the
    CUDA cores' peak."""
    n = sum(p.numel() for p in ps)
    nbytes = sum(g.numel() * g.element_size() * 2 + p.numel() * p.element_size()
                 * 4 + m.numel() * m.element_size() * 2
                 for g, p, m in zip(gs, ps, mus))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 24 * n / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_adamw_kernels(adamw_mod, llama_mod):
    """Phase 20: the fused optimizer update on Llama-3.2-1B's 11 leaves
    against its plain version, at a step that does not clip and one that
    clips. Gates: where it does not clip, p, mu and nu BIT-identical to
    the plain version's (the kernels do its float32 operations in its
    order; that step never reads the norm); where it clips,
    bit-identical if the two norms agree, else bf16 entries within one
    bf16 ulp (2^-7 relative) and mu within 1e-5 relative (the norm's
    float32 sums run in another order: a bf16 norm may round the other
    way); at both, the norm within 1e-6 relative of the plain version's,
    every leaf's float32 sum of squares within 1e-6 relative of its
    float64 sum (the plain version's, in PyTorch's order, is printed
    beside), and two kernel calls on the same inputs giving the same
    bits. Then the update's device and call ms,
    the plain version's, and the closest library call's:
    ``clip_grad_norm_(foreach=True)`` then ``torch.optim.AdamW(fused=True)``
    on the same leaves (what differs: it keeps both moments in bf16, the
    parameters' type, takes the norm in float32 and decays every leaf
    as the port does)."""
    out = {}
    step = dict(lr=3e-4, t=5, clip=1.0, **ADAMW_HP)
    for case, scale in ADAMW_GRAD_SCALE.items():
        gs, ps, mus, nus = adamw_leaves(llama_mod, scale, seed=20)
        chain = adamw_mod._chain_dtype([g.dtype for g in gs])
        scal = [adamw_mod.step_scalars(step["lr"], step["t"], 0.9, 0.95,
                                       1e-8, 0.1, 1.0, p.dtype, m.dtype, chain)
                for p, m in zip(ps, mus)]
        runs = []
        for impl in ("kernel", "kernel", "plain"):
            p2, m2, v2 = ([t.clone() for t in x] for x in (ps, mus, nus))
            if impl == "kernel":
                stats = adamw_mod.adamw_update(gs, p2, m2, v2, **step)
            else:
                stats = adamw_mod.adamw_update_plain(gs, p2, m2, v2, scal)
            torch.cuda.synchronize()
            runs.append((stats, p2 + m2 + v2))
            _free()
        (sk, tk), (sk2, tk2), (sp, tp) = runs
        clipped = float(sp[0]) >= 1.0
        if clipped != (case == "clip") or clipped != (float(sk[0]) >= 1.0):
            fail(f"adamw {case}: norms {float(sk[0])} / {float(sp[0])}")
        exact = torch.stack([g.double().square().sum() for g in gs])
        sums_rel = ((sk[1:].double() - exact).abs() / exact).max().item()
        plain_sums_rel = ((sp[1:].double() - exact).abs() / exact).max().item()
        norm_rel = abs(float(sk[0]) - float(sp[0])) / float(sp[0])
        same_norm = torch.equal(sk[0], sp[0])
        worst = {}
        for a, b in zip(tk, tp):
            d = ((a.float() - b.float()).abs()
                 / b.float().abs().clamp_min(1e-30)).max().item()
            worst[str(a.dtype)] = max(worst.get(str(a.dtype), 0.0), d)
        bitwise = all(torch.equal(a, b) for a, b in zip(tk, tp))
        repeat = torch.equal(sk, sk2) and all(
            torch.equal(a, b) for a, b in zip(tk, tk2))
        rec = {"norm_kernel": float(sk[0]), "norm_plain": float(sp[0]),
               "norms_equal": same_norm, "norm_rel": norm_rel,
               "leaf_sums_max_rel_vs_float64": sums_rel,
               "plain_leaf_sums_max_rel_vs_float64": plain_sums_rel,
               "bitwise": bitwise, "max_rel_err": worst,
               "repeat_bitwise": repeat}
        ok = norm_rel <= 1e-6 and sums_rel <= 1e-6 and repeat and (
            bitwise if (case == "keep" or same_norm) else
            worst.get("torch.bfloat16", 0) <= 2**-7
            and worst.get("torch.float32", 0) <= 1e-5)
        print(f"adamw llama3-1b leaves, {case} step: " + json.dumps(rec),
              flush=True)
        if not ok:
            fail(f"adamw kernel vs plain at the {case} step: {rec}")
        out[case] = rec
        del runs, tk, tk2, tp, sk, sk2, sp
        _free()
        if case == "keep":
            continue
        # timed at the clipping step (the norm is read on every step)
        bound_ms, bound_by = adamw_bound(gs, ps, mus)

        def kernel():
            adamw_mod.adamw_update(gs, ps, mus, nus, **step)

        def plain():
            adamw_mod.adamw_update_plain(gs, ps, mus, nus, scal)

        ms = time_ms(kernel)
        call_ms = time_ms(kernel, hide_host=False)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        _free()
        params = [torch.nn.Parameter(p.clone()) for p in ps]
        for prm, g in zip(params, gs):
            prm.grad = g.clone()
        opt = torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                                weight_decay=0.1, fused=True)

        def library():
            torch.nn.utils.clip_grad_norm_(params, 1.0, foreach=True)
            opt.step()

        library_ms = time_ms(library, reps=10)
        library_call_ms = time_ms(library, reps=10, hide_host=False)
        del params, opt
        _free()
        out.update(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_call_ms=library_call_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   max_abs_err=max(worst.values()),
                   leaves=len(ps), params=sum(p.numel() for p in ps))
    print("adamw llama3-1b update (smoke run, not a benchmark): "
          + json.dumps({k: out[k] for k in (
              "ms", "call_ms", "plain_ms", "library_ms", "library_call_ms",
              "bound_ms", "bound_by", "leaves", "params")}), flush=True)
    return out


# ---- phase 21: the training job's lifecycle -----------------------------------

#: the job: Llama-3.2-1B at full width and depth, b4 x s2048, a seeded
#: token file, a save every 2 steps (async), a fault after step index 3
#: (before the step-4 save), published to KUBEDL_MODEL_PATH
LIFECYCLE_CONFIG = {"model": "llama3-1b", "global_batch": 4, "seq_len": 2048,
                    "steps": 6, "ckpt_every": 2, "ckpt_async": True,
                    "token_bytes": 4, "log_every": 1}
LIFECYCLE_TOKENS = 1 << 22


class _Tee:
    """stdout that is also kept: train_main's printed lines are gated."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _clear_job_env(entry):
    for name in dir(entry):
        if name.startswith("ENV_"):
            os.environ.pop(getattr(entry, name), None)


def lifecycle_job(root, config, vocab, seed):
    tokens = os.path.join(root, "tokens.bin")
    np.random.default_rng(seed).integers(
        0, vocab, LIFECYCLE_TOKENS, dtype=np.int32).tofile(tokens)
    cfg = dict(config, data_path=tokens)
    return {"KUBEDL_TRAIN_CONFIG": json.dumps(cfg),
            "KUBEDL_MODEL_PATH": os.path.join(root, "model"),
            "KUBEDL_FAULT_ONCE_AT_STEP": "3",
            "KUBEDL_FAULT_MARKER": os.path.join(root, "fault-marker"),
            "KUBEDL_BEACON_FILE": os.path.join(root, "beacon", "w0.json"),
            "KUBEDL_BEACON_INTERVAL": "0.2"}


@contextlib.contextmanager
def recorded_training(ck, entry):
    """Records every fit's trainer and returned state, each step's loss
    (device scalars), the wall seconds of every checkpoint write and of
    the publish."""
    from kubedl_tpu_torch.training.trainer import Trainer

    rec = {"fits": [], "losses": [], "writes": [], "publish_s": []}
    real_fit, real_step = Trainer.fit, Trainer.train_step
    real_write, real_publish = ck.write_snapshot, entry._publish

    def fit(self, *a, **kw):
        state, s = real_fit(self, *a, **kw)
        rec["fits"].append((self, state))
        return state, s

    def train_step(self, state, batch):
        state, m = real_step(self, state, batch)
        rec["losses"].append(m["loss"])
        return state, m

    def write(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real_write(*a, **kw)
        finally:
            rec["writes"].append(time.perf_counter() - t0)

    def publish(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real_publish(*a, **kw)
        finally:
            rec["publish_s"].append(time.perf_counter() - t0)

    Trainer.fit, Trainer.train_step = fit, train_step
    ck.write_snapshot, entry._publish = write, publish
    try:
        yield rec
    finally:
        Trainer.fit, Trainer.train_step = real_fit, real_step
        ck.write_snapshot, entry._publish = real_write, real_publish


def run_job(entry, env):
    """``train_main`` in-process: (exit code, seconds, printed text)."""
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            rc = entry.train_main(env)
    except SystemExit as e:
        rc = e.code
    return rc, time.perf_counter() - t0, "".join(tee.lines)


def run_lifecycle(fa, adamw_mod, pa, ck, llama_mod, server_mod):
    """Phase 21: the training job's lifecycle at LIFECYCLE_CONFIG. Run 1
    must exit 137 (the injected fault) leaving a complete step-2
    checkpoint; run 2 must print resumed_from_step 2, train steps 3-6 on
    the native token loader with 4 x (11 + 1 + 11) optimizer launches,
    save at 4 and 6 and publish step 6, and leave the beacon at step 6;
    serve_main must restore the published parameters (every tensor equal
    to the trainer's final ones) and answer 4 greedy requests on the
    paged kernels. Prints run, save, stall, restore and publish seconds."""
    from kubedl_tpu_torch.training import entry
    from kubedl_tpu_torch.training.trainer import tree_leaves
    from kubedl_tpu_torch.watchdog.beacon import read_beacon

    _clear_job_env(entry)
    cfg = llama_mod.preset(LIFECYCLE_CONFIG["model"])
    root = tempfile.mkdtemp(prefix="kdl-lifecycle-")
    env = lifecycle_job(root, LIFECYCLE_CONFIG, cfg.vocab_size, seed=21)
    out = env["KUBEDL_MODEL_PATH"]
    ckdir = os.path.join(out, "checkpoints")
    n_leaves = len(tree_leaves(llama_mod.param_like(cfg)))
    report = {"config": LIFECYCLE_CONFIG}
    try:
        with recorded_training(ck, entry) as rec:
            rc, report["run1_s"], _ = run_job(entry, env)
            if rc != 137:
                fail(f"lifecycle run 1 exited {rc}, not 137")
            if ck.latest_step(ckdir) != 2 or not ck.checkpoint_fingerprint(
                    ckdir):
                fail(f"run 1 left no complete step-2 checkpoint in {ckdir}")
            report["run1_writes_s"] = list(rec["writes"])
            _reset(fa)
            for k in adamw_mod.LAUNCHES:
                adamw_mod.LAUNCHES[k] = 0
            rc, report["run2_s"], text = run_job(entry, env)
            launches = dict(adamw_mod.LAUNCHES)
            s = entry.LAST_SUMMARY
            if rc != 0 or '{"resumed_from_step": 2}' not in text.splitlines():
                fail(f"lifecycle run 2: rc {rc}, no resumed_from_step 2")
            want = {"adamw_norm": 4 * n_leaves, "adamw_norm_finish": 4,
                    "adamw_update": 4 * n_leaves}
            if (s["start_step"], s["steps"], s["data_loader"],
                    s["ckpt_saves"]) != (2, 4, "native", 2) \
                    or launches != want:
                fail(f"lifecycle run 2: start {s['start_step']}, steps "
                     f"{s['steps']}, loader {s['data_loader']}, saves "
                     f"{s['ckpt_saves']}, optimizer launches {launches} "
                     f"!= {want}")
            if ck.latest_step(out) != 6 or ck.latest_step(ckdir) != 6:
                fail("lifecycle: step 6 not published / not checkpointed")
            beacon = read_beacon(env["KUBEDL_BEACON_FILE"]) or {}
            if beacon.get("step") != 6.0:
                fail(f"beacon {beacon} does not show step 6")
            final = rec["fits"][-1][1]["params"]
            losses = [float(x) for x in rec["losses"]]
            report.update({
                "losses": losses, "run2_summary": {k: s[k] for k in (
                    "step_time_ms", "mfu", "ckpt_stall_s", "ckpt_saves",
                    "data_loader", "start_step", "steps")},
                "restore_s": s["startup_phases"]["state_init"],
                "run2_writes_s": rec["writes"][len(report["run1_writes_s"]):],
                "publish_s": rec["publish_s"],
                "optimizer_launches": launches, "beacon": beacon,
                "checkpoint_bytes": sum(
                    os.path.getsize(os.path.join(ckdir, "step-00000006", f))
                    for f in os.listdir(os.path.join(ckdir, "step-00000006")))})
            if not all(math.isfinite(x) for x in losses):
                fail(f"lifecycle losses not finite: {losses}")
            del rec
        shutil.rmtree(ckdir)  # the disk the serve leg does not need
        _free()

        engines = []
        real = server_mod.LlamaEngine

        class Recorded(real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                engines.append(self)

        serve_cfg = {"preset": LIFECYCLE_CONFIG["model"], "max_batch": 4,
                     "max_seq": 1024, "kv_block_size": 16,
                     "kv_attention": "blocked", "prefill_chunk_tokens": 512,
                     "prefix_cache_mb": 0.0}
        server_mod.LlamaEngine = Recorded
        t0 = time.perf_counter()
        try:
            cm = serving(server_mod, serve_cfg,
                         env={"KUBEDL_MODEL_PATH": out})
            base = cm.__enter__()
        finally:
            server_mod.LlamaEngine = real
        try:
            report["serve_restore_and_start_s"] = time.perf_counter() - t0
            for (k1, a), (k2, b) in zip(ck._leaf_items(engines[0].params),
                                        ck._leaf_items(final)):
                if k1 != k2 or not torch.equal(a, b):
                    fail(f"served leaf {k1} differs from the trained {k2}")
            del final
            rng = np.random.RandomState(21)
            reqs = [{"prompt_ids": rng.randint(0, cfg.vocab_size, size=int(
                n)).tolist(), "max_tokens": 32, "temperature": 0.0}
                for n in (64, 200, 511, 96)]
            reset_counts(pa)
            results, wall = post_all(base, reqs)
            checked(results, 32, "lifecycle serve")
            paged = dict(pa.LAUNCHES)
            if not (paged["blocked"] > 0 and paged["fused"] > 0):
                fail(f"lifecycle serve: paged launches {paged}")
            report.update(serve_wall_s=wall, serve_paged_launches=paged)
        finally:
            cm.__exit__(None, None, None)
            os.environ.pop("KUBEDL_MODEL_PATH", None)
    finally:
        _clear_job_env(entry)
        shutil.rmtree(root, ignore_errors=True)
        _free()
    print("job lifecycle llama3-1b (smoke run, not a benchmark): "
          + json.dumps(report), flush=True)
    return report


def run_lifecycle_identity(fa, ck, llama_mod):
    """Phase 21's identity gate: Llama-3.2-1B width cut to 2 layers,
    float32, the backward forced to the split pair (its dq is summed in
    registers; the fused CUDA-core backward adds dq with float32 atomics,
    whose order changes from run to run): the resumed run's losses and
    final parameters must be BIT-identical to an in-process chain of 2
    steps, save, restore, 4 steps on a fresh iterator (a resume restarts
    the data stream, as the reference's does)."""
    from kubedl_tpu_torch.data.native import TokenFileDataset
    from kubedl_tpu_torch.training import entry
    from kubedl_tpu_torch.training.trainer import Trainer, tree_leaves

    name = "llama3-1b-2layer-f32"
    llama_mod.PRESETS.setdefault(name, dataclasses.replace(
        llama_mod.preset("llama3-1b"), n_layers=2, dtype=torch.float32))
    _clear_job_env(entry)
    root = tempfile.mkdtemp(prefix="kdl-identity-")
    env = lifecycle_job(root, dict(LIFECYCLE_CONFIG, model=name),
                        llama_mod.preset(name).vocab_size, seed=22)
    env.pop("KUBEDL_BEACON_FILE")
    data_path = json.loads(env["KUBEDL_TRAIN_CONFIG"])["data_path"]
    try:
        with forced_route(fa, "split"), recorded_training(ck, entry) as rec:
            rc1 = run_job(entry, env)[0]
            rc2 = run_job(entry, env)[0]
            if (rc1, rc2) != (137, 0):
                fail(f"identity job exited {rc1} then {rc2}")
            tr, state = rec["fits"][-1]
            resumed = [float(x) for x in rec["losses"][4:]]
            resumed_params = [t.clone() for t in tree_leaves(state["params"])]
            del state
            chain = Trainer(tr.cfg)
            del tr
            data = TokenFileDataset(data_path, chain.cfg.global_batch,
                                    chain.cfg.seq_len)
            d = os.path.join(root, "chain")
            state, _ = chain.fit(iter(data), steps=2, ckpt_dir=d)
            data.close()
            restored = ck.restore_checkpoint(d, ck.train_state_like(state),
                                             device=chain.device)
            del state
            n0 = len(rec["losses"])
            data = TokenFileDataset(data_path, chain.cfg.global_batch,
                                    chain.cfg.seq_len)
            state, _ = chain.fit(iter(data),
                                 state=ck.train_state_from_tree(restored))
            data.close()
            chained = [float(x) for x in rec["losses"][n0:]]
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(state["params"]), resumed_params))
        report = {"resumed_losses": resumed, "chained_losses": chained,
                  "params_bitwise": same}
        print("lifecycle identity, 2-layer f32 llama3-1b width: "
              + json.dumps(report), flush=True)
        if len(resumed) != 4 or resumed != chained or not same:
            fail(f"resumed run differs from the in-process chain: {report}")
    finally:
        _clear_job_env(entry)
        shutil.rmtree(root, ignore_errors=True)
        _free()


# ---- phase 5 ----------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(url, body=None, timeout=1200.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def make_requests(vocab: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(64, 1537, size=8)
    reqs = []
    for j, n in enumerate(lens):
        reqs.append({
            "prompt_ids": rng.randint(0, vocab, size=int(n)).tolist(),
            "max_tokens": 128,
            "temperature": 0.0 if j < 6 else 0.8,
        })
    return reqs


def post_all(base: str, reqs):
    results = [None] * len(reqs)

    def one(j):
        try:
            results[j] = http_json(base + "/v1/generate", reqs[j])
        except urllib.error.HTTPError as e:
            results[j] = (e.code, {"error": e.read().decode()})
        except Exception as e:  # reported as a failed request below
            results[j] = (0, {"error": repr(e)})

    threads = [threading.Thread(target=one, args=(j,)) for j in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=1500)
    return results, time.perf_counter() - t0


def reset_counts(pa):
    for counts in (pa.LAUNCHES, pa.ROUTE_LAUNCHES, pa.ENTRY_ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0


@contextlib.contextmanager
def serving(server_mod, serve_cfg, env=None):
    """``serve_main`` on 127.0.0.1 with ``serve_cfg`` (and ``env``, e.g.
    ``KUBEDL_MODEL_PATH``); yields its base URL and stops it (gracefully,
    through the cancel event) on exit. serve_main reads its config from
    the process environment, so replicas start one after another."""
    port = free_port()
    cfg = dict(serve_cfg, port=port, host="127.0.0.1")
    cancel = threading.Event()
    box = {}

    def serve():
        try:
            server_mod.serve_main({**(env or {}),
                                   "KUBEDL_SERVE_CONFIG": json.dumps(cfg),
                                   "_KUBEDL_CANCEL": cancel})
        except BaseException as e:  # surfaced by the health wait below
            box["error"] = repr(e)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    while True:
        if "error" in box:
            fail(f"server failed to start ({serve_cfg}): {box['error']}")
        try:
            if http_json(base + "/healthz", timeout=5)[0] == 200:
                break
        except OSError:
            pass
        if time.perf_counter() - t0 > 600:
            fail("server not healthy after 600 s")
        time.sleep(0.5)
    print(f"engine up in {time.perf_counter() - t0:.1f} s ({serve_cfg['preset']} "
          "init + kernel warmup)", flush=True)
    try:
        yield base
    finally:
        cancel.set()
        th.join(timeout=120)
        if th.is_alive():
            fail("server did not stop")
        _free()


def checked(results, n_tokens, what):
    for j, (code, res) in enumerate(results):
        if code != 200 or len(res.get("token_ids", [])) != n_tokens:
            fail(f"{what} request {j}: HTTP {code}, {str(res)[:300]}")
    return [r[1] for r in results]


def run_engine(pa, server_mod, llama_mod, summary):
    serve_cfg = {"preset": "llama3-8b", "max_batch": 8, "max_seq": 2048,
                 "kv_block_size": 16, "kv_attention": "blocked",
                 "prefill_chunk_tokens": 512}
    cfg8 = llama_mod.preset("llama3-8b")
    reqs = make_requests(cfg8.vocab_size)
    with serving(server_mod, serve_cfg) as base:
        _, before = http_json(base + "/v1/stats")
        torch.cuda.reset_peak_memory_stats()
        reset_counts(pa)
        results, wall = post_all(base, reqs)
        launches = dict(pa.LAUNCHES)
        routes = dict(pa.ROUTE_LAUNCHES)
        _, st = http_json(base + "/v1/stats")
        peak = torch.cuda.max_memory_allocated()
    checked(results, 128, "engine")
    pipe, pipe0 = st["pipeline"], before["pipeline"]
    steps = pipe["decode_steps"] - pipe0["decode_steps"]
    if launches["blocked"] <= 0:
        fail("blocked kernel never launched on the main path")
    if launches["fused"] < cfg8.n_layers * steps or steps <= 0:
        fail(f"fused launches {launches['fused']} < layers x decode steps "
             f"({cfg8.n_layers} x {steps})")
    # prefill chunks (S >= 16, group 4, bf16) take the tensor cores; every
    # decode step the split-K kernel
    if routes["tensor_core"] != launches["blocked"] or \
            routes["split_k"] != launches["fused"]:
        fail(f"engine routes {routes} do not match {launches}")
    if st["nonfinite_logits"] != 0:
        fail(f"{st['nonfinite_logits']} non-finite logits")
    dec_tokens = pipe["decode_tokens"] - pipe0["decode_tokens"]
    dec_ms = pipe["decode_ms_sum"] - pipe0["decode_ms_sum"]
    if pipe["deferred_harvests"] - pipe0["deferred_harvests"] <= 0:
        fail(f"the decode pipeline never deferred a harvest: {pipe}")
    eng = {
        "requests": len(reqs), "wall_s": wall,
        "prompt_lens": [len(r["prompt_ids"]) for r in reqs],
        "tokens_out": sum(len(r[1]["token_ids"]) for r in results),
        "e2e_tokens_per_s": sum(len(r[1]["token_ids"]) for r in results) / wall,
        "decode_tokens_per_s": dec_tokens / (dec_ms / 1e3),
        "ms_per_decode_step": dec_ms / steps,
        "decode_steps": steps,
        "prefill_chunks": pipe["prefill_chunks"] - pipe0["prefill_chunks"],
        "ttft_ms_p50": st.get("ttft_ms_p50"),
        "ttft_ms_p95": st.get("ttft_ms_p95"),
        "max_memory_allocated_gib": peak / 2**30,
        "weight_bytes": st["weights"]["bytes"],
        "launches": launches,
        "route_launches": routes,
        # the double-buffered tick (the reference's pipeline_stats keys)
        "pipeline": {k: pipe.get(k) for k in PIPELINE_FIELDS},
        "prefix_cache": {k: st["prefix_cache"].get(k)
                         for k in ("hits", "misses", "inserts")},
    }
    print("engine (smoke run, not a benchmark): " + json.dumps(eng), flush=True)
    summary["launches"] = launches
    summary["bf16_weight_bytes"] = st["weights"]["bytes"]
    summary["bf16_ms_per_decode_step"] = eng["ms_per_decode_step"]
    summary["bf16_ttft_ms_p50"] = eng["ttft_ms_p50"]
    blocked_tokens = [r[1]["token_ids"] for r in results[:6]]
    return blocked_tokens, reqs, serve_cfg


#: pipeline_stats fields each engine phase prints
PIPELINE_FIELDS = ("ticks", "segments", "deferred_harvests", "flushes",
                   "chain_rebuilds", "overlap_ratio", "dispatch_ms_p50",
                   "harvest_ms_p50", "host_ms_p50", "tick_ms_p50",
                   "ms_per_decode_step", "decode_tokens_per_s")


def generate_concurrent(eng, reqs):
    """One thread per request into ``eng.generate``; results in order."""
    outs = [None] * len(reqs)

    def one(j):
        outs[j] = eng.generate(reqs[j]["prompt_ids"], reqs[j]["max_tokens"],
                               reqs[j]["temperature"])

    ths = [threading.Thread(target=one, args=(j,)) for j in range(len(reqs))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=1500)
    return outs


def generate_all(server_mod, engine_kw, reqs, around=None):
    """Concurrent generate() calls on a fresh engine (closed after);
    ``around`` wraps only the requests (e.g. a profiler context)."""
    eng = server_mod.LlamaEngine(**engine_kw)
    try:
        with (around or contextlib.nullcontext()):
            outs = generate_concurrent(eng, reqs)
    finally:
        eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return outs


def run_f32_parity(server_mod, llama_mod, reqs, serve_cfg):
    """Gate: Llama-3-8B width, depth cut to 2, float32 — the blocked
    kernels and the gather oracle give identical greedy streams."""
    name = "llama3-8b-2layer-f32"
    llama_mod.PRESETS[name] = dataclasses.replace(
        llama_mod.preset("llama3-8b"), n_layers=2, dtype=torch.float32)
    greedy = [dict(r, max_tokens=32) for r in reqs if r["temperature"] == 0.0]
    streams = {}
    for kern in ("blocked", "gather"):
        kw = dict(serve_cfg, preset=name, kv_attention=kern)
        outs = generate_all(server_mod, kw, greedy)
        streams[kern] = [(o or {}).get("token_ids") for o in outs]
    if any(t is None or len(t) != 32 for t in streams["blocked"]) or \
            streams["blocked"] != streams["gather"]:
        fail("f32 2-layer Llama-3-8B: blocked and gather greedy streams "
             f"differ: {streams}")
    print(f"f32 2-layer llama3-8b width: blocked == gather on "
          f"{len(greedy)} greedy streams x 32 tokens", flush=True)


def _kernel_category(name: str) -> str:
    # the tensor-core decode: one kernel for fused and blocked calls; the
    # engine phases launch it for decode steps only (Gemma-2B's)
    if "paged_decode_mma_kernel" in name:
        return "paged_attention_fused"
    if "paged_split_kernel" in name:  # split-K: by its fused flag
        return "paged_attention_fused" if "true>" in name \
            else "paged_attention_blocked"
    if "paged_combine_kernel" in name:  # the split-K merge
        return "paged_attention_combine"
    if "paged_prefill_tc_kernel" in name or "paged_attention_kernel" in name:
        return "paged_attention_blocked"
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "cublas", "gemv",
                              "nvjet")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def run_profile(server_mod, reqs, serve_cfg):
    """Where the device time goes on the main path: device time of every
    kernel in a profiled engine run, by category, and the busy share.
    Device activity only: the kernel times are all it reads."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    short = [dict(r, max_tokens=32) for r in reqs]
    prof = profile(activities=[ProfilerActivity.CUDA])
    span = {}

    @contextlib.contextmanager
    def window():
        with prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            span["wall_ms"] = (time.perf_counter() - t0) * 1e3

    outs = generate_all(server_mod, serve_cfg, short, around=window())
    wall_ms = span["wall_ms"]
    if any(len((o or {}).get("token_ids", [])) != 32 for o in outs):
        fail(f"profiled run: bad responses {str(outs)[:300]}")
    cats, counts, top = {}, {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        cat = _kernel_category(e.key)
        cats[cat] = cats.get(cat, 0.0) + us / 1e3
        counts[cat] = counts.get(cat, 0) + e.count
        top.append((us / 1e3, e.count, e.key[:90]))
    dev_ms = sum(cats.values())
    top.sort(reverse=True)
    print("profile (8 concurrent requests x 32 tokens): " + json.dumps({
        "wall_ms": wall_ms, "device_ms": dev_ms,
        "busy_share": dev_ms / wall_ms if wall_ms else None,
        "by_category_ms": cats,
        "by_category_kernels": counts,
        "ms_per_kernel": {k: cats[k] / counts[k] for k in cats if counts[k]},
        "top": [[n, ms, c] for ms, c, n in top[:10]],
    }), flush=True)
    if dev_ms == 0.0:
        print("profile: the profiler saw no device time", flush=True)


def run_gather(server_mod, reqs, serve_cfg, blocked_tokens):
    outs = generate_all(server_mod, dict(serve_cfg, kv_attention="gather"),
                        reqs)
    same = total = 0
    prefixes = []
    for a, res in zip(blocked_tokens, outs[:6]):
        b = (res or {}).get("token_ids", [])
        total += len(a)
        same += sum(1 for x, y in zip(a, b) if x == y)
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        prefixes.append(n)
    print("greedy agreement gather vs blocked (printed, not gated): "
          + json.dumps({"tokens_equal": same, "tokens": total,
                        "common_prefix_lens": prefixes}), flush=True)


# ---- phases 13 to 15: the prefix cache and speculative decoding --------------

def shared_prefix_requests(vocab, new_tokens, seed=1):
    """8 greedy requests sharing a 1024-token system prompt, each with its
    own 64-256-token suffix."""
    rng = np.random.RandomState(seed)
    system = rng.randint(0, vocab, size=1024).tolist()
    return [{"prompt_ids": system + rng.randint(0, vocab, size=int(n)).tolist(),
             "max_tokens": new_tokens, "temperature": 0.0}
            for n in rng.randint(64, 257, size=8)]


def profiled_paged(fn):
    """Run ``fn`` under torch.profiler; device ms and kernel count of the
    paged kernels by category (the blocked kernel's split-K launches
    apart from its tensor-core ones), and of every kernel ("device").
    Device activity only: kernel times are all this reads, and host ops
    would cost minutes of trace processing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cats = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        cat = _kernel_category(e.key)
        if cat == "paged_attention_blocked" and "paged_split_kernel" in e.key:
            cat = "paged_attention_blocked_split"
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        for key in {cat, "device"} if cat.startswith("paged") else {"device"}:
            ms, n = cats.get(key, (0.0, 0))
            cats[key] = (ms + us / 1e3, n + e.count)
    return {k: {"ms": ms, "kernels": n, "ms_per_kernel": ms / n if n else None}
            for k, (ms, n) in cats.items()}


def run_shared_prefix(pa, server_mod, llama_mod, summary):
    """Phase 13: Llama-3-8B bf16, full depth, prefix_cache_mb 512, whole-
    prompt prefill (so the only blocked launches are grafted suffixes):
    two requests walk the shared 1024-token prompt (the observation trie
    stores it at their prefill), then six more graft it. Gates on hits,
    tokens saved, every second-wave row grafting all 1024 tokens and
    blocked launches in that wave; records TTFT against the same waves at
    prefix_cache_mb 0 (no graft: no blocked launch there, gated)."""
    cfg8 = llama_mod.preset("llama3-8b")
    reqs = shared_prefix_requests(cfg8.vocab_size, 64)
    base_cfg = {"preset": "llama3-8b", "max_batch": 8, "max_seq": 2048,
                "kv_block_size": 16, "kv_attention": "blocked",
                "prefill_chunk_tokens": 0}
    out, streams = {}, {}
    for mb in (512.0, 0.0):
        with serving(server_mod, dict(base_cfg, prefix_cache_mb=mb)) as base:
            checked(post_all(base, reqs[:2])[0], 64, "prefix warm")
            reset_counts(pa)
            res, wall = post_all(base, reqs[2:])
            launches = dict(pa.LAUNCHES)
            routes = dict(pa.ENTRY_ROUTE_LAUNCHES)
            res = checked(res, 64, f"prefix_cache_mb={mb}")
            _, st = http_json(base + "/v1/stats")
            rec = {"wave2_wall_s": wall, "launches": launches,
                   "entry_routes": {k: v for k, v in routes.items() if v},
                   "ttft_ms": sorted(r["ttft_ms"] for r in res),
                   "cached_prefix_lens": [r["cached_prefix_len"] for r in res],
                   "pipeline": {k: st["pipeline"].get(k)
                                for k in PIPELINE_FIELDS}}
            rec["ttft_ms_p50"] = statistics.median(rec["ttft_ms"])
            if mb:
                rec["prefix_cache"] = {k: st["prefix_cache"][k] for k in (
                    "hits", "misses", "inserts", "tokens_saved", "entries",
                    "bytes", "evictions")}
                rec["advertised"] = len(st["prefix_cache"]["advertised"])
                # in-model time of the grafted-suffix prefill: the same
                # wave again (every row grafts again), profiled, with two
                # new tokens (the prefill is what it reads)
                short = [dict(r, max_tokens=2) for r in reqs[2:]]
                rec["profile"] = profiled_paged(
                    lambda: checked(post_all(base, short)[0], 2,
                                    "prefix profiled"))
                summary.setdefault("paths", {})["shared_prefix"] = launches
            streams[mb] = [r["token_ids"] for r in res]
            out[f"prefix_cache_mb={mb:g}"] = rec
    hit = out["prefix_cache_mb=512"]
    if hit["prefix_cache"]["hits"] <= 0 or \
            hit["prefix_cache"]["tokens_saved"] <= 0:
        fail(f"shared-prefix phase: no prefix hit {hit['prefix_cache']}")
    if hit["cached_prefix_lens"] != [1024] * 6:
        fail(f"shared-prefix rows did not graft the 1024-token prompt: "
             f"{hit['cached_prefix_lens']}")
    if hit["launches"]["blocked"] <= 0:
        fail("the blocked kernel never launched on grafted suffixes")
    if out["prefix_cache_mb=0"]["launches"]["blocked"] != 0:
        fail("whole-prompt prefill without a graft launched the blocked "
             "kernel")
    same = sum(a == b for x, y in zip(streams[512.0], streams[0.0])
               for a, b in zip(x, y))
    out["greedy_tokens_equal_hit_vs_miss"] = [same, 6 * 64]
    print("shared prefix (smoke run, not a benchmark): " + json.dumps(out),
          flush=True)


def spec_requests(vocab, seed=2):
    """8 greedy requests, prompts of 64-512 tokens, 64 new tokens."""
    rng = np.random.RandomState(seed)
    return [{"prompt_ids": rng.randint(0, vocab, size=int(n)).tolist(),
             "max_tokens": 64, "temperature": 0.0}
            for n in rng.randint(64, 513, size=8)]


def run_speculative(pa, server_mod, llama_mod, serve_cfg, summary):
    """Phase 14: Llama-3-8B bf16, full depth, the main engine's config
    with spec_k 4 and the n-gram draft, then the early-exit model draft
    (spec_draft_layers 4). Gates: every request answered, verify rounds,
    and the blocked kernel launched on the split-K route (S = 5, R = 20)
    while verifying; records acceptance, tokens per verify, ms per
    emitted token and verify ms, and (n-gram) the in-model time of the
    verify launches."""
    cfg8 = llama_mod.preset("llama3-8b")
    reqs = spec_requests(cfg8.vocab_size)
    out = {}
    for draft, extra in (("ngram", {}), ("model", {"spec_draft_layers": 4})):
        cfg = dict(serve_cfg, spec_k=4, spec_draft=draft, **extra)
        with serving(server_mod, cfg) as base:
            reset_counts(pa)
            res, wall = post_all(base, reqs)
            launches = dict(pa.LAUNCHES)
            routes = dict(pa.ENTRY_ROUTE_LAUNCHES)
            res = checked(res, 64, f"spec {draft}")
            _, st = http_json(base + "/v1/stats")
            sp, pipe = st["speculative"], st["pipeline"]
            if sp["verifies"] <= 0:
                fail(f"spec {draft}: no verify round {sp}")
            if routes["blocked/split_k"] <= 0:
                fail(f"spec {draft}: the blocked kernel never took the "
                     f"split-K route while verifying: {routes}")
            rounds = max(pipe["spec_rounds"], 1)
            round_ms = pipe["spec_ms_sum"] / rounds
            rec = {"wall_s": wall,
                   "e2e_tokens_per_s": 64 * len(reqs) / wall,
                   "launches": launches,
                   "entry_routes": {k: v for k, v in routes.items() if v},
                   "speculative": sp,
                   "spec_rounds": pipe["spec_rounds"],
                   # a round verifies every decoding row at once: a row's
                   # ms per emitted token is the round over its tokens (to
                   # set beside the plain engine's ms per decode step)
                   "ms_per_token_per_row": round_ms
                   / max(sp["tokens_per_verify"], 1e-9),
                   "batch_ms_per_emitted_token": pipe["spec_ms_sum"]
                   / max(sp["emitted"], 1),
                   "verify_ms_per_round": pipe["verify_ms_sum"] / rounds,
                   "spec_ms_per_round": round_ms,
                   "ttft_ms_p50": st.get("ttft_ms_p50")}
            if draft == "ngram":
                summary.setdefault("paths", {})["speculative"] = launches
                short = [dict(r, max_tokens=16) for r in reqs]
                rec["profile"] = profiled_paged(
                    lambda: checked(post_all(base, short)[0], 16,
                                    "spec profiled"))
            out[draft] = rec
    print("speculative (smoke run, not a benchmark): " + json.dumps(out),
          flush=True)


def run_f32_identity(server_mod, llama_mod):
    """Phase 15: Llama-3-8B width cut to 2 layers, float32, blocked: the
    greedy streams with the prefix cache on, with spec_k 4 (n-gram), with
    spec_k 4 + 3 candidates + the tree, and with the model draft must be
    IDENTICAL to the plain engine's (prefix cache off, no speculation) on
    the shared-prefix requests in two waves. A divergence fails the run."""
    name = "llama3-8b-2layer-f32"
    llama_mod.PRESETS.setdefault(name, dataclasses.replace(
        llama_mod.preset("llama3-8b"), n_layers=2, dtype=torch.float32))
    reqs = shared_prefix_requests(llama_mod.preset(name).vocab_size, 32,
                                  seed=3)
    base_kw = dict(preset=name, max_batch=8, max_seq=2048, kv_block_size=16,
                   kv_attention="blocked", prefill_chunk_tokens=512)
    variants = {
        "plain": dict(prefix_cache_mb=0.0),
        "prefix": dict(prefix_cache_mb=512.0),
        "spec_ngram": dict(prefix_cache_mb=0.0, spec_k=4),
        "spec_tree": dict(prefix_cache_mb=0.0, spec_k=4, spec_candidates=3,
                          spec_tree=True),
        "spec_model": dict(prefix_cache_mb=0.0, spec_k=4, spec_draft="model"),
    }
    streams, facts = {}, {}
    for label, kw in variants.items():
        eng = server_mod.LlamaEngine(**base_kw, **kw)
        try:
            outs = generate_concurrent(eng, reqs[:2]) \
                + generate_concurrent(eng, reqs[2:])
            st = eng.stats()
        finally:
            eng.close()
        del eng
        _free()
        streams[label] = [(o or {}).get("token_ids") for o in outs]
        if any(t is None or len(t) != 32 for t in streams[label]):
            fail(f"f32 identity {label}: bad responses {str(outs)[:300]}")
        facts[label] = {
            "prefix_hits": st.get("prefix_cache", {}).get("hits"),
            "verifies": st.get("speculative", {}).get("verifies"),
            "accepted": st.get("speculative", {}).get("accepted"),
            "candidates_scored": st.get("speculative", {}).get(
                "candidates_scored"),
        }
    for label in variants:
        if streams[label] != streams["plain"]:
            fail(f"f32 2-layer Llama-3-8B: {label} greedy streams differ "
                 f"from the plain engine's: {streams[label]} vs "
                 f"{streams['plain']}")
    if not facts["prefix"]["prefix_hits"]:
        fail(f"f32 identity: the prefix variant never hit {facts}")
    if not all(facts[k]["verifies"] for k in variants if k.startswith("spec")):
        fail(f"f32 identity: a spec variant never verified {facts}")
    if not facts["spec_tree"]["candidates_scored"]:
        fail(f"f32 identity: the tree variant scored no candidate {facts}")
    print("f32 2-layer llama3-8b width, greedy identity with the plain "
          "engine (8 streams x 32 tokens): " + json.dumps(facts), flush=True)


# ---- phase 22: Gemma-2B through the port --------------------------------------

#: phase 5's serving config with Gemma-2B: full width and depth (18 layers,
#: MQA: one kv-head, group 8, hd 256; a 256,000-token tied vocabulary)
GEMMA_SERVE = {"preset": "gemma-2b", "max_batch": 8, "max_seq": 2048,
               "kv_block_size": 16, "kv_attention": "blocked",
               "prefill_chunk_tokens": 512}
#: the bf16 in-model gate's starts: phase 3's, each row on blocks of its own
#: (the chunk's writes would collide in an all-trash row's block 0)
GEMMA_GATE_STARTS = [0, 15, 16, 47, 300, 1023, 1500, 700]
#: The bf16 in-model gate's tolerance: max |logit difference| over the plain
#: run's largest |logit|. The two sides differ only in paged attention,
#: whose outputs agree within about one bf16 ulp (2^-8 relative; the kernel
#: also rounds P to bf16 before P.V, as the reference does). Such a
#: perturbation of the hidden state passes through two layers of bf16
#: matmuls with float32 sums and the final norm, each a relative map, so
#: the logits move by a few 2^-8 of their scale at most: 2e-2 (about 5
#: bf16 ulps) leaves room for two layers' roundings on top.
GEMMA_LOGIT_TOL = 2e-2


@contextlib.contextmanager
def forced_plain_paged(pa):
    """The blocked entry's plain version forced on CUDA tensors (the
    in-model gate's other side); the kernel is restored on exit. Blocked
    prefill calls only: a fused or read-only call raises."""
    kernel = pa.paged_attention

    def plain(q, k_pool, v_pool, bt, starts, **kw):
        if any(v is not None for v in kw.values()):
            raise ValueError(f"forced plain paged attention: {sorted(kw)}")
        return pa.plain_paged_attention(q, k_pool, v_pool, bt, starts)

    pa.paged_attention = plain
    try:
        yield
    finally:
        pa.paged_attention = kernel


def run_gemma_engine(pa, server_mod, llama_mod, summary):
    """Phase 22: serve_main with Gemma-2B (``GEMMA_SERVE``, seeded random
    bf16 weights) on phase 5's kind of traffic (``make_requests``: 8
    requests, prompts 64-1536, 128 new tokens, 6 greedy, 2 sampled). Gates:
    every response; blocked launches, every one on the tensor-core route
    (the hd-256 kernel); fused launches >= 18 x decode steps, every one on
    the tensor-core decode; no CUDA-core launch; finite logits; a deferred
    harvest. Then a
    profiled repeat of the wave at 16 new tokens, the profiler spanning it
    (one opened mid-wave records nothing): the paged kernels' device ms a
    launch in the engine, their share of device time, the busy share."""
    cfg = llama_mod.preset("gemma-2b")
    reqs = make_requests(cfg.vocab_size)
    with serving(server_mod, GEMMA_SERVE) as base:
        before = engine_idle(base, "gemma engine")
        torch.cuda.reset_peak_memory_stats()
        reset_counts(pa)
        results, wall = post_all(base, reqs)
        st = engine_idle(base, "gemma engine")
        launches = dict(pa.LAUNCHES)
        entry_routes = dict(pa.ENTRY_ROUTE_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        short, span = [dict(r, max_tokens=16) for r in reqs], {}

        def wave():  # timed inside the profiler, before its processing
            t0 = time.perf_counter()
            checked(post_all(base, short)[0], 16, "gemma profiled wave")
            torch.cuda.synchronize()
            span["ms"] = (time.perf_counter() - t0) * 1e3

        prof = profiled_paged(wave)
        prof_wall_ms = span["ms"]
    checked(results, 128, "gemma engine")
    pipe, pipe0 = st["pipeline"], before["pipeline"]
    steps = pipe["decode_steps"] - pipe0["decode_steps"]
    if launches["blocked"] <= 0 or \
            entry_routes["blocked/tensor_core"] != launches["blocked"]:
        fail(f"gemma engine: blocked launches {launches['blocked']}, "
             f"routes {entry_routes}: every prefill chunk on the tensor cores")
    if steps <= 0 or launches["fused"] < cfg.n_layers * steps or \
            entry_routes["fused/mma_decode"] != launches["fused"]:
        fail(f"gemma engine: fused launches {launches['fused']} for "
             f"{cfg.n_layers} x {steps} decode steps, routes {entry_routes}")
    if pa.CUDA_CORE in {k.split("/")[1] for k, v in entry_routes.items() if v}:
        fail(f"gemma engine: a CUDA-core launch {entry_routes}")
    if st["nonfinite_logits"] != 0:
        fail(f"gemma engine: {st['nonfinite_logits']} non-finite logits")
    if pipe["deferred_harvests"] - pipe0["deferred_harvests"] <= 0:
        fail(f"gemma engine: the decode pipeline never deferred a harvest: "
             f"{pipe}")
    dev_ms = prof.get("device", {}).get("ms", 0.0)
    paged_ms = sum(v["ms"] for k, v in prof.items() if k != "device")
    in_model = {  # device ms a launch; the tensor-core decode has no merge
        # launch of its own (None), split-K's followed each fused launch
        "blocked": prof.get("paged_attention_blocked", {}).get(
            "ms_per_kernel"),
        "fused": prof.get("paged_attention_fused", {}).get("ms_per_kernel"),
        "merge": prof.get("paged_attention_combine", {}).get("ms_per_kernel"),
        "wall_ms": prof_wall_ms, "device_ms": dev_ms,
        "busy_share": dev_ms / prof_wall_ms,
        "paged_share": paged_ms / dev_ms if dev_ms else None,
        "by_category": prof}
    dec_tokens = pipe["decode_tokens"] - pipe0["decode_tokens"]
    dec_ms = pipe["decode_ms_sum"] - pipe0["decode_ms_sum"]
    rec = {
        "requests": len(reqs), "wall_s": wall,
        "prompt_lens": [len(r["prompt_ids"]) for r in reqs],
        "tokens_out": sum(len(r[1]["token_ids"]) for r in results),
        "decode_tokens_per_s": dec_tokens / (dec_ms / 1e3),
        "ms_per_decode_step": dec_ms / steps,
        "decode_steps": steps,
        "prefill_chunks": pipe["prefill_chunks"] - pipe0["prefill_chunks"],
        "ttft_ms_p50": st.get("ttft_ms_p50"),
        "ttft_ms_p95": st.get("ttft_ms_p95"),
        "max_memory_allocated_gib": peak / 2**30,
        "weight_bytes": st["weights"]["bytes"],
        "launches": launches,
        "entry_routes": {k: v for k, v in entry_routes.items() if v},
        "fused_per_decode_step": launches["fused"] / steps,
        "pipeline": {k: pipe.get(k) for k in PIPELINE_FIELDS},
        "profiled_wave": in_model,
    }
    print("gemma-2b engine (smoke run, not a benchmark): " + json.dumps(rec),
          flush=True)
    if dev_ms == 0.0:
        print("gemma-2b profile: the profiler saw no device time", flush=True)
    summary.setdefault("paths", {})["gemma"] = launches
    summary["gemma_in_model"] = in_model


def run_gemma_prefill_gate(pa, llama_mod):
    """Phase 22's bf16 gate: Gemma-2B width cut to 2 layers, bf16, seeded
    weights and pool history; ``paged_prefill_from`` (the chunked prefill's
    model function) over a 512-token chunk for 8 rows at ragged starts,
    once through the kernel (2 tensor-core launches) and once with the
    plain version forced. Gates: the last-position logits within
    ``GEMMA_LOGIT_TOL`` of the plain run's largest |logit|, and the argmax
    equal on every row whose top-2 gap exceeds that tolerance."""
    cfg = dataclasses.replace(llama_mod.preset("gemma-2b"), n_layers=2)
    g = torch.Generator(device=DEV).manual_seed(22)
    params = llama_mod.llama_init(cfg, g, DEV)
    B, S, BS, max_seq = 8, 512, 16, 2048
    MB = max_seq // BS
    NB = 1 + B * MB
    cache = llama_mod.init_paged_cache(cfg, B, max_seq, NB, BS, DEV)
    cache["k"].normal_(generator=g)  # each row's history before its start
    cache["v"].normal_(generator=g)
    perm = torch.randperm(NB - 1, generator=g, device=DEV) + 1
    cache["bt"] = perm.to(torch.int32).reshape(B, MB).contiguous()
    starts = torch.tensor(GEMMA_GATE_STARTS, dtype=torch.int32, device=DEV)
    cache["pos"] = starts.clone()
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         device=DEV).to(torch.int32)
    lens = torch.full((B,), S, dtype=torch.int32, device=DEV)

    def prefill():
        c = {k: v.clone() for k, v in cache.items()}
        with torch.no_grad():
            logits, _ = llama_mod.paged_prefill_from(
                params, c, toks, lens, starts, cfg, kv_attention="blocked")
        torch.cuda.synchronize()
        return logits.float()

    n0 = dict(pa.ENTRY_ROUTE_LAUNCHES)
    kern = prefill()
    n1 = dict(pa.ENTRY_ROUTE_LAUNCHES)
    with forced_plain_paged(pa):
        plain = prefill()
    if n1["blocked/tensor_core"] - n0["blocked/tensor_core"] != cfg.n_layers \
            or sum(n1.values()) - sum(n0.values()) != cfg.n_layers \
            or pa.ENTRY_ROUTE_LAUNCHES != n1:
        fail(f"gemma in-model gate: launches {n0} -> {n1} -> "
             f"{pa.ENTRY_ROUTE_LAUNCHES}: want {cfg.n_layers} tensor-core "
             "launches, then none under the plain version")
    scale = plain.abs().max().item()
    tol = GEMMA_LOGIT_TOL * scale
    err = (kern - plain).abs().max().item()
    top2 = plain.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).tolist()
    same = (kern.argmax(-1) == plain.argmax(-1)).tolist()
    rec = {"max_abs_err": err, "max_abs_logit": scale, "tol": tol,
           "err_over_scale": err / scale, "top2_gap": gap,
           "argmax_equal": same}
    print("gemma-2b 2-layer bf16, paged_prefill_from kernel vs forced "
          "plain: " + json.dumps(rec), flush=True)
    if not math.isfinite(err) or err > tol:
        fail(f"gemma in-model gate: logits differ by {err} > {tol}")
    if not all(ok for ok, d in zip(same, gap) if d > tol):
        fail(f"gemma in-model gate: argmax differs on a row whose top-2 gap "
             f"exceeds {tol}: {rec}")


def run_gemma_f32_identity(pa, server_mod, llama_mod):
    """Phase 22's f32 gate: Gemma-2B width cut to 2 layers, float32: the
    blocked engine's greedy streams IDENTICAL to the gather engine's on the
    shared-prefix requests in two waves (the second grafts the shared
    prompt). It holds the Gemma-specific model code on the card (GeGLU
    with tanh, (1+w) norms, the embedding scale, the tied head); the
    float32 prefill takes the CUDA-core route, decode the split-K one."""
    name = "gemma-2b-2layer-f32"
    llama_mod.PRESETS.setdefault(name, dataclasses.replace(
        llama_mod.preset("gemma-2b"), n_layers=2, dtype=torch.float32))
    reqs = shared_prefix_requests(llama_mod.preset(name).vocab_size, 32,
                                  seed=3)
    streams, routes = {}, {}
    for kern in ("blocked", "gather"):
        eng = server_mod.LlamaEngine(**dict(GEMMA_SERVE, preset=name,
                                            kv_attention=kern))
        reset_counts(pa)
        try:
            outs = generate_concurrent(eng, reqs[:2]) \
                + generate_concurrent(eng, reqs[2:])
        finally:
            eng.close()
        routes[kern] = {k: v for k, v in pa.ENTRY_ROUTE_LAUNCHES.items() if v}
        del eng
        _free()
        streams[kern] = [(o or {}).get("token_ids") for o in outs]
    if any(t is None or len(t) != 32 for t in streams["blocked"]) or \
            streams["blocked"] != streams["gather"]:
        fail("f32 2-layer Gemma-2B: blocked and gather greedy streams "
             f"differ: {streams}")
    if not routes["blocked"].get("blocked/cuda_core") or \
            not routes["blocked"].get("fused/split_k") or routes["gather"]:
        fail(f"f32 2-layer Gemma-2B: paged routes {routes}")
    print(f"f32 2-layer gemma-2b width: blocked == gather on {len(reqs)} "
          f"greedy streams x 32 tokens; routes {json.dumps(routes)}",
          flush=True)


# ---- phases 16 to 19: int8 weights, checkpoints and versions, the pair -------

W8_M = (1, 8, 40, 64, 512)
#: the kernels line's shapes: the MLP's up projection at decode (M=8, the
#: decode route) and in a prefill chunk (M=512, the prefill route)
W8_MAIN = (4096, 14336)
#: the tied case: Gemma-2B's embedding as its head (K = dim, N = vocab)
W8_TIED = (2048, 256000)
#: the timed cases: every layer shape at decode (M=8) and verify (M=40)
#: rows; these two also at M=64 (both routes apply at 40 and 64) and in a
#: prefill chunk (M=512)
W8_TIMED = {(4096, 14336), (4096, 128256)}
W8_REPLACES = ("kubedl_tpu/models/llama.py:332 deq (convert+scale fused into "
               "the consuming dot by XLA; no Pallas kernel)")
#: Tolerances of the W8A16 kernel against its plain version, relative to
#: the largest output: bf16 1e-2 (both sum in float32 and round once to
#: bf16; cuBLAS may split K: ~2 bf16 ulps at the top of the range); float32
#: 2e-5 (the same exact float32 weight, float32 sums reordered over K <=
#: 14336: measured ~6e-6)
W8_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}


@contextlib.contextmanager
def forced_plain_w8a16(w8):
    """The int8 matmul's plain version forced on CUDA tensors (the
    identity gate's other side); the kernel is restored on exit."""
    kernel = w8.w8a16_matmul
    w8.w8a16_matmul = lambda h, q8, s8, transposed=False: \
        w8.plain_w8a16_matmul(h, q8, s8, transposed)
    try:
        yield
    finally:
        w8.w8a16_matmul = kernel


def w8_step_shapes(cfg) -> dict:
    """The int8 weights a decode step reads, ``(K, N) -> launches``: each
    layer's wq, wk, wv, wo, w_gate, w_up and w_down, then the head (for
    Llama-3-8B 7 x 32 + 1 = 225 launches over five shapes)."""
    D, F, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    out: dict = {}
    for kn in ((D, q), (D, kv), (D, kv), (q, D), (D, F), (D, F), (F, D)):
        out[kn] = out.get(kn, 0) + L
    out[(D, cfg.vocab_size)] = out.get((D, cfg.vocab_size), 0) + 1
    return out


def w8_per_step(cfg) -> int:
    """W8A16 launches a decode step (and a prefill dispatch)."""
    return sum(w8_step_shapes(cfg).values())


def int8_weight_bytes(cfg) -> int:
    """The bytes an int8 tree holds, from the config alone: a byte a
    quantized weight and its bf16 scales (one an output column; one a
    row for the embedding, which is the head when tied), and the norms
    in the model's dtype."""
    esz = torch.tensor([], dtype=cfg.dtype).element_size()
    n = sum(c * (K * N + 2 * N) for (K, N), c in w8_step_shapes(cfg).items())
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.dim + 2 * cfg.vocab_size
    return n + (2 * cfg.n_layers + 1) * cfg.dim * esz


def w8_bound(M, N, K, dtype):
    """Least time for ``y = h @ deq(w)``: h, the int8 weight and its bf16
    scales read once, y written once, against 2 M N K operations at the
    peak rate of h's type."""
    esz = torch.tensor([], dtype=dtype).element_size()
    nbytes = M * K * esz + K * N + 2 * N + M * N * esz
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * M * N * K / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def w8_case(llama_mod, K, N, tied, seed):
    """A Llama-scale weight N(0, 1/K) in float32, its int8 leaf (the
    port's quantizer: per column, or per row for the tied [N, K]) and
    its bf16 copy for cuBLAS."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    w = torch.randn((N, K) if tied else (K, N), generator=g, device=DEV)
    w /= math.sqrt(K)
    q = llama_mod._quant_leaf(w, axis=-1 if tied else -2)
    wb = (w.T if tied else w).to(torch.bfloat16).contiguous()
    del w
    return q["q8"], q["s8"], wb


#: the case whose host cost a call phase 16 reads (the engine's decode
#: step is host-bound: 225 calls a step)
W8_HOST = (4096, 4096)


def host_us_per_call(fn, calls=500):
    """Host microseconds a call of ``fn`` takes to queue its work, over
    ``calls`` calls issued back to back (the card runs them meanwhile)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def w8_timed_routes(w8, K, N, M, tied):
    """The bf16 routes phase 16 times at a case: every layer shape at
    decode rows (M=8: the decode route) and verify rows (M=40: both
    routes, for each route's verify-step sum); ``W8_TIMED`` also at M=64
    (both) and in a prefill chunk (M=512: the prefill route); the tied
    head at M=8 only."""
    if M == 8:
        return (w8.DECODE,)
    if tied:
        return ()
    if M == 40:
        return (w8.DECODE, w8.PREFILL)
    if (K, N) in W8_TIMED:
        return {64: (w8.DECODE, w8.PREFILL), 512: (w8.PREFILL,)}.get(M, ())
    return ()


def run_w8a16_kernels(w8, llama_mod):
    """Phase 16: the W8A16 kernels against their plain version at
    Llama-3-8B's shapes (M in ``W8_M``, bf16 and float32 h) and one tied
    [N, K] case at Gemma-2B widths: for bf16 h the static route, then each
    route forced (decode and prefill, each at every M), each within
    ``W8_TOL`` and each bit-identical over two calls (the decode route's
    split-K sums are deterministic); for float32 the CUDA-core route. At
    the timed cases each timed route's device and call time, the plain
    version (dequantize, then torch.matmul), cuBLAS bf16 on the
    unquantized weight (the yardstick) and the bound; the sums over a
    decode step (M=8) and a verify step (M=40) per route."""
    out, per_route, host = {}, {}, {}
    shapes = w8_step_shapes(llama_mod.preset("llama3-8b"))
    cases = [(K, N, False) for K, N in shapes] + [W8_TIED + (True,)]
    for K, N, tied in cases:
        q8, s8, wb = w8_case(llama_mod, K, N, tied, seed=K + N)
        for M in W8_M:
            for dtype in (torch.bfloat16, torch.float32):
                g = torch.Generator(device=DEV).manual_seed(M)
                h = torch.randn((M, K), generator=g, device=DEV).to(dtype)
                ref = w8.plain_w8a16_matmul(h, q8, s8, tied)
                scale = ref.float().abs().max().item()
                route = w8.w8a16_route(M, N, K, dtype, tied)
                key = f"{K}x{N}{' tied' if tied else ''} M={M} " \
                      f"{str(dtype).split('.')[-1]}"
                rec = {"route": route, "max_abs_out": scale, "err": {}}
                forced = (None, w8.DECODE, w8.PREFILL) \
                    if dtype == torch.bfloat16 else (None,)
                for fr in forced:
                    before = dict(w8.LAUNCHES)
                    y = w8.w8a16_matmul(h, q8, s8, tied, route=fr)
                    torch.cuda.synchronize()
                    took = fr or route
                    if (w8.LAUNCHES["w8a16"] != before["w8a16"] + 1 or
                            w8.LAUNCHES[f"w8a16_{took}"]
                            != before[f"w8a16_{took}"] + 1):
                        fail(f"w8a16 {key} route {took}: did not launch "
                             "its kernel")
                    err = (y.float() - ref.float()).abs().max().item()
                    if not math.isfinite(err) or err > W8_TOL[dtype] * scale:
                        fail(f"w8a16 {key} route {took}: max abs err {err} "
                             f"> {W8_TOL[dtype]} x {scale}")
                    if fr is not None:
                        y2 = w8.w8a16_matmul(h, q8, s8, tied, route=fr)
                        if not torch.equal(y, y2):
                            fail(f"w8a16 {key} route {fr}: two calls on the "
                                 "same inputs differ")
                        del y2
                    rec["err"][str(fr or "static")] = err
                    del y
                rec["max_abs_err"] = max(rec["err"].values())
                timed = w8_timed_routes(w8, K, N, M, tied) \
                    if dtype == torch.bfloat16 else ()
                if timed:
                    rec["plain_ms"] = time_ms(
                        lambda: w8.plain_w8a16_matmul(h, q8, s8, tied),
                        reps=10, hide_host=False)
                    rec["deq_ms"] = time_ms(
                        lambda: w8.deq_weight(q8, s8, dtype, tied), reps=10,
                        hide_host=False)
                    lib = lambda: h @ wb  # noqa: E731
                    rec["library_ms"] = time_ms(lib)
                    rec["library_call_ms"] = time_ms(lib, hide_host=False)
                    rec["bound_ms"], rec["bound_by"] = w8_bound(M, N, K,
                                                                dtype)
                    rec["routes"] = {}
                    for r in timed:
                        kern = lambda: w8.w8a16_matmul(  # noqa: E731
                            h, q8, s8, tied, route=r)
                        ms = time_ms(kern)
                        rec["routes"][r] = {
                            "ms": ms, "call_ms": time_ms(kern, hide_host=False),
                            "ms_over_bound": ms / rec["bound_ms"],
                            "ms_over_library": ms / rec["library_ms"]}
                        if not tied:
                            per_route.setdefault((M, r), {})[(K, N)] = dict(
                                rec, **rec["routes"][r])
                    # the static route's numbers at the top of the record
                    if route in rec["routes"]:
                        rec.update({k: rec["routes"][route][k]
                                    for k in ("ms", "call_ms")})
                    if (K, N) == W8_HOST and M == 8:
                        host["w8a16"] = host_us_per_call(
                            lambda: w8.w8a16_matmul(h, q8, s8, tied))
                        host["library"] = host_us_per_call(lib)
                        rec["host_us_per_call"] = dict(host)
                out[key] = rec
                print(f"w8a16 {key}: " + json.dumps(rec), flush=True)
                del h, ref
        del q8, s8, wb
        _free()
    # a decode step's (M=8) and a verify step's (M=40) W8A16 work in
    # isolation, per route: the sum over the step's launches, beside
    # cuBLAS bf16 and the bound
    sums = {}
    for (M, r), recs in sorted(per_route.items()):
        if M not in (8, 40) or set(recs) != set(shapes):
            continue
        sums[f"M={M} {r}"] = {
            k: sum(recs[s][k] * n for s, n in shapes.items())
            for k in ("ms", "call_ms", "library_ms", "bound_ms")}
        print(f"w8a16 step at M={M}, route {r}, summed over its "
              f"{sum(shapes.values())} launches: "
              + json.dumps(sums[f"M={M} {r}"]), flush=True)
    if "M=8 decode" not in sums:
        fail(f"w8a16: no decode-step sums: {sorted(per_route)}")
    step = sums["M=8 decode"]
    if step["ms"] >= step["library_ms"]:
        print(f"w8a16 MISS: the M=8 decode step's W8A16 sum {step['ms']} ms "
              f"is not below cuBLAS bf16's {step['library_ms']} ms",
              flush=True)
    main = {}
    for M, r in ((8, w8.DECODE), (512, w8.PREFILL)):
        rec = per_route[(M, r)][W8_MAIN]
        main[r] = dict({k: rec[k] for k in (
            "max_abs_err", "ms", "call_ms", "plain_ms", "library_ms",
            "library_call_ms", "bound_ms", "bound_by")},
            shape=f"M={M} K={W8_MAIN[0]} N={W8_MAIN[1]} bf16")
    big = main[w8.PREFILL]
    if big["ms"] >= big["plain_ms"]:
        print(f"w8a16 MISS: M=512 {W8_MAIN}: prefill route {big['ms']} ms "
              f"is not below the plain version's {big['plain_ms']} ms",
              flush=True)
    main["step_sums"] = sums
    main["host_us_per_call"] = host
    main["table"] = {
        f"{k} {r}": dict({f: v.get(f) for f in (
            "bound_ms", "plain_ms", "library_ms")}, **rv)
        for k, v in out.items() for r, rv in v.get("routes", {}).items()}
    return main


def engine_idle(base, what):
    """The engine's stats once nothing is queued or in flight: every
    dispatched segment harvested, so its launches and its decode steps
    are both counted."""
    deadline = time.perf_counter() + 60
    while True:
        _, st = http_json(base + "/v1/stats")
        p = st["pipeline"]
        if not p["inflight"] and not p["queued"] and not any(
                st["versions"]["active_rows"].values()):
            return st
        if time.perf_counter() > deadline:
            fail(f"{what}: the engine never went idle: {p}")
        time.sleep(0.02)


#: a decode step's W8A16 kernels in a profile: the decode route's kernel
#: at one n8 tile of rows (M <= 8: the decode steps of an 8-row batch) and
#: the combine kernel that sums its split-K partials (demangled or not)
W8_STEP_KERNELS = (re.compile(r"w8a16_decode_kernel(?:<1,|ILi1E)"),
                   re.compile(r"w8a16_combine_kernel(?:<1>|ILi1E)"))


def w8_profile_window(w8, llama_mod, base, reqs, seconds=1.0):
    """W8A16 op calls and device time per decode step on the serving
    engine in this process. Calls: a window of pure decode opens once
    every request holds a row and the engine has decoded 8 steps, and
    closes after at least ``seconds`` and two decode segments (32 steps
    each when nothing waits), or when the wave ends; each decode-segment
    dispatch that starts inside it records its steps and the op calls
    made inside it, all and on the decode route (the scheduler thread
    makes them), so calls per step is exact. Device time: the profiler
    runs over the whole wave, started before it (one started inside the
    window, while the scheduler thread launched, recorded no kernel on
    the card), and a decode step's W8A16 ms
    is the decode kernel's at M <= 8 plus the combine kernel that follows
    it (``W8_STEP_KERNELS``), over those calls, times the calls a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = {"open": False, "steps": 0, "launches": 0, "decode_launches": 0,
            "segments": 0}
    real = llama_mod.paged_decode_segment

    def counted(*a, **k):
        if not seen["open"]:
            return real(*a, **k)
        n0, d0 = w8.LAUNCHES["w8a16"], w8.LAUNCHES["w8a16_decode"]
        out = real(*a, **k)
        seen["launches"] += w8.LAUNCHES["w8a16"] - n0
        seen["decode_launches"] += w8.LAUNCHES["w8a16_decode"] - d0
        seen["steps"] += int(k["n_steps"])
        seen["segments"] += 1
        return out

    box = {}
    th = threading.Thread(target=lambda: box.setdefault(
        "res", post_all(base, reqs)), daemon=True)
    _, st0 = http_json(base + "/v1/stats")
    llama_mod.paged_decode_segment = counted
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        torch.cuda.synchronize()
        prof.start()
        th.start()
        deadline = time.perf_counter() + 300
        admitted = None  # decode steps when every request held a row
        while True:
            _, st1 = http_json(base + "/v1/stats")
            steps = st1["pipeline"]["decode_steps"]
            if admitted is None and not st1["pipeline"]["queued"] and sum(
                    st1["versions"]["active_rows"].values()) == len(reqs):
                admitted = steps
            # two harvests after the last admission: its prefill is past
            if admitted is not None and steps >= max(
                    admitted + 2, st0["pipeline"]["decode_steps"] + 8):
                break
            if time.perf_counter() > deadline:
                fail("w8a16 profile: the wave never reached decode")
            time.sleep(0.02)
        seen["open"] = True
        t_open = time.perf_counter()
        while th.is_alive() and (
                seen["segments"] < 2 or time.perf_counter() - t_open < seconds):
            time.sleep(0.02)
        seen["open"] = False
        window_s = time.perf_counter() - t_open
        _, st2 = http_json(base + "/v1/stats")
        th.join(timeout=600)
        torch.cuda.synchronize()
        prof.stop()
    finally:
        llama_mod.paged_decode_segment = real
    if not seen["steps"] or st2["pipeline"]["prefills"] != \
            st1["pipeline"]["prefills"]:
        fail(f"w8a16 profile: not a pure-decode window: {seen}, "
             f"{st2['pipeline']['prefills'] - st1['pipeline']['prefills']} "
             "prefill dispatches")
    step_ms = step_calls = 0
    cats, by_kernel, count_by_kernel = {}, {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        cat = "w8a16" if "w8a16" in e.key else _kernel_category(e.key)
        cats[cat] = cats.get(cat, 0.0) + us / 1e3
        if cat != "w8a16":
            continue
        kern = next((k for k in ("decode", "combine", "prefill", "f32")
                     if f"w8a16_{k}_kernel" in e.key), "other")
        by_kernel[kern] = by_kernel.get(kern, 0.0) + us / 1e3
        count_by_kernel[kern] = count_by_kernel.get(kern, 0) + e.count
        main, comb = (p.search(e.key) for p in W8_STEP_KERNELS)
        if main or comb:
            step_ms += us / 1e3
            step_calls += e.count if main else 0
    checked(box["res"][0], reqs[0]["max_tokens"], "w8a16 profiled wave")
    if not step_calls:
        fail(f"w8a16 profile: no decode-step kernel among {count_by_kernel} "
             f"({cats})")
    per_step = seen["launches"] / seen["steps"]
    return {"window_s": window_s, "segments": seen["segments"],
            "decode_steps": seen["steps"], "launches": seen["launches"],
            "decode_route_launches": seen["decode_launches"],
            "launches_per_decode_step": per_step,
            "decode_step_calls_profiled": step_calls,
            "ms_per_call": step_ms / step_calls,
            "device_ms_per_decode_step": step_ms / step_calls * per_step,
            "wave_w8a16_ms_by_kernel": by_kernel,
            "wave_w8a16_kernels_by_name": count_by_kernel,
            "wave_by_category_ms": cats}


def bf16_wave(server_mod, serve_cfg, reqs):
    """Phase 5's engine (bf16) on ``reqs``: ms a decode step, TTFT p50
    and the wall time, the responses checked."""
    with serving(server_mod, serve_cfg) as base:
        before = engine_idle(base, "bf16 engine")
        results, wall = post_all(base, reqs)
        st = engine_idle(base, "bf16 engine")
    checked(results, reqs[0]["max_tokens"], "bf16 engine")
    pipe, pipe0 = st["pipeline"], before["pipeline"]
    steps = pipe["decode_steps"] - pipe0["decode_steps"]
    return {"ms_per_decode_step": (pipe["decode_ms_sum"]
                                   - pipe0["decode_ms_sum"]) / steps,
            "ttft_ms_p50": st.get("ttft_ms_p50"), "wall_s": wall}


def run_int8_engine(pa, w8, server_mod, llama_mod, serve_cfg, summary):
    """Phase 17: serve_main with quantize int8 at Llama-3-8B full width
    and depth on phase 5's requests. Gates: every response; W8A16
    launches exactly 7 x 32 + 1 a decode step and a prefill dispatch,
    each decode step's on the decode route and prefill chunks on the
    prefill route; both paged kernels; finite logits; resident weight
    bytes exactly the int8 tree's, from the config. Prints the int8
    decode step and TTFT beside phase 5's bf16 ones and beside the bf16
    engine's on the same requests right before and right after it."""
    cfg8 = llama_mod.preset("llama3-8b")
    reqs = make_requests(cfg8.vocab_size)
    cfg = dict(serve_cfg, quantize="int8")
    per_step = w8_per_step(cfg8)
    # the bf16 engine on the same requests right before and after: the
    # host's speed drifts within a call, and both steps are host-bound
    bracket = [bf16_wave(server_mod, serve_cfg, reqs)]
    with serving(server_mod, cfg) as base:
        before = engine_idle(base, "int8 engine")
        reset_counts(pa)
        for k in w8.LAUNCHES:
            w8.LAUNCHES[k] = 0
        results, wall = post_all(base, reqs)
        st = engine_idle(base, "int8 engine")
        n_w8 = w8.LAUNCHES["w8a16"]
        by_route = {r: w8.LAUNCHES[f"w8a16_{r}"]
                    for r in (w8.DECODE, w8.PREFILL, w8.CUDA_CORE)}
        launches = dict(pa.LAUNCHES)
        rng = np.random.RandomState(17)
        short = [{"prompt_ids": rng.randint(0, cfg8.vocab_size,
                                            size=64).tolist(),
                  "max_tokens": 128, "temperature": 0.0} for _ in range(8)]
        prof = w8_profile_window(w8, llama_mod, base, short)
    bracket.append(bf16_wave(server_mod, serve_cfg, reqs))
    checked(results, 128, "int8 engine")
    pipe, pipe0 = st["pipeline"], before["pipeline"]
    steps = pipe["decode_steps"] - pipe0["decode_steps"]
    dispatches = pipe["prefills"] - pipe0["prefills"]
    if steps <= 0 or n_w8 != per_step * (steps + dispatches):
        fail(f"w8a16 launches {n_w8} != {per_step} x ({steps} decode steps "
             f"+ {dispatches} prefill dispatches)")
    if launches["fused"] < cfg8.n_layers * steps or launches["blocked"] <= 0:
        fail(f"int8 engine: paged launches {launches} for {steps} steps")
    if (by_route[w8.DECODE] < per_step * steps or by_route[w8.PREFILL] <= 0
            or by_route[w8.DECODE] + by_route[w8.PREFILL] != n_w8):
        fail(f"w8a16 routes {by_route} over {steps} decode steps: every "
             "step's calls on the decode route, prefill chunks on the "
             "prefill route")
    if prof["launches_per_decode_step"] != per_step:
        fail(f"w8a16 window: {prof['launches']} launches in "
             f"{prof['decode_steps']} decode steps, want {per_step} a step")
    if prof["decode_route_launches"] != prof["launches"]:
        fail(f"w8a16 window: decode steps left the decode route: {prof}")
    if st["nonfinite_logits"] != 0:
        fail(f"int8 engine: {st['nonfinite_logits']} non-finite logits")
    wb, bf16_wb = st["weights"]["bytes"], summary.get("bf16_weight_bytes")
    want = int8_weight_bytes(cfg8)
    if st["weights"]["quantize"] != "int8" or wb != want:
        fail(f"int8 engine weights {st['weights']}: want {want} bytes")
    dec_ms = pipe["decode_ms_sum"] - pipe0["decode_ms_sum"]
    rec = {"requests": len(reqs), "wall_s": wall, "decode_steps": steps,
           "prefill_dispatches": dispatches,
           "prefill_chunks": pipe["prefill_chunks"] - pipe0["prefill_chunks"],
           "w8a16_launches": n_w8,
           "w8a16_launches_by_route": by_route,
           "ms_per_decode_step": dec_ms / steps,
           "bf16_ms_per_decode_step": summary.get("bf16_ms_per_decode_step"),
           "int8_over_bf16_step": (dec_ms / steps
                                   / summary["bf16_ms_per_decode_step"]
                                   if summary.get("bf16_ms_per_decode_step")
                                   else None),
           "bf16_bracket": bracket,
           "int8_over_bf16_bracket": dec_ms / steps / statistics.mean(
               b["ms_per_decode_step"] for b in bracket),
           "decode_tokens_per_s": (pipe["decode_tokens"]
                                   - pipe0["decode_tokens"]) / (dec_ms / 1e3),
           "ttft_ms_p50": st.get("ttft_ms_p50"),
           "ttft_ms_p95": st.get("ttft_ms_p95"),
           "bf16_ttft_ms_p50": summary.get("bf16_ttft_ms_p50"),
           "weight_bytes": wb, "bf16_weight_bytes": bf16_wb,
           "weight_bytes_ratio": wb / bf16_wb if bf16_wb else None,
           "paged_launches": launches,
           "pipeline": {k: pipe.get(k) for k in PIPELINE_FIELDS},
           "w8a16_profile": prof}
    print("int8 engine (smoke run, not a benchmark): " + json.dumps(rec),
          flush=True)
    summary["w8a16_launches"] = n_w8
    summary["w8a16_route_launches"] = by_route
    summary["w8a16_window"] = prof
    summary.setdefault("paths", {})["int8"] = launches
    return reqs


def f32_2layer(llama_mod):
    name = "llama3-8b-2layer-f32"
    llama_mod.PRESETS.setdefault(name, dataclasses.replace(
        llama_mod.preset("llama3-8b"), n_layers=2, dtype=torch.float32))
    return name


def run_int8_identity(w8, server_mod, llama_mod, reqs, serve_cfg):
    """Phase 17's gate: Llama-3-8B width, 2 layers, float32, int8: the
    engine's greedy streams with the kernel equal the same engine's with
    the plain version forced."""
    name = f32_2layer(llama_mod)
    greedy = [dict(r, max_tokens=32) for r in reqs if r["temperature"] == 0.0]
    kw = dict(serve_cfg, preset=name, quantize="int8", prefix_cache_mb=0.0)
    n0 = w8.LAUNCHES["w8a16"]
    kern = [(o or {}).get("token_ids")
            for o in generate_all(server_mod, kw, greedy)]
    n1 = w8.LAUNCHES["w8a16"]
    with forced_plain_w8a16(w8):
        plain = [(o or {}).get("token_ids")
                 for o in generate_all(server_mod, kw, greedy)]
    if w8.LAUNCHES["w8a16"] != n1 or n1 == n0:
        fail(f"int8 identity: kernel launches {n1 - n0}, "
             f"{w8.LAUNCHES['w8a16'] - n1} under the plain version")
    if any(t is None or len(t) != 32 for t in kern) or kern != plain:
        fail(f"f32 2-layer int8: kernel and plain greedy streams differ: "
             f"{kern} vs {plain}")
    print(f"f32 2-layer llama3-8b width int8: kernel == plain on "
          f"{len(greedy)} greedy streams x 32 tokens", flush=True)


def run_checkpoint_swap(server_mod, llama_mod, ck, summary):
    """Phase 18: Llama-3-8B width cut to 4 layers, bf16: the port's
    save_checkpoint writes two seeds' params; serve_main with
    KUBEDL_MODEL_PATH restores the first (gated: every tensor and one
    prompt's logits equal the in-memory ones), /admin/load_version loads
    the second beside it, requests name each, /admin/activate_version
    and /admin/retire_version run with rows in flight (gated: the rows
    finish, the retired tree is evicted and its memory freed)."""
    import shutil

    name = "llama3-8b-4layer"
    llama_mod.PRESETS.setdefault(name, dataclasses.replace(
        llama_mod.preset("llama3-8b"), n_layers=4))
    cfg = llama_mod.preset(name)
    root = tempfile.mkdtemp(prefix="kdl-smoke-ckpt-")
    out = {}
    try:
        params = {}
        for v, seed in (("base", 0), ("v2", 1)):
            p = llama_mod.llama_init(
                cfg, torch.Generator(device=DEV).manual_seed(seed), DEV)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save_checkpoint(os.path.join(root, v), {"params": p}, 1)
            out[f"save_s_{v}"] = time.perf_counter() - t0
            params[v] = p
        out["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(dp, f))
            for dp, _, fs in os.walk(os.path.join(root, "base")) for f in fs)
        out["fingerprint_base"] = ck.checkpoint_fingerprint(
            os.path.join(root, "base"))
        out["fingerprint_v2"] = ck.checkpoint_fingerprint(
            os.path.join(root, "v2"))
        engines = []
        real = server_mod.LlamaEngine

        class Recorded(real):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                engines.append(self)

        serve_cfg = {"preset": name, "max_batch": 8, "max_seq": 2048,
                     "kv_block_size": 16, "kv_attention": "blocked",
                     "prefill_chunk_tokens": 512, "prefix_cache_mb": 0.0}
        server_mod.LlamaEngine = Recorded
        t0 = time.perf_counter()
        try:
            cm = serving(server_mod, serve_cfg,
                         env={"KUBEDL_MODEL_PATH": os.path.join(root, "base")})
            base = cm.__enter__()
        finally:
            server_mod.LlamaEngine = real
        try:
            out["restore_and_start_s"] = time.perf_counter() - t0
            eng = engines[0]
            for (k1, a), (k2, b) in zip(ck._leaf_items(eng.params),
                                        ck._leaf_items(params["base"])):
                if k1 != k2 or not torch.equal(a, b):
                    fail(f"restored leaf {k1} differs from the saved {k2}")
            toks = torch.tensor(make_requests(cfg.vocab_size, seed=18)[0]
                                ["prompt_ids"][:256], device=DEV,
                                dtype=torch.int32)[None]
            lens = torch.tensor([toks.shape[1]], device=DEV,
                                dtype=torch.int32)

            def logits(p):
                c = llama_mod.init_paged_cache(cfg, 1, 256, 17, 16, DEV)
                c["bt"] = torch.arange(1, 17, dtype=torch.int32,
                                       device=DEV)[None]
                return llama_mod.paged_prefill_batched(p, c, toks, lens,
                                                       cfg)[0]

            with torch.no_grad():
                same = torch.equal(logits(eng.params), logits(params["base"]))
            if not same:
                fail("restored engine's logits differ from in-memory params'")
            del params
            _free()
            rng = np.random.RandomState(18)
            reqs = [{"prompt_ids": rng.randint(0, cfg.vocab_size,
                                               size=int(n)).tolist(),
                     "max_tokens": 48, "temperature": 0.0}
                    for n in rng.randint(64, 257, size=8)]
            t0 = time.perf_counter()
            code, inv = http_json(base + "/admin/load_version", {
                "version": "v2", "ckpt_dir": os.path.join(root, "v2")})
            out["load_version_s"] = time.perf_counter() - t0
            if code != 200 or inv["loaded"] != ["base", "v2"]:
                fail(f"load_version: {code} {inv}")
            mem_two = torch.cuda.memory_allocated()
            import weakref

            base_leaves = []
            llama_mod.map_leaves(
                lambda a: base_leaves.append(weakref.ref(a)) or a,
                eng._versions["base"])
            named = [dict(r, model_version=("base", "v2")[j % 2])
                     for j, r in enumerate(reqs)]
            res = checked(post_all(base, named)[0], 48, "two versions")
            out["versions_served"] = sorted({r["model_version"]
                                             for r in res})
            # rows of base in flight while base is fenced and evicted
            box = {}
            th = threading.Thread(target=lambda: box.setdefault(
                "res", post_all(base, [dict(r, model_version="base",
                                            max_tokens=96)
                                       for r in reqs[:4]])))
            th.start()
            deadline = time.perf_counter() + 120
            while not http_json(base + "/v1/stats")[1]["versions"][
                    "active_rows"].get("base"):
                if time.perf_counter() > deadline:
                    fail("retire: no base row ever went in flight")
                time.sleep(0.02)
            code, a = http_json(base + "/admin/activate_version",
                                {"version": "v2"})
            code2, r = http_json(base + "/admin/retire_version",
                                 {"version": "base"})
            out["in_flight_at_retire"] = r["active_rows"]
            if code != 200 or code2 != 200 or r["retiring"] != ["base"]:
                fail(f"activate/retire: {code} {a} / {code2} {r}")
            th.join(timeout=600)
            checked(box["res"][0], 96, "rows in flight across retire")
            deadline = time.perf_counter() + 60
            while http_json(base + "/v1/stats")[1]["versions"][
                    "loaded"] != ["v2"]:
                if time.perf_counter() > deadline:
                    fail("the retired version was never evicted")
                time.sleep(0.05)
            gc.collect()
            out["freed_bytes"] = mem_two - torch.cuda.memory_allocated()
            out["tree_bytes"] = cfg.num_params() * 2
            alive = sum(r() is not None for r in base_leaves)
            if alive:
                fail(f"retired tree not freed: {alive} of "
                     f"{len(base_leaves)} leaves still referenced")
            code, res = http_json(base + "/v1/generate", reqs[5])
            if code != 200 or res["model_version"] != "v2":
                fail(f"after the swap: {code} {res}")
        finally:
            cm.__exit__(None, None, None)
            os.environ.pop("KUBEDL_MODEL_PATH", None)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("checkpoint and hot swap (smoke run): " + json.dumps(out),
          flush=True)


def run_versions_identity(server_mod, llama_mod, ck):
    """Phase 18's gate: Llama-3-8B width, 2 layers, float32: an engine
    serving its init as "base" and a checkpoint (another seed) loaded as
    "v2" gives each version's greedy streams IDENTICAL to single-version
    engines on the same weights, with requests of both versions
    interleaved, then across activate / retire."""
    import shutil

    name = f32_2layer(llama_mod)
    cfg = llama_mod.preset(name)
    kw = dict(preset=name, max_batch=8, max_seq=2048, kv_block_size=16,
              kv_attention="blocked", prefill_chunk_tokens=512,
              prefix_cache_mb=0.0)
    reqs = [dict(r, max_tokens=32) for r in spec_requests(cfg.vocab_size,
                                                          seed=19)]
    root = tempfile.mkdtemp(prefix="kdl-smoke-ckpt-")
    try:
        p = llama_mod.llama_init(
            cfg, torch.Generator(device=DEV).manual_seed(1), DEV)
        ck.save_checkpoint(root, {"params": p}, 1)
        del p
        _free()
        want = {}
        for v, extra in (("base", {}), ("v2", {"ckpt_dir": root})):
            eng = server_mod.LlamaEngine(**kw, **extra)
            try:
                want[v] = [o["token_ids"]
                           for o in generate_concurrent(eng, reqs)]
            finally:
                eng.close()
            del eng
            _free()
        def wave(eng, names):
            """Each request twice at once, the copies naming ``names``;
            returns each name's streams and the engine's pipeline."""
            outs = [None] * (2 * len(reqs))

            def one(j):
                r = reqs[j // 2]
                outs[j] = eng.generate(r["prompt_ids"], r["max_tokens"],
                                       model_version=names[j % 2])

            ths = [threading.Thread(target=one, args=(j,))
                   for j in range(len(outs))]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600)
            return ([[outs[2 * i + k]["token_ids"] for i in range(len(reqs))]
                     for k in range(2)], eng.pipeline_stats())

        # the same load on one version: the pipeline's reading without
        # the version round-robin
        eng = server_mod.LlamaEngine(**kw)
        try:
            one_got, one_pipe = wave(eng, ("base", "base"))
        finally:
            eng.close()
        del eng
        _free()
        if one_got != [want["base"]] * 2:
            fail(f"f32 2-layer: one version at twice the load differs: "
                 f"{one_got} vs {want['base']}")
        eng = server_mod.LlamaEngine(**kw)
        try:
            eng.load_version("v2", root)
            streams, two_pipe = wave(eng, ("base", "v2"))
            got = dict(zip(("base", "v2"), streams))
            eng.activate_version("v2")
            eng.retire_version("base")
            after = [o["token_ids"] for o in generate_concurrent(eng, reqs)]
            loaded = eng.versions()["loaded"]
            pipe = eng.pipeline_stats()
        finally:
            eng.close()
        del eng
        _free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if got != want or after != want["v2"] or loaded != ["v2"]:
        fail(f"f32 2-layer versions differ from single-version engines: "
             f"{got} vs {want}; after swap {after}; loaded {loaded}")
    print("f32 2-layer llama3-8b width: two co-resident versions == "
          f"single-version engines on {len(reqs)} x 2 greedy streams x 32 "
          "tokens, and after activate/retire; pipeline " + json.dumps(
              {k: pipe.get(k) for k in PIPELINE_FIELDS}), flush=True)
    print("pipeline at 16 requests into 8 rows, one version against two: "
          + json.dumps({name: {k: p.get(k) for k in PIPELINE_FIELDS}
                        for name, p in (("one_version", one_pipe),
                                        ("two_versions", two_pipe))}),
          flush=True)


def _post_bytes(url, data, ctype, timeout=1200.0):
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def run_disagg_pair(server_mod, llama_mod, reqs, serve_cfg, colocated):
    """Phase 19: two serve_main replicas on the card, role prefill and
    role decode, Llama-3-8B full depth bf16 (prefix cache off); phase
    5's greedy requests go /v1/prefill -> KVH1 bytes -> /v1/adopt.
    Gates: every response, handoffs_out == handoffs_in, each pool's free
    blocks back where they began. Prints handoff ms and bytes, and bf16
    agreement with phase 5's colocated streams (not gated)."""
    greedy = [r for r in reqs if r["temperature"] == 0.0]
    cfg = dict(serve_cfg, prefix_cache_mb=0.0)
    legs = [None] * len(greedy)
    with serving(server_mod, dict(cfg, role="prefill")) as pre, \
            serving(server_mod, dict(cfg, role="decode")) as dec:
        free0 = [http_json(b + "/v1/stats")[1]["kv_blocks"]["free"]
                 for b in (pre, dec)]

        def one(j):
            t0 = time.perf_counter()
            code, blob = _post_bytes(pre + "/v1/prefill",
                                     json.dumps(greedy[j]).encode(),
                                     "application/json")
            t1 = time.perf_counter()
            code2, body = _post_bytes(dec + "/v1/adopt", blob,
                                      "application/octet-stream")
            legs[j] = {"prefill_ms": (t1 - t0) * 1e3,
                       "adopt_ms": (time.perf_counter() - t1) * 1e3,
                       "bytes": len(blob), "codes": [code, code2],
                       "result": json.loads(body)}

        ths = [threading.Thread(target=one, args=(j,))
               for j in range(len(greedy))]
        t0 = time.perf_counter()
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=1500)
        wall = time.perf_counter() - t0
        sts = [http_json(b + "/v1/stats")[1] for b in (pre, dec)]
    for j, leg in enumerate(legs):
        if leg is None or leg["codes"] != [200, 200] or \
                len(leg["result"].get("token_ids", [])) != 128:
            fail(f"disagg request {j}: {str(leg)[:300]}")
    if sts[0]["handoffs_out"] != sts[1]["handoffs_in"] or \
            sts[0]["handoffs_out"] != len(greedy):
        fail(f"handoffs out {sts[0]['handoffs_out']} in "
             f"{sts[1]['handoffs_in']} for {len(greedy)} requests")
    free1 = [st["kv_blocks"]["free"] for st in sts]
    if free1 != free0:
        fail(f"KV blocks not conserved: free {free0} -> {free1}")
    streams = [leg["result"]["token_ids"] for leg in legs]
    same = sum(a == b for x, y in zip(streams, colocated or [])
               for a, b in zip(x, y))
    rec = {"requests": len(greedy), "wall_s": wall,
           "prompt_lens": [len(r["prompt_ids"]) for r in greedy],
           "handoff_bytes": [leg["bytes"] for leg in legs],
           "bytes_per_token": [leg["bytes"] / len(r["prompt_ids"])
                               for leg, r in zip(legs, greedy)],
           "prefill_leg_ms": [leg["prefill_ms"] for leg in legs],
           "adopt_leg_ms": [leg["adopt_ms"] for leg in legs],
           "ttft_ms": [leg["result"].get("ttft_ms") for leg in legs],
           "handoffs": [sts[0]["handoffs_out"], sts[1]["handoffs_in"]],
           "failures": [st["handoff_failures"] for st in sts],
           "free_blocks": free0,
           "greedy_tokens_equal_colocated": [same, 128 * len(greedy)]
           if colocated else None}
    print("disaggregated pair (smoke run, not a benchmark): "
          + json.dumps(rec), flush=True)


def run_disagg_identity(server_mod, llama_mod, reqs):
    """Phase 19's gate: Llama-3-8B width, 2 layers, float32: greedy
    streams through a prefill -> decode engine pair (the KVH1 bytes in
    between) IDENTICAL to the colocated engine's."""
    from kubedl_tpu_torch.serving.disagg import DisaggCoordinator

    name = f32_2layer(llama_mod)
    kw = dict(preset=name, max_batch=8, max_seq=2048, kv_block_size=16,
              kv_attention="blocked", prefill_chunk_tokens=512,
              prefix_cache_mb=0.0)
    greedy = [dict(r, max_tokens=32) for r in reqs if r["temperature"] == 0.0]
    colo = [o["token_ids"] for o in generate_all(server_mod, kw, greedy)]
    pre = server_mod.LlamaEngine(**kw, role="prefill")
    dec = server_mod.LlamaEngine(**kw, role="decode")
    try:
        co = DisaggCoordinator(pre, dec)
        outs = [None] * len(greedy)

        def one(j):
            outs[j] = co.generate(greedy[j]["prompt_ids"], max_tokens=32)

        ths = [threading.Thread(target=one, args=(j,))
               for j in range(len(greedy))]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=600)
        st = (pre.stats(), dec.stats())
    finally:
        pre.close()
        dec.close()
    del pre, dec
    _free()
    got = [(o or {}).get("token_ids") for o in outs]
    if got != colo:
        fail(f"f32 2-layer disaggregated streams differ from colocated: "
             f"{got} vs {colo}")
    print(f"f32 2-layer llama3-8b width: disaggregated == colocated on "
          f"{len(greedy)} greedy streams x 32 tokens (handoffs "
          f"{st[0]['handoffs_out']} -> {st[1]['handoffs_in']})", flush=True)


# ---- main -------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-engine", action="store_true",
                    help="skip the serving engine (phases 5, 6, 13-15, "
                    "17-19, 22)")
    ap.add_argument("--skip-train", action="store_true",
                    help="skip the training phases (8 to 12, 21, 23-25)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubedl_tpu_torch.models import llama as llama_mod
    from kubedl_tpu_torch.models import moe as moe_mod
    from kubedl_tpu_torch.models import paged_attention as pa
    from kubedl_tpu_torch.ops import adamw
    from kubedl_tpu_torch.ops import build
    from kubedl_tpu_torch.ops import flash_attention as fa
    from kubedl_tpu_torch.ops import w8a16 as w8
    from kubedl_tpu_torch.serving import server as server_mod
    from kubedl_tpu_torch.training import checkpoint as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    # a fresh build even where one exists: phase 2 reads ptxas's report
    build.build_all(verbose=True, force=True)
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({json.dumps(build.BUILD_SECONDS)})", flush=True)
    print("tensor-core kernels (ptxas -v, cuobjdump -sass): "
          + json.dumps(tc_kernel_report(build)), flush=True)
    print("tensor-core decode kernels (ptxas -v, cuobjdump -sass): "
          + json.dumps(mma_kernel_report(build)), flush=True)
    print("w8a16 kernels (ptxas -v, cuobjdump -sass): "
          + json.dumps(w8_kernel_report(build)), flush=True)
    print("adamw kernels (ptxas -v): "
          + json.dumps(adamw_kernel_report(build)), flush=True)

    kernels = {}
    for name, shape, suffix in (("llama", LLAMA, ""),
                                ("gemma", GEMMA, "_hd256")):
        # Gemma-2B (group 8): S=8 is the tensor-core route's smallest R
        sizes = (1, 64, 512) if name == "llama" else (1, 8, 64, 512)
        subs = {}
        for S in sizes:
            rec = check_blocked(pa, shape, S, torch.bfloat16, timed=True)
            print(f"blocked {name} S={S} bf16: " + json.dumps(rec), flush=True)
            subs[S] = rec
        kernels["paged_attention_blocked" + suffix] = subs[512]
        if name == "gemma":
            for S in (8, 64):
                subs[512][f"s{S}"] = {k: subs[S][k] for k in TIMED_KEYS}
        rec = check_fused(pa, shape, torch.bfloat16, timed=True)
        print(f"fused {name} bf16: " + json.dumps(rec), flush=True)
        kernels["paged_attention_fused" + suffix] = rec
    rec = check_fused(pa, LONG, torch.bfloat16, timed=True,
                      start_list=LONG_STARTS)
    print("fused llama long-context MB=512 bf16: " + json.dumps(rec),
          flush=True)
    rec = check_fused(pa, GEMMA_LONG, torch.bfloat16, timed=True,
                      start_list=LONG_STARTS)
    print("fused gemma long-context MB=512 bf16: " + json.dumps(rec),
          flush=True)
    kernels["paged_attention_fused_hd256"]["long_8k"] = {
        k: rec[k] for k in TIMED_KEYS}
    small = dict(LLAMA, hd=64)
    for shape, S in ((LLAMA, 64), (GEMMA, 64), (small, 8)):
        rec = check_blocked(pa, shape, S, torch.float32, timed=False)
        print(f"blocked hd={shape['hd']} S={S} f32: " + json.dumps(rec),
              flush=True)
    for shape in (LLAMA, GEMMA, small):
        rec = check_fused(pa, shape, torch.float32, timed=False)
        print(f"fused hd={shape['hd']} f32: " + json.dumps(rec), flush=True)
    rec = check_blocked(pa, small, 64, torch.bfloat16, timed=False)
    print("blocked hd=64 S=64 bf16: " + json.dumps(rec), flush=True)
    # speculative verify's shapes (S = k+1): the split-K route at 1 < S < 16
    for dtype in (torch.bfloat16, torch.float32):
        for S in (2, 5, 8):
            timed = S == 5 and dtype == torch.bfloat16
            rec = check_blocked(pa, LLAMA, S, dtype, timed=timed,
                                start_list=VERIFY_STARTS)
            print(f"blocked verify llama S={S} {dtype}: " + json.dumps(rec),
                  flush=True)
            if timed:
                kernels["paged_attention_blocked"]["verify_s5"] = {
                    k: rec[k] for k in TIMED_KEYS}
    # and at Gemma-2B's widths (R = 40: the tensor-core decode in bf16,
    # split-K in float32)
    rec = check_blocked(pa, GEMMA, 5, torch.bfloat16, timed=True,
                        start_list=VERIFY_STARTS)
    print("blocked verify gemma S=5 bf16: " + json.dumps(rec), flush=True)
    kernels["paged_attention_blocked_hd256"]["verify_s5"] = {
        k: rec[k] for k in TIMED_KEYS}
    rec = check_blocked(pa, GEMMA, 5, torch.float32, timed=False,
                        start_list=VERIFY_STARTS)
    print("blocked verify gemma S=5 f32: " + json.dumps(rec), flush=True)
    rec = check_blocked(pa, small, 5, torch.bfloat16, timed=False,
                        start_list=VERIFY_STARTS)
    print("blocked verify hd=64 S=5 bf16: " + json.dumps(rec), flush=True)

    launches = {"blocked": None, "fused": None}
    summary = {"launches": launches}
    def stamp(label):
        print(f"[{time.perf_counter() - t0:.1f} s since the build began] "
              f"{label} done", flush=True)

    stamp("phases 2-4")
    with torch.no_grad():
        kernels["w8a16_matmul"] = run_w8a16_kernels(w8, llama_mod)
    stamp("phase 16")
    launches = {"blocked": None, "fused": None}
    summary = {"launches": launches}
    if not args.skip_engine:
        blocked_tokens, reqs, serve_cfg = run_engine(
            pa, server_mod, llama_mod, summary)
        launches = summary["launches"]
        run_gather(server_mod, reqs, serve_cfg, blocked_tokens)
        run_f32_parity(server_mod, llama_mod, reqs, serve_cfg)
        stamp("phase 5")
        run_profile(server_mod, reqs, serve_cfg)
        stamp("phase 6")
        run_gemma_engine(pa, server_mod, llama_mod, summary)
        run_gemma_prefill_gate(pa, llama_mod)
        run_gemma_f32_identity(pa, server_mod, llama_mod)
        stamp("phase 22")
        run_shared_prefix(pa, server_mod, llama_mod, summary)
        stamp("phase 13")
        run_speculative(pa, server_mod, llama_mod, serve_cfg, summary)
        stamp("phase 14")
        run_f32_identity(server_mod, llama_mod)
        stamp("phase 15")
        with torch.no_grad():
            run_int8_engine(pa, w8, server_mod, llama_mod, serve_cfg, summary)
            run_int8_identity(w8, server_mod, llama_mod, reqs, serve_cfg)
            stamp("phase 17")
            run_checkpoint_swap(server_mod, llama_mod, ck, summary)
            run_versions_identity(server_mod, llama_mod, ck)
            stamp("phase 18")
            run_disagg_pair(server_mod, llama_mod, reqs, serve_cfg,
                            blocked_tokens)
            run_disagg_identity(server_mod, llama_mod, reqs)
            stamp("phase 19")

    kernels.update(run_flash_kernels(fa))
    run_flash_long(fa, kernels)
    run_flash_gemma_long(fa, kernels)
    stamp("phase 7")
    with torch.no_grad():
        kernels["adamw_update"] = run_adamw_kernels(adamw, llama_mod)
    stamp("phase 20")
    launches.update({name: None for name in FLASH_REPLACES})
    opt_launches = {}
    gemma_train, gemma_launches = {}, {}
    gemma_long, gemma_long_launches = {}, {}
    moe_launches = {}
    if not args.skip_train:
        gemma_launches, gemma_train = run_gemma_train(fa, llama_mod)
        stamp("phase 23")
        gemma_long_launches, gemma_long = run_gemma_long_train(fa, llama_mod)
        stamp("phase 24")
        moe_launches, _ = run_moe_phase(fa, moe_mod)
        stamp("phase 25")
        flash_launches, opt_launches = run_train_entry(fa, llama_mod)
        launches.update(flash_launches)
        run_overfit_and_split(fa, llama_mod)
        stamp("phase 8")
        run_train_f32_parity(fa, llama_mod)
        stamp("phases 9-10")
        # the split pair's main path: the long-context training run
        launches.update(run_long_context_train(fa, llama_mod))
        stamp("phase 11")
        for preset, seq_len in BF16_ROUTE_GATES:
            run_train_bf16_routes(fa, llama_mod, preset, seq_len)
        stamp("phase 12")
        run_lifecycle(fa, adamw, pa, ck, llama_mod, server_mod)
        run_lifecycle_identity(fa, ck, llama_mod)
        stamp("phase 21")

    def record(name, source, replaces, n, rec, design):
        lib = rec["library_ms"]
        # the split pair is held against one SDPA backward as a pair
        ms = rec.get("pair_ms", rec["ms"])
        out = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": lib,
            "design": design,
            "ms_over_library": ms / lib if lib else None,
            # one call with the host's queueing in it
            "call_ms": rec["call_ms"], "library_call_ms": rec["library_call_ms"],
        }
        for key in ("shape", "pair_ms", "fused_ms", "s2048", "verify_s5",
                    "s8", "s64", "long_8k"):
            if key in rec:
                out[key] = rec[key]
        return out

    # each paged entry's design is the route its timed case took; the
    # Llama-3-8B entries count phase 5's launches, the hd-256 ones (Gemma-2B,
    # timed at phase 3's GEMMA shape) phase 22's
    gemma = summary.get("paths", {}).get("gemma", {})
    line = []
    for name in ("paged_attention_blocked", "paged_attention_fused"):
        for suffix, counts in (("", launches), ("_hd256", gemma)):
            route = kernels[name + suffix]["route"]
            rec = record(name + suffix,
                         "kubedl_tpu_torch/csrc/paged_attention.cu",
                         REPLACES[name], counts.get(name.rsplit("_", 1)[1]),
                         kernels[name + suffix], PAGED_DESIGNS.get(route, route))
            rec["shape"] = "gemma-2b" if suffix else "llama3-8b"
            if suffix:  # device ms a launch in phase 22's profiled wave
                rec["in_model_ms"] = summary.get("gemma_in_model", {}).get(
                    name.rsplit("_", 1)[1])
            line.append(rec)
    for rec in line:  # this slice's serving paths, each counted alone
        entry = rec["name"].split("_")[2]
        rec["launches_by_path"] = {
            path: counts[entry]
            for path, counts in summary.get("paths", {}).items()}
    # the W8A16 routes: decode (mma.sync on the swapped product, split-K
    # with its combine kernel) timed at M=8, prefill (wgmma, A from
    # registers) at M=512; launches per route from phase 17's main path
    w8k = kernels["w8a16_matmul"]
    by_route = summary.get("w8a16_route_launches") or {}
    window = summary.get("w8a16_window") or {}
    for route, design in (
            ("decode", "decode route: mma.sync m16n8k16 on y^T = W^T h^T, "
             "split-K over a cp.async ring + combine kernel"),
            ("prefill", "prefill route: wgmma m64n128k16, A (dequantized "
             "W^T) from registers, h by TMA")):
        rec = record(f"w8a16_matmul_{route}",
                     "kubedl_tpu_torch/csrc/w8a16.cu", W8_REPLACES,
                     by_route.get(route), w8k[route], design)
        rec["step_sums"] = w8k["step_sums"]
        rec["host_us_per_call"] = w8k["host_us_per_call"]
        if route == "decode":
            # phase 17's pure-decode window, beside what the model implies
            rec["launches_per_decode_step"] = window.get(
                "launches_per_decode_step")
            rec["device_ms_per_decode_step"] = window.get(
                "device_ms_per_decode_step")
            rec["expected_launches_per_decode_step"] = w8_per_step(
                llama_mod.preset("llama3-8b"))
            rec["table"] = w8k["table"]
        line.append(rec)
    # the optimizer update: its three kernels as one operator, launches
    # from phase 8's main path, timed on Llama-3.2-1B's leaves (phase 20)
    rec = record("adamw_update", "kubedl_tpu_torch/csrc/adamw.cu",
                 ADAMW_REPLACES, sum(opt_launches.values()) or None,
                 kernels["adamw_update"],
                 "a float32 norm slot a CTA + a one-CTA finish, then one "
                 "16-byte-vector update launch a leaf, in place")
    rec["launches_by_kernel"] = opt_launches
    line.append(rec)
    main_case = FLASH_CASES[0]  # the timed shape: llama3-1b training
    for name in FLASH_REPLACES:
        tc = fa.tensor_core_route(name, main_case[6], main_case[5])
        rec = record(name, "kubedl_tpu_torch/csrc/flash_attention.cu",
                     FLASH_REPLACES[name], launches[name], kernels[name],
                     "tensor_core" if tc else "cuda_core")
        if name in MOE_TRAIN_OPS:  # hd 64 also runs phase 25's path
            rec["launches_by_path"] = {"llama3-1b": launches[name],
                                       "bench-moe": moe_launches.get(name)}
        line.append(rec)
    # Gemma-2B's training paths (hd 256): the forward and the fused
    # backward timed at phase 7's Gemma-2B case, launches from phase 23's
    # main path, device ms a launch from its profiled step; the split pair
    # timed at phase 7's 8192-token case (its S=2048 times under "s2048"),
    # launches and device ms a launch from phase 24's
    for name, counts, path in (
            [(n, gemma_launches, gemma_train) for n in GEMMA_TRAIN_OPS]
            + [(n, gemma_long_launches, gemma_long) for n in PAIR]):
        rec = record(name + "_hd256",
                     "kubedl_tpu_torch/csrc/flash_attention.cu",
                     FLASH_REPLACES[name], counts.get(name),
                     kernels[name + "_hd256"], kernels[name + "_hd256"]["route"])
        rec["in_model_ms"] = path.get("in_model_ms", {}).get(name)
        line.append(rec)
    print(f"card: {smi}", flush=True)
    print(f"whole run: {time.perf_counter() - t_start:.1f} s "
          f"({time.perf_counter() - t0:.1f} s since the build began)",
          flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
