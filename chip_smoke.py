"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card
    python3 chip_smoke.py --skip-engine  # without phases 5 and 6
    python3 chip_smoke.py --skip-train   # without phases 8 to 12

Phases (any failure exits non-zero before the final line):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA.
2. build: compiles the port's CUDA sources (kubedl_tpu_torch/csrc) with
   nvcc for sm_90a (``-Xptxas -v``), one nvcc per source started
   together, and prints the build seconds; then, for each tensor-core
   kernel (flash forward, fused backward, the split pair, paged
   prefill), its registers and spill bytes (ptxas) and its count of
   HGMMA instructions (``cuobjdump -sass``), failing if one has none or
   if a split-pair kernel spills.
3. blocked entry vs its plain PyTorch version at the serving shapes
   (Llama-3-8B: B=8, KV=8, group 4, hd 128, BS 16, MB 128; Gemma-2B:
   hd 256, KV 1, group 8) for S in {1, 64, 512}, ragged starts, block
   boundaries and an all-trash row, bf16 and f32, each case's route
   printed (``paged_route``: split-K, tensor cores or CUDA cores); kernel,
   plain and library (SDPA over the gathered view) times (see
   ``time_ms``: "ms" is the call's device time with the host's queueing
   hidden, "call_ms" one call with the queueing in it).
4. fused decode entry (S=1, KV write fused, split-K) vs plain scatter +
   plain attention: pools bitwise equal outside the trash block, outputs
   within tolerance; the first call runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (the decode path must not
   sync); a long-context case (MB=512, 8192 positions) where most splits
   of the short rows are empty; the same timings.
5. the engine: ``serve_main`` serving Llama-3-8B (full width and depth,
   seeded random weights) on 127.0.0.1, 8 concurrent /v1/generate
   requests (6 greedy, 2 at temperature 0.8, prompts of 64-1536 tokens,
   128 new tokens each); gates on every response, on both kernels'
   launch counts during that run and on finite logits; then the same
   requests on a kv_attention="gather" engine, whose greedy-token
   agreement with the blocked run is printed (not gated: bf16 logits of
   random weights have near-ties); then Llama-3-8B width cut to 2 layers
   in float32, where the blocked and gather engines' greedy streams must
   be identical (gated: f32 leaves no near-ties at these logit gaps).
6. profile: the blocked Llama-3-8B engine again, 32 new tokens per
   request, under torch.profiler: device time and kernel count by
   category (paged attention by entry point and the split-K merge,
   matmul, other) and the device's busy share of the wall time.
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
   dv, so it is held against the pair's dq + dk/dv + group sum). Then the
   split pair at the long-context training shape (B=1, H=32, KV=8,
   S=32768, hd 64, bf16, causal, RoPE), where ``bwd_route`` is "split":
   against the plain versions run head by head (one q-head with its
   kv-head a call: one float32 score tensor of all 32 heads would be
   137 GB) and against the tensor-core fused kernel, with the same
   timings; and a head slice (H=4, KV=1, S=16384) through
   ``flash_backward`` with the split route forced, against the plain
   versions run whole.
8. training: ``train_main`` with KUBEDL_TRAIN_CONFIG={"model":
   "llama3-1b", "global_batch": 4, "seq_len": 2048, "steps": 8} on the
   card, full width and depth, seeded random weights; gates on finite
   losses and grad norms, attn_impl "flash", no sanity violations and 16
   flash_fwd + 16 flash_bwd_fused launches per step. Then Trainer.fit on
   one repeated batch must end below its first loss; then two steps with
   the backward forced to the split pair (16 + 16 launches per step).
9. f32 parity: llama3-1b width cut to 2 layers in float32 (TF32 off), one
   train step on the fused and split kernel routes against the dense
   route: losses within 1e-5 relative, gradients and updated params
   within the tolerances stated in ``run_train_f32_parity``.
10. profile: two llama3-1b train steps under torch.profiler: device time
   by category (flash fwd, flash bwd, the flash RoPE pre-pass, matmul,
   other) and the busy share.
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
12. bf16 gate: llama3-1b width cut to 2 layers, bf16, B=1, S=32768: the
   loss and every gradient leaf of one train step on the split route (the
   route at this length) against the same step with the fused route
   forced, within the tolerances stated in ``run_train_bf16_routes``.

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
import socket
import statistics
import subprocess
import sys
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

REPLACES = {
    "paged_attention_blocked":
        "kubedl_tpu/models/paged_attention.py:181 _blocked_kernel",
    "paged_attention_fused":
        "kubedl_tpu/models/paged_attention.py:290 _fused_kernel",
}


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


def check_blocked(pa, shape, S, dtype, timed: bool):
    q, kp, vp, bt, starts, _, _ = make_case(shape, S, dtype, seed=S + 11)
    route = route_of(pa, shape, S, dtype)
    before = pa.ROUTE_LAUNCHES[route]
    out = pa.paged_attention(q, kp, vp, bt, starts)
    torch.cuda.synchronize()
    ref = pa.plain_paged_attention(q, kp, vp, bt, starts)
    err = (out.float() - ref.float()).abs().max().item()
    if not math.isfinite(err) or err > TOL[dtype]:
        fail(f"blocked kernel {shape} S={S} {dtype}: max abs err {err} "
             f"> {TOL[dtype]}")
    if pa.ROUTE_LAUNCHES[route] != before + 1:
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
        rec["bound_ms"], rec["bound_by"] = bound(shape, S, dtype)
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
    if pa.ROUTE_LAUNCHES[route] != before + 1:
        fail(f"fused {shape} {dtype} did not take route {route}")
    if kk2.data_ptr() != kk.data_ptr():
        fail("fused kernel did not update the pools in place")
    kr, vr = kp.clone(), vp.clone()
    pa.plain_fused_write(kr, vr, bt, starts, nk, nv)
    # trash block 0 takes colliding garbage writes by contract
    if not (torch.equal(kk[1:], kr[1:]) and torch.equal(vk[1:], vr[1:])):
        fail(f"fused kernel pools differ from a scatter {shape} {dtype}")
    ref = pa.plain_paged_attention(q, kr, vr, bt, starts)
    own = [b for b in range(shape["B"]) if b != TRASH_ROW]
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
#: the split pair's tensor-core kernels, which must not spill
NO_SPILL = ("flash_bwd_tc_kernel<64, false>", "flash_bwd_tc_kernel<128, false>",
            "flash_bwd_dq_tc_kernel<64>", "flash_bwd_dq_tc_kernel<128>")


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
    a split-pair kernel and spills."""
    rep = {}
    for src in sorted({src for src, _ in TC_KERNELS.values()}):
        rep.update(_tc_source_report(build, src))
    want = {f"{k}<{hd}{flag}>" for k, (_, flags) in TC_KERNELS.items()
            for flag in flags for hd in (64, 128)}
    if not want <= set(rep) or any(rep[k].get("hgmma", 0) == 0 for k in want):
        fail(f"tensor-core kernels missing or without HGMMA: {rep}")
    spills = {k: rep[k] for k in NO_SPILL
              if rep[k].get("spill_stores", 1) or rep[k].get("spill_loads", 1)}
    if spills:
        fail(f"split-pair kernels spill: {spills}")
    return rep


def _tc_source_report(build, src) -> dict:
    rep, cur = {}, None
    for line in build.BUILD_LOG.get(src, "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", line)
        if m:
            cur = _kernel_key(m.group(1))
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
            cur = _kernel_key(m.group(1))
            if cur:
                rep.setdefault(cur, {})["hgmma"] = 0
        elif cur and "HGMMA" in line:
            rep[cur]["hgmma"] += 1
    return rep


# ---- phase 7: flash kernels -------------------------------------------------

FLASH_REPLACES = {
    "flash_fwd": "kubedl_tpu/ops/flash_attention.py:120 _fwd_kernel",
    "flash_bwd_fused": "kubedl_tpu/ops/flash_attention.py:480 _bwd_fused_kernel",
    "flash_bwd_dq": "kubedl_tpu/ops/flash_attention.py:314 _bwd_dq_kernel",
    "flash_bwd_dkdv": "kubedl_tpu/ops/flash_attention.py:393 _bwd_dkdv_kernel",
}
#: (label, B, H, KV, S, hd, dtype, causal, rope, timed). The first is the
#: llama3-1b training shape (the main path's); then Llama-3-8B and
#: Gemma-2B head widths, GQA groups 1 and 8 at both tensor-core widths
#: with and without RoPE, causal and not, ragged lengths, and float32 at
#: each hd. Every case runs all four kernels (the split pair too).
FLASH_CASES = [
    ("llama3-1b", 4, 32, 8, 2048, 64, torch.bfloat16, True, True, True),
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


def flash_inputs(B, H, KV, S, hd, dtype, rope, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
    do = randn(B, S, H, hd)
    cos = sin = None
    if rope:  # llama3's tables (theta 500000) at this head width
        from kubedl_tpu_torch.models.llama import rope_table

        cos, sin = rope_table(hd, 500000.0, S, device="cuda")
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


def check_flash_case(fa, case, records):
    """One FLASH_CASES entry: every kernel against its plain version, the
    two backward routes against each other; timings when ``timed``."""
    label, B, H, KV, S, hd, dtype, causal, rope, timed = case
    tol = FLASH_TOL[dtype]
    q, k, v, do, cos, sin = flash_inputs(B, H, KV, S, hd, dtype, rope,
                                         seed=S + hd)
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
    print(f"flash {label} {str(dtype)[6:]} causal={causal} rope={rope}: "
          + json.dumps(errs), flush=True)
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
        records[name] = rec
        print(f"{name} timed: " + json.dumps(rec), flush=True)


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


def run_flash_long(fa, records):
    """Phase 7, long context: the split pair at LONG_FLASH against the
    plain versions run head by head and against the tensor-core fused
    kernel, timed as at S=2048 (plain: one call); then SLICE_FLASH through
    ``flash_backward`` with the split route forced against the plain
    versions run whole. The S=2048 records stay beside the new ones
    under "s2048"."""
    label, B, H, KV, S, hd, dtype, causal, rope = LONG_FLASH
    if fa.bwd_route(S, hd) != "split":
        fail(f"bwd_route({S}, {hd}) is not split")
    tol = FLASH_TOL[dtype]["grad"]
    q, k, v, do, cos, sin = flash_inputs(B, H, KV, S, hd, dtype, rope,
                                         seed=S + hd)
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
          + json.dumps(errs), flush=True)
    _, sdpa_bwd = sdpa_flash_yardsticks(q, k, v, do, cos, sin, fa)
    lib_ms = time_ms(sdpa_bwd, reps=20)
    with forced_route(fa, "split"):
        pair_ms = time_ms(lambda: fa.flash_backward(*args), reps=20)
    fused_ms = time_ms(lambda: fa.flash_bwd_fused(*args), reps=20)
    del sdpa_bwd
    _free()
    shape = (B, H, KV, S, hd, dtype, causal, rope)
    calls = {"flash_bwd_dq": (lambda: fa.flash_bwd_dq(*args), plain_dq_ms),
             "flash_bwd_dkdv": (lambda: fa.flash_bwd_dkdv(*args),
                                plain_dkdv_ms)}
    for name, (kern, plain_ms) in calls.items():
        rec = {"max_abs_err": abs_errs[name],
               "max_err_over_max_grad": errs[name],
               "split_vs_fused": errs["split_vs_fused"],
               "ms": time_ms(kern, reps=20),
               "call_ms": time_ms(kern, reps=5, warmup=1, hide_host=False),
               "plain_ms": plain_ms, "plain_calls": H,
               "library_ms": lib_ms, "library_call_ms": None,
               "pair_ms": pair_ms, "fused_ms": fused_ms}
        rec["bound_ms"], rec["bound_by"] = flash_bound(name, *shape)
        rec["shape"] = f"B={B} H={H} KV={KV} S={S} hd={hd} bf16 " \
                       f"causal={causal} rope={rope}"
        rec["s2048"] = {key: records[name].get(key) for key in (
            "ms", "call_ms", "plain_ms", "library_ms", "pair_ms",
            "bound_ms", "max_abs_err", "shape")}
        records[name] = rec
        print(f"{name} timed (long context): " + json.dumps(rec), flush=True)
    del q, k, v, do, out, lse, dq, dk_h, dv_h, args
    _free()

    label, B, H, KV, S, hd, dtype, causal, rope = SLICE_FLASH
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
    applied) and ``want_per_step`` x steps launches of each flash kernel
    (counts set to 0 just before the run, read just after). Returns the
    launches and the printed record."""
    from kubedl_tpu_torch.training import entry
    from kubedl_tpu_torch.training.trainer import Trainer

    metrics = []
    real_step = Trainer.train_step

    def recording_step(self, state, batch):
        state, m = real_step(self, state, batch)
        metrics.append(m)  # device scalars, read after the run
        return state, m

    Trainer.train_step = recording_step
    _reset(fa)
    torch.cuda.reset_peak_memory_stats()
    try:
        rc = entry.train_main({"KUBEDL_TRAIN_CONFIG": json.dumps(config)})
    finally:
        Trainer.train_step = real_step
    launches = dict(fa.LAUNCHES)
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
    rec = {"config": config, "losses": losses, "grad_norms": norms,
           "step_time_ms": s["step_time_ms"],
           "tokens_per_sec": s["tokens_per_sec"], "mfu": s["mfu"],
           "first_step_seconds": s["first_step_seconds"],
           "hbm_floor_ms": s["hbm_floor_ms"], "n_params": s["n_params"],
           "long_context_policy": s["long_context_policy"],
           "max_memory_allocated_gib": peak / 2**30,
           "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
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
    return {k: launches[k] for k in ("flash_fwd", "flash_bwd_fused")}


#: the long-context path: Llama-3.2-1B at 32k tokens (published with a
#: 128k context), where the trainer's long-context policy applies and
#: the backward takes the split pair on every layer
LONG_TRAIN_CONFIG = {"model": "llama3-1b", "global_batch": 1,
                     "seq_len": 32768, "steps": 4, "log_every": 1}
LONG_POLICY = "loss_chunk=512,remat_policy=flash_rope"


def run_long_context_train(fa, llama_mod):
    """Phase 11: ``train_main`` at LONG_TRAIN_CONFIG. Per step: 16
    flash_fwd ("flash_rope" saves the forward's outputs, so remat never
    re-runs it), 16 flash_bwd_dq, 16 flash_bwd_dkdv, 0 flash_bwd_fused.
    Then one step (after one unprofiled) under torch.profiler. MFU is the
    trainer's 6N flops a token, which leaves attention's flops out."""
    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import TrainConfig, Trainer

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
    tr = Trainer(TrainConfig(model=model, global_batch=B, seq_len=S,
                             steps=2, warmup_steps=1, attn_impl="flash"))
    state = tr.init_state()
    batch = next(iter(SyntheticTokens(B, S, model.vocab_size, seed=2)))
    state, _ = tr.train_step(state, batch)
    profile_train_steps(tr, state, batch, 1, f"{cfg['model']} b{B} s{S}")
    del tr, state
    _free()
    return {k: launches[k] for k in PAIR}


def run_train_bf16_routes(fa, llama_mod):
    """Phase 12: llama3-1b width cut to 2 layers, bf16, B=1, S=32768, one
    seeded init: the loss and gradients of one train step on the split
    route (the route at this length) against the same step with the fused
    route forced. Gates: the loss within 1e-5 relative (both routes run
    the same forward kernels); every gradient leaf within 3e-2 of its max
    |grad|. Why 3e-2: the two backward kernels round P and dS to bf16
    from float32 scores summed in other orders, and the split route rounds
    each q-head's dk/dv to bf16 before the group sum where the fused one
    sums in float32 and rounds once, so dq, dk and dv differ by one or two
    bf16 ulps (2^-8 relative) of the largest element; the weight
    gradients round once more (bf16 products) and layer 0's pass through
    layer 1's backward: about eight ulps of the largest gradient."""
    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import TrainConfig, Trainer

    model = dataclasses.replace(llama_mod.preset("llama3-1b"), n_layers=2)
    S = LONG_TRAIN_CONFIG["seq_len"]
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
    print("bf16 2-layer llama3-1b width s32768, split vs fused: "
          + json.dumps(report), flush=True)


def _kernel_group(name: str) -> str:
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
    if "flash_bwd" in name or "flash_dq_finish" in name:
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

    state = profile_train_steps(tr, state, batch, 2,
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


def profile_train_steps(tr, state, batch, steps, label):
    """``steps`` train steps under torch.profiler: device time by
    category (``_kernel_group`` of each kernel's name, the split pair's
    two kernels on their own), the top kernels and the device's busy share
    of the wall time. Returns the state."""
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
        cat = _kernel_group(e.key)
        cats[cat] = cats.get(cat, 0.0) + us / 1e3
        counts[cat] = counts.get(cat, 0) + e.count
        top.append((us / 1e3, e.count, e.key[:90]))
    dev_ms = sum(cats.values())
    top.sort(reverse=True)
    print(f"profile ({steps} train step(s), {label}): " + json.dumps({
        "wall_ms": wall_ms, "device_ms": dev_ms,
        "busy_share": dev_ms / wall_ms if wall_ms else None,
        "by_category_ms": cats, "by_category_kernels": counts,
        "top": [[n, ms, c] for ms, c, n in top[:10]]}), flush=True)
    if dev_ms == 0.0:
        print("profile: the profiler saw no device time", flush=True)
    return state


def run_train_f32_parity(fa, llama_mod):
    """Phase 9: llama3-1b width cut to 2 layers, float32, TF32 off, one
    seeded init: one train step on each kernel route (fused, split) and on
    the plain route (dense attention). Gates: losses within 1e-5
    relative; every gradient leaf within 1e-4 of max |grad| (float32 sums
    reordered, the fused dq by atomics); updated params within 2.0001*lr
    max abs (one Adam step moves an element by at most lr(1 + wd|p|); a
    gradient near zero may flip sign between routes) and 1e-3*lr mean
    abs."""
    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import (
        TrainConfig, Trainer, tree_leaves,
    )

    model = dataclasses.replace(llama_mod.preset("llama3-1b"), n_layers=2,
                                dtype=torch.float32)
    lr = 3e-4
    kw = dict(model=model, global_batch=2, seq_len=1024, steps=4,
              warmup_steps=0, learning_rate=lr)
    batch = next(iter(SyntheticTokens(2, 1024, model.vocab_size, seed=3)))
    runs = {}
    for route in ("dense", "fused", "split"):
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
    for route in ("fused", "split"):
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
            fail(f"f32 parity {route} vs dense: {json.dumps(report)}")
    print("f32 2-layer llama3-1b width, kernels vs dense: "
          + json.dumps(report), flush=True)


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


def run_engine(pa, server_mod, llama_mod, summary):
    serve_cfg = {"preset": "llama3-8b", "max_batch": 8, "max_seq": 2048,
                 "kv_block_size": 16, "kv_attention": "blocked",
                 "prefill_chunk_tokens": 512}
    port = free_port()
    cfg = dict(serve_cfg, port=port, host="127.0.0.1")
    cancel = threading.Event()
    box = {}

    def serve():
        try:
            server_mod.serve_main({"KUBEDL_SERVE_CONFIG": json.dumps(cfg),
                                   "_KUBEDL_CANCEL": cancel})
        except BaseException as e:  # surfaced by the health wait below
            box["error"] = repr(e)

    t_start = time.perf_counter()
    th = threading.Thread(target=serve, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    while True:
        if "error" in box:
            fail(f"server failed to start: {box['error']}")
        try:
            if http_json(base + "/healthz", timeout=5)[0] == 200:
                break
        except OSError:
            pass
        if time.perf_counter() - t_start > 600:
            fail("server not healthy after 600 s")
        time.sleep(1.0)
    print(f"engine up in {time.perf_counter() - t_start:.1f} s "
          f"(llama3-8b init + kernel warmup)", flush=True)
    cfg8 = llama_mod.preset("llama3-8b")
    reqs = make_requests(cfg8.vocab_size)
    _, before = http_json(base + "/v1/stats")
    torch.cuda.reset_peak_memory_stats()
    for counts in (pa.LAUNCHES, pa.ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0
    results, wall = post_all(base, reqs)
    launches = dict(pa.LAUNCHES)
    routes = dict(pa.ROUTE_LAUNCHES)
    _, st = http_json(base + "/v1/stats")
    peak = torch.cuda.max_memory_allocated()
    cancel.set()
    th.join(timeout=120)
    if th.is_alive():
        fail("server did not stop")
    for j, (code, res) in enumerate(results):
        if code != 200 or len(res.get("token_ids", [])) != 128:
            fail(f"request {j}: HTTP {code}, {str(res)[:300]}")
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
        "launches": launches,
        "route_launches": routes,
    }
    print("engine (smoke run, not a benchmark): " + json.dumps(eng), flush=True)
    summary["launches"] = launches
    blocked_tokens = [r[1]["token_ids"] for r in results[:6]]
    gc.collect()
    torch.cuda.empty_cache()
    return blocked_tokens, reqs, serve_cfg


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
    kernel in a profiled engine run, by category, and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    short = [dict(r, max_tokens=32) for r in reqs]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
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


# ---- main -------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-engine", action="store_true",
                    help="skip the serving engine (phases 5 and 6)")
    ap.add_argument("--skip-train", action="store_true",
                    help="skip the training phases (8 to 12)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubedl_tpu_torch.models import llama as llama_mod
    from kubedl_tpu_torch.models import paged_attention as pa
    from kubedl_tpu_torch.ops import build
    from kubedl_tpu_torch.ops import flash_attention as fa
    from kubedl_tpu_torch.serving import server as server_mod

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

    kernels = {}
    for name, shape in (("llama", LLAMA), ("gemma", GEMMA)):
        for S in (1, 64, 512):
            rec = check_blocked(pa, shape, S, torch.bfloat16, timed=True)
            print(f"blocked {name} S={S} bf16: " + json.dumps(rec), flush=True)
            if name == "llama" and S == 512:
                kernels["paged_attention_blocked"] = rec
        rec = check_fused(pa, shape, torch.bfloat16, timed=True)
        print(f"fused {name} bf16: " + json.dumps(rec), flush=True)
        if name == "llama":
            kernels["paged_attention_fused"] = rec
    rec = check_fused(pa, LONG, torch.bfloat16, timed=True,
                      start_list=LONG_STARTS)
    print("fused llama long-context MB=512 bf16: " + json.dumps(rec),
          flush=True)
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

    launches = {"blocked": None, "fused": None}
    summary = {"launches": launches}
    if not args.skip_engine:
        blocked_tokens, reqs, serve_cfg = run_engine(
            pa, server_mod, llama_mod, summary)
        launches = summary["launches"]
        run_gather(server_mod, reqs, serve_cfg, blocked_tokens)
        run_f32_parity(server_mod, llama_mod, reqs, serve_cfg)
        run_profile(server_mod, reqs, serve_cfg)

    kernels.update(run_flash_kernels(fa))
    run_flash_long(fa, kernels)
    launches.update({name: None for name in FLASH_REPLACES})
    if not args.skip_train:
        launches.update(run_train_entry(fa, llama_mod))
        run_overfit_and_split(fa, llama_mod)
        run_train_f32_parity(fa, llama_mod)
        # the split pair's main path: the long-context training run
        launches.update(run_long_context_train(fa, llama_mod))
        run_train_bf16_routes(fa, llama_mod)

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
        for key in ("shape", "pair_ms", "fused_ms", "s2048"):
            if key in rec:
                out[key] = rec[key]
        return out

    # each paged entry's design is the route its timed case took
    line = [record(name, "kubedl_tpu_torch/csrc/paged_attention.cu",
                   REPLACES[name], launches[name.rsplit("_", 1)[1]],
                   kernels[name], kernels[name]["route"])
            for name in ("paged_attention_blocked", "paged_attention_fused")]
    main_case = FLASH_CASES[0]  # the timed shape: llama3-1b training
    for name in FLASH_REPLACES:
        tc = fa.tensor_core_route(main_case[6], main_case[5])
        line.append(record(name, "kubedl_tpu_torch/csrc/flash_attention.cu",
                           FLASH_REPLACES[name], launches[name],
                           kernels[name],
                           "tensor_core" if tc else "cuda_core"))
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
