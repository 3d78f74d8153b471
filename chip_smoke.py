"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card
    python3 chip_smoke.py --skip-engine  # build + kernel checks only

Phases (any failure exits non-zero before the final line):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA.
2. build: compiles the port's CUDA sources (kubedl_tpu_torch/csrc) with
   nvcc for sm_90a and prints the build seconds.
3. blocked kernel vs its plain PyTorch version at the serving shapes
   (Llama-3-8B: B=8, KV=8, group 4, hd 128, BS 16, MB 128; Gemma-2B:
   hd 256, KV 1, group 8) for S in {1, 64, 512}, ragged starts, block
   boundaries and an all-trash row, bf16 and f32; kernel, plain and
   library (SDPA over the gathered view) times.
4. fused decode kernel (S=1, KV write fused) vs plain scatter + plain
   attention: pools bitwise equal outside the trash block, outputs within
   tolerance; the same timings.
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
   request, under torch.profiler: device time by kernel category
   (paged attention, matmul, other) and the device's busy share of the
   wall time.

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


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn``, with the 50 MB L2
    flushed before each (the engine meets every layer's pool cold)."""
    global _flush
    if _flush is None:
        _flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        _flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---- inputs and bounds ------------------------------------------------------

def make_case(shape, S, dtype, seed):
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
    starts = torch.tensor(STARTS[:B], dtype=torch.int32, device="cuda")
    nk = torch.randn((B, KV, hd), generator=g, device="cuda").to(dtype)
    nv = torch.randn((B, KV, hd), generator=g, device="cuda").to(dtype)
    return q, kp, vp, bt, starts, nk, nv


def bound(shape, S, dtype, fused=False):
    """Least time for the work: K/V positions each row's queries can see
    read once (this run's starts), q read and out written once; flops
    4*hd per (query head, visible key), at the input type's peak."""
    B, KV, H, hd, BS, MB = (shape[k] for k in ("B", "KV", "H", "hd", "BS", "MB"))
    max_s = BS * MB
    esz = torch.tensor([], dtype=dtype).element_size()
    keys = vis = 0
    for st in STARTS[:B]:
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

def check_blocked(pa, shape, S, dtype, timed: bool):
    q, kp, vp, bt, starts, _, _ = make_case(shape, S, dtype, seed=S + 11)
    out = pa.paged_attention(q, kp, vp, bt, starts)
    torch.cuda.synchronize()
    ref = pa.plain_paged_attention(q, kp, vp, bt, starts)
    err = (out.float() - ref.float()).abs().max().item()
    if not math.isfinite(err) or err > TOL[dtype]:
        fail(f"blocked kernel {shape} S={S} {dtype}: max abs err {err} "
             f"> {TOL[dtype]}")
    rec = {"max_abs_err": err}
    if timed:
        rec["ms"] = time_ms(lambda: pa.paged_attention(q, kp, vp, bt, starts))
        rec["plain_ms"] = time_ms(
            lambda: pa.plain_paged_attention(q, kp, vp, bt, starts), reps=20)
        rec["library_ms"] = time_ms(sdpa_yardstick(q, kp, vp, bt, starts))
        rec["bound_ms"], rec["bound_by"] = bound(shape, S, dtype)
    return rec


def check_fused(pa, shape, dtype, timed: bool):
    q, kp, vp, bt, starts, nk, nv = make_case(shape, 1, dtype, seed=97)
    kk, vk = kp.clone(), vp.clone()
    out, kk2, vk2 = pa.paged_attention(q, kk, vk, bt, starts,
                                       new_k=nk, new_v=nv)
    torch.cuda.synchronize()
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
    rec = {"max_abs_err": err}
    if timed:
        rec["ms"] = time_ms(lambda: pa.paged_attention(
            q, kk, vk, bt, starts, new_k=nk, new_v=nv))

        def plain():
            pa.plain_fused_write(kr, vr, bt, starts, nk, nv)
            return pa.plain_paged_attention(q, kr, vr, bt, starts)

        rec["plain_ms"] = time_ms(plain)
        rec["library_ms"] = time_ms(sdpa_yardstick(q, kr, vr, bt, starts))
        rec["bound_ms"], rec["bound_by"] = bound(shape, 1, dtype, fused=True)
    return rec


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
    for k in pa.LAUNCHES:
        pa.LAUNCHES[k] = 0
    results, wall = post_all(base, reqs)
    launches = dict(pa.LAUNCHES)
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
    if "paged_attention_kernel" in name:
        return "paged_attention_fused" if "true>" in name \
            else "paged_attention_blocked"
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
    cats, top = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        cat = _kernel_category(e.key)
        cats[cat] = cats.get(cat, 0.0) + us / 1e3
        top.append((us / 1e3, e.count, e.key[:90]))
    dev_ms = sum(cats.values())
    top.sort(reverse=True)
    print("profile (8 concurrent requests x 32 tokens): " + json.dumps({
        "wall_ms": wall_ms, "device_ms": dev_ms,
        "busy_share": dev_ms / wall_ms if wall_ms else None,
        "by_category_ms": cats,
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
                    help="build and check the kernels only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubedl_tpu_torch.models import llama as llama_mod
    from kubedl_tpu_torch.models import paged_attention as pa
    from kubedl_tpu_torch.ops import build
    from kubedl_tpu_torch.serving import server as server_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    build.load_kernels(verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({json.dumps(build.BUILD_SECONDS)})", flush=True)

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

    summary = {"launches": {"blocked": None, "fused": None}}
    if not args.skip_engine:
        blocked_tokens, reqs, serve_cfg = run_engine(
            pa, server_mod, llama_mod, summary)
        run_gather(server_mod, reqs, serve_cfg, blocked_tokens)
        run_f32_parity(server_mod, llama_mod, reqs, serve_cfg)
        run_profile(server_mod, reqs, serve_cfg)

    line = []
    for name in ("paged_attention_blocked", "paged_attention_fused"):
        rec = kernels[name]
        line.append({
            "name": name, "route": "cuda",
            "source": "kubedl_tpu_torch/csrc/paged_attention.cu",
            "replaces": REPLACES[name],
            "launches": summary["launches"][name.rsplit("_", 1)[1]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
