"""Where a tensor-core paged decode launch spends its time, CTA by CTA.

    python3 scripts/paged_decode_trace.py [--plain-launch]

Builds an instrumented copy of ``kubedl_tpu_torch/csrc/paged_attention.cu``
under ``build/paged_decode_trace/`` (the source itself is not touched):
thread 0 of each CTA of ``paged_decode_mma_kernel`` records ``clock64()``
at its phase boundaries and ``%globaltimer`` at entry and exit. Then it
runs ``chip_smoke.py``'s Gemma-2B cases (the fused decode step at MB 128
and at MB 512, verify's S = 5) through the port's entry point with that
library on one NVIDIA GPU and prints one JSON line a case: the call's
device ms (``chip_smoke.time_ms``), the kernel's device ms
(``torch.profiler``), the CTAs that ran, the last CTA's exit (ns after the
first CTA's entry), and for each row the phase boundaries of the CTA
that left last, in cycles after its entry:

    entered, n known (starts and the block table read), queries issued,
    stage 0 landed, stage 0's P in shared memory, last stage landed,
    walk done, partials merged-from (everyone arrived), left

``--plain-launch`` replaces the cooperative launch with a plain one (the
kernel's wait is then safe only while every CTA happens to be resident),
to price the cooperative launch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(REPO, "build", "paged_decode_trace")
SLOTS = 64  # rows and splits traced (the table is SLOTS x SLOTS CTAs)
#: phase names, in the order of their clock64 slots 0..8
PHASES = ("entered", "n_known", "queries_issued", "stage0_landed",
          "stage0_p", "last_stage_landed", "walk_done", "merge_from",
          "left")

HEADER = """
__device__ unsigned long long g_trace[%(n)d * %(n)d][12];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TRACED (threadIdx.x == 0 && blockIdx.x < %(n)d && blockIdx.y < %(n)d)
#define SLOT g_trace[blockIdx.y * %(n)d + blockIdx.x]
#define TR(k) if (TRACED) SLOT[k] = clock64();
#define LEAVE if (TRACED) { SLOT[8] = clock64(); SLOT[9] = gtime(); }
""" % {"n": SLOTS}

FOOTER = """
static unsigned long long g_zero[%(n)d * %(n)d][12];
extern "C" int kdl_md_trace_clear() {
  return (int)cudaMemcpyToSymbol(g_trace, g_zero, sizeof(g_zero));
}
extern "C" int kdl_md_trace(void* out) {
  cudaDeviceSynchronize();
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
""" % {"n": SLOTS}

#: (anchor in the source, text put after it); each anchor must be there
AFTER = [
    ("    paged_decode_mma_kernel(const MdArgs a) {\n",
     "  if (TRACED) SLOT[10] = gtime();\n  TR(0)\n"),
    ("  __syncthreads();  // sbt\n", "  TR(2)\n"),
    ("    __syncthreads();  // stage kt (and the queries) landed for every "
     "thread\n", "    if (kt == 0) { TR(3) } else { TR(5) }\n"),
    ("    __syncthreads();  // P landed\n", "    if (kt == 0) { TR(4) }\n"),
    ("  cp_async_wait<0>();\n\n  // l over the score tiles' owners\n",
     "  TR(6)\n"),
    ("  __syncthreads();  // thread 0's acquire, for the whole CTA\n",
     "  TR(7)\n"),
]
#: (text, replacement): the kernel's exits
REPLACE = [
    ("  if (split >= used) return;  // no keys: no partial, no arrival\n",
     "  if (split >= used) { LEAVE return; }\n  TR(1)\n"),
    ("  if (used == 1) return;\n", "  if (used == 1) { LEAVE return; }\n"),
    ("  if (tid == 0 && s_departed == used - 1) {",
     "  LEAVE\n  if (tid == 0 && s_departed == used - 1) {"),
]
PLAIN_LAUNCH = (
    "  void* args[] = {&a};\n"
    "  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), "
    "grid,\n"
    "                                    dim3(kMdWarps * 32), args, smem, st);\n"
    "  if (err != cudaSuccess) return err;\n"
    "  return cudaGetLastError();",
    "  kern<<<grid, kMdWarps * 32, smem, st>>>(a);\n"
    "  return cudaGetLastError();")


def instrumented_source(plain_launch: bool) -> str:
    src_path = os.path.join(REPO, "kubedl_tpu_torch", "csrc",
                            "paged_attention.cu")
    with open(src_path) as f:
        src = f.read()
    pairs = [(a, a + b) for a, b in AFTER] + REPLACE
    if plain_launch:
        pairs.append(PLAIN_LAUNCH)
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"anchor not found once in the source: {old!r}")
        src = src.replace(old, new)
    return HEADER + src + FOOTER


def build(plain_launch: bool):
    from kubedl_tpu_torch.ops import build as kb

    os.makedirs(OUT_DIR, exist_ok=True)
    shutil.copy(os.path.join(kb.CSRC_DIR, "hopper.cuh"), OUT_DIR)
    cu = os.path.join(OUT_DIR, "paged_attention_trace.cu")
    with open(cu, "w") as f:
        f.write(instrumented_source(plain_launch))
    lib_path = os.path.join(OUT_DIR, "libpaged_attention_trace.so")
    subprocess.run([kb.find_nvcc(), *kb.NVCC_FLAGS, "-o", lib_path, cu],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    kb._declare_paged_attention(lib)
    lib.kdl_md_trace.argtypes = [ctypes.c_void_p]
    kb._libs["paged_attention"] = lib  # the entry point launches this build
    return lib


def trace_case(lib, cs, pa, kernel_ms, shape, S, starts, fused) -> dict:
    bf = torch.bfloat16
    q, kp, vp, bt, st, nk, nv = cs.make_case(shape, S, bf, seed=97,
                                             starts=starts)

    def fn():
        if fused:
            return pa.paged_attention(q, kp, vp, bt, st, new_k=nk, new_v=nv)
        return pa.paged_attention(q, kp, vp, bt, st)

    rec = {"ms": cs.time_ms(fn), "kernel_ms": sum(kernel_ms(fn).values())}
    fn()
    torch.cuda.synchronize()
    if lib.kdl_md_trace_clear() != 0:
        raise SystemExit("could not clear the trace table")
    fn()
    buf = np.zeros((SLOTS * SLOTS, 12), np.uint64)
    if lib.kdl_md_trace(buf.ctypes.data) != 0:
        raise SystemExit("could not read the trace table")
    ran = [i for i in range(SLOTS * SLOTS) if buf[i, 10]]
    t0 = min(int(buf[i, 10]) for i in ran)
    rec["ctas"] = len(ran)
    rec["last_exit_ns"] = max(int(buf[i, 9]) for i in ran) - t0
    rows = {}
    for r in range(shape["B"] * shape["KV"]):
        worked = [i for i in ran if i // SLOTS == r and buf[i, 1]]
        if not worked:
            continue
        last = max(worked, key=lambda i: int(buf[i, 9]))
        c = buf[last, :9].astype(np.int64)
        rows[r] = {"ctas": len(worked),
                   "exit_ns": int(buf[last, 9]) - t0,
                   "cycles": {p: int(c[k] - c[0]) for k, p in
                              enumerate(PHASES) if c[k] or k == 0}}
    rec["rows"] = rows
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plain-launch", action="store_true",
                    help="a plain launch in place of the cooperative one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import chip_smoke as cs
    from kubedl_tpu_torch.models import paged_attention as pa
    from paged_decode_times import kernel_ms

    lib = build(args.plain_launch)
    cases = {"fused": (cs.GEMMA, 1, cs.STARTS, True),
             "fused_8k": (dict(cs.GEMMA, MB=512), 1, cs.LONG_STARTS, True),
             "verify_s5": (cs.GEMMA, 5, cs.VERIFY_STARTS, False)}
    for name, (shape, S, starts, fused) in cases.items():
        rec = trace_case(lib, cs, pa, kernel_ms, shape, S, starts, fused)
        print(json.dumps({"card": cs.smi_line(), "case": name,
                          "launch": "plain" if args.plain_launch
                          else "cooperative", **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
