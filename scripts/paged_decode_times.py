"""Time the paged decode at Gemma-2B's widths (hd 256, bf16).

    python3 scripts/paged_decode_times.py [--tree DIR] [--reps N]

Runs the PyTorch port's paged attention on one NVIDIA GPU at
``chip_smoke.py``'s Gemma-2B shapes (B=8, H=8, KV=1, hd 256, BS 16, bf16,
seeded inputs from ``chip_smoke.make_case``): the fused decode step at
MB=128 (``STARTS``) and at MB=512 (8192 positions, ``LONG_STARTS``), and
speculative verify's blocked call at S=5 (``VERIFY_STARTS``). Prints one
JSON line: the card's name and power limit, the tree, and for each case
its route, its device ms and call ms (``chip_smoke.time_ms``: median of
``--reps``, L2 flushed; "ms" with the host's queueing hidden, "call_ms"
with it), and from ``torch.profiler`` over 20 calls each kernel's device
ms a call.

``--tree`` imports the port and ``chip_smoke`` from another checkout of
this repository (e.g. an older commit unpacked with ``git archive``), so
two versions can be timed in one run on one card: old, new, new, old.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def kernel_ms(fn, calls: int = 20) -> dict:
    """Device ms a call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key[:60]] = us / 1e3 / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as cs
    from kubedl_tpu_torch.models import paged_attention as pa

    bf = torch.bfloat16
    cases = {"fused": (cs.GEMMA, 1, cs.STARTS, True),
             "fused_8k": (dict(cs.GEMMA, MB=512), 1, cs.LONG_STARTS, True),
             "verify_s5": (cs.GEMMA, 5, cs.VERIFY_STARTS, False)}
    rec = {"card": cs.smi_line(), "tree": os.path.abspath(args.tree)}
    for name, (shape, S, starts, fused) in cases.items():
        q, kp, vp, bt, st, nk, nv = cs.make_case(shape, S, bf, seed=97,
                                                 starts=starts)
        if fused:
            def fn():
                return pa.paged_attention(q, kp, vp, bt, st, new_k=nk,
                                          new_v=nv)
        else:
            def fn():
                return pa.paged_attention(q, kp, vp, bt, st)
        rec[name] = {
            "route": pa.paged_route(bf, shape["hd"], S,
                                    shape["H"] // shape["KV"], shape["BS"],
                                    fused),
            "ms": cs.time_ms(fn, reps=args.reps),
            "call_ms": cs.time_ms(fn, reps=args.reps, hide_host=False),
            "kernels_ms": kernel_ms(fn),
        }
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
