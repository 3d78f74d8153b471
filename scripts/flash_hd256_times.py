"""Time the flash forward and fused backward at Gemma-2B's training shape.

    python3 scripts/flash_hd256_times.py [--tree DIR] [--reps N]

Runs the PyTorch port's ``flash_fwd`` and ``flash_bwd_fused`` operators on
one NVIDIA GPU at B=4, H=8, KV=1, S=2048, hd 256, bf16, causal, with
Gemma's RoPE tables (theta 10000), and prints one JSON line: the card's
name and power limit, each operator's route, and its device time (CUDA
events, median of ``--reps``, L2 flushed, host queueing hidden:
``chip_smoke.time_ms``). ``--tree`` imports the port and ``chip_smoke``
from another checkout of this repository (e.g. an older commit unpacked
with ``git archive``), so two versions can be timed in one run on one
card: old, new, new, old.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

SHAPE = dict(B=4, H=8, KV=1, S=2048, hd=256)


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
    from kubedl_tpu_torch.models.llama import rope_table
    from kubedl_tpu_torch.ops import flash_attention as fa

    B, H, KV, S, hd = (SHAPE[k] for k in ("B", "H", "KV", "S", "hd"))
    g = torch.Generator(device="cuda").manual_seed(S + hd)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v, do = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd), \
        randn(B, S, H, hd)
    cos, sin = rope_table(hd, 10000.0, S, device="cuda")
    out, lse = fa.flash_fwd(q, k, v, cos, sin, True)
    args_bwd = (q, k, v, cos, sin, out, lse, do, True)
    if hasattr(fa, "OPS"):  # the route table per operator
        routes = {op: fa.tensor_core_route(op, torch.bfloat16, hd)
                  for op in ("flash_fwd", "flash_bwd_fused")}
    else:  # one table for all four operators
        routes = dict.fromkeys(("flash_fwd", "flash_bwd_fused"),
                               fa.tensor_core_route(torch.bfloat16, hd))
    rec = {"card": cs.smi_line(), "tree": os.path.abspath(args.tree),
           "shape": SHAPE,
           "routes": {op: "tensor_core" if tc else "cuda_core"
                      for op, tc in routes.items()},
           "flash_fwd_ms": cs.time_ms(
               lambda: fa.flash_fwd(q, k, v, cos, sin, True), reps=args.reps),
           "flash_bwd_fused_ms": cs.time_ms(
               lambda: fa.flash_bwd_fused(*args_bwd), reps=args.reps)}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
