"""Time the flash operators at Gemma-2B's training shapes (hd 256).

    python3 scripts/flash_hd256_times.py [--tree DIR] [--shape b4s2048|b1s8192]
                                         [--reps N] [--train]

Runs the PyTorch port's four flash operators (``flash_fwd``,
``flash_bwd_fused``, ``flash_bwd_dq``, ``flash_bwd_dkdv``) and the split
pair as ``flash_backward`` runs it (dq, dk/dv and the group sum, the
split route forced) on one NVIDIA GPU at Gemma-2B's widths (H=8, KV=1,
hd 256, bf16, causal, Gemma's RoPE tables, theta 10000): B=4, S=2048
(``b4s2048``, the default) or B=1, S=8192 (``b1s8192``, the model's
published context). Prints one JSON line: the card's name and power
limit, each operator's route, and each device time (CUDA events, median
of ``--reps``, L2 flushed, host queueing hidden: ``chip_smoke.time_ms``).
With ``--train`` it also runs ``train_main`` on ``gemma-2b`` at b1 x
s8192 for 4 steps (``chip_smoke.py`` phase 24's configuration) and adds
its step ms, tokens/s, MFU and flash launches to the line.

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

SHAPES = {"b4s2048": dict(B=4, H=8, KV=1, S=2048, hd=256),
          "b1s8192": dict(B=1, H=8, KV=1, S=8192, hd=256)}
OPS = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkdv")
#: chip_smoke.py phase 24's training configuration
TRAIN_CONFIG = {"model": "gemma-2b", "global_batch": 1, "seq_len": 8192,
                "steps": 4, "log_every": 1}


def train_step(fa) -> dict:
    """``train_main`` at TRAIN_CONFIG in this process: its summary's step
    time (the steps after the first), tokens/s, MFU, the policy it
    applied, and the flash launches a step."""
    from kubedl_tpu_torch.training import entry

    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    rc = entry.train_main({"KUBEDL_TRAIN_CONFIG": json.dumps(TRAIN_CONFIG)})
    s = entry.LAST_SUMMARY
    steps = TRAIN_CONFIG["steps"]
    return {"rc": rc, "config": TRAIN_CONFIG,
            "step_time_ms": s["step_time_ms"],
            "tokens_per_sec": s["tokens_per_sec"], "mfu": s["mfu"],
            "first_step_seconds": s["first_step_seconds"],
            "long_context_policy": s.get("long_context_policy"),
            "launches_per_step": {k: v / steps for k, v in fa.LAUNCHES.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--shape", choices=sorted(SHAPES), default="b4s2048")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--train", action="store_true",
                    help="also time train_main at phase 24's configuration")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as cs
    from kubedl_tpu_torch.models.llama import rope_table
    from kubedl_tpu_torch.ops import flash_attention as fa

    shape = SHAPES[args.shape]
    B, H, KV, S, hd = (shape[k] for k in ("B", "H", "KV", "S", "hd"))
    g = torch.Generator(device="cuda").manual_seed(S + hd)

    def randn(*dims):
        return torch.randn(dims, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v, do = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd), \
        randn(B, S, H, hd)
    cos, sin = rope_table(hd, 10000.0, S, device="cuda")
    out, lse = fa.flash_fwd(q, k, v, cos, sin, True)
    args_bwd = (q, k, v, cos, sin, out, lse, do, True)
    calls = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, cos, sin, True),
             "flash_bwd_fused": lambda: fa.flash_bwd_fused(*args_bwd),
             "flash_bwd_dq": lambda: fa.flash_bwd_dq(*args_bwd),
             "flash_bwd_dkdv": lambda: fa.flash_bwd_dkdv(*args_bwd)}
    rec = {"card": cs.smi_line(), "tree": os.path.abspath(args.tree),
           "shape": shape,
           "routes": {op: "tensor_core" if fa.tensor_core_route(
               op, torch.bfloat16, hd) else "cuda_core" for op in OPS}}
    for op in OPS:
        rec[op + "_ms"] = cs.time_ms(calls[op], reps=args.reps)
    with cs.forced_route(fa, "split"):
        rec["pair_ms"] = cs.time_ms(lambda: fa.flash_backward(*args_bwd),
                                    reps=args.reps)
    del q, k, v, do, out, lse, args_bwd, calls
    torch.cuda.empty_cache()
    if args.train:
        rec["train"] = train_step(fa)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
