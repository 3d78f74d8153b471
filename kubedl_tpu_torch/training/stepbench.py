"""Per-phase training-step microbenchmark for the sharded weight update.

The port of ``kubedl_tpu/training/stepbench.py``: the same model, arms,
phases, interleaving and result JSON, key for key. Three arms on the
SAME ``data=n`` mesh, model, init and data stream:

- ``replicated``      — grad all-reduce + the full optimizer update on
                        every rank (shard_update=False)
- ``sharded``         — reduce-scatter -> 1/dp optimizer update ->
                        all-gather, collectives after the microbatch loop
- ``sharded_overlap`` — the same update, each microbatch's bucketed
                        reduce-scatters issued asynchronously right after
                        its backward (overlap_comm=True)

Per arm it reports timing medians decomposed into three phases:

- ``compute_ms``      — arm-invariant oracle: one device's fwd+bwd of one
                        microbatch x grad_accum (no collectives, no
                        update), timed once and shared by every arm
- ``update_ms``       — the arm's own optimizer apply in the arm's update
                        layout (``Trainer.apply_update``), timed alone
- ``exposed_comm_ms`` — max(step_ms - compute_ms - update_ms, 0): the
                        collective time still on the critical path

plus the per-device optimizer-state residency from the live tensors and
the loss against the replicated arm, so a layout change that silently
changes the math fails loudly.

How the port runs it: ``n`` devices are ``n`` ranks of one job started
through ``parallel/launch.py`` (the env ``parallel/mesh.py`` joins
from). Each rank holds all three arms' ``Trainer``s on one
``ProcessMesh`` and interleaves them; every arm starts from one init
drawn from an explicit ``torch.Generator``. The result's times are rank
0's. Ranks that share one card (a one-card host) reduce over gloo through
pinned host buffers, so there ``exposed_comm_ms`` is a host reduction,
not NVLink. Each rank also prints one ``{"stepbench_rank": ...}`` line:
its device and its flash and AdamW kernel launches (on the card the bench
model's head dim 32 runs the flash kernels' CUDA-core route).

Standalone entry (runs on the card unless ``--device cpu``):

    python -m kubedl_tpu_torch.training.stepbench --devices 4 --json out.json
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Any, Dict, Optional

#: timed step-loop iterations per arm (median taken over these)
TIMED_STEPS = 6
#: untimed warmup steps per arm (kernel builds, allocator and cache effects)
WARMUP_STEPS = 2
#: timed repetitions of the standalone update
UPDATE_REPS = 6
#: seconds a rank may run before the launcher kills the job
RANK_TIMEOUT_S = 900


def _bench_model():
    """Big enough that the optimizer state dominates device memory and
    every matmul leaf clears the scatter floor; small enough for CPU CI
    (the reference's, field for field)."""
    import torch

    from kubedl_tpu_torch.models import llama

    return llama.LlamaConfig(
        vocab_size=1024, dim=256, n_layers=4, n_heads=8, n_kv_heads=4,
        ffn_dim=1024, max_seq=256, dtype=torch.float32, remat=False,
    )


def _median_ms(samples) -> float:
    return statistics.median(samples) * 1e3


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_compute_oracle(cfg, device, seq_len: int, micro_rows: int,
                         grad_accum: int) -> float:
    """One device's fwd+bwd of one microbatch, x grad_accum: the compute
    every arm pays regardless of update layout (a one-process Trainer,
    so the arms' attention path, and no collective)."""
    import numpy as np
    import torch

    from kubedl_tpu_torch.parallel.mesh import local_mesh
    from kubedl_tpu_torch.training.trainer import Trainer

    tr = Trainer(cfg, local_mesh(device))
    params = tr.family.init(torch.Generator(device=device).manual_seed(0),
                            device)
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(rng.integers(
        0, cfg.model.vocab_size, (micro_rows, seq_len),
        dtype=np.int32)).to(device)
    tr.value_and_grad(params, batch)  # warm
    _sync(device)
    samples = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        loss, _ = tr.value_and_grad(params, batch)
        loss.item()
        _sync(device)
        samples.append(time.perf_counter() - t0)
    return _median_ms(samples) * grad_accum


def _make_update_fn(trainer, state):
    """The arm's optimizer apply alone, in the arm's real update layout
    (this rank's gradient slices -> the sharded update -> the params'
    all-gather when the update is sharded; the full replicated update
    otherwise), on a copy of the arm's state. Returns a warmed-up zero-arg
    thunk for interleaved timing."""
    import torch

    from kubedl_tpu_torch.training.trainer import tree_leaves, tree_unflatten

    leaves = tree_leaves(state["params"])
    params = tree_unflatten(state["params"], [p.clone() for p in leaves])
    opt = dict(state["opt_state"])
    opt["mu"] = [t.clone() for t in opt["mu"]]
    opt["nu"] = [t.clone() for t in opt["nu"]]
    work = {"params": params, "opt_state": opt, "step": state["step"]}
    grads = [torch.full_like(trainer._upd(p, i), 1e-3)
             for i, p in enumerate(tree_leaves(params))]

    def thunk():
        trainer.apply_update(work, grads)
        _sync(trainer.device)

    thunk()  # warm
    return thunk


def _setup_arm(cfg, mesh, data_seed: int) -> Dict[str, Any]:
    """Build + init + warm up one arm; timing happens interleaved across
    arms afterwards so slow host drift cannot favor any single arm."""
    import torch

    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import (
        Trainer, _fetch_scalar, state_bytes_per_device,
    )

    trainer = Trainer(cfg, mesh)
    # every arm from one init: the same explicit generator stream
    state = trainer.init_fn(
        torch.Generator(device=trainer.device).manual_seed(0))
    data = iter(SyntheticTokens(cfg.global_batch, cfg.seq_len,
                                cfg.model.vocab_size, seed=data_seed))
    losses = []
    for _ in range(WARMUP_STEPS):
        state, metrics = trainer.train_step(state, next(data))
        losses.append(_fetch_scalar(metrics["loss"]))
    return {
        "trainer": trainer, "state": state, "data": data,
        "losses": losses, "samples": [],
        "opt_state_bytes_per_device": _busiest(
            state_bytes_per_device(state)),
        "grad_buckets": trainer.grad_bucket_plan.n_buckets,
        "shard_update_compiled": bool(trainer.update_axes),
    }


def _busiest(nbytes: int) -> int:
    """The largest of every rank's ``nbytes`` (the reference reports the
    busiest device's residency)."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return nbytes
    t = torch.tensor([nbytes], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def _timed_step(arm) -> None:
    from kubedl_tpu_torch.training.trainer import _fetch_scalar

    trainer = arm["trainer"]
    batch = next(arm["data"])
    t0 = time.perf_counter()
    arm["state"], metrics = trainer.train_step(arm["state"], batch)
    # a scalar fetch is the only true barrier
    arm["losses"].append(_fetch_scalar(metrics["loss"]))
    arm["samples"].append(time.perf_counter() - t0)


def run_stepbench(
    devices: Optional[int] = None,
    grad_accum: int = 2,
    timed_steps: int = TIMED_STEPS,
    device=None,
) -> Dict[str, Any]:
    """This rank's part of the bench: all three arms on a pure
    data-parallel mesh over the job's ``devices`` processes (the process
    group already joined; one process alone without one), on ``device``
    (the card unless "cpu"). Returns the per-phase medians + acceptance
    proxies (the times this rank's)."""
    import dataclasses

    from kubedl_tpu_torch.api.topology import MeshSpec
    from kubedl_tpu_torch.parallel.mesh import build_mesh, world
    from kubedl_tpu_torch.training.trainer import TrainConfig, family_for

    _, n = world()
    if devices and devices != n:
        raise ValueError(f"--devices {devices}: this job has {n} processes")
    mesh = build_mesh(MeshSpec({"data": n}), device)
    model = _bench_model()
    global_batch = 2 * n * grad_accum
    seq_len = 128
    base = TrainConfig(
        model=model, global_batch=global_batch, seq_len=seq_len,
        steps=timed_steps, grad_accum=grad_accum,
        shard_update=False, overlap_comm=False,
    )
    arms_cfg = {
        "replicated": base,
        "sharded": dataclasses.replace(base, shard_update=True),
        "sharded_overlap": dataclasses.replace(
            base, shard_update=True, overlap_comm=True
        ),
    }
    compute_ms = _time_compute_oracle(
        base, mesh.device, seq_len, global_batch // (n * grad_accum),
        grad_accum,
    )
    live = {name: _setup_arm(cfg, mesh, data_seed=7)
            for name, cfg in arms_cfg.items()}
    # interleave: one timed step per arm per round, so slow host drift
    # (CPU frequency, co-tenants) lands on every arm equally
    for _ in range(timed_steps):
        for arm in live.values():
            _timed_step(arm)
    update_fns = {name: _make_update_fn(arm["trainer"], arm["state"])
                  for name, arm in live.items()}
    update_samples = {name: [] for name in live}
    for _ in range(UPDATE_REPS):
        for name, thunk in update_fns.items():
            t0 = time.perf_counter()
            thunk()
            update_samples[name].append(time.perf_counter() - t0)
    arms: Dict[str, Dict[str, Any]] = {}
    for name, arm_live in live.items():
        arm = {
            "step_ms": _median_ms(arm_live["samples"]),
            "update_ms": _median_ms(update_samples[name]),
            "opt_state_bytes_per_device":
                arm_live["opt_state_bytes_per_device"],
            "grad_buckets": arm_live["grad_buckets"],
            "shard_update_compiled": arm_live["shard_update_compiled"],
            "losses": arm_live["losses"],
            "final_loss": arm_live["losses"][-1],
        }
        arm["compute_ms"] = compute_ms
        arm["exposed_comm_ms"] = max(
            arm["step_ms"] - compute_ms - arm["update_ms"], 0.0
        )
        arm["exposed_comm_fraction"] = (
            arm["exposed_comm_ms"] / arm["step_ms"] if arm["step_ms"] else 0.0
        )
        arms[name] = arm
    rep = arms["replicated"]
    rep_losses = list(rep["losses"])
    for name, arm in arms.items():
        arm["loss_delta_vs_replicated"] = max(
            abs(a - b) for a, b in zip(arm["losses"], rep_losses)
        )
        del arm["losses"]
    # the proxy compares whichever sharded arm won on this host (the
    # reference's rule)
    best_arm = min(
        ("sharded", "sharded_overlap"),
        key=lambda a: arms[a]["exposed_comm_ms"] + arms[a]["update_ms"],
    )
    best = arms[best_arm]
    return {
        "devices": n,
        "mesh": f"data={n}",
        "model_params": family_for(model).num_params,
        "global_batch": global_batch,
        "seq_len": seq_len,
        "grad_accum": grad_accum,
        "timed_steps": timed_steps,
        "compute_ms": compute_ms,
        "arms": arms,
        "proxy": {
            "best_arm": best_arm,
            "exposed_comm_fraction_replicated": rep["exposed_comm_fraction"],
            "exposed_comm_fraction_overlap": best["exposed_comm_fraction"],
            "exposed_comm_reduced": (
                best["exposed_comm_ms"] + best["update_ms"]
                < rep["exposed_comm_ms"] + rep["update_ms"]
            ),
            "opt_state_bytes_replicated": rep["opt_state_bytes_per_device"],
            "opt_state_bytes_sharded": best["opt_state_bytes_per_device"],
            "opt_state_bytes_reduced": (
                best["opt_state_bytes_per_device"]
                < rep["opt_state_bytes_per_device"]
            ),
            "max_loss_delta": max(
                a["loss_delta_vs_replicated"] for a in arms.values()
            ),
        },
    }


def _rank_main(args) -> int:
    """One rank: join the job, run the bench, print this rank's line (and,
    rank 0, the result's)."""
    import torch
    import torch.distributed as dist

    from kubedl_tpu_torch.ops import adamw
    from kubedl_tpu_torch.ops import flash_attention as fa
    from kubedl_tpu_torch.parallel.mesh import initialize_from_env, world

    joined = initialize_from_env()
    try:
        out = run_stepbench(devices=args.devices, grad_accum=args.grad_accum,
                            timed_steps=args.timed_steps, device=args.device)
        rank, _ = world()
        dev = "cpu" if args.device == "cpu" else \
            torch.cuda.get_device_name(torch.cuda.current_device())
        print(json.dumps({"stepbench_rank": {
            "rank": rank, "device": dev,
            "flash_launches": dict(fa.LAUNCHES),
            "adamw_launches": dict(adamw.LAUNCHES)}}), flush=True)
        if rank == 0:
            print(json.dumps({"stepbench_result": out}), flush=True)
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--timed-steps", type=int, default=TIMED_STEPS)
    ap.add_argument("--json", default="", help="write the result here "
                    "(stdout always gets the JSON too)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; default the card")
    args = ap.parse_args(argv)
    from kubedl_tpu_torch.api.constants import ENV_PROCESS_ID

    if ENV_PROCESS_ID in os.environ:  # a rank of the job started below
        return _rank_main(args)
    from kubedl_tpu_torch.parallel.launch import join_ranks, start_ranks

    argv = sys.argv[1:] if argv is None else list(argv)
    procs = start_ranks([sys.executable, "-m",
                         "kubedl_tpu_torch.training.stepbench", *argv],
                        args.devices)
    outs = join_ranks(procs, RANK_TIMEOUT_S)
    result = None
    for text in outs:
        for line in text.splitlines():
            if not line.startswith("{"):
                continue
            doc = json.loads(line)
            if "stepbench_rank" in doc:
                print(line, flush=True)
            result = doc.get("stepbench_result", result)
    text = json.dumps(result, indent=2, sort_keys=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
