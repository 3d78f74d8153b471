"""Worker entrypoint of the port: ``python -m kubedl_tpu_torch.training.entry``.

The single-process path of ``kubedl_tpu/training/entry.py``: reads the
train config as JSON from ``KUBEDL_TRAIN_CONFIG`` (same keys and
defaults as the reference), builds the :class:`Trainer`, runs ``fit`` on
:class:`SyntheticTokens` and prints ``{"worker_summary": ...}``.

The device is ``KUBEDL_TRAIN_DEVICE``, else ``"device"`` in the config,
else CUDA (with no card that raises; ask for ``"cpu"`` explicitly).

What this slice does not run is rejected with a ValueError that names
the later port slice: more than one process or device
(``KUBEDL_NUM_PROCESSES``, ``KUBEDL_MESH_AXES``), checkpoints and
publishing (``KUBEDL_CKPT_DIR``, ``KUBEDL_MODEL_PATH``, ``ckpt_every``),
the parameter service (``KUBEDL_PS_ADDR``, ``train_mode: "ps"``),
elastic resize (``KUBEDL_ELASTIC_BASE_WORLD`` / ``_BASE_DP``), token
files (``data_path``), fault injection (``KUBEDL_FAULT_ONCE_AT_STEP``,
``KUBEDL_FAULT_MARKER``) and the progress beacon
(``KUBEDL_BEACON_FILE``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional

# the env names this entry reads (its own copy of kubedl_tpu/api/constants.py)
ENV_TRAIN_CONFIG = "KUBEDL_TRAIN_CONFIG"
ENV_TRAIN_DEVICE = "KUBEDL_TRAIN_DEVICE"
ENV_NUM_PROCESSES = "KUBEDL_NUM_PROCESSES"
ENV_MESH_AXES = "KUBEDL_MESH_AXES"
ENV_CKPT_DIR = "KUBEDL_CKPT_DIR"
ENV_MODEL_PATH = "KUBEDL_MODEL_PATH"
ENV_PS_ADDR = "KUBEDL_PS_ADDR"
ENV_ELASTIC_BASE_WORLD = "KUBEDL_ELASTIC_BASE_WORLD"
ENV_ELASTIC_BASE_DP = "KUBEDL_ELASTIC_BASE_DP"
ENV_BEACON_FILE = "KUBEDL_BEACON_FILE"
ENV_FAULT_ONCE_AT_STEP = "KUBEDL_FAULT_ONCE_AT_STEP"
ENV_FAULT_MARKER = "KUBEDL_FAULT_MARKER"
ENV_SPAWN_TS = "KUBEDL_SPAWN_TS"

#: last run's summary, for in-process harnesses to read back
LAST_SUMMARY: Optional[dict] = None


def _int(environ, name: str, default: int = 0) -> int:
    return int(environ.get(name, "") or default)


def _mesh_devices(spec: str) -> int:
    n = 1
    for part in filter(None, (p.strip() for p in spec.split(","))):
        n *= int(part.partition("=")[2])
    return n


def _reject_unported(environ: Dict[str, str], opts: dict) -> None:
    later = "belongs to a later port slice"
    checks = [
        (_int(environ, ENV_NUM_PROCESSES, 1) > 1,
         f"{ENV_NUM_PROCESSES} > 1: multi-process training belongs to the "
         f"multi-chip port slice"),
        (_mesh_devices(environ.get(ENV_MESH_AXES, "")) > 1,
         f"{ENV_MESH_AXES}={environ.get(ENV_MESH_AXES)!r}: a mesh of more "
         f"than one device belongs to the multi-chip port slice"),
        (bool(environ.get(ENV_CKPT_DIR)),
         f"{ENV_CKPT_DIR}: checkpoint/restore {later}"),
        (bool(environ.get(ENV_MODEL_PATH)),
         f"{ENV_MODEL_PATH}: publishing the final state {later}"),
        (bool(environ.get(ENV_PS_ADDR)) or opts.get("train_mode") == "ps",
         f"parameter-service training {later}"),
        (_int(environ, ENV_ELASTIC_BASE_WORLD) > 0
         or _int(environ, ENV_ELASTIC_BASE_DP) > 0,
         f"elastic resize ({ENV_ELASTIC_BASE_WORLD}/{ENV_ELASTIC_BASE_DP}) "
         f"{later}"),
        (bool(opts.get("data_path")),
         f"data_path: token-file datasets {later}"),
        (_int(environ, ENV_FAULT_ONCE_AT_STEP, -1) >= 0
         or bool(environ.get(ENV_FAULT_MARKER)),
         f"fault injection ({ENV_FAULT_ONCE_AT_STEP}/{ENV_FAULT_MARKER}) "
         f"{later}"),
        (bool(environ.get(ENV_BEACON_FILE)),
         f"{ENV_BEACON_FILE}: the progress beacon {later}"),
    ]
    for bad, msg in checks:
        if bad:
            raise ValueError(msg)


def _model_preset(name: str):
    from kubedl_tpu_torch.models import llama

    if "moe" in name:
        raise ValueError(f"model {name!r}: MoE belongs to the MoE port slice")
    return llama.preset(name)


def train_main(env: Optional[Dict[str, object]] = None) -> int:
    """Train from ``KUBEDL_TRAIN_CONFIG``; ``env`` overrides the process
    environment (string values) and may carry ``_KUBEDL_CANCEL`` (an
    object with ``is_set()``: the loop then exits with SystemExit(137))."""
    global LAST_SUMMARY
    t_start = time.time()
    environ = dict(os.environ)
    environ.update({k: v for k, v in (env or {}).items()
                    if isinstance(v, str)})
    cancel = (env or {}).get("_KUBEDL_CANCEL")
    phases: Dict[str, float] = {}
    spawn_ts = float(environ.get(ENV_SPAWN_TS, 0) or 0)
    if spawn_ts:
        phases["spawn_to_proc"] = max(t_start - spawn_ts, 0.0)
    opts = json.loads(environ.get(ENV_TRAIN_CONFIG, "{}") or "{}")
    _reject_unported(environ, opts)

    t0 = time.time()
    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import TrainConfig, Trainer

    phases["imports"] = time.time() - t0
    model = _model_preset(opts.get("model", "tiny"))
    for knob in ("remat_policy", "loss_chunk"):
        if knob in opts:
            model = dataclasses.replace(model, **{knob: opts[knob]})
    cfg = TrainConfig(
        model=model,
        global_batch=int(opts.get("global_batch", 8)),
        seq_len=int(opts.get("seq_len", min(128, model.max_seq))),
        steps=int(opts.get("steps", 5)),
        learning_rate=float(opts.get("learning_rate", 3e-4)),
        grad_accum=int(opts.get("grad_accum", 1)),
        attn_impl=opts.get("attn_impl", "auto"),
        context_parallel_impl=opts.get("context_parallel_impl", "ring"),
        microbatches=int(opts.get("microbatches", 0)),
        ckpt_every=int(opts.get("ckpt_every", 0)),
        ckpt_async=bool(opts.get("ckpt_async", True)),
        opt_moment_dtype=opts.get("opt_moment_dtype", "float32"),
        shard_update=bool(opts.get("shard_update", True)),
        overlap_comm=bool(opts.get("overlap_comm", True)),
        grad_bucket_mb=float(opts.get("grad_bucket_mb", 4.0)),
        log_every=int(opts.get("log_every", 0)),
        long_context_policy=opts.get("long_context_policy", "auto"),
    )
    device = environ.get(ENV_TRAIN_DEVICE) or opts.get("device") or None
    t0 = time.time()
    trainer = Trainer(cfg, device=device)
    phases["trainer_build"] = time.time() - t0
    t0 = time.time()
    state = trainer.init_state()
    phases["state_init"] = time.time() - t0
    t0 = time.time()
    data = SyntheticTokens(cfg.global_batch, cfg.seq_len, model.vocab_size)
    phases["data_build"] = time.time() - t0
    first_step_wall = {}

    def on_step(i, metrics):
        if "t" not in first_step_wall:
            first_step_wall["t"] = time.time()
        if cancel is not None and getattr(cancel, "is_set", lambda: False)():
            raise SystemExit(137)  # retryable: gang restart requested

    state, summary = trainer.fit(iter(data), state=state, on_step=on_step)
    summary["first_step_wall_time"] = first_step_wall.get("t", time.time())
    total = summary["first_step_wall_time"] - (spawn_ts or t_start)
    phases["pre_loop_sync"] = summary.get("pre_loop_sync_s", 0.0)
    phases["first_step"] = summary.get("first_step_seconds", 0.0)
    phases["unattributed"] = max(total - sum(phases.values()), 0.0)
    phases["total_to_first_step"] = total
    summary["startup_phases"] = {k: round(v, 3) for k, v in phases.items()}
    summary["compile_cache"] = None  # eager PyTorch compiles nothing
    LAST_SUMMARY = summary
    print(json.dumps({"worker_summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(train_main())
