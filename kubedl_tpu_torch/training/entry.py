"""Worker entrypoint of the port: ``python -m kubedl_tpu_torch.training.entry``.

The single-process path of ``kubedl_tpu/training/entry.py``, with the
job lifecycle around it: reads the train config as JSON from
``KUBEDL_TRAIN_CONFIG`` (the reference's keys and defaults), builds the
:class:`Trainer`, restores from the latest checkpoint (a gang restart
re-enters here and loses at most one save interval), trains with
interval saves, and publishes the final state to ``KUBEDL_MODEL_PATH``
(where serving and the ModelVersion build read it). Prints
``{"resumed_from_step": N}`` after a restore and one
``{"worker_summary": ...}`` at the end.

- Checkpoints: ``KUBEDL_CKPT_DIR``, or ``<KUBEDL_MODEL_PATH>/checkpoints``
  when ``ckpt_every`` is set (for a remote model root a local temporary
  directory named by its hash); restore from it, else from the replica
  at ``KUBEDL_CKPT_PEER``, which interval saves also push to.
- Data: ``data_path`` (with ``token_bytes``) through
  :func:`kubedl_tpu_torch.data.native.TokenFileDataset`, else
  :class:`SyntheticTokens`. A resume starts the stream afresh, as the
  reference's does: step k of a resumed run trains on the stream's
  first batch.
- Fault injection: ``KUBEDL_FAULT_ONCE_AT_STEP`` with
  ``KUBEDL_FAULT_MARKER`` exits with SystemExit(137) once, after that
  step, writing the marker.
- The progress beacon: ``KUBEDL_BEACON_FILE`` (every
  ``KUBEDL_BEACON_INTERVAL`` s), stopped (and flushed) in ``finally``.
- Publish: the final state to ``KUBEDL_MODEL_PATH``; a remote root
  (``http://host:port/blobs/...``) gets it through a temporary directory
  and the blob client.

The device is ``KUBEDL_TRAIN_DEVICE``, else ``"device"`` in the config,
else CUDA (with no card that raises; ask for ``"cpu"`` explicitly).

Still rejected with a ValueError that names the later port slice: more
than one process or device (``KUBEDL_NUM_PROCESSES``,
``KUBEDL_MESH_AXES``), the parameter service (``KUBEDL_PS_ADDR``,
``train_mode: "ps"``), elastic resize (``KUBEDL_ELASTIC_BASE_WORLD`` /
``_BASE_DP``) and a chaos plan (``"chaos"`` in the config, e.g. the
``trainer.step_stall`` site).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Dict, Optional

# the env names this entry reads (its own copy of kubedl_tpu/api/constants.py)
ENV_TRAIN_CONFIG = "KUBEDL_TRAIN_CONFIG"
ENV_TRAIN_DEVICE = "KUBEDL_TRAIN_DEVICE"
ENV_NUM_PROCESSES = "KUBEDL_NUM_PROCESSES"
ENV_MESH_AXES = "KUBEDL_MESH_AXES"
ENV_CKPT_DIR = "KUBEDL_CKPT_DIR"
ENV_CKPT_PEER = "KUBEDL_CKPT_PEER"
ENV_MODEL_PATH = "KUBEDL_MODEL_PATH"
ENV_PS_ADDR = "KUBEDL_PS_ADDR"
ENV_ELASTIC_BASE_WORLD = "KUBEDL_ELASTIC_BASE_WORLD"
ENV_ELASTIC_BASE_DP = "KUBEDL_ELASTIC_BASE_DP"
ENV_BEACON_FILE = "KUBEDL_BEACON_FILE"
ENV_BEACON_INTERVAL = "KUBEDL_BEACON_INTERVAL"
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
    """Raise ``ValueError`` for a knob the port does not run yet, naming
    the slice it belongs to. The ``"chaos"`` key of the training config
    is the port's own stand-in, not the reference's interface: the
    reference arms its ``trainer.step_stall`` site only through a
    ``FaultPlan`` armed in-process (``chaos.arm``), which reaches no
    worker through its environment. The port has no chaos sites, so a
    caller that puts a plan in the config is told so rather than ignored."""
    later = "belongs to a later port slice"
    multi = "belongs to the multi-chip port slice"
    checks = [
        (_int(environ, ENV_NUM_PROCESSES, 1) > 1,
         f"{ENV_NUM_PROCESSES} > 1: multi-process training {multi}"),
        (_mesh_devices(environ.get(ENV_MESH_AXES, "")) > 1,
         f"{ENV_MESH_AXES}={environ.get(ENV_MESH_AXES)!r}: a mesh of more "
         f"than one device {multi}"),
        (bool(environ.get(ENV_PS_ADDR)) or opts.get("train_mode") == "ps",
         f"parameter-service training {later}"),
        (_int(environ, ENV_ELASTIC_BASE_WORLD) > 0
         or _int(environ, ENV_ELASTIC_BASE_DP) > 0,
         f"elastic resize ({ENV_ELASTIC_BASE_WORLD}/{ENV_ELASTIC_BASE_DP}) "
         f"{later}"),
        (bool(opts.get("chaos")),
         f"a chaos plan (e.g. the trainer.step_stall site): fault "
         f"injection {later}"),
    ]
    for bad, msg in checks:
        if bad:
            raise ValueError(msg)


def _ckpt_dir(environ: Dict[str, str], out: str, ckpt_every: int) -> str:
    """``KUBEDL_CKPT_DIR``, else ``<out>/checkpoints`` for interval saves;
    a remote model root is a URL, so its saves go to a local temporary
    directory named by the URL's hash (the final publish uploads)."""
    from kubedl_tpu_torch.remote.client import is_remote_root

    ckpt_dir = environ.get(ENV_CKPT_DIR, "")
    if ckpt_dir or not (out and ckpt_every):
        return ckpt_dir
    if is_remote_root(out):
        return os.path.join(
            tempfile.gettempdir(),
            "kubedl-ckpt-" + hashlib.sha256(out.encode()).hexdigest()[:16])
    return os.path.join(out, "checkpoints")


def _publish(out: str, ckpt_dir: str, state) -> None:
    """The final train state at the model path's root (serving and the
    ModelVersion build read ``latest`` there)."""
    from kubedl_tpu_torch.remote.client import is_remote_root, upload_tree
    from kubedl_tpu_torch.training.checkpoint import (
        save_checkpoint, train_state_tree,
    )

    step = int(state["step"])
    if is_remote_root(out):
        with tempfile.TemporaryDirectory(prefix="kubedl-publish-") as tmp:
            save_checkpoint(tmp, train_state_tree(state), step)
            n = upload_tree(tmp, out)
            print(f"published {n} blobs to {out}", flush=True)
    elif os.path.abspath(ckpt_dir or "") != os.path.abspath(out):
        save_checkpoint(out, train_state_tree(state), step)


def _model_preset(name: str):
    """A name containing "moe" is a switch-MoE preset, any other a Llama
    one (the reference's rule); an unknown name raises ``KeyError``."""
    from kubedl_tpu_torch.models import llama, moe

    if "moe" in name:
        return moe.preset(name)
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
    from kubedl_tpu_torch.training.checkpoint import (
        restore_from_best, train_state_from_tree, train_state_like,
    )
    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import TrainConfig, Trainer

    phases["imports"] = time.time() - t0
    model = _model_preset(opts.get("model", "tiny"))
    for knob in ("remat_policy", "loss_chunk"):
        if knob in opts and hasattr(model, knob):
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

    out = environ.get(ENV_MODEL_PATH, "")
    ckpt_dir = _ckpt_dir(environ, out, cfg.ckpt_every)
    ckpt_peer = environ.get(ENV_CKPT_PEER, "")
    # restore from the latest checkpoint: a gang restart resumes instead
    # of training again; the fresh init is the restore template and, on a
    # cold start, the state
    t0 = time.time()
    state = trainer.init_state()
    if ckpt_dir:
        restored = restore_from_best(
            ckpt_dir, train_state_like(state),
            sources=[s for s in (ckpt_peer,) if s], device=trainer.device)
        if restored is not None:
            state = train_state_from_tree(restored)
            print(json.dumps({"resumed_from_step": state["step"]}),
                  flush=True)
    phases["state_init"] = time.time() - t0

    t0 = time.time()
    data_path = opts.get("data_path", "")
    if data_path:
        from kubedl_tpu_torch.data.native import TokenFileDataset

        data = TokenFileDataset(
            data_path, cfg.global_batch, cfg.seq_len, seed=cfg.seed,
            token_bytes=int(opts.get("token_bytes", 4)))
        data_loader = data.kind
    else:
        data = SyntheticTokens(cfg.global_batch, cfg.seq_len, model.vocab_size)
        data_loader = "synthetic"
    phases["data_build"] = time.time() - t0
    first_step_wall = {}
    fault_step = _int(environ, ENV_FAULT_ONCE_AT_STEP, -1)
    fault_marker = environ.get(ENV_FAULT_MARKER, "")
    beacon = None
    beacon_file = environ.get(ENV_BEACON_FILE, "")
    if beacon_file:
        from kubedl_tpu_torch.watchdog.beacon import ProgressBeacon

        try:
            beat = float(environ.get(ENV_BEACON_INTERVAL, "0.5"))
        except ValueError:
            beat = 0.5
        beacon = ProgressBeacon(beacon_file, interval=beat).start()
    tokens_per_step = float(cfg.global_batch * cfg.seq_len)

    def on_step(i, metrics):
        if "t" not in first_step_wall:
            first_step_wall["t"] = time.time()
        if beacon is not None:
            beacon.step(i + 1, tokens=(i + 1) * tokens_per_step)
        if cancel is not None and getattr(cancel, "is_set", lambda: False)():
            raise SystemExit(137)  # retryable: gang restart requested
        if (fault_step >= 0 and i == fault_step and fault_marker
                and not os.path.exists(fault_marker)):
            with open(fault_marker, "w") as f:
                f.write("fired")
            raise SystemExit(137)

    try:
        state, summary = trainer.fit(
            iter(data), state=state, on_step=on_step,
            ckpt_dir=ckpt_dir or None, ckpt_every=cfg.ckpt_every,
            ckpt_peer=ckpt_peer)
    finally:
        if beacon is not None:
            beacon.stop()  # flush the final step count
        if data_path:
            data.close()
    summary["data_loader"] = data_loader
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
    if out:
        _publish(out, ckpt_dir, state)
    return 0


if __name__ == "__main__":
    sys.exit(train_main())
