"""Worker entrypoint of the port: ``python -m kubedl_tpu_torch.training.entry``.

The port of ``kubedl_tpu/training/entry.py``, with the job lifecycle
around it: reads the train config as JSON from ``KUBEDL_TRAIN_CONFIG``
(the reference's keys and defaults), joins the job's processes
(``torch.distributed`` from ``KUBEDL_NUM_PROCESSES`` /
``KUBEDL_PROCESS_ID`` / ``KUBEDL_COORDINATOR_ADDRESS``) and builds the
mesh of ``KUBEDL_MESH_AXES`` (``parallel/mesh.py``), builds the
:class:`Trainer`, restores from the latest checkpoint (a gang restart
re-enters here and loses at most one save interval), trains with
interval saves, and publishes the final state to ``KUBEDL_MODEL_PATH``
(where serving and the ModelVersion build read it). Every process does
each of these for its part, as in the reference: it prints
``{"resumed_from_step": N}`` after a restore and one
``{"worker_summary": ...}`` at the end, and saves its own shards.

- Elastic resize: with ``KUBEDL_ELASTIC_BASE_WORLD`` (or
  ``KUBEDL_ELASTIC_BASE_DP`` with a mesh) and a world that differs,
  ``grad_accum`` is rescaled so the per-device microbatch stays as tuned
  and the global batch, and the trajectory, do not change
  (``elastic/resize.py``); prints ``{"elastic_grad_accum": ..., "world":
  ..., "base_world": ...}``.

- The kernel build cache: ``KUBEDL_COMPILE_CACHE_DIR`` is enabled before
  the first kernel (``utils/compile_cache.py``); the summary's
  ``compile_cache`` has the reference's keys: ``dir`` (the build
  directory, the default one when no cache is set), ``entries_before``
  / ``entries_after`` (files in it), ``cache_hits`` / ``cache_misses``
  (sources this process loaded from a build / compiled).

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
  step, writing the marker; and each step consults the chaos site
  ``trainer.step_stall`` of a plan armed in this process
  (``kubedl_tpu_torch.chaos.arm``, as in the reference): a fault wedges
  the step loop (the beacon keeps stamping) until the cancel event is
  set, a latency spec delays the step. A ``"chaos"`` key in the config
  is ignored, as the reference ignores keys it does not read.
- The progress beacon: ``KUBEDL_BEACON_FILE`` (every
  ``KUBEDL_BEACON_INTERVAL`` s), stopped (and flushed) in ``finally``.
- Publish: the final state to ``KUBEDL_MODEL_PATH``; a remote root
  (``http://host:port/blobs/...``) gets it through a temporary directory
  and the blob client.

The device is ``KUBEDL_TRAIN_DEVICE``, else ``"device"`` in the config,
else CUDA (with no card that raises; ask for ``"cpu"`` explicitly).

The mesh: ``KUBEDL_MESH_AXES`` may put any of ``replica``, ``data``,
``fsdp``, ``pipe``, ``expert``, ``sp`` and ``tensor`` above 1 (the model
sharded over fsdp / tensor / sp / expert, GPipe stages over pipe with
``microbatches`` in the config, 0 = 4 x pipe; ``context_parallel_impl``
picking ring or Ulysses attention for ``sp``, for Llama and MoE alike).
The trainer refuses what the reference refuses (``pipe`` with ``sp``, a
dimension an axis does not divide).

- Parameter-service mode: with ``train_mode: "ps"`` in the config AND
  ``KUBEDL_PS_ADDR`` set (the reference's rule; either alone trains
  synchronously), the worker ``"worker-" + KUBEDL_PROCESS_ID`` runs
  :meth:`Trainer.fit_ps` against :class:`~kubedl_tpu_torch.ps.server.PSClient`
  at that address (either package's tier), pushing every
  ``KUBEDL_PS_PUSH_EVERY`` steps, else ``ps_push_every`` from the config
  (default 1), with the same beacon and step hook; no interval saves.
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

from kubedl_tpu_torch.api.constants import (
    ENV_BEACON_FILE, ENV_BEACON_INTERVAL, ENV_CKPT_DIR, ENV_CKPT_PEER,
    ENV_COMPILE_CACHE_DIR, ENV_ELASTIC_BASE_DP, ENV_ELASTIC_BASE_WORLD,
    ENV_MESH_AXES, ENV_MODEL_PATH, ENV_NUM_PROCESSES, ENV_PROCESS_ID,
    ENV_PS_ADDR, ENV_PS_PUSH_EVERY,
)

# the env names this entry reads that the control plane's table does not
# hold (as in the reference, which spells them where it reads them)
ENV_TRAIN_CONFIG = "KUBEDL_TRAIN_CONFIG"
ENV_TRAIN_DEVICE = "KUBEDL_TRAIN_DEVICE"
ENV_FAULT_ONCE_AT_STEP = "KUBEDL_FAULT_ONCE_AT_STEP"
ENV_FAULT_MARKER = "KUBEDL_FAULT_MARKER"
ENV_SPAWN_TS = "KUBEDL_SPAWN_TS"

#: last run's summary, for in-process harnesses to read back
LAST_SUMMARY: Optional[dict] = None


def _int(environ, name: str, default: int = 0) -> int:
    return int(environ.get(name, "") or default)


def _check_mesh(environ: Dict[str, str]) -> None:
    """Raise ``ValueError`` for a mesh axis no rule names
    (:func:`~kubedl_tpu_torch.parallel.mesh.check_axes`)."""
    from kubedl_tpu_torch.api.topology import MeshSpec
    from kubedl_tpu_torch.parallel.mesh import check_axes

    check_axes(MeshSpec.from_env(environ.get(ENV_MESH_AXES, "")))


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


def _publish(out: str, ckpt_dir: str, state, mesh) -> None:
    """The final train state at the model path's root (serving and the
    ModelVersion build read ``latest`` there): this rank's part of it."""
    from kubedl_tpu_torch.remote.client import is_remote_root, upload_tree
    from kubedl_tpu_torch.training.checkpoint import (
        save_checkpoint, train_state_tree,
    )

    step = int(state["step"])
    rank, nprocs = mesh.rank, mesh.world
    if is_remote_root(out):
        with tempfile.TemporaryDirectory(prefix="kubedl-publish-") as tmp:
            save_checkpoint(tmp, train_state_tree(state), step, rank, nprocs)
            if rank == 0:  # rank 0's files (the marker) go up last
                mesh.barrier()
            n = upload_tree(tmp, out)
            if rank != 0:
                mesh.barrier()
            print(f"published {n} blobs to {out}", flush=True)
    elif os.path.abspath(ckpt_dir or "") != os.path.abspath(out):
        save_checkpoint(out, train_state_tree(state), step, rank, nprocs,
                        mesh.barrier)


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
    _check_mesh(environ)
    from kubedl_tpu_torch.ops.build import BUILD_SECONDS, build_dir
    from kubedl_tpu_torch.utils.compile_cache import (
        cache_entry_count, enable_compilation_cache,
    )

    # before the first kernel: a gang restart / resize / resume re-enters
    # here and must load, not compile again, the unchanged kernels
    enable_compilation_cache(environ.get(ENV_COMPILE_CACHE_DIR, ""))
    cache = {"dir": str(build_dir()),
             "entries_before": cache_entry_count(str(build_dir())),
             "built_before": dict(BUILD_SECONDS)}
    from kubedl_tpu_torch.parallel.mesh import initialize_from_env

    t0 = time.time()
    joined = initialize_from_env(environ)
    phases["dist_init"] = time.time() - t0
    try:
        return _train(environ, opts, cancel, phases, t_start, spawn_ts,
                      cache)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(environ: Dict[str, str], opts: dict, cancel,
           phases: Dict[str, float], t_start: float, spawn_ts: float,
           cache: dict) -> int:
    """The rest of :func:`train_main`, inside the job's process group."""
    global LAST_SUMMARY
    from kubedl_tpu_torch.parallel.mesh import mesh_from_env

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
    # elastic resize: at a world other than the one the job was tuned at,
    # grad accumulation is rescaled so the per-device microbatch keeps
    # its tuned size; global_batch (and the loss trajectory) is unchanged
    base_world = _int(environ, ENV_ELASTIC_BASE_WORLD)
    world = _int(environ, ENV_NUM_PROCESSES, 1)
    # planner-owned meshes: rescale in data-parallel units instead
    base_dp = _int(environ, ENV_ELASTIC_BASE_DP)
    mesh_axes = environ.get(ENV_MESH_AXES, "")
    if base_dp > 0 and mesh_axes:
        from kubedl_tpu_torch.api.topology import MeshSpec
        from kubedl_tpu_torch.elastic.resize import data_parallel_world

        base_world = base_dp
        world = data_parallel_world(MeshSpec.from_env(mesh_axes))
    if base_world > 0 and world != base_world:
        from kubedl_tpu_torch.elastic.resize import grad_accum_for_world

        accum = grad_accum_for_world(cfg.grad_accum, base_world, world,
                                     cfg.global_batch)
        if accum != cfg.grad_accum:
            print(json.dumps({"elastic_grad_accum": accum, "world": world,
                              "base_world": base_world}), flush=True)
            cfg = dataclasses.replace(cfg, grad_accum=accum)
    device = environ.get(ENV_TRAIN_DEVICE) or opts.get("device") or None
    t0 = time.time()
    mesh = mesh_from_env(device, environ)
    trainer = Trainer(cfg, mesh)
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
    from kubedl_tpu_torch import chaos

    def cancelled() -> bool:
        return cancel is not None and getattr(cancel, "is_set",
                                              lambda: False)()

    def on_step(i, metrics):
        if "t" not in first_step_wall:
            first_step_wall["t"] = time.time()
        if beacon is not None:
            beacon.step(i + 1, tokens=(i + 1) * tokens_per_step)
        if cancelled():
            raise SystemExit(137)  # retryable: gang restart requested
        if (fault_step >= 0 and i == fault_step and fault_marker
                and not os.path.exists(fault_marker)):
            with open(fault_marker, "w") as f:
                f.write("fired")
            raise SystemExit(137)
        if chaos.should_fail("trainer.step_stall"):
            # injected hang: wedge the STEP LOOP without exiting — the
            # beacon thread keeps stamping fresh ts, so a watchdog sees
            # the hang signature (not silent death); only the cancel gets
            # us out. A latency spec returns after should_fail's own
            # bounded sleep instead of entering this.
            while True:
                if cancelled():
                    raise SystemExit(137)
                time.sleep(0.02)

    # parameter-service mode: this worker pushes deltas to / pulls the
    # aggregate from the tier at KUBEDL_PS_ADDR instead of the sync gang
    ps_addr = environ.get(ENV_PS_ADDR, "")
    try:
        if opts.get("train_mode", "sync") == "ps" and ps_addr:
            from kubedl_tpu_torch.ps.server import PSClient

            push_every = int(environ.get(ENV_PS_PUSH_EVERY, "0")
                             or opts.get("ps_push_every", 1))
            state, summary = trainer.fit_ps(
                iter(data), PSClient(ps_addr),
                "worker-" + environ.get(ENV_PROCESS_ID, "0"),
                state=state, on_step=on_step, push_every=push_every)
        else:
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
    from kubedl_tpu_torch.utils.compile_cache import (
        cache_entry_count, cache_events,
    )

    # the kernel builds this process loaded (hits) and compiled (misses)
    events = cache_events(since=cache["built_before"])
    summary["compile_cache"] = {
        "dir": cache["dir"],
        "entries_before": cache["entries_before"],
        "entries_after": cache_entry_count(cache["dir"]),
        "cache_hits": events["hits"],
        "cache_misses": events["misses"],
    }
    LAST_SUMMARY = summary
    print(json.dumps({"worker_summary": summary}), flush=True)
    if out:
        _publish(out, ckpt_dir, state, mesh)
    return 0


if __name__ == "__main__":
    sys.exit(train_main())
