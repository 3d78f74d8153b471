"""Checkpoint save (params) and restore in the reference's on-disk format.

Port of the restore side of ``kubedl_tpu/training/checkpoint.py`` and of
its single-process save, so that each package restores the other's
checkpoints. The format (``checkpoint.py:10-23``)::

    <ckpt_dir>/step-<N:08d>/
        meta.json            step, process count and the global shape /
                             dtype of every leaf, keyed by the JAX tree
                             path string (``['params']['layers']['wq']``)
        shards-p<pid>.npz    process pid's entries: a whole leaf under its
                             path, a shard under "<path>@<offs>+<shape>"
    <ckpt_dir>/latest        the marker, written last

Leaves are torch tensors. :func:`_leaf_items` walks nested dicts, lists,
tuples and named tuples in the order of ``jax.tree_util
.tree_flatten_with_path`` (dict keys sorted) and yields the same strings
as ``jax.tree_util.keystr``, so the manifest keys are the reference's.

bf16 without ``ml_dtypes``: the reference's ``np.savez`` writes bf16
leaves as two-byte void entries (``|V2``), and that is how they load in
a process that never imported ``ml_dtypes``; the manifest's
``"dtype": "bfloat16"`` is what says they are bf16. So the port reads
such an entry as its bits (int16, then a bf16 view) and writes bf16 the
same way.

Restore places every leaf on the device one at a time, from the npz
entry (or the shard entries) that hold it: the host never holds a copy
of the whole tree. A ``like`` tree of ``meta`` tensors describes the
target without allocating it.

The trainer's state is saved in the reference's tree
(:func:`train_state_tree`): ``['params'][...]``,
``['opt_state'][1][0].count`` / ``.mu[...]`` / ``.nu[...]`` (optax's
``ScaleByAdamState``), ``['opt_state'][1][2].count`` (the schedule's
``ScaleByScheduleState``) and ``['step']``, the counts int32 scalars, so
a job resumes from either package's checkpoint. Interval saves run off
the step loop (:class:`AsyncCheckpointer`: the device-to-host copy into
reused host buffers on the caller, the files on a writer thread, an
optional best-effort push to a peer's blob store), and a restart
restores from the local directory or a replica
(:func:`restore_from_best`).

Multi-process saves: each rank writes its own ``shards-p<rank>.npz``. A
leaf a rank holds a region of (a parameter split over fsdp / tensor, a
moment of it or of the sharded update) rides the tree as :class:`Sharded`
and is saved under the reference's shard key ``"<path>@<offs>+<shape>"``
(offsets and shape in every dimension) by the region's first replica;
rank 0 writes
the whole leaves. After its shard file is in place each rank passes a
barrier, and only then does rank 0 write the manifest (with ``nprocs``)
and, last, the ``latest`` marker. A restore assembles each leaf from
whatever shards cover it, and a :class:`Sharded` target reads only its
own region, so a save restores at any world size.
"""

from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import re
import shutil
import tempfile
import threading
import time
from collections import namedtuple
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from kubedl_tpu_torch import chaos
from kubedl_tpu_torch.parallel.mesh import ShardSpec

log = logging.getLogger("kubedl_tpu_torch.training.checkpoint")


# ---- tree paths --------------------------------------------------------------

class Sharded:
    """A leaf of a state tree that this rank holds a slice of: ``local``
    (the slice's tensor) and ``spec`` (where it sits in the global
    leaf)."""

    __slots__ = ("local", "spec")

    def __init__(self, local, spec: ShardSpec) -> None:
        self.local, self.spec = local, spec


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _leaf_items(state, prefix: str = ""):
    """``(keystr, leaf)`` for every leaf of ``state`` in JAX's flattening
    order: dict keys sorted, ``['k']`` for a dict key, ``[i]`` for a list
    or tuple index, ``.name`` for a named-tuple field; ``None`` and empty
    containers hold no leaf."""
    if state is None:
        return
    if isinstance(state, dict):
        for k in sorted(state):
            yield from _leaf_items(state[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(state):
        for name in state._fields:
            yield from _leaf_items(getattr(state, name), f"{prefix}.{name}")
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            yield from _leaf_items(v, f"{prefix}[{i}]")
    else:
        yield prefix, state


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from ``leaves`` (an iterator in
    :func:`_leaf_items` order)."""
    if like is None:
        return None
    if isinstance(like, dict):
        # fill in sorted order, then restore the original key order
        filled = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, n), leaves)
                            for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _shard_key(key: str, index, shape=None) -> str:
    """"<path>@<offsets>[+<dims>]": the shard's global offset, plus its
    shape so restore computes overlap without decompressing the entry."""
    offs = ",".join(str(s.start or 0) for s in index)
    if shape is None:
        return f"{key}@{offs}"
    return f"{key}@{offs}+" + "x".join(str(n) for n in shape)


# ---- dtypes: torch <-> npz entries -------------------------------------------

def _dtype_name(dtype: torch.dtype) -> str:
    """The manifest's dtype string (numpy's name; "bfloat16" for bf16)."""
    return str(dtype).replace("torch.", "")


def _to_torch(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A host tensor from an npz entry; a two-byte void (or ``ml_dtypes``)
    entry whose manifest says bfloat16 is read as bf16 bits. An array
    that owns its contiguous data (a region assembled from shards) is
    wrapped; any other (a view of a mapped file) is copied, so no tensor
    keeps a file mapped."""
    if not (arr.flags.c_contiguous and arr.flags.owndata):
        arr = np.array(arr, order="C")
    if dtype_name == "bfloat16" or arr.dtype.name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 entry of itemsize {arr.dtype.itemsize}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class MappedNpz:
    """The arrays of an uncompressed ``.npz`` (``np.savez``'s) as views
    of one read-only mapping of the file: an entry is read at the
    page cache's rate when it is touched, with no per-entry stream and
    no CRC pass (``np.load`` reads a member in 256 KB chunks and checks
    its CRC). A compressed member falls back to ``np.load``. Has
    ``np.load``'s ``files``, ``[name]`` and ``close()``."""

    def __init__(self, path) -> None:
        import zipfile
        from numpy.lib import format as npformat

        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        self._arrays: Dict[str, np.ndarray] = {}
        self._fallback = None
        with zipfile.ZipFile(path) as zf, open(path, "rb") as fh:
            for info in zf.infolist():
                name = info.filename[:-4] if info.filename.endswith(".npy") \
                    else info.filename
                if info.compress_type != zipfile.ZIP_STORED:
                    self._fallback = np.load(path)
                    self._arrays = {}
                    break
                # the local header: 30 bytes, then the name and the extra
                fh.seek(info.header_offset + 26)
                n_name, n_extra = np.frombuffer(fh.read(4), "<u2")
                fh.seek(info.header_offset + 30 + int(n_name) + int(n_extra))
                major, _ = npformat.read_magic(fh)
                read = npformat.read_array_header_1_0 if major == 1 \
                    else npformat.read_array_header_2_0
                shape, fortran, dtype = read(fh)
                start = fh.tell()
                n = int(np.prod(shape)) * dtype.itemsize
                arr = self._mm[start:start + n].view(dtype)
                self._arrays[name] = arr.reshape(
                    shape, order="F" if fortran else "C")
        self.files = list(self._fallback.files if self._fallback is not None
                          else self._arrays)

    def __getitem__(self, name: str) -> np.ndarray:
        if self._fallback is not None:
            return self._fallback[name]
        return self._arrays[name]

    def close(self) -> None:
        if self._fallback is not None:
            self._fallback.close()
        self._arrays, self._mm = {}, None


# ---- save --------------------------------------------------------------------

def snapshot_state(state, process_index: int = 0):
    """Device-to-host capture of what rank ``process_index`` saves of
    ``state`` (its shards; on rank 0 also every whole leaf) and the
    manifest: owned host copies, bf16 as its bits in a two-byte void
    array."""
    return _Staging(pin=False).snapshot(state, process_index)


def write_snapshot(ckpt_dir: str, shards: Dict[str, np.ndarray],
                   manifest: Dict[str, Any], step: int, pid: int,
                   nprocs: int, barrier: Optional[Callable] = None) -> str:
    """Persist a snapshot: the shard file (written to a temporary name,
    then renamed); then ``barrier()`` (every rank's shard file is in
    place past it); then on rank 0 the manifest and the marker. The
    chaos site ``checkpoint.torn`` sits between the shards and the
    manifest: a rank that dies there leaves shards without a manifest or
    marker, and a restore falls back to the previous complete step."""
    d = Path(ckpt_dir) / f"step-{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(d), suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **shards)
    os.replace(tmp, d / f"shards-p{pid}.npz")
    if barrier is not None:
        barrier()
    chaos.check("checkpoint.torn")
    if pid == 0:
        (d / "meta.json").write_text(
            json.dumps({"step": step, "nprocs": nprocs, "leaves": manifest})
        )
        (Path(ckpt_dir) / "latest").write_text(d.name)
    return str(d)


def save_checkpoint(ckpt_dir: str, state, step: int, process_index: int = 0,
                    nprocs: int = 1, barrier: Optional[Callable] = None
                    ) -> str:
    """Write rank ``process_index``'s part of ``state`` (a tree of tensors,
    e.g. ``{"params": params}``) as step ``step`` of a checkpoint of
    ``nprocs`` processes (``barrier`` as in :func:`write_snapshot`)."""
    shards, manifest = snapshot_state(state, process_index)
    return write_snapshot(ckpt_dir, shards, manifest, step, process_index,
                          nprocs, barrier)


def latest_step(ckpt_dir: str) -> Optional[int]:
    marker = Path(ckpt_dir) / "latest"
    if not marker.exists():
        return None
    m = re.match(r"step-(\d+)", marker.read_text().strip())
    return int(m.group(1)) if m else None


def checkpoint_fingerprint(ckpt_dir: str, step: Optional[int] = None) -> str:
    """Content fingerprint of one checkpoint step: sha256 over the
    manifest bytes plus every shard file's (name, sha256), in sorted
    order — the reference's function, byte for byte. Defaults to the step
    the ``latest`` marker names; "" when that step is incomplete (no
    manifest or no shard file)."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return ""
    d = Path(ckpt_dir) / f"step-{step:08d}"
    meta = d / "meta.json"
    shard_files = sorted(glob.glob(str(d / "shards-p*.npz")))
    if not meta.exists() or not shard_files:
        return ""
    h = hashlib.sha256()
    h.update(meta.read_bytes())
    for f in shard_files:
        h.update(Path(f).name.encode())
        fh = hashlib.sha256()
        with open(f, "rb") as fp:
            for chunk in iter(lambda: fp.read(1 << 20), b""):
                fh.update(chunk)
        h.update(fh.digest())
    return h.hexdigest()


# ---- restore -----------------------------------------------------------------

class IncompleteCheckpoint(Exception):
    """A step dir is missing shard data (e.g. preemption mid-save)."""


class _ShardStore:
    """Lazy view over every process's shard files for one step dir: npz
    entries are read only when a leaf needs them."""

    def __init__(self, d: Path) -> None:
        self.files = [MappedNpz(f)
                      for f in sorted(glob.glob(str(d / "shards-p*.npz")))]
        if not self.files:
            raise FileNotFoundError(f"no shard files under {d}")
        self.index: Dict[str, tuple] = {}
        for i, f in enumerate(self.files):
            for k in f.files:
                self.index[k] = (i, k)

    def close(self) -> None:
        for f in self.files:
            f.close()

    def _pieces(self, key: str):
        """``(offsets, shape or None, file, entry)`` of each shard entry of
        ``key``."""
        prefix = key + "@"
        for skey, (i, k) in self.index.items():
            if not skey.startswith(prefix):
                continue
            off_part, _, dim_part = skey[len(prefix):].partition("+")
            offs = [int(x) for x in off_part.split(",")]
            pshape = [int(x) for x in dim_part.split("x")] if dim_part \
                else None
            yield offs, pshape, i, k

    def validate_coverage(self, key: str, shape) -> None:
        """Global coverage from the shard keys alone (offsets and shapes
        ride the keys): a torn save fails before any leaf is read."""
        if key in self.index:
            return
        covered = 0
        for _offs, pshape, i, k in self._pieces(key):
            if pshape is None:  # legacy key without a shape: load it
                pshape = list(self.files[i][k].shape)
            covered += int(np.prod(pshape))
        total = int(np.prod(shape))
        if covered != total:
            raise IncompleteCheckpoint(
                f"leaf {key!r}: shards cover {covered} of {total} elements"
            )

    def full(self, key: str, shape) -> np.ndarray:
        """The whole leaf in its stored dtype, assembled from its entry or
        from the shard entries that cover it."""
        return self.region(key, shape, tuple(slice(0, n) for n in shape))

    def region(self, key: str, shape, index) -> np.ndarray:
        """The sub-array ``index`` (slices into the global ``shape``) in
        its stored dtype, from the entries that overlap it: a rank reads
        only the shard bytes it needs. Raises IncompleteCheckpoint unless
        the pieces cover every element of the region."""
        want = [(s.start or 0, n if s.stop is None else s.stop)
                for s, n in zip(index, shape)]
        if key in self.index:
            i, k = self.index[key]
            arr = self.files[i][k]
            if all(a == 0 and b == n for (a, b), n in zip(want, shape)):
                return arr
            return arr[tuple(slice(a, b) for a, b in want)]
        out = None
        covered = 0
        for offs, pshape, i, k in self._pieces(key):
            if pshape is None:  # legacy key without a shape: load it
                pshape = list(self.files[i][k].shape)
            lo = [max(o, a) for o, (a, _) in zip(offs, want)]
            hi = [min(o + n, b) for o, n, (_, b) in zip(offs, pshape, want)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue  # no overlap: the entry is never read
            piece = self.files[i][k]
            if out is None:
                out = np.zeros([b - a for a, b in want], dtype=piece.dtype)
            src = tuple(slice(a - o, b - o) for a, b, o in zip(lo, hi, offs))
            dst = tuple(slice(a - w, b - w)
                        for a, b, (w, _) in zip(lo, hi, want))
            out[dst] = piece[src]
            covered += int(np.prod([b - a for a, b in zip(lo, hi)]))
        size = int(np.prod([b - a for a, b in want]))
        if out is None or covered != size:
            raise IncompleteCheckpoint(
                f"leaf {key!r}: shards cover {covered} of {size} elements "
                f"of region {want}"
            )
        return out


def _available_steps(ckpt_dir: str):
    steps = []
    for p in Path(ckpt_dir).glob("step-*"):
        m = re.match(r"step-(\d+)$", p.name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps, reverse=True)


def restore_checkpoint(ckpt_dir: str, like, step: Optional[int] = None,
                       gc_torn: bool = False, device=None,
                       leaf_fn: Optional[Callable] = None):
    """Load into the structure of ``like`` (a tree of tensors; ``meta``
    tensors describe it without memory). Each leaf takes its ``like``
    leaf's dtype and lands on ``device`` (default: the ``like`` leaf's
    device); ``leaf_fn(key, tensor)``, when given, maps each leaf as it
    lands (e.g. quantizes it), so the tree is never held twice. Returns
    None when the dir holds no complete checkpoint.

    With no explicit ``step``, tries the newest step dir first and falls
    back to older ones (a save torn by preemption must not block a
    resume); ``gc_torn=True`` deletes the torn newer dirs skipped over by
    a successful fallback (single process only)."""
    candidates = [step] if step is not None else _available_steps(ckpt_dir)
    last_err: Optional[Exception] = None
    torn: list = []
    for cand in candidates:
        try:
            state = _restore_step(ckpt_dir, like, cand, device, leaf_fn)
        except (IncompleteCheckpoint, FileNotFoundError, KeyError) as e:
            if step is not None:
                raise
            last_err = e
            torn.append(cand)
            continue
        if gc_torn and torn:
            for t in torn:
                shutil.rmtree(Path(ckpt_dir) / f"step-{t:08d}",
                              ignore_errors=True)
            log.warning("restored step %d; garbage-collected %d torn newer "
                        "step dir(s): %s", cand, len(torn), torn)
        return state
    if last_err is not None:
        log.warning("no complete checkpoint under %s (last error: %s)",
                    ckpt_dir, last_err)
    return None


def _restore_step(ckpt_dir: str, like, step: int, device=None,
                  leaf_fn: Optional[Callable] = None):
    d = Path(ckpt_dir) / f"step-{step:08d}"
    meta_file = d / "meta.json"
    if not meta_file.exists():
        raise IncompleteCheckpoint(f"{d} has no manifest")
    meta = json.loads(meta_file.read_text())
    store = _ShardStore(d)
    try:
        nprocs = int(meta.get("nprocs", 1))
        if len(store.files) < nprocs:
            raise IncompleteCheckpoint(
                f"{d}: {len(store.files)} of {nprocs} process shard files "
                "present"
            )
        leaves_meta = meta.get("leaves", {})
        items = list(_leaf_items(like))
        # coverage of every leaf first, from the keys alone: a torn save
        # fails before anything is read or allocated
        for key, leaf in items:
            spec = leaf.spec if isinstance(leaf, Sharded) else None
            store.validate_coverage(
                key, spec.shape if spec else tuple(leaf.shape))
        out = []
        for key, leaf in items:
            spec = leaf.spec if isinstance(leaf, Sharded) else None
            if spec is not None:  # this rank's region only
                arr = store.region(key, spec.shape, spec.index)
                leaf, want = leaf.local, spec.local_shape
            else:
                want = tuple(leaf.shape)
                arr = store.full(key, want)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"leaf {key!r}: checkpoint shape {tuple(arr.shape)} != "
                    f"{want}"
                )
            host = _to_torch(arr, leaves_meta.get(key, {}).get("dtype", ""))
            del arr
            if isinstance(leaf, torch.Tensor):
                dev = device if device is not None else leaf.device
                t = host.to(device=dev, dtype=leaf.dtype)
            else:
                t = host.to(dtype=_to_torch(np.asarray(leaf), "").dtype)
            del host
            t = leaf_fn(key, t) if leaf_fn is not None else t
            out.append(t if spec is None else Sharded(t, spec))
    finally:
        store.close()
    return _unflatten(like, iter(out))


# ---- the train state in the reference's tree ------------------------------------

#: optax's state types, as the reference's tree holds them: the chain
#: ``clip_by_global_norm -> adamw`` is ``(EmptyState(), (ScaleByAdamState,
#: EmptyState(), ScaleByScheduleState))``
EmptyState = namedtuple("EmptyState", [])
ScaleByAdamState = namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
ScaleByScheduleState = namedtuple("ScaleByScheduleState", ["count"])


def train_state_tree(state, leaf: Optional[Callable] = None):
    """The port's train state (``{"params", "opt_state": {"count", "mu":
    [...], "nu": [...], "shards"?}, "step", "param_shards"?}``) as the
    reference's tree, a shard as :class:`Sharded`, its tensors
    mapped through ``leaf`` (default: the state's own tensors, to save
    them; :func:`train_state_like` gives ``meta`` tensors, to restore).
    The moments' lists follow ``tree_leaves(params)``, the reference's
    order; the counts become int32 scalars."""
    from kubedl_tpu_torch.training.trainer import tree_leaves, tree_unflatten

    f = leaf or (lambda t: t)
    params, opt = state["params"], state["opt_state"]
    count = np.int32(opt["count"])

    def tree(ts, specs):  # a shard rides the tree as Sharded
        specs = specs or [None] * len(ts)
        return tree_unflatten(params, [
            f(t) if s is None else Sharded(f(t), s)
            for t, s in zip(ts, specs)])

    adam = ScaleByAdamState(count, tree(opt["mu"], opt.get("shards")),
                            tree(opt["nu"], opt.get("shards")))
    return {
        "params": tree(tree_leaves(params), state.get("param_shards")),
        "opt_state": (EmptyState(),
                      (adam, EmptyState(), ScaleByScheduleState(count))),
        "step": np.int32(state["step"]),
    }


def train_state_like(state):
    """:func:`train_state_tree` of ``meta`` tensors: a restore template
    that allocates nothing."""
    return train_state_tree(
        state, leaf=lambda t: torch.empty_like(t, device="meta"))


def train_state_from_tree(tree):
    """The inverse of :func:`train_state_tree` (e.g. on a restored tree)."""
    from kubedl_tpu_torch.training.trainer import tree_leaves, tree_unflatten

    def local(ts):  # (this rank's tensors, their Sharded specs)
        specs = [t.spec if isinstance(t, Sharded) else None for t in ts]
        return [t.local if s else t for t, s in zip(ts, specs)], specs

    adam = tree["opt_state"][1][0]
    mu, specs = local(tree_leaves(adam.mu))
    nu, _ = local(tree_leaves(adam.nu))
    p, pspecs = local(tree_leaves(tree["params"]))
    opt = {"count": int(adam.count), "mu": mu, "nu": nu}
    if any(specs):
        opt["shards"] = specs
    state = {"params": tree_unflatten(tree["params"], p), "opt_state": opt,
             "step": int(tree["step"])}
    if any(pspecs):
        state["param_shards"] = pspecs
    return state


# ---- asynchronous saves ---------------------------------------------------------

class _Staging:
    """Host buffers a snapshot lands in, one a leaf. An
    :class:`AsyncCheckpointer` keeps its own across saves, pinned for
    CUDA leaves (the copies run at the link's rate without a fresh
    page-locked allocation each time), and reuses a buffer only after
    the previous save's writer has finished with it: at most one save is
    in flight. :func:`snapshot_state` takes fresh pageable ones."""

    def __init__(self, pin: bool = True) -> None:
        self.pin = pin
        self.bufs: Dict[str, torch.Tensor] = {}

    def snapshot(self, state, pid: int = 0):
        """``(shards, manifest)`` of what rank ``pid`` saves: its
        :class:`Sharded` slices that it writes, and on rank 0 every whole
        leaf."""
        shards: Dict[str, np.ndarray] = {}
        manifest: Dict[str, Any] = {}
        on_cuda = False
        for key, leaf in _leaf_items(state):
            if isinstance(leaf, Sharded):
                spec, leaf = leaf.spec, leaf.local
                manifest[key] = {"shape": list(spec.shape),
                                 "dtype": _dtype_name(leaf.dtype)}
                if not spec.write:
                    continue
                name = _shard_key(key, spec.index, spec.local_shape)
            elif not isinstance(leaf, torch.Tensor):
                a = np.asarray(leaf)
                manifest[key] = {"shape": list(a.shape), "dtype": str(a.dtype)}
                if pid == 0:
                    shards[key] = np.array(a)
                continue
            else:
                manifest[key] = {"shape": list(leaf.shape),
                                 "dtype": _dtype_name(leaf.dtype)}
                if pid != 0:
                    continue
                name = key
            buf = self.bufs.get(key)
            if buf is None or buf.shape != leaf.shape or \
                    buf.dtype != leaf.dtype:
                buf = torch.empty(leaf.shape, dtype=leaf.dtype,
                                  pin_memory=self.pin and leaf.is_cuda)
                self.bufs[key] = buf
            buf.copy_(leaf.detach(), non_blocking=buf.is_pinned())
            on_cuda = on_cuda or leaf.is_cuda
            shards[name] = (buf.view(torch.int16).numpy().view("V2")
                            if buf.dtype == torch.bfloat16 else buf.numpy())
        if on_cuda:
            torch.cuda.synchronize()  # the copies have landed
        return shards, manifest


class AsyncCheckpointer:
    """Interval saves off the step loop, with optional peer replication
    (the reference's class, ``kubedl_tpu/training/checkpoint.py:391``).

    ``save(state, step)`` blocks only for (a) the previous write to
    finish (at most one save in flight: snapshots are host memory) and
    (b) the device-to-host snapshot; the npz, manifest and marker writes
    and the peer push run on a writer thread. ``wait_for_pending()`` is
    the barrier a clean exit takes before trusting ``latest``; it
    re-raises the writer's error. ``peer_url`` (a blob root,
    ``http://host:port/blobs/...``) mirrors each completed step dir to
    another host: best-effort, a dead peer degrades durability, never
    training. ``process_index`` / ``nprocs`` / ``barrier``: this rank's
    part of a multi-process save (:func:`write_snapshot`); the barrier
    runs on the writer thread, so it must be callable from there."""

    def __init__(self, ckpt_dir: str, peer_url: str = "",
                 process_index: int = 0, nprocs: int = 1,
                 barrier: Optional[Callable] = None) -> None:
        self.ckpt_dir = ckpt_dir
        self.peer_url = peer_url.rstrip("/") if peer_url else ""
        self._pid, self._nprocs = process_index, nprocs
        self._barrier = barrier
        self._staging = _Staging()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: step of the most recently ENQUEUED save
        self.last_saved_step: Optional[int] = None
        #: seconds save() blocked its caller, summed
        self.stall_seconds = 0.0
        self.saves = 0
        self.peer_pushes = 0

    def save(self, state, step: int) -> None:
        t0 = time.perf_counter()
        try:
            self.wait_for_pending()  # backpressure; surfaces prior errors
            shards, manifest = self._staging.snapshot(state, self._pid)
            self._thread = threading.Thread(
                target=self._write, args=(shards, manifest, step),
                daemon=True, name="kubedl-ckpt-writer")
            self._thread.start()
            self.last_saved_step = step
            self.saves += 1
        finally:
            self.stall_seconds += time.perf_counter() - t0

    def _write(self, shards, manifest, step) -> None:
        try:
            write_snapshot(self.ckpt_dir, shards, manifest, step, self._pid,
                           self._nprocs, self._barrier)
        except BaseException as e:  # noqa: BLE001 -- re-raised at the barrier
            self._error = e
            return
        if self.peer_url:
            self._push_to_peer(step)

    def _push_to_peer(self, step: int) -> None:
        from kubedl_tpu_torch.remote import client as remote

        d = Path(self.ckpt_dir) / f"step-{step:08d}"
        try:
            remote.upload_tree(str(d), f"{self.peer_url}/{d.name}")
            if self._pid == 0:
                # the marker last, as locally: a reader following the
                # replica's `latest` finds a fully uploaded step dir
                base, prefix = remote._split(self.peer_url)
                key = f"{prefix}/latest" if prefix else "latest"
                remote.put_blob(base, key, d.name.encode())
            self.peer_pushes += 1
        except Exception as e:  # best-effort: degraded durability only
            log.warning("peer replication of step %d to %s failed: %s",
                        step, self.peer_url, e)

    def wait_for_pending(self) -> None:
        """Join the in-flight write; re-raise its failure (a save the
        caller believes happened must not silently not exist)."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.wait_for_pending()


def restore_from_best(ckpt_dir: str, like, sources: Sequence[str] = (),
                      step: Optional[int] = None, device=None):
    """Restore with the replica preference order: the local dir first,
    then each remote source (a peer replica, a blob store) mirrored INTO
    the local dir and retried. None only when every source is exhausted
    (the reference's function, ``checkpoint.py:498``)."""
    state = restore_checkpoint(ckpt_dir, like, step=step, device=device)
    if state is not None:
        return state
    for src in sources:
        if not src:
            continue
        from kubedl_tpu_torch.remote.client import download_tree

        try:
            n = download_tree(src, ckpt_dir)
        except Exception as e:
            log.warning("checkpoint source %s unreachable: %s", src, e)
            continue
        if n <= 0:
            continue
        state = restore_checkpoint(ckpt_dir, like, step=step, device=device)
        if state is not None:
            log.warning("restored from replica %s (%d files): the local "
                        "checkpoint dir was missing or torn", src, n)
            return state
    return None


__all__ = ["save_checkpoint", "snapshot_state", "write_snapshot",
           "latest_step", "checkpoint_fingerprint", "restore_checkpoint",
           "IncompleteCheckpoint", "train_state_tree", "train_state_like",
           "train_state_from_tree", "AsyncCheckpointer",
           "restore_from_best", "Sharded", "MappedNpz"]
