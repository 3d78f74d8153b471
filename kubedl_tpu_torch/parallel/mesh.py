"""Mesh construction and distributed bootstrap: the port of
``kubedl_tpu/parallel/mesh.py``.

The consumer side of the operator's env contract: a worker process calls
:func:`initialize_from_env` (``torch.distributed`` from the ``KUBEDL_*``
variables the reference's ``jax.distributed.initialize`` reads) and
:func:`mesh_from_env` for the logical mesh the job asked for
(``KUBEDL_MESH_AXES``), in :class:`MeshSpec`'s axis order: one rank a
device, ranks laid out row-major over the ordered axes, as the reference
reshapes its device list.

**The backend is a rule, not a knob.** The first group is gloo (the
rendezvous, and the exchange the rule needs). Then each rank names its
(host, device UUID): NCCL when every rank has a card of its own, gloo on
the CPU and when ranks share a card (NCCL refuses two ranks on one
device). A NCCL group that fails to start raises; nothing falls back to
gloo. Gloo on CUDA tensors is staged explicitly through pinned host
buffers (device-to-host copy, the collective on the host, host-to-device
copy): the compute stays on the card. That staging and the collective
are timed on the host (:attr:`ProcessMesh.seconds`; the staging's sync
also waits for the device work queued before it); a NCCL collective is
not timed (reading its time would need a host sync inside the step).

:class:`ServingMesh` is the serving engine's mesh: every rank in one
process, its collectives copies between the ranks' devices.

Every axis of :class:`MeshSpec` runs: the model-sharding axes ``fsdp``,
``tensor``, ``sp``, ``expert`` (``models/llama.py``'s
:class:`~kubedl_tpu_torch.models.llama.TrainShard`, ``models/moe.py``'s
``MoEShard``) and ``pipe`` (GPipe stages, ``parallel/pipeline.py``). An
axis name outside that set raises ``ValueError`` (:func:`check_axes`).

The collectives the reference's ``shard_map`` bodies use, each over a
tuple of axes: ``all_reduce``, ``all_gather`` and ``reduce_scatter``
(flat, in place of ``psum`` / ``all_gather`` / ``psum_scatter``),
``ppermute`` (a ring shift, paired ``isend`` / ``irecv``) and
``all_to_all``. Each has a ``torch.autograd.Function`` whose backward is
its transpose (:func:`gather_dim`, whose backward reduce-scatters;
Megatron's :func:`copy_to` / :func:`reduce_from`;
:func:`gather_replicated`; :func:`shift`; :func:`all_to_all`). They run their collective with the
dispatch modes off, so a selective-checkpoint policy neither saves nor
skips it: a remat'ed layer runs its collectives again when it is
recomputed (an fsdp layer's weights are gathered again, not held).
``ProcessMesh`` stays in place of ``DeviceMesh`` / FSDP2: two ranks that
share a card must use gloo, which has no ``all_gather_into_tensor`` /
``reduce_scatter_tensor`` on CUDA tensors, so every collective is staged
through the pooled pinned buffers here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import math
import os
import socket
import time
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from kubedl_tpu_torch import resolve_device
# the env names the bootstrap reads
from kubedl_tpu_torch.api.constants import (
    ENV_COORDINATOR_ADDRESS, ENV_MESH_AXES, ENV_NUM_PROCESSES, ENV_PROCESS_ID,
)
from kubedl_tpu_torch.api.topology import MeshSpec


#: Axes a batch dimension is sharded over (all data-parallel-like axes).
DATA_AXES = ("replica", "data", "fsdp")
#: The sequence/context-parallel mesh axis (ring attention shards over it).
SEQUENCE_AXIS = "sp"
#: the mesh axes this port shards over (another name above 1 raises: see
#: :func:`check_axes`)
PORTED_AXES = ("replica", "data", "fsdp", "pipe", "expert", "sp", "tensor")
#: seconds a rendezvous or a collective may wait for its peers
TIMEOUT_S = 300.0


def initialize_from_env(environ: Optional[Mapping[str, str]] = None,
                        timeout_s: float = TIMEOUT_S) -> bool:
    """``torch.distributed.init_process_group`` over gloo from the
    operator-injected env (``environ``, default ``os.environ``): the
    coordinator's ``host:port``, the process count and this process's
    id. A no-op (False) when the job is single-process."""
    env = os.environ if environ is None else environ
    n = int(env.get(ENV_NUM_PROCESSES, "1") or 1)
    if n <= 1:
        return False
    dist.init_process_group(
        "gloo", init_method=f"tcp://{env[ENV_COORDINATOR_ADDRESS]}",
        world_size=n, rank=int(env[ENV_PROCESS_ID]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def world() -> Tuple[int, int]:
    """``(rank, world size)``; ``(0, 1)`` without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when asked for, else
    ``cuda:<rank % device_count>`` (which becomes the current device)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    rank, _ = world()
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def collective_backend(device: torch.device) -> str:
    """The rule: "nccl" when every rank has a card of its own, "gloo" on
    the CPU or when ranks share a card (each rank's (host, device UUID),
    gathered over the first gloo group)."""
    _, n = world()
    if device.type != "cuda" or n <= 1:
        return "gloo"
    me = (socket.gethostname(), str(torch.cuda.get_device_properties(
        device).uuid))
    everyone = [None] * n
    dist.all_gather_object(everyone, me)
    return "nccl" if len(set(everyone)) == n else "gloo"


@dataclass(frozen=True)
class ShardSpec:
    """Where a rank's slice of a leaf sits: the region ``starts[d]:
    stops[d]`` of every dimension d of a leaf of global ``shape``.
    ``write``: this rank saves the slice to a checkpoint (the slice's first
    replica, as the reference's ``replica_id == 0``)."""

    shape: Tuple[int, ...]
    starts: Tuple[int, ...]
    stops: Tuple[int, ...]
    write: bool = True

    @property
    def index(self) -> Tuple[slice, ...]:
        return tuple(slice(a, b) for a, b in zip(self.starts, self.stops))

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in zip(self.starts, self.stops))

    def narrow(self, dim: int, start: int, length: int) -> "ShardSpec":
        """The sub-region rows ``start:start + length`` (local to this
        region) of dimension ``dim``."""
        starts, stops = list(self.starts), list(self.stops)
        starts[dim] += start
        stops[dim] = starts[dim] + length
        return dataclasses.replace(self, starts=tuple(starts),
                                   stops=tuple(stops))

    def take(self, t):
        """This region of the whole leaf ``t`` (a view)."""
        for d, (a, b) in enumerate(zip(self.starts, self.stops)):
            if (a, b) != (0, self.shape[d]):
                t = t.narrow(d, a, b - a)
        return t


# torch 2.13 names the flat collectives ``*_single`` and deprecates the
# older names, which are all that earlier releases (2.11, say) have
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    getattr(dist, "reduce_scatter_tensor", None)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    getattr(dist, "all_gather_into_tensor", None)


class _Pending:
    """An asynchronous collective: ``wait()`` finishes it (and, when
    staged, copies the host result back to the card)."""

    def __init__(self, mesh: "ProcessMesh", kind: str, work, after=None):
        self.mesh, self.kind, self.work, self.after = mesh, kind, work, after

    def wait(self) -> None:
        t0 = time.perf_counter()
        self.work.wait()
        if self.after is not None:
            self.after()
        self.mesh._account(self.kind, t0)


class ProcessMesh:
    """The logical mesh over the job's processes: the counterpart of the
    reference's ``jax.sharding.Mesh`` (``axis_names``, ``shape``) that
    holds the process group of each axis and runs the collectives the
    trainer needs over a tuple of axes. One rank a device; a mesh of one
    process has no groups and its collectives are the identity.
    ``alone``: a mesh of this process only, whatever group the job has
    (:func:`local_mesh`)."""

    def __init__(self, spec: MeshSpec, device: torch.device,
                 backend: str = "gloo", alone: bool = False) -> None:
        self.rank, self.world = (0, 1) if alone else world()
        ordered = spec.ordered()
        self.axis_names = tuple(a for a, _ in ordered)
        self.shape: Dict[str, int] = dict(ordered)
        self.device = device
        self.backend = backend if self.world > 1 else ""
        sizes = [s for _, s in ordered]
        self.coords = dict(zip(self.axis_names, _unravel(self.rank, sizes)))
        self.seconds: Dict[str, float] = {}
        #: collectives issued, by kind
        self.calls: Dict[str, int] = {}
        self._pool: Dict[tuple, list] = {}
        self._groups: Dict[Tuple[str, ...], object] = {}
        if self.world > 1:
            # a group for every set of axes above 1 (mesh order): the
            # trainer reduces over the batch axes, the sequence axis and
            # the axes a leaf is not sharded over, in their combinations
            on = self.active(self.axis_names)
            for n in range(1, len(on) + 1):
                for axes in itertools.combinations(on, n):
                    self._groups[axes] = self._new_groups(axes, backend)
            # the checkpoint writers' barrier runs on threads of its own:
            # a group of its own, so it never interleaves with the step's
            self._barrier_group = dist.new_group(list(range(self.world)),
                                                 backend="gloo")
            if backend == "nccl":  # surface a NCCL that cannot start now
                for g in set(self._groups.values()):
                    probe = torch.ones(1, device=device)
                    dist.all_reduce(probe, group=g)
                torch.cuda.synchronize(device)

    # ---- layout ---------------------------------------------------------------

    def active(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """The axes of ``axes`` this mesh has above size 1, in mesh order."""
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major position along ``axes`` (mesh order)."""
        i = 0
        for a in self.axis_names:
            if a in axes:
                i = i * self.shape[a] + self.coords[a]
        return i

    def _new_groups(self, axes: Tuple[str, ...], backend: str):
        """Every group of ranks that vary along ``axes`` (the other
        coordinates fixed), made in one order on every rank as
        ``new_group`` requires; returns this rank's."""
        sizes = [self.shape[a] for a in self.axis_names]
        fixed = [range(1) if a in axes else range(self.shape[a])
                 for a in self.axis_names]
        mine = None
        for base in itertools.product(*fixed):
            ranks = []
            for along in itertools.product(*[range(self.shape[a])
                                             for a in axes]):
                c = dict(zip(self.axis_names, base))
                c.update(zip(axes, along))
                ranks.append(_ravel([c[a] for a in self.axis_names], sizes))
            g = dist.new_group(sorted(ranks), backend=backend)
            if self.rank in ranks:
                mine = g
        return mine

    def _group(self, axes: Sequence[str]):
        return self._groups[self.active(axes)]

    def peer(self, axis: str, shift: int) -> int:
        """The global rank ``shift`` places along ``axis`` from this one
        (cyclic), the other coordinates fixed."""
        c = dict(self.coords)
        c[axis] = (c[axis] + shift) % self.shape[axis]
        return _ravel([c[a] for a in self.axis_names],
                      [self.shape[a] for a in self.axis_names])

    # ---- collectives ----------------------------------------------------------

    def _account(self, kind: str, t0: float) -> None:
        if self.backend == "gloo":
            self.seconds[kind] = self.seconds.get(kind, 0.0) + \
                time.perf_counter() - t0

    def _host(self, like: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer shaped as ``like``, from the pool (a
        returned buffer is reused once its host-to-device copy is done)."""
        free = self._pool.setdefault((like.dtype, like.numel()), [])
        if free:
            buf, done = free.pop()
            done.synchronize()
            return buf.view(like.shape)
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def _give(self, *bufs: torch.Tensor) -> None:
        done = torch.cuda.Event()
        done.record()
        for b in bufs:
            self._pool.setdefault((b.dtype, b.numel()), []).append(
                (b.reshape(-1), done))

    def _run(self, kind: str, fn, out: torch.Tensor, inp: torch.Tensor,
             axes: Sequence[str], async_op: bool):
        """``fn(out, inp, group, async_op)`` over the group of ``axes``;
        staged through pinned host buffers for gloo on the card."""
        t0 = time.perf_counter()
        self.calls[kind] = self.calls.get(kind, 0) + 1
        group = self._group(axes)
        if not (self.backend == "gloo" and inp.is_cuda):
            work = fn(out, inp, group, async_op)
            if not async_op:
                self._account(kind, t0)
                return None
            return _Pending(self, kind, work)
        h_in = self._host(inp)
        h_in.copy_(inp, non_blocking=True)
        h_out = h_in if out is inp else self._host(out)
        torch.cuda.current_stream(inp.device).synchronize()  # h_in landed
        work = fn(h_out, h_in, group, True)

        def after():
            out.copy_(h_out, non_blocking=True)
            self._give(*{id(b): b for b in (h_in, h_out)}.values())

        pending = _Pending(self, kind, work, after)
        self._account(kind, t0)
        if async_op:
            return pending
        pending.wait()
        return None

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str]) -> None:
        """Sum ``t`` in place over the ranks along ``axes``."""
        if self.size(self.active(axes)) > 1:
            self._run("all_reduce",
                      lambda o, i, g, a: dist.all_reduce(o, group=g,
                                                         async_op=a),
                      t, t, axes, False)

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor,
                       axes: Sequence[str], async_op: bool = False):
        """``out`` (``inp.numel() / n`` elements) = this rank's block of
        ``inp`` summed over the n ranks along ``axes``."""
        return self._run("reduce_scatter",
                         lambda o, i, g, a: _REDUCE_SCATTER(
                             o, i, group=g, async_op=a),
                         out, inp, axes, async_op)

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor,
                   axes: Sequence[str], async_op: bool = False):
        """``out`` = every rank's ``inp`` along ``axes``, in rank order."""
        return self._run("all_gather",
                         lambda o, i, g, a: _ALL_GATHER(
                             o, i, group=g, async_op=a),
                         out, inp, axes, async_op)

    def ppermute(self, t: torch.Tensor, axis: str,
                 shift: int = 1) -> torch.Tensor:
        """The ``t`` of the rank ``shift`` places back along ``axis``
        (this rank's goes ``shift`` places on): the reference's
        ``lax.ppermute`` over the ring ``i -> i + shift``, as a paired
        ``isend`` / ``irecv``."""
        if self.shape.get(axis, 1) <= 1:
            return t
        t0 = time.perf_counter()
        self.calls["ppermute"] = self.calls.get("ppermute", 0) + 1
        group = self._group((axis,))
        dst, src = self.peer(axis, shift), self.peer(axis, -shift)
        # gloo sends and receives dense buffers only (a gradient that
        # reaches the backward's inverse shift may be strided)
        t = t.contiguous()
        out = torch.empty_like(t)
        send, recv = t, out
        if self.backend == "gloo" and t.is_cuda:
            send, recv = self._host(t), self._host(t)
            send.copy_(t, non_blocking=True)
            torch.cuda.current_stream(t.device).synchronize()
        ops = [dist.P2POp(dist.isend, send, dst, group),
               dist.P2POp(dist.irecv, recv, src, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if recv is not out:
            out.copy_(recv, non_blocking=True)
            self._give(send, recv)
        self._account("ppermute", t0)
        return out

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """The reference's tiled ``lax.all_to_all``: ``t`` cut into n
        blocks along ``split_dim``, block j sent to the j-th rank along
        ``axis``, and the n blocks received concatenated along
        ``concat_dim`` in rank order."""
        n = self.shape.get(axis, 1)
        if n <= 1:
            return t
        k = t.shape[split_dim] // n
        # [n, ...]: block j of the split dimension first
        blocks = t.unflatten(split_dim, (n, k)).movedim(split_dim, 0)
        inp = blocks.contiguous()
        out = torch.empty_like(inp)
        self._run("all_to_all",
                  lambda o, i, g, a: dist.all_to_all_single(
                      o, i, group=g, async_op=a),
                  out, inp, (axis,), False)
        # out[j] is rank j's block (shaped as t with k at split_dim):
        # concatenated along concat_dim, block j at j
        return out.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)

    def barrier(self) -> None:
        """Every rank has reached this point (on the checkpoint writers'
        own group; callable from a writer thread)."""
        if self.world > 1:
            dist.barrier(group=self._barrier_group)


# ---- the collectives as autograd functions ---------------------------------------

@contextlib.contextmanager
def _modes_off():
    """Run a collective outside any dispatch mode: a selective-checkpoint
    policy then neither saves its result nor skips it, so a recomputed
    layer runs it again."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


def _n(mesh: ProcessMesh, axes: Sequence[str]) -> int:
    return mesh.size(mesh.active(axes))


def _gather(mesh: ProcessMesh, t: torch.Tensor, axes, dim: int):
    """Every rank's ``t`` along ``axes``, concatenated along ``dim`` in
    rank order."""
    n = _n(mesh, axes)
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    with _modes_off():
        mesh.all_gather(out.view(-1), x.view(-1), axes)
    return out.movedim(0, dim)


def _scatter(mesh: ProcessMesh, t: torch.Tensor, axes, dim: int):
    """This rank's block along ``dim`` of ``t`` summed over ``axes``."""
    n = _n(mesh, axes)
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    with _modes_off():
        mesh.reduce_scatter(out.view(-1), x.view(-1), axes)
    # a gradient in the shard's own layout (the optimizer kernels take
    # contiguous leaves)
    return out.movedim(0, dim).contiguous()


def _summed(mesh: ProcessMesh, t: torch.Tensor, axes):
    out = t.clone(memory_format=torch.contiguous_format)
    with _modes_off():
        mesh.all_reduce(out, axes)
    return out


def _own(mesh: ProcessMesh, t: torch.Tensor, axes, dim: int):
    """This rank's block along ``dim`` of ``t`` (a copy)."""
    k = t.shape[dim] // _n(mesh, axes)
    return t.narrow(dim, mesh.index(mesh.active(axes)) * k, k).contiguous()


class _GatherDim(torch.autograd.Function):
    """All-gather along a dimension; backward: reduce-scatter."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _gather(mesh, t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(ctx.args[0], g, *ctx.args[1:]), None, None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather along a dimension for a computation every rank of
    ``axes`` repeats on the same inputs; backward: this rank's block
    of the (equal) gradients."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _gather(mesh, t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(ctx.args[0], g, *ctx.args[1:]), None, None, None


class _CopyTo(torch.autograd.Function):
    """Megatron's f: identity; backward: all-reduce."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.args = (mesh, axes)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _summed(ctx.args[0], g, ctx.args[1]), None, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: all-reduce; backward: identity."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        return _summed(mesh, t, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Shift(torch.autograd.Function):
    """``ppermute`` by ``shift`` along an axis; backward: the inverse
    shift."""

    @staticmethod
    def forward(ctx, t, mesh, axis, shift):
        ctx.args = (mesh, axis, shift)
        with _modes_off():
            return mesh.ppermute(t, axis, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, shift = ctx.args
        with _modes_off():
            return mesh.ppermute(g, axis, -shift), None, None, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` (split one dimension, concatenate another);
    backward: the inverse ``all_to_all``."""

    @staticmethod
    def forward(ctx, t, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        with _modes_off():
            return mesh.all_to_all(t, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        with _modes_off():
            return (mesh.all_to_all(g, axis, concat_dim, split_dim), None,
                    None, None, None)


def gather_dim(t: torch.Tensor, mesh: ProcessMesh, axes: Sequence[str],
               dim: int) -> torch.Tensor:
    """``t`` of every rank along ``axes`` concatenated along ``dim`` (an
    fsdp shard gathered to the whole weight); its gradient is
    reduce-scattered back to the shard."""
    if _n(mesh, axes) <= 1:
        return t
    return _GatherDim.apply(t, mesh, tuple(axes), dim)


def gather_replicated(t: torch.Tensor, mesh: ProcessMesh,
                      axes: Sequence[str], dim: int) -> torch.Tensor:
    """As :func:`gather_dim`, for a value every rank along ``axes`` then
    uses in the same computation (a vocab-sharded head or embedding under
    tensor parallelism): the gradient is this rank's block, not a sum."""
    if _n(mesh, axes) <= 1:
        return t
    return _GatherReplicated.apply(t, mesh, tuple(axes), dim)


def copy_to(t: torch.Tensor, mesh: ProcessMesh,
            axes: Sequence[str]) -> torch.Tensor:
    """Megatron's f before a column-parallel product: identity, the
    gradient all-reduced over ``axes``."""
    if _n(mesh, axes) <= 1:
        return t
    return _CopyTo.apply(t, mesh, tuple(axes))


def reduce_from(t: torch.Tensor, mesh: ProcessMesh,
                axes: Sequence[str]) -> torch.Tensor:
    """Megatron's g after a row-parallel product: the partial sums
    all-reduced over ``axes`` (the reference's ``lax.psum``); the
    gradient passes through."""
    if _n(mesh, axes) <= 1:
        return t
    return _ReduceFrom.apply(t, mesh, tuple(axes))


def shift(t: torch.Tensor, mesh: ProcessMesh, axis: str,
          by: int = 1) -> torch.Tensor:
    """The reference's ``lax.ppermute(t, axis, [(i, i + by)])``,
    differentiable."""
    if mesh.shape.get(axis, 1) <= 1:
        return t
    return _Shift.apply(t, mesh, axis, by)


def all_to_all(t: torch.Tensor, mesh: ProcessMesh, axis: str,
               split_dim: int, concat_dim: int) -> torch.Tensor:
    """The reference's tiled ``lax.all_to_all``, differentiable."""
    if mesh.shape.get(axis, 1) <= 1:
        return t
    return _AllToAll.apply(t, mesh, axis, split_dim, concat_dim)


def _unravel(i: int, sizes: Sequence[int]):
    out = []
    for s in reversed(sizes):
        out.append(i % s)
        i //= s
    return tuple(reversed(out))


def _ravel(coords: Sequence[int], sizes: Sequence[int]) -> int:
    i = 0
    for c, s in zip(coords, sizes):
        i = i * s + c
    return i


def check_axes(spec: MeshSpec) -> None:
    """Raise ``ValueError`` for an axis above 1 that is none of
    :data:`PORTED_AXES` (no rule of the trainer names it)."""
    for a, s in spec.ordered():
        if s > 1 and a not in PORTED_AXES:
            raise ValueError(f"mesh axis {a}={s}: not an axis the trainer "
                             f"shards over (one of {PORTED_AXES})")


def build_mesh(spec: Optional[MeshSpec] = None,
               device=None) -> ProcessMesh:
    """The :class:`ProcessMesh` of ``spec`` over this job's processes (one
    a device). With no spec, every process becomes a 1-axis "data" mesh.
    Axes of size 1 are kept so rules can always name them."""
    _, n = world()
    if spec is None or not spec.axes:
        spec = MeshSpec({"data": n})
    check_axes(spec)
    if spec.size() != n:
        raise ValueError(f"mesh {dict(spec.ordered())} needs {spec.size()} "
                         f"devices, have {n}")
    dev = rank_device(device)
    return ProcessMesh(spec, dev, collective_backend(dev))


def local_mesh(device=None) -> ProcessMesh:
    """The one-process mesh on ``device``: this process alone, with no
    collectives to run, also inside a job's process group."""
    return ProcessMesh(MeshSpec({"data": 1}), resolve_device(device),
                       alone=True)


class ServingMesh:
    """The serving engine's mesh: the counterpart of the reference's
    ``build_mesh(spec, jax.devices()[:n])`` for one serving process, as
    the reference's ``serve_main`` is one process. Every rank lives in
    this process: rank ``r`` (row-major over the spec's ordered axes, as
    the reference reshapes its device list) sits on ``cuda:(r mod
    device_count)``, or on the CPU when ``device`` is the CPU. Ranks may
    share a card: placing several on one device is reported
    (:meth:`describe`), nothing falls back to another device.

    The collectives are copies between the ranks' devices: :meth:`sum`
    adds the ranks' partials in rank order (a fixed order, so every
    caller sees the same bits), :meth:`gather` concatenates their blocks
    in rank order."""

    def __init__(self, spec: MeshSpec, device=None) -> None:
        check_axes(spec)
        ordered = spec.ordered()
        self.axis_names = tuple(a for a, _ in ordered)
        self.shape: Dict[str, int] = dict(ordered)
        self.size = spec.size()
        sizes = [s for _, s in ordered]
        #: per rank: its coordinate on every axis
        self.coords = [dict(zip(self.axis_names, _unravel(r, sizes)))
                       for r in range(self.size)]
        dev = resolve_device(device)
        if dev.type == "cuda":
            n = torch.cuda.device_count()
            self.devices = [torch.device("cuda", r % n)
                            for r in range(self.size)]
        else:
            self.devices = [dev] * self.size

    def rank(self, coords: Mapping[str, int]) -> int:
        """The rank at ``coords`` (an axis left out is at 0)."""
        return _ravel([coords.get(a, 0) for a in self.axis_names],
                      [self.shape[a] for a in self.axis_names])

    def along(self, rank: int, axis: str) -> list:
        """The ranks along ``axis`` through ``rank`` (the other
        coordinates fixed), in order."""
        c = dict(self.coords[rank])
        out = []
        for i in range(self.shape.get(axis, 1)):
            c[axis] = i
            out.append(self.rank(c))
        return out

    @staticmethod
    def sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
        """The partials summed on ``device`` in rank order, in their own
        dtype."""
        out = parts[0].to(device)
        for p in parts[1:]:
            out = out + p.to(device)
        return out

    @staticmethod
    def gather(parts: Sequence[torch.Tensor], dim: int,
               device) -> torch.Tensor:
        """The ranks' blocks concatenated along ``dim`` on ``device``."""
        if len(parts) == 1:
            return parts[0].to(device)
        return torch.cat([p.to(device) for p in parts], dim=dim)

    def describe(self) -> Dict:
        """The axes, each rank's device, and how many ranks share one."""
        names = [str(d) for d in self.devices]
        return {"axes": dict(self.shape), "devices": names,
                "ranks_per_device": max(names.count(n) for n in names)}


def mesh_from_env(device=None,
                  environ: Optional[Mapping[str, str]] = None
                  ) -> ProcessMesh:
    env = os.environ if environ is None else environ
    raw = env.get(ENV_MESH_AXES, "")
    return build_mesh(MeshSpec.from_env(raw) if raw else None, device)


def batch_axes(mesh) -> tuple:
    """The tuple of mesh axes a batch dim shards over."""
    names, shape = tuple(mesh.axis_names), dict(mesh.shape)
    return tuple(a for a in DATA_AXES if a in names and shape[a] > 1) or (
        tuple(a for a in DATA_AXES if a in names)[:1] or (None,)
    )


def axis_size(mesh, name: str) -> int:
    return dict(mesh.shape).get(name, 1)


__all__ = [
    "initialize_from_env", "mesh_from_env", "build_mesh", "batch_axes",
    "axis_size", "DATA_AXES", "ProcessMesh", "local_mesh",
    "ShardSpec", "collective_backend", "rank_device", "check_axes", "world",
    "SEQUENCE_AXIS", "PORTED_AXES", "gather_dim", "gather_replicated",
    "copy_to", "reduce_from", "shift", "all_to_all", "ServingMesh",
]
