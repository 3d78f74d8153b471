"""Shard-level state for the parameter service: the port's copy of
``kubedl_tpu/ps/shards.py``.

One shard owns a hash-partitioned subset of the model's parameters plus a
monotone ``version`` counter (one tick per applied push). Two existing
robustness mechanisms are reused rather than reinvented:

- **Durability** rides :class:`kubedl_tpu_torch.core.wal.WriteAheadLog` — the
  same ``<len><crc32><json>`` framing, torn-tail truncation and crash-only
  poisoned-handle semantics the object store proved out. A shard appends
  one record per applied push and compacts into a snapshot, so a failed-
  over owner replays to the exact pre-crash state.
- **Ownership fencing** rides :class:`kubedl_tpu_torch.core.leases.Lease`: each
  shard has a ``ps-shard-<i>`` lease whose ``transitions`` counter is the
  fencing token. A failover bumps it; any apply stamped with the deposed
  owner's token is rejected (:class:`FencedOut`) — a zombie owner that
  wakes up after a long stall can never smear a write over its
  successor's state.
"""

from __future__ import annotations

import os
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from kubedl_tpu_torch.core.leases import LEASE_NAMESPACE, Lease
from kubedl_tpu_torch.core.store import AlreadyExists, ObjectStore
from kubedl_tpu_torch.core.wal import WriteAheadLog


def shard_for(name: str, num_shards: int) -> int:
    """Deterministic hash partition: parameter path -> owning shard."""
    return zlib.crc32(name.encode("utf-8")) % max(int(num_shards), 1)


def partition(names, num_shards: int) -> List[List[str]]:
    """Group parameter names by owning shard (stable within a shard)."""
    out: List[List[str]] = [[] for _ in range(max(int(num_shards), 1))]
    for n in names:
        out[shard_for(n, num_shards)].append(n)
    return out


class FencedOut(Exception):
    """An apply carried a stale fencing token (deposed shard owner)."""


class ShardDead(Exception):
    """The shard's owner has crashed; recover() it before touching it."""


def _lease_name(shard_id: int) -> str:
    return f"ps-shard-{shard_id}"


class _LeaseHeld(Exception):
    pass


def acquire_shard_lease(
    store: ObjectStore,
    shard_id: int,
    identity: str,
    ttl: float,
    clock: Callable[[], float],
) -> int:
    """Acquire (or renew) the shard's lease; returns the fencing token
    (``Lease.transitions``). A live lease held by someone else raises
    :class:`_LeaseHeld` — same expiry arbitration as
    ``LeaderElector._try_acquire``."""
    name = _lease_name(shard_id)
    now = clock()
    existing = store.try_get("Lease", name, LEASE_NAMESPACE)
    if existing is None:
        lease = Lease(
            holder=identity, acquired_at=now, renewed_at=now,
            lease_ttl=ttl, transitions=0,
        )
        lease.metadata.name = name
        lease.metadata.namespace = LEASE_NAMESPACE
        try:
            store.create(lease)
            return 0
        except AlreadyExists:
            pass  # raced another candidate: fall through to mutate

    def mutate(obj: Lease) -> None:
        fresh = clock()
        if obj.holder != identity and fresh - obj.renewed_at <= obj.lease_ttl:
            raise _LeaseHeld(obj.holder)
        if obj.holder != identity:
            obj.transitions += 1  # the fencing token bump
        obj.holder = identity
        obj.acquired_at = fresh
        obj.renewed_at = fresh
        obj.lease_ttl = ttl

    store.update_with_retry("Lease", name, LEASE_NAMESPACE, mutate)
    return store.get("Lease", name, LEASE_NAMESPACE).transitions


class ShardState:
    """One shard's parameters + version, WAL-backed and lease-fenced.

    Not thread-safe by itself — the owning :class:`ParameterService`
    serializes access under its lock (same division of labor as
    WriteAheadLog / ObjectStore)."""

    def __init__(
        self,
        shard_id: int,
        store: ObjectStore,
        wal_dir: str = "",
        fsync: str = "always",
        lease_ttl: float = 5.0,
        clock: Callable[[], float] = None,
        snapshot_every: int = 256,
    ) -> None:
        import time as _time

        self.shard_id = shard_id
        self.store = store
        self.wal_dir = wal_dir
        self.fsync = fsync
        self.lease_ttl = lease_ttl
        self.clock = clock or _time.time
        self.snapshot_every = snapshot_every
        self.params: Dict[str, np.ndarray] = {}
        self.version = 0
        self.fence = -1          # current owner's fencing token
        self.owner = ""
        self.alive = False
        self.failovers = 0
        self._wal: Optional[WriteAheadLog] = None

    # ---- ownership -------------------------------------------------------

    def open(self, identity: str) -> int:
        """Acquire the shard lease as ``identity`` and recover state from
        the WAL (no-op dir = memory-only shard). Returns the fencing
        token. Raises :class:`_LeaseHeld` while the previous owner's
        lease is live."""
        token = acquire_shard_lease(
            self.store, self.shard_id, identity, self.lease_ttl, self.clock
        )
        if self.owner and self.owner != identity:
            self.failovers += 1
        self.owner = identity
        self.fence = token
        self._recover()
        self.alive = True
        return token

    def kill(self) -> None:
        """Simulate the owner crashing: the in-memory state is gone and
        the WAL handle dies with the process. The lease is NOT released —
        a successor must wait out (or fake-clock past) the TTL, exactly
        like a real crash."""
        self.alive = False
        if self._wal is not None:
            try:
                self._wal.close()
            except Exception:
                pass
            self._wal = None
        self.params = {}
        self.version = 0

    def _recover(self) -> None:
        if not self.wal_dir:
            return
        wal = WriteAheadLog(
            os.path.join(self.wal_dir, f"shard-{self.shard_id}"),
            fsync=self.fsync, snapshot_every=self.snapshot_every,
        )
        snap_rev, snap_objs, tail = wal.recover()
        params: Dict[str, np.ndarray] = {}
        version = snap_rev
        for obj in snap_objs:
            for k, v in obj.get("params", {}).items():
                params[k] = np.asarray(v, dtype=np.float32)
        for rec in tail:
            obj = rec.get("obj", {})
            if rec.get("op") == "init":
                params = {
                    k: np.asarray(v, dtype=np.float32)
                    for k, v in obj.get("params", {}).items()
                }
                version = int(rec.get("rev", 0))
            elif rec.get("op") == "push":
                w = float(obj.get("weight", 1.0))
                for k, v in obj.get("delta", {}).items():
                    arr = np.asarray(v, dtype=np.float32)
                    params[k] = params.get(k, np.zeros_like(arr)) + w * arr
                version = int(rec.get("rev", version))
        self.params = params
        self.version = version
        self._wal = wal

    # ---- state -----------------------------------------------------------

    def init_params(self, params: Dict[str, np.ndarray]) -> None:
        """Seed the shard (version 0). Skipped when recovery already
        loaded state — a failed-over owner must keep the replayed values,
        not reset survivors' progress."""
        if self.params:
            return
        self.params = {
            k: np.asarray(v, dtype=np.float32).copy() for k, v in params.items()
        }
        if self._wal is not None:
            self._wal.append(
                self.version, "init", "PSShard", "ps",
                f"shard-{self.shard_id}",
                obj={"params": {k: v.tolist() for k, v in self.params.items()}},
            )

    def apply(
        self, worker: str, weight: float, delta: Dict[str, np.ndarray],
        fence: int,
    ) -> int:
        """Apply one decay-weighted delta; returns the new version.
        ``fence`` is the caller's view of the ownership token — stale
        means a deposed owner's route and the write is refused."""
        if not self.alive:
            raise ShardDead(f"shard {self.shard_id} owner is down")
        if fence != self.fence:
            raise FencedOut(
                f"shard {self.shard_id}: fence {fence} != current {self.fence}"
            )
        new_version = self.version + 1
        if self._wal is not None:
            self._wal.append(
                new_version, "push", "PSShard", "ps",
                f"shard-{self.shard_id}",
                obj={
                    "worker": worker, "weight": weight,
                    "delta": {k: np.asarray(v).tolist() for k, v in delta.items()},
                },
            )
        for k, v in delta.items():
            arr = np.asarray(v, dtype=np.float32)
            if k in self.params:
                # the reference's params + weight * arr, added in place
                # (the shard's arrays are its own: snapshots copy them);
                # 1.0 * arr is arr, so a fresh push skips the product
                np.add(self.params[k], arr if weight == 1.0 else weight * arr,
                       out=self.params[k])
            else:
                self.params[k] = weight * arr
        self.version = new_version
        if self._wal is not None and self._wal.should_snapshot():
            self._wal.snapshot(
                self.version,
                [{"params": {k: v.tolist() for k, v in self.params.items()}}],
            )
        return self.version

    def snapshot(self) -> Tuple[int, Dict[str, np.ndarray]]:
        if not self.alive:
            raise ShardDead(f"shard {self.shard_id} owner is down")
        return self.version, {k: v.copy() for k, v in self.params.items()}
