"""In-process object store with watch semantics: the port's copy of
``kubedl_tpu/core/store.py`` (the etcd/api-server analogue).

The reference rides controller-runtime's informer cache + client (SURVEY.md
L0). Here a single thread-safe store holds every object, hands out deep
copies (so controllers can't mutate shared state accidentally — the same
reason the reference reads via a cache and writes via the client), and fans
out Added/Modified/Deleted events to registered watchers. Controllers never
poll: watch events feed their workqueues
(the reference's ``core/workqueue.py``), exactly like informer event handlers.

Durability is opt-in: ``ObjectStore(wal_dir=...)`` puts a write-ahead log
(:mod:`kubedl_tpu_torch.core.wal`) in front of every mutation and rehydrates the
pre-crash world from snapshot+log in the constructor — before any
controller registers. The default in-memory path is untouched (WAL-off
writes pay one ``None`` test).

Concurrency model (the scaling contract):

- Stored objects are **replace-on-write**: a mutation deepcopies into a
  fresh object and swaps the bucket slot; the displaced object is never
  touched again. That invariant is what makes the read fast paths legal.
- :meth:`peek` is a lock-free point read (CPython dict reads are atomic
  under the GIL) returning the stored object itself — callers must not
  mutate it; :meth:`get` deepcopies it outside any lock.
- Scans (:meth:`list`, :meth:`collect_orphans`, the sharded facade's
  counters) run over :meth:`snapshot_view` — an RCU-style copy-on-write
  per-kind tuple rebuilt lazily when that kind's generation counter moved,
  so read fan-out never holds the write lock while copying.
- Under ``wal_fsync="group"`` a write stages its WAL record and applies to
  memory inside the lock, then blocks in ``wait_durable`` OUTSIDE the lock
  (group commit: N writers share one fsync) before watchers are notified
  or the call returns. Readers may therefore observe a record the batched
  fsync hasn't covered yet; writers never acknowledge one.
"""

from __future__ import annotations

import copy
import logging
import re
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from kubedl_tpu_torch import chaos
from kubedl_tpu_torch.core.objects import BaseObject, ensure_uid_floor, match_labels

log = logging.getLogger("kubedl_tpu_torch.core.store")

WatchCallback = Callable[[str, BaseObject, Optional[BaseObject]], None]
# signature: (event_type, new_obj, old_obj) with event_type in
# {"ADDED", "MODIFIED", "DELETED"}


class Conflict(Exception):
    """Optimistic-concurrency failure (stale resource_version on update)."""


class NotFound(Exception):
    pass


class AlreadyExists(Exception):
    pass


@dataclass
class _Watcher:
    kinds: Optional[Tuple[str, ...]]
    callback: WatchCallback


class ObjectStore:
    def __init__(
        self,
        wal_dir: Optional[str] = None,
        wal_fsync: str = "always",
        wal_snapshot_every: int = 1000,
        wal_fsync_floor: float = 0.0,
        wal_group_window: Optional[float] = None,
    ) -> None:
        self._lock = threading.RLock()
        self._objects: Dict[str, Dict[Tuple[str, str], BaseObject]] = {}
        #: per-kind write generation + lazily rebuilt snapshot views
        #: (kind -> (generation, tuple of stored objects)); see the module
        #: docstring's concurrency model
        self._gen: Dict[str, int] = {}
        self._views: Dict[str, Tuple[int, Tuple[BaseObject, ...]]] = {}
        self._rv = 0
        self._watchers: List[_Watcher] = []
        #: revision of the most recent delete — a watcher replaying from an
        #: older revision can never see that DELETED event (gap detection)
        self._last_delete_rev = 0
        #: watchers registered with a since_revision older than replayable
        #: history (exported as a gauge by the operator)
        self.watch_gaps = 0
        self._wal = None
        self.rehydrated = False
        self.replayed_records = 0
        self.recovery_seconds = 0.0
        if wal_dir:
            self._open_wal(
                wal_dir, wal_fsync, wal_snapshot_every, wal_fsync_floor,
                wal_group_window,
            )

    # ---- durability (WAL) ------------------------------------------------

    @property
    def revision(self) -> int:
        with self._lock:
            return self._rv

    def _open_wal(
        self,
        wal_dir: str,
        fsync: str,
        snapshot_every: int,
        fsync_floor: float = 0.0,
        group_window: Optional[float] = None,
    ) -> None:
        """Replay snapshot+log into memory, then arm the WAL on the write
        path. Runs in the constructor so every object is back before any
        watcher or controller exists."""
        from kubedl_tpu_torch.core.codec import decode_object
        from kubedl_tpu_torch.core.wal import DEFAULT_GROUP_WINDOW, WriteAheadLog

        t0 = time.perf_counter()
        wal = WriteAheadLog(
            wal_dir,
            fsync=fsync,
            snapshot_every=snapshot_every,
            fsync_floor=fsync_floor,
            group_window=(
                DEFAULT_GROUP_WINDOW if group_window is None else group_window
            ),
        )
        snap_rev, snap_objs, records = wal.recover()
        max_uid = 0
        with self._lock:
            self._rv = snap_rev
            for data in snap_objs:
                obj = decode_object(data)
                self._objects.setdefault(obj.kind, {})[obj.key] = obj
            for rec in records:
                rev = int(rec["rev"])
                if rec["op"] == "PUT":
                    obj = decode_object(rec["obj"])
                    self._objects.setdefault(obj.kind, {})[obj.key] = obj
                else:
                    self._objects.get(rec["kind"], {}).pop(
                        (rec["namespace"], rec["name"]), None
                    )
                    self._last_delete_rev = rev
                self._rv = max(self._rv, rev)
            self.replayed_records = len(records)
            self.rehydrated = bool(snap_objs or records)
            # a restarted process mints uids from 1 again — colliding with
            # replayed objects would defeat adoption-by-(name, uid)
            for bucket in self._objects.values():
                for obj in bucket.values():
                    m = re.match(r"uid-(\d+)$", obj.metadata.uid)
                    if m:
                        max_uid = max(max_uid, int(m.group(1)))
            self._wal = wal
        ensure_uid_floor(max_uid)
        self.recovery_seconds = time.perf_counter() - t0
        if self.rehydrated:
            live = sum(len(b) for b in self._objects.values())
            log.info(
                "rehydrated %d objects (snapshot rv=%d + %d WAL records, "
                "%d torn bytes dropped) in %.1fms",
                live, snap_rev, len(records), wal.torn_tail_bytes,
                self.recovery_seconds * 1e3,
            )

    def _wal_put(self, rev: int, obj: BaseObject) -> Optional[int]:
        """Append a PUT record; raises (nothing applied) on failure. Under
        group commit returns a staging ticket the caller must pass to
        :meth:`_wait_durable` AFTER releasing the store lock."""
        if self._wal is None:
            return None
        from kubedl_tpu_torch.core.codec import encode

        return self._wal.append(
            rev, "PUT", obj.kind, obj.metadata.namespace, obj.metadata.name,
            encode(obj),
        )

    def _wal_delete(
        self, rev: int, kind: str, namespace: str, name: str
    ) -> Optional[int]:
        if self._wal is None:
            return None
        return self._wal.append(rev, "DELETE", kind, namespace, name)

    def _wait_durable(self, ticket: Optional[int]) -> None:
        """Fsync-before-ack barrier for group commit: block (outside the
        store lock) until the batched fsync covers ``ticket``. No-op for
        every other policy. Tickets are monotonic per WAL, so waiting on a
        batch's LAST ticket covers the whole batch."""
        if ticket is not None and self._wal is not None:
            self._wal.wait_durable(ticket)

    def _maybe_compact(self) -> None:
        """Snapshot + truncate once enough records accumulated. Caller
        holds the lock; the dump is O(live objects)."""
        if self._wal is None or not self._wal.should_snapshot():
            return
        from kubedl_tpu_torch.core.codec import encode

        objs = [
            encode(o) for bucket in self._objects.values() for o in bucket.values()
        ]
        self._wal.snapshot(self._rv, objs)

    @property
    def wal_appends(self) -> int:
        return self._wal.appends if self._wal is not None else 0

    @property
    def wal_fsyncs(self) -> int:
        return self._wal.fsyncs if self._wal is not None else 0

    @property
    def wal_batches(self) -> int:
        return self._wal.batches if self._wal is not None else 0

    @property
    def wal_batch_records(self) -> int:
        return self._wal.batch_records if self._wal is not None else 0

    def set_wal_batch_observer(self, cb: Callable[[int], None]) -> None:
        """Install the per-batch size callback (feeds the
        ``kubedl_tpu_wal_batch_size`` histogram); called from the
        committer thread with the number of records each fsync covered."""
        if self._wal is not None:
            self._wal.on_batch = cb

    def compact(self) -> None:
        """Force a snapshot+truncate now (test/ops hook)."""
        with self._lock:
            if self._wal is None:
                return
            from kubedl_tpu_torch.core.codec import encode

            objs = [
                encode(o)
                for bucket in self._objects.values()
                for o in bucket.values()
            ]
            self._wal.snapshot(self._rv, objs)

    def close(self) -> None:
        """Detach the WAL (flush + stop accepting writes). In-memory
        operation continues — late writers from a dying incarnation mutate
        only their abandoned memory image, never the files the next
        incarnation replays."""
        with self._lock:
            if self._wal is not None:
                self._wal.close()

    # ---- CRUD ------------------------------------------------------------

    def _bump(self, kind: str) -> None:
        """Advance ``kind``'s write generation (caller holds the lock);
        snapshot views for that kind rebuild lazily on next read."""
        self._gen[kind] = self._gen.get(kind, 0) + 1

    def create(self, obj: BaseObject) -> BaseObject:
        chaos.check("store.create")
        with self._lock:
            bucket = self._objects.setdefault(obj.kind, {})
            if obj.key in bucket:
                raise AlreadyExists(f"{obj.kind} {obj.key} already exists")
            rev = self._rv + 1
            stored = copy.deepcopy(obj)
            stored.metadata.resource_version = rev
            ticket = self._wal_put(rev, stored)  # raises unapplied
            self._rv = rev
            obj.metadata.resource_version = rev
            bucket[obj.key] = stored
            self._bump(obj.kind)
            self._maybe_compact()
        self._wait_durable(ticket)  # fsync-before-ack, outside the lock
        snapshot = copy.deepcopy(stored)  # stored is replace-on-write: safe
        self._notify("ADDED", snapshot, None)
        return snapshot

    def create_many(self, objs: List[BaseObject]) -> List[BaseObject]:
        """Create a batch under ONE lock hold and ONE durability wait —
        under group commit N sequential :meth:`create` calls would each pay
        a full commit window; a batch stages every record and waits once on
        the last (monotonic) ticket. All-or-nothing on name collisions: the
        whole batch is pre-checked and :class:`AlreadyExists` raises before
        anything is staged or applied, so callers can fall back to the
        per-object path. The chaos ``store.create`` site fires once per
        batch (a batch is one API call). Watch events still fan out one
        ADDED per object, in batch order, after the batch is durable."""
        if not objs:
            return []
        chaos.check("store.create")
        ticket = None
        stored_objs: List[BaseObject] = []
        with self._lock:
            for obj in objs:
                bucket = self._objects.setdefault(obj.kind, {})
                if obj.key in bucket:
                    raise AlreadyExists(f"{obj.kind} {obj.key} already exists")
            for obj in objs:
                rev = self._rv + 1
                stored = copy.deepcopy(obj)
                stored.metadata.resource_version = rev
                ticket = self._wal_put(rev, stored) or ticket
                self._rv = rev
                obj.metadata.resource_version = rev
                self._objects[obj.kind][obj.key] = stored
                self._bump(obj.kind)
                stored_objs.append(stored)
            self._maybe_compact()
        self._wait_durable(ticket)
        out = []
        for stored in stored_objs:
            snapshot = copy.deepcopy(stored)
            self._notify("ADDED", snapshot, None)
            out.append(snapshot)
        return out

    def peek(
        self, kind: str, name: str, namespace: str = "default"
    ) -> Optional[BaseObject]:
        """Lock-free point read returning the STORED object (or ``None``
        if absent/terminating) — the internal fast path behind existence
        probes and :meth:`get`. Legal because stored objects are
        replace-on-write (module docstring) and CPython dict reads are
        GIL-atomic. Callers MUST NOT mutate the result; anything handed
        outside the store must be deepcopied first."""
        bucket = self._objects.get(kind)
        if bucket is None:
            return None
        obj = bucket.get((namespace, name))
        if obj is None or obj.metadata.deletion_timestamp is not None:
            return None
        return obj

    def get(self, kind: str, name: str, namespace: str = "default") -> BaseObject:
        obj = self.peek(kind, name, namespace)
        if obj is None:
            raise NotFound(f"{kind} {namespace}/{name} not found")
        return copy.deepcopy(obj)  # outside any lock: see peek()

    def try_get(
        self, kind: str, name: str, namespace: str = "default"
    ) -> Optional[BaseObject]:
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def update(self, obj: BaseObject) -> BaseObject:
        """Optimistic update: fails with Conflict on stale resource_version
        (the reference requeues on conflict, job.go:298-306)."""
        chaos.check("store.update")
        with self._lock:
            bucket = self._objects.get(obj.kind, {})
            cur = bucket.get(obj.key)
            if cur is None:
                raise NotFound(f"{obj.kind} {obj.key} not found")
            if obj.metadata.resource_version != cur.metadata.resource_version:
                raise Conflict(
                    f"{obj.kind} {obj.key}: stale rv "
                    f"{obj.metadata.resource_version} != {cur.metadata.resource_version}"
                )
            rev = self._rv + 1
            stored = copy.deepcopy(obj)
            stored.metadata.resource_version = rev
            ticket = self._wal_put(rev, stored)  # raises unapplied
            self._rv = rev
            obj.metadata.resource_version = rev
            bucket[obj.key] = stored
            self._bump(obj.kind)
            self._maybe_compact()
        self._wait_durable(ticket)  # fsync-before-ack, outside the lock
        # cur was displaced from the bucket and is never mutated again, so
        # both copies are safe outside the lock
        old = copy.deepcopy(cur)
        snapshot = copy.deepcopy(stored)
        self._notify("MODIFIED", snapshot, old)
        return snapshot

    def update_with_retry(
        self, kind: str, name: str, namespace: str, mutate: Callable[[BaseObject], None],
        attempts: int = 5,
    ) -> BaseObject:
        """Read-modify-write loop, the client-go `retry.RetryOnConflict` idiom.

        Retries ride the shared :class:`~kubedl_tpu_torch.chaos.RetryPolicy`
        (in-process conflicts are cheap, so the backoff floor is tiny —
        jitter only matters when many workers contend on one object)."""
        policy = chaos.RetryPolicy(
            max_attempts=attempts, base_delay=0.001, max_delay=0.02
        )

        def attempt() -> BaseObject:
            obj = self.get(kind, name, namespace)
            mutate(obj)
            return self.update(obj)

        return policy.call(attempt, retry_on=(Conflict,))

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        chaos.check("store.delete")
        ticket = None
        with self._lock:
            bucket = self._objects.get(kind, {})
            obj = bucket.get((namespace, name))
            if obj is not None:
                rev = self._rv + 1
                ticket = self._wal_delete(rev, kind, namespace, name)
                self._rv = rev
                self._last_delete_rev = rev
                bucket.pop((namespace, name))
                self._bump(kind)
                self._maybe_compact()
        if obj is None:
            raise NotFound(f"{kind} {namespace}/{name} not found")
        self._wait_durable(ticket)  # fsync-before-ack, outside the lock
        self._notify("DELETED", copy.deepcopy(obj), copy.deepcopy(obj))

    def try_delete(self, kind: str, name: str, namespace: str = "default") -> bool:
        try:
            self.delete(kind, name, namespace)
            return True
        except NotFound:
            return False

    def delete_many(self, keys: List[Tuple[str, str, str]]) -> int:
        """Delete a batch of ``(kind, name, namespace)`` keys under ONE
        lock hold and ONE durability wait (see :meth:`create_many` for
        why). Missing keys are skipped — try-delete semantics — and the
        count actually deleted is returned. The chaos ``store.delete``
        site fires once per batch; DELETED events fan out per object
        after the batch is durable."""
        if not keys:
            return 0
        chaos.check("store.delete")
        ticket = None
        doomed: List[BaseObject] = []
        with self._lock:
            for kind, name, namespace in keys:
                bucket = self._objects.get(kind, {})
                obj = bucket.get((namespace, name))
                if obj is None:
                    continue
                rev = self._rv + 1
                ticket = self._wal_delete(rev, kind, namespace, name) or ticket
                self._rv = rev
                self._last_delete_rev = rev
                bucket.pop((namespace, name))
                self._bump(kind)
                doomed.append(obj)
            self._maybe_compact()
        self._wait_durable(ticket)
        for obj in doomed:
            self._notify("DELETED", copy.deepcopy(obj), copy.deepcopy(obj))
        return len(doomed)

    def snapshot_view(self, kind: str) -> Tuple[BaseObject, ...]:
        """RCU-style scan view: an immutable tuple of ``kind``'s stored
        objects, consistent as of some point at or after the last write
        that completed before this call. Rebuilt (copy-on-write) only when
        the kind's generation moved, so steady-state readers touch no lock
        at all and never copy objects — deepcopy what leaves the store.
        The contained objects follow :meth:`peek` rules: do not mutate."""
        gen = self._gen.get(kind, 0)
        cached = self._views.get(kind)
        if cached is not None and cached[0] == gen:
            return cached[1]
        with self._lock:
            gen = self._gen.get(kind, 0)
            view = tuple(self._objects.get(kind, {}).values())
        self._views[kind] = (gen, view)
        return view

    def list(
        self,
        kind: str,
        namespace: Optional[str] = "default",
        selector: Optional[Dict[str, str]] = None,
    ) -> List[BaseObject]:
        out = []
        for obj in self.snapshot_view(kind):
            if namespace is not None and obj.metadata.namespace != namespace:
                continue
            if selector and not match_labels(obj.metadata.labels, selector):
                continue
            out.append(copy.deepcopy(obj))  # copied OUTSIDE the lock
        out.sort(key=lambda o: (o.metadata.namespace, o.metadata.name))
        return out

    def kinds(self) -> Iterable[str]:
        with self._lock:
            return list(self._objects)

    # ---- watches ---------------------------------------------------------

    def watch(
        self,
        callback: WatchCallback,
        kinds: Optional[Iterable[str]] = None,
        since_revision: Optional[int] = None,
    ) -> Callable[[], None]:
        """Register a watcher; returns an unsubscribe function. Watchers run
        inline on the mutating thread (informer-style handlers must be quick
        — typically just a workqueue enqueue).

        ``since_revision`` replays history missed before registration:
        synthesized ADDED events (revision rides each object's
        ``metadata.resource_version``) are delivered for every live matching
        object newer than that revision — ``since_revision=0`` is a full
        relist. Deletions are not reconstructible from live state; if any
        happened after ``since_revision`` the watcher has a real gap, which
        is logged and counted (``watch_gaps``) instead of passing silently.
        Replay runs inline before this call returns; a concurrent mutation
        may deliver its live event before the replayed ADDED (same
        relist-vs-watch race informers have — handlers must be level-driven).
        """
        w = _Watcher(tuple(kinds) if kinds else None, callback)
        replay: List[BaseObject] = []
        with self._lock:
            self._watchers.append(w)
            if since_revision is not None and since_revision < self._rv:
                if since_revision < self._last_delete_rev:
                    self.watch_gaps += 1
                    log.warning(
                        "watcher registered at revision %d but deletes up to "
                        "revision %d are gone — DELETED events in that gap "
                        "cannot be replayed",
                        since_revision, self._last_delete_rev,
                    )
                for kind, bucket in self._objects.items():
                    if w.kinds is not None and kind not in w.kinds:
                        continue
                    for obj in bucket.values():
                        if obj.metadata.resource_version > since_revision:
                            replay.append(copy.deepcopy(obj))
        for obj in sorted(replay, key=lambda o: o.metadata.resource_version):
            callback("ADDED", obj, None)

        def cancel() -> None:
            with self._lock:
                if w in self._watchers:
                    self._watchers.remove(w)

        return cancel

    def _notify(
        self, event: str, obj: BaseObject, old: Optional[BaseObject]
    ) -> None:
        with self._lock:
            watchers = list(self._watchers)
        for w in watchers:
            if w.kinds is None or obj.kind in w.kinds:
                w.callback(event, obj, old)

    # ---- garbage collection ---------------------------------------------

    def collect_orphans(self) -> int:
        """Delete objects whose controller owner is gone (the kube GC
        analogue; the reference leans on ownerReferences for cascade).
        Scans snapshot views, not the live buckets: GC sweeps no longer
        stall writers, at the cost of possibly missing an orphan created
        mid-sweep (the next sweep gets it — GC is level-driven)."""
        doomed: List[BaseObject] = []
        views = [self.snapshot_view(kind) for kind in self.kinds()]
        uids = {o.metadata.uid for view in views for o in view}
        for view in views:
            for obj in view:
                ref = obj.metadata.controller_ref()
                if ref is not None and ref.uid not in uids:
                    doomed.append(obj)
        for obj in doomed:
            self.try_delete(obj.kind, obj.metadata.name, obj.metadata.namespace)
        return len(doomed)
