"""Write-ahead log + snapshot for the object store: the port's copy of
``kubedl_tpu/core/wal.py`` with its framing unchanged, so a log written by
either package replays in the other (the etcd-WAL analogue).

The reference operator survives restarts because the apiserver is its
durable store; :class:`~kubedl_tpu_torch.core.store.ObjectStore` is in-memory,
so this module gives it a disk image: every mutation is appended here
BEFORE it becomes visible, and a restarted process replays snapshot + log
to rebuild the exact pre-crash world (docs/robustness.md "Crash recovery").

Layout under ``wal_dir``::

    snapshot.json   {"revision": N, "objects": [encoded...]} — full state
                    at revision N, written atomically (tmp + rename)
    wal.log         records with revision > N, appended in revision order

Record framing (binary, little-endian)::

    <u32 payload-length> <u32 crc32(payload)> <payload: UTF-8 JSON>

The JSON payload is ``{"rev", "op": "PUT"|"DELETE", "kind", "namespace",
"name", "obj"}`` where ``obj`` is the :func:`kubedl_tpu_torch.core.codec.encode`
form for PUT and absent for DELETE.

Recovery semantics (the acceptance contract):

- A *torn trailing* record (fewer bytes on disk than the header promises —
  the process died mid-append) is tolerated: replay stops at the last good
  record and the tail is truncated so new appends start clean.
- A record whose bytes are all present but whose CRC mismatches is
  *corruption*, not a torn write, and raises :class:`WalCorruption` —
  silently dropping interior history would resurrect deleted objects.
- Snapshot + compaction (every ``snapshot_every`` appends) bound replay to
  O(live objects + log tail), not O(total writes ever).

fsync policy knob: ``"always"`` fsyncs each append (durability to the
record), ``"group"`` group-commits — appends stage their bytes and a
per-segment committer thread fsyncs once per batch window, acknowledging
every staged writer after the ONE fsync that covers it (fsync-before-ack:
an acknowledged record is exactly as durable as under ``"always"``, the
log just pays O(batches) fsyncs instead of O(appends)) — ``"batch"``
fsyncs only at snapshot/close (a crash may lose the un-synced tail —
torn-tail tolerance makes that a clean rollback), ``"off"`` never fsyncs
(tests/benchmarks).

Group-commit contract: :meth:`WriteAheadLog.append` returns a ticket
(monotonic sequence number); the caller applies the record to memory and
then blocks in :meth:`wait_durable` OUTSIDE its store lock — so N writers
overlap one commit window — and must not acknowledge its client until
that returns. A crash (or injected fault) between append and the batched
fsync loses only records whose ``wait_durable`` never returned: replay
after the crash keeps every acknowledged record (it was fsynced before
its ack) and may or may not keep unacknowledged ones. A failed group
fsync poisons the log (crash-only, like a torn append): every waiter
past the last durable seq raises.

Chaos sites: ``store.wal_append`` tears an append in half (simulating
death mid-write; the log is then dead, crash-only), ``store.wal_fsync``
fails the fsync call, and ``store.wal_group_commit`` fails the batched
group-commit fsync between staged appends and their acknowledgement.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubedl_tpu_torch import chaos

_HEADER = struct.Struct("<II")

WAL_FILE = "wal.log"
SNAPSHOT_FILE = "snapshot.json"

VALID_FSYNC = ("always", "group", "batch", "off")

#: default group-commit accumulation window (seconds): how long the
#: committer lets appends pile up after waking before the one fsync that
#: acknowledges them all. The window + the fsync itself bound a writer's
#: ack latency; everything staged while a previous batch was fsyncing
#: rides the next batch for free.
DEFAULT_GROUP_WINDOW = 0.005


class WalCorruption(Exception):
    """A fully-present record failed its CRC (or carried unparseable JSON)."""


def read_snapshot(wal_dir: str) -> Tuple[int, List[dict]]:
    """Read-only load of a segment's snapshot file: ``(revision,
    objects)``, ``(0, [])`` when absent. Safe against a concurrent
    owner — the snapshot is written atomically (tmp + rename), so a
    reader sees either the old or the new image, never a torn one."""
    path = os.path.join(wal_dir, SNAPSHOT_FILE)
    try:
        with open(path, "r") as f:
            snap = json.load(f)
    except (OSError, json.JSONDecodeError):
        return 0, []
    return int(snap.get("revision", 0)), list(snap.get("objects", []))


def read_records(wal_dir: str, offset: int = 0) -> Tuple[List[dict], int]:
    """Read-only replay of a segment's log from byte ``offset``: parse
    every COMPLETE record and return ``(records, next_offset)``.

    This is :meth:`WriteAheadLog.recover`'s parse without its ownership
    side effects: a torn or still-being-written trailing record simply
    stops the scan (``next_offset`` points at its first byte, so the next
    call resumes there once the owner finishes the append) — the file is
    never truncated and no append handle is taken. A CRC mismatch on a
    fully-present record is still :class:`WalCorruption`: non-owner
    readers must not paper over interior damage either. Used by
    the reference's federation tail reader to serve cross-shard reads by
    tailing a remote owner's segment."""
    path = os.path.join(wal_dir, WAL_FILE)
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            buf = f.read()
    except OSError:
        return [], offset
    records: List[dict] = []
    pos = 0
    while pos < len(buf):
        if pos + _HEADER.size > len(buf):
            break  # torn/in-flight header
        length, crc = _HEADER.unpack_from(buf, pos)
        start = pos + _HEADER.size
        if start + length > len(buf):
            break  # torn/in-flight payload
        payload = buf[start : start + length]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise WalCorruption(
                f"{path}: CRC mismatch at offset {offset + pos}"
            )
        try:
            records.append(json.loads(payload.decode("utf-8")))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise WalCorruption(
                f"{path}: bad payload at offset {offset + pos}: {e}"
            ) from e
        pos = start + length
    return records, offset + pos


def log_size(wal_dir: str) -> int:
    """Current byte length of a segment's log file (0 when absent) —
    the tail reader's compaction probe: a log SHORTER than the reader's
    cursor means the owner snapshotted + truncated, so the reader must
    restart from the (new) snapshot."""
    try:
        return os.path.getsize(os.path.join(wal_dir, WAL_FILE))
    except OSError:
        return 0


class WriteAheadLog:
    """Append/replay engine. Not thread-safe by itself — the owning
    ObjectStore serializes calls under its own lock."""

    def __init__(
        self,
        wal_dir: str,
        fsync: str = "always",
        snapshot_every: int = 1000,
        fsync_floor: float = 0.0,
        group_window: float = DEFAULT_GROUP_WINDOW,
    ) -> None:
        if fsync not in VALID_FSYNC:
            raise ValueError(f"fsync policy {fsync!r} not in {VALID_FSYNC}")
        self.dir = wal_dir
        self.fsync_policy = fsync
        #: minimum seconds per fsynced commit. Models a production-grade
        #: durable medium (etcd-class network/SSD disks commit in 1-5ms)
        #: on hosts whose local fsync hits the page cache in ~100us; the
        #: stall happens inside the commit critical section, so it
        #: contends with concurrent writers exactly like real commit
        #: latency does. 0.0 (default) = the raw device.
        self.fsync_floor = fsync_floor
        self.snapshot_every = max(1, snapshot_every)
        os.makedirs(wal_dir, exist_ok=True)
        self.log_path = os.path.join(wal_dir, WAL_FILE)
        self.snapshot_path = os.path.join(wal_dir, SNAPSHOT_FILE)
        #: cumulative counters, exported as metrics by the operator
        self.appends = 0
        self.fsyncs = 0
        self.torn_tail_bytes = 0  # bytes truncated by the last recover()
        self._since_snapshot = 0
        self._f: Optional[Any] = None
        #: a torn append (chaos or IO error) poisons the handle: the bytes
        #: on disk no longer end on a record boundary, so further appends
        #: would corrupt interior history. Crash-only — reopen to recover.
        self._dead = False
        self._closed = False
        # ---- group commit (fsync="group") --------------------------------
        self.group_window = group_window
        #: batched fsyncs executed and records they covered — avg batch =
        #: batch_records / batches; per-batch sizes also flow through
        #: :attr:`on_batch` for the kubedl_tpu_wal_batch_size histogram
        self.batches = 0
        self.batch_records = 0
        self.on_batch: Optional[Callable[[int], None]] = None
        self._commit_cv = threading.Condition()
        self._staged_seq = 0  # last record staged (bytes flushed to OS)
        self._acked_seq = 0  # last record covered by a durable fsync
        self._commit_error: Optional[BaseException] = None
        self._committer: Optional[threading.Thread] = None
        #: excludes the committer's fsync from racing the log rotation in
        #: snapshot()/close() (append vs those is already serialized by
        #: the store lock; fsync-concurrent-with-append is fine at the OS
        #: level, fsync of a just-closed fd is not)
        self._rotate_lock = threading.Lock()

    # ---- recovery --------------------------------------------------------

    def recover(self) -> Tuple[int, List[dict], List[dict]]:
        """Load the snapshot and replay the log tail. Returns
        ``(snapshot_revision, snapshot_objects, tail_records)``; truncates
        a torn trailing record and opens the log for appending."""
        snap_rev, snap_objs = 0, []
        if os.path.exists(self.snapshot_path):
            with open(self.snapshot_path, "r") as f:
                snap = json.load(f)
            snap_rev = int(snap.get("revision", 0))
            snap_objs = list(snap.get("objects", []))

        records: List[dict] = []
        good_end = 0
        if os.path.exists(self.log_path):
            with open(self.log_path, "rb") as f:
                buf = f.read()
            offset = 0
            while offset < len(buf):
                if offset + _HEADER.size > len(buf):
                    break  # torn header
                length, crc = _HEADER.unpack_from(buf, offset)
                start = offset + _HEADER.size
                if start + length > len(buf):
                    break  # torn payload
                payload = buf[start : start + length]
                if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    raise WalCorruption(
                        f"{self.log_path}: CRC mismatch at offset {offset}"
                    )
                try:
                    records.append(json.loads(payload.decode("utf-8")))
                except (UnicodeDecodeError, json.JSONDecodeError) as e:
                    raise WalCorruption(
                        f"{self.log_path}: bad payload at offset {offset}: {e}"
                    ) from e
                offset = start + length
                good_end = offset
            self.torn_tail_bytes = len(buf) - good_end
            if self.torn_tail_bytes:
                with open(self.log_path, "r+b") as f:
                    f.truncate(good_end)
        self._f = open(self.log_path, "ab")  # noqa: SIM115 — held for appends
        self._since_snapshot = len(records)
        if self.fsync_policy == "group" and self._committer is None:
            self._committer = threading.Thread(
                target=self._commit_loop,
                name=f"wal-commit-{os.path.basename(self.dir)}",
                daemon=True,
            )
            self._committer.start()
        return snap_rev, snap_objs, records

    # ---- append ----------------------------------------------------------

    def append(
        self,
        rev: int,
        op: str,
        kind: str,
        namespace: str,
        name: str,
        obj: Optional[Dict[str, Any]] = None,
    ) -> Optional[int]:
        """Record one mutation. Raises before the caller applies it to
        memory; on success the record is on disk (fsync per policy).

        Under ``fsync="group"`` the record is only *staged* (bytes flushed
        to the OS, not yet fsynced) and a ticket is returned: the caller
        must pass it to :meth:`wait_durable` — outside its own lock, so
        concurrent writers share one commit — before acknowledging the
        write to anyone. Every other policy returns ``None`` with the
        historical inline semantics unchanged."""
        if self._closed:
            return None  # detached (clean shutdown raced a late writer): drop
        if self._dead or self._f is None:
            raise WalCorruption(f"{self.log_path}: log is dead after torn append")
        record: Dict[str, Any] = {
            "rev": rev, "op": op, "kind": kind,
            "namespace": namespace, "name": name,
        }
        if obj is not None:
            record["obj"] = obj
        payload = json.dumps(record, separators=(",", ":")).encode("utf-8")
        data = _HEADER.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload
        if chaos.should_fail("store.wal_append"):
            # simulate the process dying mid-write: half the record reaches
            # disk, the rest never will — replay must roll the tail back
            self._f.write(data[: max(1, len(data) // 2)])
            self._f.flush()
            self._poison(WalCorruption(f"{self.log_path}: torn append"))
            raise chaos.FaultInjected(
                f"chaos: torn WAL append at store.wal_append (rev {rev})"
            )
        self._f.write(data)
        self._f.flush()
        self.appends += 1
        self._since_snapshot += 1
        if self.fsync_policy == "group":
            with self._commit_cv:
                self._staged_seq += 1
                seq = self._staged_seq
                self._commit_cv.notify_all()
            return seq
        if self.fsync_policy == "always":
            self._fsync()
        return None

    # ---- group commit ----------------------------------------------------

    def wait_durable(self, ticket: Optional[int]) -> None:
        """Block until the batched fsync covering ``ticket`` completed —
        the fsync-before-ack barrier. ``None`` (non-group policies, where
        append itself was the barrier) returns immediately. Call WITHOUT
        holding the store lock: the whole point is that N writers wait on
        one commit concurrently. Raises if the log died before the ticket
        became durable (the write is unacknowledged — after a restart it
        may or may not replay)."""
        if ticket is None:
            return
        with self._commit_cv:
            while self._acked_seq < ticket:
                if self._commit_error is not None:
                    raise WalCorruption(
                        f"{self.log_path}: group commit failed before seq "
                        f"{ticket} became durable"
                    ) from self._commit_error
                if self._closed and self._committer is None:
                    return  # detached post-close: close() already fsynced
                self._commit_cv.wait(0.5)

    def _poison(self, err: BaseException) -> None:
        """Kill the log (torn append / failed commit): wake every waiter
        with the error; the store is crash-only from here."""
        self._dead = True
        with self._commit_cv:
            if self._commit_error is None:
                self._commit_error = err
            self._commit_cv.notify_all()

    def _commit_loop(self) -> None:
        """The per-segment group committer: sleep until something is
        staged, let the batch window accumulate a burst, then fsync ONCE
        and acknowledge everything staged before the fsync."""
        while True:
            with self._commit_cv:
                while (
                    self._staged_seq == self._acked_seq
                    and not self._closed
                    and self._commit_error is None
                ):
                    self._commit_cv.wait(0.2)
                if self._commit_error is not None:
                    return
                if self._closed and self._staged_seq == self._acked_seq:
                    return
            if self.group_window > 0.0 and not self._closed:
                time.sleep(self.group_window)  # accumulate the burst
            with self._commit_cv:
                seq = self._staged_seq
            try:
                # the crash seam this site models: records staged (bytes on
                # disk) but the batch fsync never happens — on replay only
                # unacknowledged records may be lost
                chaos.check("store.wal_group_commit")
                with self._rotate_lock:
                    self._fsync()
            except BaseException as e:  # noqa: BLE001 — poison + stop
                self._poison(e)
                return
            with self._commit_cv:
                batch = seq - self._acked_seq
                self._acked_seq = seq
                self._commit_cv.notify_all()
            if batch > 0:
                self.batches += 1
                self.batch_records += batch
                cb = self.on_batch
                if cb is not None:
                    cb(batch)

    def _fsync(self) -> None:
        if self._f is None:
            return
        chaos.check("store.wal_fsync")
        t0 = time.perf_counter()
        os.fsync(self._f.fileno())
        self.fsyncs += 1
        if self.fsync_floor > 0.0:
            remaining = self.fsync_floor - (time.perf_counter() - t0)
            if remaining > 0.0:
                time.sleep(remaining)

    # ---- snapshot + compaction ------------------------------------------

    def should_snapshot(self) -> bool:
        return (
            not self._dead
            and not self._closed
            and self._since_snapshot >= self.snapshot_every
        )

    def snapshot(self, revision: int, objects: List[dict]) -> None:
        """Write the full state at ``revision`` atomically, then truncate
        the log — replay cost returns to O(live objects)."""
        if self._closed or self._dead:
            return
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"revision": revision, "objects": objects}, f)
            f.flush()
            if self.fsync_policy != "off":
                os.fsync(f.fileno())
        os.replace(tmp, self.snapshot_path)
        # every logged record <= revision is now in the snapshot: truncate
        with self._rotate_lock:
            if self._f is not None:
                self._f.close()
            open(self.log_path, "wb").close()
            self._f = open(self.log_path, "ab")  # noqa: SIM115
        self._since_snapshot = 0
        if self.fsync_policy == "group":
            # the fsynced snapshot covers every staged record (snapshot is
            # called under the store lock, so nothing stages concurrently):
            # they are durable now — ack them so waiters don't stall on a
            # batch whose bytes just got truncated away
            with self._commit_cv:
                if self._acked_seq < self._staged_seq:
                    self._acked_seq = self._staged_seq
                self._commit_cv.notify_all()

    # ---- lifecycle -------------------------------------------------------

    def close(self) -> None:
        """Detach: flush what is already appended and stop accepting
        writes. Late appends (e.g. a reap thread finishing after operator
        shutdown) are dropped silently — the next incarnation owns the
        files."""
        if self._closed:
            return
        self._closed = True
        committer = self._committer
        if committer is not None:
            # wake the committer; it drains any staged-but-unacked batch
            # with one final fsync, then exits on the _closed flag
            with self._commit_cv:
                self._commit_cv.notify_all()
            committer.join(timeout=5.0)
            self._committer = None
        with self._rotate_lock:
            if self._f is not None:
                try:
                    self._f.flush()
                    if self.fsync_policy != "off" and not self._dead:
                        os.fsync(self._f.fileno())
                        self.fsyncs += 1
                except (OSError, ValueError):
                    pass
                self._f.close()
                self._f = None
        # the final fsync above covered anything still staged (e.g. the
        # committer died or timed out): release any last waiters
        with self._commit_cv:
            if not self._dead and self._acked_seq < self._staged_seq:
                self._acked_seq = self._staged_seq
            self._commit_cv.notify_all()
