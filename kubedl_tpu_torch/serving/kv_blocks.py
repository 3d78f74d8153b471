"""Host-side block-table KV allocator for the paged serving cache.

The contiguous engine pre-allocates every batch row out to ``max_seq``,
so HBM — not compute — caps batch occupancy: a row serving a 40-token
chat holds the same KV footprint as one serving a 4k-token document.
Paged KV (the vLLM block-table idea) breaks the cache into fixed-size
blocks of ``block_size`` tokens; a row owns an ordered *block list* and
grows it as decode advances, so resident bytes track the tokens actually
cached, not the worst case (docs/serving.md "Paged KV").

This module is the HOST half: pure-Python bookkeeping over integer block
ids. The device half lives in `kubedl_tpu_torch.models.llama` (pool layout
``[L, NB, BS, KV, hd]``; gather-view attention and scatter writes over a
``[B, MB]`` block table). The split keeps every policy decision —
refcounts, watermarks, copy-on-write, preemption — unit-testable with no
device in sight.

Invariants the engine relies on:

- **Block 0 is the trash block.** It is never allocated and never freed;
  every unmapped block-table entry points at it, so device writes from
  vacant/overshooting rows land in garbage nobody reads (the paged twin
  of the contiguous path's garbage-beyond-pos contract).
- **Refcounts make sharing safe.** A prefix-cache entry and any number
  of rows may reference the same block; `free` decrements and only
  returns the block to the free list at zero. A block with refs >= 2 is
  *shared* and therefore read-only — the engine copies it
  (`copy-on-write`) before any write can land inside it, which in
  practice means exactly the partial tail block of a grafted prefix:
  full blocks are never written again, so they are shared by reference
  forever at zero copy cost.
- **Watermarks drive admission, with hysteresis.** When the free
  fraction drops below ``low_watermark`` the allocator closes admission;
  it reopens only once frees recover past ``high_watermark``, so
  admission does not flap around one block. The engine sheds (503 +
  Retry-After) while closed and defers admitting queued requests.

Thread safety: one internal lock; the scheduler thread and request
threads (stats) both call in.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional

#: the reserved write-sink block every unmapped table entry points at
TRASH_BLOCK = 0


class BlockExhausted(Exception):
    """Raised by callers that treat allocation failure as an error (the
    allocator itself returns None — preemption is the engine's policy)."""


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size KV blocks.

    ``num_blocks`` INCLUDES the reserved trash block 0, mirroring the
    device pool's leading dimension; ``total`` reports usable blocks.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 low_watermark: float = 0.05,
                 high_watermark: float = 0.15) -> None:
        if num_blocks < 2:
            raise ValueError("need at least one usable block beyond trash")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if not 0.0 <= low_watermark <= high_watermark <= 1.0:
            raise ValueError("need 0 <= low <= high <= 1 watermarks")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.low_watermark = float(low_watermark)
        self.high_watermark = float(high_watermark)
        self._lock = threading.Lock()
        # LIFO free list: hot blocks cycle, keeping the working set dense
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._refs: List[int] = [0] * self.num_blocks
        self._refs[TRASH_BLOCK] = 1  # pinned forever
        self._admitting = True
        self._stats = {"allocs": 0, "frees": 0, "alloc_failures": 0,
                       "cow_copies": 0}

    # -- capacity ----------------------------------------------------------

    @property
    def total(self) -> int:
        """Usable blocks (the trash block is not capacity)."""
        return self.num_blocks - 1

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to cache ``n_tokens`` token positions."""
        return max(0, (int(n_tokens) + self.block_size - 1) // self.block_size)

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_count(self) -> int:
        with self._lock:
            return self.total - len(self._free)

    @property
    def shared_count(self) -> int:
        """Blocks referenced by >= 2 owners (prefix entries + rows)."""
        with self._lock:
            return sum(
                1 for b in range(1, self.num_blocks) if self._refs[b] >= 2
            )

    def free_fraction(self) -> float:
        with self._lock:
            return len(self._free) / max(self.total, 1)

    # -- alloc / free / sharing -------------------------------------------

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks (refcount 1 each) or None if the free
        list cannot cover them — all-or-nothing, so a half-grown row
        never exists. Updates the admission hysteresis either way."""
        n = int(n)
        with self._lock:
            if n > len(self._free):
                self._stats["alloc_failures"] += 1
                return None
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._refs[b] = 1
            self._stats["allocs"] += n
            self._update_gate_locked()
            return out

    def incref(self, blocks: Iterable[int]) -> None:
        """Add one reference per block (prefix entry sharing a row's
        blocks, or a graft sharing an entry's)."""
        with self._lock:
            for b in blocks:
                if b == TRASH_BLOCK:
                    continue
                if self._refs[b] <= 0:
                    raise ValueError(f"incref of unallocated block {b}")
                self._refs[b] += 1

    def free(self, blocks: Iterable[int]) -> int:
        """Drop one reference per block; blocks reaching zero return to
        the free list. Returns how many were actually reclaimed."""
        reclaimed = 0
        with self._lock:
            for b in blocks:
                if b == TRASH_BLOCK:
                    continue
                if self._refs[b] <= 0:
                    raise ValueError(f"double free of block {b}")
                self._refs[b] -= 1
                if self._refs[b] == 0:
                    self._free.append(b)
                    reclaimed += 1
            self._stats["frees"] += reclaimed
            self._update_gate_locked()
        return reclaimed

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._refs[block]

    def is_shared(self, block: int) -> bool:
        """True when a write into ``block`` would be visible to another
        owner — the copy-on-write trigger."""
        with self._lock:
            return self._refs[block] >= 2

    def cow(self, block: int) -> Optional[int]:
        """Copy-on-write bookkeeping: allocate a private replacement for
        shared ``block`` and drop this owner's reference to the original.
        The caller owns the DEVICE copy of the payload (the host side
        cannot move bytes). Returns the new block id, or None when no
        block is free. For an unshared block this is a no-op returning
        the block itself — callers can call it unconditionally."""
        with self._lock:
            if block != TRASH_BLOCK and self._refs[block] < 2:
                return block
            if not self._free:
                self._stats["alloc_failures"] += 1
                return None
            new = self._free.pop()
            self._refs[new] = 1
            if block != TRASH_BLOCK:
                self._refs[block] -= 1
                if self._refs[block] == 0:  # last other owner freed it
                    self._free.append(block)
            self._stats["allocs"] += 1
            self._stats["cow_copies"] += 1
            self._update_gate_locked()
            return new

    # -- admission watermarks ---------------------------------------------

    def _update_gate_locked(self) -> None:
        frac = len(self._free) / max(self.total, 1)
        if self._admitting and frac < self.low_watermark:
            self._admitting = False
        elif not self._admitting and frac >= self.high_watermark:
            self._admitting = True

    def admission_open(self) -> bool:
        """Hysteresis gate: False between crossing the low watermark and
        recovering past the high watermark. The engine sheds new requests
        (503 + Retry-After) and defers queued admissions while closed."""
        with self._lock:
            return self._admitting

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict:
        with self._lock:
            free = len(self._free)
            shared = sum(
                1 for b in range(1, self.num_blocks) if self._refs[b] >= 2
            )
            out = dict(self._stats)
        out.update({
            "total": self.total,
            "free": free,
            "used": self.total - free,
            "shared": shared,
            "block_size": self.block_size,
            "free_fraction": round(free / max(self.total, 1), 4),
            "admission_open": self._admitting,
            "low_watermark": self.low_watermark,
            "high_watermark": self.high_watermark,
        })
        return out
