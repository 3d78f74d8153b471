"""Device-resident prefix KV cache for shared-prompt serving traffic.

Real request fleets overwhelmingly share prompt prefixes — system
prompts, few-shot templates, chat history. Recomputing the shared
prefix's K/V on every admission is pure redundant prefill work: cached
prefix KV turns O(prompt) prefill into O(suffix), cutting TTFT and
freeing device time for decode throughput (docs/serving.md "Prefix
cache").

Two token-trie structures, both host-side and tiny; the PAYLOAD (per-
layer K/V arrays, `[L, P, KV, hd]` bucket-padded, or pool block ids in
the paged engine) lives on the engine's device:

- The **entry trie** indexes stored prefixes for longest-prefix match:
  `match(prompt)` walks the prompt and returns the DEEPEST stored entry
  that still leaves at least one suffix token to prefill (the engine
  needs last-token logits to sample from).
- The **observation trie** watches traffic to decide what is WORTH
  storing: every admitted prompt is `observe()`d, and
  `insert_candidate()` returns the longest prefix of a prompt that at
  least ``min_seen`` distinct requests have shared — exactly the
  "system prompt" of a shared-prefix fleet, without any tagging. A
  request can also tag itself cacheable (`"cache_prefix": true` in the
  body), which makes its whole prompt a candidate on first sight.

Entries are kept under a configurable byte budget with LRU eviction.
Entries grafted into in-flight rows are PINNED by refcount: `match`
pins, the engine unpins at prefill harvest / finalize / slot vacation /
error recovery — a pinned entry is never evicted. Accounting (hits,
misses, tokens saved, insertions, evictions, bytes) feeds
`LlamaEngine.stats()["prefix_cache"]` (a copy of the reference's
``kubedl_tpu/serving/prefix_cache.py``: the diff is docstrings only).

Thread safety: one internal lock; callers are the scheduler thread plus
request threads releasing pins on timeout vacation.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple


class PrefixEntry:
    """One cached prefix. Two payload shapes:

    - **array payload** (contiguous engine): device-resident per-layer
      K/V copies, ``bytes`` = their nbytes;
    - **block payload** (paged engine): ``blocks`` holds pool block ids
      the entry REFERENCES (refcounted by the engine's BlockAllocator —
      no copy exists), and the caller passes the bytes those references
      pin via ``nbytes``.
    """

    __slots__ = ("tokens", "length", "k", "v", "blocks", "bytes", "refs",
                 "last_use", "hits")

    def __init__(self, tokens: Tuple[int, ...], k, v, length: int,
                 blocks: Optional[Tuple[int, ...]] = None,
                 nbytes: Optional[int] = None) -> None:
        self.tokens = tokens
        self.length = length  # true prefix length (k/v are bucket-padded)
        self.k = k  # [L, P, KV, hd] (None for block-payload entries)
        self.v = v
        self.blocks = tuple(blocks) if blocks else None
        if nbytes is not None:
            self.bytes = int(nbytes)
        else:
            self.bytes = int(getattr(k, "nbytes", 0)) + int(
                getattr(v, "nbytes", 0)
            )
        self.refs = 0  # in-flight rows using this entry (pin count)
        self.last_use = 0  # LRU clock value at last match/insert
        self.hits = 0


class _Node:
    """Entry-trie node: child per token, optional terminal entry."""

    __slots__ = ("children", "entry")

    def __init__(self) -> None:
        self.children: Dict[int, "_Node"] = {}
        self.entry: Optional[PrefixEntry] = None


class PrefixCache:
    """Token-trie prefix KV store with byte budget + LRU + pinning."""

    def __init__(
        self,
        budget_bytes: int,
        min_len: int = 8,
        min_seen: int = 2,
        max_obs_nodes: int = 100_000,
        max_obs_depth: int = 4096,
        on_evict=None,
    ) -> None:
        #: callback(entry) fired whenever an entry leaves the cache via
        #: eviction/reclaim — the paged engine returns the entry's block
        #: references to its allocator here. Called under the cache lock;
        #: the callback must not call back into this cache.
        self.on_evict = on_evict
        #: HBM byte budget for entry payloads (k+v nbytes)
        self.budget_bytes = int(budget_bytes)
        #: prefixes shorter than this are not worth a graft dispatch
        self.min_len = max(1, int(min_len))
        #: observation threshold: insert once this many requests shared it
        self.min_seen = max(1, int(min_seen))
        self._lock = threading.Lock()
        self._root = _Node()
        self._entries: Dict[Tuple[int, ...], PrefixEntry] = {}
        self._bytes = 0
        self._clock = 0  # LRU tick, bumped per match/insert
        # observation trie: token -> [count, children]; bounded node count
        self._obs_root: list = [0, {}]
        self._obs_nodes = 0
        self._max_obs_nodes = int(max_obs_nodes)
        self._max_obs_depth = int(max_obs_depth)
        self._stats = {
            "hits": 0, "misses": 0, "inserts": 0, "evictions": 0,
            "tokens_saved": 0, "insert_rejects": 0,
        }

    # -- lookup / pinning --------------------------------------------------

    def match(self, prompt: Sequence[int]) -> Tuple[Optional[PrefixEntry], int]:
        """Longest stored prefix of ``prompt`` that leaves >= 1 suffix
        token. On a hit the entry is PINNED (refcount) and its LRU clock
        bumped; the caller owns one `unpin`. Returns (entry, length) or
        (None, 0)."""
        # deepest usable terminal: depth <= len(prompt) - 1
        limit = len(prompt) - 1
        with self._lock:
            node = self._root
            best: Optional[PrefixEntry] = None
            for d in range(limit):
                node = node.children.get(int(prompt[d]))
                if node is None:
                    break
                if node.entry is not None:
                    best = node.entry
            if best is None:
                self._stats["misses"] += 1
                return None, 0
            self._clock += 1
            best.last_use = self._clock
            best.refs += 1
            best.hits += 1
            self._stats["hits"] += 1
            return best, best.length

    def unpin(self, entry: PrefixEntry) -> None:
        """Release one in-flight pin taken by `match` (or `pin`)."""
        with self._lock:
            if entry.refs > 0:
                entry.refs -= 1

    def pin(self, entry: PrefixEntry) -> None:
        with self._lock:
            entry.refs += 1

    def add_tokens_saved(self, n: int) -> None:
        """Account prefill tokens actually skipped (the engine calls this
        at suffix-prefill dispatch, not at match: a graft dropped before
        prefill — overflow fixup, vacation — must not inflate it)."""
        if n > 0:
            with self._lock:
                self._stats["tokens_saved"] += int(n)

    # -- traffic observation ----------------------------------------------

    def observe(self, prompt: Sequence[int]) -> None:
        """Record one request's prompt in the observation trie (bounded
        nodes/depth). Counts on each node = how many requests shared the
        prefix ending there."""
        with self._lock:
            node = self._obs_root
            node[0] += 1
            for tok in list(prompt)[: self._max_obs_depth]:
                tok = int(tok)
                nxt = node[1].get(tok)
                if nxt is None:
                    if self._obs_nodes >= self._max_obs_nodes:
                        return  # full: keep counting along existing paths
                    nxt = [0, {}]
                    node[1][tok] = nxt
                    self._obs_nodes += 1
                nxt[0] += 1
                node = nxt

    def insert_candidate(
        self, prompt: Sequence[int], tagged: bool = False
    ) -> int:
        """Length of the prefix of ``prompt`` worth inserting now: the
        whole prompt when ``tagged`` (request body opted in), else the
        longest prefix >= ``min_seen`` requests have shared. 0 = nothing
        (too short, or not shared traffic)."""
        if tagged:
            return len(prompt) if len(prompt) >= self.min_len else 0
        with self._lock:
            node = self._obs_root
            depth = 0
            for tok in list(prompt)[: self._max_obs_depth]:
                nxt = node[1].get(int(tok))
                if nxt is None or nxt[0] < self.min_seen:
                    break
                depth += 1
                node = nxt
        return depth if depth >= self.min_len else 0

    # -- insertion / eviction ----------------------------------------------

    def insert(self, tokens: Sequence[int], k, v, length: int,
               blocks: Optional[Sequence[int]] = None,
               nbytes: Optional[int] = None) -> bool:
        """Store a prefix entry (payload bucket-padded by the caller;
        or, paged, ``blocks`` references with explicit ``nbytes``).
        Duplicate keys just refresh the existing entry's LRU clock.
        Evicts LRU unpinned entries until the new entry fits; rejects it
        (False) if it cannot fit — pinned bytes never get evicted and a
        single entry larger than the budget never enters."""
        key = tuple(int(t) for t in tokens)
        entry = PrefixEntry(
            key, k, v, int(length),
            blocks=tuple(blocks) if blocks else None, nbytes=nbytes,
        )
        with self._lock:
            self._clock += 1
            existing = self._entries.get(key)
            if existing is not None:
                existing.last_use = self._clock
                return False
            if entry.bytes > self.budget_bytes:
                self._stats["insert_rejects"] += 1
                return False
            while self._bytes + entry.bytes > self.budget_bytes:
                if not self._evict_lru_locked():
                    self._stats["insert_rejects"] += 1
                    return False
            node = self._root
            for tok in key:
                node = node.children.setdefault(tok, _Node())
            node.entry = entry
            entry.last_use = self._clock
            self._entries[key] = entry
            self._bytes += entry.bytes
            self._stats["inserts"] += 1
            return True

    def _evict_lru_locked(self) -> bool:
        victim = None
        for e in self._entries.values():
            if e.refs > 0:
                continue
            if victim is None or e.last_use < victim.last_use:
                victim = e
        if victim is None:
            return False
        self._remove_locked(victim)
        self._stats["evictions"] += 1
        return True

    def reclaim(self, nbytes: int) -> int:
        """Evict LRU UNPINNED entries until at least ``nbytes`` of budget
        came back (or nothing evictable remains); returns bytes freed.
        The paged engine's pressure valve: under block exhaustion, cached
        prefixes are the first thing to go — they are an optimization,
        resident rows are work. `on_evict` fires per entry, handing block
        references back to the allocator."""
        freed = 0
        with self._lock:
            while freed < int(nbytes):
                before = self._bytes
                if not self._evict_lru_locked():
                    break
                freed += before - self._bytes
        return freed

    def clear(self) -> None:
        """Drop EVERY entry — pinned or not — without firing `on_evict`.
        Error-recovery only: the engine rebuilt its device pool and
        allocator, so the block references entries hold are already
        dead and must not be double-freed into the new allocator."""
        with self._lock:
            for e in self._entries.values():
                e.k = e.v = None
            self._entries.clear()
            self._root = _Node()
            self._bytes = 0

    def _remove_locked(self, entry: PrefixEntry) -> None:
        del self._entries[entry.tokens]
        self._bytes -= entry.bytes
        # unlink from the trie, pruning now-empty branches
        path: List[Tuple[_Node, int]] = []
        node = self._root
        for tok in entry.tokens:
            path.append((node, tok))
            node = node.children[tok]
        node.entry = None
        for parent, tok in reversed(path):
            child = parent.children[tok]
            if child.entry is None and not child.children:
                del parent.children[tok]
            else:
                break
        if self.on_evict is not None:
            self.on_evict(entry)
        entry.k = entry.v = None  # drop device buffer refs eagerly

    # -- introspection -----------------------------------------------------

    def prefix_keys(self, limit: int = 256) -> List[Tuple[int, ...]]:
        """Snapshot of stored prefix token keys, most-recently-used first
        (bounded by ``limit``). Feeds the engine's advertised-prefix map:
        the router's block-aware affinity steers shared prompts onto
        replicas whose caches already hold their blocks."""
        with self._lock:
            keys = sorted(
                self._entries.values(), key=lambda e: -e.last_use
            )[: max(0, int(limit))]
            return [e.tokens for e in keys]

    def stats(self) -> Dict:
        with self._lock:
            s = dict(self._stats)
            s["entries"] = len(self._entries)
            s["bytes"] = self._bytes
            s["budget_bytes"] = self.budget_bytes
            s["pinned"] = sum(1 for e in self._entries.values() if e.refs)
        total = s["hits"] + s["misses"]
        s["hit_rate"] = round(s["hits"] / total, 4) if total else 0.0
        return s

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
