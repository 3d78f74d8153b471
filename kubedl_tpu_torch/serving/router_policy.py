"""Prefix affinity digests: the part of the reference's router policy the
engine needs.

The engine's ``/v1/stats`` advertises digests of the prefixes its cache
holds, in the same hash the router's consistent-hash ring keys on, so the
unchanged router (``kubedl_tpu/serving/router_policy.py``) steers shared
prompts onto a PyTorch replica that already holds their blocks. Copied
from ``kubedl_tpu/serving/router_policy.py:197-215``; the rest of that
module (the ring, the router's policies) is the control plane's and stays
there.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence


def _stable_hash(data: bytes) -> int:
    # NOT the builtin hash(): PYTHONHASHSEED would shuffle the ring every
    # process restart and the affinity (and its cache hit rate) with it
    return int.from_bytes(hashlib.sha1(data).digest()[:8], "big")


def prefix_digest(prompt_ids: Sequence[int],
                  prefix_len: int) -> Optional[int]:
    """Stable digest of a prompt's first ``prefix_len`` tokens — the SAME
    value the ring hashes on, so an engine's advertised-prefix map (built
    from its prefix-cache keys) and the router's per-request lookup agree
    by construction. None for prompts shorter than the affinity length or
    disabled affinity."""
    if prefix_len <= 0:
        return None
    ids = list(prompt_ids)[:prefix_len]
    if len(ids) < prefix_len:
        return None
    return _stable_hash(b",".join(str(int(t)).encode() for t in ids))


__all__ = ["prefix_digest"]
