"""The port's compile cache: its nvcc kernel builds behind
``KUBEDL_COMPILE_CACHE_DIR``.

The counterpart of ``kubedl_tpu/utils/compile_cache.py``. What the
reference's processes compile at start is XLA programs, kept in JAX's
persistent cache; what the port's compile is its CUDA kernels, one
``nvcc`` a source (``ops/build.py``), each build named by a hash of its
source, headers and flags. So the operator's ``KUBEDL_COMPILE_CACHE_DIR``
(injected into every training and serving pod beside the checkpoint
dir) becomes the directory those builds live in: a gang restart, a
resize or a resume with an unchanged tree loads every kernel from it and
compiles none. Both entry points (``training/entry.py::train_main``,
``serving/server.py::serve_main``) call :func:`enable_compilation_cache`
before their first kernel.

Hits and misses are read from ``ops/build.py``'s ``BUILD_SECONDS``: a
source this process loaded from an existing build is a hit, one it
compiled a miss (:func:`cache_events`).
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Dict, Optional

from kubedl_tpu_torch.api.constants import ENV_COMPILE_CACHE_DIR
from kubedl_tpu_torch.ops import build

log = logging.getLogger("kubedl_tpu_torch.utils.compile_cache")

#: the env name of the cache's bound in bytes (the reference's)
ENV_COMPILE_CACHE_MAX_BYTES = "KUBEDL_COMPILE_CACHE_MAX_BYTES"
#: default LRU size cap for the on-disk cache (bytes): caching every
#: build with no bound would grow the directory forever on a long-lived
#: host
DEFAULT_MAX_SIZE = 4 << 30


def enable_compilation_cache(cache_dir: str = "") -> str:
    """Point the kernel builds at ``cache_dir``.

    Resolution order, the reference's: explicit arg >
    ``KUBEDL_COMPILE_CACHE_DIR`` env > disabled (returns "", and the
    builds stay in ``build/kubedl_tpu_torch/``). The cache is bounded by
    ``KUBEDL_COMPILE_CACHE_MAX_BYTES`` (default 4 GiB): past it a new
    build evicts the least recently used builds this process has not
    loaded. A directory that cannot be made or written raises
    ``RuntimeError`` naming it: a job never builds elsewhere quietly.
    Safe to call more than once; must be called before the first kernel
    to serve it (a library already loaded stays loaded).
    """
    cache_dir = cache_dir or os.environ.get(ENV_COMPILE_CACHE_DIR, "")
    if not cache_dir:
        return ""
    path = os.path.abspath(cache_dir)
    try:
        os.makedirs(path, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=path, prefix=".write-probe-"):
            pass
    except OSError as e:
        raise RuntimeError(
            f"compile cache directory {path} cannot be written "
            f"({ENV_COMPILE_CACHE_DIR}): {e}") from e
    max_size = int(os.environ.get(ENV_COMPILE_CACHE_MAX_BYTES,
                                  DEFAULT_MAX_SIZE))
    build.set_build_dir(path, max_size)
    log.info("kernel build cache at %s (bound %d bytes)", path, max_size)
    return cache_dir


def cache_entry_count(cache_dir: str) -> int:
    """Number of files in the cache dir (tests and the smoke run use this
    to prove a warm start actually hit: a second identical run adds zero
    new entries)."""
    if not cache_dir or not os.path.isdir(cache_dir):
        return 0
    n = 0
    for _root, _dirs, files in os.walk(cache_dir):
        n += len(files)
    return n


def cache_events(since: Optional[Dict[str, float]] = None
                 ) -> Dict[str, int]:
    """``{"hits": sources loaded from a build, "misses": sources
    compiled}`` in this process, counting only the sources not yet in
    ``since`` (a copy of ``build.BUILD_SECONDS`` taken earlier)."""
    since = since or {}
    new = [s for name, s in build.BUILD_SECONDS.items() if name not in since]
    return {"hits": sum(1 for s in new if s == 0.0),
            "misses": sum(1 for s in new if s > 0.0)}


__all__ = ["enable_compilation_cache", "cache_entry_count", "cache_events",
           "DEFAULT_MAX_SIZE", "ENV_COMPILE_CACHE_MAX_BYTES"]
