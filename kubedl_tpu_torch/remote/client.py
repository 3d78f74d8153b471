"""Blob client for the remote store (urllib only): the port's copy of
``kubedl_tpu/remote/client.py``.

Remote model roots are self-describing URLs, ``http://host:port/blobs/
<prefix>``: :func:`is_remote_root` tells them from local directories.
The training worker publishes to one with :func:`upload_tree`, and
:func:`download_tree` mirrors a checkpoint replica back in
(``training/checkpoint.py::restore_from_best``).

Every round trip consults the chaos site ``remote.request``. Transient
failures (5xx, a refused or reset connection, an injected fault) retry
under the shared policy (``chaos.RetryPolicy``: 4 attempts, full-jitter
backoff from 0.05 s capped at 0.5 s); a 4xx surfaces at once.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path
from typing import List

from kubedl_tpu_torch import chaos


class RemoteError(Exception):
    def __init__(self, msg: str, transient: bool = False) -> None:
        super().__init__(msg)
        #: True for 5xx / connection errors: safe to retry; 4xx is not
        self.transient = transient


def is_remote_root(root: str) -> bool:
    return root.startswith(("http://", "https://")) and "/blobs/" in root


def _split(root: str) -> tuple:
    """'http://h:p/blobs/a/b' -> ('http://h:p', 'a/b')."""
    base, _, prefix = root.partition("/blobs/")
    return base, prefix.strip("/")


def _request_once(url: str, data: bytes = None, method: str = "GET") -> bytes:
    chaos.check("remote.request")
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        raise RemoteError(
            f"{method} {url}: HTTP {e.code}: {e.read()[:200]}",
            transient=e.code >= 500,
        ) from e
    except urllib.error.URLError as e:
        raise RemoteError(f"{method} {url}: {e.reason}", transient=True) from e


def _request(url: str, data: bytes = None, method: str = "GET") -> bytes:
    """One blob-server round trip; transient failures (5xx, connection
    reset, injected chaos) retry under the shared policy, permanent 4xx
    surface immediately."""
    policy = chaos.RetryPolicy(max_attempts=4, base_delay=0.05, max_delay=0.5)
    return policy.call(
        lambda: _request_once(url, data=data, method=method),
        retry_on=(RemoteError, chaos.FaultInjected),
        giveup=lambda e: isinstance(e, RemoteError) and not e.transient,
    )


def _quote_key(key: str) -> str:
    return urllib.parse.quote(key, safe="/")


def put_blob(base_url: str, key: str, data: bytes) -> None:
    _request(f"{base_url}/blobs/{_quote_key(key)}", data=data, method="PUT")


def get_blob(base_url: str, key: str) -> bytes:
    return _request(f"{base_url}/blobs/{_quote_key(key)}")


def list_blobs(base_url: str, prefix: str = "") -> List[str]:
    q = urllib.parse.quote(prefix, safe="/")
    return json.loads(_request(f"{base_url}/blobs?prefix={q}"))["keys"]


def upload_tree(local_dir: str, remote_root: str) -> int:
    """Upload every file under ``local_dir`` to the remote prefix (sorted
    order); returns the number of files uploaded."""
    base, prefix = _split(remote_root)
    root = Path(local_dir)
    n = 0
    for p in sorted(root.rglob("*")):
        if p.is_file():
            rel = p.relative_to(root).as_posix()
            put_blob(base, f"{prefix}/{rel}" if prefix else rel, p.read_bytes())
            n += 1
    return n


def download_tree(remote_root: str, local_dir: str) -> int:
    """Mirror the remote prefix into ``local_dir``; returns file count."""
    base, prefix = _split(remote_root)
    n = 0
    for key in list_blobs(base, prefix):
        rel = key[len(prefix):].lstrip("/") if prefix else key
        dest = Path(local_dir) / rel
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_bytes(get_blob(base, key))
        n += 1
    return n


__all__ = ["RemoteError", "is_remote_root", "put_blob", "get_blob",
           "list_blobs", "upload_tree", "download_tree"]
