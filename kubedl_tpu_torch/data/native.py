"""Token-file datasets: the port's copy of ``kubedl_tpu/data/native.py``.

:func:`TokenFileDataset` serves ``[batch, seq]`` int32 windows of a
binary token file (uint32 tokens, or uint16 with ``token_bytes=2``):

- :class:`NativeTokenLoader`: the repository's C++ loader
  (``native/dataloader.cpp``: the file memory-mapped, window starts from
  a seeded xorshift generator, batches assembled ahead on a host thread)
  through ctypes. The port builds it with ``g++`` at first use into its
  own ``build/kubedl_tpu_torch/`` (named by a hash of the source and the
  flags), never beside the source, so the two packages never race on
  one shared library.
- :class:`_NumpyTokenLoader`: the reference's numpy path, where no
  compiler exists (host code, the same interface; its windows come from
  numpy's generator, so they are not the C++ loader's).

One difference from the reference: the port always opens the C++ loader
with a prefetch depth of 1 (one fill thread, one batch ahead). At a
depth above 1 the C++ loader starts two fill threads that draw window
starts in turn but may queue their batches in either order, and may drop
one when both find the same free slot; so the same seed need not give the
same stream twice, and a resumed run could not be held to its
uninterrupted twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

log = logging.getLogger("kubedl_tpu_torch.data.native")

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "native" / "dataloader.cpp"
BUILD_DIR = ROOT / "build" / "kubedl_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libkdl_data-{h.hexdigest()[:12]}.so"


def _build_lib() -> Optional[Path]:
    out = _lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        log.info("native data loader unavailable (%s); using numpy", e)
        return None
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a torso
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lib_lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        if not SRC.exists():
            return None
        path = _build_lib()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.kdl_loader_open.restype = ctypes.c_void_p
        lib.kdl_loader_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ]
        lib.kdl_loader_next.restype = ctypes.c_int
        lib.kdl_loader_next.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int32)]
        lib.kdl_loader_tokens.restype = ctypes.c_long
        lib.kdl_loader_tokens.argtypes = [ctypes.c_void_p]
        lib.kdl_loader_close.restype = None
        lib.kdl_loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeTokenLoader:
    """Batches from a binary token file via the C++ prefetch ring."""

    kind = "native"

    def __init__(self, path: str, batch: int, seq: int, seed: int = 0,
                 token_bytes: int = 4) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native data loader not available")
        self._lib = lib
        self.batch, self.seq = batch, seq
        self._h = lib.kdl_loader_open(
            os.fsencode(path), batch, seq, seed, 1, token_bytes
        )
        if not self._h:
            raise FileNotFoundError(
                f"cannot open token file {path!r} (need >= {seq} tokens)"
            )

    @property
    def n_tokens(self) -> int:
        return int(self._lib.kdl_loader_tokens(self._h))

    def next(self) -> np.ndarray:
        out = np.empty((self.batch, self.seq), np.int32)
        rc = self._lib.kdl_loader_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        )
        if rc != 0:
            raise RuntimeError("native loader stopped")
        return out

    __next__ = next

    def close(self) -> None:
        if self._h:
            self._lib.kdl_loader_close(self._h)
            self._h = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self) -> Iterator[np.ndarray]:
        return self


class _NumpyTokenLoader:
    """The same sampling contract in numpy (no compiler needed)."""

    kind = "numpy"

    def __init__(self, path: str, batch: int, seq: int, seed: int = 0,
                 token_bytes: int = 4) -> None:
        dtype = np.uint16 if token_bytes == 2 else np.int32
        self._tokens = np.memmap(path, dtype=dtype, mode="r")
        if len(self._tokens) < seq:
            raise FileNotFoundError(f"token file {path!r} too small")
        self.batch, self.seq = batch, seq
        self._rng = np.random.default_rng(seed or 0x9E3779B9)

    @property
    def n_tokens(self) -> int:
        return len(self._tokens)

    def next(self) -> np.ndarray:
        span = len(self._tokens) - self.seq
        starts = (
            self._rng.integers(0, span, self.batch) if span > 0
            else np.zeros(self.batch, np.int64)
        )
        return np.stack(
            [self._tokens[s:s + self.seq] for s in starts]
        ).astype(np.int32)

    __next__ = next

    def close(self) -> None:
        pass

    def __iter__(self) -> Iterator[np.ndarray]:
        return self


def TokenFileDataset(path: str, batch: int, seq: int, seed: int = 0,
                     token_bytes: int = 4):
    """A dataset over a binary token file: the native prefetch loader
    when a compiler is available, numpy otherwise (``.kind`` says which)."""
    if native_available():
        return NativeTokenLoader(path, batch, seq, seed, token_bytes)
    return _NumpyTokenLoader(path, batch, seq, seed, token_bytes)


__all__ = ["NativeTokenLoader", "TokenFileDataset", "native_available"]
