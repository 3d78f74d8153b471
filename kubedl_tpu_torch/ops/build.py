"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``kubedl_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface
under ``build/kubedl_tpu_torch/`` at the repository root, at first use,
and loaded with ``ctypes``. The library name carries a hash of the
source, of the shared headers (``csrc/*.cuh``) and of the flags, so an
edited source or header never loads a stale build. No
PyTorch headers are involved (a source including them takes minutes to
compile; this one takes seconds).

Nothing here runs at import: the CPU tests import every module of the
port on machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kubedl_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_lock = threading.Lock()
_libs: dict = {}
#: seconds each source took to build in this process (0.0 = loaded)
BUILD_SECONDS: dict = {}
#: nvcc's output per source built in this process (with ``verbose``, the
#: ``-Xptxas -v`` report: registers, spills, shared memory per kernel)
BUILD_LOG: dict = {}


def find_nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the port's CUDA kernels "
        "are built from source at first use"
    )


def _lib_path(src: Path) -> Path:
    """The build of ``src`` named by a hash of its text, of every header
    beside it (``*.cuh``, which any source may include) and of the flags."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build(src_name: str, verbose: bool = False, force: bool = False) -> Path:
    """Compile ``csrc/<src_name>`` unless an up-to-date build exists (or
    ``force``: compile again, e.g. for the ``-Xptxas -v`` report);
    returns the shared library's path."""
    src = CSRC_DIR / src_name
    out = _lib_path(src)
    if out.exists() and not force:
        BUILD_SECONDS.setdefault(src_name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src_name} (rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    BUILD_LOG[src_name] = proc.stdout + proc.stderr
    if verbose and BUILD_LOG[src_name]:
        print(BUILD_LOG[src_name], flush=True)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a torso
    BUILD_SECONDS[src_name] = time.perf_counter() - t0
    return out


def _declare_paged_attention(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kdl_paged_route.argtypes = [i] * 6  # dtype hd S group BS fused
    lib.kdl_paged_route.restype = i
    lib.kdl_paged_attention_blocked.argtypes = [
        p, p, p, p, p, p, p,  # q, k_pool, v_pool, bt, starts, ws, out
        i, i, i, i, i, i, i, i,  # B S H KV hd NB BS MB
        i, i, i,  # nsplit split_len dtype
        p,  # stream
    ]
    lib.kdl_paged_attention_blocked.restype = i
    lib.kdl_paged_attention_fused.argtypes = [
        p, p, p, p, p, p, p,  # q k_pool v_pool bt starts new_k new_v
        p, p,  # ws out
        i, i, i, i, i, i, i,  # B H KV hd NB BS MB
        i, i, i,  # nsplit split_len dtype
        p,  # stream
    ]
    lib.kdl_paged_attention_fused.restype = i


def _declare_flash_attention(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    dims = [i] * 9 + [p]  # B Sq Sk H KV hd causal rope dtype, the stream
    # q k v cos sin out lse q_rot k_rot
    lib.kdl_flash_fwd.argtypes = [p] * 9 + dims
    # q k v cos sin out lse dout q_rot k_rot stats, then dq_ws dq dk dv /
    # dq / dk_h dv_h
    lib.kdl_flash_bwd_fused.argtypes = [p] * 15 + dims
    lib.kdl_flash_bwd_dq.argtypes = [p] * 12 + dims
    lib.kdl_flash_bwd_dkdv.argtypes = [p] * 13 + dims
    lib.kdl_flash_route.argtypes = [i] * 2  # dtype hd
    for fn in (lib.kdl_flash_fwd, lib.kdl_flash_bwd_fused,
               lib.kdl_flash_bwd_dq, lib.kdl_flash_bwd_dkdv,
               lib.kdl_flash_route):
        fn.restype = i


_SOURCES = {
    "paged_attention": _declare_paged_attention,
    "flash_attention": _declare_flash_attention,
}


def _load(name: str, verbose: bool):
    with _lock:
        lib: Optional[ctypes.CDLL] = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name + ".cu", verbose)))
            _SOURCES[name](lib)
            _libs[name] = lib
        return lib


def build_all(verbose: bool = False, force: bool = False) -> None:
    """Compile every source that has no up-to-date build (every source
    with ``force``), one ``nvcc`` each, all started together; then load
    them."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(_SOURCES)) as pool:
        list(pool.map(lambda n: build(n + ".cu", verbose, force), _SOURCES))
    for name in _SOURCES:
        _load(name, verbose)


def load_kernels(verbose: bool = False):
    """The paged-attention kernel library (built on first call)."""
    return _load("paged_attention", verbose)


def load_flash_kernels(verbose: bool = False):
    """The flash-attention kernel library (built on first call)."""
    return _load("flash_attention", verbose)


def check_launch(err: int, name: str) -> None:
    """Raise on the ``cudaGetLastError()`` code a C entry point returned:
    a refused launch (too many threads, too much shared memory) never
    runs, and a later synchronize would not report it."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err}")


__all__ = ["build", "build_all", "load_kernels", "load_flash_kernels",
           "check_launch", "find_nvcc", "BUILD_DIR", "BUILD_SECONDS",
           "BUILD_LOG"]
