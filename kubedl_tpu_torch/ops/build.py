"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``kubedl_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface,
at first use, and loaded with ``ctypes``. The library name carries a
hash of the source, of the shared headers (``csrc/*.cuh``) and of the
flags, so an edited source or header never loads a stale build, and a
process whose tree is unchanged loads every build and compiles none. No
PyTorch headers are involved (a source including them takes minutes to
compile; this one takes seconds).

The builds live in :func:`build_dir`, read at every call:
``build/kubedl_tpu_torch/`` at the repository root, unless
:func:`kubedl_tpu_torch.utils.compile_cache.enable_compilation_cache`
pointed it at the job's cache directory (``KUBEDL_COMPILE_CACHE_DIR``),
whose size it bounds: past the bound a new build evicts the least
recently used builds that this process has not loaded.

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
#: where the builds go unless a compile cache is enabled
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
#: the enabled compile cache's directory and its bound in bytes
#: (:func:`set_build_dir`); None: ``BUILD_DIR``, unbounded
_cache_dir: Optional[Path] = None
_cache_max_bytes: Optional[int] = None
#: the builds this process compiled or loaded (it never evicts them)
_used: set = set()


def build_dir() -> Path:
    """The directory builds go to and load from, as of this call."""
    return _cache_dir or BUILD_DIR


def set_build_dir(path, max_bytes: Optional[int] = None) -> Path:
    """Point every later build and load at ``path`` (None: back to
    ``BUILD_DIR``), bounded at ``max_bytes`` of builds (None: unbounded).
    Libraries this process already loaded stay loaded."""
    global _cache_dir, _cache_max_bytes
    _cache_dir = None if path is None else Path(path).resolve()
    _cache_max_bytes = max_bytes
    return build_dir()


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
    return build_dir() / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def _evict(max_bytes: int) -> None:
    """Delete the least recently used builds (a load refreshes a build's
    time) that this process has not used, until the builds take at most
    ``max_bytes``."""
    libs = []
    for lib in build_dir().glob("lib*.so"):
        try:
            st = lib.stat()
        except FileNotFoundError:  # another process evicted it
            continue
        libs.append((st.st_mtime, st.st_size, lib))
    total = sum(size for _, size, _ in libs)
    for _, size, lib in sorted(libs, key=lambda x: x[0]):
        if total <= max_bytes:
            break
        if lib in _used:
            continue
        lib.unlink(missing_ok=True)
        total -= size


def build(src_name: str, verbose: bool = False, force: bool = False) -> Path:
    """Compile ``csrc/<src_name>`` unless an up-to-date build exists (or
    ``force``: compile again, e.g. for the ``-Xptxas -v`` report);
    returns the shared library's path."""
    src = CSRC_DIR / src_name
    out = _lib_path(src)
    if out.exists() and not force:
        BUILD_SECONDS.setdefault(src_name, 0.0)
        _used.add(out)
        try:
            os.utime(out)  # recently used: the last to be evicted
        except OSError:  # a cache another user owns still serves
            pass
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
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
    _used.add(out)
    if _cache_max_bytes is not None:
        _evict(_cache_max_bytes)
    return out


def _declare_paged_attention(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kdl_paged_route.argtypes = [i] * 6  # dtype hd S group BS fused
    lib.kdl_paged_route.restype = i
    lib.kdl_paged_attention_blocked.argtypes = [
        p, p, p, p, p, p, p, p,  # q k_pool v_pool bt starts ws counters out
        i, i, i, i, i, i, i, i,  # B S H KV hd NB BS MB
        i, i, i,  # nsplit split_len dtype
        p,  # stream
    ]
    lib.kdl_paged_attention_blocked.restype = i
    lib.kdl_paged_attention_fused.argtypes = [
        p, p, p, p, p, p, p,  # q k_pool v_pool bt starts new_k new_v
        p, p, p,  # ws counters out
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
    # q k v cos sin out lse dout q_rot k_rot stats, then dq_ws dkv_ws dq
    # dk dv / dq / dk_h dv_h
    lib.kdl_flash_bwd_fused.argtypes = [p] * 16 + dims
    lib.kdl_flash_bwd_dq.argtypes = [p] * 12 + dims
    lib.kdl_flash_bwd_dkdv.argtypes = [p] * 13 + dims
    lib.kdl_flash_route.argtypes = [i] * 3  # op dtype hd
    for fn in (lib.kdl_flash_fwd, lib.kdl_flash_bwd_fused,
               lib.kdl_flash_bwd_dq, lib.kdl_flash_bwd_dkdv,
               lib.kdl_flash_route):
        fn.restype = i


def _declare_w8a16(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kdl_w8a16_matmul.argtypes = [
        p, p, p, p, p,  # h q8 s8 y ws
        i, i, i, i, i,  # M N K tied dtype
        i, i, i,  # route splits k_slice
        p,  # stream
    ]
    lib.kdl_w8a16_matmul.restype = i
    lib.kdl_w8a16_route.argtypes = [i] * 5  # M N K dtype tied
    lib.kdl_w8a16_route.restype = i


def _declare_adamw(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kdl_adamw_norm_blocks.argtypes = [i]
    lib.kdl_adamw_sumsq.argtypes = [p, i, i, i, p, p]  # g n bf16 vec slots
    lib.kdl_adamw_norm_finish.argtypes = [p, p, p, i, p, p]  # slots offsets
    # bf16 n_leaves out; then p g mu nu norm n p_bf16 mu_bf16 vec scalars
    lib.kdl_adamw_update.argtypes = [p, p, p, p, p, i, i, i, i, p, p]
    for fn in (lib.kdl_adamw_norm_blocks, lib.kdl_adamw_sumsq,
               lib.kdl_adamw_norm_finish, lib.kdl_adamw_update):
        fn.restype = i


_SOURCES = {
    "paged_attention": _declare_paged_attention,
    "flash_attention": _declare_flash_attention,
    "w8a16": _declare_w8a16,
    "adamw": _declare_adamw,
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


def load_w8a16_kernels(verbose: bool = False):
    """The W8A16 weight-only int8 matmul library (built on first call)."""
    return _load("w8a16", verbose)


def load_adamw_kernels(verbose: bool = False):
    """The fused optimizer-update library (built on first call)."""
    return _load("adamw", verbose)


def stream_handle(device) -> int:
    """The raw handle of ``device``'s current stream, without building a
    Stream object (the public path costs several microseconds a call)."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def float_workspace(cache: dict, device, stream: int, numel: int):
    """A float32 scratch tensor of at least ``numel`` elements for the
    kernels on ``(device, stream)``, kept in ``cache`` and grown as
    needed: the calls on one stream run in order, so each may reuse it."""
    import torch

    ws = cache.get((device, stream))
    if ws is None or ws.numel() < numel:
        ws = torch.empty(numel, dtype=torch.float32, device=device)
        cache[(device, stream)] = ws
    return ws


def int_counters(cache: dict, device, stream: int, numel: int):
    """An int32 tensor of at least ``numel`` zeros for the kernels on
    ``(device, stream)``, kept in ``cache`` and grown as needed (a new one
    is zeroed): each launch that counts in it leaves it at zero again."""
    import torch

    cnt = cache.get((device, stream))
    if cnt is None or cnt.numel() < numel:
        cnt = torch.zeros(numel, dtype=torch.int32, device=device)
        cache[(device, stream)] = cnt
    return cnt


def check_launch(err: int, name: str) -> None:
    """Raise on the ``cudaGetLastError()`` code a C entry point returned:
    a refused launch (too many threads, too much shared memory) never
    runs, and a later synchronize would not report it."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err}")


__all__ = ["build", "build_all", "load_kernels", "load_flash_kernels",
           "load_w8a16_kernels", "load_adamw_kernels", "stream_handle",
           "float_workspace", "int_counters",
           "check_launch", "find_nvcc", "build_dir", "set_build_dir",
           "BUILD_DIR", "BUILD_SECONDS", "BUILD_LOG"]
