"""Start the processes of one multi-process job on this host, as the
control plane starts a job's workers: each rank gets the env
:func:`~kubedl_tpu_torch.parallel.mesh.initialize_from_env` reads
(``KUBEDL_NUM_PROCESSES``, ``KUBEDL_PROCESS_ID``,
``KUBEDL_COORDINATOR_ADDRESS`` on a free local port), and the join has a
timeout: when one rank fails or runs over, every rank is killed and the
join raises.
"""

from __future__ import annotations

import os
import socket
import subprocess
from typing import Dict, List

from kubedl_tpu_torch.api.constants import (
    ENV_COMPILE_CACHE_DIR, ENV_COORDINATOR_ADDRESS, ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
)

#: the checkout's root (the directory that holds the package)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def job_env(rank: int, world: int, port: int, **extra: str) -> Dict[str, str]:
    """The environment of rank ``rank`` of a ``world``-process job: this
    process's, without any ``KUBEDL_*`` name it holds but the kernel
    cache's (``KUBEDL_COMPILE_CACHE_DIR``, which the operator gives every
    worker of a job alike), the checkout on ``PYTHONPATH``, and
    ``extra``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBEDL_") or k == ENV_COMPILE_CACHE_DIR}
    env.update({ENV_NUM_PROCESSES: str(world),
                ENV_PROCESS_ID: str(rank),
                ENV_COORDINATOR_ADDRESS: f"127.0.0.1:{port}",
                "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", "")},
               **extra)
    return env


def start_ranks(argv: List[str], world: int = 2,
                **extra: str) -> List[subprocess.Popen]:
    """Start ``world`` processes of ``argv`` (from the checkout's root) as
    one job; returns them."""
    port = free_port()
    return [subprocess.Popen(argv, env=job_env(r, world, port, **extra),
                             cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def join_ranks(procs: List[subprocess.Popen], timeout: float) -> List[str]:
    """Wait for every rank, each at most ``timeout`` seconds; raise
    ``RuntimeError`` unless each exited 0 (every rank still running is
    killed then). Returns each rank's standard output."""
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(
                    f"rank {r} timed out after {timeout} s") from None
            if p.returncode != 0:
                raise RuntimeError(
                    f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


__all__ = ["free_port", "job_env", "start_ranks", "join_ranks"]
