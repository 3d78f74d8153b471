"""Worker-side progress beacon: the port's copy of
``kubedl_tpu/watchdog/beacon.py`` (``ProgressBeacon``, ``read_beacon``,
``beacon_path``; the kubelet-side file source stays with the operator).

The beacon is a tiny JSON file the worker rewrites atomically on a side
thread: ``{"step": N, "tokens": T, "ts": wall_time}``. Running on its own
thread is what lets the watchdog tell its failure classes apart: a
wedged step loop keeps stamping fresh ``ts`` with a frozen ``step``,
while a dead process stops stamping altogether.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Dict, Optional


def beacon_path(root: str, namespace: str, pod_name: str) -> str:
    """Deterministic per-pod beacon file path, computable when the pod
    spec is built (the operator injects it as env) and when it is read."""
    return os.path.join(root, namespace, pod_name + ".json")


def read_beacon(path: str) -> Optional[Dict[str, float]]:
    try:
        with open(path, "r") as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return None  # absent, mid-replace or torn: the next beat retries
    if not isinstance(raw, dict) or "step" not in raw:
        return None
    return {
        "step": float(raw.get("step", 0.0)),
        "tokens": float(raw.get("tokens", 0.0)),
        "ts": float(raw.get("ts", 0.0)),
    }


class ProgressBeacon:
    """Stamps the worker's progress to ``path`` every ``interval`` s.

    ``step(n, tokens)`` is called from the training loop's per-step hook;
    the writer thread persists the latest values on its own, so a wedged
    step loop still produces fresh ``ts`` stamps.
    """

    def __init__(self, path: str, interval: float = 0.5,
                 clock=time.time) -> None:
        self.path = path
        self.interval = max(float(interval), 0.05)
        self.clock = clock
        self._lock = threading.Lock()
        self._step = 0.0
        self._tokens = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.writes = 0

    def step(self, step: int, tokens: float = 0.0) -> None:
        with self._lock:
            self._step = float(step)
            self._tokens = float(tokens)

    def write_once(self) -> None:
        with self._lock:
            payload = {"step": self._step, "tokens": self._tokens,
                       "ts": self.clock()}
        d = os.path.dirname(self.path)
        try:
            if d:
                os.makedirs(d, exist_ok=True)
            # atomic replace: a reader never sees a torn beacon
            fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".beacon.tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
            self.writes += 1
        except OSError:
            pass  # a lost beacon degrades detection, never training

    def start(self) -> "ProgressBeacon":
        if self._thread is not None:
            return self
        self._stop.clear()
        self.write_once()  # announce liveness before the first step

        def loop() -> None:
            while not self._stop.wait(self.interval):
                self.write_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="kubedl-beacon")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.write_once()  # flush the final step count

    def __enter__(self) -> "ProgressBeacon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["ProgressBeacon", "read_beacon", "beacon_path"]
