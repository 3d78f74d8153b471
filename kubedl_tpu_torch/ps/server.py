"""HTTP front + thin client for the parameter service: the port's copy
of ``kubedl_tpu/ps/server.py``. The wire is the reference's byte for
byte, so a client of either package talks to a server of the other.

Real multi-process workers (training subprocesses, the verify drive)
can't share a Python object with the aggregation tier, so this module
puts the same ThreadingHTTPServer JSON pattern the blob server uses in
front of one :class:`~kubedl_tpu_torch.ps.service.ParameterService`:

- ``POST /ps/register|pull|push|deregister`` — the worker protocol.
  Arrays cross the wire as nested JSON lists (these are small test-scale
  models; a production tier would use a binary framing).
- ``POST /ps/admin {"op": "fail_shard"|"recover_shard", "shard": i}`` —
  chaos control from the driving process.
- ``GET /ps/stats`` — membership/version introspection.

Exception mapping is part of the protocol: 409 = :class:`PushRejected`
(body carries current shard versions so the client re-pulls without an
extra round trip), 410 = :class:`MemberEvicted` (re-register to rejoin),
503 = transient (injected fault / shard down) — the client surfaces it
as :class:`PSUnavailable` and the worker retries.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from kubedl_tpu_torch.chaos import FaultInjected
from kubedl_tpu_torch.ps.service import (
    MemberEvicted,
    ParameterService,
    PushRejected,
    PushResult,
    ShardUnavailable,
)

log = logging.getLogger("kubedl_tpu_torch.ps.server")


class PSUnavailable(Exception):
    """Transient transport/service failure; the worker should retry."""


def _encode_params(params: Dict[str, np.ndarray]) -> Dict[str, list]:
    return {k: np.asarray(v).tolist() for k, v in params.items()}


def _decode_params(params: Dict[str, list]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v, dtype=np.float32) for k, v in params.items()}


class PSServer:
    """Serve one :class:`ParameterService` over HTTP."""

    def __init__(self, service: ParameterService, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.service = service
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug(fmt, *args)

            def _json(self, code: int, payload) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/ps/stats":
                    self._json(200, server.service.stats())
                elif self.path == "/healthz":
                    self._json(200, {"status": "ok"})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except Exception as e:
                    self._json(400, {"error": str(e)})
                    return
                try:
                    self._json(200, server._dispatch(self.path, req))
                except PushRejected as e:
                    self._json(409, {"error": str(e), "versions": e.versions})
                except MemberEvicted as e:
                    self._json(410, {"error": str(e)})
                except (FaultInjected, ShardUnavailable) as e:
                    self._json(503, {"error": str(e)})
                except Exception as e:
                    self._json(500, {"error": str(e)})

        class Server(ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                # a preempted worker dying mid-request is this tier's
                # NORMAL case, not a server error worth a traceback
                exc = sys.exc_info()[1]
                if isinstance(exc, (BrokenPipeError, ConnectionError)):
                    log.debug("client %s vanished: %s", client_address, exc)
                    return
                super().handle_error(request, client_address)

        self._http = Server((host, port), Handler)
        self.host, self.port = self._http.server_address[:2]
        self.addr = f"{self.host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def _dispatch(self, path: str, req: dict) -> dict:
        svc = self.service
        worker = req.get("worker", "")
        if path == "/ps/register":
            params, versions = svc.register(worker)
            return {"params": _encode_params(params), "versions": versions}
        if path == "/ps/pull":
            params, versions = svc.pull(worker)
            return {"params": _encode_params(params), "versions": versions}
        if path == "/ps/push":
            res = svc.push(
                worker, int(req.get("step", 0)),
                _decode_params(req.get("deltas") or {}),
                versions=req.get("versions"),
            )
            return {
                "outcome": res.outcome, "weight": res.weight,
                "staleness": res.staleness, "versions": res.versions,
            }
        if path == "/ps/deregister":
            svc.deregister(
                worker,
                commit_in_flight=bool(req.get("commit", True)),
                reason=req.get("reason", "departed"),
            )
            return {"ok": True}
        if path == "/ps/admin":
            op = req.get("op", "")
            shard = int(req.get("shard", 0))
            if op == "fail_shard":
                svc.fail_shard(shard)
                return {"ok": True}
            if op == "recover_shard":
                return {"fence": svc.recover_shard(shard)}
            raise ValueError(f"unknown admin op {op!r}")
        raise ValueError(f"unknown path {path!r}")

    def start(self) -> "PSServer":
        self._thread = threading.Thread(
            target=self._http.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="ps-server",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "PSServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class PSClient:
    """Duck-types the worker-facing surface of :class:`ParameterService`
    (register / pull / push / deregister) over HTTP, so
    ``Trainer.fit_ps`` takes either one interchangeably."""

    def __init__(self, addr: str, timeout: float = 10.0) -> None:
        self.base = addr if addr.startswith("http") else f"http://{addr}"
        self.timeout = timeout

    def _post(self, path: str, payload: dict) -> dict:
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            f"{self.base}{path}", data=body,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            detail = {}
            try:
                detail = json.loads(e.read() or b"{}")
            except Exception:
                pass
            msg = detail.get("error", str(e))
            if e.code == 409:
                raise PushRejected(msg, versions=detail.get("versions"))
            if e.code == 410:
                raise MemberEvicted(msg)
            if e.code == 503:
                raise PSUnavailable(msg)
            raise PSUnavailable(f"HTTP {e.code}: {msg}")
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            raise PSUnavailable(str(e))

    def register(self, worker: str) -> Tuple[Dict[str, np.ndarray], List[int]]:
        out = self._post("/ps/register", {"worker": worker})
        return _decode_params(out["params"]), list(out["versions"])

    def pull(self, worker: str) -> Tuple[Dict[str, np.ndarray], List[int]]:
        out = self._post("/ps/pull", {"worker": worker})
        return _decode_params(out["params"]), list(out["versions"])

    def push(self, worker: str, step: int, deltas: Dict[str, np.ndarray],
             versions: Optional[List[int]] = None) -> PushResult:
        out = self._post("/ps/push", {
            "worker": worker, "step": step,
            "deltas": _encode_params(deltas), "versions": versions,
        })
        return PushResult(
            outcome=out["outcome"], weight=float(out["weight"]),
            staleness=int(out["staleness"]), versions=list(out["versions"]),
        )

    def deregister(self, worker: str, commit_in_flight: bool = True,
                   reason: str = "departed") -> None:
        self._post("/ps/deregister", {
            "worker": worker, "commit": commit_in_flight, "reason": reason,
        })

    def stats(self) -> dict:
        try:
            with urllib.request.urlopen(
                f"{self.base}/ps/stats", timeout=self.timeout
            ) as resp:
                return json.loads(resp.read() or b"{}")
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            raise PSUnavailable(str(e))
