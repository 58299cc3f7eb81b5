"""Serving controller: worker registry, heartbeats and dispatch, the port's
copy of lavida_mod_tpu/serve/controller.py (standard library only; the port
imports nothing of the JAX package).

Capability parity with reference llava/serve/controller.py:58-298 (worker
registration, heartbeat expiry, lottery / shortest-queue dispatch, request
proxying) on http.server and urllib.

API (JSON over HTTP):
  POST /register_worker    {worker_name, check_heart_beat, worker_status}
  POST /receive_heart_beat {worker_name, queue_length}
  POST /refresh_all_workers
  POST /list_models
  POST /get_worker_address {model}
  POST /worker_generate_stream {model, ...}   (proxied to a worker)

Usage:
  python -m lavida_mod_tpu_torch.serve.controller [--host 0.0.0.0]
      [--port 10000] [--dispatch-method shortest_queue|lottery]
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

HEART_BEAT_EXPIRATION = 90


@dataclasses.dataclass
class WorkerInfo:
    model_names: list
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


def _post(url: str, payload: dict, timeout: float = 5.0) -> dict:
    req = urllib.request.Request(
        url, json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def json_handler(handle):
    """A request handler class that answers every POST with
    `handle(path, payload)` as JSON."""

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            self._send(json.dumps(handle(self.path, payload)).encode(),
                       "application/json")

        def _send(self, body: bytes, kind: str):
            self.send_response(200)
            self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    return Handler


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        assert dispatch_method in ("lottery", "shortest_queue")
        self.dispatch_method = dispatch_method
        self.worker_info: dict[str, WorkerInfo] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------

    def register_worker(self, worker_name: str, check_heart_beat: bool,
                        worker_status: Optional[dict]) -> bool:
        if worker_status is None:
            try:
                worker_status = _post(worker_name + "/worker_get_status", {})
            except Exception:
                return False
        with self._lock:
            self.worker_info[worker_name] = WorkerInfo(
                worker_status["model_names"], worker_status.get("speed", 1.0),
                worker_status.get("queue_length", 0), check_heart_beat,
                time.time(),
            )
        return True

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self._lock:
            if worker_name not in self.worker_info:
                return False
            w = self.worker_info[worker_name]
            w.queue_length = queue_length
            w.last_heart_beat = time.time()
        return True

    def remove_stale_workers(self):
        expire = time.time() - HEART_BEAT_EXPIRATION
        with self._lock:
            stale = [
                n for n, w in self.worker_info.items()
                if w.check_heart_beat and w.last_heart_beat < expire
            ]
            for n in stale:
                del self.worker_info[n]

    def refresh_all_workers(self):
        info = dict(self.worker_info)
        self.worker_info = {}
        for name, w in info.items():
            self.register_worker(name, w.check_heart_beat, None)

    def list_models(self) -> list[str]:
        models = set()
        for w in self.worker_info.values():
            models.update(w.model_names)
        return sorted(models)

    def get_worker_address(self, model_name: str) -> str:
        with self._lock:
            candidates = [
                (n, w) for n, w in self.worker_info.items()
                if model_name in w.model_names
            ]
        if not candidates:
            return ""
        if self.dispatch_method == "lottery":
            speeds = [w.speed for _, w in candidates]
            total = sum(speeds)
            r = random.random() * total
            acc = 0.0
            for (n, w), s in zip(candidates, speeds):
                acc += s
                if r <= acc:
                    return n
            return candidates[-1][0]
        # shortest queue, speed-normalized (controller.py:117-166)
        qlens = [w.queue_length / max(w.speed, 1e-6) for _, w in candidates]
        name, w = candidates[int(min(range(len(qlens)), key=qlens.__getitem__))]
        w.queue_length += 1
        return name

    # ------------------------------------------------------------------

    def handle(self, path: str, payload: dict) -> dict:
        if path == "/register_worker":
            ok = self.register_worker(
                payload["worker_name"], payload.get("check_heart_beat", True),
                payload.get("worker_status"),
            )
            return {"exist": ok}
        if path == "/receive_heart_beat":
            return {"exist": self.receive_heart_beat(
                payload["worker_name"], payload.get("queue_length", 0)
            )}
        if path == "/refresh_all_workers":
            self.refresh_all_workers()
            return {}
        if path == "/list_models":
            self.remove_stale_workers()
            return {"models": self.list_models()}
        if path == "/get_worker_address":
            return {"address": self.get_worker_address(payload["model"])}
        if path == "/worker_generate_stream":
            addr = self.get_worker_address(payload["model"])
            if not addr:
                return {"text": "", "error_code": 2,
                        "error": "no worker for model"}
            return _post(addr + "/worker_generate", payload, timeout=600)
        return {"error": f"unknown path {path}", "error_code": 1}

    def server(self, host: str = "0.0.0.0",
               port: int = 10000) -> ThreadingHTTPServer:
        """The HTTP server, bound (port 0: any free port, in
        `server_address`) and not yet serving."""
        return ThreadingHTTPServer((host, port), json_handler(self.handle))

    def serve(self, host: str = "0.0.0.0", port: int = 10000):
        server = self.server(host, port)
        print(f"[controller] listening on {host}:{server.server_address[1]}")
        server.serve_forever()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=10000)
    ap.add_argument("--dispatch-method", default="shortest_queue")
    a = ap.parse_args()
    Controller(a.dispatch_method).serve(a.host, a.port)
