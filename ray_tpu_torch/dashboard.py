"""Dashboard: an HTTP window onto cluster state.

Equivalent of the reference's ``dashboard/`` (head-node web UI +
``dashboard/modules/*`` REST endpoints), scoped to what a GPU-cluster
operator actually debugs with: nodes, actors, tasks, objects, workers,
placement groups, jobs, metrics, and a downloadable Perfetto timeline.
Redesign: a stdlib ThreadingHTTPServer thread inside the driver process
serving JSON from the state API — no Node.js build, no agent processes.

The port of ``ray_tpu/dashboard.py``, over the port's state API: ``jobs``
reads the port's job manager actor, and the timeline's temp file and the
server thread carry the port's names.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

def _ui_html() -> bytes:
    """The single-file SPA (``dashboard_ui.html`` next to this module —
    the reference ships a React build in ``dashboard/client/``; here one
    no-build HTML file renders the same overview pages from the JSON
    API)."""
    import os

    path = os.path.join(os.path.dirname(__file__), "dashboard_ui.html")
    with open(path, "rb") as f:
        return f.read()


_ENDPOINTS = [
    "nodes", "actors", "tasks", "objects", "workers",
    "placement_groups", "jobs", "metrics", "cluster_resources",
    "available_resources", "timeline", "grafana_dashboard",
    "errors", "diagnostics", "traces", "memory", "profiles", "loops",
]


def _collect(endpoint: str):
    from .core import api as core_api
    from .util import state

    if endpoint == "nodes":
        return state.list_nodes()
    if endpoint == "actors":
        return state.list_actors()
    if endpoint == "tasks":
        return state.list_tasks()
    if endpoint == "objects":
        return state.list_objects()
    if endpoint == "workers":
        return state.list_workers()
    if endpoint == "errors":
        return state.list_errors()
    if endpoint == "diagnostics":
        return state.cluster_diagnostics()
    if endpoint == "traces":
        return state.list_traces()
    if endpoint == "memory":
        return state.memory_summary()
    if endpoint == "profiles":
        return state.list_profiles()
    if endpoint == "loops":
        # Compiled-loop stall attribution (driver-local: the dashboard
        # thread runs in the driver, which owns the CompiledLoop objects).
        return state.loop_stats()
    if endpoint == "placement_groups":
        return state.list_placement_groups()
    if endpoint == "jobs":
        from .job.job_manager import JOB_MANAGER_NAME

        try:
            mgr = core_api.get_actor(JOB_MANAGER_NAME)
        except ValueError:
            return []
        return core_api.get(mgr.list.remote(), timeout=30)
    if endpoint == "metrics":
        from .util.metrics import get_metrics

        return get_metrics()
    if endpoint == "cluster_resources":
        return core_api.cluster_resources()
    if endpoint == "available_resources":
        return core_api.available_resources()
    if endpoint == "grafana_dashboard":
        from .grafana import generate_dashboard

        return generate_dashboard()
    if endpoint == "timeline":
        # Chrome-trace JSON, loadable in Perfetto (reference ray.timeline).
        # Unique temp file per request: ThreadingHTTPServer handles
        # requests concurrently and the trace write is not atomic.
        import os
        import tempfile

        from . import timeline as dump_timeline

        fd, path = tempfile.mkstemp(prefix="raytpu_torch_timeline_",
                                    suffix=".json")
        os.close(fd)
        try:
            dump_timeline(path)
            with open(path) as f:
                return json.load(f)
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass
    raise KeyError(endpoint)


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # quiet
        pass

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        if path in ("", "/index.html"):
            self._send(200, _ui_html(), "text/html; charset=utf-8")
            return
        if path == "/metrics":
            # Prometheus scrape endpoint (reference: per-node metrics
            # agent re-export; one process here).
            try:
                from .util.metrics import prometheus_text

                self._send(200, prometheus_text().encode(), "text/plain; version=0.0.4")
            except Exception as e:
                self._send(500, f"# error: {e}\n".encode(), "text/plain")
            return
        if path == "/-/healthz":
            self._send(200, b'"ok"', "application/json")
            return
        if path == "/api/serve/applications":
            # Serve REST status (reference dashboard serve REST API).
            try:
                from .serve.config_api import serve_status

                self._send(200, json.dumps(serve_status(), default=str).encode(),
                           "application/json")
            except Exception as e:
                self._send(500, json.dumps({"error": f"{type(e).__name__}: {e}"}).encode(),
                           "application/json")
            return
        if path.startswith("/api/"):
            endpoint = path[len("/api/"):]
            if endpoint not in _ENDPOINTS:
                self._send(404, json.dumps({"error": f"unknown endpoint {endpoint}"}).encode(),
                           "application/json")
                return
            try:
                data = _collect(endpoint)
                self._send(200, json.dumps(data, default=str).encode(), "application/json")
            except Exception as e:
                self._send(500, json.dumps({"error": f"{type(e).__name__}: {e}"}).encode(),
                           "application/json")
            return
        self._send(404, b'{"error": "not found"}', "application/json")

    def do_PUT(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        if path != "/api/serve/applications":
            self._send(404, b'{"error": "not found"}', "application/json")
            return
        # Declarative deploy (reference PUT /api/serve/applications/).
        try:
            length = int(self.headers.get("Content-Length", 0))
            config = json.loads(self.rfile.read(length))
            from .serve.config_api import deploy_config

            deployed = deploy_config(config)
            self._send(200, json.dumps({"deployed": deployed}).encode(),
                       "application/json")
        except Exception as e:
            self._send(500, json.dumps({"error": f"{type(e).__name__}: {e}"}).encode(),
                       "application/json")

    def do_DELETE(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        prefix = "/api/serve/applications/"
        if not path.startswith(prefix):
            self._send(404, b'{"error": "not found"}', "application/json")
            return
        try:
            from .serve import api as serve_api

            serve_api.delete(path[len(prefix):])
            self._send(200, b'{"deleted": true}', "application/json")
        except Exception as e:
            self._send(500, json.dumps({"error": f"{type(e).__name__}: {e}"}).encode(),
                       "application/json")


class Dashboard:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="raytpu-torch-dashboard"
        )
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


_dashboard: Dashboard | None = None


def start_dashboard(host: str = "127.0.0.1", port: int = 0) -> str:
    """Start (or return) the dashboard; returns its URL."""
    global _dashboard
    if _dashboard is None:
        _dashboard = Dashboard(host, port)
    return _dashboard.url


def stop_dashboard() -> None:
    global _dashboard
    if _dashboard is not None:
        _dashboard.stop()
        _dashboard = None
