"""Scrapeable live metrics endpoint, a framework-free copy of
``repro.serving.metrics_server``.

A stdlib ``http.server`` on a daemon thread, so a serving cluster is
observable while it runs:

  * ``GET /metrics``  -- Prometheus text exposition
    (``ClusterMetrics.export_prometheus``),
  * ``GET /healthz``  -- JSON liveness summary (replica counts, retire /
    callback error counters, drift events, the watchdog's roll-up),
  * ``GET /snapshot`` -- the full JSON metrics snapshot.

The handler calls the snapshot providers on the request thread; everything
they touch is behind the metrics locks, so a scrape never tears a snapshot
and never blocks the decode loop for longer than one snapshot assembly.
Binding to port 0 picks a free port; the bound port is ``server.port``
after ``start()``.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Daemon-thread HTTP server over callable metric providers."""

    def __init__(self, prometheus_fn: Callable[[], str],
                 healthz_fn: Optional[Callable[[], dict]] = None,
                 snapshot_fn: Optional[Callable[[], dict]] = None,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self._prometheus_fn = prometheus_fn
        self._healthz_fn = healthz_fn
        self._snapshot_fn = snapshot_fn
        self._host = host
        self._port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "MetricsServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib casing)
                try:
                    outer._route(self)
                except BrokenPipeError:
                    pass
                except Exception as e:
                    try:
                        self.send_error(500, explain=repr(e))
                    except Exception:
                        pass

            def log_message(self, *a) -> None:
                pass  # scrapes must not spam the serving process's stderr

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-server",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Shut the listener down, close its socket, and join the daemon
        thread, so callers exit without leaked sockets or threads.
        Idempotent."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    close = stop  # conventional alias: the clean-shutdown contract

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def port(self) -> int:
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self._port}"

    # -- routing ------------------------------------------------------------

    def _route(self, handler: BaseHTTPRequestHandler) -> None:
        path = handler.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/metrics":
            body = self._prometheus_fn().encode()
            self._reply(handler, 200, PROM_CONTENT_TYPE, body)
        elif path == "/healthz":
            health = (self._healthz_fn() if self._healthz_fn is not None
                      else {"status": "ok"})
            code = 200 if health.get("status") == "ok" else 503
            self._reply(handler, code, "application/json",
                        json.dumps(health).encode())
        elif path == "/snapshot" and self._snapshot_fn is not None:
            self._reply(handler, 200, "application/json",
                        json.dumps(self._snapshot_fn()).encode())
        else:
            handler.send_error(404)

    @staticmethod
    def _reply(handler: BaseHTTPRequestHandler, code: int,
               ctype: str, body: bytes) -> None:
        handler.send_response(code)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)


_STATUS_RANK = {"ok": 0, "degraded": 1, "unhealthy": 2}


def cluster_healthz(cluster) -> dict:
    """Liveness summary for a ``ServingCluster``: the watchdog roll-up
    (``cluster.health()``: per-replica state, degraded flag, eviction
    ledger) combined with the retirement-fault check (retire_errors: a lost
    completion is the one error class that corrupts results silently).
    Overall status is the worst of the two."""
    snap = cluster.metrics.snapshot()
    counters = snap["aggregate"]["counters"]
    retire_errors = counters.get("retire_errors", 0)
    status = "ok" if retire_errors == 0 else "degraded"
    out = {
        "replicas_active": snap["replicas_active"],
        "standby": len(getattr(cluster, "_standby", ())),
        "draining": len(getattr(cluster, "_draining", ())),
        "completed": counters.get("completed", 0),
        "rejected": counters.get("rejected", 0),
        "failed": counters.get("cluster_failed", 0),
        "retire_errors": retire_errors,
        "callback_errors": counters.get("callback_errors", 0),
        "expert_drift_events": counters.get("expert_drift", 0),
    }
    health_fn = getattr(cluster, "health", None)
    if callable(health_fn):
        wd = health_fn()
        if _STATUS_RANK.get(wd.get("status"), 0) > _STATUS_RANK[status]:
            status = wd["status"]
        out["replicas"] = wd.get("replicas", {})
        out["evicted"] = wd.get("evicted", [])
        out["degraded"] = wd.get("degraded", False)
    out["status"] = status
    return out


def serve_cluster_metrics(cluster, host: str = "127.0.0.1",
                          port: int = 0) -> MetricsServer:
    """Wire a ``ServingCluster``'s metrics to a started ``MetricsServer``
    (the ``launch/serve.py --metrics-port`` path)."""
    return MetricsServer(
        cluster.metrics.export_prometheus,
        healthz_fn=lambda: cluster_healthz(cluster),
        snapshot_fn=cluster.metrics.snapshot,
        host=host, port=port,
    ).start()
