"""Served operational surface (ref pkg/operator/operator.go:126-177):
a metrics server (`/metrics`, `/debug/traces[/last]`, plus
`/debug/pprof/*` when profiling is enabled) and a probe server
(`/healthz`, `/readyz`).

The reference gets these from controller-runtime's manager; here they
are two stdlib ThreadingHTTPServers. The pprof equivalents are a live
all-thread stack dump, and a sampling profiler over
``sys._current_frames`` that emits collapsed stacks (flamegraph input) —
the closest Python analogue of ``/debug/pprof/profile``.

The port's copy of ``karpenter_core_tpu/operator/server.py``, with every
route of the reference's. ``/debug/device`` serves the port's device
plane (``tracing.deviceplane``).
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# route → (status, content_type, body) producer
Route = Callable[[Dict[str, list]], Tuple[int, str, str]]


def _stack_dump(_query) -> Tuple[int, str, str]:
    lines = []
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sys._current_frames().items():
        lines.append(f"goroutine-equivalent thread {ident} [{names.get(ident, '?')}]:")
        lines.extend(l.rstrip() for l in traceback.format_stack(frame))
        lines.append("")
    return 200, "text/plain; charset=utf-8", "\n".join(lines)


# single-flight gate for the sampling profiler: two overlapping captures
# would double-count samples (both walk sys._current_frames and see each
# other's handler thread) and burn two threads at 100 Hz
_PROFILE_GATE = threading.Lock()


def _collapsed_profile(query) -> Tuple[int, str, str]:
    """Sample every thread's stack for ?seconds=N (default 2, max 30) at
    ~100 Hz; emit one collapsed stack per line with its sample count.
    Concurrent captures are rejected with 429."""
    try:
        seconds = min(float(query.get("seconds", ["2"])[0]), 30.0)
    except ValueError:
        return 400, "text/plain", "bad seconds parameter\n"
    if not _PROFILE_GATE.acquire(blocking=False):
        return 429, "text/plain", "profile capture already in flight\n"
    try:
        me = threading.get_ident()
        samples: Counter = Counter()
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                stack = []
                while frame is not None:
                    code = frame.f_code
                    stack.append(f"{code.co_name} ({code.co_filename}:{frame.f_lineno})")
                    frame = frame.f_back
                if stack:
                    samples[";".join(reversed(stack))] += 1
            time.sleep(0.01)
    finally:
        _PROFILE_GATE.release()
    body = "".join(f"{stack} {count}\n" for stack, count in samples.most_common())
    return 200, "text/plain; charset=utf-8", body or "no samples\n"


def _traces(query) -> Tuple[int, str, str]:
    """Chrome trace-event JSON of the buffered solve traces
    (Perfetto / chrome://tracing loadable). ``?id=<trace_id>`` selects
    one trace; default is every trace still in the ring."""
    from ..tracing import RING, to_chrome_json

    wanted = query.get("id", [None])[0]
    if wanted is not None:
        tr = RING.get(wanted)
        if tr is None:
            return 404, "text/plain", f"no buffered trace {wanted}\n"
        traces = [tr]
    else:
        traces = RING.all()
    return 200, "application/json", to_chrome_json(traces)


def _traces_last(_query) -> Tuple[int, str, str]:
    """The most recent solve trace as Chrome trace-event JSON."""
    from ..tracing import RING, to_chrome_json

    tr = RING.last()
    if tr is None:
        return 404, "text/plain", "no solve traces captured yet\n"
    return 200, "application/json", to_chrome_json([tr])


def _device(query) -> Tuple[int, str, str]:
    """The device plane (tracing/deviceplane.py): the signature registry
    with each kernel's launches, the process's compile (library load) and
    transfer totals, and the recent compile events with their trace ids,
    plus the kernel libraries' status and the boot prewarm's outcome.
    ``?tail=N`` bounds the event list (default 32)."""
    import json

    from ..solver import backend, prewarm
    from ..tracing import deviceplane

    try:
        tail = int(query.get("tail", ["32"])[0])
    except ValueError:
        return 400, "text/plain", "bad tail parameter\n"
    state = deviceplane.debug_state(tail=tail)
    state["compile_cache"] = backend.compile_cache_status()
    state["prewarm"] = prewarm.last_result()
    return 200, "application/json", json.dumps(state, default=str)


def _decisions(query) -> Tuple[int, str, str]:
    """The flight recorder's ring (tracing/flightrec.py): per-decision
    records with SLO burn rates and timeline-reconstruction coverage.
    ``?tail=N`` bounds the decision list (default 32)."""
    import json

    from ..tracing import RECORDER

    try:
        tail = int(query.get("tail", ["32"])[0])
    except ValueError:
        return 400, "text/plain", "bad tail parameter\n"
    return 200, "application/json", json.dumps(RECORDER.debug_state(tail=tail), default=str)


def _decisions_last(_query) -> Tuple[int, str, str]:
    """The most recent decision's flight record."""
    import json

    from ..tracing import RECORDER

    rec = RECORDER.last()
    if rec is None:
        return 404, "text/plain", "no decisions recorded yet\n"
    return 200, "application/json", json.dumps(rec, default=str)


class _Handler(BaseHTTPRequestHandler):
    # routes injected per-server via the server instance
    def do_GET(self):  # noqa: N802 — http.server API
        parsed = urlparse(self.path)
        route = self.server.routes.get(parsed.path)  # type: ignore[attr-defined]
        if route is None:
            self.send_error(404)
            return
        status, content_type, body = route(parse_qs(parsed.query))
        payload = body.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, fmt, *args):  # quiet: probes poll every few seconds
        pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, port: int, routes: Dict[str, Route]):
        super().__init__(("0.0.0.0", port), _Handler)
        self.routes = routes


class OperationalServer:
    """Binds the metrics and probe ports and serves them from daemon
    threads. ``port`` 0 binds an ephemeral port (tests); the bound ports
    are exposed as ``metrics_port`` / ``probe_port`` after start()."""

    def __init__(
        self,
        registry,
        ready_check: Callable[[], bool],
        metrics_port: int = 8000,
        probe_port: int = 8081,
        enable_profiling: bool = False,
        logger=None,
        serving_state: Optional[Callable[[], dict]] = None,
        fleet_state: Optional[Callable[[], dict]] = None,
        solve_stats: Optional[Callable[[], Optional[dict]]] = None,
    ):
        self.registry = registry
        self.ready_check = ready_check
        self._metrics_port = metrics_port
        self._probe_port = probe_port
        self.enable_profiling = enable_profiling
        self.logger = logger
        # serving-pipeline introspection hook (ServingPipeline.debug_state)
        self.serving_state = serving_state
        # fleet introspection hook (FleetEngine/FleetScheduler state:
        # registry, last batch composition, DRR deficits)
        self.fleet_state = fleet_state
        # consolidated per-solve stats hook (solver/stats.py): the one
        # stable schema over the scattered last_* stat blobs
        self.solve_stats = solve_stats
        self._metrics_server: Optional[_Server] = None
        self._probe_server: Optional[_Server] = None

    # -- route payloads -----------------------------------------------------

    def _metrics(self, _query) -> Tuple[int, str, str]:
        return 200, PROMETHEUS_CONTENT_TYPE, self.registry.expose()

    def _healthz(self, _query) -> Tuple[int, str, str]:
        return 200, "text/plain", "ok\n"

    def _readyz(self, _query) -> Tuple[int, str, str]:
        # operator.go:171-175: readiness is cache sync
        if self.ready_check():
            return 200, "text/plain", "ok\n"
        return 503, "text/plain", "caches not synced\n"

    def _serving(self, _query) -> Tuple[int, str, str]:
        """Serving-pipeline state: queue depths/backpressure, tick log,
        prewarm traffic, decision-latency percentiles."""
        import json

        if self.serving_state is None:
            return 404, "text/plain", "serving pipeline not running\n"
        try:
            payload = json.dumps(self.serving_state(), default=str)
        except Exception as err:  # noqa: BLE001 — a debug route must not 500 the server
            return 500, "text/plain", f"serving state unavailable: {err}\n"
        return 200, "application/json", payload

    def _fleet(self, _query) -> Tuple[int, str, str]:
        """Fleet state: tenant registry, last mega-solve round
        composition, dispatcher coalescing stats, DRR deficits."""
        import json

        if self.fleet_state is None:
            return 404, "text/plain", "fleet solver not running\n"
        try:
            payload = json.dumps(self.fleet_state(), default=str)
        except Exception as err:  # noqa: BLE001 — a debug route must not 500 the server
            return 500, "text/plain", f"fleet state unavailable: {err}\n"
        return 200, "application/json", payload

    def _solve_stats(self, _query) -> Tuple[int, str, str]:
        """Consolidated per-solve stats (solver/stats.py SCHEMA): one
        stable document over timings/cache/merge/pack-backend/disruption
        — the blob the bench readers and dashboards consume."""
        import json

        if self.solve_stats is None:
            return 404, "text/plain", "no solver wired\n"
        try:
            payload = self.solve_stats()
        except Exception as err:  # noqa: BLE001 — a debug route must not 500 the server
            return 500, "text/plain", f"solve stats unavailable: {err}\n"
        if payload is None:
            return 404, "text/plain", "no solve has completed yet\n"
        return 200, "application/json", json.dumps(payload, default=str)

    # -- lifecycle ----------------------------------------------------------

    @property
    def metrics_port(self) -> Optional[int]:
        return self._metrics_server.server_address[1] if self._metrics_server else None

    @property
    def probe_port(self) -> Optional[int]:
        return self._probe_server.server_address[1] if self._probe_server else None

    def _bind(self, port: int, routes: Dict[str, Route]) -> Optional[_Server]:
        try:
            server = _Server(port, routes)
        except OSError as err:
            # a busy port must not take the operator down; the rest of
            # the surface (and the controllers) keep running
            if self.logger is not None:
                self.logger.error("failed to bind port %s: %s", port, err)
            return None
        threading.Thread(target=server.serve_forever, name=f"http-{port}", daemon=True).start()
        return server

    def start(self) -> None:
        metrics_routes: Dict[str, Route] = {
            "/metrics": self._metrics,
            # solve traces are always on: the tracer's steady-state cost
            # is a few dozen span records per solve, and the routes only
            # read the ring buffer
            "/debug/traces": _traces,
            "/debug/traces/last": _traces_last,
            # the flight recorder rides the same always-on policy as the
            # trace ring: the routes only read the bounded ring
            "/debug/decisions": _decisions,
            "/debug/decisions/last": _decisions_last,
            # the device plane's registry and totals: reads only
            "/debug/device": _device,
        }
        if self.serving_state is not None:
            metrics_routes["/debug/serving"] = self._serving
        if self.fleet_state is not None:
            metrics_routes["/debug/fleet"] = self._fleet
        if self.solve_stats is not None:
            metrics_routes["/debug/solve/stats"] = self._solve_stats
        if self.enable_profiling:
            metrics_routes["/debug/pprof/"] = _stack_dump
            metrics_routes["/debug/pprof/profile"] = _collapsed_profile
        probe_routes: Dict[str, Route] = {"/healthz": self._healthz, "/readyz": self._readyz}
        self._metrics_server = self._bind(self._metrics_port, metrics_routes)
        self._probe_server = self._bind(self._probe_port, probe_routes)

    def stop(self) -> None:
        for server in (self._metrics_server, self._probe_server):
            if server is not None:
                server.shutdown()
                server.server_close()
        self._metrics_server = None
        self._probe_server = None
