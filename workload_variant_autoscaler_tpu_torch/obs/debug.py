"""/debug/* endpoints: the flight recorder's read surface.

WSGI middleware mounted on the metrics server (metrics/__init__.py
`serve(debug_middleware=...)`), INSIDE the kube-auth gate when one is
configured — trace, decision, profile, and goodput payloads describe
the fleet and must not be more public than /metrics itself.

Routes (the canonical table is `DEBUG_ROUTES`; wvalint WVL307 holds
every entry to auth-gate test coverage in
tests/test_metrics_auth.py::TestDebugRoutesAuthGated):

- `GET /debug/traces[?limit=N]` — the last N reconcile-cycle traces
  (newest first) from the tracer ring, full span trees with events.
- `GET /debug/decisions[?variant=V&namespace=NS&limit=N]` — the last N
  DecisionRecords (newest first), optionally filtered; what the
  `explain` CLI consumes.
- `GET /debug/profile[?cycle=N&limit=N]` — the last N per-cycle
  wall-clock attribution ledgers (obs/profile.py), newest first, or
  exactly cycle N; what the `controller profile` CLI consumes.
- `GET /debug/goodput[?window=N]` — the live GoodputMeter's rolling
  ledger: windowed summary (goodput fraction, SLO attainment, badput
  fractions) + the retained per-tick entries, optionally re-clipped to
  the trailing N seconds; what the `controller goodput` CLI consumes.

Stdlib-only, no intra-repo imports (see obs/trace.py's import rule).
"""

from __future__ import annotations

import json
from typing import Optional
from urllib.parse import parse_qs

from .decision import DecisionLog
from .goodput import GoodputMeter
from .profile import Profiler
from .trace import Tracer

# every route the middleware mounts, in one table: the auth-gate test
# enumerates THIS tuple (so a new route cannot ship ungated), and
# wvalint WVL307 holds the route strings below to test coverage
DEBUG_ROUTES = ("/debug/traces", "/debug/decisions", "/debug/profile",
                "/debug/goodput")


def _int_param(params: dict, key: str, default: Optional[int]) -> Optional[int]:
    raw = params.get(key, [""])[0]
    try:
        val = int(raw)
    except ValueError:
        return default
    return val if val > 0 else default


def debug_middleware(tracer: Optional[Tracer],
                     decisions: Optional[DecisionLog],
                     profiler: Optional[Profiler] = None,
                     goodput: Optional[GoodputMeter] = None):
    """app -> app wrapper adding the /debug/* routes in front of
    whatever the inner app (the Prometheus exposition) serves."""

    def wrap(inner_app):
        def app(environ, start_response):
            path = environ.get("PATH_INFO", "") or ""
            if not path.startswith("/debug/"):
                return inner_app(environ, start_response)
            params = parse_qs(environ.get("QUERY_STRING", "") or "")
            limit = _int_param(params, "limit", None)
            if path.rstrip("/") == "/debug/traces" and tracer is not None:
                body = {"traces": tracer.snapshot(limit=limit or 16)}
            elif path.rstrip("/") == "/debug/decisions" \
                    and decisions is not None:
                body = {"decisions": decisions.snapshot(
                    variant=params.get("variant", [""])[0],
                    namespace=params.get("namespace", [""])[0],
                    limit=limit or 64,
                )}
            elif path.rstrip("/") == "/debug/profile" \
                    and profiler is not None:
                body = {"profiles": profiler.snapshot(
                    limit=limit or 8,
                    cycle=_int_param(params, "cycle", None),
                )}
            elif path.rstrip("/") == "/debug/goodput" \
                    and goodput is not None:
                window = _int_param(params, "window", None)
                window_s = float(window) if window is not None else None
                body = {"summary": goodput.summary(window_s),
                        "ticks": goodput.ledger(window_s)}
            else:
                payload = json.dumps({"error": "not found"}).encode()
                start_response("404 Not Found", [
                    ("Content-Type", "application/json"),
                    ("Content-Length", str(len(payload))),
                ])
                return [payload]
            payload = json.dumps(body, default=str).encode()
            start_response("200 OK", [
                ("Content-Type", "application/json"),
                ("Content-Length", str(len(payload))),
            ])
            return [payload]

        return app

    return wrap
