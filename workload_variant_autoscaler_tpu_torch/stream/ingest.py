"""Ingest layer: the remote-write endpoint + the streamed-scrape poller.

Two ways metric deltas reach the streaming core without waiting for a
reconcile tick:

- **Prometheus remote-write** (`POST /api/v1/write`, mounted beside
  the `/debug/*` routes on the metrics server, INSIDE the auth gate):
  a snappy-compressed protobuf WriteRequest, decoded by the stdlib
  codec in stream/remotewrite.py. The endpoint expects the load
  signals as RECORDING RULES — Prometheus evaluates the same PromQL
  the scrape path uses and forwards just those series here, labelled
  `model_name`/`namespace`:

      wva:stream:arrival_rpm        req/min arrival rate
      wva:stream:avg_input_tokens   mean prompt tokens
      wva:stream:avg_output_tokens  mean generation tokens
      wva:stream:avg_ttft_ms        mean TTFT (advisory)
      wva:stream:avg_itl_ms         mean ITL (advisory)

  One request may carry any subset for any number of groups; per
  (model, namespace) group the newest-timestamp sample of each series
  wins and the group counts as ONE ingest event.

  The door is defended (docs/robustness.md, "Streaming fault matrix"):
  bodies over `WVA_STREAM_MAX_BODY_BYTES` answer 413; malformed bytes
  answer 400/415 with the decode failure METERED on
  `inferno_stream_shed_total{reason="decode-error"}` (the WSGI worker
  never crashes); label-cardinality bombs and semantically-poisoned
  groups are quarantined per group, and a request that lost any group
  answers 429 with `X-Shed-Groups` accounting; a source whose
  quarantine breaker is OPEN answers 429 outright until the breaker's
  cooldown elapses.
- **Streamed scrape** (`ScrapePoller`): the fallback for clusters
  without remote-write plumbing — a daemon thread polling the SAME
  per-variant PromQL the reconcile scrape uses, every
  `WVA_STREAM_SCRAPE_MS` (0, the default, disables it — unless the
  remote-write breaker is open, in which case the poller covers the
  fleet at a fixed fallback cadence until the breaker recovers; the
  cadence backstop still covers everything regardless). Runs on its
  own Prometheus client clone (an HTTP client is not thread-safe) and feeds
  the same `observe_load` door, so the change detector treats both
  paths identically. Poll failures are logged, metered
  (`reason="scrape-error"`), retried through the standard backoff
  ladder, and NEVER kill the thread; the stop event is honored
  promptly, including mid-backoff.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

from ..collector import active_family, collect_load
from ..metrics import (
    SHED_BODY_TOO_LARGE,
    SHED_DECODE_ERROR,
    SHED_QUARANTINE_LABELS,
    SHED_SCRAPE_ERROR,
    SHED_SOURCE_QUARANTINED,
    SOURCE_REMOTE_WRITE,
)
from ..utils import get_logger, kv
from ..utils.backoff import STANDARD_BACKOFF, with_backoff
from .core import ShedError
from .pushdown import RAW_SERIES
from .remotewrite import WireError, parse_write_request, snappy_decompress

log = get_logger("wva.stream.ingest")

REMOTE_WRITE_PATH = "/api/v1/write"

# cardinality-bomb ceilings for one WriteRequest: a series carrying
# more labels than any sane recording rule, or a request minting more
# groups than the whole ingest store holds, is an attack on memory,
# not telemetry
MAX_LABELS_PER_SERIES = 64
MAX_GROUPS_PER_REQUEST = 1024

# poller cadence while the remote-write breaker is open and no explicit
# WVA_STREAM_SCRAPE_MS is configured (the quarantine fallback)
QUARANTINE_POLL_S = 5.0

# remote-write series name -> CollectedLoad field (the recording-rule
# contract; docs/observability.md "Streaming reconcile")
STREAM_SERIES = {
    "wva:stream:arrival_rpm": "arrival_rate_rpm",
    "wva:stream:avg_input_tokens": "avg_input_tokens",
    "wva:stream:avg_output_tokens": "avg_output_tokens",
    "wva:stream:avg_ttft_ms": "avg_ttft_ms",
    "wva:stream:avg_itl_ms": "avg_itl_ms",
}


def ingest_write_request(core, body: bytes,
                         encoding: str = "snappy") -> tuple[int, int]:
    """Decode one remote-write request body and fold it into the core.
    Returns (groups ingested, groups shed) — shed groups are already
    metered on inferno_stream_shed_total by the door that refused them.
    Raises WireError on malformed payloads."""
    if encoding in ("snappy", ""):
        try:
            raw = snappy_decompress(body)
        except WireError:
            if encoding == "snappy":
                raise
            raw = body                     # uncompressed fallback
    elif encoding == "identity":
        raw = body
    else:
        raise WireError(f"unsupported content encoding {encoding!r}")

    # (model, ns) -> field -> (timestamp, value); newest timestamp wins
    groups: dict[tuple, dict] = {}
    # (model, ns) -> [(role, fingerprint, value, ts_ms)] raw-counter
    # samples for the pushdown ledger (stream/pushdown.py); per origin
    # series the newest sample in a request wins, mirroring the
    # rule-series rule (a counter's newest reading subsumes the rest)
    raw_groups: dict[tuple, list] = {}
    pushdown = core.pushdown_enabled()
    shed = 0
    for series in parse_write_request(raw):
        if len(series.labels) > MAX_LABELS_PER_SERIES:
            core.emitter.emit_stream_shed(SHED_QUARANTINE_LABELS)
            shed += 1
            continue
        name = series.labels.get("__name__", "")
        fld = STREAM_SERIES.get(name)
        role = RAW_SERIES.get(name) if pushdown else None
        if (fld is None and role is None) or not series.samples:
            continue
        model = series.labels.get("model_name", "")
        ns = series.labels.get("namespace", "")
        if not model or not ns:
            continue
        key = (model, ns)
        if key not in groups and key not in raw_groups \
                and len(groups) + len(raw_groups) \
                >= MAX_GROUPS_PER_REQUEST:
            core.emitter.emit_stream_shed(SHED_QUARANTINE_LABELS)
            shed += 1
            continue
        value, ts = max(series.samples, key=lambda s: s[1])
        if role is not None:
            # the origin fingerprint is the FULL labelset, __name__
            # included — a pod's seven counters are seven distinct
            # origin series with seven independent monotonic baselines
            fingerprint = tuple(sorted(series.labels.items()))
            raw_groups.setdefault(key, []).append(
                (role, fingerprint, value, float(ts)))
            continue
        best = groups.setdefault(key, {})
        if fld not in best or ts >= best[fld][0]:
            best[fld] = (ts, value)
    # pushdown: advance each group's counter ledger and fold the derived
    # load fields into the same per-group merge the rule series use
    for key, points in raw_groups.items():
        model, ns = key
        try:
            derived = core.ingest_raw(model, ns, points,
                                      source=SOURCE_REMOTE_WRITE)
        except ShedError:
            # poisoned batch — metered inside the ledger; the group's
            # baselines did not advance, the rest of the request lands
            shed += 1
            continue
        if not derived:
            continue                       # baseline-only (first sight)
        raw_ts = max(ts for _r, _f, _v, ts in points)
        best = groups.setdefault(key, {})
        for fld, value in derived.items():
            if fld not in best or raw_ts >= best[fld][0]:
                best[fld] = (raw_ts, value)
    entries = []
    for (model, ns), fields in groups.items():
        newest_ts = max((ts for ts, _v in fields.values()), default=0)
        entries.append((model, ns,
                        {f: v for f, (_ts, v) in fields.items()},
                        float(newest_ts)))
    ingested = 0
    # ONE striped batch through the core: the whole request is vetted
    # and quantized up front, then folded in per store stripe —
    # quarantined/shed entries are metered inside; the rest still land
    for reason, _changed in core.ingest_batch(entries,
                                              source=SOURCE_REMOTE_WRITE):
        if reason is None:
            ingested += 1
        else:
            shed += 1
    return ingested, shed


def remote_write_middleware(core):
    """app -> app wrapper mounting POST /api/v1/write in front of the
    metrics exposition (same composition shape as obs.debug_middleware;
    the caller places it inside the auth gate). Each request to the
    path is timed onto inferno_stream_door_seconds, whatever its
    status."""

    def door(environ, start_response):
        if environ.get("REQUEST_METHOD", "") != "POST":
            return _reply(start_response, "405 Method Not Allowed",
                          {"error": "POST only"})
        if core.source_quarantined(SOURCE_REMOTE_WRITE):
            # the per-source breaker is open: the push door is
            # closed while the ScrapePoller fallback covers the
            # fleet; senders should back off and retry later
            core.emitter.emit_stream_shed(SHED_SOURCE_QUARANTINED)
            return _reply(start_response, "429 Too Many Requests",
                          {"error": "source quarantined"},
                          extra_headers=[("Retry-After", "60")])
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        limit = core.max_body_bytes()
        if length > limit:
            core.emitter.emit_stream_shed(SHED_BODY_TOO_LARGE)
            return _reply(start_response,
                          "413 Request Entity Too Large",
                          {"error": f"body exceeds {limit} bytes"})
        body = environ["wsgi.input"].read(length) if length else b""
        encoding = (environ.get("HTTP_CONTENT_ENCODING")
                    or "snappy").strip().lower()
        try:
            ingested, shed = ingest_write_request(core, body,
                                                  encoding=encoding)
        except WireError as e:
            core.emitter.emit_stream_shed(SHED_DECODE_ERROR)
            status = ("415 Unsupported Media Type"
                      if "content encoding" in str(e)
                      else "400 Bad Request")
            return _reply(start_response, status, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — the WSGI worker must never crash
            core.emitter.emit_stream_shed(SHED_DECODE_ERROR)
            log.warning("remote-write ingest failed",
                        extra=kv(error=str(e)))
            return _reply(start_response, "400 Bad Request",
                          {"error": "malformed payload"})
        if shed:
            # partial refusal: the sender learns exactly how much
            # landed; shed groups are metered and re-covered by the
            # requested backstop pass, never silently lost
            return _reply(start_response, "429 Too Many Requests",
                          {"error": "some groups shed"},
                          extra_headers=[
                              ("X-Ingested-Groups", str(ingested)),
                              ("X-Shed-Groups", str(shed)),
                          ])
        start_response("204 No Content",
                       [("X-Ingested-Groups", str(ingested))])
        return [b""]

    def wrap(inner_app):
        def app(environ, start_response):
            if environ.get("PATH_INFO", "") != REMOTE_WRITE_PATH:
                return inner_app(environ, start_response)
            t0 = time.perf_counter()
            try:
                return door(environ, start_response)
            finally:
                core.emitter.emit_stream_door(time.perf_counter() - t0)

        return app

    return wrap


def _reply(start_response, status: str, body: dict,
           extra_headers: Optional[list] = None):
    payload = json.dumps(body).encode()
    start_response(status, [
        ("Content-Type", "application/json"),
        ("Content-Length", str(len(payload))),
    ] + (extra_headers or []))
    return [payload]


class ScrapePoller:
    """Daemon thread: the streamed-scrape fallback. All configuration is
    fixed at construction; the loop only reads (the knob is re-read
    every iteration so a ConfigMap edit can enable/disable it live).
    The loop survives ANY poll failure: errors are logged, metered
    (`inferno_stream_shed_total{reason="scrape-error"}` — so
    `inferno_stream_events_total{source="scrape"}` keeps counting only
    real sweeps), and retried through the standard backoff ladder with
    the stop event as the sleeper, so shutdown is prompt even
    mid-backoff."""

    def __init__(self, core, stop: threading.Event, prom=None):
        self.core = core
        self.stop = stop
        self.thread: Optional[threading.Thread] = None
        rec = core.rec
        clone = getattr(rec.prom, "clone", None)
        self.prom = prom if prom is not None else (
            clone() if callable(clone) else rec.prom)

    def _period_s(self) -> float:
        period = self.core._knob("WVA_STREAM_SCRAPE_MS", 0.0) / 1000.0
        if period <= 0 and self.core.source_quarantined(
                SOURCE_REMOTE_WRITE):
            # the push door is quarantined: cover the fleet at the
            # fallback cadence until the breaker half-opens
            return QUARANTINE_POLL_S
        return period

    def poll_once(self) -> int:
        """One sweep over the fleet's (model, namespace) groups through
        the regular collect_load PromQL; returns groups ingested.
        Best-effort per group: a failing group is metered and skipped
        (the cadence backstop still covers it)."""
        cm = self.core.rec.state.last_operator_cm
        family = active_family(cm)
        ingested = 0
        for model, ns in self.core.scrape_targets():
            try:
                load = collect_load(self.prom, model, ns, family=family)
            except Exception:  # noqa: BLE001 — poller is best-effort
                self.core.emitter.emit_stream_shed(SHED_SCRAPE_ERROR)
                continue
            self.core.observe_load(model, ns, load)
            ingested += 1
        return ingested

    def _poll_with_backoff(self) -> None:
        """One poll attempt, retried through the standard ladder on
        failure (sleeping on the STOP EVENT so shutdown interrupts the
        backoff). Exhausting the ladder raises to the loop's catch —
        which logs, meters, and keeps the thread alive."""
        with_backoff(self.poll_once, backoff=STANDARD_BACKOFF,
                     sleep=self.stop.wait)

    def start(self) -> Optional[threading.Thread]:
        def loop() -> None:
            while not self.stop.is_set():
                period = self._period_s()
                if period <= 0:
                    self.stop.wait(5.0)
                    continue
                if self.stop.wait(period):
                    return
                try:
                    self._poll_with_backoff()
                except Exception as e:  # noqa: BLE001 — the poller thread must survive
                    log.warning("stream scrape poll failed",
                                extra=kv(error=str(e)))
                    self.core.emitter.emit_stream_shed(SHED_SCRAPE_ERROR)

        t = threading.Thread(target=loop, name="wva-stream-scrape",
                             daemon=True)
        t.start()
        self.thread = t
        return t
