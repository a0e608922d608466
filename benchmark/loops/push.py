"""The event path: remote-write pushes through the streaming core's door.

`WVA_STREAM` is on and the core runs on the host's clock in its own
consumer thread (`StreamCore.run`), as the controller runs it. The
harness posts each push of the open-loop schedule through
`stream.remote_write_middleware(core)` when it falls due, whatever the
core is doing, and keeps the Prometheus stand-in in step with what it
pushed. A push's reaction time runs from when the schedule said it was
due to when the micro-cycle that took its change (the value pushed, or a
later one for the same group) had published; a push the door refused,
or whose change was not published within `drain_s` after the window,
is failed and reads as the whole wait.

The rate of pushes published is taken as the contract closes a window
of work sent ahead: when its time is up nothing more is sent, every push
sent is waited for, and the clock is read after that wait, so it is the
pushes published over the time from the window's opening to the close
or to the last of them published, whichever is later. Below the cell's
capacity it is the offered rate; a backlog that outlasts the window
lowers it.
"""

from __future__ import annotations

import copy
import io
import statistics
import threading
import time
from contextlib import nullcontext

import numpy as np

from .. import harness
from ..build import RealClock, build, lane_rates, published, set_loads
from ..fleet import Fleet
from ..reference.decide import Reference
from ..trace import DeviceTrace
from .polled import _warm_plan

LAG = "inferno_stream_lag_seconds"


def post(door, body: bytes):
    """One POST /api/v1/write through the door: (status, headers)."""
    out = []
    environ = {"PATH_INFO": "/api/v1/write", "REQUEST_METHOD": "POST",
               "CONTENT_LENGTH": str(len(body)),
               "HTTP_CONTENT_ENCODING": "snappy",
               "wsgi.input": io.BytesIO(body)}
    b"".join(door(environ, lambda st, hdrs: out.append((st, dict(hdrs)))))
    return out[0]


def body_of(stream, loads: dict, groups, ts_ms: float) -> bytes:
    """The recording-rule series of `groups` as one snappy-compressed
    remote-write request."""
    series = []
    for model, ns in groups:
        v = loads[(model, ns)]
        for name, value in (("wva:stream:arrival_rpm", v["rps"] * 60.0),
                            ("wva:stream:avg_input_tokens", v["prompt"]),
                            ("wva:stream:avg_output_tokens", v["gen"]),
                            ("wva:stream:avg_ttft_ms", v["ttft"] * 1e3),
                            ("wva:stream:avg_itl_ms", v["itl"] * 1e3)):
            series.append(({"__name__": name, "model_name": model,
                            "namespace": ns}, [(value, int(ts_ms))]))
    return stream.snappy_compress(stream.encode_write_request(series))


class Ledger:
    """Every push's groups and values, and which micro-cycle published
    each: a cycle that sized group g on the value of push j publishes
    every push of g up to j not yet published."""

    def __init__(self, fleet: Fleet):
        self.fleet = fleet
        self.va_index = {fleet.full_name(i): i for i in range(fleet.variants)}
        self.value_of: dict = {}      # (group, rpm) -> push id
        self.by_group: dict = {}      # group -> [push id, ...] in order
        self.pending: dict = {}       # push id -> groups not yet published
        self.published: dict = {}     # push id -> host time
        self.lock = threading.Lock()

    def add_base(self, loads: dict) -> None:
        """The loads before any push: what a group sizes on until then."""
        with self.lock:
            for g, v in loads.items():
                self.value_of[(g, v["rps"] * 60.0)] = -1

    def add(self, pid: int, groups: list, loads: dict) -> None:
        with self.lock:
            for g in groups:
                self.value_of[(g, loads[g]["rps"] * 60.0)] = pid
                self.by_group.setdefault(g, []).append(pid)
            self.pending[pid] = set(groups)

    def drop(self, pid: int) -> None:
        with self.lock:
            self.pending.pop(pid, None)

    def consume(self, loads_rpm: dict, t: float) -> dict:
        """Mark what a cycle sized ({group: rpm}); returns {group: push
        id, -1 for the loads before any push, None for a value nobody
        sent}."""
        out = {}
        with self.lock:
            for g, rpm in loads_rpm.items():
                pid = self.value_of.get((g, rpm))
                out[g] = pid
                if pid is None:
                    continue
                for p in self.by_group.get(g, ()):
                    if p > pid:
                        break
                    left = self.pending.get(p)
                    if left is not None and g in left:
                        left.discard(g)
                        if not left:
                            del self.pending[p]
                            self.published[p] = t
        return out


def _lag(emitter) -> tuple:
    s = c = 0.0
    for metric in emitter.registry.collect():
        for x in metric.samples:
            if x.name == LAG + "_sum":
                s = x.value
            elif x.name == LAG + "_count":
                c = x.value
    return s, c


def run(ctx: harness.Context) -> dict:
    from workload_variant_autoscaler_tpu_torch import stream

    cell = ctx.cell
    fleet = Fleet.from_config(cell.config)
    params = cell.traffic["params"]
    base = fleet.base_loads()
    loads = copy.deepcopy(base)
    traffic = ctx.generator.Traffic(params, fleet, base, ctx.seed)
    dev = ctx.device
    ledger = Ledger(fleet)
    cycles: list = []
    with harness.Probes(ctx) as probes:
        b = build(fleet, cell.config, RealClock(), loads, dev, ctx.dtype)
        harness.quiet_loggers()
        _warm_plan(b, dev)
        rec = b.rec
        orig = rec.reconcile

        def logged(*, scope=None, stream_loads=None):
            label = "full pass" if scope is None else "micro-cycle"
            t0 = time.perf_counter()
            with probes.span(label):
                res = orig(scope=scope, stream_loads=stream_loads)
            t1 = time.perf_counter()
            # what the cycle sized on, per group, as the controller keeps it
            rpm = {g: v.arrival_rate_rpm
                   for g, v in rec.state.cycle_loads.items()}
            systems = probes.take_systems()
            done = np.array([ledger.va_index[k] for k in res.processed],
                            dtype=np.int64)
            cycles.append({
                "t0": t0, "t1": t1, "scoped": scope is not None,
                "rpm": rpm, "pushes": ledger.consume(rpm, t1),
                "processed": done,
                "lanes": (lane_rates(b, systems[-1], done) if systems
                          else np.full(done.shape, np.nan)),
                "published": published(b, done)})
            return res

        rec.reconcile = logged
        probes.watch(rec)
        ledger.add_base(loads)
        core = stream.StreamCore(rec)
        rec.stream_core = core
        door = stream.remote_write_middleware(core)(lambda _e, _s: [b""])
        core.process_once()                      # the first full pass
        pid = 0
        for groups in traffic.warmup_pushes():   # the event path, warmed
            keys = [g for g, _r in groups]
            for g, rps in groups:
                loads[g]["rps"] = rps
            ledger.add(pid, keys, loads)
            pid += 1
            post(door, body_of(stream, loads, keys, time.time() * 1e3))
            time.sleep(core.queue.debounce_s)
            core.process_once()
        schedule = traffic.schedule(ctx.seconds)
        stop = threading.Event()
        consumer = threading.Thread(target=core.run, args=(stop,),
                                    name="stream-consumer")
        consumer.start()
        probes.reset()
        lag0 = _lag(b.emitter)
        n_warm = len(cycles)
        setup_s = time.perf_counter() - ctx.t_start

        pushes = []
        tracer = DeviceTrace(dev) if ctx.trace else None
        gc_clock = harness.GcClock()
        with (tracer if tracer is not None else nullcontext()), gc_clock:
            # bodies stamped for the planned window, encoded before it opens
            anchor = time.time() + 1.0
            sends = []
            for t, groups in schedule:
                keys = [g for g, _r in groups]
                view = {g: dict(loads[g], rps=r) for g, r in groups}
                sends.append((t, groups, keys, body_of(
                    stream, view, keys, (anchor + t) * 1e3)))
            while time.time() < anchor:
                time.sleep(min(anchor - time.time(), 0.05))
            t_open = time.perf_counter() - (time.time() - anchor)
            if tracer is not None:
                tracer.t0 = t_open
            for t, groups, keys, body in sends:
                due = t_open + t
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                for g, rps in groups:
                    loads[g]["rps"] = rps
                ledger.add(pid, keys, loads)
                set_loads(b, loads, keys)
                with probes.span("door"):
                    status, _headers = post(door, body)
                ok = status.startswith("204")
                if not ok:
                    ledger.drop(pid)
                pushes.append({"pid": pid, "due": due, "ok": ok,
                               "sent": time.perf_counter(),
                               "status": status})
                pid += 1
            t_close = t_open + ctx.seconds
            rest = t_close - time.perf_counter()
            if rest > 0:
                time.sleep(rest)
            # the core's own lag and micro-cycles as the window closes:
            # reading the trace out after it stalls the consumer thread
            lag1, n_close = _lag(b.emitter), len(cycles)
        deadline = t_close + float(params["drain_s"])
        while time.perf_counter() < deadline:
            with ledger.lock:
                if not any(p["pid"] in ledger.pending for p in pushes):
                    break
            time.sleep(0.01)
        stop.set()
        consumer.join()
        memory = harness.device_record(dev)
    window = [c for c in cycles[n_warm:] if c["t0"] >= t_open]
    react, unpublished, done, t_end = [], 0, 0, t_close
    for p in pushes:
        t = ledger.published.get(p["pid"])
        if p["ok"] and t is None:
            unpublished += 1
        if p["ok"] and t is not None:
            done += 1
            t_end = max(t_end, t)
        react.append((t - p["due"]) * 1e3 if (p["ok"] and t is not None)
                     else (deadline - p["due"]) * 1e3)
    if unpublished:
        t_end = deadline
    p50, p95 = harness.percentile(react, 0.50), harness.percentile(react, 0.95)
    tenth = max(len(react) // 10, 1)
    out = {"setup_s": setup_s, "device": memory, "attempted": len(pushes),
           "notes": [
               f"react_p50_ms {p50!r} react_p95_ms {p95!r}; {done} pushes "
               f"published, the last {t_end - t_close:.4f} s after the close",
               "react ms, median of each tenth of the pushes by due time: "
               + " ".join(f"{statistics.median(react[k:k + tenth]):.1f}"
                          for k in range(0, len(react), tenth)),
               f"cycles in the window: {sum(c['scoped'] for c in window)} "
               f"scoped, {sum(not c['scoped'] for c in window)} full",
               gc_clock.note()],
           "failed": sum(1 for p in pushes if not p["ok"]) + unpublished,
           "core_failures": dict(core.failures)}
    ref = Reference(fleet, base, device=dev)
    out["checks"] = judge(b, fleet, ref, window, ledger, unpublished)
    if ctx.trace:
        scoped = [c for c in cycles[n_warm:n_close]
                  if c["t0"] >= t_open and c["scoped"]]
        out["records"] = {
            "trace": tracer.summary(probes.spans),
            "stream": {"lag_sum": lag1[0] - lag0[0],
                       "lag_count": lag1[1] - lag0[1],
                       "accepted": sum(1 for p in pushes if p["ok"]),
                       "microcycles": len(scoped)},
            "react": {"p50_ms": p50, "p95_ms": p95}}
    else:
        out["metrics"] = {"pushes_per_s": done / (t_end - t_open)}
    return out


def judge(b, fleet: Fleet, ref: Reference, window: list, ledger: Ledger,
          unpublished: int) -> harness.Checks:
    """Every cycle of the window against the reference: each processed
    VA's sized lane, and its status on the API server after the cycle at
    the value the cycle sized its group on (which has to be a value the
    harness sent); then every accepted push published, and
    inferno_desired_replicas after the last cycle."""
    tau = harness.LIMITS["lane_rate_gap"]
    lane_gap, outside, unprocessed = 0.0, 0, 0
    for c in window:
        acc, reps = c["published"]
        for n, i in enumerate(c["processed"]):
            i = int(i)
            g = fleet.group_of(i)
            lane_gap = max(lane_gap, harness.lane_gap(ref, i,
                                                      c["lanes"][n]))
            if c["pushes"].get(g) is None:
                outside += 1             # sized on a value nobody sent
                continue
            outside += not harness.admissible(ref, fleet, i, c["rpm"][g],
                                              tau, int(acc[n]), int(reps[n]))
        if c["scoped"]:
            want = sum(1 for i in range(fleet.variants)
                       if fleet.group_of(i) in c["rpm"])
            unprocessed += want - len(c["processed"])
    checks = harness.Checks()
    checks.add("lane_rate_gap", lane_gap if window else 1.0)
    checks.add("decisions_outside", outside)
    checks.add("unprocessed", unprocessed)
    checks.add("pushes_unpublished", unpublished)
    checks.add("published_mismatch", harness.published_mismatch(b, fleet))
    return checks
