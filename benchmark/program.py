"""The program's own flight recorder, read over a traced window.

The port's Reconciler keeps a ring of its cycles' span trees
(`obs/trace.py`), a ledger of where each cycle's wall went
(`obs/profile.py`: every span's exclusive time, in buckets named by
`bucket_for`), its GC audit (`obs/profile.py GC_AUDIT`) and series on
its emitter. This module reads them:

- `Recorder`: after each `reconcile()` in the window, the cycle's trace
  and its ledger record; at the window's open and close, the GC audit's
  pause seconds and the stream histograms
  (`inferno_stream_queue_wait_seconds`, `inferno_stream_door_seconds`);
- `idle_by_span`: the card's idle time in the window, each instant
  under the innermost program span open over it, in one sweep over
  sorted intervals (a 512-VA shift window holds ~28,000 `kube.*` spans);
- `Recorder.readings`: the per-layer numbers those give.

A number the program cannot give (no GC audit or such series, spans not
on the host's `perf_counter`, as at the parent commit) is left out of
the readings; nothing raises.

A window loop uses it under `ctx.trace`: `attach(rec)` once the
Reconciler is built, `open_window(dt)` as the `DeviceTrace` opens,
`close_window()` as it closes, then records `readings(mode)` and
`note()`. `loops/polled.py` and `loops/push.py` make no such call yet.
"""

from __future__ import annotations

import time

OUTSIDE = "outside any cycle"
ROOT_LABEL = "reconcile"
QUEUE_WAIT = "inferno_stream_queue_wait_seconds"
DOOR = "inferno_stream_door_seconds"
LAG = "inferno_stream_lag_seconds"
# ledger bucket of each self_ms metric (obs/profile.py bucket_for)
SELF_MS = {"self_ms.kube": "kube", "self_ms.prometheus": "prometheus",
           "self_ms.pack": "system.pack", "self_ms.decide": "system.decide"}
# what each loop's window reports
POLLED = (*SELF_MS, "gc.pause_pct.cycle")
PUSH = ("gc.pause_pct.push", "stream.queue_wait_ms", "stream.door_ms")
TOP = 10


def gc_seconds():
    """The program's GC pause seconds so far, every generation, read
    from its GC audit as the window opens and closes (the counter
    `inferno_gc_pause_seconds_total` moves only as a cycle ends); None
    where the program has no such audit."""
    try:
        from workload_variant_autoscaler_tpu_torch.obs.profile import \
            GC_AUDIT
    except ImportError:
        return None
    return sum(GC_AUDIT.totals())


def series(emitter) -> dict:
    """The program's GC pause seconds and the two stream histograms'
    sums and counts, with the lag's (a queue wait is counted with each
    lag, for the same load change); what the program lacks is left
    out."""
    out: dict = {}
    gc_s = gc_seconds()
    if gc_s is not None:
        out["gc_s"] = gc_s
    names = {QUEUE_WAIT + "_sum": "wait_sum",
             QUEUE_WAIT + "_count": "wait_count",
             DOOR + "_sum": "door_sum", DOOR + "_count": "door_count",
             LAG + "_sum": "lag_sum", LAG + "_count": "lag_count"}
    for metric in emitter.registry.collect():
        for s in metric.samples:
            key = names.get(s.name)
            if key is not None:
                out[key] = out.get(key, 0.0) + s.value
    return out


def _depths(trace) -> dict:
    """span_id -> depth under the root; a `gc` pause above every span,
    as the ledger places it (a collection stops every thread)."""
    from workload_variant_autoscaler_tpu_torch.obs import GC_SPAN

    by_id = {s.span_id: s for s in trace.spans}
    out: dict = {}

    def depth(sp) -> int:
        if sp.span_id not in out:
            parent = by_id.get(sp.parent_id) if sp.parent_id else None
            out[sp.span_id] = 0 if parent is None else depth(parent) + 1
        return out[sp.span_id]

    for sp in trace.spans:
        out[sp.span_id] = 1 << 30 if sp.name == GC_SPAN else depth(sp)
    return out


def span_intervals(traces) -> list:
    """(start, end, depth, label) per span of finished cycle traces, in
    seconds on perf_counter; an unfinished span ends with its root."""
    from workload_variant_autoscaler_tpu_torch.obs.profile import bucket_for

    out = []
    for tr in traces:
        root = tr.root
        if root is None or root.duration_ms is None:
            continue
        end_root = root.start_perf + root.duration_ms * 1e-3
        depth = _depths(tr)
        for sp in tr.spans:
            end = (sp.start_perf + sp.duration_ms * 1e-3
                   if sp.duration_ms is not None else end_root)
            label = ROOT_LABEL if sp is root else bucket_for(sp.name)
            out.append((sp.start_perf, end, depth[sp.span_id], label))
    return out


def idle_by_span(gaps, spans) -> dict:
    """Seconds of `gaps` [(start, end)] under each label: at every
    instant of a gap the innermost (deepest) span open owns it, parallel
    siblings at that depth splitting it equally; an instant under no
    span is OUTSIDE. One sweep over the sorted ends of both."""
    points = []           # (t, kind, index): ends (0) before starts (1)
    for i, (a, b, _d, _l) in enumerate(spans):
        if b > a:
            points += [(a, 1, i), (b, 0, i)]
    for a, b in gaps:
        if b > a:
            points += [(a, 1, -1), (b, 0, -1)]
    points.sort()
    out: dict = {}
    active: set = set()
    in_gap = 0
    prev = None
    for t, kind, i in points:
        if in_gap and prev is not None and t > prev:
            piece = t - prev
            if active:
                top = max(spans[j][2] for j in active)
                owners = [spans[j][3] for j in active if spans[j][2] == top]
                for label in owners:
                    out[label] = out.get(label, 0.0) + piece / len(owners)
            else:
                out[OUTSIDE] = out.get(OUTSIDE, 0.0) + piece
        prev = t
        if i < 0:
            in_gap += 1 if kind else -1
        elif kind:
            active.add(i)
        else:
            active.discard(i)
    return out


def device_gaps(dt) -> list:
    """The idle gaps of a closed DeviceTrace's window on perf_counter:
    its device intervals put on the host clock through its anchor."""
    from benchmark.trace import ANCHOR, DEVICE_CATS, HOST_SPAN_CAT

    offset, dev = None, []
    for e in dt.events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        if e.get("cat", "") in DEVICE_CATS:
            dev.append((a, a + d))
        elif e.get("cat") == HOST_SPAN_CAT and e.get("name") == ANCHOR:
            offset = a - dt.anchor * 1e6
    if offset is None:
        return []
    lo, hi = dt.t0, dt.t0 + dt.window_s
    edges, last = [], lo
    for a, b in sorted(dev):
        a, b = (a - offset) * 1e-6, (b - offset) * 1e-6
        if b <= last or a >= hi:
            continue
        if a > last:
            edges.append((last, a))
        last = max(last, b)
    if last < hi:
        edges.append((last, hi))
    return edges


class Recorder:
    """Collects the program's traces, ledger records and series over the
    traced window (see the module doc)."""

    def __init__(self):
        self.rec = None
        self.window = None            # the DeviceTrace, once it opened
        self.open = False
        self.traces: list = []
        self.records: list = []
        self.at_open: dict = {}
        self.at_close: dict = {}
        self.t_open = self.t_close = 0.0
        self._seen: set = set()

    def attach(self, rec) -> None:
        """Wrap `rec.reconcile` (its instance attribute, as the loops
        and the streaming core call it)."""
        self.rec = rec
        inner = rec.reconcile
        recorder = self

        def reconcile(*a, **kw):
            try:
                return inner(*a, **kw)
            finally:
                if recorder.open:
                    recorder.after_cycle()

        rec.reconcile = reconcile

    def after_cycle(self) -> None:
        """Keep the cycles finished since the last call, with their
        ledger records (the newest few, so none is missed)."""
        new = set()
        for tr in self.rec.tracer.traces(4):
            root = tr.root
            if (tr.trace_id not in self._seen and root is not None
                    and root.name == ROOT_LABEL
                    and root.duration_ms is not None):
                new.add(tr.trace_id)
                self.traces.append(tr)
        self._seen |= new
        self.records += [r for r in self.rec.profiler.records(4)
                         if r.trace_id in new]

    def open_window(self, dt) -> None:
        self.window = dt
        if self.rec is not None:
            # set-up's cycles are not the window's
            self._seen |= {tr.trace_id for tr in self.rec.tracer.traces()}
        self.at_open = series(self.rec.emitter) if self.rec else {}
        self.t_open = time.perf_counter()
        self.open = True

    def close_window(self) -> None:
        self.open = False
        self.t_close = time.perf_counter()
        self.at_close = series(self.rec.emitter) if self.rec else {}

    def _host_time(self) -> bool:
        return (self.rec is not None
                and self.rec.tracer.perf is time.perf_counter)

    def _delta(self, key: str):
        if key not in self.at_open or key not in self.at_close:
            return None
        return self.at_close[key] - self.at_open[key]

    def readings(self, mode: str) -> dict:
        """The per-layer numbers of a polled or a push window; a number
        the program cannot give is left out."""
        out: dict = {}
        if mode == "polled" and self._host_time() and self.records:
            for name, bucket in SELF_MS.items():
                if any(bucket in r.buckets for r in self.records):
                    out[name] = sum(r.buckets.get(bucket, 0.0)
                                    for r in self.records) / len(self.records)
        gc_s = self._delta("gc_s")
        span = self.t_close - self.t_open
        if gc_s is not None and span > 0:
            out["gc.pause_pct.cycle" if mode == "polled"
                else "gc.pause_pct.push"] = 100.0 * gc_s / span
        if mode == "push":
            for name, key in (("stream.queue_wait_ms", "wait"),
                              ("stream.door_ms", "door")):
                s, n = self._delta(key + "_sum"), self._delta(key + "_count")
                if s is not None and n:
                    out[name] = 1e3 * s / n
        return {k: out[k] for k in (POLLED if mode == "polled" else PUSH)
                if k in out}

    def idle(self) -> dict:
        """The window's idle seconds by program span label, or {} where
        the spans are not on the host's clock or nothing was traced."""
        if self.window is None or not self._host_time():
            return {}
        return idle_by_span(device_gaps(self.window),
                            span_intervals(self.traces))

    def note(self) -> str:
        idle = self.idle()
        if not idle:
            return "idle by program span: nothing to read"
        top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        walls = [r.wall_ms for r in self.records]
        share = (sum(r.attributed_fraction * r.wall_ms
                     for r in self.records) / sum(walls)
                 if walls and sum(walls) > 0 else None)
        head = ", ".join(f"{k} {v:.3f} s" for k, v in top)
        tail = ("" if share is None else
                f"; the ledger attributes {100.0 * share:.2f}% of the "
                f"{len(walls)} cycles' wall to named spans")
        return f"idle by program span: {head}{tail}"

