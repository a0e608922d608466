"""benchmark/program.py: the program's spans and series read over a
traced window. The sweep that puts the card's idle time under the
innermost program span, the gaps read from a device trace, a program
that lacks what is read (nothing, and no raise), and a CPU rehearsal of
each cell at a tiny size that reads every number."""

import time
from types import SimpleNamespace

import pytest

from benchmark import harness, program, spec
from benchmark.run import run_cell
from benchmark.trace import ANCHOR, DeviceTrace
from conftest import TINY

CELLS = [w["name"] for w in spec.bench()["workloads"]]


def test_idle_by_span_gives_each_instant_to_the_innermost_span():
    spans = [(0.0, 10.0, 0, "reconcile"),
             (1.0, 9.0, 1, "stage:publish"),
             (2.0, 6.0, 2, "kube"),            # two fan-out siblings
             (3.0, 7.0, 2, "kube"),
             (4.0, 5.0, 1 << 30, "gc"),        # a pause owns its wall
             (3.0, 3.5, 2, "prometheus")]      # a third sibling
    gaps = [(0.5, 8.0), (11.0, 12.0)]
    idle = program.idle_by_span(gaps, spans)
    assert idle == pytest.approx({
        "reconcile": 0.5, "stage:publish": 2.0, "gc": 1.0,
        "kube": 4.0 - 0.5 / 3, "prometheus": 0.5 / 3,
        program.OUTSIDE: 1.0})
    assert sum(idle.values()) == pytest.approx(8.5)


def test_device_gaps_on_the_host_clock():
    """Device work at 2-3 s and 5-6 s of a 10 s window opened at 100 s,
    on a trace clock 1000 s ahead of perf_counter."""
    us = 1e6
    dt = SimpleNamespace(anchor=100.0, t0=100.0, window_s=10.0, events=[
        {"ph": "X", "cat": "user_annotation", "name": ANCHOR,
         "ts": 1100.0 * us, "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1102.0 * us,
         "dur": 1.0 * us},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 1105.0 * us,
         "dur": 0.5 * us},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1105.25 * us,
         "dur": 0.75 * us}])
    assert program.device_gaps(dt) == pytest.approx(
        [(100.0, 102.0), (103.0, 105.0), (106.0, 110.0)])
    dt.events = dt.events[1:]                  # no anchor: nothing
    assert program.device_gaps(dt) == []


def test_a_program_without_the_series_reads_nothing(monkeypatch):
    """The parent's program: spans on an injected clock, no GC audit,
    none of the new series. Nothing is read, nothing raises."""
    monkeypatch.setattr(program, "gc_seconds", lambda: None)
    registry = SimpleNamespace(collect=lambda: [])
    rec = SimpleNamespace(
        emitter=SimpleNamespace(registry=registry),
        tracer=SimpleNamespace(perf=time.time, traces=lambda *a: []),
        profiler=SimpleNamespace(records=lambda *a: []))
    r = program.Recorder()
    r.rec = rec
    r.open_window(SimpleNamespace(events=[], anchor=0.0, t0=0.0,
                                  window_s=1.0))
    r.after_cycle()
    r.close_window()
    assert r.readings("polled") == {} and r.readings("push") == {}
    assert r.note() == "idle by program span: nothing to read"


def traced(monkeypatch, cell, seed, seconds, **kw):
    """One `--trace 1` run of `cell` on the CPU with a Recorder attached
    where a window loop attaches it under `ctx.trace` (a call the loops
    do not make yet): to the Reconciler `Probes.watch` receives, and to
    the window the `DeviceTrace` opens and closes."""
    recorder = program.Recorder()
    watch, enter, leave = (harness.Probes.watch, DeviceTrace.__enter__,
                           DeviceTrace.__exit__)

    def watch_(probes, rec):
        watch(probes, rec)
        recorder.attach(rec)

    def enter_(dt):
        out = enter(dt)
        recorder.open_window(dt)
        return out

    def leave_(dt, *exc):
        recorder.close_window()
        return leave(dt, *exc)

    monkeypatch.setattr(harness.Probes, "watch", watch_)
    monkeypatch.setattr(DeviceTrace, "__enter__", enter_)
    monkeypatch.setattr(DeviceTrace, "__exit__", leave_)
    res, lines = run_cell(cell, seed, seconds, True, device="cpu",
                          t_start=time.perf_counter(), **kw)
    return res, lines, recorder


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_rehearsal_reads_the_program(cell, monkeypatch):
    """A traced run at a tiny size on the CPU: the run is correct, every
    program reading of the cell's loop is a number (positive, but for
    the GC share: a 2 s window may see no collection), and the note
    places idle time under program spans. A push's queue wait is counted
    with its lag, as the cycle serving it publishes: on a slow host no
    micro-cycle may end inside a 2 s window, and then neither reads."""
    traffic = {"rate_per_s": 3.0} if "push" in cell else None
    res, lines, recorder = traced(monkeypatch, cell, 2**31 + 11, 2.0,
                                  deployment=TINY, traffic=traffic)
    assert res["correct"], lines
    mode = spec.resolve(cell).traffic["mode"]
    readings = recorder.readings(mode)
    want = program.POLLED if mode == "polled" else program.PUSH
    if recorder._delta("lag_count") == 0:
        want = tuple(k for k in want if k != "stream.queue_wait_ms")
    assert list(readings) == list(want)
    assert all(v > 0.0 for k, v in readings.items()
               if not k.startswith("gc.")), readings
    assert all(v >= 0.0 for v in readings.values()), readings
    note = recorder.note()
    assert note.startswith("idle by program span: ")
    assert "nothing to read" not in note
