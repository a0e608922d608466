"""The polled loop: `Reconciler.reconcile()` back to back.

Before each cycle the traffic mix changes loads in the Prometheus
stand-in (not timed) and the controller's injected clock advances one
poll interval; each cycle is timed on the host's clock up to a
`torch.cuda.synchronize()`. `cycle_ms` is the summed wall of every cycle
that began in the window over their count.
"""

from __future__ import annotations

import copy
import time
from contextlib import nullcontext

import numpy as np
import torch

from .. import harness
from ..build import Clock, build, lane_rates, published, set_loads
from ..fleet import Fleet
from ..reference.decide import Reference
from ..trace import DeviceTrace

STAGES = ("config", "prepare", "analyze", "optimize", "publish")


def _warm_plan(b, device: str) -> None:
    """The controller's own start-up warm-up: one fused decision per
    sizing group the fleet will run (translate.warmup_plan)."""
    from workload_variant_autoscaler_tpu_torch.controller import translate
    from workload_variant_autoscaler_tpu_torch.ops.fused import warmup

    ctl = b.mods["ctl"]
    plan = translate.warmup_plan(
        b.kube.list_variant_autoscalings(),
        service_class_cm=b.kube.get_configmap(
            ctl.SERVICE_CLASS_CM_NAME, ctl.CONFIG_MAP_NAMESPACE).data,
        operator_cm=b.kube.get_configmap(
            ctl.CONFIG_MAP_NAME, ctl.CONFIG_MAP_NAMESPACE).data)
    for lanes, max_batch, pct in plan:
        warmup(max_batch, lanes, pct, device=device)


def _stage_marks(emitter) -> dict:
    out = {}
    for metric in emitter.registry.collect():
        for s in metric.samples:
            if s.name == "inferno_reconcile_stage_duration_msec" \
                    and s.labels.get("stage") in STAGES:
                out[s.labels["stage"]] = s.value
            elif s.name == "inferno_solve_lanes" \
                    and s.labels.get("state") == "solved":
                out["lanes_solved"] = s.value
    return out


def run(ctx: harness.Context) -> dict:
    cell = ctx.cell
    fleet = Fleet.from_config(cell.config)
    params = cell.traffic["params"]
    interval = float(params["interval_s"])
    clock = Clock()
    base = fleet.base_loads()
    loads = copy.deepcopy(base)
    traffic = ctx.generator.Traffic(params, fleet, base, ctx.seed)
    dev = ctx.device
    with harness.Probes(ctx) as probes:
        b = build(fleet, cell.config, clock, loads, dev, ctx.dtype)
        harness.quiet_loggers()
        probes.watch(b.rec)
        _warm_plan(b, dev)
        # set-up's passes: the first full pass, then one traffic step, so
        # the window starts on a warm engine
        for step in range(2):
            if step:
                set_loads(b, loads, traffic.step(loads))
            clock.advance(interval)
            b.rec.reconcile()
            harness.sync(dev)
        probes.reset()
        setup_s = time.perf_counter() - ctx.t_start

        cycles = []
        groups = fleet.groups()
        every = np.arange(fleet.variants)
        tracer = DeviceTrace(dev) if ctx.trace else None
        gc_clock = harness.GcClock()
        with (tracer if tracer is not None else nullcontext()), gc_clock:
            t_end = time.perf_counter() + ctx.seconds
            while time.perf_counter() < t_end:
                set_loads(b, loads, traffic.step(loads))
                clock.advance(interval)
                rpm = np.array([loads[g]["rps"] * 60.0 for g in groups])
                harness.sync(dev)
                t0 = time.perf_counter()
                error = None
                with probes.span("reconcile"):
                    try:
                        res = b.rec.reconcile()
                    except Exception as e:  # noqa: BLE001 - a failed cycle is counted
                        res, error = None, repr(e)
                    harness.sync(dev)
                wall = time.perf_counter() - t0
                systems = probes.take_systems()
                row = {"wall_s": wall, "rpm": rpm, "error": error,
                       "processed": (len(res.processed) if res else 0),
                       "res_error": (res.error if res else None),
                       "lanes": (lane_rates(b, systems[-1], every)
                                 if systems else np.full(every.shape, np.nan)),
                       "published": published(b, every)}
                if ctx.trace:
                    row["decide_s"] = sum(probes.decide_s)
                    probes.decide_s = []
                    row["launches"] = probes.take_launches()
                    row["marks"] = _stage_marks(b.emitter)
                cycles.append(row)
        memory = harness.device_record(dev)
    out = {"setup_s": setup_s, "cycles": cycles, "device": memory,
           "notes": ["cycle walls, ms: " + " ".join(
               f"{c['wall_s'] * 1e3:.1f}" for c in cycles), gc_clock.note()],
           "attempted": len(cycles),
           "failed": sum(1 for c in cycles if c["error"] or c["res_error"]
                         or c["processed"] != fleet.variants)}
    ref = Reference(fleet, base, device=dev)
    out["checks"] = judge(b, fleet, ref, cycles)
    if ctx.trace:
        out["records"] = records(cycles, tracer, ref, probes.spans)
        rows = out["records"]["rows"]
        out["notes"].append("roofline rows in the window: " + "; ".join(
            f"{f} {r['matched']} matched, {r['unmatched']} unmatched, "
            f"{r['padding']} padding, reference trips {r['trips']}"
            for f, r in rows.items()))
        if probes.kept:
            from .. import roofline

            out["notes"].append(roofline.trips_note(probes.kept, ref))
    else:
        walls = [c["wall_s"] for c in cycles]
        out["metrics"] = {"cycle_ms": sum(walls) / len(walls) * 1e3}
    return out


def judge(b, fleet: Fleet, ref: Reference, cycles: list) -> harness.Checks:
    """Every cycle of the window against the reference: each VA's sized
    lane, and each VA's status on the API server (slice and replicas)
    after the cycle; then inferno_desired_replicas after the last."""
    tau = harness.LIMITS["lane_rate_gap"]
    gidx = {g: k for k, g in enumerate(fleet.groups())}
    lane_gap, outside, unprocessed = 0.0, 0, 0
    for c in cycles:
        unprocessed += fleet.variants - c["processed"]
        acc, reps = c["published"]
        for i in range(fleet.variants):
            lane_gap = max(lane_gap, harness.lane_gap(ref, i, c["lanes"][i]))
            outside += not harness.admissible(
                ref, fleet, i, c["rpm"][gidx[fleet.group_of(i)]], tau,
                int(acc[i]), int(reps[i]))
    checks = harness.Checks()
    checks.add("lane_rate_gap", lane_gap if cycles else 1.0)
    checks.add("decisions_outside", outside)
    checks.add("unprocessed", unprocessed if cycles else fleet.variants)
    checks.add("published_mismatch", harness.published_mismatch(b, fleet))
    return checks


def records(cycles: list, tracer, ref: Reference, spans: list) -> dict:
    """What the per-layer readers read."""
    from .. import roofline

    n = len(cycles)
    work, rows = roofline.launch_work(
        [x for c in cycles for x in c["launches"]], ref)
    return {
        "cycles": n,
        "stage_ms": {s: sum(c["marks"].get(s, 0.0) for c in cycles) / n
                     for s in STAGES},
        "lanes_solved": sum(c["marks"].get("lanes_solved", 0.0)
                            for c in cycles) / n,
        "decide_ms": sum(c["decide_s"] for c in cycles) / n * 1e3,
        "least_s": work,
        "rows": rows,
        "trace": tracer.summary(spans),
    }
