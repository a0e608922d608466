"""The fleet put through the program: ConfigMaps, Deployments and
VariantAutoscalings admitted into the API-server stand-in, the loads
into the Prometheus stand-in, and a `Reconciler` over both.

A frozen copy of `tests/reconcile_cluster.py build`, with the stand-ins
of `standins/` in place of the program's own fakes. This module imports
the program lazily, inside its functions: the reference and the tests
that look at imports load it without the program.
"""

from __future__ import annotations

import importlib
import json
import time
from dataclasses import dataclass, field

from .fleet import SHAPES, Fleet
from .standins.kube import ApiServer
from .standins.prom import PromStandIn

PORT = "workload_variant_autoscaler_tpu_torch"


class Clock:
    """The controller's injected wall and monotonic clocks, advanced by
    the harness between polled cycles."""

    def __init__(self, t0: float = 1_700_000_000.0):
        self.t = t0

    def now(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t - 1_600_000_000.0

    def advance(self, seconds: float) -> None:
        self.t += seconds


class RealClock:
    """The host's clocks: the streaming core's debounce and lag are
    real-time behaviour."""

    now = staticmethod(time.time)
    monotonic = staticmethod(time.monotonic)


@dataclass
class Built:
    fleet: Fleet
    kube: ApiServer
    prom: PromStandIn
    emitter: object
    rec: object
    mods: dict = field(default_factory=dict)
    queries: dict = field(default_factory=dict)


def modules() -> dict:
    return {name: importlib.import_module(f"{PORT}.{path}") for name, path in (
        ("ctl", "controller"), ("kube", "controller.kube"),
        ("crd", "controller.crd"), ("col", "collector"),
        ("met", "metrics"))}


def _queries(col, fleet: Fleet) -> dict:
    """The program's query texts: the grouped fleet queries (field each
    answers; None is availability) and, per group, the per-variant ones."""
    grouped = ((col.fleet_true_arrival_rate_query(), "rps"),
               (col.fleet_arrival_rate_query(), "rps"),
               (col.fleet_avg_prompt_tokens_query(), "prompt"),
               (col.fleet_avg_generation_tokens_query(), "gen"),
               (col.fleet_avg_ttft_query(), "ttft"),
               (col.fleet_avg_itl_query(), "itl"),
               (col.fleet_availability_query(), None))
    per_group = {}
    for model, ns in fleet.groups():
        per_group[(model, ns)] = (
            (col.true_arrival_rate_query(model, ns), "rps"),
            (col.arrival_rate_query(model, ns), "rps"),
            (col.avg_prompt_tokens_query(model, ns), "prompt"),
            (col.avg_generation_tokens_query(model, ns), "gen"),
            (col.avg_ttft_query(model, ns), "ttft"),
            (col.avg_itl_query(model, ns), "itl"))
    return {"grouped": grouped, "per_group": per_group}


def published(b: Built, idx) -> tuple:
    """(slice index, replicas) arrays of the VAs `idx` as the API server
    holds their status (read in place: the stand-in is the harness's)."""
    import numpy as np

    names = {s[0]: k for k, s in enumerate(SHAPES)}
    acc = np.full(len(idx), -1, dtype=np.int16)
    reps = np.zeros(len(idx), dtype=np.int32)
    for n, i in enumerate(idx):
        name, ns = b.fleet.va_key(int(i))
        d = b.kube.vas[(ns, name)].status.desired_optimized_alloc
        acc[n] = names.get(d.accelerator, -1)
        reps[n] = d.num_replicas
    return acc, reps


def lane_rates(b: Built, system, idx):
    """The rate per replica (req/s) of each VA's own slice lane in a
    cycle's System, NaN where it has none."""
    import numpy as np

    out = np.full(len(idx), np.nan)
    for n, i in enumerate(idx):
        s = system.servers.get(b.fleet.full_name(int(i)))
        a = s.all_allocations.get(b.fleet.slice_of(int(i))) if s else None
        if a is not None:
            out[n] = a.max_arrv_rate_per_replica * 1000.0
    return out


def set_loads(b: Built, loads: dict, keys=None) -> None:
    """Answer the queries of `keys` (every group when None) from `loads`."""
    grouped = b.queries["grouped"]
    for key in (loads if keys is None else keys):
        v = loads[key]
        for q, fld in b.queries["per_group"][key]:
            b.prom.set_single(q, v[fld])
        labels = {"model_name": key[0], "namespace": key[1]}
        for q, fld in grouped:
            b.prom.set_group(q, labels, 1.0 if fld is None else v[fld])


def build(fleet: Fleet, cfg: dict, clock, loads: dict, device: str,
          dtype) -> Built:
    """The fleet through the program's modules, with a Reconciler on
    `clock` over the stand-ins (its decision ring and every other
    setting at the controller's defaults)."""
    mods = modules()
    ctl, crd = mods["ctl"], mods["crd"]
    ctrl = cfg["controller"]
    kube = ApiServer(mods["kube"])
    kube.put_configmap(ctl.ConfigMap(
        ctl.CONFIG_MAP_NAME, ctl.CONFIG_MAP_NAMESPACE,
        dict(ctrl["operator"])))
    kube.put_configmap(ctl.ConfigMap(
        ctl.ACCELERATOR_CM_NAME, ctl.CONFIG_MAP_NAMESPACE,
        {name: json.dumps({"chip": gen, "chips": str(chips),
                           "cost": str(cost)})
         for name, gen, chips, cost, _s in SHAPES[:fleet.profiles]}))
    kube.put_configmap(ctl.ConfigMap(
        ctl.SERVICE_CLASS_CM_NAME, ctl.CONFIG_MAP_NAMESPACE,
        fleet.service_class_yaml()))
    prof = fleet.profiles_by_model()
    for i in range(fleet.variants):
        name, ns = fleet.va_key(i)
        replicas = 1 + i % 3
        kube.put_deployment(ctl.Deployment(
            name=name, namespace=ns, spec_replicas=replicas,
            status_replicas=replicas))
        accs = [crd.AcceleratorProfile(
            acc=acc, acc_count=1,
            perf_parms=crd.PerfParms(
                decode_parms={"alpha": repr(a), "beta": repr(bt)},
                prefill_parms={"gamma": repr(g), "delta": repr(d)}),
            max_batch_size=mb)
            for acc, a, bt, g, d, mb in prof[fleet.model_of(i)]]
        kube.put_variant_autoscaling(crd.VariantAutoscaling(
            metadata=crd.ObjectMeta(
                name=name, namespace=ns,
                labels={crd.ACCELERATOR_LABEL: fleet.slice_of(i)}),
            spec=crd.VariantAutoscalingSpec(
                model_id=fleet.model_of(i),
                slo_class_ref=crd.ConfigMapKeyRef(
                    name=ctl.SERVICE_CLASS_CM_NAME,
                    key=fleet.class_of(i)[0].lower()),
                model_profile=crd.ModelProfile(accelerators=accs))))
    prom = PromStandIn(now=clock.now,
                       latency_s=cfg["standins"]["prom_latency_s"])
    emitter = mods["met"].MetricsEmitter()
    rec = ctl.Reconciler(
        kube=kube, prom=prom, emitter=emitter, now=clock.now,
        sleep=(time.sleep if isinstance(clock, RealClock)
               else (lambda _s: None)),
        monotonic=clock.monotonic, device=device, dtype=dtype)
    b = Built(fleet=fleet, kube=kube, prom=prom, emitter=emitter, rec=rec,
              mods=mods, queries=_queries(mods["col"], fleet))
    for q, _fld in b.queries["grouped"]:
        prom.declare_grouped(q)
    set_loads(b, loads)
    return b
