"""One plain description of a cluster, built through either package's
controller modules: the JAX reference (`workload_variant_autoscaler_tpu`)
or the PyTorch port (`workload_variant_autoscaler_tpu_torch`).

The two packages' `crd`, `kube` and `collector` classes are distinct
types, so a parity test builds the same cluster twice from one `Cluster`
and drives both with the same loads and the same injected clock. This
module imports neither package at import time: the card tests import it
where only the port is installed.

A cluster: `variants` VariantAutoscalings, VA i serving model
`m{i % models}` in namespace `ns{i % namespaces}`, each with the first
`profiles` slice shapes of SHAPES (per-model perf parameters drawn from
`seed` around the Llama-3.1-8B fit, as chip_smoke.build_fleet draws
them), a Deployment, two service classes (`premium`, held at
`percentile` when set, and `freemium`, both listing every model), the
three ConfigMaps, with `nodes` a TPU node inventory plus
WVA_LIMITED_MODE, and with `faults` a seeded FaultPlan on both
dependencies. Prometheus is a FakePromAPI answering both the grouped
fleet queries (one labelled sample per (model, namespace)) and the
per-variant queries, with loads drawn from `seed`.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field

import numpy as np

PORT = "workload_variant_autoscaler_tpu_torch"
JAX = "workload_variant_autoscaler_tpu"

# (slice name, chip generation, chips, cost, relative speed): the first
# eight default slice shapes at their catalog prices, with the relative
# speeds chip_smoke.build_fleet draws its profiles around
SHAPES = (
    ("v5e-1", "v5e", 1, 20.0, 1.0),
    ("v5e-4", "v5e", 4, 80.0, 0.55),
    ("v5e-8", "v5e", 8, 160.0, 0.4),
    ("v5e-16", "v5e", 16, 320.0, 0.3),
    ("v5p-4", "v5p", 4, 340.0, 0.35),
    ("v5p-8", "v5p", 8, 680.0, 0.25),
    ("v6e-1", "v6e", 1, 55.0, 0.65),
    ("v6e-4", "v6e", 4, 220.0, 0.35),
)
# GKE accelerator label of each generation's node pool
NODE_LABELS = {"v5e": "tpu-v5-lite-podslice", "v5p": "tpu-v5p-slice",
               "v6e": "tpu-v6e-slice"}


@dataclass(frozen=True)
class Cluster:
    variants: int = 256
    namespaces: int = 4
    models: int = 32
    profiles: int = 2
    percentile: float | None = None
    nodes: tuple = ()              # ((generation, chips), ...)
    operator: tuple = ()           # extra operator ConfigMap (key, value)
    seed: int = 0
    # FaultRule fields as dicts: a FaultPlan of the package's own types,
    # attached to the kube and wrapped around Prometheus
    faults: tuple = ()


@dataclass
class Built:
    """One package's build of a Cluster."""

    pkg: str
    kube: object
    prom: object
    emitter: object
    rec: object
    mods: dict = field(default_factory=dict)
    plan: object = None            # the FaultPlan, when the cluster has one


class Clock:
    """Injected wall clock and monotonic clock, advanced between cycles."""

    def __init__(self, t0: float = 1_700_000_000.0):
        self.t = t0

    def now(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t - 1_600_000_000.0

    def advance(self, seconds: float) -> None:
        self.t += seconds


def va_key(i: int, c: Cluster) -> tuple[str, str]:
    return f"v{i:05d}", f"ns{i % c.namespaces}"


def model_of(i: int, c: Cluster) -> str:
    return f"m{i % c.models}"


def profiles(c: Cluster) -> dict:
    """model -> [(slice name, alpha, beta, gamma, delta, max_batch)]."""
    rng = np.random.default_rng(c.seed)
    out = {}
    for m in range(c.models):
        u = rng.uniform(0.8, 1.25, 4)
        rows = []
        for name, _gen, _chips, _cost, speed in SHAPES[:c.profiles]:
            f = speed * float(rng.uniform(0.95, 1.05))
            rows.append((name, 6.973 * float(u[0]) * f,
                         0.027 * float(u[1]) * f, 5.2 * float(u[2]) * f,
                         0.1 * float(u[3]) * f,
                         int(rng.choice([64, 128, 256]))))
        out[f"m{m}"] = rows
    return out


def loads(c: Cluster, seed_offset: int = 1) -> dict:
    """(model, namespace) -> dict of the six scraped values."""
    rng = np.random.default_rng(c.seed + seed_offset)
    out = {}
    for i in range(c.variants):
        key = (model_of(i, c), va_key(i, c)[1])
        if key in out:
            continue
        out[key] = {
            "rps": float(rng.uniform(0.5, 40.0)),
            "prompt": float(rng.choice([128.0, 256.0, 512.0])),
            "gen": float(rng.choice([128.0, 256.0])),
            "ttft": float(rng.uniform(0.05, 0.4)),
            "itl": float(rng.uniform(0.008, 0.03)),
        }
    return out


def churn(load: dict, share: float, rng: np.random.Generator) -> list:
    """Scale the arrival rate of about `share` of the groups in place;
    returns the changed keys."""
    keys = sorted(load)
    n = max(1, int(round(share * len(keys))))
    picked = [keys[j] for j in rng.choice(len(keys), size=n, replace=False)]
    for k in picked:
        load[k]["rps"] = float(load[k]["rps"] * rng.uniform(0.3, 1.8))
    return picked


def _service_classes(c: Cluster) -> dict:
    models = [f"m{m}" for m in range(c.models)]
    pct = (f"    slo-ttft-percentile: {c.percentile}\n"
           if c.percentile else "")
    premium = "name: Premium\npriority: 1\ndata:\n" + "".join(
        f"  - model: {m}\n    slo-tpot: 24\n    slo-ttft: 500\n{pct}"
        for m in models)
    freemium = "name: Freemium\npriority: 10\ndata:\n" + "".join(
        f"  - model: {m}\n    slo-tpot: 40\n    slo-ttft: 2000\n"
        for m in models)
    return {"premium": premium, "freemium": freemium}


def modules(pkg: str) -> dict:
    return {
        "col": importlib.import_module(pkg + ".collector"),
        "ctl": importlib.import_module(pkg + ".controller"),
        "kube": importlib.import_module(pkg + ".controller.kube"),
        "met": importlib.import_module(pkg + ".metrics"),
        "obs": importlib.import_module(pkg + ".obs"),
        "faults": importlib.import_module(pkg + ".faults"),
    }


def set_loads(b: Built, load: dict, failing: tuple = ()) -> None:
    """Answer every query from `load`; the groups in `failing` are left
    out of the grouped results and their per-variant demand query
    raises (a Prometheus error for that model)."""
    col = b.mods["col"]
    prom = b.prom
    prom.query_results.clear()
    prom.query_errors.clear()
    grouped = (
        (col.fleet_true_arrival_rate_query(), "rps"),
        (col.fleet_arrival_rate_query(), "rps"),
        (col.fleet_avg_prompt_tokens_query(), "prompt"),
        (col.fleet_avg_generation_tokens_query(), "gen"),
        (col.fleet_avg_ttft_query(), "ttft"),
        (col.fleet_avg_itl_query(), "itl"),
        (col.fleet_availability_query(), None),
    )
    for q, _field in grouped:
        prom.set_empty(q)
    for (model, ns), v in sorted(load.items()):
        per_variant = (
            (col.true_arrival_rate_query(model, ns), v["rps"]),
            (col.arrival_rate_query(model, ns), v["rps"]),
            (col.avg_prompt_tokens_query(model, ns), v["prompt"]),
            (col.avg_generation_tokens_query(model, ns), v["gen"]),
            (col.avg_ttft_query(model, ns), v["ttft"]),
            (col.avg_itl_query(model, ns), v["itl"]),
        )
        for q, value in per_variant:
            prom.set_result(q, value)
        if (model, ns) in failing:
            prom.set_error(col.true_arrival_rate_query(model, ns),
                           ConnectionError("prometheus unreachable"))
            continue
        labels = {"model_name": model, "namespace": ns}
        for q, fld in grouped:
            prom.add_result(q, 1.0 if fld is None else v[fld],
                            labels=labels)


def build(pkg: str, c: Cluster, clock: Clock, load: dict,
          **rec_kw) -> Built:
    """The cluster through `pkg`'s modules, with a Reconciler on the
    injected clock (no-op sleep, a decision ring large enough for every
    variant of several cycles)."""
    mods = modules(pkg)
    ctl, kmod, crd = mods["ctl"], mods["kube"], mods["ctl"].crd
    kube = ctl.InMemoryKube()
    operator = {"GLOBAL_OPT_INTERVAL": "60s", **dict(c.operator)}
    if c.nodes:
        operator["WVA_LIMITED_MODE"] = "true"
    kube.put_configmap(ctl.ConfigMap(
        ctl.CONFIG_MAP_NAME, ctl.CONFIG_MAP_NAMESPACE, operator))
    kube.put_configmap(ctl.ConfigMap(
        ctl.ACCELERATOR_CM_NAME, ctl.CONFIG_MAP_NAMESPACE,
        {name: json.dumps({"chip": gen, "chips": str(chips),
                           "cost": str(cost)})
         for name, gen, chips, cost, _s in SHAPES[:c.profiles]}))
    kube.put_configmap(ctl.ConfigMap(
        ctl.SERVICE_CLASS_CM_NAME, ctl.CONFIG_MAP_NAMESPACE,
        _service_classes(c)))
    for j, (gen, chips) in enumerate(c.nodes):
        kube.put_node(kmod.Node(
            name=f"node-{gen}-{j}",
            labels={"cloud.google.com/gke-tpu-accelerator":
                    NODE_LABELS[gen]},
            tpu_capacity=int(chips)))
    prof = profiles(c)
    for i in range(c.variants):
        name, ns = va_key(i, c)
        model = model_of(i, c)
        replicas = 1 + i % 3
        kube.put_deployment(ctl.Deployment(
            name=name, namespace=ns, spec_replicas=replicas,
            status_replicas=replicas))
        accs = [crd.AcceleratorProfile(
            acc=acc, acc_count=1,
            perf_parms=crd.PerfParms(
                decode_parms={"alpha": repr(a), "beta": repr(bt)},
                prefill_parms={"gamma": repr(g), "delta": repr(d)}),
            max_batch_size=mb) for acc, a, bt, g, d, mb in prof[model]]
        kube.put_variant_autoscaling(crd.VariantAutoscaling(
            metadata=crd.ObjectMeta(
                name=name, namespace=ns,
                labels={crd.ACCELERATOR_LABEL:
                        SHAPES[i % c.profiles][0]}),
            spec=crd.VariantAutoscalingSpec(
                model_id=model,
                slo_class_ref=crd.ConfigMapKeyRef(
                    name=ctl.SERVICE_CLASS_CM_NAME,
                    key="premium" if i % 2 == 0 else "freemium"),
                model_profile=crd.ModelProfile(accelerators=accs))))
    prom = mods["col"].FakePromAPI(now=clock.now)
    plan = None
    if c.faults:
        fl = mods["faults"]
        plan = fl.FaultPlan([fl.FaultRule(**r) for r in c.faults],
                            seed=c.seed)
        kube.attach_fault_plan(plan)
    emitter = mods["met"].MetricsEmitter()
    rec = ctl.Reconciler(
        kube=kube, prom=prom if plan is None
        else mods["faults"].FaultyPromAPI(prom, plan),
        emitter=emitter, now=clock.now,
        sleep=lambda _s: None, monotonic=clock.monotonic,
        decisions=mods["obs"].DecisionLog(capacity=8 * c.variants + 64,
                                          now=clock.now),
        **rec_kw)
    b = Built(pkg=pkg, kube=kube, prom=prom, emitter=emitter, rec=rec,
              mods=mods, plan=plan)
    set_loads(b, load)
    return b


# the emitter series a decision shows on (per-variant labels)
DECISION_SERIES = ("inferno_desired_replicas", "inferno_current_replicas",
                   "inferno_desired_ratio", "inferno_replica_scaling_total",
                   "inferno_condition_status", "inferno_degradation_state",
                   "inferno_variant_power_watts")


def samples(emitter, series=DECISION_SERIES) -> dict:
    """(sample name, sorted labels) -> value for the named series."""
    out = {}
    for metric in emitter.registry.collect():
        for s in metric.samples:
            if s.name in series:
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def published(b: Built, c: Cluster) -> dict:
    """(name, namespace) -> the VA's published status: desired
    (accelerator, replicas), current max batch, and conditions as
    (type, status, reason)."""
    out = {}
    for i in range(c.variants):
        name, ns = va_key(i, c)
        try:
            va = b.kube.get_variant_autoscaling(name, ns)
        except Exception:  # noqa: BLE001 - a deleted VA reads as absent
            continue
        d = va.status.desired_optimized_alloc
        out[(name, ns)] = (
            d.accelerator, d.num_replicas, va.status.current_alloc.max_batch,
            tuple(sorted((x.type, x.status, x.reason)
                         for x in va.status.conditions)))
    return out


def decision_records(b: Built, cycle: int) -> dict:
    """(variant, namespace) -> the cycle's DecisionRecord as a dict,
    without the trace id (a random identifier)."""
    out = {}
    for rec in b.rec.decisions.records():
        if rec.cycle != cycle:
            continue
        d = rec.to_dict()
        d.pop("trace_id")
        out[(rec.variant, rec.namespace)] = d
    return out
