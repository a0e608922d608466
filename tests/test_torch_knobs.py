"""The port reads every env-then-ConfigMap knob through `utils.knob`,
and reads each as the JAX package reads it.

Each knob below is read through the accessor both packages read it by
(the Reconciler's solve engine and knob methods, translate, collector,
utils and the streaming core), on a Reconciler of each package over an
empty fleet, with the same environment and operator ConfigMap, in six
cases: a value in the environment wins over the ConfigMap's; the
ConfigMap's value counts when the environment leaves the knob unset or
empty; with neither set the accessor's default holds; an environment
value of blanks, and the ConfigMap's value padded with blanks in the
environment, read as the reference reads them (most knobs let blanks
win, `WVA_TTFT_PERCENTILE` and `WVA_METRIC_FAMILY` fall through to the
ConfigMap, `WVA_TPU_METRICS` does not strip). The JetStream label
overrides keep their own rule (an environment value set to "" wins).
Then one case holds the three readers of WVA_SOLVE_EPSILON (the engine,
the scoped micro-cycle, the streaming core) to one value.
"""

import importlib
import math
from dataclasses import dataclass

import pytest
import torch

import reconcile_cluster as rc
from reconcile_cluster import JAX, PORT, Cluster
from workload_variant_autoscaler_tpu_torch.controller import (
    reconciler as reconciler_mod,
)
from workload_variant_autoscaler_tpu_torch.stream import StreamCore


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def module(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def reconciler(pkg: str):
    """A Reconciler of `pkg` over an empty fleet (the port's on the CPU
    in float64)."""
    ctl = module(pkg, "controller")
    kube = ctl.InMemoryKube()
    for name, data in ((ctl.CONFIG_MAP_NAME, {"GLOBAL_OPT_INTERVAL": "60s"}),
                       (ctl.ACCELERATOR_CM_NAME, {}),
                       (ctl.SERVICE_CLASS_CM_NAME, {})):
        kube.put_configmap(ctl.ConfigMap(name, ctl.CONFIG_MAP_NAMESPACE,
                                         data))
    on = ({"device": "cpu", "dtype": torch.float64} if pkg == PORT
          else {})
    return ctl.Reconciler(kube, module(pkg, "collector").FakePromAPI(),
                          sleep=lambda _s: None, **on)


def engine(read):
    return lambda _pkg, rec, cm: read(rec._solve_engine(cm))


def last_cm(read):
    """An accessor that reads the last operator ConfigMap the cycle saw."""
    def run(_pkg, rec, cm):
        rec._last_operator_cm = cm
        return read(rec)
    return run


def sample_hz(pkg, rec, cm):
    """The rate the cycle starts its residual sampler at (0: none)."""
    started = [0.0]

    class Sampler:
        def __init__(self, hz):
            started[0] = hz

        def start(self):
            return self

        def stop(self):
            return None

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module(pkg, "controller.reconciler"), "ResidualSampler",
                   Sampler)
        rec._last_operator_cm = cm
        rec.reconcile()
    return started[0]


def tpu_scrape(_pkg, rec, cm):
    """Whether the TPU gauges are scraped for one namespace."""
    seen = []
    rec.emitter.emit_tpu_utilization_metrics = seen.append
    rec._collect_tpu_utilization({"ns0"}, operator_cm=cm)
    return seen[-1] != {}


def stream_core(read):
    def run(pkg, rec, cm):
        rec._last_operator_cm = cm
        return read(module(pkg, "stream").StreamCore(rec))
    return run


def family(pkg, cm):
    """active_family as each package's ingest door calls it."""
    active = module(pkg, "collector").active_family
    if pkg == PORT:
        return active(cm)
    return active(cm.get("WVA_METRIC_FAMILY"), cm=cm)


def jetstream(field):
    return lambda pkg, _rec, cm: getattr(
        family(pkg, {"WVA_METRIC_FAMILY": "jetstream", **cm}), field)


@dataclass(frozen=True)
class Knob:
    key: str
    read: object            # (package, reconciler, ConfigMap) -> reading
    env: str                # the environment's value ...
    cm: str                 # ... and the ConfigMap's
    want_env: object
    want_cm: object
    want_default: object
    # the reading with the environment set to "", where the knob's own
    # rule is not the ConfigMap's value
    want_empty: object = "cm"


def hier_kind(e):
    return type(e).__name__, getattr(e, "min_variants", None)


KNOBS = {k.key: k for k in (
    Knob("WVA_INCREMENTAL_SOLVE", engine(lambda e: e is not None),
         "on", "off", True, False, True),
    Knob("WVA_HIER_SOLVE", engine(hier_kind), "on", "off",
         ("HierarchicalSolveEngine", 0), ("IncrementalSolveEngine", None),
         ("HierarchicalSolveEngine", 2048)),
    Knob("WVA_SOLVE_EPSILON", engine(lambda e: e.epsilon),
         "0.05", "0.1", 0.05, 0.1, 0.02),
    Knob("WVA_SOLVE_FULL_EVERY", engine(lambda e: e.full_every),
         "5", "9", 5, 9, 32),
    Knob("WVA_HIER_SHARD_VARIANTS", engine(lambda e: e.shard_target),
         "256", "512", 256, 512, 1024),
    Knob("WVA_HIER_MIN_VARIANTS", engine(lambda e: e.min_variants),
         "10", "20", 10, 20, 2048),
    Knob("WVA_ARENA_CHECKPOINT", engine(lambda e: e.checkpoint_path),
         "env.ckpt", "cm.ckpt", "env.ckpt", "cm.ckpt", None),
    Knob("WVA_ARENA_CHECKPOINT_EVERY", engine(lambda e: e.checkpoint_every),
         "4", "6", 4, 6, 8),
    Knob("WVA_ARENA_CHECKPOINT_MAX_AGE_S",
         engine(lambda e: e.checkpoint_max_age_s),
         "120", "60", 120.0, 60.0, 3600.0),
    Knob("WVA_STREAM", lambda _pkg, rec, cm: rec._stream_enabled(cm),
         "on", "off", True, False, True),
    Knob("WVA_CYCLE_DEADLINE", last_cm(lambda rec: rec._cycle_budget_s()),
         "5s", "30s", 5.0, 30.0, math.inf),
    Knob("WVA_PROFILE_SAMPLE_HZ", sample_hz, "50", "20", 50.0, 20.0, 0.0),
    Knob("WVA_TPU_METRICS", tpu_scrape, "true", "false", True, False, True),
    Knob("WVA_FAST_DEMAND_PROBE",
         last_cm(lambda rec: rec._probe_knob(rec.PROBE_ENV, 0.0)),
         "5", "10", 5.0, 10.0, 0.0),
    Knob("WVA_FAST_PROBE_UTIL",
         last_cm(lambda rec: rec._probe_knob(rec.PROBE_UTIL_ENV, 0.85)),
         "0.7", "0.9", 0.7, 0.9, 0.85),
    Knob("WVA_FAST_PROBE_WINDOW", last_cm(lambda rec: rec.probe_window()),
         "15s", "30s", "15s", "30s", "1m"),
    Knob("WVA_TTFT_PERCENTILE",
         lambda pkg, _rec, cm: module(
             pkg, "controller").translate.ttft_percentile(cm),
         "0.9", "0.95", 0.9, 0.95, None),
    Knob("WVA_COLLECT_FANOUT",
         lambda pkg, _rec, cm: module(pkg, "utils").fanout_workers(cm),
         "3", "12", 3, 12, 8),
    Knob("WVA_METRIC_FAMILY", lambda pkg, _rec, cm: family(pkg, cm).name,
         "vllm", "jetstream", "vllm", "jetstream", "vllm"),
    Knob("WVA_STREAM_LAG_BUDGET_MS",
         stream_core(lambda core: core._lag_budget_s()),
         "100", "200", 0.1, 0.2, 5.0),
    Knob("WVA_STREAM_PUSHDOWN",
         stream_core(lambda core: core.pushdown_enabled()),
         "on", "off", True, False, True),
    # the JetStream overrides: a set environment value wins, even ""
    Knob("WVA_JETSTREAM_NAMESPACE_LABEL", jetstream("namespace_label"),
         "ns_env", "ns_cm", "ns_env", "ns_cm", "namespace", want_empty=""),
)}

CASES = ("env-wins", "cm-when-env-unset", "cm-when-env-empty",
         "env-blank", "env-padded", "default")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("key", list(KNOBS))
def test_env_then_configmap(key, case, monkeypatch):
    """The port's reading equals the JAX package's, and, where the case
    has one, the knob's own expected value."""
    k = KNOBS[key]
    env = {"env-wins": k.env, "cm-when-env-empty": "", "env-blank": "  ",
           "env-padded": f" {k.cm} "}.get(case)
    if env is None:
        monkeypatch.delenv(key, raising=False)
    else:
        monkeypatch.setenv(key, env)
    cm = {} if case in ("default", "env-padded") else {key: k.cm}
    mine = k.read(PORT, reconciler(PORT), dict(cm))
    assert mine == k.read(JAX, reconciler(JAX), dict(cm))
    want = {"env-wins": k.want_env, "cm-when-env-unset": k.want_cm,
            "cm-when-env-empty": k.want_empty,
            "default": k.want_default}.get(case, mine)
    assert mine == (k.want_cm if want == "cm" else want)


@pytest.mark.parametrize("where", ["configmap", "env"])
@pytest.mark.parametrize("raw,want", [("0.05", 0.05), ("0", 0.0),
                                      ("-1", 0.02), ("junk", 0.02)])
def test_solve_epsilon_one_value_for_its_three_readers(raw, want, where,
                                                       monkeypatch):
    """The engine a full pass sizes with, the scoped micro-cycle's load
    snap and the streaming core's door read one WVA_SOLVE_EPSILON; a
    negative or unparsable value reads the default everywhere."""
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    if where == "env":
        monkeypatch.setenv("WVA_SOLVE_EPSILON", raw)
        operator = ()
    else:
        monkeypatch.delenv("WVA_SOLVE_EPSILON", raising=False)
        operator = (("WVA_SOLVE_EPSILON", raw),)
    c = Cluster(variants=8, models=2, namespaces=2, operator=operator)
    clock = rc.Clock()
    p = rc.build(PORT, c, clock, rc.loads(c), device="cpu",
                 dtype=torch.float64)
    p.rec.reconcile()
    snapped = []
    quantize = reconciler_mod.quantize_load

    def spy(load, epsilon):
        snapped.append(epsilon)
        return quantize(load, epsilon)

    monkeypatch.setattr(reconciler_mod, "quantize_load", spy)
    clock.advance(60.0)
    keys = [":".join(rc.va_key(i, c)) for i in range(c.variants)
            if rc.model_of(i, c) == rc.model_of(0, c)]
    assert sorted(p.rec.reconcile(scope=keys).processed) == sorted(keys)
    readings = {p.rec._solve_engine_obj.epsilon, *snapped,
                StreamCore(p.rec)._epsilon()}
    assert snapped and readings == {want}
