"""North-star benchmark of the PyTorch port: chip-hours to hold the p95-ITL
SLO under a ShareGPT-style load ramp, with the autoscaler's reconcile
cycle on the card.

The counterpart of bench_loop.py: the same scenarios, the same
measurement contract, the same one JSON line and exit code. It runs the
full closed loop — emulator fleet -> sim-time Prometheus -> the port's
Reconciler -> (emulated) HPA actuation -> fleet replicas — in simulated
time, with the Llama-3.1-8B v5e-1 profile and the Premium service class
(slo-tpot 24ms, slo-ttft 500ms) in the default scenario. The emulator's
decode/prefill physics follow the same fitted linear models the analyzer
uses, so the measured ITL distribution is the ground truth the SLO is
judged against.

    python3 bench_torch_loop.py [key] [--device cuda|cpu] [--dtype float32|float64]

`key` is sharegpt-ramp (the default), fleet-scale, solve-churn or one of
SCENARIOS; `list` names them. The Reconciler runs on `cuda` unless
`--device cpu` is asked, in float32 unless `--dtype float64` is; without
CUDA a run raises, it never drops to the CPU on its own. On the card
every sizing group goes through the CUDA bisection kernels: the mean
form (B1) on every cycle that sizes, the tail form (B2) on the TTFT rows
of the scenarios that size on p95 TTFT (WVA_TTFT_PERCENTILE=0.95).

Default scenario: a ShareGPT-like token mix (uniform lengths averaging
221 in / 179 out, the ShareGPT_V3 corpus means, rounded); a 30-minute
ramp, req/s 10 -> 25 -> 45 -> 60 -> 25 -> 10 (300s each); a reconcile
every 60s, WVA_SCALE_DOWN_STABILIZATION 180s, scale-to-zero off.

Metric: chip-hours provisioned (active + draining replica-time, 1 chip
per v5e-1 replica) while p95 ITL (post-warmup) meets the SLO. Baseline:
static peak provisioning, the replicas the sizer needs at the peak rate
held for the whole scenario. vs_baseline = static chip-hours /
autoscaled chip-hours.

What the numbers are:
- value, the p95s, energy_wh, peak_replicas and requests are
  simulated-time quantities of the EMULATED TPU fleet (its chips, its
  power curve). They depend only on the decisions, so any device that
  decides the same gives the same numbers; they are not the card's.
- reconcile_wall_ms_p50/max and the fleet-scale and solve-churn walls
  are host-clock times of the port's cycle on `device`, synchronized
  with the card: the device's own numbers.
- device (the card's name and power limit as nvidia-smi gives them, or
  "cpu"), dtype, backend and kernel_launches (B1/B2 launches per
  reconcile cycle, from the port's launch counters; zero on the CPU,
  where nothing launches) say where the cycle ran.

Prints ONE JSON line; exits 1 if the SLO did not hold (a cheap answer
that violates the SLO is not an answer), 2 for an unknown key.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time as _time
from collections import Counter

import torch

# keep stdout clean for the single JSON result line
os.environ.setdefault("LOG_LEVEL", "error")

from workload_variant_autoscaler_tpu_torch.controller import (  # noqa: E402
    ACCELERATOR_CM_NAME,
    CONFIG_MAP_NAME,
    CONFIG_MAP_NAMESPACE,
    SERVICE_CLASS_CM_NAME,
    ConfigMap,
    Deployment,
    InMemoryKube,
    Reconciler,
    crd,
)
from workload_variant_autoscaler_tpu_torch.controller.translate import (  # noqa: E402
    engine_backend,
    warmup_plan,
)
from workload_variant_autoscaler_tpu_torch.emulator import (  # noqa: E402
    Fleet,
    PoissonLoadGenerator,
    PrometheusSink,
    SimPromAPI,
    Simulation,
    SliceModelConfig,
    TokenDistribution,
)
from workload_variant_autoscaler_tpu_torch.emulator.engine import MetricsSink  # noqa: E402
from workload_variant_autoscaler_tpu_torch.metrics import (  # noqa: E402
    INFERNO_SOLVE_LANES,
    STATE_SOLVED,
    MetricsEmitter,
)
from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as _bk  # noqa: E402
from workload_variant_autoscaler_tpu_torch.ops import fused as _fused  # noqa: E402
from workload_variant_autoscaler_tpu_torch.utils.device import (  # noqa: E402
    device_name,
    resolve_device,
    resolve_dtype,
)

MODEL = "llama-8b"
NS = "default"
VARIANT = "chat-8b"

# Llama-3.1-8B fitted profile (reference parameter-estimation.md:265 for
# alpha/beta; emulator truth == analyzer model)
CFG = SliceModelConfig(
    model_name=MODEL, slice_name="v5e-1",
    alpha=6.973, beta=0.027, gamma=5.2, delta=0.1,
    max_batch_size=64, hbm_gb=16.0, model_size_gb=8.0, kv_mb_per_token=0.25,
)
SLO_ITL_MS = 24.0
SLO_TTFT_MS = 500.0

# ShareGPT-like mix and the ramp (see module docstring)
TOKENS = TokenDistribution(avg_input_tokens=221, avg_output_tokens=179,
                           distribution="uniform")
RAMP = [(300, 600), (300, 1500), (300, 2700), (300, 3600), (300, 1500),
        (300, 600)]  # (seconds, rpm)
DURATION_MS = sum(d for d, _ in RAMP) * 1000.0
WARMUP_MS = 120_000.0  # first reconcile periods: cold start, not steady state
RECONCILE_MS = 60_000.0
CHIPS_PER_REPLICA = 1  # v5e-1
SEED = 20260729
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def oracle_chip_hours(ramp) -> float:
    """Clairvoyant provisioning cost: the minimum replicas the sizer
    itself says hold the SLOs at each segment's offered rate, switched
    the instant the segment starts (no measurement window, no reconcile
    cadence, no drain). The tightest bound any autoscaler with this
    performance model could reach."""
    import math

    from workload_variant_autoscaler_tpu_torch.ops.analyzer import (
        QueueAnalyzer,
        QueueConfig,
        RequestSize,
        ServiceParms,
        TargetPerf,
    )

    qa = QueueAnalyzer(
        QueueConfig(
            max_batch_size=CFG.max_batch_size,
            max_queue_size=CFG.max_batch_size * 10,
            parms=ServiceParms(alpha=CFG.alpha, beta=CFG.beta,
                               gamma=CFG.gamma, delta=CFG.delta),
        ),
        RequestSize(avg_input_tokens=TOKENS.avg_input_tokens,
                    avg_output_tokens=TOKENS.avg_output_tokens),
    )
    r = qa.size(TargetPerf(ttft=SLO_TTFT_MS, itl=SLO_ITL_MS))
    rate_star = min(r.rate_ttft, r.rate_itl, r.rate_tps)  # req/s per replica
    chip_s = 0.0
    for dur_s, rpm in ramp:
        replicas = max(math.ceil((rpm / 60.0) / rate_star), 1)
        chip_s += replicas * CHIPS_PER_REPLICA * dur_s
    return chip_s / 3600.0


class LatencySink(MetricsSink):
    """Compact ITL/TTFT percentile recorder: decode steps take few distinct
    values (alpha + beta*batch), so a Counter stays tiny at millions of
    tokens."""

    def __init__(self, from_ms: float):
        self.from_ms = from_ms
        self.now_ms = 0.0
        self.itl_counts: Counter[float] = Counter()
        self.ttfts: list[tuple[float, float]] = []

    def on_token(self, dt_ms: float) -> None:
        if self.now_ms >= self.from_ms:
            self.itl_counts[round(dt_ms, 3)] += 1

    def on_first_token(self, req) -> None:
        self.ttfts.append((req.first_token_ms, req.ttft_ms))

    def p95_itl(self) -> float:
        total = sum(self.itl_counts.values())
        if total == 0:
            return float("nan")
        seen = 0
        for dt in sorted(self.itl_counts):
            seen += self.itl_counts[dt]
            if seen >= 0.95 * total:
                return dt
        return max(self.itl_counts)

    def p95_ttft(self, from_ms: float) -> float:
        vals = sorted(v for t, v in self.ttfts if t >= from_ms)
        if not vals:
            return float("nan")
        return vals[int(len(vals) * 0.95)]


class _Composite:
    def __init__(self, *sinks):
        self.sinks = sinks

    def __getattr__(self, name):
        targets = [getattr(s, name) for s in self.sinks]

        def fan_out(*args, **kwargs):
            for t in targets:
                t(*args, **kwargs)
        # cache: on_token fires per generated token (~10M/run); dispatch
        # must not rebuild the closure every call
        setattr(self, name, fan_out)
        return fan_out


class CycleLog:
    """Runs a Reconciler's cycles and keeps, for each, its wall (host
    clock, synchronized with the card, in ms), its B1 (mean form) and B2
    (tail form) kernel launches, read as differences of the port's launch
    counters around the cycle (they count launches on the card only),
    and whether it sized any lane (the inferno_solve_lanes gauge the
    cycle sets)."""

    def __init__(self, rec: Reconciler):
        self.rec = rec
        self.walls: list[float] = []
        self.cycles: list[tuple[int, int, bool]] = []

    def reconcile(self):
        before = dict(_bk.launches)
        t0 = _time.perf_counter()
        result = self.rec.reconcile()
        if self.rec.device.type == "cuda":
            torch.cuda.synchronize(self.rec.device)
        self.walls.append((_time.perf_counter() - t0) * 1000.0)
        solved = self.rec.emitter.value(INFERNO_SOLVE_LANES,
                                        state=STATE_SOLVED) or 0.0
        self.cycles.append((_bk.launches["mean"] - before["mean"],
                            _bk.launches["tail"] - before["tail"],
                            solved > 0))
        return result

    def launches(self) -> dict:
        """B1/B2 launches per cycle; on the card every cycle that sizes
        launches B1, and B2 too in a scenario that sizes on p95 TTFT."""
        n = len(self.cycles)
        b1 = sum(c[0] for c in self.cycles)
        b2 = sum(c[1] for c in self.cycles)
        sizing = [c for c in self.cycles if c[2]]
        return {
            "cycles": n,
            "sizing_cycles": len(sizing),
            "B1": b1,
            "B2": b2,
            "B1_per_cycle": b1 / n if n else 0.0,
            "B2_per_cycle": b2 / n if n else 0.0,
            "sizing_cycles_with_B1": sum(1 for c in sizing if c[0] > 0),
            "sizing_cycles_with_B2": sum(1 for c in sizing if c[1] > 0),
        }


def warm_kernels(kube, device, dtype) -> None:
    """Build the kernel library and run one decision of each sizing
    group's form at its shape (translate.warmup_plan, as the controller
    process does at startup; the tail form too where the fleet sizes on
    a TTFT percentile), so reconcile_wall_ms measures steady cycles, not
    the build or a first launch."""
    def cm(name):
        return kube.get_configmap(name, CONFIG_MAP_NAMESPACE).data

    for bucket, max_batch, pct in warmup_plan(
            kube.list_variant_autoscalings(),
            service_class_cm=cm(SERVICE_CLASS_CM_NAME),
            operator_cm=cm(CONFIG_MAP_NAME)):
        _fused.warmup(max_batch=max_batch, bucket=bucket,
                      ttft_percentile=pct, device=device, dtype=dtype)


# result keys that say where a run happened (the reporting keys) or time
# it on the host's clock: all that may differ between two runs that
# decide the same, on two devices
WHERE_KEYS = frozenset({"device", "dtype", "backend", "kernel_launches",
                        "reconcile_wall_ms_p50", "reconcile_wall_ms_max"})


def where(device, dtype) -> dict:
    """The reporting keys of a run, resolved before it starts: the device
    the cycle runs on (raises without CUDA unless it is the CPU; the
    card's label comes from nvidia-smi), its dtype and the engine
    backend selected for it."""
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    return {"device": device_name(dev),
            "dtype": str(dt).removeprefix("torch."),
            "backend": engine_backend(dev)}


def _walls(walls: list[float]) -> dict:
    walls = sorted(walls)
    return {"reconcile_wall_ms_p50": round(walls[len(walls) // 2], 2),
            "reconcile_wall_ms_max": round(walls[-1], 2)}


def build_loop(device=None, dtype=None):
    prom_sink = PrometheusSink(MODEL, NS)
    lat = LatencySink(from_ms=WARMUP_MS)
    fleet = Fleet(CFG, _Composite(prom_sink, lat), replicas=1)
    sim = Simulation(fleet, seed=SEED)
    prom = SimPromAPI(prom_sink, MODEL, NS)

    kube = InMemoryKube()
    kube.put_configmap(ConfigMap(CONFIG_MAP_NAME, CONFIG_MAP_NAMESPACE, {
        "GLOBAL_OPT_INTERVAL": "60s",
        "WVA_SCALE_DOWN_STABILIZATION": "180s",
    }))
    kube.put_configmap(ConfigMap(
        ACCELERATOR_CM_NAME, CONFIG_MAP_NAMESPACE,
        {"v5e-1": json.dumps({"chip": "v5e", "chips": "1", "cost": "20.0"})},
    ))
    kube.put_configmap(ConfigMap(
        SERVICE_CLASS_CM_NAME, CONFIG_MAP_NAMESPACE,
        {"premium": (
            "name: Premium\npriority: 1\ndata:\n"
            f"  - model: {MODEL}\n    slo-tpot: {SLO_ITL_MS:.0f}\n"
            f"    slo-ttft: {SLO_TTFT_MS:.0f}\n"
        )},
    ))
    kube.put_deployment(Deployment(name=VARIANT, namespace=NS,
                                   spec_replicas=1, status_replicas=1))
    va = crd.VariantAutoscaling(
        metadata=crd.ObjectMeta(name=VARIANT, namespace=NS,
                                labels={crd.ACCELERATOR_LABEL: "v5e-1"}),
        spec=crd.VariantAutoscalingSpec(
            model_id=MODEL,
            slo_class_ref=crd.ConfigMapKeyRef(name=SERVICE_CLASS_CM_NAME,
                                              key="premium"),
            model_profile=crd.ModelProfile(accelerators=[
                crd.AcceleratorProfile(
                    acc="v5e-1", acc_count=1,
                    perf_parms=crd.PerfParms(
                        decode_parms={"alpha": str(CFG.alpha),
                                      "beta": str(CFG.beta)},
                        prefill_parms={"gamma": str(CFG.gamma),
                                       "delta": str(CFG.delta)},
                    ),
                    max_batch_size=CFG.max_batch_size,
                ),
            ]),
        ),
    )
    kube.put_variant_autoscaling(va)

    rec = Reconciler(kube=kube, prom=prom, emitter=MetricsEmitter(),
                     now=lambda: sim.now_ms / 1000.0, sleep=lambda _s: None,
                     device=device, dtype=dtype)
    return sim, fleet, prom, kube, rec, lat


def run(ramp=None, warmup_ms: float = WARMUP_MS,
        reconcile_ms: float = RECONCILE_MS, *, device=None,
        dtype=None) -> dict:
    place = where(device, dtype)
    ramp = RAMP if ramp is None else ramp
    duration_ms = sum(d for d, _ in ramp) * 1000.0
    if duration_ms < reconcile_ms:
        raise ValueError(
            f"scenario too short: ramp lasts {duration_ms / 1000.0:.0f}s but "
            f"the first reconcile fires at {reconcile_ms / 1000.0:.0f}s; "
            "no autoscaling would be measured"
        )
    sim, fleet, prom, kube, rec, lat = build_loop(device, dtype)
    lat.from_ms = warmup_ms
    # warm the kernels as the controller does at startup: reconcile_wall_ms
    # then measures the steady-state cycle, not the build
    warm_kernels(kube, rec.device, rec.dtype)
    cycles = CycleLog(rec)
    gen = PoissonLoadGenerator(sim, schedule=ramp, tokens=TOKENS, seed=SEED)
    gen.start()

    chip_ms = 0.0
    watt_ms = 0.0
    power = _power_curve("v5e")
    last_sample_ms = 0.0
    history: list[tuple[float, int]] = []
    next_reconcile = reconcile_ms

    def on_tick(now_ms):
        nonlocal chip_ms, watt_ms, last_sample_ms, next_reconcile
        lat.now_ms = now_ms
        # chip-time integral: pay for every live pod, draining included
        provisioned = len(fleet.all_replicas()) * CHIPS_PER_REPLICA
        chip_ms += provisioned * (now_ms - last_sample_ms)
        watt_ms += fleet_watts(fleet, CHIPS_PER_REPLICA, power) * (now_ms - last_sample_ms)
        last_sample_ms = now_ms
        prom.scrape(now_ms)
        if now_ms >= next_reconcile:
            next_reconcile += reconcile_ms
            cycles.reconcile()
            va = kube.get_variant_autoscaling(VARIANT, NS)
            desired = va.status.desired_optimized_alloc.num_replicas
            history.append((now_ms, desired))
            kube.put_deployment(Deployment(name=VARIANT, namespace=NS,
                                           spec_replicas=desired,
                                           status_replicas=desired))
            fleet.set_replicas(max(desired, 0), now_ms)
            sim.kick()

    sim.run_until(duration_ms, on_tick=on_tick, tick_ms=5000.0)

    chip_hours = chip_ms / 3_600_000.0
    peak_replicas = max(d for _t, d in history)
    static_chip_hours = (peak_replicas * CHIPS_PER_REPLICA
                         * duration_ms / 3_600_000.0)
    oracle = oracle_chip_hours(ramp)
    p95_itl = lat.p95_itl()
    p95_ttft = lat.p95_ttft(warmup_ms)
    return {
        "metric": "chip_hours_to_hold_p95_itl_slo",
        "value": round(chip_hours, 3),
        "unit": "chip-hours",
        "vs_baseline": round(static_chip_hours / chip_hours, 3),
        "slo_held": bool(p95_itl <= SLO_ITL_MS),
        "p95_itl_ms": round(p95_itl, 3),
        "slo_itl_ms": SLO_ITL_MS,
        "p95_ttft_ms": round(p95_ttft, 1),
        "static_peak_chip_hours": round(static_chip_hours, 3),
        # clairvoyant lower bound: ceil(rate/rate*) replicas the instant
        # each ramp segment starts, zero reaction lag, zero drain time
        "oracle_chip_hours": round(oracle, 3),
        "efficiency_vs_oracle": round(oracle / chip_hours, 3),
        # energy of the emulated fleet: batch occupancy through the
        # catalog power curve (idle draw included for idle pods)
        "energy_wh": round(watt_ms / 3_600_000.0, 1),
        "peak_replicas": peak_replicas,
        "requests": gen.generated,
        # wall-clock of one full collect->analyze->optimize->publish cycle
        # on the device
        **_walls(cycles.walls),
        "scenario": "sharegpt-ramp-30min-v5e1-llama8b-premium",
        **place,
        "kernel_launches": cycles.launches(),
    }


# ---------------------------------------------------------------------------
# Multi-variant scenarios (BASELINE configs 2 and 5)
# ---------------------------------------------------------------------------
# The generic machinery below drives several (variant, fleet, loadgen)
# triples through ONE reconciler against ONE sim-time Prometheus — the
# same measurement contract, summed over a heterogeneous fleet.

from dataclasses import (  # noqa: E402
    dataclass,
    field as _field,
    replace as _dc_replace,
)

from workload_variant_autoscaler_tpu_torch.emulator import MultiPromAPI  # noqa: E402


@dataclass
class VariantScenario:
    name: str                   # VA / Deployment name
    model: str                  # model_id + model_name label
    sc_key: str                 # key in the service-classes ConfigMap
    accelerator: str            # slice shape (matches accelerator CM entry)
    chips_per_replica: int
    cfg: SliceModelConfig       # emulator ground-truth physics
    ramp: list                  # [(seconds, rpm)]
    tokens: TokenDistribution
    slo_itl_ms: float
    slo_ttft_ms: float


def _power_curve(chip: str):
    """Per-chip piecewise power model from the catalog (the same curve
    the controller's inferno_*_power_watts gauges use). It is the power
    of the EMULATED workload's TPU chips (v5e, v5p), not of the card the
    Reconciler runs on."""
    from workload_variant_autoscaler_tpu_torch.models.chips import make_slice
    from workload_variant_autoscaler_tpu_torch.models.entities import Accelerator

    acc = Accelerator(make_slice(chip, 1, cost_per_chip=0.0))
    acc.calculate()
    return acc.power


def fleet_watts(fleet, chips_per_replica: int, power) -> float:
    """Power draw of the emulated fleet: per-replica utilisation from the
    emulator's actual running batch (not the analyzer's model), idle draw
    included for provisioned-but-empty replicas and draining pods."""
    watts = 0.0
    for replica in fleet.all_replicas():
        util = min(len(replica.running) / replica.config.max_batch_size, 1.0)
        watts += power(util) * chips_per_replica
    return watts


@dataclass
class Scenario:
    key: str
    title: str
    accelerators: dict          # name -> {"chip": .., "chips": .., "cost": ..}
    service_classes: dict       # cm key -> service-class YAML
    variants: list = _field(default_factory=list)
    warmup_ms: float = WARMUP_MS
    reconcile_ms: float = RECONCILE_MS
    stabilization: str = "180s"
    operator_extra: dict = _field(default_factory=dict)  # extra operator-CM keys
    judge_ttft: bool = False  # strict mode: slo_held requires the TTFT tail too
    # demand-breakout probe period (0 = off): between cadence cycles the
    # probe compares live demand against the published capacity envelope
    # and reconciles early on breakout (reconciler.demand_probe)
    fast_probe_ms: float = 0.0


def _make_va(v: VariantScenario) -> crd.VariantAutoscaling:
    return crd.VariantAutoscaling(
        metadata=crd.ObjectMeta(name=v.name, namespace=NS,
                                labels={crd.ACCELERATOR_LABEL: v.accelerator}),
        spec=crd.VariantAutoscalingSpec(
            model_id=v.model,
            slo_class_ref=crd.ConfigMapKeyRef(name=SERVICE_CLASS_CM_NAME,
                                              key=v.sc_key),
            model_profile=crd.ModelProfile(accelerators=[
                crd.AcceleratorProfile(
                    acc=v.accelerator, acc_count=1,
                    perf_parms=crd.PerfParms(
                        decode_parms={"alpha": str(v.cfg.alpha),
                                      "beta": str(v.cfg.beta)},
                        prefill_parms={"gamma": str(v.cfg.gamma),
                                       "delta": str(v.cfg.delta)},
                    ),
                    max_batch_size=v.cfg.max_batch_size,
                ),
            ]),
        ),
    )


def run_scenario(sc: Scenario, *, device=None, dtype=None) -> dict:
    place = where(device, dtype)
    durations = {sum(d for d, _ in v.ramp) for v in sc.variants}
    if len(durations) != 1:
        raise ValueError("all variant ramps must cover the same duration")
    duration_ms = durations.pop() * 1000.0
    if duration_ms < sc.reconcile_ms:
        raise ValueError("scenario shorter than one reconcile interval")

    # one (sink, fleet, prom, latency) triple per variant; one sim over all
    lats, fleets, proms = {}, {}, []
    for v in sc.variants:
        prom_sink = PrometheusSink(v.model, NS)
        lat = LatencySink(from_ms=sc.warmup_ms)
        fleet = Fleet(v.cfg, _Composite(prom_sink, lat), replicas=1)
        lats[v.name], fleets[v.name] = lat, fleet
        proms.append((v, prom_sink))
    sim = Simulation([fleets[v.name] for v in sc.variants], seed=SEED)
    prom = MultiPromAPI([SimPromAPI(sink, v.model, NS) for v, sink in proms])

    kube = InMemoryKube()
    kube.put_configmap(ConfigMap(CONFIG_MAP_NAME, CONFIG_MAP_NAMESPACE, {
        "GLOBAL_OPT_INTERVAL": f"{sc.reconcile_ms / 1000.0:.0f}s",
        "WVA_SCALE_DOWN_STABILIZATION": sc.stabilization,
        **sc.operator_extra,
    }))
    kube.put_configmap(ConfigMap(
        ACCELERATOR_CM_NAME, CONFIG_MAP_NAMESPACE,
        {name: json.dumps(spec) for name, spec in sc.accelerators.items()},
    ))
    kube.put_configmap(ConfigMap(SERVICE_CLASS_CM_NAME, CONFIG_MAP_NAMESPACE,
                                 dict(sc.service_classes)))
    for v in sc.variants:
        kube.put_deployment(Deployment(name=v.name, namespace=NS,
                                       spec_replicas=1, status_replicas=1))
        kube.put_variant_autoscaling(_make_va(v))

    rec = Reconciler(kube=kube, prom=prom, emitter=MetricsEmitter(),
                     now=lambda: sim.now_ms / 1000.0, sleep=lambda _s: None,
                     device=device, dtype=dtype)
    # decision-neutral: the kernels (both forms in a p95 scenario) are
    # built and launched before the first cycle is timed
    warm_kernels(kube, rec.device, rec.dtype)
    cycles = CycleLog(rec)
    gens = {}
    for i, v in enumerate(sc.variants):
        gen = PoissonLoadGenerator(sim, schedule=v.ramp, tokens=v.tokens,
                                   seed=SEED + i, fleet=fleets[v.name])
        gen.start()
        gens[v.name] = gen

    chip_ms = {v.name: 0.0 for v in sc.variants}
    watt_ms = {v.name: 0.0 for v in sc.variants}
    # chip generation comes from the scenario's accelerator catalog (one
    # source of truth; a per-variant copy could silently desync the curve)
    curves = {v.name: _power_curve(sc.accelerators[v.accelerator]["chip"])
              for v in sc.variants}
    peak_desired = {v.name: 1 for v in sc.variants}
    probe_kicks = 0
    last_sample_ms = 0.0
    next_reconcile = sc.reconcile_ms
    next_probe = sc.fast_probe_ms

    def do_reconcile(now_ms):
        cycles.reconcile()
        for v in sc.variants:
            va = kube.get_variant_autoscaling(v.name, NS)
            desired = va.status.desired_optimized_alloc.num_replicas
            peak_desired[v.name] = max(peak_desired[v.name], desired)
            kube.put_deployment(Deployment(
                name=v.name, namespace=NS,
                spec_replicas=desired, status_replicas=desired))
            fleets[v.name].set_replicas(max(desired, 0), now_ms)
        sim.kick()

    def on_tick(now_ms):
        nonlocal last_sample_ms, next_reconcile, next_probe, probe_kicks
        dt = now_ms - last_sample_ms
        last_sample_ms = now_ms
        for v in sc.variants:
            lats[v.name].now_ms = now_ms
            chip_ms[v.name] += (len(fleets[v.name].all_replicas())
                                * v.chips_per_replica * dt)
            watt_ms[v.name] += fleet_watts(
                fleets[v.name], v.chips_per_replica, curves[v.name]) * dt
        prom.scrape(now_ms)
        if now_ms >= next_reconcile:
            next_reconcile += sc.reconcile_ms
            do_reconcile(now_ms)
        elif sc.fast_probe_ms and now_ms >= next_probe:
            # sim-time analogue of the controller's probe thread: one
            # cheap demand query per variant; breakout -> early cycle
            next_probe += sc.fast_probe_ms
            if rec.demand_probe():
                probe_kicks += 1
                do_reconcile(now_ms)

    sim.run_until(duration_ms, on_tick=on_tick, tick_ms=5000.0)

    total_chip_hours = sum(chip_ms.values()) / 3_600_000.0
    static_chip_hours = sum(
        peak_desired[v.name] * v.chips_per_replica * duration_ms / 3_600_000.0
        for v in sc.variants
    )
    per_variant = {}
    all_held = True
    for v in sc.variants:
        p95 = lats[v.name].p95_itl()
        p95_ttft = lats[v.name].p95_ttft(sc.warmup_ms)
        # the judged SLO is p95 ITL (the north-star metric); TTFT is
        # reported with its own held flag and gates the headline only in
        # strict scenarios (judge_ttft)
        ttft_ok = bool(p95_ttft <= v.slo_ttft_ms)
        held = bool(p95 <= v.slo_itl_ms) and (ttft_ok or not sc.judge_ttft)
        all_held = all_held and held
        per_variant[v.name] = {
            "model": v.model, "accelerator": v.accelerator,
            "p95_itl_ms": round(p95, 3), "slo_itl_ms": v.slo_itl_ms,
            "p95_ttft_ms": round(p95_ttft, 1), "slo_ttft_ms": v.slo_ttft_ms,
            "ttft_held": ttft_ok,
            "slo_held": held, "peak_replicas": peak_desired[v.name],
            "chip_hours": round(chip_ms[v.name] / 3_600_000.0, 3),
            # energy of the emulated fleet: batch occupancy through the
            # same piecewise power curve the controller's gauges use
            "energy_wh": round(watt_ms[v.name] / 3_600_000.0, 1),
            "requests": gens[v.name].generated,
        }
    out = {
        "metric": "chip_hours_to_hold_p95_itl_slo",
        "value": round(total_chip_hours, 3),
        "unit": "chip-hours",
        "vs_baseline": round(static_chip_hours / total_chip_hours, 3),
        "slo_held": all_held,
        "static_peak_chip_hours": round(static_chip_hours, 3),
        "energy_wh": round(sum(watt_ms.values()) / 3_600_000.0, 1),
        "scenario": sc.key,
        "variants": per_variant,
    }
    if sc.fast_probe_ms:
        out["probe_kicks"] = probe_kicks
    out.update(_walls(cycles.walls))
    out.update(place)
    out["kernel_launches"] = cycles.launches()
    return out


_PREMIUM_YAML = (
    "name: Premium\npriority: 1\ndata:\n"
    "  - model: llama-8b\n    slo-tpot: 24\n    slo-ttft: 500\n"
)
_FREEMIUM_YAML = (
    "name: Freemium\npriority: 10\ndata:\n"
    "  - model: llama-70b\n    slo-tpot: 200\n    slo-ttft: 4000\n"
)

_CHAT_8B = VariantScenario(
    name=VARIANT, model=MODEL, sc_key="premium", accelerator="v5e-1",
    chips_per_replica=1, cfg=CFG, ramp=[list(seg) for seg in RAMP],
    tokens=TOKENS, slo_itl_ms=SLO_ITL_MS, slo_ttft_ms=SLO_TTFT_MS,
)

# Llama-70B on a v5e-8 slice (8-chip TP): slower per-token than v5p but
# cheap; weights ~70 GB int8 over 8x16 GB HBM
_CFG_70B_V5E8 = SliceModelConfig(
    model_name="llama-70b", slice_name="v5e-8",
    alpha=20.0, beta=0.1, gamma=15.0, delta=0.15,
    max_batch_size=32, hbm_gb=128.0, model_size_gb=70.0, kv_mb_per_token=0.8,
)
# shared by multi-model-mix (mean-based ablation) and multi-model-p95
# (full-SLO headline): the pair's comparability depends on byte-identical
# configs, so catalog, class map, and variant each have exactly ONE
# definition (same rule for the strict-knob dict, shared with
# sharegpt-fast-probe — BASELINE.md claims "the same knobs")
_MM_ACCELERATORS = {
    "v5e-1": {"chip": "v5e", "chips": "1", "cost": "20.0"},
    "v5e-8": {"chip": "v5e", "chips": "8", "cost": "160.0"},
}
_MM_SERVICE_CLASSES = {"premium": _PREMIUM_YAML, "freemium": _FREEMIUM_YAML}
_FULL_SLO_KNOBS = {"WVA_FAST_DEMAND_PROBE": "5",
                   "WVA_TTFT_PERCENTILE": "0.95",
                   "WVA_DEMAND_HEADROOM": "0.13",
                   "WVA_FAST_PROBE_WINDOW": "15s"}
_CHAT_70B_V5E8 = VariantScenario(
    name="chat-70b", model="llama-70b", sc_key="freemium",
    accelerator="v5e-8", chips_per_replica=8, cfg=_CFG_70B_V5E8,
    ramp=[(300, 120), (300, 300), (300, 480), (300, 600),
          (300, 300), (300, 120)],
    tokens=TOKENS, slo_itl_ms=200.0, slo_ttft_ms=4000.0,
)

# Llama-70B on a v5p-4 slice: fewer, beefier chips (95 GB HBM each),
# bf16 weights fit; faster decode, higher $/hr
_CFG_70B_V5P4 = SliceModelConfig(
    model_name="llama-70b", slice_name="v5p-4",
    alpha=14.0, beta=0.06, gamma=10.0, delta=0.08,
    max_batch_size=48, hbm_gb=380.0, model_size_gb=140.0, kv_mb_per_token=0.8,
)
# Llama-70B TP=16 on a multi-host v5e-16 pod slice (2 hosts x 8 chips):
# wide TP cuts per-token latency, bf16 weights over 256 GB aggregate HBM
_CFG_70B_V5E16 = SliceModelConfig(
    model_name="llama-70b", slice_name="v5e-16",
    alpha=12.0, beta=0.05, gamma=8.0, delta=0.06,
    max_batch_size=64, hbm_gb=256.0, model_size_gb=140.0, kv_mb_per_token=0.8,
)

# ONE definition each for the config-4/5 variants, catalogs, and class
# maps, shared by the mean-based scenario and its -p95 full-SLO
# counterpart: the pair's comparability depends on byte-identical
# configs (same rule as the multi-model pair above)
_MH_ACCELERATORS = {"v5e-16": {"chip": "v5e", "chips": "16",
                               "cost": "320.0"}}
_MH_SERVICE_CLASSES = {"freemium": _FREEMIUM_YAML}
_HF_ACCELERATORS = {
    "v5e-1": {"chip": "v5e", "chips": "1", "cost": "20.0"},
    "v5p-4": {"chip": "v5p", "chips": "4", "cost": "180.0"},
}
_HF_SERVICE_CLASSES = {"premium": _PREMIUM_YAML, "freemium": _FREEMIUM_YAML}
_CHAT_70B_V5E16 = VariantScenario(
    name="chat-70b", model="llama-70b", sc_key="freemium",
    accelerator="v5e-16", chips_per_replica=16, cfg=_CFG_70B_V5E16,
    ramp=[(300, 600), (300, 1500), (300, 3000), (300, 3600),
          (300, 1500), (300, 600)],
    tokens=TOKENS, slo_itl_ms=200.0, slo_ttft_ms=4000.0,
)
_SUM_70B_V5P4 = VariantScenario(
    name="summarize-70b", model="llama-70b", sc_key="freemium",
    accelerator="v5p-4", chips_per_replica=4, cfg=_CFG_70B_V5P4,
    ramp=[(300, 300), (300, 600), (300, 1200), (300, 1500),
          (300, 600), (300, 120)],
    tokens=TOKENS, slo_itl_ms=200.0, slo_ttft_ms=4000.0,
)

SCENARIOS: dict[str, Scenario] = {
    # strict mode: hold the FULL Premium SLO — p95 TTFT (500ms) AND p95
    # ITL (24ms) — through every ramp step. Demand headroom (0.75) plus a
    # 30s cadence absorbs the 80% rate jumps that mean-based sizing lets
    # pile into the TTFT tail. The reference cannot express this at all
    # (no headroom knob, 60s fixed sizing-to-measured-mean).
    "sharegpt-strict-slo": Scenario(
        key="sharegpt-strict-slo",
        title="config-1 ramp, BOTH p95 tails held (headroom 0.75, 30s cadence)",
        accelerators={"v5e-1": {"chip": "v5e", "chips": "1", "cost": "20.0"}},
        service_classes={"premium": _PREMIUM_YAML},
        variants=[_CHAT_8B],
        reconcile_ms=30_000.0,
        operator_extra={"WVA_DEMAND_HEADROOM": "0.75"},
        judge_ttft=True,
    ),
    # strict mode via PRINCIPLED tail sizing instead of blunt headroom:
    # WVA_TTFT_PERCENTILE=0.95 sizes each replica so the 95th percentile
    # of TTFT (occupancy-quantile prefill + Erlang wait tail from the
    # state-dependent solve) meets the SLO — the reference's dead
    # percentile code (allocation.go:117) realized and validated
    "sharegpt-p95-sizing": Scenario(
        key="sharegpt-p95-sizing",
        title="config-1 ramp, BOTH p95 tails held by percentile sizing",
        accelerators={"v5e-1": {"chip": "v5e", "chips": "1", "cost": "20.0"}},
        service_classes={"premium": _PREMIUM_YAML},
        variants=[_CHAT_8B],
        reconcile_ms=30_000.0,
        # percentile sizing holds the steady-state tail; the small
        # headroom absorbs the inter-cycle ramp jumps (vs 0.75 needed
        # when headroom does BOTH jobs alone)
        operator_extra={"WVA_TTFT_PERCENTILE": "0.95",
                        "WVA_DEMAND_HEADROOM": "0.25"},
        judge_ttft=True,
    ),
    # strict mode via REACTION TIME on top of percentile sizing: a 5s
    # demand-breakout probe (reconciler.demand_probe — one PromQL query
    # between cycles, full reconcile only on breakout) catches each ramp
    # step within seconds, so percentile sizing needs only 0.13 headroom
    # for the inter-cycle jumps instead of sharegpt-p95-sizing's 0.25 —
    # the cheapest committed config that holds BOTH tails (2.362
    # chip-hours, p95 TTFT 478 ms). The reference cannot react faster
    # than its fixed interval at any cost.
    "sharegpt-fast-probe": Scenario(
        key="sharegpt-fast-probe",
        title="config-1 ramp, BOTH p95 tails held: p95 sizing + 5s breakout probe",
        accelerators={"v5e-1": {"chip": "v5e", "chips": "1", "cost": "20.0"}},
        service_classes={"premium": _PREMIUM_YAML},
        variants=[_CHAT_8B],
        reconcile_ms=30_000.0,
        # WVA_FAST_DEMAND_PROBE must be SET (not just the sim driving
        # demand_probe()) — it also switches cadence/kicked cycles to
        # sizing on max(1m, probe-window) demand, without which a
        # probe-kicked cycle sizes on the smoothed 1m rate and
        # under-provisions the very step it reacted to (ADVICE r3)
        operator_extra=_FULL_SLO_KNOBS,
        judge_ttft=True,
        fast_probe_ms=5_000.0,
    ),
    # config-1 ramp with heavy-tailed (lognormal, sigma=1) lengths: real
    # ShareGPT histograms, not the uniform mix — stresses KV admission and
    # the TTFT tail far harder at the same mean load
    "sharegpt-lognormal": Scenario(
        key="sharegpt-lognormal",
        title="config-1 ramp, lognormal token lengths (tail stress)",
        accelerators={"v5e-1": {"chip": "v5e", "chips": "1", "cost": "20.0"}},
        service_classes={"premium": _PREMIUM_YAML},
        variants=[
            VariantScenario(
                name=VARIANT, model=MODEL, sc_key="premium",
                accelerator="v5e-1", chips_per_replica=1, cfg=CFG,
                ramp=[list(seg) for seg in RAMP],
                tokens=TokenDistribution(avg_input_tokens=221,
                                         avg_output_tokens=179,
                                         distribution="lognormal"),
                slo_itl_ms=SLO_ITL_MS, slo_ttft_ms=SLO_TTFT_MS,
            ),
        ],
    ),
    # BASELINE config 2: two models, two service classes, one optimizer run
    "multi-model-mix": Scenario(
        key="multi-model-mix",
        title="8B Premium (v5e-1) + 70B Freemium (v5e-8), one optimizer",
        accelerators=_MM_ACCELERATORS,
        service_classes=_MM_SERVICE_CLASSES,
        variants=[_CHAT_8B, _CHAT_70B_V5E8],
    ),
    # multi-model-mix under the FULL-SLO guarantee: percentile sizing +
    # the 5s breakout probe across the whole fleet, one optimizer run.
    # All FOUR tails hold (8B p95 TTFT 475/500ms ITL 7.4/24ms; 70B
    # 1124/4000ms, 22.3/200ms) at 9.861 chip-hours — the mean-based
    # ablation above is 24% cheaper (7.43) but blows the 70B TTFT tail
    # (5119/4000ms). Fleet-wide per-variant probe envelopes kick early
    # cycles independently per model (21 kicks on this ramp).
    "multi-model-p95": Scenario(
        key="multi-model-p95",
        title="8B Premium + 70B Freemium, ALL p95 tails held (p95 sizing + probe)",
        accelerators=_MM_ACCELERATORS,
        service_classes=_MM_SERVICE_CLASSES,
        variants=[_CHAT_8B, _CHAT_70B_V5E8],
        operator_extra=_FULL_SLO_KNOBS,
        judge_ttft=True,
        fast_probe_ms=5_000.0,
    ),
    # BASELINE config 4: multi-host v5e-16 pod slices (TP=16 Llama-70B).
    # A replica is an ATOMIC 16-chip unit — scale-out steps the chip count
    # by whole pod slices, exactly the granularity GKE multi-host TPU
    # node pools scale at.
    "multihost-70b": Scenario(
        key="multihost-70b",
        title="Llama-70B TP=16 on multi-host v5e-16 pod slices",
        accelerators=_MH_ACCELERATORS,
        service_classes=_MH_SERVICE_CLASSES,
        variants=[_CHAT_70B_V5E16],
    ),
    # config 4 under the FULL-SLO guarantee: percentile sizing + the 5s
    # breakout probe on ATOMIC 16-chip pod slices — the hardest case for
    # tail sizing, because every probe kick or headroom increment costs a
    # whole v5e-16 (the mean-based scenario above stays as the labeled
    # ablation)
    "multihost-70b-p95": Scenario(
        key="multihost-70b-p95",
        title="Llama-70B TP=16 multi-host, BOTH p95 tails held (p95 sizing + probe)",
        accelerators=_MH_ACCELERATORS,
        service_classes=_MH_SERVICE_CLASSES,
        variants=[_CHAT_70B_V5E16],
        operator_extra=_FULL_SLO_KNOBS,
        judge_ttft=True,
        fast_probe_ms=5_000.0,
    ),
    # BASELINE config 5: heterogeneous chip generations in one fleet
    "hetero-fleet": Scenario(
        key="hetero-fleet",
        title="v5e + v5p fleet under load-ramp SLO stress",
        accelerators=_HF_ACCELERATORS,
        service_classes=_HF_SERVICE_CLASSES,
        variants=[_CHAT_8B, _SUM_70B_V5P4],
    ),
    # CAPSTONE (round 5, beyond any single BASELINE config): ONE
    # optimizer, ONE operator ConfigMap, FOUR variants spanning every
    # slice topology the framework supports — single-chip v5e-1,
    # 8-chip TP v5e-8, ATOMIC multi-host v5e-16, and a v5p-4
    # generation — all under the full-SLO guarantee (percentile sizing
    # + 5s breakout probe per variant): EIGHT p95 tails held in one
    # reconcile loop. The reference cannot express any part of this
    # (mean-only sizing, fixed cadence, no slice topology model).
    # Distinct model ids per variant: the sim Prometheus keys series by
    # model, and these are four separate deployments with their own
    # fitted profiles.
    "whole-fleet-p95": Scenario(
        key="whole-fleet-p95",
        title="4 slice topologies, one optimizer, ALL EIGHT p95 tails held",
        accelerators={
            "v5e-1": {"chip": "v5e", "chips": "1", "cost": "20.0"},
            "v5e-8": {"chip": "v5e", "chips": "8", "cost": "160.0"},
            "v5e-16": {"chip": "v5e", "chips": "16", "cost": "320.0"},
            "v5p-4": {"chip": "v5p", "chips": "4", "cost": "180.0"},
        },
        service_classes={
            "premium": _PREMIUM_YAML,
            "freemium": (
                "name: Freemium\npriority: 10\ndata:\n"
                "  - model: llama-70b-chat\n    slo-tpot: 200\n"
                "    slo-ttft: 4000\n"
                "  - model: llama-70b-long\n    slo-tpot: 200\n"
                "    slo-ttft: 4000\n"
                "  - model: llama-70b-sum\n    slo-tpot: 200\n"
                "    slo-ttft: 4000\n"
            ),
        },
        # shared per-config variant definitions under distinct model ids
        # (the sim Prometheus keys series by model; these are four
        # separate deployments with the same fitted physics)
        variants=[
            _CHAT_8B,
            _dc_replace(_CHAT_70B_V5E8, name="chat-70b",
                        model="llama-70b-chat",
                        cfg=_dc_replace(_CFG_70B_V5E8,
                                        model_name="llama-70b-chat")),
            _dc_replace(_CHAT_70B_V5E16, name="long-70b",
                        model="llama-70b-long",
                        cfg=_dc_replace(_CFG_70B_V5E16,
                                        model_name="llama-70b-long")),
            _dc_replace(_SUM_70B_V5P4, name="sum-70b",
                        model="llama-70b-sum",
                        cfg=_dc_replace(_CFG_70B_V5P4,
                                        model_name="llama-70b-sum")),
        ],
        operator_extra=_FULL_SLO_KNOBS,
        judge_ttft=True,
        fast_probe_ms=5_000.0,
    ),
    # config 5 under the FULL-SLO guarantee: all four tails (8B Premium
    # TTFT+ITL, 70B Freemium TTFT+ITL) held across heterogeneous chip
    # generations by percentile sizing + the breakout probe, one
    # optimizer run (mean-based scenario above = the labeled ablation)
    "hetero-fleet-p95": Scenario(
        key="hetero-fleet-p95",
        title="v5e + v5p fleet, ALL p95 tails held (p95 sizing + probe)",
        accelerators=_HF_ACCELERATORS,
        service_classes=_HF_SERVICE_CLASSES,
        variants=[_CHAT_8B, _SUM_70B_V5P4],
        operator_extra=_FULL_SLO_KNOBS,
        judge_ttft=True,
        fast_probe_ms=5_000.0,
    ),
}


def run_fleet_scale(sizes=(64, 256, 512), cycles: int = 30, *,
                    device=None, dtype=None) -> dict:
    """Controller scalability: steady-state reconcile wall time at fleet
    sizes of 64/256/512 VariantAutoscalings, with the cycle on `device`.

    The WHOLE fleet is one sizing-group decision per cycle
    (models/system.py); the residual O(N) is the per-VA
    collect/translate/publish path (one status write per VA).

    Measurement: in-memory kube + fake Prometheus (zero network — the
    collector still issues its aggregate queries per cycle and the full
    collect->analyze->optimize->publish path runs), engine backend
    selected for the device (`engine_backend(device)`: the CUDA kernels
    on the card), one warm cycle to pay the build, then `cycles` timed
    cycles per size, each synchronized with the card.
    """
    place = where(device, dtype)
    from workload_variant_autoscaler_tpu_torch.collector import (
        FakePromAPI,
        arrival_rate_query,
        avg_generation_tokens_query,
        avg_itl_query,
        avg_prompt_tokens_query,
        avg_ttft_query,
        true_arrival_rate_query,
    )

    def build(n: int):
        kube = InMemoryKube()
        kube.put_configmap(ConfigMap(CONFIG_MAP_NAME, CONFIG_MAP_NAMESPACE,
                                     {"GLOBAL_OPT_INTERVAL": "60s"}))
        kube.put_configmap(ConfigMap(
            ACCELERATOR_CM_NAME, CONFIG_MAP_NAMESPACE,
            {
                "v5e-1": json.dumps({"chip": "v5e", "chips": "1",
                                     "cost": "20.0"}),
                "v5e-4": json.dumps({"chip": "v5e", "chips": "4",
                                     "cost": "80.0"}),
            },
        ))
        kube.put_configmap(ConfigMap(
            SERVICE_CLASS_CM_NAME, CONFIG_MAP_NAMESPACE,
            {"premium": (
                "name: Premium\npriority: 1\ndata:\n"
                f"  - model: {MODEL}\n    slo-tpot: {SLO_ITL_MS:.0f}\n"
                f"    slo-ttft: {SLO_TTFT_MS:.0f}\n"
            )},
        ))
        for i in range(n):
            name = f"chat-{i}"
            kube.put_deployment(Deployment(name=name, namespace=NS,
                                           spec_replicas=1,
                                           status_replicas=1))
            kube.put_variant_autoscaling(crd.VariantAutoscaling(
                metadata=crd.ObjectMeta(
                    name=name, namespace=NS,
                    labels={crd.ACCELERATOR_LABEL: "v5e-1"}),
                spec=crd.VariantAutoscalingSpec(
                    model_id=MODEL,
                    slo_class_ref=crd.ConfigMapKeyRef(
                        name=SERVICE_CLASS_CM_NAME, key="premium"),
                    model_profile=crd.ModelProfile(accelerators=[
                        crd.AcceleratorProfile(
                            acc="v5e-1", acc_count=1,
                            perf_parms=crd.PerfParms(
                                decode_parms={"alpha": "6.973",
                                              "beta": "0.027"},
                                prefill_parms={"gamma": "5.2",
                                               "delta": "0.1"},
                            ),
                            max_batch_size=64,
                        ),
                        crd.AcceleratorProfile(
                            acc="v5e-4", acc_count=1,
                            perf_parms=crd.PerfParms(
                                decode_parms={"alpha": "3.2",
                                              "beta": "0.012"},
                                prefill_parms={"gamma": "2.4",
                                               "delta": "0.04"},
                            ),
                            max_batch_size=192,
                        ),
                    ]),
                ),
            ))
        prom = FakePromAPI()
        prom.set_result(true_arrival_rate_query(MODEL, NS), 30.0)
        prom.set_result(arrival_rate_query(MODEL, NS), 30.0)
        prom.set_result(avg_prompt_tokens_query(MODEL, NS), 128.0)
        prom.set_result(avg_generation_tokens_query(MODEL, NS), 128.0)
        prom.set_result(avg_ttft_query(MODEL, NS), 0.2)
        prom.set_result(avg_itl_query(MODEL, NS), 0.012)
        return Reconciler(kube=kube, prom=prom, emitter=MetricsEmitter(),
                          sleep=lambda _s: None, device=device, dtype=dtype)

    fleets = {}
    for n in sizes:
        rec = build(n)
        first = rec.reconcile()           # build/first-launch warmup cycle
        if len(first.processed) != n:
            raise RuntimeError(
                f"fleet-scale {n}: {len(first.processed)} processed, "
                f"skipped={first.skipped}")
        log = CycleLog(rec)
        for _ in range(cycles):
            log.reconcile()
        walls = sorted(log.walls)
        p50 = walls[len(walls) // 2]
        p95 = walls[min(int(len(walls) * 0.95), len(walls) - 1)]
        fleets[str(n)] = {
            "p50_ms": round(p50, 1), "p95_ms": round(p95, 1),
            "max_ms": round(walls[-1], 1), "cycles": cycles,
            # the scaling story in one number: host work per VA per cycle
            "p50_ms_per_va": round(p50 / n, 3),
            "kernel_launches": log.launches(),
        }

    lo, hi = str(sizes[0]), str(sizes[-1])
    return {
        "metric": "reconcile_wall_ms_p95",
        "value": fleets[hi]["p95_ms"],
        "unit": "ms",
        # sublinearity: per-VA cycle cost at the largest fleet vs the
        # smallest (>1 = the batched design amortizes as fleets grow; a
        # per-VA loop would hold this flat at ~1)
        "vs_baseline": round(fleets[lo]["p50_ms_per_va"]
                             / fleets[hi]["p50_ms_per_va"], 2),
        "slo_held": True,
        "scenario": "fleet-scale",
        **place,
        "fleets": fleets,
    }


def run_solve_churn(n: int = 512, cycles: int = 24,
                    churn_frac: float = 0.01,
                    seed: int = 20260804, *, device=None,
                    dtype=None) -> dict:
    """Steady-state incremental solve: a 512-variant fleet where ~1% of
    variants change load per cycle, reconciled with
    `WVA_INCREMENTAL_SOLVE=on` vs `off`, the cycle on `device`.

    In steady state the full path re-solves every candidate lane of
    every variant every cycle; the incremental engine re-solves only the
    signature-changed sub-batch and reuses cached allocations for the
    rest (solver/incremental.py). Measured here per mode, identical
    seeded churn schedule for both:

      - kernel lanes solved per cycle (`inferno_solve_lanes{state}`) —
        the O(fleet) -> O(changed) claim; `vs_baseline` is the ratio;
      - analyze+optimize stage wall per cycle (the stages the engine
        touches) and full cycle wall;
      - B1 launches per cycle.

    Each variant is its own model (independent Prometheus series), so
    per-variant churn is real. Loads stay strictly positive and the
    churn factor (x1.35 / x0.7) always crosses a WVA_SOLVE_EPSILON=0.02
    bucket, so "changed" truly means re-solved.
    """
    place = where(device, dtype)
    import random as _random

    from workload_variant_autoscaler_tpu_torch.collector import (
        FakePromAPI,
        arrival_rate_query,
        availability_query,
        avg_generation_tokens_query,
        avg_itl_query,
        avg_prompt_tokens_query,
        avg_ttft_query,
        true_arrival_rate_query,
    )
    from workload_variant_autoscaler_tpu_torch.collector.collector import (
        VLLM_FAMILY,
        fleet_arrival_rate_query,
        fleet_availability_query,
        fleet_avg_generation_tokens_query,
        fleet_avg_itl_query,
        fleet_avg_prompt_tokens_query,
        fleet_avg_ttft_query,
        fleet_true_arrival_rate_query,
    )
    from workload_variant_autoscaler_tpu_torch.metrics import (
        INFERNO_RECONCILE_STAGE_DURATION_MSEC,
        STAGE_ANALYZE,
        STAGE_OPTIMIZE,
        STATE_SKIPPED,
    )

    def model_name(i: int) -> str:
        return f"llama-8b-m{i}"

    def seed_prom(store: FakePromAPI, loads: dict[int, float]) -> None:
        """Rewrite every series from the loads dict (grouped fleet
        vectors AND the per-variant repair queries, so both collection
        paths see the same fleet)."""
        fam = VLLM_FAMILY
        grouped = (
            fleet_true_arrival_rate_query(fam),
            fleet_arrival_rate_query(fam),
            fleet_avg_prompt_tokens_query(fam),
            fleet_avg_generation_tokens_query(fam),
            fleet_avg_ttft_query(fam),
            fleet_avg_itl_query(fam),
            fleet_availability_query(fam),
        )
        for q in grouped:
            store.set_empty(q)
        for i, rps in loads.items():
            m = model_name(i)
            labels = {"model_name": m, "namespace": NS}
            per_model = {
                fleet_true_arrival_rate_query(fam): rps,
                fleet_arrival_rate_query(fam): rps,
                fleet_avg_prompt_tokens_query(fam): 128.0,
                fleet_avg_generation_tokens_query(fam): 128.0,
                fleet_avg_ttft_query(fam): 0.2,
                fleet_avg_itl_query(fam): 0.012,
                fleet_availability_query(fam): 1.0,
            }
            for q, v in per_model.items():
                store.add_result(q, v, labels=labels)
            for q, v in (
                (availability_query(m, NS, fam), 1.0),
                (true_arrival_rate_query(m, NS, fam), rps),
                (arrival_rate_query(m, NS, fam), rps),
                (avg_prompt_tokens_query(m, NS, fam), 128.0),
                (avg_generation_tokens_query(m, NS, fam), 128.0),
                (avg_ttft_query(m, NS, fam), 0.2),
                (avg_itl_query(m, NS, fam), 0.012),
            ):
                store.set_result(q, v, labels=labels)

    def build():
        kube = InMemoryKube()
        kube.put_configmap(ConfigMap(CONFIG_MAP_NAME, CONFIG_MAP_NAMESPACE,
                                     {"GLOBAL_OPT_INTERVAL": "60s",
                                      # measuring the solve, not 512
                                      # drift warnings/cycle of noise
                                      "WVA_DRIFT_TOLERANCE": "0"}))
        kube.put_configmap(ConfigMap(
            ACCELERATOR_CM_NAME, CONFIG_MAP_NAMESPACE,
            {"v5e-1": json.dumps({"chip": "v5e", "chips": "1",
                                  "cost": "20.0"})},
        ))
        slos = "\n".join(
            f"  - model: {model_name(i)}\n    slo-tpot: 24\n"
            f"    slo-ttft: 500" for i in range(n))
        kube.put_configmap(ConfigMap(
            SERVICE_CLASS_CM_NAME, CONFIG_MAP_NAMESPACE,
            {"premium": f"name: Premium\npriority: 1\ndata:\n{slos}\n"},
        ))
        for i in range(n):
            name = f"chat-{i}"
            kube.put_deployment(Deployment(name=name, namespace=NS,
                                           spec_replicas=1,
                                           status_replicas=1))
            kube.put_variant_autoscaling(crd.VariantAutoscaling(
                metadata=crd.ObjectMeta(
                    name=name, namespace=NS,
                    labels={crd.ACCELERATOR_LABEL: "v5e-1"}),
                spec=crd.VariantAutoscalingSpec(
                    model_id=model_name(i),
                    slo_class_ref=crd.ConfigMapKeyRef(
                        name=SERVICE_CLASS_CM_NAME, key="premium"),
                    model_profile=crd.ModelProfile(accelerators=[
                        crd.AcceleratorProfile(
                            acc="v5e-1", acc_count=1,
                            perf_parms=crd.PerfParms(
                                decode_parms={"alpha": "6.973",
                                              "beta": "0.027"},
                                prefill_parms={"gamma": "5.2",
                                               "delta": "0.1"}),
                            max_batch_size=64),
                    ]),
                )))
        store = FakePromAPI()
        emitter = MetricsEmitter()
        rec = Reconciler(kube=kube, prom=store, emitter=emitter,
                         sleep=lambda _s: None, device=device, dtype=dtype)
        return store, emitter, rec

    per_cycle_churn = max(int(round(n * churn_frac)), 1)

    def run_mode(mode: str) -> tuple[dict, Reconciler]:
        os.environ["WVA_INCREMENTAL_SOLVE"] = mode
        try:
            rng = _random.Random(seed)   # identical schedule per mode
            loads = {i: 10.0 + (i % 47) for i in range(n)}
            store, emitter, rec = build()
            seed_prom(store, loads)
            # warm-up: first (full) solve + the build, plus one steady
            # cycle so the warm-start seed is committed
            for _ in range(2):
                result = rec.reconcile()
                if len(result.processed) != n:
                    raise RuntimeError(
                        f"solve-churn: {len(result.processed)} processed, "
                        f"skipped={result.skipped}")
            log = CycleLog(rec)
            stage_walls, solved, skipped = [], [], []
            for _c in range(cycles):
                for i in rng.sample(range(n), per_cycle_churn):
                    loads[i] *= rng.choice((1.35, 0.7))
                seed_prom(store, loads)
                log.reconcile()
                stage_walls.append(sum(
                    emitter.value(INFERNO_RECONCILE_STAGE_DURATION_MSEC,
                                  stage=s) or 0.0
                    for s in (STAGE_ANALYZE, STAGE_OPTIMIZE)))
                solved.append(emitter.value(INFERNO_SOLVE_LANES,
                                            state=STATE_SOLVED) or 0.0)
                skipped.append(emitter.value(INFERNO_SOLVE_LANES,
                                             state=STATE_SKIPPED) or 0.0)
            walls = sorted(log.walls)
            stage_walls.sort()
            return {
                "lanes_solved_per_cycle": round(sum(solved) / cycles, 1),
                "lanes_skipped_per_cycle": round(sum(skipped) / cycles, 1),
                "cycle_wall_ms_p50": round(walls[len(walls) // 2], 1),
                "cycle_wall_ms_max": round(walls[-1], 1),
                "analyze_optimize_ms_p50": round(
                    stage_walls[len(stage_walls) // 2], 2),
                "cycles": cycles,
                "kernel_launches": log.launches(),
            }, rec
        finally:
            os.environ.pop("WVA_INCREMENTAL_SOLVE", None)

    incremental, rec = run_mode("on")
    full, _ = run_mode("off")
    lanes_ratio = (full["lanes_solved_per_cycle"]
                   / max(incremental["lanes_solved_per_cycle"], 1e-9))
    return {
        "metric": "steady_state_lanes_solved_per_cycle",
        "value": incremental["lanes_solved_per_cycle"],
        "unit": "lanes/cycle",
        # the headline: how many fewer kernel lanes a steady-state
        # cycle solves with the incremental engine on
        "vs_baseline": round(lanes_ratio, 1),
        "slo_held": True,
        "scenario": "solve-churn",
        "n_variants": n,
        "churn_per_cycle": per_cycle_churn,
        **place,
        "wall_speedup_p50": round(full["cycle_wall_ms_p50"]
                                  / incremental["cycle_wall_ms_p50"], 2),
        "analyze_optimize_speedup_p50": round(
            full["analyze_optimize_ms_p50"]
            / max(incremental["analyze_optimize_ms_p50"], 1e-9), 2),
        "incremental": incremental,
        "full": full,
    }


KEYS = ("sharegpt-ramp", "fleet-scale", "solve-churn")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] and args[0] in ("-h", "--help", "list"):
        print("usage: bench_torch_loop.py [key] [--device cuda|cpu] "
              "[--dtype float32|float64]\nscenarios: sharegpt-ramp "
              "(default), fleet-scale, solve-churn, " + ", ".join(SCENARIOS),
              file=sys.stderr)
        return 0
    parser = argparse.ArgumentParser(prog="bench_torch_loop.py",
                                     add_help=False)
    parser.add_argument("key", nargs="?", default="sharegpt-ramp")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="float32", choices=DTYPES)
    opts = parser.parse_args(args)
    key = opts.key
    if key not in KEYS and key not in SCENARIOS:
        print(f"unknown scenario {key!r}; try: sharegpt-ramp, fleet-scale, "
              "solve-churn, " + ", ".join(SCENARIOS), file=sys.stderr)
        return 2
    on = {"device": resolve_device(opts.device),
          "dtype": resolve_dtype(DTYPES[opts.dtype])}
    if key == "sharegpt-ramp":
        result = run(**on)
    elif key == "fleet-scale":
        result = run_fleet_scale(**on)
    elif key == "solve-churn":
        result = run_solve_churn(**on)
    else:
        result = run_scenario(SCENARIOS[key], **on)
    print(json.dumps(result))
    return 0 if result["slo_held"] else 1


if __name__ == "__main__":
    sys.exit(main())
