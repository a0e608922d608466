"""bench_torch_collect: fleet-scale collection, with the port's reconcile
cycle on the card.

The counterpart of bench_collect.py's fleet leg. It drives the same
512-variant fleet (8 models, 64 variants each; the Premium class,
slo-tpot 24 and slo-ttft 500, so every sizing runs the mean form of the
bisection kernel, B1) through full reconcile cycles against a
latency-injecting Prometheus stand-in (every query pays a fixed 2 ms
round-trip, the dominant term of real in-cluster collection): ~8 grouped
queries per cycle, demuxed per variant, and one Deployment LIST. The
port has no per-variant collection path to compare against.

One warm-up cycle (the kernel library's build and first launch) comes
before the timed cycle, so the time is steady state. The
cluster admits objects without the CRD schema
(`InMemoryKube(validate_schema=False)`), as bench_collect.py's does.

    python3 bench_torch_collect.py [--device cuda|cpu] [--out PATH]

The Reconciler runs on `cuda` unless `--device cpu` is asked, in float32;
without CUDA the run raises, it never drops to the CPU on its own. Prints
ONE JSON line: bench_collect.py's keys of the fleet leg, and the keys
that say where the cycle ran (bench_torch_loop.where: the card's name and
power limit, the dtype, the engine backend) with the kernel_launches (B1/B2
launches and sizing readbacks per reconcile cycle, from the port's
counters). It writes the line to PATH only when `--out` is given, and
never to a BENCH_*.json (those are the JAX package's CPU records) or under
tests/fixtures/.

This module also holds what the other bench_torch_* ports of the cycle
and event-path benchmarks share: `knobs`, `cycle_launches`,
`launch_summary`, `parse_args`, `refuse_output` and `emit`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

import torch

from bench_torch_loop import where
from workload_variant_autoscaler_tpu_torch.collector import (
    FakePromAPI,
    VLLM_FAMILY,
    arrival_rate_query,
    availability_query,
    avg_generation_tokens_query,
    avg_itl_query,
    avg_prompt_tokens_query,
    avg_ttft_query,
    fleet_arrival_rate_query,
    fleet_availability_query,
    fleet_avg_generation_tokens_query,
    fleet_avg_itl_query,
    fleet_avg_prompt_tokens_query,
    fleet_avg_ttft_query,
    fleet_true_arrival_rate_query,
    true_arrival_rate_query,
)
from workload_variant_autoscaler_tpu_torch.controller import (
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
from workload_variant_autoscaler_tpu_torch.metrics import MetricsEmitter
from workload_variant_autoscaler_tpu_torch.obs.profile import DEVICE_AUDIT
from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as _bk

N_VARIANTS = 512
N_MODELS = 8          # variants share models 64:1, like real fleets
NS = "default"
LATENCY_S = 0.002     # per-query round-trip of the latency model


@contextlib.contextmanager
def knobs(**values: str):
    """Set environment knobs of the port for the block's duration and
    restore what was there (the JAX scripts set theirs when imported;
    these ports share a process with each other and with the tests)."""
    saved = {name: os.environ.get(name) for name in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def counters() -> tuple[int, int, int]:
    """(B1 launches, B2 launches, d2h readbacks) so far in this process."""
    return (_bk.launches["mean"], _bk.launches["tail"],
            DEVICE_AUDIT.snapshot()["transfers"].get("d2h", 0))


@contextlib.contextmanager
def cycle_launches():
    """For the block's duration, one row per Reconciler.reconcile call
    (polled cycles, a streaming core's micro-cycles, a twin's cycles, in
    any thread): its B1 and B2 launches and its sizing readbacks (the
    one d2h copy of each sizing group, utils/device.readback), read as
    differences of the port's process-wide counters around the call.
    Launches count on the card only; a readback counts on either device,
    so a cycle "sized" when it read one back."""
    rows: list[tuple[int, int, int]] = []
    orig = Reconciler.reconcile

    def counted(self, *args, **kwargs):
        before = counters()
        try:
            return orig(self, *args, **kwargs)
        finally:
            rows.append(tuple(a - b for a, b in zip(counters(), before)))

    Reconciler.reconcile = counted
    try:
        yield rows
    finally:
        Reconciler.reconcile = orig


def launch_summary(rows) -> dict:
    """B1/B2 launches per reconcile call of `cycle_launches` rows; on the
    card every call that sizes a mean-SLO group launches B1."""
    n = len(rows)
    sizing = [r for r in rows if r[2] > 0]
    b1 = sum(r[0] for r in rows)
    b2 = sum(r[1] for r in rows)
    return {
        "cycles": n,
        "sizing_cycles": len(sizing),
        "B1": b1,
        "B2": b2,
        "B1_per_cycle": b1 / n if n else 0.0,
        "B2_per_cycle": b2 / n if n else 0.0,
        "sizing_cycles_with_B1": sum(1 for r in sizing if r[0] > 0),
        "d2h_per_sizing_cycle": sorted({r[2] for r in sizing}),
    }


def parse_args(prog: str, argv, smoke: bool = False):
    """The shared CLI: `--device` (default cuda; raises without CUDA),
    `--out PATH` (refused up front by `refuse_output`) and, where the
    JAX script has one, `--smoke`."""
    parser = argparse.ArgumentParser(prog=prog)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    if smoke:
        parser.add_argument("--smoke", action="store_true")
    opts = parser.parse_args(argv)
    refuse_output(parser, opts.out)
    return opts


def refuse_output(parser, path) -> None:
    """Exit 2 (`parser.error`) when `path` names a BENCH_*.json (the JAX
    package's records) or lies under tests/fixtures/ (its fixtures)."""
    if not path:
        return
    parts = Path(path).resolve().parts
    if parts[-1].startswith("BENCH_") and parts[-1].endswith(".json"):
        parser.error(f"{path}: the BENCH_*.json records are the JAX "
                     "package's and are never overwritten")
    if any(parts[i:i + 2] == ("tests", "fixtures")
           for i in range(len(parts) - 1)):
        parser.error(f"{path}: tests/fixtures/ holds the JAX package's "
                     "fixtures and is never written")


def emit(out: dict, path: str | None, fails=(), budgets=()) -> int:
    """Print the one JSON line, write it to `path` when given; the exit
    code: 1, with the failures on stderr, when an invariant failed or a
    wall-clock budget was not met."""
    print(json.dumps(out), flush=True)
    if path:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1, sort_keys=True)
            f.write("\n")
    if fails or not all(b["met"] for b in budgets):
        print(json.dumps({"failures": list(fails),
                          "budgets": list(budgets)}), file=sys.stderr)
        return 1
    return 0


class LatencyPromAPI:
    """Labeled query store behind a fixed per-query latency."""

    def __init__(self, store: FakePromAPI, latency_s: float = LATENCY_S):
        self.store = store
        self.latency_s = latency_s
        self.count = 0

    def query(self, promql: str):
        self.count += 1
        if self.latency_s > 0:
            time.sleep(self.latency_s)
        return self.store.query(promql)


class CountingKube(InMemoryKube):
    def __init__(self):
        super().__init__(validate_schema=False)
        self.verb_counts: dict[str, int] = {}

    def _count(self, what: str) -> None:
        self.verb_counts[what] = self.verb_counts.get(what, 0) + 1

    def get_deployment(self, name, namespace):
        self._count("get:Deployment")
        return super().get_deployment(name, namespace)

    def list_deployments(self, namespace=None):
        self._count("list:Deployment")
        return super().list_deployments(namespace)

    def get_variant_autoscaling(self, name, namespace):
        self._count("get:VariantAutoscaling")
        return super().get_variant_autoscaling(name, namespace)

    def list_variant_autoscalings(self):
        self._count("list:VariantAutoscaling")
        return super().list_variant_autoscalings()


def model_name(i: int) -> str:
    return f"llama-8b-m{i % N_MODELS}"


def seed_prom(store: FakePromAPI, rps: float = 30.0) -> None:
    fam = VLLM_FAMILY
    grouped = {
        fleet_true_arrival_rate_query(fam): rps,
        fleet_arrival_rate_query(fam): rps,
        fleet_avg_prompt_tokens_query(fam): 128.0,
        fleet_avg_generation_tokens_query(fam): 128.0,
        fleet_avg_ttft_query(fam): 0.2,
        fleet_avg_itl_query(fam): 0.012,
        fleet_availability_query(fam): 1.0,
    }
    for m_i in range(N_MODELS):
        m = model_name(m_i)
        labels = {"model_name": m, "namespace": NS}
        for q, v in grouped.items():
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


def build_cluster(n_variants: int = N_VARIANTS, *, device=None, dtype=None,
                  ) -> tuple[CountingKube, LatencyPromAPI, Reconciler]:
    """The bench fleet: n_variants VAs sharing N_MODELS models, one
    fixed-latency Prometheus, one in-memory kube, the Reconciler on
    `device` in `dtype`. bench_torch_profile.py and bench_torch_fuse.py
    reuse it."""
    kube = CountingKube()
    kube.put_configmap(ConfigMap(CONFIG_MAP_NAME, CONFIG_MAP_NAMESPACE,
                                 {"GLOBAL_OPT_INTERVAL": "60s",
                                  # measuring collection, not the drift
                                  # watchdog (512 warnings/cycle of noise)
                                  "WVA_DRIFT_TOLERANCE": "0"}))
    kube.put_configmap(ConfigMap(
        ACCELERATOR_CM_NAME, CONFIG_MAP_NAMESPACE,
        {"v5e-1": json.dumps({"chip": "v5e", "chips": "1", "cost": "20.0"})},
    ))
    slos = "\n".join(
        f"  - model: {model_name(i)}\n    slo-tpot: 24\n    slo-ttft: 500"
        for i in range(N_MODELS))
    kube.put_configmap(ConfigMap(
        SERVICE_CLASS_CM_NAME, CONFIG_MAP_NAMESPACE,
        {"premium": f"name: Premium\npriority: 1\ndata:\n{slos}\n"},
    ))
    for i in range(n_variants):
        name = f"chat-{i}"
        kube.put_deployment(Deployment(name=name, namespace=NS,
                                       spec_replicas=1, status_replicas=1))
        kube.put_variant_autoscaling(crd.VariantAutoscaling(
            metadata=crd.ObjectMeta(name=name, namespace=NS,
                                    labels={crd.ACCELERATOR_LABEL: "v5e-1"}),
            spec=crd.VariantAutoscalingSpec(
                model_id=model_name(i),
                slo_class_ref=crd.ConfigMapKeyRef(
                    name=SERVICE_CLASS_CM_NAME, key="premium"),
                model_profile=crd.ModelProfile(accelerators=[
                    crd.AcceleratorProfile(
                        acc="v5e-1", acc_count=1,
                        perf_parms=crd.PerfParms(
                            decode_parms={"alpha": "6.973", "beta": "0.027"},
                            prefill_parms={"gamma": "5.2", "delta": "0.1"},
                        ),
                        max_batch_size=64,
                    ),
                ]),
            ),
        ))
    store = FakePromAPI()
    seed_prom(store)
    prom = LatencyPromAPI(store)
    rec = Reconciler(kube=kube, prom=prom, emitter=MetricsEmitter(),
                     sleep=lambda _s: None, device=device, dtype=dtype)
    return kube, prom, rec


def timed_cycle(n_variants: int = N_VARIANTS, *, device=None,
                dtype=None) -> dict:
    """A warm-up cycle, then the timed one (host clock, synchronized
    with the card)."""
    with cycle_launches() as rows:
        kube, prom, rec = build_cluster(n_variants, device=device,
                                        dtype=dtype)
        rec.reconcile()             # warm-up: build, launch, first publish
        prom.count = 0
        kube.verb_counts.clear()
        t0 = time.perf_counter()
        result = rec.reconcile()
        if rec.device.type == "cuda":
            torch.cuda.synchronize(rec.device)
        wall_s = time.perf_counter() - t0
    if len(result.processed) != n_variants:
        raise RuntimeError(f"collect: {len(result.processed)} of "
                           f"{n_variants} processed, skipped={result.skipped}")
    return {
        "wall_s": round(wall_s, 3),
        "prom_queries": prom.count,
        "kube_lists": sum(v for k, v in kube.verb_counts.items()
                          if k.startswith("list:")),
        "kube_gets": sum(v for k, v in kube.verb_counts.items()
                         if k.startswith("get:")),
        "kernel_launches": launch_summary(rows),
    }


def run(n_variants: int = N_VARIANTS, *, device=None, dtype=None) -> dict:
    place = where(device, dtype)
    fleet = timed_cycle(n_variants, device=device, dtype=dtype)
    return {
        "metric": "reconcile_cycle_wall_s",
        "bench": "collect",
        "variants": n_variants,
        "models": N_MODELS,
        "latency_ms": LATENCY_S * 1000.0,
        "value": fleet["wall_s"],
        "unit": "s/cycle",
        **place,
        "fleet": fleet,
        "fleet_queries_per_cycle": fleet["prom_queries"],
    }


def main(argv=None) -> int:
    opts = parse_args("bench_torch_collect.py", argv)
    return emit(run(device=opts.device), opts.out)


if __name__ == "__main__":
    raise SystemExit(main())
