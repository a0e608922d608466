"""bench_torch_fuse: the fused decision against the staged pipeline, with
the port's cycle on the card.

The counterpart of bench_fuse.py, on bench_torch_collect.py's
512-variant fleet shape:

- one warm-up cycle, then three profiled whole-fleet load-shift cycles
  per mode (staged `WVA_FUSED_SOLVE=off`: `ops/fused.size_stage` and a
  readback after each device step; fused `on`: `decide_batch`, one
  packed readback per sizing group), the fastest by `stage:analyze`
  exclusive ms from the attribution ledger (`analyze_ms`: with the fused
  path's pack and decision spans folded in), with its transfer counts and
  retraces (always empty: PyTorch runs eagerly; the check is kept);
- a 10-cycle steady load-shift run on the fused path: exactly one bulk
  d2h per sizing group per cycle, every cycle;
- the fused analyze + optimize wall at 4096 servers on a System driven
  directly (`System.calculate` with the device's backend, then
  `Manager.optimize`; none of the collection or publish residual), with
  7 shared load levels and with a load per server.

Every sizing runs B1 on the card (mean-SLO fleets, the Premium class);
the staged path sizes through `size_stage(backend="kernel")` there.

    python3 bench_torch_fuse.py [--device cuda|cpu] [--smoke] [--out PATH]

The budget is PERF.md's: `fleet_4096.analyze_optimize_ms_p50` < 100 ms.
bench_fuse.py's `r09_*`/`vs_r09` keys compare against a CPU record of
the JAX package and are not carried over; `vs_staged_rerun` comes from
the same run on the same device. `--smoke` (64 variants) checks the
invariants only. Runs in float32 on `cuda` unless `--device cpu` is
asked; raises without CUDA. WVA_NATIVE_KERNEL=false holds for each
function's duration (bench_fuse.py pins it when imported). Prints ONE
JSON line with bench_torch_loop.where's keys and kernel_launches; exits
1 when an invariant or the budget fails.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from bench_torch_collect import (
    N_VARIANTS,
    build_cluster,
    counters,
    cycle_launches,
    emit,
    knobs,
    launch_summary,
    parse_args,
    seed_prom,
)
from bench_torch_loop import where
from workload_variant_autoscaler_tpu_torch.controller.translate import (
    engine_backend,
)
from workload_variant_autoscaler_tpu_torch.models import System, make_slice
from workload_variant_autoscaler_tpu_torch.models.spec import (
    AllocationData,
    ModelSliceProfile,
    ModelTarget,
    OptimizerSpec,
    ServerLoadSpec,
    ServerSpec,
    ServiceClassSpec,
    SystemSpec,
)
from workload_variant_autoscaler_tpu_torch.solver import Manager, Optimizer

SMOKE_VARIANTS = 64
STEADY_CYCLES = 10
FLEET_SERVERS = 4096
ANALYZE_BUDGET_MS = 100.0
# the fused/staged split exists on the device's own backends (bench_fuse.py
# pins its XLA path the same way)
NATIVE_OFF = {"WVA_NATIVE_KERNEL": "false"}


def analyze_ms(rec: dict) -> float:
    """A ProfileRecord dict's `stage:analyze` exclusive ms with the fused
    path's pack and decision spans (`system.pack`, `system.decide`,
    models/system.py) folded back in: the staged path opens neither."""
    b = rec["buckets"]
    return sum(b.get(k, 0.0)
               for k in ("stage:analyze", "system.pack", "system.decide"))


def profiled_cycle(n_variants: int, mode: str, *, device=None,
                   dtype=None) -> dict:
    """Warm-up cycle, then three profiled whole-fleet load-shift cycles
    (every signature changes, every lane re-solves each time). Returns
    the ProfileRecord dict of the fastest by stage:analyze (the cycles
    are identical work, so the min is the least-noise sample), with the
    four cycles' kernel_launches."""
    with knobs(WVA_FUSED_SOLVE=mode, **NATIVE_OFF), \
            cycle_launches() as rows:
        _kube, prom, rec = build_cluster(n_variants, device=device,
                                         dtype=dtype)
        rec.reconcile()                     # warm-up
        records = []
        for rps in (36.0, 42.0, 48.0):
            seed_prom(prom.store, rps=rps)  # fleet-wide demand step
            result = rec.reconcile()
            if len(result.processed) != n_variants:
                raise RuntimeError(f"fuse {mode}: {len(result.processed)} "
                                   f"of {n_variants} processed")
            records.append(rec.profiler.records()[0].to_dict())
    best = min(records, key=analyze_ms)
    best["kernel_launches"] = launch_summary(rows)
    return best


def steady_state_run(n_variants: int, *, device=None, dtype=None) -> dict:
    """STEADY_CYCLES fused load-shift cycles after warm-up: per-cycle
    retraces and transfer counts from the per-cycle audit deltas."""
    with knobs(WVA_FUSED_SOLVE="on", **NATIVE_OFF), \
            cycle_launches() as rows:
        _kube, prom, rec = build_cluster(n_variants, device=device,
                                         dtype=dtype)
        rec.reconcile()
        per_cycle = []
        for i in range(STEADY_CYCLES):
            # monotone steps well past WVA_SOLVE_EPSILON, starting off
            # the warm-up's 30 rps: every cycle's signatures change, so
            # every cycle re-solves through the arena
            seed_prom(prom.store, rps=32.5 + 2.5 * i)
            rec.reconcile()
            audit = rec.profiler.records()[0].device
            per_cycle.append({
                "retraces": sum(audit["retraces"].values()),
                "d2h": audit["transfers"].get("d2h", 0),
                "h2d": audit["transfers"].get("h2d", 0),
            })
    return {
        "cycles": STEADY_CYCLES,
        "retraces_total": sum(c["retraces"] for c in per_cycle),
        "d2h_per_cycle": sorted({c["d2h"] for c in per_cycle}),
        "h2d_per_cycle": sorted({c["h2d"] for c in per_cycle}),
        "kernel_launches": launch_summary(rows),
    }


def fleet_spec(n: int = FLEET_SERVERS,
               distinct_loads: bool = False) -> SystemSpec:
    """`n` Premium servers over 8 models on v5e-1, 7 shared load levels
    or (distinct_loads) a load per server."""
    models = [f"llama-8b-m{i}" for i in range(8)]
    return SystemSpec(
        accelerators=[make_slice("v5e", 1, "1x1")],
        profiles=[ModelSliceProfile(model=m, accelerator="v5e-1",
                                    alpha=6.973, beta=0.027, gamma=5.2,
                                    delta=0.1, max_batch_size=64,
                                    at_tokens=128)
                  for m in models],
        service_classes=[ServiceClassSpec(
            name="Premium", priority=1,
            model_targets=tuple(ModelTarget(model=m, slo_itl=24.0,
                                            slo_ttft=500.0)
                                for m in models))],
        servers=[ServerSpec(
            name=f"chat-{i}", service_class="Premium",
            model=models[i % len(models)], min_num_replicas=1,
            current_alloc=AllocationData(
                accelerator="v5e-1", num_replicas=1,
                load=ServerLoadSpec(
                    arrival_rate=(1200.0 + i * 0.37 if distinct_loads
                                  else 1200.0 + (i % 7) * 60.0),
                    avg_in_tokens=128,
                    avg_out_tokens=128)))
            for i in range(n)],
        capacity={},
        optimizer=OptimizerSpec(unlimited=True),
    )


def fleet_4096(distinct_loads: bool = False, n: int = FLEET_SERVERS, *,
               device=None, dtype=None) -> dict:
    """The fused analyze + optimize wall at `n` servers on a directly
    driven System (host clock, synchronized with the card), one build
    and first-launch cycle, then the median of 5. `distinct_loads` gives
    every server its own arrival rate: the no-sharing worst case where
    lane dedup finds nothing."""
    spec = fleet_spec(n, distinct_loads)
    unique_lanes = 0
    rows: list[tuple[int, int, int]] = []

    def cycle() -> float:
        nonlocal unique_lanes
        system = System(device=device, dtype=dtype)
        opt_spec = system.set_from_spec(spec)
        before = counters()
        t0 = time.perf_counter()
        system.calculate(backend=engine_backend(system.device))
        Manager(system, Optimizer(opt_spec)).optimize()
        if system.device.type == "cuda":
            torch.cuda.synchronize(system.device)
        wall = (time.perf_counter() - t0) * 1000.0
        rows.append(tuple(a - b for a, b in zip(counters(), before)))
        if len(system.generate_solution().allocations) != n:
            raise RuntimeError("fleet_4096: a server was left unallocated")
        unique_lanes = system.last_unique_lanes
        return wall

    with knobs(WVA_FUSED_SOLVE="on", **NATIVE_OFF):
        cycle()                              # build, first launch
        walls = [cycle() for _ in range(5)]
    return {
        "variants": n,
        "models": 8,
        "distinct_load_levels": n if distinct_loads else 7,
        # lanes the fused program dispatched after identical-lane dedup
        "unique_lanes": unique_lanes,
        "analyze_optimize_ms_p50": round(statistics.median(walls), 1),
        "analyze_optimize_ms": [round(w, 1) for w in walls],
        "kernel_launches": launch_summary(rows),
    }


def run(smoke: bool = False, *, device=None, dtype=None) -> dict:
    with knobs(**NATIVE_OFF):
        place = where(device, dtype)
    n = SMOKE_VARIANTS if smoke else N_VARIANTS
    steady = steady_state_run(n, device=device, dtype=dtype)
    fused = profiled_cycle(n, "on", device=device, dtype=dtype)
    if smoke:
        return {
            "bench": "fuse-smoke", "variants": n,
            "analyze_ms": analyze_ms(fused),
            "steady_state": steady,
            "fused": {"transfers": fused["device"]["transfers"],
                      "retraces": fused["device"]["retraces"]},
            **place,
            "kernel_launches": fused["kernel_launches"],
        }

    staged = profiled_cycle(n, "off", device=device, dtype=dtype)
    fused_analyze = analyze_ms(fused)
    staged_analyze = analyze_ms(staged)
    return {
        "metric": "stage_analyze_exclusive_ms",
        "bench": "fuse",
        "variants": n,
        "value": fused_analyze,
        "unit": "ms exclusive stage:analyze, 512-variant whole-fleet "
                "load-shift cycle",
        "staged_rerun_analyze_ms": staged_analyze,
        "vs_staged_rerun": round(staged_analyze / fused_analyze, 2),
        "fused": {
            "wall_ms": fused["wall_ms"],
            "analyze_ms": fused_analyze,
            "transfers": fused["device"]["transfers"],
            "retraces": fused["device"]["retraces"],
            "kernel_launches": fused["kernel_launches"],
        },
        "staged": {
            "wall_ms": staged["wall_ms"],
            "analyze_ms": staged_analyze,
            "transfers": staged["device"]["transfers"],
            "retraces": staged["device"]["retraces"],
            "kernel_launches": staged["kernel_launches"],
        },
        "steady_state": steady,
        "fleet_4096": fleet_4096(device=device, dtype=dtype),
        # the no-sharing worst case (every server its own load: dedup
        # finds nothing, all 4096 candidates solve individually); no
        # budget rides on it
        "fleet_4096_distinct_loads": fleet_4096(True, device=device,
                                                dtype=dtype),
        **place,
    }


def check(out: dict) -> tuple[list[str], list[dict]]:
    """(the deterministic invariants that failed, every wall-clock
    budget with its value and whether it was met)."""
    steady, fused = out["steady_state"], out["fused"]
    fails = []
    if steady["retraces_total"] != 0 or fused["retraces"]:
        fails.append(f"retraced: {steady}, {fused['retraces']}")
    if steady["d2h_per_cycle"] != [1]:
        fails.append(f"expected exactly one bulk readback per cycle: "
                     f"{steady}")
    if fused["transfers"].get("d2h", 0) > 2:
        fails.append(f"fused cycle read back more than twice: {fused}")
    budgets = []
    if "fleet_4096" in out:
        p50 = out["fleet_4096"]["analyze_optimize_ms_p50"]
        budgets.append({"budget": "fleet_4096 analyze_optimize_ms_p50",
                        "value": p50, "limit": ANALYZE_BUDGET_MS,
                        "met": p50 < ANALYZE_BUDGET_MS})
    return fails, budgets


def main(argv=None) -> int:
    opts = parse_args("bench_torch_fuse.py", argv, smoke=True)
    out = run(opts.smoke, device=opts.device)
    return emit(out, opts.out, *check(out))


if __name__ == "__main__":
    sys.exit(main())
