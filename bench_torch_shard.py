"""bench_torch_shard: the lane-mesh fleet solve of the port at 8192
variants, with the port's engine on the card.

The counterpart of bench_shard.py. It measures a FORCED FULL
analyze+optimize pass (IncrementalSolveEngine with full_every=1: every
lane re-solves every cycle) as the variant axis grows 512 -> 2048 -> 8192,
on a lane mesh (WVA_SHARDED_FLEET's `fleet_mesh`) and unsharded:

- per-size forced-full walls, sharded and unsharded, and the decisions
  of the two, which must be equal;
- a 10-cycle churn on the mesh's resident ShardedFleetArena: exactly one
  bulk readback per cycle, and that readback crosses the sharded boundary
  (the device audit's `d2h@<entries>` tally); the audit's retrace count,
  which PyTorch keeps at 0 by construction (it never traces), is held
  too;
- the vector greedy (WVA_VECTOR_GREEDY) against the sequential list
  scheduler on the 4096-variant no-sharing capacity-limited shape: the
  allocations must be equal; its >= 3x speedup is a budget.

The mesh is `--mesh-devices N` entries (default 8, the JAX script's
MESH_DEVICES) that list the local devices in turn. On one card all N
entries are that card: the sharded column then measures N per-shard host
costs and the sharded-boundary counters, not scaling across cards; the
record says how many cards the mesh holds (`mesh_cards`).

The JAX script's headline compared the 8192-variant sharded pass with a
512-variant cycle wall it had measured before; this one measures that
cycle in the same run: bench_torch_collect's steady fleet reconcile cycle
on the same fleet shape (512 VAs, 8 models, the Premium class), and
reports the ratio as `vs_512_reconcile_cycle` with both numbers beside it.

    python3 bench_torch_shard.py [--device cuda|cpu] [--dtype float32|float64]
        [--mesh-devices 8] [--smoke] [--out PATH]

Runs on `cuda` in float32 unless asked; raises without CUDA. Invariants
raise; the two wall-clock budgets (8192 sharded <= 2x the 512-VA cycle,
greedy speedup >= 3) are printed as met or not met. Each engine cycle's
B1/B2 launches and sizing readbacks are counted from the port's counters.
Prints ONE JSON line; writes it to PATH only with `--out`.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import statistics
import time
from dataclasses import replace as dc_replace

import torch

from bench_torch_collect import (
    counters,
    emit,
    knobs,
    launch_summary,
    refuse_output,
    timed_cycle,
)
from bench_torch_loop import where
from workload_variant_autoscaler_tpu_torch.models import (
    AllocationData,
    ModelSliceProfile,
    ModelTarget,
    OptimizerSpec,
    SaturationPolicy,
    ServerLoadSpec,
    ServerSpec,
    ServiceClassSpec,
    System,
    SystemSpec,
    make_slice,
)
from workload_variant_autoscaler_tpu_torch.obs.profile import DEVICE_AUDIT
from workload_variant_autoscaler_tpu_torch.parallel import Mesh
from workload_variant_autoscaler_tpu_torch.parallel.mesh import (
    LANE_AXIS,
    _local_devices,
)
from workload_variant_autoscaler_tpu_torch.solver import (
    IncrementalSolveEngine,
    Manager,
    Optimizer,
    solve_greedy,
)
from workload_variant_autoscaler_tpu_torch.utils.device import (
    resolve_device,
    resolve_dtype,
)

MESH_DEVICES = 8
STEADY_CYCLES = 10
SIZES = (512, 2048, 8192)
SMOKE_SIZES = (64, 128)
CHURN_N = 512
GREEDY_N = 4096
# the engine's sizing backend: the CUDA kernels on the card, their plain
# versions on the CPU
BACKEND = "kernel"
# the keys of this script's records that time a run on the host's clock
# or name the cards its mesh listed: all that may differ between two runs
# that decide the same
WALL_KEYS = frozenset({"mesh_cards", "analyze_optimize_ms_p50",
                       "analyze_optimize_ms", "sequential_ms_p50",
                       "vector_ms_p50", "speedup", "reconcile_cycle_512_ms",
                       "vs_512_reconcile_cycle"})


def fleet_spec(n: int, *, distinct_loads: bool = False,
               limited: bool = False, load_step: float = 0.0) -> SystemSpec:
    """The bench_collect fleet shape (8 models, 7 load levels), scaled
    to n variants. `distinct_loads` gives every variant its own rate
    (no lane dedup); `limited` switches to the capacity-bounded
    optimizer with ample chips (uncontended pools)."""
    n_models = 8
    models = [f"llama-8b-m{i}" for i in range(n_models)]
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
            model=models[i % n_models], min_num_replicas=1,
            current_alloc=AllocationData(
                accelerator="v5e-1", num_replicas=1,
                load=ServerLoadSpec(
                    arrival_rate=load_step + (
                        1200.0 + i * 0.37 if distinct_loads
                        else 1200.0 + (i % 7) * 60.0),
                    avg_in_tokens=128,
                    avg_out_tokens=128)))
            for i in range(n)],
        capacity={"v5e": 50_000_000} if limited else {},
        optimizer=OptimizerSpec(unlimited=not limited,
                                saturation_policy="None"),
    )


def lane_mesh(entries: int, device=None) -> Mesh | None:
    """A lane mesh of `entries` entries listing the local devices of
    `device` in turn (one card: the card `entries` times); None below two
    entries, the unsharded program."""
    if entries < 2:
        return None
    local = _local_devices(device)
    return Mesh(tuple(local[i % len(local)] for i in range(entries)),
                LANE_AXIS)


def mesh_keys(mesh: Mesh | None) -> dict:
    """What a record says of its mesh: its entries and the distinct
    cards (or hosts) they list."""
    if mesh is None:
        return {"mesh_entries": 0, "mesh_cards": 0}
    return {"mesh_entries": mesh.size, "mesh_cards": len(set(mesh.devices))}


def digest(allocations: dict) -> str:
    """sha256 of {name: (accelerator, replicas)}, sorted by name."""
    rows = sorted([name, acc, int(n)] for name, (acc, n)
                  in allocations.items())
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def decisions_digest(solution) -> str:
    """`digest` of every variant's decision in an AllocationSolution."""
    return digest({name: (a.accelerator, a.num_replicas)
                   for name, a in solution.allocations.items()})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def engine_cycle(spec, engine, fm, *, device, dtype,
                 hold_gc: bool = False):
    """One analyze+optimize pass through the engine, on `device` in
    `dtype`: (wall ms, the engine's SolveStats, decisions digest,
    (B1, B2, d2h) of the pass). The System is built before the clock
    starts; with `hold_gc` the garbage of that build is collected first
    and the collector stays off inside the timed pass (bench_hier.py's
    protocol at 32k variants)."""
    dev = resolve_device(device)
    system = System(dev, resolve_dtype(dtype))
    opt_spec = system.set_from_spec(spec)
    if hold_gc:
        gc.collect()
        gc.disable()
    try:
        _sync(dev)
        before = counters()
        t0 = time.perf_counter()
        stats = engine.calculate(system, backend=BACKEND, fleet_mesh=fm,
                                 optimizer_spec=opt_spec)
        Manager(system, Optimizer(opt_spec)).optimize(
            warm=engine.warm_start())
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1000.0
        launched = tuple(a - b for a, b in zip(counters(), before))
    finally:
        if hold_gc:
            gc.enable()
    solution = system.generate_solution()
    if len(solution.allocations) != len(spec.servers):
        raise AssertionError(f"{len(solution.allocations)} allocations for "
                             f"{len(spec.servers)} variants")
    engine.finish_cycle(system)
    return wall, stats, decisions_digest(solution), launched


def forced_full_walls(n: int, mesh: Mesh | None, *, device=None,
                      dtype=None) -> dict:
    """Forced-full analyze+optimize walls (full_every=1: no lane is
    skipped, every cycle re-solves the whole fleet). One warm-up cycle,
    then 5 timed cycles over shifting fleet-wide load; the decisions of
    each timed cycle, digested."""
    engine = IncrementalSolveEngine(epsilon=0.0, full_every=1)
    on = {"device": device, "dtype": dtype}
    engine_cycle(fleet_spec(n), engine, mesh, **on)       # warm-up
    runs = [engine_cycle(fleet_spec(n, load_step=25.0 * (i + 1)), engine,
                         mesh, **on)
            for i in range(5)]
    walls = [r[0] for r in runs]
    return {
        "variants": n,
        "sharded": mesh is not None,
        "analyze_optimize_ms_p50": statistics.median(walls),
        "analyze_optimize_ms": walls,
        "decisions": [r[2] for r in runs],
        "kernel_launches": launch_summary([r[3] for r in runs]),
    }


def churned_spec(n: int, step: int) -> SystemSpec:
    """fleet_spec(n) with its first 5 variants' load moved 300 * step rps
    past the rest: well past epsilon, so they re-size."""
    spec = fleet_spec(n)
    churned = [
        dc_replace(srv, current_alloc=dc_replace(
            srv.current_alloc, load=dc_replace(
                srv.current_alloc.load,
                arrival_rate=srv.current_alloc.load.arrival_rate
                + 300.0 * step)))
        for srv in spec.servers[:5]]
    return dc_replace(spec, servers=churned + list(spec.servers[5:]))


def churn_run(n: int, mesh: Mesh, *, device=None, dtype=None) -> dict:
    """STEADY_CYCLES incremental cycles on the mesh after a warm-up, a
    small load churn each cycle: the device audit's per-cycle retraces,
    transfers and sharded-boundary tallies, and each cycle's launches."""
    engine = IncrementalSolveEngine(epsilon=0.05, full_every=0)
    on = {"device": device, "dtype": dtype}
    engine_cycle(fleet_spec(n), engine, mesh, **on)       # warm-up
    per_cycle, launched, digests = [], [], []
    # one discarded churn cycle first: the warm-up packed a fresh slab
    # (a whole upload), so the first in-place scatter happens here, not
    # inside the measured run
    for i in range(-1, STEADY_CYCLES):
        before = DEVICE_AUDIT.snapshot()
        _wall, _stats, digest, counts = engine_cycle(
            churned_spec(n, i + 2), engine, mesh, **on)
        if i < 0:
            continue
        delta = DEVICE_AUDIT.delta(before, DEVICE_AUDIT.snapshot())
        per_cycle.append({
            "retraces": sum(delta.get("retraces", {}).values()),
            "d2h": delta.get("transfers", {}).get("d2h", 0),
            "h2d": delta.get("transfers", {}).get("h2d", 0),
            "sharded": delta.get("sharded", {}),
        })
        launched.append(counts)
        digests.append(digest)
    return {
        "cycles": STEADY_CYCLES,
        "variants": n,
        **mesh_keys(mesh),
        "retraces_total": sum(c["retraces"] for c in per_cycle),
        "d2h_per_cycle": sorted({c["d2h"] for c in per_cycle}),
        "h2d_per_cycle": sorted({c["h2d"] for c in per_cycle}),
        "sharded_d2h_per_cycle": sorted(
            {c["sharded"].get(f"d2h@{mesh.size}", 0) for c in per_cycle}),
        "decisions": digests,
        "kernel_launches": launch_summary(launched),
    }


def hold_churn(steady: dict) -> None:
    """The churn's invariants: no retrace (by construction: PyTorch does
    not trace), and one bulk readback per cycle, across the sharded
    boundary."""
    if steady["retraces_total"] != 0:
        raise AssertionError(f"retraces in the churn: {steady}")
    if steady["d2h_per_cycle"] != [1]:
        raise AssertionError(
            f"expected exactly one bulk readback per cycle: {steady}")
    if steady["sharded_d2h_per_cycle"] != [1]:
        raise AssertionError(
            f"the bulk readback must cross the sharded boundary: {steady}")


def greedy_allocations(system) -> dict:
    return {s.name: (a.accelerator, a.num_replicas, a.cost, a.value)
            for s in system.servers.values()
            if (a := s.allocation) is not None}


def greedy_compare(n: int, *, device=None, dtype=None) -> dict:
    """solve_greedy on the no-sharing capacity-limited shape: the
    sequential list scheduler against the vector sweep, same System;
    their allocations must be equal."""
    system = System(resolve_device(device), resolve_dtype(dtype))
    system.set_from_spec(fleet_spec(n, distinct_loads=True, limited=True))
    system.calculate(backend=BACKEND)

    def run(mode: str) -> tuple[float, dict]:
        with knobs(WVA_VECTOR_GREEDY=mode):
            t0 = time.perf_counter()
            solve_greedy(system, SaturationPolicy.NONE)
            wall = (time.perf_counter() - t0) * 1000.0
        return wall, greedy_allocations(system)

    run("on")                       # the sweep's first call
    seq = [run("off") for _ in range(5)]
    vec = [run("on") for _ in range(5)]
    if seq[0][1] != vec[0][1]:
        raise AssertionError("vector greedy diverged from sequential")
    if len(seq[0][1]) != n:
        raise AssertionError(f"{len(seq[0][1])} of {n} variants allocated")
    seq_ms = statistics.median(w for w, _ in seq)
    vec_ms = statistics.median(w for w, _ in vec)
    return {
        "variants": n,
        "shape": "no-sharing capacity-limited (distinct loads)",
        "sequential_ms_p50": seq_ms,
        "vector_ms_p50": vec_ms,
        "speedup": seq_ms / vec_ms,
        "allocations_equal": True,
        "decisions": digest({name: a[:2] for name, a in seq[0][1].items()}),
    }


def measure(sizes, mesh: Mesh, *, device=None, dtype=None) -> dict:
    """Unsharded and sharded forced-full walls per size; raises unless
    the two decide alike in every timed cycle."""
    walls = {}
    for n in sizes:
        plain = forced_full_walls(n, None, device=device, dtype=dtype)
        sharded = forced_full_walls(n, mesh, device=device, dtype=dtype)
        if sharded["decisions"] != plain["decisions"]:
            raise AssertionError(f"{n} variants: the sharded forced-full "
                                 f"decisions differ from the unsharded")
        walls[str(n)] = {"unsharded": plain, "sharded": sharded,
                         "decisions_equal": True}
    return walls


def budget(name: str, value: float, limit: float, met: bool) -> dict:
    return {"budget": name, "value": value, "limit": limit,
            "met": "met" if met else "not met"}


def run(smoke: bool = False, mesh_devices: int = MESH_DEVICES, *,
        device=None, dtype=None) -> dict:
    """The whole bench (or its smoke): the churn, the per-size walls and,
    at full size, the greedy and the 512-VA reconcile cycle."""
    place = {**where(device, dtype), "backend": BACKEND}
    mesh = lane_mesh(mesh_devices, device)
    if mesh is None:
        raise ValueError("bench_torch_shard measures a lane mesh: "
                         "--mesh-devices must be at least 2")
    on = {"device": device, "dtype": dtype}
    steady = churn_run(SMOKE_SIZES[1] if smoke else CHURN_N, mesh, **on)
    hold_churn(steady)
    head = {**place, **mesh_keys(mesh)}
    if smoke:
        return {"bench": "shard-smoke", "sizes": list(SMOKE_SIZES), **head,
                "steady_state": steady,
                "walls": measure(SMOKE_SIZES, mesh, **on)}
    walls = measure(SIZES, mesh, **on)
    greedy = greedy_compare(GREEDY_N, **on)
    cycle_ms = timed_cycle(512, **on)["wall_s"] * 1000.0
    headline = walls["8192"]["sharded"]["analyze_optimize_ms_p50"]
    ratio = headline / cycle_ms
    return {
        "metric": "sharded_full_pass_ms_8192",
        "bench": "shard",
        "value": headline,
        "unit": "ms analyze+optimize, 8192-variant forced full pass, "
                f"{mesh.size}-entry lane mesh over "
                f"{mesh_keys(mesh)['mesh_cards']} device(s)",
        **head,
        "reconcile_cycle_512_ms": cycle_ms,
        "vs_512_reconcile_cycle": ratio,
        "budgets": [
            budget("vs_512_reconcile_cycle", ratio, 2.0, ratio <= 2.0),
            budget("greedy speedup", greedy["speedup"], 3.0,
                   greedy["speedup"] >= 3.0)],
        "walls": walls,
        "steady_state": steady,
        "greedy": greedy,
    }


def parse_args(prog: str, argv, mesh_default):
    """The CLI of the engine-scale benches: `--device` (default cuda;
    raises without CUDA), `--dtype`, `--mesh-devices`, `--smoke` and
    `--out PATH` (refused up front when it names a BENCH_*.json or a
    path under tests/fixtures/)."""
    parser = argparse.ArgumentParser(prog=prog)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "float64"))
    parser.add_argument("--mesh-devices", type=int, default=mesh_default)
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--out", default=None)
    opts = parser.parse_args(argv)
    refuse_output(parser, opts.out)
    return opts


def main(argv=None) -> int:
    opts = parse_args("bench_torch_shard.py", argv, MESH_DEVICES)
    return emit(run(opts.smoke, opts.mesh_devices, device=opts.device,
                    dtype=getattr(torch, opts.dtype)), opts.out)


if __name__ == "__main__":
    raise SystemExit(main())
