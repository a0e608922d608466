"""bench_torch_hier: the hierarchical two-level solve of the port at
8k-32k variants, with the port's engine on the card.

The counterpart of bench_hier.py. It measures what the hierarchical
engine (WVA_HIER_SOLVE, solver/hierarchy.py) does to two walls:

- per-size steady-state FORCED-FULL walls at 8192 / 16384 / 32768
  variants: the fleet is cut into super-shards whose forced-full phases
  are hash-staggered over a FULL_EVERY-cycle window, so a steady cycle
  re-solves only the shards due that cycle; the number is the worst
  cycle of the window, and its budget is sublinear growth (the 32k worst
  cycle under 4x the 8k one). The flat engine's forced-full wall at the
  same sizes is recorded beside it;
- restart to first decision: a controller restarted against a warm arena
  checkpoint (WVA_ARENA_CHECKPOINT) against one that starts cold, each
  measured as a fresh process (`--restart-probe`: the interpreter,
  `import torch`, the CUDA context and the first cycle; the kernel
  library is built before the probes start, so no probe pays `nvcc`).
  Each probe reports the share of its wall that `import torch` and the
  CUDA context took. Budget: the warm restart decides within one
  reconcile interval (DEFAULT_INTERVAL_SECONDS, 60 s).

Invariants (they raise): no steady cycle re-solves the whole fleet, every
lane comes due exactly once per window, and a warm restart restores once
and solves fewer lanes than the fleet.

The mesh is `--mesh-devices N` lane-mesh entries listing the local cards
in turn; the default is the number of local cards, so one card runs the
unsharded program, as a one-card controller does (the JAX script forced
an 8-device host mesh).

    python3 bench_torch_hier.py [--device cuda|cpu] [--dtype float32|float64]
        [--mesh-devices N] [--smoke] [--out PATH]

Runs on `cuda` in float32 unless asked; raises without CUDA. The two
budgets are printed as met or not met. `--smoke` runs (256, 512) variants
at a 64-variant shard target with the restart measured in process.
Prints ONE JSON line; writes it to PATH only with `--out`.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import torch  # noqa: E402

_IMPORT_TORCH_S = time.perf_counter() - _T_IMPORT

from bench_torch_collect import emit, launch_summary  # noqa: E402
from bench_torch_loop import where  # noqa: E402
from bench_torch_shard import WALL_KEYS as SHARD_WALL_KEYS  # noqa: E402
from bench_torch_shard import (  # noqa: E402
    BACKEND,
    budget,
    engine_cycle,
    fleet_spec,
    lane_mesh,
    mesh_keys,
    parse_args,
)
from workload_variant_autoscaler_tpu_torch.controller.reconciler import (  # noqa: E402
    DEFAULT_INTERVAL_SECONDS,
)
from workload_variant_autoscaler_tpu_torch.solver import (  # noqa: E402
    HierarchicalSolveEngine,
    IncrementalSolveEngine,
)
from workload_variant_autoscaler_tpu_torch.utils.device import (  # noqa: E402
    resolve_device,
)

SIZES = (8192, 16384, 32768)
SMOKE_SIZES = (256, 512)
SMOKE_SHARD_TARGET = 64
# one reconcile cycle: the restart budget, a warm restart must decide
# within it
CYCLE_INTERVAL_S = DEFAULT_INTERVAL_SECONDS
FULL_EVERY = 16
# sized so the shard count (ceil(n / target)) never exceeds FULL_EVERY at
# the largest fleet: the hash-offset phases are then distinct mod
# FULL_EVERY and at most one super-shard pays forced-full per cycle, so
# the forced work per cycle is bounded by SHARD_TARGET lanes whatever
# the fleet size
SHARD_TARGET = 4096
EPSILON = 0.05
# the keys of this script's records that time a run on the host's clock
# (bench_torch_shard's and its own) or name the cards its mesh listed
WALL_KEYS = SHARD_WALL_KEYS | frozenset({
    "first_full_pass_ms", "forced_wall_ms_max", "window_walls_ms",
    "forced_full_ms_min", "cold_first_decision_ms",
    "warm_restart_to_first_decision_ms", "first_cycle_ms",
    "import_torch_s", "cuda_context_s", "startup_share",
    "forced_wall_32k_vs_8k"})


def local_cards(device=None) -> int:
    """The default --mesh-devices: the local cards (1 on the CPU)."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _cycle(spec, engine, mesh, on):
    return engine_cycle(spec, engine, mesh, hold_gc=True, **on)


def hier_forced_walls(n: int, mesh, shard_target: int = SHARD_TARGET, *,
                      device=None, dtype=None) -> dict:
    """Steady-state walls over one FULL_EVERY stagger window with the
    two-level solve on: the fleet never changes, so every lane a cycle
    solves is a staggered forced-full re-solve of the shards whose phase
    came due. The number is the WORST cycle in the window."""
    on = {"device": device, "dtype": dtype}
    engine = HierarchicalSolveEngine(epsilon=EPSILON, full_every=FULL_EVERY,
                                     shard_target=shard_target,
                                     min_variants=0)
    spec = fleet_spec(n)
    first_ms, stats, _d, _c = _cycle(spec, engine, mesh, on)  # all forced
    shards = stats.shards
    walls, forced_lanes, launched, digests = [], [], [], []
    for _ in range(FULL_EVERY):
        wall, stats, digest, counts = _cycle(spec, engine, mesh, on)
        walls.append(wall)
        forced_lanes.append(stats.modes.get("full", 0))
        launched.append(counts)
        digests.append(digest)
    if max(forced_lanes) >= n:
        raise AssertionError(f"stagger failed: a steady cycle re-solved "
                             f"the whole fleet ({n})")
    if sum(forced_lanes) != n:
        raise AssertionError(f"every lane must come due exactly once per "
                             f"window: {forced_lanes}")
    return {
        "variants": n,
        "shards": shards,
        "full_every": FULL_EVERY,
        "first_full_pass_ms": first_ms,
        "forced_wall_ms_max": max(walls),
        "forced_lanes_max_cycle": max(forced_lanes),
        "forced_lanes": forced_lanes,
        "window_walls_ms": walls,
        "decisions": sorted(set(digests)),
        "kernel_launches": launch_summary(launched),
    }


def flat_forced_walls(n: int, mesh, *, device=None, dtype=None) -> dict:
    """The flat comparator: one monolithic forced-full analyze+optimize
    pass (full_every=1, every lane, every cycle)."""
    on = {"device": device, "dtype": dtype}
    engine = IncrementalSolveEngine(epsilon=0.0, full_every=1)
    spec = fleet_spec(n)
    _cycle(spec, engine, mesh, on)                  # warm-up
    runs = [_cycle(spec, engine, mesh, on) for _ in range(2)]
    return {"variants": n, "forced_full_ms_min": min(r[0] for r in runs),
            "decisions": sorted({r[2] for r in runs}),
            "kernel_launches": launch_summary([r[3] for r in runs])}


def flat_decisions(n: int, mesh, *, device=None, dtype=None) -> str:
    """The decisions of one from-scratch flat forced-full pass at the
    hierarchical engine's EPSILON. The flat comparator's epsilon 0 sizes
    the load unsnapped, so it may decide otherwise by design; this pass
    snaps the load as the hierarchical engine does."""
    engine = IncrementalSolveEngine(epsilon=EPSILON, full_every=1)
    return _cycle(fleet_spec(n), engine, mesh,
                  {"device": device, "dtype": dtype})[2]


def _mk_engine(shard_target: int, ckpt=None) -> HierarchicalSolveEngine:
    return HierarchicalSolveEngine(epsilon=EPSILON, full_every=FULL_EVERY,
                                   shard_target=shard_target,
                                   min_variants=0, checkpoint_path=ckpt,
                                   checkpoint_every=1)


def _hold_warm(engine, stats, n: int) -> None:
    if engine.ckpt_events["restore"] != 1:
        raise AssertionError(f"no restore: {engine.ckpt_events}")
    if not stats.restored:
        raise AssertionError(f"the first cycle did not restore: {stats}")
    if stats.lanes_solved >= n:
        raise AssertionError(f"warm restart paid the cold all-forced pass "
                             f"({stats})")


def restart_probe(kind: str, n: int, shard_target: int, ckpt: str,
                  mesh_devices: int, *, device=None, dtype=None) -> dict:
    """Runs INSIDE a fresh process: one restarted controller's path to its
    first decision. `cold` pays the all-forced O(fleet) pass; `warm`
    restores the arena checkpoint and lands in the incremental steady
    state. Reports the probe's `import torch` and CUDA-context seconds."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    context_s = time.perf_counter() - t0
    mesh = lane_mesh(mesh_devices, device)
    engine = _mk_engine(shard_target, ckpt if kind == "warm" else None)
    wall, stats, digest, counts = _cycle(fleet_spec(n), engine, mesh,
                                         {"device": device, "dtype": dtype})
    if kind == "warm":
        _hold_warm(engine, stats, n)
    return {"kind": kind, "lanes_solved": stats.lanes_solved,
            "restored": stats.restored, "first_cycle_ms": wall,
            "decisions": digest, "import_torch_s": _IMPORT_TORCH_S,
            "cuda_context_s": context_s,
            "kernel_launches": launch_summary([counts])}


def restart_leg(n: int, shard_target: int = SHARD_TARGET,
                in_process: bool = False, mesh_devices: int = 1, *,
                device=None, dtype=None) -> dict:
    """Cold against warm restart to first decision, each measured as a
    FRESH PROCESS of this script (interpreter, torch, CUDA context and
    the first cycle included: what a real controller restart pays).
    `in_process` (smoke) skips the processes and times engine
    construction and the first cycle only."""
    on = {"device": device, "dtype": dtype}
    mesh = lane_mesh(mesh_devices, device)
    spec = fleet_spec(n)
    if resolve_device(device).type == "cuda":
        # the probes load the library this builds (build/torch_kernels/)
        from workload_variant_autoscaler_tpu_torch.ops import _build

        _build.library("bisect_kernel")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "arena.ckpt")
        engine = _mk_engine(shard_target, path)
        settle = [_cycle(spec, engine, mesh, on) for _ in range(3)]
        settled = settle[-1][2]
        saves = engine.ckpt_events["save"]
        if in_process:
            t0 = time.perf_counter()
            warm = _mk_engine(shard_target, path)
            _w, stats, digest, _c = _cycle(spec, warm, mesh, on)
            warm_ms = (time.perf_counter() - t0) * 1000.0
            _hold_warm(warm, stats, n)
            t0 = time.perf_counter()
            _w, _s, cold_digest, _c = _cycle(spec, _mk_engine(shard_target),
                                             mesh, on)
            cold_ms = (time.perf_counter() - t0) * 1000.0
            probes = {"warm": {"lanes_solved": stats.lanes_solved,
                               "restored": True, "decisions": digest},
                      "cold": {"decisions": cold_digest}}
        else:
            def probe(kind: str) -> tuple[float, dict]:
                argv = [sys.executable, os.path.abspath(__file__),
                        "--restart-probe", kind, str(n), str(shard_target),
                        path, "--device", str(device or "cuda"),
                        "--dtype", str(dtype or torch.float32)[6:],
                        "--mesh-devices", str(mesh_devices)]
                t0 = time.perf_counter()
                r = subprocess.run(argv, capture_output=True, text=True,
                                   cwd=os.path.dirname(
                                       os.path.abspath(__file__)))
                wall = (time.perf_counter() - t0) * 1000.0
                if r.returncode != 0:
                    raise RuntimeError(f"{kind} probe exited "
                                       f"{r.returncode}:\n{r.stdout}\n"
                                       f"{r.stderr}")
                out = json.loads(r.stdout.strip().splitlines()[-1])
                start = out["import_torch_s"] + out["cuda_context_s"]
                out["startup_share"] = start * 1000.0 / wall
                return wall, out

            warm_ms, warm_out = probe("warm")
            cold_ms, cold_out = probe("cold")
            probes = {"warm": warm_out, "cold": cold_out}
    for kind in ("warm", "cold"):
        if probes[kind]["decisions"] != settled:
            raise AssertionError(f"the {kind} restart decided otherwise "
                                 f"than the engine it replaced")
    return {
        "variants": n,
        "measured": "in-process" if in_process else "fresh process",
        **mesh_keys(mesh),
        "checkpoint_saves": saves,
        "cold_first_decision_ms": cold_ms,
        "warm_restart_to_first_decision_ms": warm_ms,
        "warm_lanes_solved": probes["warm"]["lanes_solved"],
        "cycle_interval_s": CYCLE_INTERVAL_S,
        "probes": probes,
    }


def measure(sizes, mesh, shard_target: int = SHARD_TARGET, *,
            device=None, dtype=None) -> dict:
    """Hierarchical and flat forced-full walls per size; raises unless
    every cycle of the stagger window decides as a from-scratch flat
    forced-full pass at the same epsilon (flat_decisions; the fleet never
    changes, so the window has one decision set)."""
    on = {"device": device, "dtype": dtype}
    out = {}
    for n in sizes:
        hier = hier_forced_walls(n, mesh, shard_target, **on)
        flat = flat_forced_walls(n, mesh, **on)
        if hier["decisions"] != [flat_decisions(n, mesh, **on)]:
            raise AssertionError(f"{n} variants: the hierarchical engine "
                                 f"decided otherwise than the flat "
                                 f"forced-full pass at epsilon {EPSILON}")
        out[str(n)] = {"hier": hier, "flat": flat, "decisions_equal": True}
    return out


def run(smoke: bool = False, mesh_devices: int | None = None, *,
        device=None, dtype=None) -> dict:
    """The whole bench, or its smoke."""
    if mesh_devices is None:
        mesh_devices = local_cards(device)
    on = {"device": device, "dtype": dtype}
    place = {**where(device, dtype), "backend": BACKEND}
    mesh = lane_mesh(mesh_devices, device)
    head = {**place, **mesh_keys(mesh)}
    if smoke:
        # a 64-variant shard target keeps several shards in play at smoke
        # sizes, so the stagger invariants stay meaningful
        return {"bench": "hier-smoke", "sizes": list(SMOKE_SIZES), **head,
                "walls": measure(SMOKE_SIZES, mesh, SMOKE_SHARD_TARGET, **on),
                "restart": restart_leg(SMOKE_SIZES[1], SMOKE_SHARD_TARGET,
                                       True, mesh_devices, **on)}
    walls = measure(SIZES, mesh, **on)
    restart = restart_leg(SIZES[-1], SHARD_TARGET, False, mesh_devices, **on)
    wall_8k = walls["8192"]["hier"]["forced_wall_ms_max"]
    wall_32k = walls["32768"]["hier"]["forced_wall_ms_max"]
    ratio = wall_32k / wall_8k
    warm_ms = restart["warm_restart_to_first_decision_ms"]
    return {
        "metric": "hier_forced_wall_ms_32768",
        "bench": "hier",
        "value": wall_32k,
        "unit": "ms analyze+optimize, worst steady cycle in one "
                f"{FULL_EVERY}-cycle stagger window, 32768 variants",
        **head,
        "shard_target": SHARD_TARGET,
        "full_every": FULL_EVERY,
        "forced_wall_32k_vs_8k": ratio,
        "budgets": [
            budget("forced_wall_32k_vs_8k", ratio, 4.0, ratio < 4.0),
            budget("warm_restart_to_first_decision_ms", warm_ms,
                   CYCLE_INTERVAL_S * 1000.0,
                   warm_ms < CYCLE_INTERVAL_S * 1000.0)],
        "walls": walls,
        "restart": restart,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--restart-probe"]:
        kind, n, shard_target, ckpt = argv[1:5]
        opts = parse_args("bench_torch_hier.py --restart-probe", argv[5:], 1)
        print(json.dumps(restart_probe(
            kind, int(n), int(shard_target), ckpt, opts.mesh_devices,
            device=opts.device, dtype=getattr(torch, opts.dtype))),
            flush=True)
        return 0
    opts = parse_args("bench_torch_hier.py", argv, None)
    return emit(run(opts.smoke, opts.mesh_devices, device=opts.device,
                    dtype=getattr(torch, opts.dtype)), opts.out)


if __name__ == "__main__":
    raise SystemExit(main())
