"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout, holds each
kernel against its plain PyTorch version at the shapes of the main path,
checks that a lane's kernel result and its whole decide_batch decision
keep their bits in any batch and k_max bucket (for rows on both sides of
the kernel's choice of team), drives the port's
analyze + optimize path (System.calculate ->
decide_batch -> Manager.optimize -> generate_solution) at full fleet
width, checks the decisions against the PyTorch trip loop and a CPU
reference, times the kernels and the cycle, then drives limited mode
(the capacity-aware greedy, with ample and with scarce capacity), the
staged path and the incremental engine's steady-state cycle at full
width and holds each against its reference (phase 6), then drives the
hierarchical engine (super-shards, staggered forced-full) at fleet
scale, unlimited and in limited mode, holds every cycle against a
from-scratch flat engine, restarts it from its checkpoint, and times it
against the flat engine up to 16384 variants (phase 7). It prints one
JSON line per the kernels and a final status line. Every phase raises
on failure; the script exits non-zero when CUDA is absent or any check
fails.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
N_VARIANTS = 512          # x 8 slice shapes = 4096 candidate lanes
N_VARIANTS_F64 = 64       # the float64 kernel check's smaller fleet
N_VARIANTS_CPU = 16       # the CPU reference check's fleet
TIMING_REPS = 10

# phase 6: limited-mode capacity per chip pool, as a multiple of what the
# unlimited solution takes; the engine churn's length, the share of
# variants whose load crosses an epsilon bucket each cycle, the cycles of
# its capacity change and fleet grow, and the variants the grow adds
AMPLE, SCARCE = 10.0, 0.6
LIMITED_POLICY = "PriorityRoundRobin"
ENGINE_CYCLES = 30
CHURN_SHARE = 0.02
CAPACITY_CHANGE_AT, GROW_AT, N_GROW = 15, 22, 16

# phase 7: the hierarchical engine. 7a/7b: HIER_VARIANTS variants (4
# shards of the default 1024), HIER_CYCLES churn cycles, forced full
# every HIER_FULL_EVERY cycles; the limited churn turns scarce at cycle
# HIER_SCARCE_FROM; 7b checkpoints every HIER_CKPT_EVERY cycles and
# restarts after cycle HIER_RESTART_AFTER. 7c: FLEET_VARIANTS variants
# (16 shards) for FLEET_CYCLES cycles at the seam's defaults (forced
# full every 32 cycles, a checkpoint every 8), a persistent flat engine
# for FLAT_CYCLES cycles and FLAT_REPS from-scratch flat cycles. The
# limited fleet pins variant i to a slice of GENERATIONS[i % 3].
HIER_VARIANTS = 4096
HIER_CYCLES = 12
HIER_FULL_EVERY = 8
HIER_SCARCE_FROM = 7
HIER_CKPT_EVERY = 4
HIER_RESTART_AFTER = 8
FLEET_VARIANTS = 16384
FLEET_CYCLES = 11
FLAT_CYCLES = 4
FLAT_REPS = 2
GENERATIONS = ("v5e", "v5p", "v6e")

# H100 SXM peaks (NVIDIA data sheet; the special-function rate is 16
# results per clock per SM for compute capability 9.0, at the 1.98 GHz
# boost clock over 132 SMs)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# least arithmetic of one bisection trip: per valid state (mean solve),
# extra per valid state in the tail form (CDF scan, count, Erlang sums),
# and per Poisson index of the tail form (increment scan, exp, scan; the
# log(i) terms do not depend on the trip, so only the exp counts)
FLOPS_PER_STATE, SFU_PER_STATE = 9, 1
TAIL_FLOPS_PER_STATE = 6
FLOPS_PER_ERLANG, SFU_PER_ERLANG = 6, 1

TAIL_PCT = 0.95
RTOL = {"B1": 1e-3, "B2": 2e-3}   # float32, tests/test_pallas.py tolerances
RTOL_F64 = 1e-9

SLICE_SPEED = (1.0, 0.55, 0.4, 0.3, 0.35, 0.25, 0.65, 0.35)


def log(*args) -> None:
    print(*args, flush=True)


@contextlib.contextmanager
def env(name: str, value: str):
    """Set an environment knob of the port for the block's duration."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name)
        else:
            os.environ[name] = saved


def ptxas_summary(text: str):
    """(kernel, registers and spills) per kernel entry of nvcc's
    -Xptxas -v output, the kernel named as bisect_small<float, tail>."""
    out, kernel, spill = [], None, ""
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"(bisect_(?:small|long))I([fd])Lb([01])E", ln)
            kernel = (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}"
                      f", {'tail' if m.group(3) == '1' else 'mean'}>"
                      if m else ln.split("'")[1])
        elif "spill stores" in ln:
            spill = ", ".join(re.findall(r"\d+ bytes spill \w+", ln))
        elif "Used" in ln and kernel:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append((kernel, f"{regs} registers, {spill}"))
            kernel, spill = None, ""
    return out


def blocks_per_sm(dtype: torch.dtype, k_max: int, tail_pct, long_team: bool):
    """Resident blocks per SM, on this card, of the kernel that takes rows
    of up to 3072 states (a block is one row of more than 768 states or
    four shorter rows) or, with long_team, of the one that takes longer
    rows (a block per row), at k_max."""
    from workload_variant_autoscaler_tpu_torch.ops import _build

    lib = _build.library("bisect_kernel")
    blocks = ctypes.c_int(0)
    err = lib.wva_bisect_occupancy(int(tail_pct is not None),
                                   int(dtype == torch.float64), k_max,
                                   int(long_team), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err} "
                           f"({lib.wva_error_string(err).decode()})")
    return blocks.value


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_fleet(n_variants: int, seed: int):
    """n_variants variants x the first 8 default slice shapes: per-variant
    profiles drawn around the Llama-3.1-8B fit (alpha=6.973, beta=0.027,
    gamma=5.2, delta=0.1), max_batch from {64, 128, 256}, half the
    variants in a premium class held at p95 TTFT, half on the mean."""
    from workload_variant_autoscaler_tpu_torch.models.chips import DEFAULT_SLICES
    from workload_variant_autoscaler_tpu_torch.models.spec import (
        AllocationData, ModelSliceProfile, ModelTarget, OptimizerSpec,
        ServerLoadSpec, ServerSpec, ServiceClassSpec, SystemSpec)

    rng = np.random.default_rng(seed)
    slices = list(DEFAULT_SLICES[:8])
    models = [f"m{i}" for i in range(n_variants)]
    spec = SystemSpec(
        accelerators=slices,
        service_classes=[
            ServiceClassSpec(name="premium", priority=1, model_targets=tuple(
                ModelTarget(model=m, slo_itl=24.0, slo_ttft=500.0,
                            slo_ttft_percentile=TAIL_PCT) for m in models)),
            ServiceClassSpec(name="freemium", priority=10, model_targets=tuple(
                ModelTarget(model=m, slo_itl=40.0, slo_ttft=2000.0)
                for m in models)),
        ],
        optimizer=OptimizerSpec(unlimited=True),
    )
    for i, m in enumerate(models):
        u = rng.uniform(0.8, 1.25, 4)
        for s, acc in enumerate(slices):
            f = SLICE_SPEED[s] * rng.uniform(0.95, 1.05)
            spec.profiles.append(ModelSliceProfile(
                model=m, accelerator=acc.name,
                alpha=6.973 * u[0] * f, beta=0.027 * u[1] * f,
                gamma=5.2 * u[2] * f, delta=0.1 * u[3] * f,
                max_batch_size=int(rng.choice([64, 128, 256]))))
        spec.servers.append(ServerSpec(
            name=f"srv-{i}", model=m,
            service_class="premium" if i % 2 == 0 else "freemium",
            min_num_replicas=1,
            current_alloc=AllocationData(
                accelerator=slices[0].name, num_replicas=1,
                load=ServerLoadSpec(
                    arrival_rate=float(rng.uniform(60.0, 3000.0)),
                    avg_in_tokens=int(rng.choice([128, 256, 512])),
                    avg_out_tokens=int(rng.choice([128, 256]))))))
    return spec


def make_system(spec, device, dtype):
    from workload_variant_autoscaler_tpu_torch import System

    system = System(device=device, dtype=dtype)
    opt = system.set_from_spec(spec)
    return system, opt


def cycle(system, opt, backend="kernel"):
    """One analyze + optimize cycle through the user's entry points."""
    from workload_variant_autoscaler_tpu_torch import Manager, Optimizer

    system.calculate(backend=backend)
    Manager(system, Optimizer(opt)).optimize()
    return system.generate_solution()


def capture_launches(system, opt):
    """Run one cycle and record the inputs of every kernel call it made
    and of every decide_batch call (one per sizing group)."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk
    from workload_variant_autoscaler_tpu_torch.ops import fused

    calls, groups = [], []
    orig, orig_decide = bk.bisect, fused.decide_batch

    def spy(fcols, icols, clm, k_max, tail_pct=None):
        calls.append(("B1" if tail_pct is None else "B2",
                      (fcols.clone(), icols.clone(), clm.clone(), k_max,
                       tail_pct)))
        return orig(fcols, icols, clm, k_max, tail_pct)

    def spy_decide(q, slo, epi, k_max, ttft_percentile=None,
                   backend="kernel"):
        groups.append((q, slo, epi, k_max, ttft_percentile))
        return orig_decide(q, slo, epi, k_max, ttft_percentile, backend)

    bk.bisect, fused.decide_batch = spy, spy_decide
    try:
        cycle(system, opt)
    finally:
        bk.bisect, fused.decide_batch = orig, orig_decide
    return calls, groups


def compare(calls, rtol):
    """Each captured call through the kernel and its plain version on the
    card; returns {kernel: max abs error} and raises on disagreement."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    errs: dict[str, float] = {}
    for name, args in calls:
        xk = bk.bisect(*args)
        xp = bk.bisect_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(xk).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        tol = rtol[name] if isinstance(rtol, dict) else rtol
        bad = (xk - xp).abs() > tol * xp.abs()
        err = float((xk - xp).abs().max())
        log(f"  {name} {tuple(args[0].shape)} k_max={args[3]} "
            f"{str(xk.dtype)[6:]}: max_abs_err={err:.3e} "
            f"max_rel_err={float(((xk - xp).abs() / xp.abs()).max()):.3e} "
            f"(rtol {tol:g})")
        if bool(bad.any()):
            raise AssertionError(
                f"{name}: {int(bad.sum())} rows disagree with the plain "
                f"version beyond rtol {tol:g}")
        errs[name] = max(errs.get(name, 0.0), err)
    return errs


# Rows whose lane bits are checked: (max_batch, states K, k_max buckets).
# The kernel gives a row of at most 768 states one warp and a longer one
# 128 threads, from the row's own state count, so both sides are covered.
LANE_ROWS = ((64, 704, (768, 2816, 3072, 4096)),
             (256, 2816, (2816, 3072, 4096)))


def lane_independence(calls):
    """One live row of each kind in LANE_ROWS, placed in a batch of 16
    under each of its k_max buckets, must give the bits it gives in the
    full-width launch, from each kernel."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    for name in ("B1", "B2"):
        for max_batch, k_occ, buckets in LANE_ROWS:
            for n, (fcols, icols, clm, k_max, pct) in calls:
                live = torch.nonzero((icols[:, bk.I_KOCC] == k_occ)
                                     & (icols[:, bk.I_DONE] == 0)).flatten()
                if n == name and live.numel() >= 1 and fcols.shape[0] >= 16:
                    break
            else:
                raise AssertionError(
                    f"{name}: no live max_batch-{max_batch} row")
            rows = torch.arange(fcols.shape[0], device=fcols.device)
            idx = torch.cat([live[:1], rows[rows != live[0]][:15]])
            full = bk.bisect(fcols, icols, clm, k_max, pct)[idx[0]]
            sub_clm = clm[idx % clm.shape[0]]
            got = []
            for k in buckets:
                c = sub_clm[:, :k] if k <= k_max else torch.cat(
                    [sub_clm, torch.zeros(16, k - k_max, dtype=clm.dtype,
                                          device=clm.device)], dim=1)
                got.append(bk.bisect(fcols[idx].contiguous(),
                                     icols[idx].contiguous(), c.contiguous(),
                                     k, pct)[0])
            torch.cuda.synchronize()
            same = all(torch.equal(g, full) for g in got)
            log(f"  {name} max_batch-{max_batch} row {int(idx[0])}: full "
                f"width k_max={k_max} {float(full)!r}, batch 16 k_max "
                f"{'/'.join(map(str, buckets))} {[float(g) for g in got]} "
                f"-> bit-identical={same}")
            if not same:
                raise AssertionError(
                    f"{name}: lane result depends on its batch")


def bits(x: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float tensor (so NaN compares equal to itself)."""
    return x.contiguous().view(
        torch.int64 if x.dtype == torch.float64 else torch.int32)


def decide_lane_independence(groups) -> bool:
    """One feasible lane of each kind in LANE_ROWS and each sizing group,
    decided in a batch of 16 under each of its k_max buckets and in the
    group's full-width batch, through both backends: True when every
    packed column of decide_batch gives the same bits (System._dedup_rows
    relies on it, and decide_batch's own torch prologue and epilogue run
    on both backends)."""
    from workload_variant_autoscaler_tpu_torch.ops import fused

    same = True
    for q, slo, epi, k_max, pct in groups:
        full = {b: fused.decide_batch(q, slo, epi, k_max, pct, b)
                for b in fused.BACKENDS}
        for max_batch, k_occ, buckets in LANE_ROWS:
            kind = (q.occupancy == k_occ) & q.valid
            lane = torch.nonzero(
                kind & (full["kernel"][fused.ROW_FEASIBLE] > 0)).flatten()
            # the batch's other lanes must fit the smallest bucket
            others = torch.nonzero((q.occupancy <= min(buckets))
                                   & q.valid).flatten()
            if lane.numel() < 1 or others.numel() < 16:
                raise AssertionError(
                    f"too few feasible max_batch-{max_batch} lanes")
            idx = torch.cat([lane[:1], others[others != lane[0]][:15]])

            def sub(t):
                return type(t)(*[a[idx] for a in t])

            for backend in fused.BACKENDS:
                want = bits(full[backend][:, idx[0]])
                for k in buckets:
                    got = fused.decide_batch(sub(q), sub(slo), sub(epi), k,
                                             pct, backend)[:, 0]
                    same = same and torch.equal(bits(got), want)
    return same


def reduction_cost(groups, reps: int):
    """decide_batch's time for the cycle's groups (backend "kernel") with
    the lane-stable prefix and row sums of ops/batched.py and with
    torch.cumsum / torch.sum in their place, and whether the torch
    reductions keep the lane bits. Returns (stable ms, torch ms, torch
    reductions bit-identical)."""
    from workload_variant_autoscaler_tpu_torch.ops import batched, fused

    def run():
        for g in groups:
            fused.decide_batch(*g)

    shipped = batched._prefix_sum, batched._row_sum
    for _ in range(2):
        run()
    t_stable = event_ms(run, reps)
    batched._prefix_sum = lambda x: torch.cumsum(x, dim=1)
    batched._row_sum = lambda x: x.sum(dim=1)
    try:
        for _ in range(2):
            run()
        t_torch = event_ms(run, reps)
        torch_same = decide_lane_independence(groups)
    finally:
        batched._prefix_sum, batched._row_sum = shipped
    return t_stable, t_torch, torch_same


def decisions(system):
    return {name: (s.allocation.accelerator, s.allocation.num_replicas)
            if s.allocation else None for name, s in system.servers.items()}


def event_ms(fn, reps: int) -> float:
    """Median device time of fn() over reps runs, CUDA events."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(name, args) -> tuple[float, float]:
    """(bytes time, operations time) of one call's work on an H100: the
    bytes it must move over HBM bandwidth, and its arithmetic, counting
    the trips each row runs, as the larger of the FP32 time and the
    special-function time (the two units run at once). The call's bound
    is the larger of the two."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    fcols, icols, clm, k_max, pct = args
    trips = bk.trips_run(*args).double()
    k_occ = icols[:, bk.I_KOCC].double()
    n_top = torch.clamp(k_occ, max=k_max)
    r = clm.shape[0]
    item = clm.element_size()
    nbytes = (fcols.numel() * item + icols.numel() * 4
              + float(n_top[:r].sum()) * item + fcols.shape[0] * item)
    work = trips * n_top
    flops = float(work.sum()) * FLOPS_PER_STATE
    sfu = float(work.sum()) * SFU_PER_STATE
    if name == "B2":
        n_max = icols[:, bk.I_NMAX].double()
        n_wait = torch.clamp(torch.minimum(k_occ - 1, n_top) - n_max + 1,
                             min=0)
        flops += float(work.sum()) * TAIL_FLOPS_PER_STATE
        flops += float((trips * n_wait).sum()) * FLOPS_PER_ERLANG
        sfu += float((trips * n_wait).sum()) * SFU_PER_ERLANG
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOPS_PER_S, sfu / SFU_OPS_PER_S) * 1e3
    return t_bytes, t_ops


def wrapper_host_us(args, reps: int = 200) -> float:
    """Host time of one kernel wrapper call, in us: back-to-back calls on
    one frozen row (its kernel only writes x0), so the device is never
    what the host waits for."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    fcols, icols, clm, k_max, pct = args
    icols = icols[:1].clone()
    icols[:, bk.I_DONE] = 1
    one = (fcols[:1].contiguous(), icols, clm[:1].contiguous(), k_max, pct)
    bk.bisect(*one)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        bk.bisect(*one)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def cycle_breakdown(system, opt, reps: int = 5):
    """Median (calculate, decide_batch inside it, optimize + solution)
    wall in ms over reps cycles; decide_batch is synchronized on both
    sides, so its time holds the device work of the sizing groups."""
    from workload_variant_autoscaler_tpu_torch import Manager, Optimizer
    from workload_variant_autoscaler_tpu_torch.ops import fused

    orig = fused.decide_batch
    spent: list[float] = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    fused.decide_batch = timed
    samples = []
    try:
        for _ in range(reps):
            spent.clear()
            t0 = time.perf_counter()
            system.calculate()
            t1 = time.perf_counter()
            Manager(system, Optimizer(opt)).optimize()
            system.generate_solution()
            t2 = time.perf_counter()
            samples.append(((t1 - t0) * 1e3, sum(spent) * 1e3,
                            (t2 - t1) * 1e3))
    finally:
        fused.decide_batch = orig
    return tuple(statistics.median(col) for col in zip(*samples))


def limited_spec(spec, capacity):
    from workload_variant_autoscaler_tpu_torch.models.spec import OptimizerSpec

    return dataclasses.replace(
        spec, capacity=dict(capacity),
        optimizer=OptimizerSpec(unlimited=False,
                                saturation_policy=LIMITED_POLICY))


def sweep_outcomes(fn):
    """Run fn() and return its result and what every vector fast pass of
    the greedy returned in it (the servers it left to the sequential
    loop; None where it stood down)."""
    from workload_variant_autoscaler_tpu_torch.solver import greedy

    seen = []
    orig = greedy._vector_fast_pass

    def spy(system, only, available):
        out = orig(system, only, available)
        seen.append(out)
        return out

    greedy._vector_fast_pass = spy
    try:
        return fn(), seen
    finally:
        greedy._vector_fast_pass = orig


def limited_run(spec, dtype, backend="kernel", sweep="on"):
    """One limited-mode cycle under WVA_VECTOR_GREEDY=sweep: (system,
    optimizer spec, the candidate allocations before the greedy scaled
    any, the sweep outcomes)."""
    from workload_variant_autoscaler_tpu_torch import Manager, Optimizer

    system, opt = make_system(spec, "cuda", dtype)
    system.calculate(backend=backend)
    pristine = {n: {a: x.clone() for a, x in s.all_allocations.items()}
                for n, s in system.servers.items()}
    with env("WVA_VECTOR_GREEDY", sweep):
        _, seen = sweep_outcomes(
            lambda: Manager(system, Optimizer(opt)).optimize())
    system.generate_solution()
    return system, opt, pristine, seen


def greedy_ms(system, opt, pristine, mode: str, reps: int = 5) -> float:
    """Median wall of Manager.optimize (the greedy and allocate_by_type)
    under WVA_VECTOR_GREEDY=mode, on fresh clones of the candidates each
    time (best effort scales them in place)."""
    from workload_variant_autoscaler_tpu_torch import Manager, Optimizer

    times = []
    with env("WVA_VECTOR_GREEDY", mode):
        for _ in range(reps):
            for name, server in system.servers.items():
                server.all_allocations = {
                    a: x.clone() for a, x in pristine[name].items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Manager(system, Optimizer(opt)).optimize()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def limited_mode(spec, unlimited_system):
    """Phase 6a: limited mode at full width in float32 on the kernels,
    with capacity for AMPLE and SCARCE times the chips the unlimited
    solution takes per pool, the vector sweep forced on (the default is
    the sequential loop); then float64 decisions of backend "kernel"
    against "batched" in both capacities, each under the default.
    Returns (ample, scarce) capacities and the greedy times."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    used = {c: a.count for c, a in unlimited_system.allocate_by_type().items()}
    caps = {"ample": {c: int(AMPLE * n) for c, n in used.items()},
            "scarce": {c: int(SCARCE * n) for c, n in used.items()}}
    log(f"  chips the unlimited solution takes per pool: {used}; ample "
        f"{caps['ample']}, scarce {caps['scarce']} ({LIMITED_POLICY})")
    times = {}
    for label, cap in caps.items():
        bk.reset_launches()
        system, opt, pristine, seen = limited_run(limited_spec(spec, cap),
                                                  torch.float32)
        torch.cuda.synchronize()
        launches = dict(bk.launches)
        if launches["mean"] < 1 or launches["tail"] < 1:
            raise AssertionError(f"{label}: a kernel was not launched: "
                                 f"{launches}")
        sized = {n for n, s in system.servers.items() if s.all_allocations}
        allocs = system.allocation_solution.allocations
        bad = [n for n, a in allocs.items()
               if not (np.isfinite(a.cost) and np.isfinite(a.itl_average)
                       and np.isfinite(a.ttft_average))]
        pools = {c: (a.count, a.limit)
                 for c, a in system.allocate_by_type().items()}
        over = {c: cl for c, cl in pools.items() if cl[0] > cl[1]}
        if bad or over:
            raise AssertionError(f"{label}: bad allocations {bad[:5]}, "
                                 f"pools over capacity {over}")
        if label == "ample":
            if seen != [set()]:
                raise AssertionError("ample: the vector pass did not settle "
                                     "every server")
            if decisions(system) != decisions(unlimited_system):
                raise AssertionError("ample: limited decisions differ from "
                                     "the unlimited ones")
        elif seen != [sized]:
            raise AssertionError("scarce: the contended component did not "
                                 "go to the sequential loop whole")
        short = sum(1 for n, s in system.servers.items()
                    if (a := s.allocation) is None or a.num_replicas
                    < unlimited_system.servers[n].allocation.num_replicas)
        log(f"  {label}: {len(allocs)} of {len(system.servers)} servers "
            f"allocated, {short} below their unlimited replicas; vector pass "
            f"left {len(seen[0])} servers to the sequential loop; pools "
            f"(chips used, limit) {pools}; launches {launches}")
        times[label] = {mode: greedy_ms(system, opt, pristine, mode)
                        for mode in ("on", "off")}
        log(f"  {label}: greedy (Manager.optimize, median of 5) with the "
            f"sweep {times[label]['on']:.3f} ms, sequential "
            f"{times[label]['off']:.3f} ms")
    for label, cap in caps.items():
        k64 = limited_run(limited_spec(spec, cap), torch.float64, "kernel",
                          "off")[0]
        b64 = limited_run(limited_spec(spec, cap), torch.float64, "batched",
                          "off")[0]
        dk, db = decisions(k64), decisions(b64)
        diff = [n for n in dk if dk[n] != db[n]]
        log(f"  {label}, float64: {len(diff)} of {len(dk)} servers' decisions "
            f"differ between backend 'kernel' and 'batched'")
        if diff:
            raise AssertionError(f"{label}: float64 decisions differ: "
                                 f"{diff[:5]}")
    return caps, times


def staged_path(spec, fused64):
    """Phase 6a': the staged path (WVA_FUSED_SOLVE=off) in float64 on the
    kernels decides as the fused path (phase 4's float64 system) does."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    with env("WVA_FUSED_SOLVE", "off"):
        bk.reset_launches()
        staged, opt = make_system(spec, "cuda", torch.float64)
        cycle(staged, opt, "kernel")
        launches = dict(bk.launches)
    ds, df = decisions(staged), decisions(fused64)
    diff = [n for n in ds if ds[n] != df[n]]
    log(f"  staged path, float64: {len(diff)} of {len(ds)} servers' "
        f"decisions differ from the fused path; launches {launches}")
    if diff or launches["mean"] < 1 or launches["tail"] < 1:
        raise AssertionError(f"staged path: decisions differ {diff[:5]} or "
                             f"a kernel was not launched ({launches})")


CYCLE_PARTS = ("wall", "calculate", "decide", "optimize", "finish", "gc")


@contextlib.contextmanager
def cycle_clock():
    """For the block's duration, time every decide_batch call
    (synchronized on both sides) and every run of the cyclic garbage
    collector (`gc.callbacks`); yields the dict their ms add up in, which
    timed_cycle zeroes at the start of each cycle."""
    from workload_variant_autoscaler_tpu_torch.ops import fused

    spent = {"decide": 0.0, "gc": 0.0}
    gc_started = [0.0]
    orig_decide = fused.decide_batch

    def on_gc(phase, _info):
        if phase == "start":
            gc_started[0] = time.perf_counter()
        else:
            spent["gc"] += (time.perf_counter() - gc_started[0]) * 1e3

    def timed_decide(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_decide(*args, **kwargs)
        torch.cuda.synchronize()
        spent["decide"] += (time.perf_counter() - t0) * 1e3
        return out

    fused.decide_batch = timed_decide
    gc.callbacks.append(on_gc)
    try:
        yield spent
    finally:
        fused.decide_batch = orig_decide
        gc.callbacks.remove(on_gc)


def timed_cycle(spec, eng, spent):
    """One cycle through `eng` on the card in float32, inside
    cycle_clock: (solution, stats, whether the greedy ran warm, the
    CYCLE_PARTS in ms, the B1/B2 launches). The parts are the wall,
    engine.calculate, decide_batch inside it, optimize(warm),
    generate_solution + finish_cycle, and the collector's time inside
    the wall; the launch counts are set to 0 just before the cycle and
    read just after."""
    from workload_variant_autoscaler_tpu_torch import (
        Manager, Optimizer, System)
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    system = System(device="cuda", dtype=torch.float32)
    opt = system.set_from_spec(spec)
    torch.cuda.synchronize()
    bk.reset_launches()
    spent["decide"] = spent["gc"] = 0.0
    t0 = time.perf_counter()
    stats = eng.calculate(system, backend="kernel", optimizer_spec=opt)
    t1 = time.perf_counter()
    warm = eng.warm_start()
    Manager(system, Optimizer(opt)).optimize(warm=warm)
    t2 = time.perf_counter()
    solution = system.generate_solution()
    eng.finish_cycle(system)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    parts = {"wall": (t3 - t0) * 1e3, "calculate": (t1 - t0) * 1e3,
             "decide": spent["decide"], "optimize": (t2 - t1) * 1e3,
             "finish": (t3 - t2) * 1e3, "gc": spent["gc"]}
    return solution, stats, warm is not None, parts, dict(bk.launches)


def brief(parts):
    return ", ".join(f"{k} {parts[k]:.3f}" for k in CYCLE_PARTS)


def churn_specs(caps):
    """Phase 6b's ENGINE_CYCLES limited-mode specs: each cycle
    CHURN_SHARE of the variants step their load by 10% (about five 2%
    buckets); the capacity goes from ample to scarce at
    CAPACITY_CHANGE_AT and N_GROW variants join at GROW_AT. Returns
    (spec, live variants, scarce) per cycle."""
    from workload_variant_autoscaler_tpu_torch.models.spec import (
        OptimizerSpec, SystemSpec)

    fleet = build_fleet(N_VARIANTS + N_GROW, SEED)
    rng = np.random.default_rng(SEED + 3)
    loads = {s.name: s.current_alloc.load for s in fleet.servers}
    live, cap = N_VARIANTS, caps["ample"]
    out = []
    for c in range(ENGINE_CYCLES):
        if c == CAPACITY_CHANGE_AT:
            cap = caps["scarce"]
        if c == GROW_AT:
            live += N_GROW
        if c:
            names = [s.name for s in fleet.servers[:live]]
            moved = max(1, round(CHURN_SHARE * live))
            for i in rng.choice(live, moved, replace=False):
                load = loads[names[i]]
                loads[names[i]] = dataclasses.replace(
                    load, arrival_rate=load.arrival_rate
                    * float(rng.choice([0.9, 1.1])))
        servers = [dataclasses.replace(
            s, current_alloc=dataclasses.replace(s.current_alloc,
                                                 load=loads[s.name]))
            for s in fleet.servers[:live]]
        out.append((SystemSpec(
            accelerators=fleet.accelerators, profiles=fleet.profiles,
            service_classes=fleet.service_classes, servers=servers,
            capacity=dict(cap), optimizer=OptimizerSpec(
                unlimited=False, saturation_policy=LIMITED_POLICY)),
            live, cap is caps["scarce"]))
    return out


def engine_churn(caps):
    """Phase 6b: the churn_specs cycles, float32 on the kernels, first
    through one persistent IncrementalSolveEngine alone, then each spec
    again through a from-scratch engine (full_every=1); the solutions
    must be equal every cycle. Returns the per-cycle records: each
    engine's CYCLE_PARTS in ms (the wall; engine.calculate, decide_batch
    inside it, synchronized on both sides; optimize(warm);
    generate_solution + finish_cycle; the time the cyclic garbage
    collector ran inside the wall) and the B1/B2 launches of the
    persistent engine's cycle (the launch counts are set to 0 just before
    it and read just after)."""
    from workload_variant_autoscaler_tpu_torch import IncrementalSolveEngine

    specs = churn_specs(caps)
    engine = IncrementalSolveEngine()
    with cycle_clock() as spent:
        persistent = [timed_cycle(spec, engine, spent)
                      for spec, _live, _scarce in specs]
        replay = [timed_cycle(spec, IncrementalSolveEngine(full_every=1),
                              spent)
                  for spec, _live, _scarce in specs]
    records = []
    for c, ((_spec, live, scarce), mine, ref) in enumerate(
            zip(specs, persistent, replay)):
        sol, stats, warm, parts, launches = mine
        same = sol == ref[0]
        records.append(dict(cycle=c, full=stats.full, warm=warm,
                            solved=stats.lanes_solved,
                            skipped=stats.lanes_skipped, parts=parts,
                            from_scratch=ref[3], scarce=scarce,
                            launches=launches))
        log(f"  cycle {c:2d}: {live} variants, "
            f"{'scarce' if scarce else 'ample'}, "
            f"{'full' if stats.full else 'incremental'}"
            f"{' (' + stats.reason + ')' if stats.reason else ''}, "
            f"greedy {'warm' if warm else 'cold'}: lanes solved "
            f"{stats.lanes_solved} skipped {stats.lanes_skipped}, "
            f"launches {launches}; ms: {brief(parts)}; from scratch: "
            f"{brief(ref[3])}; equal={same}")
        if not same:
            raise AssertionError(f"cycle {c}: the incremental engine's "
                                 f"solution differs from a from-scratch "
                                 f"one")
    return records


def engine_summary(records) -> None:
    """Phase 6b's summary: the persistent engine's launches over the
    churn (raises when a kernel never ran), and the median of each cycle
    part for its warm steady-state cycles, ample and scarce, and for the
    from-scratch engine's cycles."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    launches = {form: sum(r["launches"][form] for r in records)
                for form in bk.launches}
    log(f"  engine churn, the persistent engine's {len(records)} cycles: "
        f"kernel launches {launches}")
    if launches["mean"] < 1 or launches["tail"] < 1:
        raise AssertionError(f"engine churn: a kernel was not launched: "
                             f"{launches}")

    def medians(cycles):
        parts = [f"{k} {statistics.median(c[k] for c in cycles):.3f}"
                 for k in CYCLE_PARTS]
        less_gc = statistics.median(c["wall"] - c["gc"] for c in cycles)
        return ", ".join(parts) + f", wall less gc {less_gc:.3f}"

    for label, scarce in (("ample", False), ("scarce", True)):
        steady = [r for r in records if r["warm"] and r["scarce"] == scarce]
        log(f"  steady-state cycle ({label}, warm greedy, {len(steady)} "
            f"cycles, lanes solved median "
            f"{statistics.median(r['solved'] for r in steady)}), median ms: "
            f"{medians([r['parts'] for r in steady])}")
    log(f"  full cycle (from-scratch engine, all {len(records)} cycles), "
        f"median ms: {medians([r['from_scratch'] for r in records])}")


def pinned_fleet(n_variants: int, seed: int):
    """build_fleet's fleet with variant i pinned (keep_accelerator) to
    the first slice of generation GENERATIONS[i % 3]: three pool
    components. Restricting profiles would not split the fleet: the
    partition unions the chips of every candidate accelerator, and a
    server that is not pinned has the whole catalog as candidates."""
    fleet = build_fleet(n_variants, seed)
    first = {}
    for acc in fleet.accelerators:
        first.setdefault(acc.chip, acc.name)
    fleet.servers[:] = [dataclasses.replace(
        s, keep_accelerator=True, current_alloc=dataclasses.replace(
            s.current_alloc, accelerator=first[GENERATIONS[i % 3]]))
        for i, s in enumerate(fleet.servers)]
    return fleet


def pool_capacities(fleet):
    """(ample, scarce): AMPLE and SCARCE times the chips the unlimited
    solution of `fleet` takes in each chip pool."""
    system, opt = make_system(fleet, "cuda", torch.float32)
    cycle(system, opt)
    used = {c: a.count for c, a in system.allocate_by_type().items()}
    return ({c: int(AMPLE * n) for c, n in used.items()},
            {c: int(SCARCE * n) for c, n in used.items()})


def hier_specs(fleet, cycles: int, seed: int, caps=None):
    """(cycle, spec) for cycles 1..`cycles` of `fleet`: before each cycle
    but the first, CHURN_SHARE of the variants step their load by +-10%,
    as in phase 6b. With caps=(ample, scarce), limited mode under
    LIMITED_POLICY, scarce from cycle HIER_SCARCE_FROM on; else
    unlimited. A generator: every call yields the same sequence."""
    from workload_variant_autoscaler_tpu_torch.models.spec import OptimizerSpec

    rng = np.random.default_rng(seed)
    loads = [s.current_alloc.load for s in fleet.servers]
    moved = max(1, round(CHURN_SHARE * len(loads)))
    for c in range(1, cycles + 1):
        if c > 1:
            for i in rng.choice(len(loads), moved, replace=False):
                loads[i] = dataclasses.replace(
                    loads[i], arrival_rate=loads[i].arrival_rate
                    * float(rng.choice([0.9, 1.1])))
        servers = [dataclasses.replace(s, current_alloc=dataclasses.replace(
            s.current_alloc, load=load))
            for s, load in zip(fleet.servers, loads)]
        if caps is None:
            yield c, dataclasses.replace(fleet, servers=servers)
        else:
            yield c, dataclasses.replace(
                fleet, servers=servers,
                capacity=dict(caps[c >= HIER_SCARCE_FROM]),
                optimizer=OptimizerSpec(unlimited=False,
                                        saturation_policy=LIMITED_POLICY))


def hier_churn(label, fleet, seed, caps=None, restart_path=None,
               flat=False):
    """Phase 7a: HIER_CYCLES cycles of hier_specs through one persistent
    HierarchicalSolveEngine (the defaults of the engine seam, forced full
    every HIER_FULL_EVERY cycles); then, with `flat`, through a persistent
    flat engine; then each spec again through a from-scratch flat engine
    (full_every=1). Every solution must equal the from-scratch one.

    With `restart_path` (phase 7b) the engine checkpoints there every
    HIER_CKPT_EVERY cycles. After cycle HIER_RESTART_AFTER a second
    engine is built from the file; it and the first run the unchanged
    fleet once more (cycle n'), then both run the rest of the churn.

    Returns the runs: (cycle name, cycle, engine name, timed_cycle's
    result)."""
    from workload_variant_autoscaler_tpu_torch import (
        HierarchicalSolveEngine, IncrementalSolveEngine)

    kw = dict(full_every=HIER_FULL_EVERY)
    if restart_path:
        kw.update(checkpoint_path=restart_path,
                  checkpoint_every=HIER_CKPT_EVERY)
    engines = {"hier": HierarchicalSolveEngine(**kw)}
    runs = []
    with cycle_clock() as spent:
        for c, spec in hier_specs(fleet, HIER_CYCLES, seed, caps):
            for who, eng in list(engines.items()):
                runs.append((str(c), c, who, timed_cycle(spec, eng, spent)))
            if restart_path and c == HIER_RESTART_AFTER:
                engines["restarted"] = HierarchicalSolveEngine(**kw)
                for who in ("restarted", "hier"):
                    runs.append((f"{c}'", c, who,
                                 timed_cycle(spec, engines[who], spent)))
        events = {who: dict(e.ckpt_events) for who, e in engines.items()}
        del engines
        if flat:
            gc.collect()
            eng = IncrementalSolveEngine()
            runs += [(str(c), c, "flat", timed_cycle(spec, eng, spent))
                     for c, spec in hier_specs(fleet, HIER_CYCLES, seed,
                                               caps)]
            del eng
        replay = {c: timed_cycle(spec, IncrementalSolveEngine(full_every=1),
                                 spent)
                  for c, spec in hier_specs(fleet, HIER_CYCLES, seed, caps)}

    n = len(fleet.servers)
    for name, c, who, (sol, stats, warm, parts, launches) in runs:
        same = sol == replay[c][0]
        log(f"  {label} cycle {name:>3} {who:>9}: {stats.shards} shards, "
            f"{stats.shards_solved} solved, "
            f"{'restored' if stats.restored else 'full' if stats.full else 'incremental'}"
            f" ({stats.modes.get('full', 0)} of {n} variants forced), "
            f"lanes solved {stats.lanes_solved} skipped "
            f"{stats.lanes_skipped}, launches {launches}, greedy "
            f"{'warm' if warm else 'cold'}; ms: {brief(parts)}; from "
            f"scratch wall {replay[c][3]['wall']:.3f}; equal={same}")
        if not same:
            raise AssertionError(f"{label} cycle {name} ({who}): solution "
                                 f"differs from a from-scratch one")
        if who == "flat":
            continue
        if caps is None and stats.shards < 4:
            raise AssertionError(f"{label}: {stats.shards} shards")
        # cycle n' repeats cycle n's fleet: nothing is left to solve
        if caps is not None and not name.endswith("'") \
                and stats.shards_solved < 2:
            raise AssertionError(f"{label}: {stats.shards_solved} shards "
                                 f"solved")
        if c > 1 and stats.modes.get("full", 0) >= n:
            raise AssertionError(f"{label} cycle {name}: every variant "
                                 f"was forced full on a steady cycle")
    hier = [r for r in runs if r[2] != "flat"]
    launched = {form: sum(r[3][4][form] for r in hier)
                for form in ("mean", "tail")}
    if launched["mean"] < 1 or launched["tail"] < 1:
        raise AssertionError(f"{label}: a kernel was not launched: "
                             f"{launched}")
    if restart_path:
        first = next(r[3][1] for r in runs if r[2] == "restarted")
        log(f"  {label} checkpoint events: {events}; first cycle of the "
            f"restarted engine: restored={first.restored}, "
            f"full={first.full}, lanes solved {first.lanes_solved}")
        if events["restarted"]["restore"] != 1 \
                or any(e["save_error"] for e in events.values()) \
                or events["hier"]["save"] < 1 \
                or not first.restored or first.full \
                or first.lanes_solved != 0:
            raise AssertionError(f"{label}: warm restart failed: {events}")
        by_cycle = {}
        for name, _c, who, result in hier:
            by_cycle.setdefault(name, {})[who] = result[0]
        if any(s["restarted"] != s["hier"]
               for s in by_cycle.values() if "restarted" in s):
            raise AssertionError(f"{label}: the restarted engine differs "
                                 f"from the never-restarted one")
    return runs


def timed_method(obj, name: str) -> list:
    """Wrap obj.<name> (on the instance) to append each call's ms to the
    returned list."""
    spent, orig = [], getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(obj, name, timed)
    return spent


def timed_saves(engine) -> list:
    """Time every checkpoint save of `engine` (finish_cycle calls
    maybe_checkpoint each cycle; it saves every checkpoint_every-th):
    a list of (whole save ms, of which building the payload ms)."""
    saves = []
    built = timed_method(engine, "_checkpoint_payload")
    orig = engine.maybe_checkpoint

    def timed():
        before = engine.ckpt_events["save"]
        t0 = time.perf_counter()
        orig()
        if engine.ckpt_events["save"] > before:
            saves.append(((time.perf_counter() - t0) * 1e3, built[-1]))

    engine.maybe_checkpoint = timed
    return saves


def fleet_scale(workdir):
    """Phase 7c: FLEET_VARIANTS variants x 8 slices, unlimited, through
    the engine the seam gives by default (`_solve_engine`, with a
    checkpoint path): FLEET_CYCLES churn cycles (the first all forced,
    then steady, a shard forced full on the cycles its stagger phase
    comes due), a warm restart from the checkpoint of the engine's
    first save against a cold start on that cycle's fleet, a persistent
    flat engine over the first FLAT_CYCLES cycles and FLAT_REPS
    from-scratch flat cycles on the last fleet (each must decide as the
    hierarchical engine did). Returns the hierarchical runs, the restart
    records (how -> (ms to build the engine, ms to its first decision,
    timed_cycle's result, checkpoint events, ms of lane digests in the
    cycle)), the flat runs (cycle,
    timed_cycle's result), the saves and the checkpoint's size."""
    from workload_variant_autoscaler_tpu_torch import IncrementalSolveEngine
    from workload_variant_autoscaler_tpu_torch.controller import (
        SolveEngineSelector)

    fleet = build_fleet(FLEET_VARIANTS, SEED + 5)
    path = os.path.join(workdir, "fleet.ckpt")
    knobs = {"WVA_ARENA_CHECKPOINT": path}
    engine = SolveEngineSelector()._solve_engine(knobs)
    saves = timed_saves(engine)
    runs, kept = [], {}
    with cycle_clock() as spent:
        for c, spec in hier_specs(fleet, FLEET_CYCLES, SEED + 6):
            runs.append((c, timed_cycle(spec, engine, spent)))
            if c in (engine.checkpoint_every, FLEET_CYCLES):
                kept[c] = spec
            r = runs[-1][1]
            log(f"  fleet cycle {c:2d}: {r[1].shards} shards, "
                f"{r[1].shards_solved} solved, "
                f"{'full' if r[1].full else 'steady'} "
                f"({r[1].modes.get('full', 0)} variants forced), lanes "
                f"solved {r[1].lanes_solved} skipped {r[1].lanes_skipped}, "
                f"launches {r[4]}; ms: {brief(r[3])}")
        events = dict(engine.ckpt_events)
        size = os.path.getsize(path)
        del engine
        gc.collect()
        restart = {}
        at = min(kept)
        for how, cm in (("warm", knobs), ("cold", {})):
            t0 = time.perf_counter()
            eng = SolveEngineSelector()._solve_engine(cm)
            built = (time.perf_counter() - t0) * 1e3
            digests = timed_method(eng, "_lane_digest")
            out = timed_cycle(kept[at], eng, spent)
            restart[how] = (built, (time.perf_counter() - t0) * 1e3, out,
                            dict(eng.ckpt_events), sum(digests))
            del eng, out
            gc.collect()
        eng = IncrementalSolveEngine()
        flat = [(c, timed_cycle(spec, eng, spent))
                for c, spec in hier_specs(fleet, FLAT_CYCLES, SEED + 6)]
        del eng
        flat += [(FLEET_CYCLES, timed_cycle(
            kept[FLEET_CYCLES], IncrementalSolveEngine(full_every=1), spent))
            for _ in range(FLAT_REPS)]
    want = {c: r[0] for c, r in runs}
    warm, cold = restart["warm"][2], restart["cold"][2]
    log(f"  restart on cycle {at}'s fleet: warm (checkpoint events "
        f"{restart['warm'][3]}) restored={warm[1].restored} full="
        f"{warm[1].full} lanes solved {warm[1].lanes_solved}; cold "
        f"full={cold[1].full} lanes solved {cold[1].lanes_solved}")
    for c, r in flat:
        log(f"  fleet cycle {c:2d}, flat: {'full' if r[1].full else 'steady'}"
            f", lanes solved {r[1].lanes_solved}; ms: {brief(r[3])}; "
            f"equal={r[0] == want[c]}")
    if not (warm[1].restored and not warm[1].full
            and warm[1].lanes_solved == 0 and cold[1].full
            and warm[0] == want[at] and cold[0] == want[at]
            and all(r[0] == want[c] for c, r in flat)
            and events["save"] >= 1 and events["save_error"] == 0
            and restart["warm"][3]["restore"] == 1):
        raise AssertionError(f"fleet scale: restart or flat check failed "
                             f"(events {events}, {restart['warm'][3]})")
    return runs, restart, flat, saves, size


def hier_summary(card, unlimited_runs, limited_runs, fleet) -> None:
    """Phase 7's summary: launches per hierarchical cycle, the steady
    cycles at HIER_VARIANTS and FLEET_VARIANTS variants, hierarchical
    against flat (the crossover on this card), and phase 7c's times, with
    the card's name and power limit beside them. A steady cycle is any
    cycle after the first; `quiet` ones have no shard forced full."""
    runs, restart, flat, saves, size = fleet

    def parts(results):
        return brief({k: statistics.median(r[3][k] for r in results)
                      for k in CYCLE_PARTS})

    def forced(r):
        return r[1].modes.get("full", 0)

    for label, rs in (("unlimited", unlimited_runs),
                      ("limited", limited_runs)):
        per = [(r[3][4]["mean"], r[3][4]["tail"]) for r in rs
               if r[2] != "flat"]
        log(f"  launches (B1, B2) per hierarchical cycle, {label}, "
            f"{HIER_VARIANTS} variants: {per}")
    per = [(r[4]["mean"], r[4]["tail"]) for _c, r in runs]
    log(f"  launches (B1, B2) per hierarchical cycle, {FLEET_VARIANTS} "
        f"variants: {per}")

    for n, hier, flat_steady in (
            (HIER_VARIANTS,
             [r[3] for r in unlimited_runs if r[1] > 1 and r[2] == "hier"],
             [r[3] for r in unlimited_runs if r[1] > 1 and r[2] == "flat"]),
            (FLEET_VARIANTS, [r for c, r in runs if c > 1],
             [r for c, r in flat if c > 1 and not r[1].full])):
        quiet = [r for r in hier if not forced(r)]
        shard = [r for r in hier if forced(r)]
        log(f"  {card}: steady cycle at {n} variants, unlimited, median ms:")
        log(f"    hierarchical, no shard forced ({len(quiet)} cycles, lanes "
            f"solved {statistics.median(r[1].lanes_solved for r in quiet)})"
            f": {parts(quiet)}")
        if shard:
            log(f"    hierarchical, a shard forced full ({len(shard)} cycles,"
                f" {statistics.median(forced(r) for r in shard)} variants "
                f"forced): {parts(shard)}; worst wall "
                f"{max(r[3]['wall'] for r in shard):.3f}")
        log(f"    flat ({len(flat_steady)} cycles, lanes solved "
            f"{statistics.median(r[1].lanes_solved for r in flat_steady)}): "
            f"{parts(flat_steady)}")
        if not quiet or (n == FLEET_VARIANTS and not shard):
            raise AssertionError(f"{n} variants: steady cycles with and "
                                 f"without a shard forced full are needed")
    lim = [r[3] for r in limited_runs if r[1] > 1 and r[2] != "flat"
           and not r[0].endswith("'")]
    log(f"  {card}: steady cycle at {HIER_VARIANTS} variants, limited "
        f"({LIMITED_POLICY}), hierarchical, median ms ({len(lim)} cycles): "
        f"{parts(lim)}")

    full = [r for c, r in flat if r[1].full]
    log(f"  {card}: {FLEET_VARIANTS} variants ({FLEET_VARIANTS * 8} lanes, "
        f"{runs[0][1][1].shards} shards), unlimited, ms:")
    log(f"    hierarchical first cycle (all shards forced): "
        f"{brief(runs[0][1][3])}")
    log(f"    flat forced-full cycle (a new engine's first cycle, median of "
        f"{len(full)}): {parts(full)}")
    for how in ("warm", "cold"):
        built, total, out, _events, digests = restart[how]
        log(f"    restart to first decision, {how}: {total:.3f} (engine "
            f"built through the seam {built:.3f}, then one cycle: lanes "
            f"solved {out[1].lanes_solved}, lane digests {digests:.3f}, "
            f"{brief(out[3])})")
    log(f"    checkpoint saves (whole save, of which the payload): "
        f"{[(round(a, 3), round(b, 3)) for a, b in saves]} ms; file "
        f"{size} bytes")
    gcs = [r[3]["gc"] for _c, r in runs]
    log(f"    gc per hierarchical cycle: median {statistics.median(gcs):.3f}"
        f", max {max(gcs):.3f}")


def hier_phase():
    """Phase 7: 7a's two churns (7b's restart inside the limited one),
    then 7c; returns hier_summary's arguments after the card line."""
    from workload_variant_autoscaler_tpu_torch import HierarchicalSolveEngine
    from workload_variant_autoscaler_tpu_torch.controller import (
        SolveEngineSelector)
    from workload_variant_autoscaler_tpu_torch.solver import hierarchy

    default = SolveEngineSelector()._solve_engine({})
    made = HierarchicalSolveEngine(full_every=HIER_FULL_EVERY)
    knobs = ("epsilon", "shard_target", "min_variants", "checkpoint_path")
    if type(default) is not HierarchicalSolveEngine \
            or (default.min_variants, default.shard_target) \
            != (hierarchy.DEFAULT_MIN_VARIANTS, hierarchy.DEFAULT_SHARD_TARGET) \
            or any(getattr(made, k) != getattr(default, k) for k in knobs):
        raise AssertionError("the engine seam's default is not the "
                             "hierarchical engine at its defaults")
    del default, made
    log(f"  7a(i): {HIER_VARIANTS} variants x 8 slices, unlimited, the "
        f"seam's default engine with full_every={HIER_FULL_EVERY}, then a "
        f"persistent flat engine, each held against a from-scratch one")
    unlimited = hier_churn("7a(i)", build_fleet(HIER_VARIANTS, SEED + 3),
                           SEED + 4, flat=True)
    gc.collect()
    limited_fleet = pinned_fleet(HIER_VARIANTS, SEED + 3)
    caps = pool_capacities(limited_fleet)
    log(f"  7a(ii)/7b: {HIER_VARIANTS} variants pinned to one slice each "
        f"({'/'.join(GENERATIONS)} for i mod 3), {LIMITED_POLICY}, ample "
        f"{caps[0]}, scarce {caps[1]} from cycle {HIER_SCARCE_FROM}; "
        f"checkpoint every {HIER_CKPT_EVERY} cycles, restart after cycle "
        f"{HIER_RESTART_AFTER}")
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as d:
        limited = hier_churn("7a(ii)", limited_fleet, SEED + 4, caps,
                             restart_path=os.path.join(d, "arena.ckpt"))
        del limited_fleet
        gc.collect()
        log(f"  7c: {FLEET_VARIANTS} variants x 8 slices, unlimited, the "
            f"seam's default engine with a checkpoint")
        fleet = fleet_scale(d)
    return unlimited, limited, fleet


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from workload_variant_autoscaler_tpu_torch.ops import _build
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: card {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library("bisect_kernel")
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for name, text in _build.build_logs.items():
        for kernel, line in ptxas_summary(text):
            log(f"  nvcc {name}: {kernel}: {line}")
    for form, pct in (("mean", None), ("tail", TAIL_PCT)):
        for dt in (torch.float32, torch.float64):
            log(f"  {form} form, {str(dt)[6:]}: resident blocks per SM "
                f"{blocks_per_sm(dt, 2816, pct, False)} at k_max 2816 (128 "
                f"threads: one row of 769-3072 states or four rows of at "
                f"most 768), {blocks_per_sm(dt, 5632, pct, True)} at k_max "
                f"5632 (256 threads: one row of more than 3072 states)")

    log("phase 2: kernels against their plain versions")
    spec = build_fleet(N_VARIANTS, SEED)
    system, opt = make_system(spec, "cuda", torch.float32)
    calls, groups = capture_launches(system, opt)
    errs = compare(calls, RTOL)
    spec64 = build_fleet(N_VARIANTS_F64, SEED + 1)
    sys64, opt64 = make_system(spec64, "cuda", torch.float64)
    calls64, groups64 = capture_launches(sys64, opt64)
    compare(calls64, RTOL_F64)
    lane_independence(calls)
    for dt, g in (("float32", groups), ("float64", groups64)):
        same = decide_lane_independence(g)
        log(f"  decide_batch lanes, {dt}, {len(g)} groups x both backends, "
            f"max_batch-64 and -256 lanes: batch 16 under k_max "
            f"768/2816/3072/4096 against full width -> bit-identical={same}")
        if not same:
            raise AssertionError(f"decide_batch lane bits depend on the "
                                 f"batch or k_max bucket ({dt})")

    log("phase 3: main path at full width (float32, backend='kernel')")
    bk.reset_launches()
    t0 = time.perf_counter()
    solution = cycle(system, opt)
    torch.cuda.synchronize()
    first_cycle_s = time.perf_counter() - t0
    launches = dict(bk.launches)
    if launches["mean"] < 1 or launches["tail"] < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    percentiles = {system.service_classes[s.service_class_name]
                   .target(s.model_name).slo_ttft_percentile
                   for s in system.servers.values()}
    allocs = solution.allocations
    bad = [n for n, a in allocs.items()
           if not (a.num_replicas >= 1 and np.isfinite(a.cost)
                   and np.isfinite(a.itl_average)
                   and np.isfinite(a.ttft_average))]
    if bad or not allocs:
        raise AssertionError(f"bad allocations: {bad[:5]} of {len(allocs)}")
    log(f"  lanes={system.last_solve_lanes} "
        f"unique_lanes={system.last_unique_lanes} groups={len(percentiles)} "
        f"allocations={len(allocs)} of {len(system.servers)} servers "
        f"launches={launches} cycle={first_cycle_s * 1e3:.1f} ms")

    log("phase 4: decisions, backend='kernel' against backend='batched'")
    k64, o64 = make_system(spec, "cuda", torch.float64)
    b64, ob64 = make_system(spec, "cuda", torch.float64)
    cycle(k64, o64, "kernel")
    cycle(b64, ob64, "batched")
    dk, db = decisions(k64), decisions(b64)
    diff = [n for n in dk if dk[n] != db[n]]
    log(f"  float64: {len(diff)} of {len(dk)} servers differ")
    if diff:
        raise AssertionError(f"float64 decisions differ: {diff[:5]}")
    b32, ob32 = make_system(spec, "cuda", torch.float32)
    cycle(b32, ob32, "batched")
    lanes_k = {(n, a): (x.num_replicas, x.cost) for n, s in system.servers.items()
               for a, x in s.all_allocations.items()}
    lanes_b = {(n, a): (x.num_replicas, x.cost) for n, s in b32.servers.items()
               for a, x in s.all_allocations.items()}
    n_lane_diff = sum(lanes_k.get(key) != lanes_b.get(key)
                      for key in set(lanes_k) | set(lanes_b))
    log(f"  float32: {n_lane_diff} of {len(set(lanes_k) | set(lanes_b))} "
        f"lanes' decisions differ between the backends; servers differing: "
        f"{sum(decisions(system)[n] != decisions(b32)[n] for n in dk)}")
    small = build_fleet(N_VARIANTS_CPU, SEED + 2)
    ref, oref = make_system(small, "cpu", torch.float64)
    dev, odev = make_system(small, "cuda", torch.float64)
    cycle(ref, oref, "batched")
    cycle(dev, odev, "kernel")
    if decisions(ref) != decisions(dev):
        raise AssertionError("small fleet: card kernel path differs from "
                             "the CPU reference")
    worst = max((abs(x.ttft - ref.servers[n].allocation.ttft)
                 / abs(ref.servers[n].allocation.ttft)
                 for n, s in dev.servers.items()
                 if (x := s.allocation) is not None), default=0.0)
    log(f"  small fleet ({len(ref.servers)} servers): decisions equal to the "
        f"CPU float64 reference, worst TTFT rel err {worst:.2e}")
    if worst > 1e-9:
        raise AssertionError("small fleet TTFT disagrees with the reference")

    log("phase 5: times")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        cycle(system, opt)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"  cycle wall (calculate + optimize + generate_solution, "
        f"{system.last_solve_lanes} lanes): median {statistics.median(walls):.3f} "
        f"ms of {[round(w, 3) for w in walls]}")
    calc, decide, solve = cycle_breakdown(system, opt)
    log(f"  cycle breakdown (median of 5): calculate {calc:.3f} ms, of which "
        f"decide_batch {decide:.3f} ms (2 groups, synchronized) and host "
        f"{calc - decide:.3f} ms; optimize + generate_solution {solve:.3f} ms")
    t_stable, t_torch, torch_same = reduction_cost(groups, TIMING_REPS)
    log(f"  decide_batch, 2 groups, CUDA events, median of {TIMING_REPS}: "
        f"lane-stable prefix/row sums {t_stable:.3f} ms, torch.cumsum/"
        f"torch.sum {t_torch:.3f} ms; the torch reductions keep the lane "
        f"bits: {torch_same}")
    log(f"  kernel wrapper host time per call (one frozen row, 200 calls): "
        f"{wrapper_host_us(calls[0][1]):.1f} us; each kernel time below "
        f"holds its calls' host time, since CUDA events bracket each call")
    rows = []
    replaces = "workload_variant_autoscaler_tpu/ops/pallas_kernel.py:326"
    for name in ("B1", "B2"):
        mine = [a for n, a in calls if n == name]
        ms = plain = bnd = t_bytes = t_ops = 0.0
        for args in mine:
            for _ in range(2):
                bk.bisect(*args)
            ms += event_ms(lambda: bk.bisect(*args), TIMING_REPS)
            plain += event_ms(lambda: bk.bisect_plain(*args), 3)
            tb, to = bound_ms(name, args)
            bnd += max(tb, to)
            t_bytes += tb
            t_ops += to
        by = "bytes" if t_bytes > t_ops else "operations"
        n_top = torch.cat([torch.clamp(a[1][:, bk.I_KOCC], max=a[3])
                           for a in mine])
        teams = [int((n_top <= 768).sum()),
                 int(((n_top > 768) & (n_top <= 3072)).sum()),
                 int((n_top > 3072).sum())]
        log(f"  {name}: {len(mine)} launches per cycle, kernel {ms:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}), plain {plain:.3f} ms per cycle; "
            f"rows per team (warp / 128 / 256 threads): {teams}")
        rows.append({
            "name": name, "route": "cuda",
            "source": "workload_variant_autoscaler_tpu_torch/csrc/"
                      "bisect_kernel.cu",
            "replaces": replaces,
            "launches": launches["mean" if name == "B1" else "tail"],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
        })

    log("phase 6: limited mode, the staged path and the incremental engine "
        "at full width (float32, backend='kernel', unless said)")
    caps, greedy_times = limited_mode(spec, system)
    staged_path(spec, k64)
    # the engine's cycles run with none of the earlier phases' objects
    # alive, as in a controller process
    del system, sys64, k64, b64, b32, ref, dev, solution
    del calls, calls64, groups, groups64
    gc.collect()
    engine_summary(engine_churn(caps))
    log(f"  greedy ms (median of 5): ample sweep "
        f"{greedy_times['ample']['on']:.3f}, ample sequential "
        f"{greedy_times['ample']['off']:.3f}, scarce after the sweep's "
        f"fall-back {greedy_times['scarce']['on']:.3f}, scarce sequential "
        f"{greedy_times['scarce']['off']:.3f}")

    log("phase 7: the hierarchical engine at fleet scale (float32, "
        "backend='kernel')")
    del spec, caps
    gc.collect()
    t7 = time.perf_counter()
    hier_summary(card, *hier_phase())
    log(f"  phase 7 took {time.perf_counter() - t7:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
