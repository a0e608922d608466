"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout, holds each
kernel against its plain PyTorch version at the shapes of the main path,
checks that a lane's kernel result and its whole decide_batch decision
keep their bits in any batch and k_max bucket, drives the port's
analyze + optimize path (System.calculate ->
decide_batch -> Manager.optimize -> generate_solution) at full fleet
width, checks the decisions against the PyTorch trip loop and a CPU
reference, times the kernels and the cycle, and prints one JSON line per
the kernels and a final status line. Every phase raises on failure; the
script exits non-zero when CUDA is absent or any check fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
N_VARIANTS = 512          # x 8 slice shapes = 4096 candidate lanes
N_VARIANTS_F64 = 64       # the float64 kernel check's smaller fleet
N_VARIANTS_CPU = 16       # the CPU reference check's fleet
TIMING_REPS = 10

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


def lane_independence(calls):
    """One row placed in a batch of 16 under k_max 768 and 3072, and in
    the full-width launch, must give the same bits from each kernel."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    for name in ("B1", "B2"):
        for n, (fcols, icols, clm, k_max, pct) in calls:
            fits = icols[:, bk.I_KOCC] <= 704          # max_batch 64 rows
            live = torch.nonzero(fits & (icols[:, bk.I_DONE] == 0)).flatten()
            others = torch.nonzero(fits).flatten()
            if n == name and live.numel() >= 1 and others.numel() >= 16:
                break
        else:
            raise AssertionError(f"{name}: too few live max_batch-64 rows")
        idx = torch.cat([live[:1], others[others != live[0]][:15]])
        full = bk.bisect(fcols, icols, clm, k_max, pct)[idx[0]]
        sub_clm = clm[idx % clm.shape[0]]
        got = []
        for k in (768, 3072):
            c = sub_clm[:, :k] if k <= k_max else torch.cat(
                [sub_clm, torch.zeros(16, k - k_max, dtype=clm.dtype,
                                      device=clm.device)], dim=1)
            got.append(bk.bisect(fcols[idx].contiguous(),
                                 icols[idx].contiguous(), c.contiguous(),
                                 k, pct)[0])
        torch.cuda.synchronize()
        same = all(torch.equal(g, full) for g in got)
        log(f"  {name} row {int(idx[0])}: full width k_max={k_max} "
            f"{float(full)!r}, batch 16 k_max 768/3072 "
            f"{[float(g) for g in got]} -> bit-identical={same}")
        if not same:
            raise AssertionError(f"{name}: lane result depends on its batch")


def bits(x: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float tensor (so NaN compares equal to itself)."""
    return x.contiguous().view(
        torch.int64 if x.dtype == torch.float64 else torch.int32)


def decide_lane_independence(groups) -> bool:
    """One feasible max_batch-64 lane of each sizing group, decided in a
    batch of 16 under k_max 768 and 3072 and in the group's full-width
    batch, through both backends: True when every packed column of
    decide_batch gives the same bits (System._dedup_rows relies on it,
    and decide_batch's own torch prologue and epilogue run on both
    backends)."""
    from workload_variant_autoscaler_tpu_torch.ops import fused

    same = True
    for q, slo, epi, k_max, pct in groups:
        full = {b: fused.decide_batch(q, slo, epi, k_max, pct, b)
                for b in fused.BACKENDS}
        fits = (q.occupancy <= 704) & q.valid
        lane = torch.nonzero(
            fits & (full["kernel"][fused.ROW_FEASIBLE] > 0)).flatten()
        others = torch.nonzero(fits).flatten()
        if lane.numel() < 1 or others.numel() < 16:
            raise AssertionError("too few feasible max_batch-64 lanes")
        idx = torch.cat([lane[:1], others[others != lane[0]][:15]])

        def sub(t):
            return type(t)(*[a[idx] for a in t])

        for backend in fused.BACKENDS:
            want = bits(full[backend][:, idx[0]])
            for k in (768, 3072):
                got = fused.decide_batch(sub(q), sub(slo), sub(epi), k, pct,
                                         backend)[:, 0]
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
        log(f"  nvcc {name}: " + " | ".join(
            ln.strip() for ln in text.splitlines() if "Used" in ln))

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
        log(f"  decide_batch lanes, {dt}, {len(g)} groups x both backends: "
            f"batch 16 under k_max 768/3072 against full width -> "
            f"bit-identical={same}")
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
        log(f"  {name}: {len(mine)} launches per cycle, kernel {ms:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}), plain {plain:.3f} ms per cycle")
        rows.append({
            "name": name, "route": "cuda",
            "source": "workload_variant_autoscaler_tpu_torch/csrc/"
                      "bisect_kernel.cu",
            "replaces": replaces,
            "launches": launches["mean" if name == "B1" else "tail"],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
