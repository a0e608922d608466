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
against the flat engine up to 16384 variants (phase 7), then drives the
controller's reconcile cycle (`Reconciler.reconcile()`: collect from a
FakePromAPI, analyze through the engines and the kernels, optimize,
publish to an InMemoryKube) at 512 VAs x 8 slices, in limited mode, and
at 4096 VAs, each cycle held against a full-solve reconciler and 8a's
first cycles against the CPU in float64 (phase 8), then drives the
streaming core on the 512-VA fleet: load changes pushed over
remote-write drain into scoped micro-cycles, each round held against a
polled reconciler, a storm and an escalation, a warm restart of the core
from its checkpoint, and the controller process itself
(`python -m workload_variant_autoscaler_tpu_torch.controller` in dev
mode, fed by pushes, scraped until every VA's published replicas equal a
polled reference, stopped with SIGTERM) (phase 9), then runs the
goodput twin (`emulator.twin.run_scenario`: the real Reconciler through
the streaming and adversarial library scenarios and flash-crowd in
simulated time, full duration; phase 14 runs the other five) on the card,
three scenarios in float64 against the CPU and one rerun byte for byte,
and the capacity planner on the card against the CPU and as its CLI
(phase 10), then builds the native host library and holds the native
and scalar backends against the kernel (calculate and three reconcile
cycles), splits the decision over 4-entry lane and candidate meshes of
the card (bit for bit the unsharded decision, 4 launches of each form
per group), drives the flat and the hierarchical engine on the lane mesh
against unsharded ones, restarts from a lane-mesh checkpoint, and reads
the mesh knobs (phase 11), then runs the repo's two headline benchmarks
through the port's own entry points: the north-star closed loop
(bench_torch_loop.py: the emulated TPU fleet, sim-time Prometheus and
the Reconciler on the card, full duration) on sharegpt-ramp,
sharegpt-p95-sizing and whole-fleet-p95 in float32, each holding its SLO
with B2 in every cycle a p95 loop sizes, sharegpt-p95-sizing in float64
on the card against the CPU, and bench_torch.py's candidate sizings per
second at 4096 candidates with its end-to-end backend parity (phase 12),
then runs the six cycle and event-path benchmarks (bench_torch_collect,
_profile, _fuse, _stream, _streamload, _streamchaos) at the JAX
scripts' full sizes, holds their invariants, B1 in every cycle that
sized, and collect's and stream's decisions in float64 on the card
against the CPU, and prints their wall-clock budgets as met or not met
(phase 13), then runs the engine-scale and goodput-scoreboard benchmarks
(bench_torch_goodput, _goodput_live and _adversary at full size in
float32, the adversary's rerun in another process byte for byte, four
of them in float64 on the card against the CPU, then bench_torch_shard
and bench_torch_hier at full sizes alone: the sharded boundary's one
readback per cycle, sharded against unsharded decisions, the stagger, a
warm restart at 32768 variants in fresh processes), holds their
invariants and B1 in every cycle that sized, and prints their budgets
as met or not met (phase 14), then runs the controller as
Dockerfile.cuda's image holds it, without Docker: the package and the
libraries phase 1 built copied into read-only directories, the
prebuilt-library knob set, no compiler on PATH; the process must go
ready, publish what a polled reference publishes, compile and write
nothing, and exit 0 on SIGTERM, three processes whose library is
missing, stale or unbuildable must exit 1 before /readyz, and B1/B2
launched from the prebuilt library must be bit-equal to the in-tree
library's (phase 15). Phase 12's longest closed loop runs beside
phases 10 and 11. Phases 1-10 and 12-14 pin WVA_NATIVE_KERNEL=false,
so their CPU references stay on the batched path. It prints one JSON
line per phase-8 and phase-9 fleet, per phase-10 run, per phase-11
part, per phase-12 run, per phase-13 and phase-14 script and for
phase 15, one for the kernels and a final status line. Every phase raises on
failure; the script exits non-zero when CUDA is absent or any check
fails.
"""

from __future__ import annotations

import contextlib
import copy
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
FLAT_CYCLES = 2
FLAT_REPS = 1
GENERATIONS = ("v5e", "v5p", "v6e")

# phase 8: the reconcile cycle (Reconciler.reconcile) on the card, on a
# cluster built by tests/reconcile_cluster.py (InMemoryKube, FakePromAPI).
# 8a: RECON_VARIANTS VAs, a model each, in RECON_NAMESPACES namespaces,
# 8 slice profiles each (a cycle sizes each VA on its current slice: 512
# lanes), half in a mean class, half held at p95 TTFT; warm-up, a first
# cycle and RECON_STEADY steady cycles, RECON_CHURN of the models' loads
# changing before each, one model's query raising in cycle RECON_FAIL_AT;
# then RECON_F64_CYCLES float64 cycles on the card against the CPU. 8b:
# the same fleet limited to RECON_SCARCE of the chips its unlimited
# solution takes in each pool, for 1 + LIMITED_STEADY cycles. 8c:
# FLEET_RECON_VARIANTS VAs x 2 shapes (FLEET_RECON_MODELS models) for
# FLEET_RECON_CYCLES cycles. Every cycle is held against a second
# reconciler with WVA_INCREMENTAL_SOLVE=off (a full solve every cycle).
# Both run at WVA_SOLVE_EPSILON=0: the engine must then decide exactly as
# the full solve (at the default 0.02 it sizes on bucketed loads, by
# design).
RECON_VARIANTS = 512
RECON_NAMESPACES = 8
RECON_STEADY = 6
RECON_CHURN = 0.02
RECON_FAIL_AT = 5
RECON_F64_CYCLES = 3
RECON_SCARCE = 0.6
LIMITED_STEADY = 3
FLEET_RECON_VARIANTS = 4096
FLEET_RECON_MODELS = 512
FLEET_RECON_CYCLES = 2
RECON_OPERATOR = (("WVA_SOLVE_EPSILON", "0"),)
STAGES = ("config", "prepare", "analyze", "optimize", "publish")

# phase 9: the streaming core and the process, on 8a's fleet at the
# defaults of a deployed process (WVA_STREAM on, the default debounce and
# WVA_SOLVE_EPSILON). 9a: a StreamCore over the card's reconciler, a
# backstop full pass, STREAM_ROUNDS rounds in which STREAM_CHANGED models
# (half in each class) change their load, pushed as one remote-write
# request; then a storm round (every model) and a round whose backlog
# outlives the lag budget (the escalation valve). Every round is held
# against a polled reference on the card (WVA_STREAM=off, a full solve
# of every VA each cycle through WVA_SOLVE_FULL_EVERY=1, at the same
# epsilon: WVA_INCREMENTAL_SOLVE=off would size on exact loads, the
# stream on epsilon buckets). 9b: a checkpoint, a fresh reconciler and
# core restored from it, STREAM_RESTART_ROUNDS rounds against the
# un-restarted core. 9c: `python -m
# workload_variant_autoscaler_tpu_torch.controller` in dev mode over the
# fleet's manifests and a Prometheus shim, PROCESS_ROUNDS pushed rounds.
STREAM_ROUNDS = 10
STREAM_CHANGED = 10
STREAM_RESTART_ROUNDS = 3
PROCESS_ROUNDS = 5
STREAM_REFERENCE = (("WVA_STREAM", "off"), ("WVA_SOLVE_FULL_EVERY", "1"))
# the process's environment beyond the smoke's own (a CPU rehearsal sets
# WVA_PLATFORM=cpu here); WVA_PLATFORM is unset otherwise: the card
PROCESS_ENV: dict = {}
PROCESS_READY_S = 300.0

# phase 10: the goodput twin and the planner on the card. 10a: the
# library's STREAMING_SCENARIOS and ADVERSARIAL_SCENARIOS and TWIN_RERUN
# at full duration in float32, in this process (the other SCENARIOS run
# in phase 14a, bench_torch_goodput); 10b: TWIN_F64 at full
# duration in float64, on the card against the port on the CPU, and 10c:
# TWIN_RERUN again on the card in float32 against 10a's run, both in
# TWIN_WORKERS worker processes started alongside 10a; 10d: the planner
# over PLAN_FITS fits of every default slice shape (and two options it
# must refuse) at PLAN_RATE req/s, mean and p95 TTFT, card against CPU in
# float64, then its CLI as a subprocess on the card.
TWIN_F64 = ("pool-drain", "restart-under-load", "diurnal-wave")
TWIN_RERUN = "flash-crowd"
TWIN_WORKERS = 4
PLAN_FITS = 8
PLAN_RATE = 80.0
PLAN_REPS = 5
# phase 10's device (a CPU rehearsal sets "cpu")
TWIN_DEVICE = "cuda"

# phase 11: the host backends and the device mesh. 11a: native against
# the kernel on phase 5's fleet (float64), scalar against native on the
# 64-variant fleet, NATIVE_RECON_CYCLES reconcile cycles of 8a's fleet
# with WVA_NATIVE_KERNEL=true against the kernel reconciler (float64),
# calculate at 4096 lanes, median of NATIVE_REPS (the host backends'
# in a spawned worker beside 11b); 11b: MESH_SHARDS-entry lane and
# candidate meshes of the card: the sharded decision against the
# unsharded one, MESH_CYCLES churned cycles of the flat engine (512
# variants) and the hierarchical one (MESH_HIER_VARIANTS) on the lane
# mesh against unsharded engines, a restart from the lane-mesh
# checkpoint; 11c: the knobs on one card.
MESH_SHARDS = 4
MESH_CYCLES = 10
MESH_HIER_VARIANTS = 4096
NATIVE_REPS = 5
NATIVE_RECON_CYCLES = 3
# phase 11's device (a CPU rehearsal sets "cpu")
MESH_DEVICE = "cuda"

# phase 12: the repo's two headline benchmarks through the port's own
# entry points (bench_torch_loop.py, bench_torch.py). 12a: LOOP_F32 at
# full duration in float32 on the card; 12b: LOOP_WIDE at full duration
# in float32, and LOOP_F64 in float64 on the card against the CPU; the
# four runs of 12a and LOOP_F64 in LOOP_WORKERS worker processes, beside
# 12c: the bench_torch record at BENCH_CANDIDATES candidates, in this
# process. LOOP_WIDE, the longest, runs in a worker of its own started
# before phase 10 (`wide_loop`), beside phases 10 and 11. Every closed
# loop holds its SLO; a p95 scenario launches B2 in every cycle that
# sizes.
LOOP_F32 = ("sharegpt-ramp", "sharegpt-p95-sizing")
LOOP_WIDE = "whole-fleet-p95"
LOOP_F64 = "sharegpt-p95-sizing"
LOOP_WORKERS = 4
BENCH_CANDIDATES = 4096
# phase 12's device (a CPU rehearsal sets "cpu")
LOOP_DEVICE = "cuda"

# phase 13: the cycle and event-path benchmarks through the port's root
# scripts (bench_torch_collect, _profile, _fuse, _stream, _streamload,
# _streamchaos) at the JAX scripts' full sizes in float32, collect's and
# stream's (64 variants) decisions in float64 on the card against the
# CPU, in BENCH13_WORKERS spawned workers; the wall-clock jobs then run
# alone. A CPU rehearsal sets BENCH13_DEVICE "cpu" and BENCH13_SMOKE
# (the scripts' smoke sizes).
BENCH13_WORKERS = 6
BENCH13_DEVICE = "cuda"
BENCH13_SMOKE = False

# phase 14: the engine-scale and goodput-scoreboard benchmarks through the
# port's root scripts. 14a, simulated time in float32 on the card, in
# BENCH14_WORKERS spawned workers: bench_torch_goodput and
# bench_torch_goodput_live over the six library scenarios at full
# duration (a job each; every score sheet sane and at its scenario's
# goodput floor, hold_scores), bench_torch_adversary's search at its
# defaults and its same-seed rerun (a worker each), then its hardened run
# and promotion; 14b, float64 on the card against the CPU: the adversary
# and goodput-live smokes, bench_torch_shard's churn, bench_torch_hier's
# smoke; 14c, wall clock, alone: bench_torch_shard at full sizes on an
# 8-entry lane mesh, bench_torch_hier at full sizes with no mesh (the
# restart leg at 32768 in fresh processes), and bench_torch_hier at 8192
# on an 8-entry mesh, each with launch counts of its own. A CPU
# rehearsal sets BENCH14_DEVICE "cpu" and BENCH14_SMOKE (smoke sizes,
# abbreviated scenarios).
BENCH14_WORKERS = 6
BENCH14_DEVICE = "cuda"
BENCH14_SMOKE = False
BENCH14_MESH = 8
# the JAX package's committed search record (read as a file, compared
# for information only: float32 decisions on the card may take another
# path)
ADVERSARY_RECORD = "BENCH_adversary_r14.json"

# phase 15: the shipped layout, as Dockerfile.cuda's runtime image holds
# the controller: the port's package copied into a read-only app/, the
# libraries phase 1 (and 11a) built copied into a read-only kernels/ (the
# image's /app/kernels), WVA_TORCH_KERNEL_DIR and WVA_NATIVE_LIB pointing
# there, no nvcc or g++ on PATH, CUDA_HOME a missing directory, HOME
# read-only. 15a: the controller process over phase 9's fleet (its
# manifests, a PromShim): ready, a first full publish equal to a polled
# reference, the prebuilt library mapped and nothing compiled, nothing
# written under the layout, SIGTERM -> 0, its peak RSS. 15b, each a fresh
# process: the knob at an empty directory, at one whose library has
# another digest, and unset; each must exit 1 before /readyz and log the
# cause (SHIPPED_REFUSALS: leg -> text its error holds). 15c: a worker in
# the layout launches B1/B2 from the prebuilt library on phase 5's fleet
# (and phase 2's float64 one), bit-equal to this process's in-tree
# library. A CPU rehearsal sets SHIPPED_ENV {"WVA_PLATFORM": "cpu"} (15a
# only: on the CPU nothing loads the CUDA library).
SHIPPED_ENV: dict = {}
SHIPPED_STALE_DIGEST = "0" * 16
SHIPPED_REFUSALS = {
    "empty": "no prebuilt library libbisect_kernel_",
    "stale": f"it holds libbisect_kernel_{SHIPPED_STALE_DIGEST}.so",
    "unset": "nvcc not found",
}
SHIPPED_EXIT_S = 180.0

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
# the planner's ninth default shape (v6e-8), beyond build_fleet's eight
PLAN_SPEED = SLICE_SPEED + (0.3,)


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
    the engine the controller runs by default (`select_solve_engine`,
    with a checkpoint path): FLEET_CYCLES churn cycles (the first all forced,
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
        select_solve_engine)

    fleet = build_fleet(FLEET_VARIANTS, SEED + 5)
    path = os.path.join(workdir, "fleet.ckpt")
    knobs = {"WVA_ARENA_CHECKPOINT": path}
    engine = select_solve_engine(knobs, None)
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
            eng = select_solve_engine(cm, None)
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
        select_solve_engine)
    from workload_variant_autoscaler_tpu_torch.solver import hierarchy

    default = select_solve_engine({}, None)
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


def reconcile_cluster():
    """tests/reconcile_cluster.py: the cluster maker of the port's
    parity tests (it imports only the package it is asked for)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import reconcile_cluster as rc

    return rc


@contextlib.contextmanager
def batch_spy():
    """For the block's duration, record the solution entry each VA is
    published from (accelerator, replicas, batch; translate.
    create_optimized_alloc reads it); yields the dict, which recon_cycle
    clears before each cycle."""
    from workload_variant_autoscaler_tpu_torch.controller import translate

    seen = {}
    orig = translate.create_optimized_alloc

    def spy(name, namespace, solution, now=None):
        d = solution.allocations[f"{name}:{namespace}"]
        seen[(name, namespace)] = (d.accelerator, d.num_replicas,
                                   d.max_batch)
        return orig(name, namespace, solution, now=now)

    translate.create_optimized_alloc = spy
    try:
        yield seen
    finally:
        translate.create_optimized_alloc = orig


def recon_cycle(b, spy):
    """One Reconciler.reconcile() of build `b`: (result, wall ms, the
    reconciler's own stage marks in ms, the B1/B2 launches, the solution
    entries published). The launch counts are set to 0 just before the
    cycle and read just after."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    spy.clear()
    torch.cuda.synchronize()
    bk.reset_launches()
    t0 = time.perf_counter()
    result = b.rec.reconcile()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {"B1": bk.launches["mean"], "B2": bk.launches["tail"]}
    stages = {s: b.emitter.value("inferno_reconcile_stage_duration_msec",
                                 stage=s) for s in STAGES}
    return result, wall, stages, launches, dict(spy)


def recon_decisions(rc, b, c, solved) -> dict:
    """Per VA: the published accelerator and replicas, the solution
    entry it was published from this cycle (with its batch), its
    conditions (type, status, reason), and the value of
    inferno_desired_replicas."""
    desired = {}
    for (_series, labels), value in rc.samples(
            b.emitter, ("inferno_desired_replicas",)).items():
        lab = dict(labels)
        desired[(lab["variant_name"], lab["namespace"],
                 lab["accelerator_type"])] = value
    return {(name, ns): (acc, reps, solved.get((name, ns)), conds,
                         desired.get((name, ns, acc)))
            for (name, ns), (acc, reps, _mb, conds)
            in rc.published(b, c).items()}


def hold_equal(label, rc, c, pair, outs) -> None:
    """Raise unless the two reconcilers of `pair` published the same
    decisions and returned the same ReconcileResult."""
    (res_a, *_r, bat_a), (res_b, *_s, bat_b) = outs
    da = recon_decisions(rc, pair[0], c, bat_a)
    db = recon_decisions(rc, pair[1], c, bat_b)
    diff = sorted(k for k in da.keys() | db.keys() if da.get(k) != db.get(k))
    if diff:
        k = diff[0]
        raise AssertionError(f"{label}: {len(diff)} VAs differ, e.g. {k}: "
                             f"{da.get(k)} != {db.get(k)}")
    for field in ("processed", "skipped", "degraded", "error"):
        if getattr(res_a, field) != getattr(res_b, field):
            raise AssertionError(f"{label}: ReconcileResult.{field} differs")


def warm(rc, b, c) -> tuple[float, list]:
    """translate.warmup_plan of the build's VAs and ConfigMaps, and one
    fused.warmup per entry on the card: (seconds, plan)."""
    from workload_variant_autoscaler_tpu_torch.controller import translate
    from workload_variant_autoscaler_tpu_torch.ops.fused import warmup

    ctl = b.mods["ctl"]
    t0 = time.perf_counter()
    plan = translate.warmup_plan(
        b.kube.list_variant_autoscalings(),
        service_class_cm=b.kube.get_configmap(
            ctl.SERVICE_CLASS_CM_NAME, ctl.CONFIG_MAP_NAMESPACE).data,
        operator_cm=b.kube.get_configmap(
            ctl.CONFIG_MAP_NAME, ctl.CONFIG_MAP_NAMESPACE).data)
    for lanes, max_batch, pct in plan:
        warmup(max_batch, lanes, pct, device="cuda")
    return time.perf_counter() - t0, plan


def recon_pair(rc, c, clock, load, dtype=torch.float32, devices=None):
    """The cluster twice: the reconciler under test on the card, and its
    reference (a full solve every cycle on the card, or, with `devices`,
    the same reconciler on another device)."""
    first, second = devices or ("cuda", "cuda")
    ref_c = c if devices else dataclasses.replace(
        c, operator=c.operator + (("WVA_INCREMENTAL_SOLVE", "off"),))
    return (rc.build(rc.PORT, c, clock, load, device=first, dtype=dtype),
            rc.build(rc.PORT, ref_c, clock, load, device=second,
                     dtype=dtype))


def drive_pair(label, rc, c, pair, clock, load, cycles, seed, spy,
               fail_at=None, log_cycles=True):
    """`cycles` cycles of both reconcilers, 60 s apart, RECON_CHURN of
    the loads changing between cycles; every cycle held equal. Returns
    the per-cycle records of the first reconciler (wall, stages,
    launches, result, solution entries published) and the second's
    walls."""
    rng = np.random.default_rng(seed)
    rows, ref_walls = [], []
    for cycle in range(1, cycles + 1):
        failing = (sorted(load)[3],) if cycle == fail_at else ()
        for b in pair:
            rc.set_loads(b, load, failing)
        outs = [recon_cycle(b, spy) for b in pair]
        hold_equal(f"{label} cycle {cycle}", rc, c, pair, outs)
        res, wall, stages, launches, _bat = outs[0]
        if failing:
            model, ns = failing[0]
            stale = {f"{name}:{vns}": "stale-cache"
                     for i in range(c.variants)
                     for name, vns in [rc.va_key(i, c)]
                     if (rc.model_of(i, c), vns) == (model, ns)}
            if res.degraded != stale:
                raise AssertionError(f"{label} cycle {cycle}: the failing "
                                     f"model's VAs read {res.degraded}, "
                                     f"not the stale-cache tier")
        rows.append((wall, stages, launches, res, outs[0][4]))
        ref_walls.append(outs[1][1])
        if log_cycles:
            log(f"    {label} cycle {cycle}: wall {wall:.3f} ms (reference "
                f"{outs[1][1]:.3f}), stages "
                + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
                + f"; launches {launches}; processed {len(res.processed)}"
                f", degraded {len(res.degraded)}; equal=True")
        clock.advance(60.0)
        rc.churn(load, RECON_CHURN, rng)
    return rows, ref_walls


def recon_summary(label, card, c, rows, ref_walls, **extra) -> None:
    """One JSON line for a sub-phase: the medians of the steady cycles'
    wall and stages (the first cycle's beside them), B1/B2 launches per
    cycle, and what `extra` adds."""
    steady = rows[1:] or rows
    out = {
        "phase": label, "card": card, "variants": c.variants,
        # the VAs' profiles; a cycle sizes one lane per VA, on its
        # current slice (translate.add_server_info_to_system_data)
        "profiles": c.variants * c.profiles, "cycles": len(rows),
        "first_cycle_ms": rows[0][0],
        "first_cycle_stage_ms": rows[0][1],
        "cycle_ms_median": statistics.median(r[0] for r in steady),
        "stage_ms_median": {s: statistics.median(r[1][s] for r in steady)
                            for s in STAGES},
        "reference_cycle_ms_median": statistics.median(ref_walls[1:]
                                                       or ref_walls),
        "b1_launches_per_cycle": [r[2]["B1"] for r in rows],
        "b2_launches_per_cycle": [r[2]["B2"] for r in rows],
        "equal": True,
    }
    out.update(extra)
    log(json.dumps(out))


def chips_taken(rc, solved: dict) -> dict:
    """Chips per generation a cycle's solution entries take."""
    chips = {name: (gen, n) for name, gen, n, _cost, _s in rc.SHAPES}
    need: dict = {}
    for acc, reps, _mb in solved.values():
        gen, n = chips[acc]
        need[gen] = need.get(gen, 0) + reps * n
    return need


def reconcile_phase(card):
    """Phase 8: 8a, its float64 card-vs-CPU check, 8b and 8c, each
    printing its summary line; returns the B1/B2 launches of 8a's
    cycles."""
    import logging

    rc = reconcile_cluster()
    # the reconcilers log a line per variant and cycle at INFO, and the
    # drift watchdog one per variant and cycle at WARNING (this fleet's
    # scraped latencies are drawn, not served, so its profiles drift)
    for name in list(logging.root.manager.loggerDict):
        if name.startswith("wva"):
            logging.getLogger(name).setLevel(logging.ERROR)
    os.environ["LOG_LEVEL"] = "error"
    with batch_spy() as spy:
        c = rc.Cluster(variants=RECON_VARIANTS, namespaces=RECON_NAMESPACES,
                       models=RECON_VARIANTS, profiles=8,
                       percentile=TAIL_PCT, operator=RECON_OPERATOR,
                       seed=SEED + 5)
        clock = rc.Clock()
        load = rc.loads(c)
        pair = recon_pair(rc, c, clock, load)
        warm_s, plan = warm(rc, pair[0], c)
        log(f"  8a: {c.variants} VAs x 8 slices in {c.namespaces} "
            f"namespaces, float32, warm-up {warm_s:.3f} s over {plan}")
        rows, ref_walls = drive_pair("8a", rc, c, pair, clock, load,
                                     1 + RECON_STEADY, SEED + 6, spy,
                                     fail_at=RECON_FAIL_AT)
        if len(rows[0][3].processed) != c.variants:
            raise AssertionError("8a: the first cycle did not process "
                                 "every VA")
        launches = [r[2] for r in rows]
        if sum(x["B1"] for x in launches) < 1 \
                or sum(x["B2"] for x in launches) < 1:
            raise AssertionError(f"8a: a kernel was not launched from "
                                 f"Reconciler.reconcile(): {launches}")
        need = chips_taken(rc, rows[-1][4])
        del pair
        gc.collect()

        # (ii) float64, the card against the CPU (the kernels' plain
        # versions), on the same fleet
        clock64 = rc.Clock()
        load64 = rc.loads(c)
        pair64 = recon_pair(rc, c, clock64, load64, torch.float64,
                            devices=("cuda", "cpu"))
        rows64, cpu_walls = drive_pair("8a float64 card vs cpu", rc, c,
                                       pair64, clock64, load64,
                                       RECON_F64_CYCLES, SEED + 7, spy)
        del pair64
        gc.collect()
        recon_summary("8a", card, c, rows, ref_walls, warmup_s=warm_s,
                      warmup_plan=plan, f64_card_vs_cpu_cycles=len(rows64),
                      f64_card_cycle_ms=[r[0] for r in rows64],
                      f64_cpu_cycle_ms=cpu_walls)

        # 8b: limited mode, scarce pools
        nodes = tuple((gen, int(RECON_SCARCE * n))
                      for gen, n in sorted(need.items()))
        cb = dataclasses.replace(c, nodes=nodes)
        clock = rc.Clock()
        load = rc.loads(cb)
        pair = recon_pair(rc, cb, clock, load)
        log(f"  8b: the 8a fleet, limited mode, pools {dict(nodes)} chips "
            f"({RECON_SCARCE} of the unlimited solution's {need})")
        rows_b, ref_b = drive_pair("8b", rc, cb, pair, clock, load,
                                   1 + LIMITED_STEADY, SEED + 8, spy)
        taken = [chips_taken(rc, r[4]) for r in rows_b]
        unplaced = [cb.variants - len(r[4]) for r in rows_b]
        if any(t.get(gen, 0) > n for t in taken for gen, n in nodes):
            raise AssertionError(f"8b: an allocation {taken} exceeds the "
                                 f"pools {nodes}")
        if not any(unplaced):
            raise AssertionError("8b: every VA was placed; the pools are "
                                 "not scarce")
        del pair
        gc.collect()
        recon_summary("8b", card, cb, rows_b, ref_b, pools=dict(nodes),
                      chips_taken=taken[-1], vas_without_allocation=unplaced)

        # 8c: fleet scale, the seam's default engine
        cc = rc.Cluster(variants=FLEET_RECON_VARIANTS,
                        namespaces=RECON_NAMESPACES,
                        models=FLEET_RECON_MODELS, profiles=2,
                        percentile=TAIL_PCT, operator=RECON_OPERATOR,
                        seed=SEED + 9)
        clock = rc.Clock()
        load = rc.loads(cc)
        pair = recon_pair(rc, cc, clock, load)
        warm_c, plan_c = warm(rc, pair[0], cc)
        log(f"  8c: {cc.variants} VAs x 2 slices, warm-up {warm_c:.3f} s "
            f"over {plan_c}")
        rows_c, ref_c = drive_pair("8c", rc, cc, pair, clock, load,
                                   FLEET_RECON_CYCLES, SEED + 10, spy)
        engine = pair[0].rec._solve_engine_obj
        if type(engine).__name__ != "HierarchicalSolveEngine" \
                or engine.last_partition is None \
                or engine.last_partition.n_shards < 2:
            raise AssertionError(f"8c: the default engine was "
                                 f"{type(engine).__name__}, not the "
                                 f"hierarchical engine over shards")
        recon_summary("8c", card, cc, rows_c, ref_c, warmup_s=warm_c,
                      warmup_plan=plan_c, engine=type(engine).__name__,
                      shards=engine.last_partition.n_shards)
        del pair
        gc.collect()
    return launches


class StreamClock:
    """The streaming core's injected monotonic clock: the host's, less
    the time spent in the polled reference (which a deployed process
    does not run), plus explicit jumps (a consumer that fell behind)."""

    def __init__(self):
        self.offset = 0.0

    def __call__(self) -> float:
        return time.monotonic() + self.offset

    @contextlib.contextmanager
    def paused(self):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.offset -= time.monotonic() - t0

    def jump(self, seconds: float) -> None:
        self.offset += seconds


def wsgi_post(app, body: bytes):
    """One POST /api/v1/write through a WSGI door: (status, headers)."""
    import io

    out = []
    environ = {"PATH_INFO": "/api/v1/write", "REQUEST_METHOD": "POST",
               "CONTENT_LENGTH": str(len(body)),
               "HTTP_CONTENT_ENCODING": "snappy",
               "wsgi.input": io.BytesIO(body)}
    b"".join(app(environ, lambda st, hdrs: out.append((st, dict(hdrs)))))
    return out[0]


def write_body(load: dict, keys, ts_ms: float) -> bytes:
    """The recording-rule series of `keys`' loads as one snappy-compressed
    remote-write request (the port's codec)."""
    from workload_variant_autoscaler_tpu_torch import stream

    series = []
    for model, ns in keys:
        v = load[(model, ns)]
        for name, value in (("wva:stream:arrival_rpm", v["rps"] * 60.0),
                            ("wva:stream:avg_input_tokens", v["prompt"]),
                            ("wva:stream:avg_output_tokens", v["gen"]),
                            ("wva:stream:avg_ttft_ms", v["ttft"] * 1e3),
                            ("wva:stream:avg_itl_ms", v["itl"] * 1e3)):
            series.append(({"__name__": name, "model_name": model,
                            "namespace": ns}, [(value, int(ts_ms))]))
    return stream.snappy_compress(stream.encode_write_request(series))


def pick_changes(rc, c, load, rng, n):
    """Scale the rate of `n` models' loads by 10-80% up or down (so each
    crosses an epsilon bucket), half from each class (VA i is premium,
    p95, when i is even; a model per VA); returns their keys."""
    keys = []
    for parity in (0, 1):
        idx = [i for i in range(c.variants) if i % 2 == parity]
        for i in rng.choice(idx, size=(n + 1 - parity) // 2, replace=False):
            keys.append((rc.model_of(int(i), c), rc.va_key(int(i), c)[1]))
    for k in keys:
        f = float(rng.uniform(1.1, 1.8))
        load[k]["rps"] *= f if rng.random() < 0.5 else 1.0 / f
    return keys


def without_drift(conds) -> tuple:
    return tuple(x for x in conds if x[0] != "PerfModelAccurate")


def stream_view(rc, b, c, batches) -> dict:
    """Per VA: the published accelerator and replicas, the batch of the
    solution it was last published from, its conditions but the drift
    verdict (PerfModelAccurate counts strikes per cycle a VA takes part
    in: a polled loop re-judges every VA every cycle, the stream only
    the changed ones), and inferno_desired_replicas."""
    desired = {}
    for (_series, labels), value in rc.samples(
            b.emitter, ("inferno_desired_replicas",)).items():
        lab = dict(labels)
        desired[(lab["variant_name"], lab["namespace"])] = (
            lab["accelerator_type"], value)
    return {key: (acc, reps, batches.get(key, (None,) * 3)[2],
                  without_drift(conds), desired.get(key))
            for key, (acc, reps, _mb, conds) in rc.published(b, c).items()}


def hold_views(label, a: dict, b: dict) -> None:
    diff = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
    if diff or not a:
        k = diff[0] if diff else None
        raise AssertionError(f"{label}: {len(diff)} of {len(a)} VAs "
                             f"differ, e.g. {k}: {a.get(k)} != {b.get(k)}")


class DecideSpy:
    """Counts `ops/fused.decide_batch` calls and their lanes."""

    def __init__(self):
        from workload_variant_autoscaler_tpu_torch.ops import fused

        self.fused, self.orig, self.calls = fused, fused.decide_batch, []

        def spy(q, *a, **kw):
            self.calls.append(q.batch_size)
            return self.orig(q, *a, **kw)

        fused.decide_batch = spy

    def close(self) -> None:
        self.fused.decide_batch = self.orig


def stream_round(core, door, body, clock, spy, batches, lags):
    """Push `body` through the door, wait for the debounce window to
    close, drain: (results, wall ms, launches, decide_batch lanes, lag
    observations, door answer). The launch counts are set to 0 just
    before the drain and read just after."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    answer = wsgi_post(door, body) if body is not None else None
    deadline = core.queue.next_deadline()
    if deadline is not None:
        time.sleep(max(deadline - clock(), 0.0))
    spy.clear()
    n_lags = len(lags)
    torch.cuda.synchronize()
    bk.reset_launches()
    decide = DecideSpy()
    try:
        t0 = time.perf_counter()
        results = core.process_once()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        decide.close()
    launches = {"B1": bk.launches["mean"], "B2": bk.launches["tail"]}
    batches.update(spy)
    return results, wall, launches, decide.calls, lags[n_lags:], answer


def reference_round(rc, ref, c, spy, clock) -> dict:
    with clock.paused():
        spy.clear()
        ref.rec.reconcile()
        return stream_view(rc, ref, c, dict(spy))


def shed_counts(b) -> dict:
    """inferno_stream_shed_total by reason."""
    return {s.labels["reason"]: s.value
            for metric in b.emitter.registry.collect()
            for s in metric.samples
            if s.name == "inferno_stream_shed_total"}


def pct(values, q):
    values = sorted(values)
    if not values:
        return None
    return values[min(int(round(q * (len(values) - 1))), len(values) - 1)]


def stream_cluster(rc):
    """8a's fleet at the process defaults: phase 9's and phase 15's."""
    return rc.Cluster(variants=RECON_VARIANTS, namespaces=RECON_NAMESPACES,
                      models=RECON_VARIANTS, profiles=8, percentile=TAIL_PCT,
                      seed=SEED + 5)


def stream_phase(card):
    """Phase 9: 9a, 9b and 9c, each printing its summary line; returns
    the B1/B2 launches of 9a's micro-cycles."""
    import logging
    import shutil

    from workload_variant_autoscaler_tpu_torch import stream

    rc = reconcile_cluster()
    for name in list(logging.root.manager.loggerDict):
        if name.startswith("wva"):
            logging.getLogger(name).setLevel(logging.ERROR)
    os.environ["LOG_LEVEL"] = "error"
    c = stream_cluster(rc)
    ref_c = dataclasses.replace(c, operator=STREAM_REFERENCE)
    wall_clock = rc.Clock()
    load = rc.loads(c)
    workdir = tempfile.mkdtemp(prefix="wva-stream-")
    try:
        with batch_spy() as spy:
            b = rc.build(rc.PORT, c, wall_clock, load, device="cuda")
            ref = rc.build(rc.PORT, ref_c, wall_clock, load, device="cuda")
            clock = StreamClock()
            core = stream.StreamCore(b.rec, clock=clock)
            b.rec.stream_core = core
            door = stream.remote_write_middleware(core)(
                lambda _e, _s: [b""])
            lags: list = []
            emit = b.emitter.emit_stream_lag

            def record_lag(seconds):
                lags.append(seconds)
                emit(seconds)

            b.emitter.emit_stream_lag = record_lag
            warm_s, plan = warm(rc, b, c)
            batches: dict = {}
            res, wall, launches, lanes, _l, _a = stream_round(
                core, door, None, clock, spy, batches, lags)
            if len(res) != 1 or len(res[0].processed) != c.variants:
                raise AssertionError("9a: the backstop pass did not "
                                     "process every VA")
            hold_views("9a backstop", stream_view(rc, b, c, batches),
                       reference_round(rc, ref, c, spy, clock))
            backstop_ms, backstop_lanes = wall, lanes
            log(f"  9a: {c.variants} VAs x 8 slices, warm-up {warm_s:.3f} s;"
                f" backstop full pass {wall:.3f} ms, launches {launches}, "
                f"decide_batch lanes {lanes}; equal=True")
            rng = np.random.default_rng(SEED + 12)
            rows = []
            base_debounce = core.queue.debounce_s
            for rnd in range(1, STREAM_ROUNDS + 3):
                wall_clock.advance(1.0)
                storm = rnd == STREAM_ROUNDS + 1
                valve = rnd == STREAM_ROUNDS + 2
                n = c.variants if storm else STREAM_CHANGED
                keys = pick_changes(rc, c, load, rng, n)
                for x in (b, ref):
                    rc.set_loads(x, load)
                body = write_body(load, keys, wall_clock.now() * 1e3)
                if valve:
                    answer = wsgi_post(door, body)
                    clock.jump(5.5)       # the default 5 s lag budget blown
                    out = stream_round(core, door, None, clock, spy,
                                       batches, lags)
                    out = out[:5] + (answer,)
                else:
                    out = stream_round(core, door, body, clock, spy,
                                       batches, lags)
                res, wall, launches, lanes, new_lags, answer = out
                debounce_ms = core.queue.debounce_s * 1e3
                stages = {st: b.emitter.value(
                    "inferno_reconcile_stage_duration_msec", stage=st)
                    for st in STAGES}
                if not answer[0].startswith("204"):
                    raise AssertionError(f"9a round {rnd}: the door "
                                         f"answered {answer}")
                scope = sorted({"{}:{}".format(*rc.va_key(i, c))
                                for i in range(c.variants)
                                if (rc.model_of(i, c),
                                    rc.va_key(i, c)[1]) in set(keys)})
                if valve:
                    if len(res) != 1 or len(res[0].processed) != c.variants \
                            or b.emitter.value(
                                "inferno_cycle_degradation_state") != 1.0:
                        raise AssertionError("9a: the escalation valve did "
                                             "not run one stream-degraded "
                                             "full pass")
                elif len(res) != 1 or res[0].processed != scope:
                    raise AssertionError(
                        f"9a round {rnd}: {len(res)} cycles over "
                        f"{[len(r.processed) for r in res]} VAs, not one "
                        f"micro-cycle over the {len(scope)} changed VAs")
                want = reference_round(rc, ref, c, spy, clock)
                got = stream_view(rc, b, c, batches)
                if valve:
                    # the valve's pass rides the stream-degraded rung:
                    # decisions equal, conditions and rung are its own
                    got = {k: v[:3] + v[4:] for k, v in got.items()}
                    want = {k: v[:3] + v[4:] for k, v in want.items()}
                hold_views(f"9a round {rnd}", got, want)
                kind = "storm" if storm else "valve" if valve else "round"
                rows.append({"kind": kind, "cycles": len(res), "wall": wall,
                             "launches": launches, "lanes": lanes,
                             "lags": new_lags, "debounce_ms": debounce_ms,
                             "stages": stages})
                log(f"    9a {kind} {rnd}: {len(res)} micro-cycle(s) over "
                    f"{[len(r.processed) for r in res]} VAs, wall "
                    f"{wall:.3f} ms (stages "
                    + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
                    + f"), decide_batch lanes {lanes}, launches {launches}, "
                    f"lag {min(new_lags):.4f}-{max(new_lags):.4f} s over "
                    f"{len(new_lags)} groups, debounce {debounce_ms} ms; "
                    f"equal=True")
            steady = [r for r in rows if r["kind"] == "round"]
            storm_row = rows[STREAM_ROUNDS]
            if not storm_row["debounce_ms"] > base_debounce * 1e3:
                raise AssertionError("9a: the storm did not widen the "
                                     "debounce window")
            micro = [r["launches"] for r in steady]
            if not any(x["B1"] for x in micro) \
                    or not any(x["B2"] for x in micro):
                raise AssertionError(f"9a: a kernel was not launched from "
                                     f"the micro-cycles: {micro}")
            if any(core.failures.values()):
                raise AssertionError(f"9a: failures {core.failures}")
            shed = shed_counts(b)
            steady_lags = [x for r in steady for x in r["lags"]]
            summary9a = {
                "phase": "9a", "card": card, "variants": c.variants,
                "backstop_ms": backstop_ms,
                "backstop_decide_batch_lanes": backstop_lanes,
                "rounds": len(steady),
                "changed_models_per_round": STREAM_CHANGED,
                "warmup_s": warm_s,
                "micro_cycles_per_round": [r["cycles"] for r in steady],
                "decide_batch_lanes_per_micro_cycle":
                    [sum(r["lanes"]) for r in steady],
                "decide_batch_calls_per_micro_cycle":
                    [len(r["lanes"]) for r in steady],
                "b1_launches_per_micro_cycle": [x["B1"] for x in micro],
                "b2_launches_per_micro_cycle": [x["B2"] for x in micro],
                "micro_cycle_ms_median": statistics.median(
                    r["wall"] for r in steady),
                "micro_cycle_stage_ms_median": {
                    st: statistics.median(r["stages"][st] for r in steady)
                    for st in STAGES},
                "micro_cycle_ms_p95": pct([r["wall"] for r in steady], 0.95),
                "lag_s_median": statistics.median(steady_lags),
                "lag_s_p95": pct(steady_lags, 0.95),
                "storm": {"vas": c.variants, "wall_ms": storm_row["wall"],
                          "lanes": sum(storm_row["lanes"]),
                          "launches": storm_row["launches"],
                          "lag_s_max": max(storm_row["lags"], default=None),
                          "debounce_ms_base": base_debounce * 1e3,
                          "debounce_ms_after": storm_row["debounce_ms"]},
                "valve": {"wall_ms": rows[-1]["wall"],
                          "launches": rows[-1]["launches"]},
                "shed": shed,
                "quarantined": {k: v for k, v in shed.items()
                                if k.startswith("quarantine")},
                "failed_cycles": core.failures["cycle"],
                "failures": dict(core.failures), "equal": True,
            }
            log(json.dumps(summary9a))

            # 9b: a checkpoint, and a fresh reconciler + core from it
            path = os.path.join(workdir, "stream.ckpt")
            with env("WVA_STREAM_CHECKPOINT", path):
                t0 = time.perf_counter()
                core._maybe_checkpoint()
                save_ms = (time.perf_counter() - t0) * 1e3
                if b.emitter.value("inferno_stream_checkpoint_total",
                                   event="save") != 1.0 \
                        or core.failures["checkpoint_save"]:
                    raise AssertionError("9b: the checkpoint was not saved")
                b2 = rc.build(rc.PORT, c, wall_clock, load, device="cuda")
                for key, va in b.kube.vas.items():
                    b2.kube.vas[key] = copy.deepcopy(va)
                t0 = time.perf_counter()
                core2 = stream.StreamCore(b2.rec, clock=clock)
                restore_ms = (time.perf_counter() - t0) * 1e3
            b2.rec.stream_core = core2
            door2 = stream.remote_write_middleware(core2)(
                lambda _e, _s: [b""])
            if b2.emitter.value("inferno_stream_checkpoint_total",
                                event="restore") != 1.0 \
                    or b2.rec.state.cycle_index != b.rec.state.cycle_index \
                    or core2.process_once():
                raise AssertionError("9b: the core did not restore warm")
            batches2 = dict(batches)
            restart_rows = []
            for rnd in range(1, STREAM_RESTART_ROUNDS + 1):
                wall_clock.advance(1.0)
                keys = pick_changes(rc, c, load, rng, STREAM_CHANGED)
                for x in (b, b2):
                    rc.set_loads(x, load)
                body = write_body(load, keys, wall_clock.now() * 1e3)
                out = [stream_round(k, d, body, clock, spy, bt, lags)
                       for k, d, bt in ((core, door, batches),
                                        (core2, door2, batches2))]
                for x in out:
                    if len(x[0]) != 1:
                        raise AssertionError(f"9b round {rnd}: {len(x[0])} "
                                             f"cycles")
                if out[0][0][0].processed != out[1][0][0].processed:
                    raise AssertionError(f"9b round {rnd}: the restarted "
                                         f"core processed other VAs")
                # a restarted emitter holds the series of the VAs it has
                # re-solved since; the published status covers every VA
                got = stream_view(rc, b2, c, batches2)
                want = stream_view(rc, b, c, batches)
                hold_views(f"9b round {rnd}", got, {
                    k: v if got[k][4] is not None else v[:4] + (None,)
                    for k, v in want.items()})
                restart_rows.append(out[1])
                log(f"    9b round {rnd}: restarted core wall "
                    f"{out[1][1]:.3f} ms (un-restarted {out[0][1]:.3f}), "
                    f"launches {out[1][2]}; equal=True")
            if any(core2.failures.values()):
                raise AssertionError(f"9b: failures {core2.failures}")
            log(json.dumps({
                "phase": "9b", "card": card, "checkpoint_save_ms": save_ms,
                "checkpoint_bytes": os.path.getsize(path),
                "restore_ms": restore_ms, "rounds": len(restart_rows),
                "micro_cycle_ms": [r[1] for r in restart_rows],
                "launches": [r[2] for r in restart_rows],
                "failures": dict(core2.failures), "equal": True}))
            del b, b2, ref, core, core2
            gc.collect()
        process_phase(card, rc, c, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return [r["launches"] for r in steady]


def write_manifests(rc, c, load, directory) -> None:
    """The fleet as dev-mode manifests (JSON documents, which YAML reads):
    the three ConfigMaps, the Deployments and the VariantAutoscalings."""
    from workload_variant_autoscaler_tpu_torch.controller.crd import (
        va_to_dict,
    )

    b = rc.build(rc.PORT, c, rc.Clock(), load, device="cpu")
    docs = [{"apiVersion": "v1", "kind": "ConfigMap",
             "metadata": {"name": cm.name, "namespace": cm.namespace},
             "data": dict(cm.data)} for cm in b.kube.configmaps.values()]
    docs += [{"apiVersion": "apps/v1", "kind": "Deployment",
              "metadata": {"name": d.name, "namespace": d.namespace},
              "spec": {"replicas": d.spec_replicas}}
             for d in b.kube.deployments.values()]
    docs += [va_to_dict(va) for va in b.kube.vas.values()]
    with open(os.path.join(directory, "fleet.yaml"), "w",
              encoding="utf-8") as fh:
        fh.write("\n---\n".join(json.dumps(d) for d in docs))


class PromShim:
    """A Prometheus HTTP API on localhost answering /api/v1/query (and
    /api/v1/query_range, each sample as a one-point series) from the
    port's FakePromAPI."""

    def __init__(self, prom):
        import http.server
        import threading
        import urllib.parse

        shim = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — the stdlib's handler name
                url = urllib.parse.urlparse(self.path)
                query = urllib.parse.parse_qs(url.query).get("query", [""])[0]
                with shim.lock:
                    samples = prom.query(query)
                if url.path == "/api/v1/query":
                    data = {"resultType": "vector", "result": [
                        {"metric": s.labels, "value": [s.timestamp,
                                                       repr(s.value)]}
                        for s in samples]}
                elif url.path == "/api/v1/query_range":
                    data = {"resultType": "matrix", "result": [
                        {"metric": s.labels, "values": [[s.timestamp,
                                                         repr(s.value)]]}
                        for s in samples]}
                else:
                    self.send_error(404)
                    return
                body = json.dumps({"status": "success",
                                   "data": data}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *_a):
                pass

        self.lock = threading.Lock()
        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(url: str, timeout: float = 10.0):
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except OSError:
        return None, ""


def scraped_desired(text: str) -> dict:
    out = {}
    for ln in text.splitlines():
        m = re.match(r'inferno_desired_replicas\{(.*)\} (\S+)$', ln)
        if m:
            lab = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1)))
            out[(lab["variant_name"], lab["namespace"])] = (
                lab["accelerator_type"], float(m.group(2)))
    return out


def polled_reference(rc, c, load) -> dict:
    """(variant, namespace) -> (accelerator, inferno_desired_replicas) of
    one polled full pass on the card over `load` (STREAM_REFERENCE): what
    a controller process must publish."""
    ref = rc.build(rc.PORT, dataclasses.replace(
        c, operator=STREAM_REFERENCE), rc.Clock(), load, device="cuda")
    ref.rec.reconcile()
    want = {}
    for (_s, labels), value in rc.samples(
            ref.emitter, ("inferno_desired_replicas",)).items():
        lab = dict(labels)
        want[(lab["variant_name"], lab["namespace"])] = (
            lab["accelerator_type"], value)
    return want


def start_controller(penv, cwd, manifests, log_path, health_port,
                     metrics_port):
    """`python -m workload_variant_autoscaler_tpu_torch.controller` in dev
    mode over `manifests`, from `cwd`, its output into `log_path`."""
    with open(log_path, "w", encoding="utf-8") as out:
        return subprocess.Popen(
            [sys.executable, "-m",
             "workload_variant_autoscaler_tpu_torch.controller",
             "--kube-manifests", manifests, "--leader-elect",
             "--allow-http-prom", "--metrics-addr", "127.0.0.1",
             "--metrics-port", str(metrics_port),
             "--health-port", str(health_port)],
            env=penv, cwd=cwd, stdout=out, stderr=subprocess.STDOUT)


def log_lines(path: str) -> list:
    """The JSON lines of a controller's log."""
    with open(path, encoding="utf-8") as fh:
        return [json.loads(ln) for ln in fh if ln.startswith("{")]


def process_phase(card, rc, c, workdir) -> None:
    """9c: the controller process in dev mode on the card (WVA_PLATFORM
    unset), fed by pushed remote-write rounds; every VA's scraped
    inferno_desired_replicas must equal an in-process polled reference on
    the final loads, and SIGTERM must end it with 0."""
    import signal
    import urllib.request

    load = rc.loads(c)
    manifests = os.path.join(workdir, "manifests")
    os.makedirs(manifests)
    write_manifests(rc, c, load, manifests)
    feed = rc.Built(pkg=rc.PORT, kube=None,
                    prom=rc.modules(rc.PORT)["col"].FakePromAPI(),
                    emitter=None, rec=None, mods=rc.modules(rc.PORT))
    rc.set_loads(feed, load)
    shim = PromShim(feed.prom)
    metrics_port, health_port = free_port(), free_port()
    penv = {k: v for k, v in os.environ.items()
            if k not in ("WVA_PLATFORM", "LOG_LEVEL")}
    penv.update(PROMETHEUS_BASE_URL=shim.url, **PROCESS_ENV)
    log_path = os.path.join(workdir, "controller.log")
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = None
    try:
        t_start, wall_start = time.perf_counter(), time.time()
        proc = start_controller(penv, repo, manifests, log_path,
                                health_port, metrics_port)

        def alive():
            if proc.poll() is not None:
                with open(log_path, encoding="utf-8") as fh:
                    tail = fh.read()[-4000:]
                raise AssertionError(f"9c: the process exited with "
                                     f"{proc.returncode}:\n{tail}")

        deadline = time.perf_counter() + PROCESS_READY_S
        while http_get(f"http://127.0.0.1:{health_port}/readyz",
                       2.0)[0] != 200:
            alive()
            if time.perf_counter() > deadline:
                raise AssertionError("9c: /readyz never answered 200")
            time.sleep(0.1)
        t_ready = time.perf_counter() - t_start
        base = f"http://127.0.0.1:{metrics_port}"
        while len(scraped_desired(http_get(base + "/metrics")[1])) \
                < c.variants:
            alive()
            if time.perf_counter() > deadline:
                raise AssertionError("9c: the first full pass never "
                                     "published every VA")
            time.sleep(0.2)
        t_first = time.perf_counter() - t_start
        # the rounds' loads, and the polled reference on the final ones,
        # before the first push, so the timing below holds only the
        # process's work
        rng = np.random.default_rng(SEED + 13)
        rounds = []
        for _ in range(PROCESS_ROUNDS):
            keys = pick_changes(rc, c, load, rng, STREAM_CHANGED)
            rounds.append((keys, copy.deepcopy(load)))
        changed = {k for keys, _l in rounds for k in keys}
        want = polled_reference(rc, c, load)
        t_post = time.perf_counter()
        for keys, round_load in rounds:
            with shim.lock:
                rc.set_loads(feed, round_load)
            req = urllib.request.Request(
                base + "/api/v1/write",
                data=write_body(round_load, keys, time.time() * 1e3),
                headers={"Content-Encoding": "snappy"}, method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                if r.status != 204:
                    raise AssertionError(f"9c: the door answered "
                                         f"{r.status}")
            time.sleep(0.2)
        got = {}
        match_deadline = time.perf_counter() + 120.0
        while got != want:
            alive()
            if time.perf_counter() > match_deadline:
                diff = sorted(k for k in want if got.get(k) != want[k])
                raise AssertionError(
                    f"9c: {len(diff)} VAs' inferno_desired_replicas differ "
                    f"from the reference, e.g. {diff[:1]}: "
                    f"{[got.get(k) for k in diff[:1]]} != "
                    f"{[want[k] for k in diff[:1]]}")
            got = scraped_desired(http_get(base + "/metrics")[1])
            if got != want:
                time.sleep(0.1)
        t_match = time.perf_counter() - t_post
        _s, text = http_get(base + "/debug/decisions?limit=100000")
        records = json.loads(text)["decisions"]
        streamed = {(d["variant"], d["namespace"]) for d in records
                    if d["inputs"]["collection_mode"] == "stream"}
        want_streamed = {rc.va_key(i, c) for i in range(c.variants)
                         if (rc.model_of(i, c), rc.va_key(i, c)[1])
                         in changed}
        if not want_streamed <= streamed:
            raise AssertionError(f"9c: {len(want_streamed - streamed)} "
                                 f"changed VAs have no streamed record")
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc_term = proc.wait(timeout=30)
        t_exit = time.perf_counter() - t_term
        if rc_term != 0:
            raise AssertionError(f"9c: the process exited {rc_term} on "
                                 f"SIGTERM")
        lines = log_lines(log_path)

        def first(msg):
            found = [ln for ln in lines if ln.get("msg") == msg]
            return found[0] if found else None

        failed = [ln["msg"] for ln in lines if ln.get("msg") in (
            "stream cycle failed", "stream consumer iteration failed",
            "stream checkpoint save failed", "engine warmup launch failed")]
        pinned, built = first("device platform pinned"), first(
            "kernel library loaded")
        warmed = first("engine kernels warmed")
        if failed or pinned is None or warmed is None \
                or warmed["failures"] != 0 \
                or (pinned["device"] != "cpu" and built is None):
            raise AssertionError(f"9c: the log holds failures {failed[:3]}, "
                                 f"device line {pinned}, warm-up {warmed}")
        log(f"  9c device line: {json.dumps(pinned)}")
        # seconds from the start to each startup step's log line
        milestones = {msg: round(found["ts"] - wall_start, 3)
                      for msg in ("device platform pinned",
                                  "dev mode: in-memory apiserver from "
                                  "manifests",
                                  "health probe server started",
                                  "kernel library loaded",
                                  "validating Prometheus connectivity",
                                  "metrics server started",
                                  "acquired leader lease (created)",
                                  "starting reconcile loop",
                                  "engine kernels warmed")
                      if (found := first(msg)) is not None}
        log(json.dumps({
            "phase": "9c", "card": card, "variants": c.variants,
            "device": pinned["device"], "device_name": pinned["name"],
            "library_load_s": built["seconds"] if built else None,
            "warmup_s": warmed["seconds"],
            "ready_s": t_ready, "first_full_publish_s": t_first,
            "startup_log_s": milestones,
            "rounds": PROCESS_ROUNDS,
            "first_post_to_last_matching_sample_s": t_match,
            "streamed_records": len(streamed), "sigterm_exit_s": t_exit,
            "exit_code": rc_term, "equal": True}))
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        shim.stop()


def quiet_wva_loggers(level) -> None:
    import logging

    for name in list(logging.root.manager.loggerDict):
        if name.startswith("wva"):
            logging.getLogger(name).setLevel(level)


def twin_library() -> dict:
    from workload_variant_autoscaler_tpu_torch.emulator import scenarios

    return {**scenarios.SCENARIOS, **scenarios.STREAMING_SCENARIOS,
            **scenarios.ADVERSARIAL_SCENARIOS}


def twin_signature():
    """tests/twin_signature.py (signature, differences, text), shared
    with the port's twin tests."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import twin_signature as ts

    return ts


def twin_job(name: str, device: str, dtype_name: str, duration_s: float):
    """One twin run of `duration_s` sim seconds (the scenario's own in
    the smoke), in a worker process: (name, device, dtype, signature,
    launches, wall s)."""
    import logging

    from workload_variant_autoscaler_tpu_torch.emulator import twin
    from workload_variant_autoscaler_tpu_torch.emulator.scenarios import (
        abbreviated)
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    torch.set_num_threads(1)
    quiet_wva_loggers(logging.CRITICAL)
    ts = twin_signature()
    bk.reset_launches()
    t0 = time.perf_counter()
    result = twin.run_scenario(
        abbreviated(twin_library()[name], duration_s), device=device,
        dtype=getattr(torch, dtype_name))
    wall = time.perf_counter() - t0
    return (name, device, dtype_name, ts.signature(result),
            dict(bk.launches), wall)


@contextlib.contextmanager
def reconcile_walls():
    """For the block's duration, the wall of every Reconciler.reconcile
    call (polled cycles and the streaming core's micro-cycles), in ms,
    synchronized with the card."""
    from workload_variant_autoscaler_tpu_torch.controller import reconciler

    walls: list = []
    orig = reconciler.Reconciler.reconcile

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(self, *args, **kwargs)
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            walls.append((time.perf_counter() - t0) * 1e3)

    reconciler.Reconciler.reconcile = timed
    try:
        yield walls
    finally:
        reconciler.Reconciler.reconcile = orig


def plan_options(fits: int, seed: int) -> list:
    """The planner's options: `fits` draws of build_fleet's recipe (the
    Llama-3.1-8B fit scaled by the slice's speed) on every default slice
    shape, then an option whose ITL floor is above the target and one with
    no batch slot."""
    from workload_variant_autoscaler_tpu_torch import planner
    from workload_variant_autoscaler_tpu_torch.models.chips import DEFAULT_SLICES

    rng = np.random.default_rng(seed)
    out = []
    for s, acc in enumerate(DEFAULT_SLICES):
        for _ in range(fits):
            u = rng.uniform(0.8, 1.25, 4)
            f = PLAN_SPEED[s] * rng.uniform(0.95, 1.05)
            out.append(planner.SliceOption(
                acc=acc.name, cost=float(acc.cost),
                alpha=float(6.973 * u[0] * f), beta=float(0.027 * u[1] * f),
                gamma=float(5.2 * u[2] * f), delta=float(0.1 * u[3] * f),
                max_batch=int(rng.choice([64, 128, 256]))))
    out.append(planner.SliceOption("itl-floor", 5.0, 30.0, 0.1, 5.0, 0.1, 64))
    out.append(planner.SliceOption("no-slot", 5.0, 6.0, 0.02, 5.0, 0.1, 0))
    return out


def plan_rows_equal(ref, mine) -> None:
    import math

    if [(r.acc, r.feasible, r.replicas, r.reason) for r in ref] != \
            [(r.acc, r.feasible, r.replicas, r.reason) for r in mine]:
        raise AssertionError("planner rows: order, feasibility or "
                             "replicas differ between the card and the CPU")
    for a, b in zip(ref, mine):
        for k, v in dataclasses.asdict(a).items():
            w = getattr(b, k)
            if isinstance(v, float) and not (
                    v == w or math.isclose(v, w, rel_tol=RTOL_F64)):
                raise AssertionError(f"planner row {a.acc} {k}: {v} vs {w}")


def planner_phase(card) -> dict:
    """10d: the planner on the card against the CPU (float64), its times
    (float32), and its CLI as a subprocess with WVA_PLATFORM unset;
    returns the launches of one tail-form plan on the card."""
    from workload_variant_autoscaler_tpu_torch import planner
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk
    from workload_variant_autoscaler_tpu_torch.ops.analyzer import TargetPerf

    opts = plan_options(PLAN_FITS, SEED + 11)
    target = TargetPerf(ttft=500.0, itl=24.0)
    per_plan = {}
    for pct_ in (None, TAIL_PCT):
        ref = planner.plan(opts, target, PLAN_RATE, 128, 128, pct_,
                           device="cpu", dtype=torch.float64)
        bk.reset_launches()
        mine = planner.plan(opts, target, PLAN_RATE, 128, 128, pct_,
                            device=TWIN_DEVICE, dtype=torch.float64)
        launched = dict(bk.launches)
        plan_rows_equal(ref, mine)
        if pct_ is not None and (launched["mean"] < 1 or launched["tail"] < 1):
            raise AssertionError(f"the tail-form plan launched {launched}")
        walls = {}
        for dev in (TWIN_DEVICE, "cpu"):
            times = []
            for _ in range(PLAN_REPS):
                t0 = time.perf_counter()
                planner.plan(opts, target, PLAN_RATE, 128, 128, pct_,
                             device=dev, dtype=torch.float32)
                times.append((time.perf_counter() - t0) * 1e3)
            walls[dev] = statistics.median(times)
        form = "mean" if pct_ is None else f"p{int(pct_ * 100)}"
        per_plan[form] = {"B1": launched["mean"], "B2": launched["tail"]}
        log(json.dumps({
            "phase": "10d", "card": card, "form": form,
            "options": len(opts), "feasible": sum(r.feasible for r in mine),
            "launches": per_plan[form], "equal_float64": True,
            "plan_ms_card_float32": walls[TWIN_DEVICE],
            "plan_ms_cpu_float32": walls["cpu"]}))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profiles.yaml")
        with open(path, "w") as f:
            for o in opts:
                f.write(f"- {{acc: {o.acc}, cost: {o.cost!r}, alpha: "
                        f"{o.alpha!r}, beta: {o.beta!r}, gamma: {o.gamma!r}, "
                        f"delta: {o.delta!r}, maxBatch: {o.max_batch}}}\n")
        env_ = {k: v for k, v in os.environ.items() if k != "WVA_PLATFORM"}
        env_.update(PROCESS_ENV)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "workload_variant_autoscaler_tpu_torch"
             ".planner", "--profiles", path, "--rate", str(PLAN_RATE),
             "--slo-ttft", "500", "--slo-itl", "24", "--ttft-percentile",
             str(TAIL_PCT), "--json"],
            env=env_, cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"planner CLI exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    rows = json.loads(out.stdout)
    same = rows == [dataclasses.asdict(r) for r in planner.plan(
        opts, target, PLAN_RATE, 128, 128, TAIL_PCT, device=TWIN_DEVICE,
        dtype=torch.float32)]
    if not same:
        raise AssertionError("the planner CLI's rows differ from plan() "
                             "on the card")
    log(json.dumps({"phase": "10d", "card": card, "cli": "planner --json "
                    "--ttft-percentile", "exit_code": 0, "rows": len(rows),
                    "equal_to_plan_on_card": True, "wall_s": cli_s}))
    return per_plan


def twin_phase(card) -> dict:
    """Phase 10 (10a-10d); returns the B1/B2 launches per twin cycle and
    per plan for the kernels line."""
    import logging

    from workload_variant_autoscaler_tpu_torch.emulator import twin
    from workload_variant_autoscaler_tpu_torch.emulator.scenarios import (
        ADVERSARIAL_SCENARIOS, SCENARIOS)
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    quiet_wva_loggers(logging.CRITICAL)
    ts = twin_signature()
    library = twin_library()
    jobs = [(n, dev, "float64", library[n].duration_s) for n in TWIN_F64
            for dev in (TWIN_DEVICE, "cpu")]
    jobs.append((TWIN_RERUN, TWIN_DEVICE, "float32",
                 library[TWIN_RERUN].duration_s))
    # a worker that dies fails its future at once (BrokenProcessPool)
    pool = spawn_pool(TWIN_WORKERS)
    try:
        pending = [pool.submit(twin_job, *job) for job in jobs]
        t10a = time.perf_counter()
        b1 = b2 = cycles = 0
        mine = {}
        for name, scenario in library.items():
            if name in SCENARIOS and name != TWIN_RERUN:
                continue        # phase 14a's bench_torch_goodput runs it
            kind = ("SCENARIOS" if name in SCENARIOS else "ADVERSARIAL"
                    if name in ADVERSARIAL_SCENARIOS else "STREAMING")
            bk.reset_launches()
            with reconcile_walls() as walls:
                t0 = time.perf_counter()
                result = twin.run_scenario(scenario, device=TWIN_DEVICE,
                                           dtype=torch.float32)
                wall = time.perf_counter() - t0
            launched = dict(bk.launches)
            d = result.to_dict()
            if launched["mean"] < 1:
                raise AssertionError(f"{name}: B1 was not launched")
            if not (0.0 <= d["goodput_fraction"] <= 1.0
                    and 0.0 <= d["slo_attainment"] <= 1.0
                    and d["cost_dollar_seconds"] > 0.0 and result.cycles > 0):
                raise AssertionError(f"{name}: bad score sheet {d}")
            if name == TWIN_RERUN:
                mine[name] = ts.signature(result)
            b1 += launched["mean"]
            b2 += launched["tail"]
            cycles += result.cycles
            log(json.dumps({
                "phase": "10a", "card": card, "scenario": name,
                "library": kind, "dtype": "float32",
                "duration_s": scenario.duration_s,
                "goodput_fraction": d["goodput_fraction"],
                "goodput_floor": scenario.goodput_floor,
                "slo_attainment": d["slo_attainment"],
                "cycles": result.cycles, "raised_cycles": d["raised_cycles"],
                "fault_trips": d["fault_trips"],
                "launches": {"B1": launched["mean"], "B2": launched["tail"]},
                "reconcile_calls": len(walls), "wall_s": wall,
                "reconcile_ms_median": statistics.median(walls),
                "reconcile_ms_p95": pct(walls, 0.95)}))
        log(f"  10a: {len(library) - len(SCENARIOS) + 1} scenarios in "
            f"{time.perf_counter() - t10a:.1f} s")
        results = [p.result(timeout=900) for p in pending]
    finally:
        stop_pool(pool)
    by = {(n, dev, dt): (sig, launched, wall)
          for n, dev, dt, sig, launched, wall in results}
    for name in TWIN_F64:
        card_sig, launched, card_wall = by[(name, TWIN_DEVICE, "float64")]
        cpu_sig, _, cpu_wall = by[(name, "cpu", "float64")]
        diff = ts.differences(cpu_sig, card_sig, RTOL_F64)
        if diff:
            raise AssertionError(f"10b {name}: the card's float64 twin "
                                 f"differs from the CPU's: {diff}")
        if launched["mean"] < 1:
            raise AssertionError(f"10b {name}: B1 was not launched")
        log(json.dumps({
            "phase": "10b", "card": card, "scenario": name,
            "dtype": "float64", "equal": True,
            "goodput_fraction": card_sig["result"]["goodput_fraction"],
            "cycles": card_sig["result"]["cycles"],
            "decisions": len(card_sig["decisions"]),
            "ticks": len(card_sig["ticks"]),
            "launches": {"B1": launched["mean"], "B2": launched["tail"]},
            "wall_s_card": card_wall, "wall_s_cpu": cpu_wall}))
    again, _, rerun_wall = by[(TWIN_RERUN, TWIN_DEVICE, "float32")]
    same = ts.text(again) == ts.text(mine[TWIN_RERUN])
    log(json.dumps({"phase": "10c", "card": card, "scenario": TWIN_RERUN,
                    "dtype": "float32", "byte_identical": same,
                    "bytes": len(ts.text(again)), "wall_s": rerun_wall}))
    if not same:
        raise AssertionError(f"10c {TWIN_RERUN}: a rerun on the card is "
                             "not byte-identical")
    per_plan = planner_phase(card)
    return {"per_twin_cycle": {"B1": b1 / cycles, "B2": b2 / cycles},
            "per_plan": per_plan}


def host_backend_job(backend: str, n_variants: int, n_small: int,
                     seed: int, reps: int) -> dict:
    """Phase 11a's host work for one host backend, in a worker process
    (no card): its decisions on build_fleet(n_small) in float64, and
    System.calculate at n_variants x 8 lanes, ms, `reps` times (the
    scalar path's analyzer is the native one, as the port picks it with
    WVA_NATIVE_KERNEL unset)."""
    torch.set_num_threads(1)
    system, opt = make_system(build_fleet(n_small, seed + 1), "cpu",
                              torch.float64)
    cycle(system, opt, backend)
    out: dict = {"small": decisions(system), "walls": []}
    spec = build_fleet(n_variants, seed)
    for _ in range(reps):
        system, _opt = make_system(spec, "cpu", torch.float64)
        t0 = time.perf_counter()
        system.calculate(backend=backend)
        out["walls"].append((time.perf_counter() - t0) * 1e3)
    out["lanes"] = system.last_solve_lanes
    return out


def lane_errors(a, b) -> tuple[float, float]:
    """Worst relative TTFT and max-rate errors between the candidate
    allocations of two Systems over the lanes both hold."""
    ttft = rate = 0.0
    for name, server in a.servers.items():
        other = b.servers[name].all_allocations
        for acc, x in server.all_allocations.items():
            y = other.get(acc)
            if y is None or not y.ttft:
                continue
            ttft = max(ttft, abs(x.ttft - y.ttft) / abs(y.ttft))
            rate = max(rate, abs(x.max_arrv_rate_per_replica
                                 - y.max_arrv_rate_per_replica)
                       / abs(y.max_arrv_rate_per_replica))
    return ttft, rate


def synced_ms(fn, reps: int) -> list:
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def native_phase(card) -> dict:
    """11a on the card: build the native library, native against the
    kernel at 4096 lanes (float64), the kernel's calculate times, and
    NATIVE_RECON_CYCLES reconcile cycles with WVA_NATIVE_KERNEL=true
    against the kernel reconciler (float64). Returns the summary."""
    from workload_variant_autoscaler_tpu_torch.ops import _build, native
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native host library did not build: "
                             f"{_build.build_logs.get('wva_queueing')}")
    build_s = time.perf_counter() - t0
    built = _build.build_logs.get("wva_queueing", "")
    log(f"  11a: native library {'built' if built else 'loaded'} in "
        f"{build_s:.3f} s: {built.splitlines()[0] if built else 'cached'}")
    spec = build_fleet(N_VARIANTS, SEED)
    nat, onat = make_system(spec, MESH_DEVICE, torch.float64)
    ker, oker = make_system(spec, MESH_DEVICE, torch.float64)
    bk.reset_launches()
    cycle(nat, onat, "native")
    torch.cuda.synchronize()
    nat_launches = dict(bk.launches)
    cycle(ker, oker, "kernel")
    if nat_launches != {"mean": 0, "tail": 0}:
        raise AssertionError(f"the native cycle launched {nat_launches}")
    diff = [n for n, d in decisions(ker).items() if decisions(nat)[n] != d]
    ttft_err, rate_err = lane_errors(nat, ker)
    log(f"  11a: native against kernel, float64, {nat.last_solve_lanes} "
        f"lanes: {len(diff)} of {len(nat.servers)} servers differ; worst "
        f"lane TTFT rel err {ttft_err:.3e}, rate rel err {rate_err:.3e}")
    if diff or not nat.generate_solution().allocations:
        raise AssertionError(f"native decisions differ from the kernel's: "
                             f"{diff[:5]}")
    kernel_ms = synced_ms(lambda: ker.calculate(backend="kernel"),
                          NATIVE_REPS)

    rc = reconcile_cluster()
    c = rc.Cluster(variants=RECON_VARIANTS, namespaces=RECON_NAMESPACES,
                   models=RECON_VARIANTS, profiles=8, percentile=TAIL_PCT,
                   operator=RECON_OPERATOR, seed=SEED + 5)
    clock = rc.Clock()
    load = rc.loads(c)
    pair = (rc.build(rc.PORT, c, clock, load, device=MESH_DEVICE,
                     dtype=torch.float64),
            rc.build(rc.PORT, c, clock, load, device=MESH_DEVICE,
                     dtype=torch.float64))
    rng = np.random.default_rng(SEED + 14)
    walls = {"native": [], "kernel": []}
    with batch_spy() as spy:
        for n in range(1, NATIVE_RECON_CYCLES + 1):
            for b in pair:
                rc.set_loads(b, load)
            with env("WVA_NATIVE_KERNEL", "true"):
                out_n = recon_cycle(pair[0], spy)
            with env("WVA_NATIVE_KERNEL", "false"):
                out_k = recon_cycle(pair[1], spy)
            hold_equal(f"11a reconcile cycle {n}", rc, c, pair,
                       (out_n, out_k))
            backend = pair[0].rec._solve_engine_obj._analyze_sig[0]
            if out_n[3] != {"B1": 0, "B2": 0} or backend != "native":
                raise AssertionError(f"11a cycle {n}: the native reconciler "
                                     f"ran {backend}, launches {out_n[3]}")
            if n == 1 and (out_k[3]["B1"] < 1 or out_k[3]["B2"] < 1):
                raise AssertionError(f"11a: the kernel reconciler launched "
                                     f"{out_k[3]}")
            walls["native"].append(out_n[1])
            walls["kernel"].append(out_k[1])
            log(f"    11a reconcile cycle {n}: native {out_n[1]:.3f} ms "
                f"(launches {out_n[3]}), kernel {out_k[1]:.3f} ms "
                f"(launches {out_k[3]}); processed {len(out_n[0].processed)}"
                f"; equal=True")
            clock.advance(60.0)
            rc.churn(load, RECON_CHURN, rng)
    return {"build_s": build_s, "lanes": nat.last_solve_lanes,
            "servers_differ": 0, "ttft_rel_err": ttft_err,
            "rate_rel_err": rate_err, "kernel_calculate_ms": kernel_ms,
            "reconcile_ms": walls}


def mesh_engines(label, fleet, seed, make, mesh, restart_path=None):
    """MESH_CYCLES churned cycles (hier_specs, unlimited) through an
    engine on `mesh` and an unsharded one (float32, the kernels), held
    equal every cycle. With `restart_path`, the mesh engine checkpoints
    on its last cycle; a new engine restored from it runs the last spec
    again (it must solve no lane), then both the restored and the
    unsharded engine run one more churned cycle, held equal. Returns
    (the mesh engine's cycle walls, the unsharded one's, the engines,
    the restart record)."""
    from workload_variant_autoscaler_tpu_torch import Manager, Optimizer

    def run(spec, engine, m):
        system, opt = make_system(spec, MESH_DEVICE, torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = engine.calculate(system, backend="kernel", fleet_mesh=m,
                                 optimizer_spec=opt)
        Manager(system, Optimizer(opt)).optimize(warm=engine.warm_start())
        sol = system.generate_solution()
        engine.finish_cycle(system)
        torch.cuda.synchronize()
        return sol, stats, (time.perf_counter() - t0) * 1e3

    sharded = make(restart_path)
    plain = make(None)
    specs = list(hier_specs(fleet, MESH_CYCLES + 1, seed))
    walls = ([], [])
    for c, spec in specs[:MESH_CYCLES]:
        sol_m, stats, wall_m = run(spec, sharded, mesh)
        sol_p, _stats, wall_p = run(spec, plain, None)
        if sol_m != sol_p:
            raise AssertionError(f"{label} cycle {c}: the engine on the "
                                 f"lane mesh differs from the unsharded one")
        walls[0].append(wall_m)
        walls[1].append(wall_p)
        log(f"    {label} cycle {c}: lanes solved {stats.lanes_solved} "
            f"skipped {stats.lanes_skipped}, mesh {wall_m:.3f} ms, "
            f"unsharded {wall_p:.3f} ms; equal=True")
    restart = None
    if restart_path is not None:
        restored = make(restart_path)
        if restored.ckpt_events["restore"] != 1 \
                or restored._restored_arena_mesh != mesh.size:
            raise AssertionError(f"{label}: no lane-mesh restore "
                                 f"{restored.ckpt_events}")
        sol_r, stats, wall_r = run(specs[MESH_CYCLES - 1][1], restored, mesh)
        if not stats.restored or stats.lanes_solved:
            raise AssertionError(f"{label}: the restored engine solved "
                                 f"{stats.lanes_solved} lanes")
        c, spec = specs[MESH_CYCLES]
        sol_n, stats_n, wall_n = run(spec, restored, mesh)
        sol_p, _stats, _wall = run(spec, plain, None)
        if sol_n != sol_p:
            raise AssertionError(f"{label}: the restored engine's next "
                                 f"cycle differs from the unsharded one")
        # each shard arena built after the restore holds the checkpoint's
        # slabs (one per lane bucket it had packed), staged onto the mesh
        # once: no slab is uploaded whole a second time
        arenas = list(restored._shard_arenas.values())
        uploads = [a.full_uploads for a in arenas]
        slabs = [len(a._slabs) for a in arenas]
        if not arenas or uploads != slabs:
            raise AssertionError(f"{label}: shard arenas uploaded "
                                 f"{uploads} whole slabs for {slabs} slabs "
                                 f"after the restore")
        restart = {"restore_cycle_ms": wall_r, "next_cycle_ms": wall_n,
                   "next_lanes_solved": stats_n.lanes_solved,
                   "shard_arena_slabs": slabs,
                   "shard_arena_full_uploads": uploads,
                   "next_cycle_scatters": sum(a.scatter_packs
                                              for a in arenas)}
        log(f"    {label} restart from the arena_mesh={mesh.size} "
            f"checkpoint: restore cycle {wall_r:.3f} ms, 0 lanes; next "
            f"cycle {wall_n:.3f} ms, {stats_n.lanes_solved} lanes; shard "
            f"arenas' slabs {slabs}, each uploaded once {uploads}, "
            f"scatters {restart['next_cycle_scatters']}; equal=True")
    return walls, sharded, restart


def arena_counters(arenas) -> dict:
    keys = ("packs", "full_uploads", "scatter_packs", "noop_packs",
            "lanes_scattered")
    return {k: sum(getattr(a, k) for a in arenas) for k in keys}


def mesh_phase(card) -> dict:
    """11b on the card. Returns the summary (launches per sharded group
    included)."""
    from workload_variant_autoscaler_tpu_torch import (
        HierarchicalSolveEngine, IncrementalSolveEngine)
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk
    from workload_variant_autoscaler_tpu_torch.ops import fused
    from workload_variant_autoscaler_tpu_torch.ops.arena import (
        ShardedFleetArena)
    from workload_variant_autoscaler_tpu_torch.parallel import (
        Mesh, decide_batch_sharded)

    dev = Mesh((MESH_DEVICE,)).devices[0]
    lane = Mesh((dev,) * MESH_SHARDS, "lanes")
    cand = Mesh((dev,) * MESH_SHARDS, "candidates")
    spec = build_fleet(N_VARIANTS, SEED)
    per_group: dict = {}
    walls = {"unsharded": [], "lanes": []}
    for dt in (torch.float32, torch.float64):
        system, opt = make_system(spec, MESH_DEVICE, dt)
        _calls, groups = capture_launches(system, opt)
        del _calls
        for q, slo, epi, k_max, pct in groups:
            plain = fused.decide_batch(q, slo, epi, k_max, pct)
            for mesh in (lane, cand):
                bk.reset_launches()
                got = decide_batch_sharded(q, slo, epi, k_max, mesh,
                                           ttft_percentile=pct)
                torch.cuda.synchronize()
                launched = {"B1": bk.launches["mean"],
                            "B2": bk.launches["tail"]}
                want = {"B1": MESH_SHARDS,
                        "B2": MESH_SHARDS if pct is not None else 0}
                form = "p95" if pct is not None else "mean"
                if launched != want:
                    raise AssertionError(f"11b {form} group on the "
                                         f"{mesh.axis} mesh launched "
                                         f"{launched}, not {want}")
                if got.shape != plain.shape or not torch.equal(
                        bits(got), bits(plain)):
                    raise AssertionError(f"11b: the {str(dt)[6:]} {form} "
                                         f"group sharded over {mesh.axis} "
                                         "is not bit-identical")
                per_group[form] = launched
            if dt == torch.float32:
                walls["unsharded"].append(statistics.median(synced_ms(
                    lambda: fused.decide_batch(q, slo, epi, k_max, pct), 5)))
                walls["lanes"].append(statistics.median(synced_ms(
                    lambda: decide_batch_sharded(q, slo, epi, k_max, lane,
                                                 ttft_percentile=pct), 5)))
        log(f"  11b: decide_batch_sharded, {str(dt)[6:]}, "
            f"{system.last_solve_lanes} lanes in {len(groups)} groups, "
            f"{MESH_SHARDS}-entry lane and candidate meshes of the card: "
            f"bit-identical to decide_batch; launches per sharded group "
            f"{per_group}")
        del system, groups
    log(f"  11b: decide_batch per group (float32, median of 5, ms): "
        f"unsharded {walls['unsharded']}, lane mesh {walls['lanes']}")

    # the arena: a 2% scatter against a fresh upload, at 4096 lanes
    system, _opt = make_system(spec, MESH_DEVICE, torch.float32)
    rows = system._group_rows(system._candidate_pairs(), epilogue=True)
    arena = ShardedFleetArena(lane, dtype=torch.float32)
    arena.pack(rows, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(SEED + 15)
    churned = dict(rows, alpha=list(rows["alpha"]))
    for i in rng.choice(len(churned["alpha"]),
                        max(1, round(CHURN_SHARE * len(churned["alpha"]))),
                        replace=False):
        churned["alpha"][i] *= 1.01
    out = arena.pack(churned, device=dev, dtype=torch.float32)
    fresh = ShardedFleetArena(lane, dtype=torch.float32).pack(
        churned, device=dev, dtype=torch.float32)
    for tree_a, tree_b in zip(out, fresh):
        for part_a, part_b in zip(tree_a, tree_b):
            for a, b in zip(part_a, part_b):
                if not torch.equal(a, b):
                    raise AssertionError("11b: a scatter differs from a "
                                         "fresh upload")
    log(f"  11b: ShardedFleetArena at {len(rows['alpha'])} lanes: a "
        f"{CHURN_SHARE:.0%} scatter ({arena.lanes_scattered} lanes) equals "
        f"a fresh upload bit for bit; counters {arena_counters([arena])}")
    del system

    flat_walls, flat, _r = mesh_engines(
        "11b flat", build_fleet(N_VARIANTS, SEED + 12), SEED + 13,
        lambda _path: IncrementalSolveEngine(), lane)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "arena.ckpt")
        hier_walls, hier, restart = mesh_engines(
            "11b hierarchical", build_fleet(MESH_HIER_VARIANTS, SEED + 16),
            SEED + 17, lambda p: HierarchicalSolveEngine(
                checkpoint_path=p, checkpoint_every=MESH_CYCLES), lane,
            restart_path=path)
    flat_counts = arena_counters([flat._fleet_arena])
    hier_counts = arena_counters(hier._shard_arenas.values())
    log(f"  11b: arena counters after the churn: flat {flat_counts}, "
        f"hierarchical ({len(hier._shard_arenas)} shard arenas) "
        f"{hier_counts}")
    steady = {
        "flat_mesh_ms": statistics.median(flat_walls[0][1:]),
        "flat_unsharded_ms": statistics.median(flat_walls[1][1:]),
        "hier_mesh_ms": statistics.median(hier_walls[0][1:]),
        "hier_unsharded_ms": statistics.median(hier_walls[1][1:]),
    }
    log(f"  11b: steady cycles (median of {MESH_CYCLES - 1}), ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in steady.items()))
    return {"launches_per_sharded_group": per_group,
            "decide_ms": walls, "steady": steady,
            "first_cycle_ms": {"flat": [w[0] for w in flat_walls],
                               "hier": [w[0] for w in hier_walls]},
            "arena": {"flat": flat_counts, "hier": hier_counts},
            "restart": restart}


def knob_phase() -> dict:
    """11c: the mesh knobs on this host's cards."""
    from workload_variant_autoscaler_tpu_torch.controller import translate
    from workload_variant_autoscaler_tpu_torch.parallel import fleet_mesh

    cards = torch.cuda.device_count()
    fm = fleet_mesh(device=MESH_DEVICE)
    with env("WVA_SHARDED_FLEET", "on"):
        on = translate.sharded_fleet_mesh("kernel", MESH_DEVICE)
    if cards == 1 and (fm is not None or on is not None):
        raise AssertionError("11c: a lane mesh on a one-card host")
    with env("WVA_MESH_DEVICES", "1"):
        one = translate.engine_mesh("kernel", MESH_DEVICE)
    if one is None or one.size != 1 or one.axis != "candidates":
        raise AssertionError(f"11c: WVA_MESH_DEVICES=1 gave {one}")
    spec = build_fleet(N_VARIANTS, SEED)
    lanes = []
    for mesh in (one, None):
        system, _opt = make_system(spec, MESH_DEVICE, torch.float32)
        system.calculate(backend="kernel", mesh=mesh)
        lanes.append({(n, a): (x.num_replicas, x.cost, x.itl, x.ttft, x.rho)
                      for n, s in system.servers.items()
                      for a, x in s.all_allocations.items()})
    if lanes[0] != lanes[1]:
        raise AssertionError("11c: the one-card candidate mesh decides "
                             "differently from the default")
    log(f"  11c: {cards} card(s): fleet_mesh() {fm}, WVA_SHARDED_FLEET=on "
        f"-> {on} (unsharded); WVA_MESH_DEVICES=1 -> a {one.size}-device "
        f"{one.axis} mesh, {len(lanes[0])} lanes equal to the default")
    return {"cards": cards, "fleet_mesh": fm is not None,
            "sharded_fleet_on": on is not None, "mesh_devices_1": one.size}


def phase_11(card) -> dict:
    """Phase 11 (11a-11c); the host backends' timings run in two
    spawned workers (one per backend) beside the card's work. Returns
    the launches per sharded group."""
    pool = spawn_pool(2)
    try:
        jobs = {b: pool.submit(host_backend_job, b, N_VARIANTS,
                               N_VARIANTS_F64, SEED, NATIVE_REPS)
                for b in ("native", "scalar")}
        t = time.perf_counter()
        nat = native_phase(card)
        log(f"  11a on the card took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        mesh = mesh_phase(card)
        log(f"  11b took {time.perf_counter() - t:.1f} s")
        knobs = knob_phase()
        hosted = {b: job.result(timeout=600) for b, job in jobs.items()}
    finally:
        stop_pool(pool)
    if hosted["scalar"]["small"] != hosted["native"]["small"]:
        raise AssertionError("11a: scalar and native decide differently "
                             "on the 64-variant fleet")
    times = {"native": statistics.median(hosted["native"]["walls"]),
             "scalar": statistics.median(hosted["scalar"]["walls"]),
             "kernel": statistics.median(nat["kernel_calculate_ms"])}
    log(f"  11a: scalar against native on the "
        f"{len(hosted['native']['small'])}-variant fleet (float64, CPU): "
        f"equal decisions; calculate at {hosted['native']['lanes']} lanes "
        f"(two workers beside the card's work), median of {NATIVE_REPS}, "
        f"ms: native "
        f"(host) {times['native']:.3f}, scalar (host) {times['scalar']:.3f}"
        f", kernel (card) {times['kernel']:.3f}")
    log(json.dumps({"phase": "11a", "card": card, "lanes": nat["lanes"],
                    "native_build_s": nat["build_s"],
                    "native_vs_kernel_servers_differ": 0,
                    "ttft_rel_err": nat["ttft_rel_err"],
                    "rate_rel_err": nat["rate_rel_err"],
                    "scalar_vs_native_equal": True,
                    "calculate_ms_median": times,
                    "calculate_ms": {"native": hosted["native"]["walls"],
                                     "scalar": hosted["scalar"]["walls"],
                                     "kernel": nat["kernel_calculate_ms"]},
                    "reconcile_ms": nat["reconcile_ms"],
                    "reconcile_equal": True}))
    log(json.dumps({"phase": "11b", "card": card, "shards": MESH_SHARDS,
                    **mesh, "equal": True}))
    log(json.dumps({"phase": "11c", "card": card, **knobs}))
    return mesh["launches_per_sharded_group"]


def loop_job(key: str, device: str, dtype_name: str):
    """One bench_torch_loop run at full duration, in a worker process:
    (key, device, dtype, result, launches, wall s). The launch counts are
    set to 0 just before the run and read just after."""
    import logging

    import bench_torch_loop as bl
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    torch.set_num_threads(1)
    quiet_wva_loggers(logging.CRITICAL)
    where = {"device": device, "dtype": getattr(torch, dtype_name)}
    bk.reset_launches()
    t0 = time.perf_counter()
    result = (bl.run(**where) if key == "sharegpt-ramp"
              else bl.run_scenario(bl.SCENARIOS[key], **where))
    wall = time.perf_counter() - t0
    return key, device, dtype_name, result, dict(bk.launches), wall


def loop_summary(label, card, key, result, launched, wall) -> dict:
    """Check one closed loop on the card (its SLO held; B1 launched in
    every cycle that sized, B2 too in a scenario that sizes on a TTFT
    percentile, never in a mean one), log its line, return its launches
    per cycle."""
    import bench_torch_loop as bl

    k = result["kernel_launches"]
    sized = k["sizing_cycles"]
    p95 = (key in bl.SCENARIOS
           and "WVA_TTFT_PERCENTILE" in bl.SCENARIOS[key].operator_extra)
    if not result["slo_held"]:
        raise AssertionError(f"{label} {key}: the SLO did not hold: {result}")
    # on the CPU (a rehearsal) nothing launches
    on_card = LOOP_DEVICE == "cuda"
    if sized < 1 or on_card and (launched["mean"] < 1
                                 or k["sizing_cycles_with_B1"] != sized):
        raise AssertionError(f"{label} {key}: B1 was not launched in every "
                             f"cycle that sized: {k}, {launched}")
    if p95 and on_card and (launched["tail"] < 1
                            or k["sizing_cycles_with_B2"] != sized):
        raise AssertionError(f"{label} {key}: B2 was not launched in every "
                             f"cycle that sized: {k}, {launched}")
    if not p95 and launched["tail"]:
        raise AssertionError(f"{label} {key}: B2 launched on a mean-sized "
                             f"loop: {launched}")
    tails = ({"": {"p95_itl_ms": result["p95_itl_ms"],
                   "p95_ttft_ms": result["p95_ttft_ms"]}}
             if "variants" not in result else
             {name: {"p95_itl_ms": v["p95_itl_ms"],
                     "p95_ttft_ms": v["p95_ttft_ms"]}
              for name, v in result["variants"].items()})
    log(json.dumps({
        "phase": label, "card": card, "scenario": key,
        "dtype": result["dtype"], "chip_hours": result["value"],
        "vs_baseline": result["vs_baseline"], "slo_held": True,
        "p95": tails, "energy_wh": result["energy_wh"],
        "probe_kicks": result.get("probe_kicks"),
        "reconcile_wall_ms_p50": result["reconcile_wall_ms_p50"],
        "reconcile_wall_ms_max": result["reconcile_wall_ms_max"],
        "cycles": k["cycles"], "sizing_cycles": sized,
        "launches": {"B1": launched["mean"], "B2": launched["tail"]},
        "wall_s": wall}))
    return {"B1": k["B1_per_cycle"], "B2": k["B2_per_cycle"]}


def bench_phase(card) -> dict:
    """12c: the bench_torch record at BENCH_CANDIDATES candidates on the
    card; the end-to-end stage's backends must agree and both forms
    launch."""
    import bench_torch
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    bk.reset_launches()
    t0 = time.perf_counter()
    rec = bench_torch.run(BENCH_CANDIDATES, device=LOOP_DEVICE)
    wall = time.perf_counter() - t0
    launched = dict(bk.launches)
    if not rec["e2e"]["backends_agree"]:
        raise AssertionError(f"12c: the end-to-end stage's backends "
                             f"allocate differently: {rec['e2e']}")
    if LOOP_DEVICE == "cuda" and (launched["mean"] < 1
                                  or launched["tail"] < 1):
        raise AssertionError(f"12c: a kernel was not launched: {launched}")
    if not (rec["value"] > 0 and rec["tail_sizings_per_sec"] > 0
            and rec["sequential_rate"] > 0):
        raise AssertionError(f"12c: bad rates {rec}")
    log(json.dumps({"phase": "12c", "card": card,
                    "launches": {"B1": launched["mean"],
                                 "B2": launched["tail"]},
                    "wall_s": wall, **rec}))
    return rec


def spawn_pool(workers: int):
    """A pool of `workers` spawned worker processes (each starts from a
    fresh import, as CUDA needs)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))


def stop_pool(pool) -> None:
    """Shut a worker pool down, ending any worker still running."""
    workers = list((pool._processes or {}).values())
    pool.shutdown(wait=False, cancel_futures=True)
    for proc in workers:
        if proc.is_alive():
            proc.terminate()
        proc.join(timeout=30)


def wide_loop():
    """12b's LOOP_WIDE run (phase 12's longest job) in a worker of its
    own, started now: (the pool, the future of its loop_job)."""
    pool = spawn_pool(1)
    return pool, pool.submit(loop_job, LOOP_WIDE, LOOP_DEVICE, "float32")


def phase_12(card, wide) -> dict:
    """Phase 12 (12a-12c); the closed loops run in spawned workers beside
    12c, LOOP_WIDE's in `wide` (wide_loop's future, started earlier).
    Returns the B1/B2 launches per closed-loop cycle of each float32 run
    on the card."""
    import bench_torch_loop as bl

    jobs = [(key, LOOP_DEVICE, "float32") for key in LOOP_F32]
    jobs += [(LOOP_F64, dev, "float64") for dev in (LOOP_DEVICE, "cpu")]
    pool = spawn_pool(LOOP_WORKERS)
    try:
        pending = [pool.submit(loop_job, *job) for job in jobs]
        bench_phase(card)
        results = [p.result(timeout=900) for p in [*pending, wide]]
    finally:
        stop_pool(pool)
    by = {(key, dev, dt): (result, launched, wall)
          for key, dev, dt, result, launched, wall in results}
    per_cycle = {}
    for key in (*LOOP_F32, LOOP_WIDE):
        label = "12a" if key in LOOP_F32 else "12b"
        per_cycle[key] = loop_summary(label, card, key,
                                      *by[(key, LOOP_DEVICE, "float32")])
    card64, launched, card_wall = by[(LOOP_F64, LOOP_DEVICE, "float64")]
    cpu64, _, cpu_wall = by[(LOOP_F64, "cpu", "float64")]
    keys = (set(card64) | set(cpu64)) - bl.WHERE_KEYS
    differ = sorted(k for k in keys if card64.get(k) != cpu64.get(k))
    if differ:
        raise AssertionError(
            f"12b {LOOP_F64}: the card's float64 run differs from the CPU's "
            f"in {differ}: card {[card64.get(k) for k in differ]}, CPU "
            f"{[cpu64.get(k) for k in differ]}")
    loop_summary("12b", card, LOOP_F64, card64, launched, card_wall)
    log(json.dumps({"phase": "12b", "card": card, "scenario": LOOP_F64,
                    "dtype": "float64", "equal_to_cpu": True,
                    "keys_compared": len(keys), "wall_s_card": card_wall,
                    "wall_s_cpu": cpu_wall}))
    return per_cycle


def bench13_job(name: str, device: str, dtype_name: str, smoke: bool):
    """One phase-13 job in a worker process: (name, device, dtype, result,
    published decisions per run, launches, wall s). The launch counts are
    set to 0 just before the job and read just after."""
    import logging

    import bench_torch_collect as bc
    import bench_torch_fuse as bf
    import bench_torch_profile as bp
    import bench_torch_stream as bs
    import bench_torch_streamchaos as bx
    import bench_torch_streamload as bl
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    torch.set_num_threads(1)
    quiet_wva_loggers(logging.CRITICAL)
    on = {"device": device, "dtype": getattr(torch, dtype_name)}
    kubes: list = []

    def capture(module):
        orig = module.build_cluster

        def spy(*args, **kwargs):
            out = orig(*args, **kwargs)
            kubes.append(out[0])
            return out

        module.build_cluster = spy

    bk.reset_launches()
    t0 = time.perf_counter()
    if name == "collect":
        result = bc.run(64 if smoke else bc.N_VARIANTS, **on)
    elif name == "collect-decisions":
        capture(bc)
        result = bc.timed_cycle(64 if smoke else bc.N_VARIANTS, **on)
    elif name == "profile":
        result = bp.run(smoke, **on)
    elif name == "fuse":
        result = bf.run(smoke, **on)
    elif name == "stream-decisions":
        capture(bs)
        result = bs.run(64, 8, 10, 3, **on)
    elif name == "chaos-sim":
        result = {"flood": bx.flood_phase(315.0 if smoke else 0.0, **on),
                  "restart": bx.restart_phase(300.0 if smoke else 0.0, **on)}
    elif name == "walls":
        # the three wall-clock budgets, one after another
        result = {
            "stream": (bs.run(64, 8, 10, 3, **on) if smoke else bs.run(**on)),
            "streamload": (bl.run(16, 20, 15, smoke=True, **on) if smoke
                           else bl.run(**on)),
            "wire": (bx.wire_phase(32, 4, 6, 2, 24, **on) if smoke
                     else bx.wire_phase(**on))}
    else:
        raise ValueError(name)
    wall = time.perf_counter() - t0
    published = [sorted((va.metadata.name,
                         va.status.desired_optimized_alloc.accelerator,
                         va.status.desired_optimized_alloc.num_replicas)
                        for va in k.list_variant_autoscalings())
                 for k in kubes]
    return (name, device, dtype_name, result, published, dict(bk.launches),
            wall)


def launch_dicts(out, path="") -> list:
    """Every (path, kernel_launches) summary inside a script's result."""
    found = []
    if isinstance(out, dict):
        for k, v in out.items():
            if k == "kernel_launches":
                found.append((path or "run", v))
            else:
                found += launch_dicts(v, f"{path}{k}.")
    return found


def hold_launches(label, out) -> dict:
    """Raise unless, on the card, every reconcile cycle or micro-cycle of
    `out` that sized (read a decision back) launched B1, never B2 (no
    p95 class in these fleets), and every fused one read back exactly
    once (one sizing group); returns the launches over them, in all and
    per cycle."""
    on_card = BENCH13_DEVICE == "cuda"
    cycles = b1 = b2 = sized = 0
    for path, k in launch_dicts(out):
        if on_card and k["sizing_cycles_with_B1"] != k["sizing_cycles"]:
            raise AssertionError(f"13 {label} {path}: B1 was not launched "
                                 f"in every cycle that sized: {k}")
        if k["B2"]:
            raise AssertionError(f"13 {label} {path}: B2 launched on a "
                                 f"mean-SLO fleet: {k}")
        if "staged" not in path and k["d2h_per_sizing_cycle"] not in ([1],
                                                                       []):
            raise AssertionError(f"13 {label} {path}: not one readback "
                                 f"per sizing group per cycle: {k}")
        cycles += k["cycles"]
        b1 += k["B1"]
        b2 += k["B2"]
        sized += k["sizing_cycles"]
    if sized < 1:
        raise AssertionError(f"13 {label}: no cycle sized")
    return {"B1": b1, "B2": b2, "cycles": cycles, "sizing_cycles": sized,
            "B1_per_cycle": b1 / cycles, "B2_per_cycle": b2 / cycles}


def hold_checks(label, fails, budgets) -> list:
    """Raise on a failed invariant; return each wall-clock budget with
    "met" or "not met" (a budget not met is a finding, not a failure)."""
    if fails:
        raise AssertionError(f"13 {label}: invariants failed: {fails}")
    return [{**b, "met": "met" if b["met"] else "not met"} for b in budgets]


def phase_13(card) -> dict:
    """Phase 13: the six ports of the cycle and event-path benchmarks at
    the JAX scripts' full sizes in float32 on the card (collect, profile,
    fuse, the twins of streamchaos), with collect's and stream's
    decisions in float64 on the card and the CPU, in BENCH13_WORKERS
    spawned workers; then the three wall-clock jobs (bench_torch_stream,
    the throughput phase of bench_torch_streamload, the wire phase of
    bench_torch_streamchaos), one after another in one worker, with
    nothing beside them. Returns B1/B2 per cycle of each script."""

    import bench_torch_fuse as bf
    import bench_torch_streamchaos as bx
    import bench_torch_streamload as bl

    dev, smoke = BENCH13_DEVICE, BENCH13_SMOKE
    jobs = [("collect", dev, "float32"), ("profile", dev, "float32"),
            ("fuse", dev, "float32"), ("chaos-sim", dev, "float32")]
    jobs += [(name, d, "float64") for name in ("collect-decisions",
                                               "stream-decisions")
             for d in (dev, "cpu")]
    pool = spawn_pool(BENCH13_WORKERS)
    try:
        pending = [pool.submit(bench13_job, *job, smoke) for job in jobs]
        results = [p.result(timeout=900) for p in pending]
        results.append(pool.submit(bench13_job, "walls", dev, "float32",
                                   smoke).result(timeout=900))
    finally:
        stop_pool(pool)
    by = {(n, d, dt): (result, published, launched, wall)
          for n, d, dt, result, published, launched, wall in results}
    beside = [j[0] + ("" if j[1] == dev else "@cpu") + "/" + j[2]
              for j in jobs]
    per_cycle = {}

    def line(script, job, out, budgets=(), **extra):
        """The script's JSON line: its launches over the cycles it
        reports (counter differences around each), the job's launches
        (counted from 0 over the whole job), its budgets and result."""
        n = hold_launches(script, out)
        per_cycle[script] = {"B1": n["B1_per_cycle"],
                             "B2": n["B2_per_cycle"]}
        _r, _p, launched, wall = by[job]
        log(json.dumps({"phase": "13", "card": card, "script": script,
                        "launches": n, "job": job[0],
                        "job_launches": {"B1": launched["mean"],
                                         "B2": launched["tail"]},
                        "budgets": list(budgets), "job_wall_s": wall,
                        **extra, "result": out}))

    out = by[("collect", dev, "float32")][0]
    line("bench_torch_collect", ("collect", dev, "float32"), out,
         beside=beside)
    ref, ref_pub, _, cpu_wall = by[("collect-decisions", "cpu", "float64")]
    mine, pub, _, card_wall = by[("collect-decisions", dev, "float64")]
    counts = ("prom_queries", "kube_lists", "kube_gets")
    if {k: mine[k] for k in counts} != {k: ref[k] for k in counts}:
        raise AssertionError("13 collect: float64 counts differ between "
                             "the card and the CPU")
    if pub != ref_pub or len(pub) != 1:
        raise AssertionError("13 collect: float64 decisions on the card "
                             "differ from the CPU's")
    hold_launches("collect-decisions", mine)
    log(json.dumps({"phase": "13", "card": card,
                    "script": "bench_torch_collect", "dtype": "float64",
                    "equal_to_cpu": True, "variants": len(pub[0]), "wall_s_card": card_wall,
                    "wall_s_cpu": cpu_wall}))

    job = ("profile", dev, "float32")
    line("bench_torch_profile", job, by[job][0], beside=beside)
    job = ("fuse", dev, "float32")
    line("bench_torch_fuse", job, by[job][0],
         hold_checks("fuse", *bf.check(by[job][0])), beside=beside)

    ref, ref_pub, _, cpu_wall = by[("stream-decisions", "cpu", "float64")]
    mine, pub, _, card_wall = by[("stream-decisions", dev, "float64")]
    if pub != ref_pub or len(pub) != 1 \
            or mine["decision_check"] != ref["decision_check"] \
            or mine["events"] != ref["events"]:
        raise AssertionError("13 stream: float64 decisions on the card "
                             "differ from the CPU's")
    hold_launches("stream-decisions", mine)
    log(json.dumps({"phase": "13", "card": card,
                    "script": "bench_torch_stream", "dtype": "float64",
                    "equal_to_cpu": True, "variants": len(pub[0]),
                    "events": mine["events"], "wall_s_card": card_wall,
                    "wall_s_cpu": cpu_wall}))

    walls = ("walls", dev, "float32")
    timed = by[walls][0]
    alone = "alone, after the other jobs ended"
    if not timed["stream"]["decision_check"]["resized_from_push"]:
        raise AssertionError("13 stream: the pushes did not re-size")
    line("bench_torch_stream", walls, timed["stream"], beside=alone)
    load_out = timed["streamload"]
    if smoke:
        load_out["smoke"] = True
    line("bench_torch_streamload", walls, load_out,
         hold_checks("streamload", *bl.check(load_out)), beside=alone)
    sim = ("chaos-sim", dev, "float32")
    chaos = {"bench": "streamchaos", "lag_budget_ms": bx.LAG_BUDGET_MS,
             "value": timed["wire"]["p99_ms"], **by[sim][0],
             "wire": timed["wire"]}
    line("bench_torch_streamchaos", sim, chaos,
         hold_checks("streamchaos", *bx.check(chaos)),
         beside=f"flood and restart beside {beside}; wire {alone}")
    return per_cycle


def bench14_job(name: str, device: str, dtype_name: str, arg, smoke: bool):
    """One phase-14 job in a worker process: (name, device, dtype, arg,
    result, launches, wall s). The launch counts are set to 0 just
    before the job and read just after."""
    import logging

    import bench_torch_adversary as pa
    import bench_torch_goodput as pg
    import bench_torch_goodput_live as pv
    import bench_torch_hier as ph
    import bench_torch_shard as ps
    from bench_torch_loop import where
    from workload_variant_autoscaler_tpu_torch.emulator.adversary import (
        DEFAULT_GENERATIONS, DEFAULT_POPULATION, DEFAULT_SEED)
    from workload_variant_autoscaler_tpu_torch.emulator.scenarios import (
        SCENARIOS)
    from workload_variant_autoscaler_tpu_torch.emulator.scenarios.adversarial \
        import DURATION_S
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    torch.set_num_threads(1)
    quiet_wva_loggers(logging.CRITICAL)
    on = {"device": device, "dtype": getattr(torch, dtype_name)}
    search = ((DEFAULT_SEED, 1, 2, 60.0) if smoke else
              (DEFAULT_SEED, DEFAULT_GENERATIONS, DEFAULT_POPULATION,
               DURATION_S))
    bk.reset_launches()
    t0 = time.perf_counter()
    if name == "goodput":
        score, launched, _wall = pg.run_one(arg, **on)
        result = {"score": score, "kernel_launches": launched}
    elif name == "live":
        result = pv.run_one(arg, SCENARIOS[arg], **on)
    elif name == "search":
        result = pa.run_search(*search, **on)
    elif name == "harden":
        first, second, hand_min = arg
        result = pa.finish(first, second, hand_min, where(**on), **on)
    elif name == "adv-smoke":
        result = pa.run_search(DEFAULT_SEED, pa.SMOKE_GENERATIONS,
                               pa.SMOKE_POPULATION, pa.SMOKE_DURATION_S,
                               **on)
    elif name == "live-smoke":
        result = pv.run(True, **on)
    elif name == "shard-churn":
        result = ps.churn_run(ps.SMOKE_SIZES[1] if smoke else ps.CHURN_N,
                              ps.lane_mesh(BENCH14_MESH, device), **on)
    elif name == "hier-smoke":
        result = ph.run(True, **on)
    elif name == "walls":
        # the wall-clock jobs, one after another, nothing beside them; the
        # launch counts are set to 0 before each and read after it
        runs = {"shard": lambda: ps.run(smoke, BENCH14_MESH, **on),
                "hier": lambda: ph.run(smoke, None, **on),
                "hier_mesh": lambda: ph.measure(
                    ph.SMOKE_SIZES[:1] if smoke else ph.SIZES[:1],
                    ps.lane_mesh(BENCH14_MESH, device),
                    ph.SMOKE_SHARD_TARGET if smoke else ph.SHARD_TARGET,
                    **on)}
        result, each = {}, {}
        for part, go in runs.items():
            bk.reset_launches()
            result[part] = go()
            each[part] = dict(bk.launches)
        result["launches"] = each
    else:
        raise ValueError(name)
    wall = time.perf_counter() - t0
    return name, device, dtype_name, arg, result, dict(bk.launches), wall


def hold14(label, out) -> dict:
    """The launches over every cycle of `out` that reports them: raises
    unless, on the card, every cycle that sized (read a decision back)
    launched B1; B2 is counted, not assumed 0."""
    on_card = BENCH14_DEVICE == "cuda"
    cycles = b1 = b2 = sized = 0
    for path, k in launch_dicts(out):
        if on_card and k["sizing_cycles_with_B1"] != k["sizing_cycles"]:
            raise AssertionError(f"14 {label} {path}: B1 was not launched "
                                 f"in every cycle that sized: {k}")
        cycles += k["cycles"]
        b1 += k["B1"]
        b2 += k["B2"]
        sized += k["sizing_cycles"]
    if sized < 1:
        raise AssertionError(f"14 {label}: no cycle sized")
    return {"B1": b1, "B2": b2, "cycles": cycles, "sizing_cycles": sized,
            "B1_per_cycle": b1 / cycles, "B2_per_cycle": b2 / cycles}


def without_walls(out, drop=None):
    """`out` without its host-clock values (walls, ms, shares) and the
    keys that name where it ran, as the scripts define them: what float64
    on the card and on the CPU must hold equal."""
    if drop is None:
        import bench_torch_adversary as pa
        import bench_torch_goodput_live as pv
        import bench_torch_hier as ph
        import bench_torch_loop as bl
        import bench_torch_shard as ps

        drop = (bl.WHERE_KEYS | ps.WALL_KEYS | ph.WALL_KEYS | pa.WALL_KEYS
                | pv.WALL_KEYS)
    if isinstance(out, dict):
        return {k: without_walls(v, drop) for k, v in out.items()
                if k not in drop}
    if isinstance(out, list):
        return [without_walls(v, drop) for v in out]
    return out


def hold_scores(scores: dict, launched: dict) -> None:
    """14a's hold on bench_torch_goodput: raises unless every scenario's
    score sheet is sane (goodput and SLO attainment in [0, 1], a cost
    and cycles), reaches the scenario's goodput floor and, on the card,
    launched B1."""
    from workload_variant_autoscaler_tpu_torch.emulator.scenarios import (
        SCENARIOS)

    for name, d in scores.items():
        if not (0.0 <= d["goodput_fraction"] <= 1.0
                and 0.0 <= d["slo_attainment"] <= 1.0
                and d["cost_dollar_seconds"] > 0.0 and d["cycles"] > 0):
            raise AssertionError(f"14a {name}: bad score sheet {d}")
        if d["goodput_fraction"] < SCENARIOS[name].goodput_floor:
            raise AssertionError(
                f"14a {name}: goodput {d['goodput_fraction']} below the "
                f"scenario's floor {SCENARIOS[name].goodput_floor}")
        if BENCH14_DEVICE == "cuda" and launched[name]["mean"] < 1:
            raise AssertionError(f"14a {name}: B1 was not launched")


def run14(pool, jobs, smoke: bool) -> dict:
    """The jobs' results by (name, device, dtype, arg; None for the
    hardened run's): (result, launches, wall s). A worker that dies fails
    its future, and so the phase."""
    done = [p.result(timeout=1500) for p in
            [pool.submit(bench14_job, *job, smoke) for job in jobs]]
    return {(n, d, dt, None if n == "harden" else a): (r, launched, wall)
            for n, d, dt, a, r, launched, wall in done}


def phase_14(card) -> dict:
    """Phase 14 (14a-14c, see BENCH14_WORKERS). Returns B1/B2 per cycle
    of each script for the kernels line."""
    import bench_torch_adversary as pa
    import bench_torch_goodput as pg
    from workload_variant_autoscaler_tpu_torch.emulator.scenarios import (
        SCENARIOS)

    dev, smoke = BENCH14_DEVICE, BENCH14_SMOKE
    names = list(SCENARIOS)
    sim = [("search", dev, "float32", 0), ("search", dev, "float32", 1)]
    sim += [(kind, dev, "float32", n) for kind in ("goodput", "live")
            for n in names]
    sim += [(kind, d, "float64", None) for kind in (
        "adv-smoke", "live-smoke", "shard-churn", "hier-smoke")
        for d in (dev, "cpu")]
    pool = spawn_pool(BENCH14_WORKERS)
    t0 = time.perf_counter()
    try:
        by = run14(pool, sim, smoke)
        t_sim = time.perf_counter() - t0
        scores = {n: by[("goodput", dev, "float32", n)][0]["score"]
                  for n in names}
        hold_scores(scores, {n: by[("goodput", dev, "float32", n)][1]
                             for n in names})
        hand = None if smoke else pg.compose(scores)
        first = by[("search", dev, "float32", 0)][0]
        second = by[("search", dev, "float32", 1)][0]
        hand_min = 1.0 if smoke else pa.hand_library_min(hand)
        t1 = time.perf_counter()
        by.update(run14(pool, [("harden", dev, "float32",
                                (first, second, hand_min))], smoke))
        t_harden = time.perf_counter() - t1
        t2 = time.perf_counter()
        by.update(run14(pool, [("walls", dev, "float32", None)], smoke))
        t_walls = time.perf_counter() - t2
    finally:
        stop_pool(pool)
    per_cycle = {}

    def line(script, part, out, job_launches, **extra):
        n = hold14(f"{script} {part}", out)
        per_cycle.setdefault(script, []).append(n)
        log(json.dumps({"phase": "14", "card": card, "script": script,
                        "part": part, "launches": n,
                        "job_launches": job_launches, **extra}))

    def launched(jobs):
        return {"B1": sum(by[j][1]["mean"] for j in jobs),
                "B2": sum(by[j][1]["tail"] for j in jobs)}

    # 14a: the scoreboard, the live meter, the search
    jobs = [("goodput", dev, "float32", n) for n in names]
    line("bench_torch_goodput", "14a",
         {n: by[j][0] for n, j in zip(names, jobs)}, launched(jobs),
         dtype="float32", scenarios=len(names),
         record=None if smoke else {k: v for k, v in hand.items()
                                    if k != "scenarios"},
         goodput={n: (None if smoke else scores[n]["goodput_fraction"])
                  for n in names},
         wall_s={n: by[j][2] for n, j in zip(names, jobs)})
    jobs = [("live", dev, "float32", n) for n in names]
    line("bench_torch_goodput_live", "14a",
         {n: by[j][0] for n, j in zip(names, jobs)}, launched(jobs),
         dtype="float32", equivalent=True,
         scenarios=[{k: by[j][0][k] for k in ("scenario", "ticks",
                                              "variants", "goodput_fraction",
                                              "wall_s")} for j in jobs])
    record = by[("harden", dev, "float32", None)][0]
    search_jobs = [("search", dev, "float32", 0),
                   ("search", dev, "float32", 1)]
    line("bench_torch_adversary", "14a",
         {"search": by[search_jobs[0]][0], "rerun": by[search_jobs[1]][0]},
         launched(search_jobs), dtype="float32",
         byte_identical_across_processes=record["deterministic"],
         value=record["value"], budget=record["budget"],
         evaluations=len(record["evaluations"]),
         hand_library_min=record["hand_library_min"],
         hardened_goodput=record["hardened_goodput"],
         promoted=[{k: p[k] for k in ("name", "unhardened_goodput",
                                      "hardened_goodput", "floor")}
                   for p in record["promoted"]],
         results=record["results"],
         wall_s={"search": by[search_jobs[0]][2],
                 "rerun": by[search_jobs[1]][2],
                 "hardened_and_promote": by[("harden", dev, "float32",
                                             None)][2]})
    committed = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             ADVERSARY_RECORD)
    with open(committed, encoding="utf-8") as f:
        jax_record = json.load(f)
    found = by[search_jobs[0]][0]["result"]
    log(json.dumps({
        "phase": "14a", "card": card, "information": "the float32 card "
        "search against the JAX package's committed record (not a check)",
        "worst_params_equal": found["worst"]["params"]
        == jax_record["worst"]["params"],
        "generation_worst_equal": found["generation_worst"]
        == jax_record["generation_worst"],
        "worst_goodput": [found["worst"]["goodput"],
                          jax_record["worst"]["goodput"]]}))

    # 14b: float64 on the card against the CPU
    for kind, script in (("adv-smoke", "bench_torch_adversary"),
                         ("live-smoke", "bench_torch_goodput_live"),
                         ("shard-churn", "bench_torch_shard"),
                         ("hier-smoke", "bench_torch_hier")):
        mine, card_launched, card_wall = by[(kind, dev, "float64", None)]
        ref, _l, cpu_wall = by[(kind, "cpu", "float64", None)]
        if without_walls(mine) != without_walls(ref):
            raise AssertionError(f"14b {kind}: float64 on the card differs "
                                 f"from the CPU")
        line(script, f"14b {kind}", mine,
             {"B1": card_launched["mean"], "B2": card_launched["tail"]},
             dtype="float64", equal_to_cpu=True, wall_s_card=card_wall,
             wall_s_cpu=cpu_wall)

    # 14c: wall clock, alone
    walls, _launched, walls_wall = by[("walls", dev, "float32", None)]

    def sub_launched(part):
        k = walls["launches"][part]
        return {"B1": k["mean"], "B2": k["tail"]}

    alone = "alone, after the other jobs ended"
    shard = walls["shard"]
    line("bench_torch_shard", "14c", shard, sub_launched("shard"),
         beside=alone, **{k: shard.get(k) for k in (
             "mesh_entries", "mesh_cards", "value",
             "reconcile_cycle_512_ms", "vs_512_reconcile_cycle", "budgets")},
         steady_state={k: v for k, v in shard["steady_state"].items()
                       if k != "decisions"},
         walls={n: {side: w[side]["analyze_optimize_ms_p50"]
                    for side in ("unsharded", "sharded")}
                for n, w in shard["walls"].items()},
         greedy={k: v for k, v in shard.get("greedy", {}).items()
                 if k != "decisions"})
    hier = walls["hier"]
    line("bench_torch_hier", "14c", hier, sub_launched("hier"),
         beside=alone, **{k: hier.get(k) for k in (
             "mesh_entries", "value", "forced_wall_32k_vs_8k", "budgets")},
         walls={n: {"shards": w["hier"]["shards"],
                    "first_full_pass_ms": w["hier"]["first_full_pass_ms"],
                    "forced_wall_ms_max": w["hier"]["forced_wall_ms_max"],
                    "forced_lanes_max_cycle":
                        w["hier"]["forced_lanes_max_cycle"],
                    "quiet_wall_ms_median": statistics.median(
                        x for x, f in zip(w["hier"]["window_walls_ms"],
                                          w["hier"]["forced_lanes"])
                        if not f) if 0 in w["hier"]["forced_lanes"]
                    else None,
                    "flat_forced_full_ms_min":
                        w["flat"]["forced_full_ms_min"]}
                for n, w in hier["walls"].items()},
         restart={k: v for k, v in hier["restart"].items()
                  if k != "probes"},
         probes={k: {x: v[x] for x in ("lanes_solved", "restored",
                                       "first_cycle_ms", "import_torch_s",
                                       "cuda_context_s", "startup_share")
                     if x in v}
                 for k, v in hier["restart"]["probes"].items()})
    mesh = walls["hier_mesh"]
    line("bench_torch_hier", f"14c {BENCH14_MESH}-entry mesh", mesh,
         sub_launched("hier_mesh"),
         beside=alone, mesh_entries=BENCH14_MESH,
         walls={n: {"shards": w["hier"]["shards"],
                    "forced_wall_ms_max": w["hier"]["forced_wall_ms_max"],
                    "first_full_pass_ms": w["hier"]["first_full_pass_ms"],
                    "flat_forced_full_ms_min":
                        w["flat"]["forced_full_ms_min"]}
                for n, w in mesh.items()})
    log(f"  14: simulated-time jobs {t_sim:.1f} s ({len(sim)} jobs in "
        f"{BENCH14_WORKERS} workers), hardened run and promotion "
        f"{t_harden:.1f} s, wall-clock job {t_walls:.1f} s "
        f"(in the worker {walls_wall:.1f} s)")
    return {script: {"B1": sum(n["B1"] for n in ns)
                     / sum(n["cycles"] for n in ns),
                     "B2": sum(n["B2"] for n in ns)
                     / sum(n["cycles"] for n in ns)}
            for script, ns in per_cycle.items()}


def tree_state(root: str) -> dict:
    """relative path -> (mode, size, mtime_ns) of `root` and everything
    under it: what a process that writes nothing leaves as it was."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in [".", *dirnames, *filenames]:
            path = os.path.normpath(os.path.join(dirpath, name))
            st = os.lstat(path)
            out[os.path.relpath(path, root)] = (st.st_mode, st.st_size,
                                                st.st_mtime_ns)
    return out


def shipped_layout(workdir: str) -> dict:
    """The image's layout under `workdir`: app/ (the port's package),
    kernels/ (the prebuilt libraries), home/, and an empty/ and a stale/
    kernel directory for the refusal legs, all read-only; bin/ (python
    alone) for PATH; tmp/ writable, as a pod's /tmp is."""
    import shutil

    from workload_variant_autoscaler_tpu_torch.ops import _build

    if _build.prebuilt_dir() is not None:
        raise AssertionError(f"15: {_build.KERNEL_DIR_ENV} is set in the "
                             f"smoke's own process")
    pkg = "workload_variant_autoscaler_tpu_torch"
    repo = os.path.dirname(os.path.abspath(__file__))
    lay = {k: os.path.join(workdir, k)
           for k in ("app", "kernels", "home", "empty", "stale", "bin",
                     "tmp")}
    shutil.copytree(os.path.join(repo, pkg), os.path.join(lay["app"], pkg),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for k in ("kernels", "home", "empty", "stale", "bin", "tmp"):
        os.makedirs(lay[k])
    for name in ("bisect_kernel", "wva_queueing"):
        _build.library(name)        # built by phases 1 and 11a
        shutil.copy2(_build.library_path(name), lay["kernels"])
    lay["bisect"] = os.path.join(lay["kernels"],
                                 _build.file_name("bisect_kernel"))
    lay["native"] = os.path.join(lay["kernels"],
                                 _build.file_name("wva_queueing"))
    shutil.copy2(lay["bisect"], os.path.join(
        lay["stale"], f"libbisect_kernel_{SHIPPED_STALE_DIGEST}.so"))
    os.symlink(sys.executable, os.path.join(lay["bin"], "python3"))
    for k in ("app", "kernels", "home", "empty", "stale"):
        subprocess.run(["chmod", "-R", "a-w", lay[k]], check=True)
    return lay


def shipped_env(lay: dict, prom_url: str, kernel_dir) -> dict:
    """The runtime image's environment over the layout; `kernel_dir`
    None leaves WVA_TORCH_KERNEL_DIR and WVA_NATIVE_LIB unset."""
    import shutil

    penv = {k: v for k, v in os.environ.items()
            if k not in ("WVA_PLATFORM", "LOG_LEVEL", "PYTHONPATH",
                         "CUDA_HOME", "WVA_TORCH_KERNEL_DIR",
                         "WVA_NATIVE_LIB")}
    penv.update(PYTHONPATH=lay["app"], PATH=lay["bin"],
                CUDA_HOME=os.path.join(lay["tmp"], "no-cuda-here"),
                HOME=lay["home"], TMPDIR=lay["tmp"],
                PYTHONDONTWRITEBYTECODE="1", PROMETHEUS_BASE_URL=prom_url,
                **SHIPPED_ENV)
    if kernel_dir is not None:
        penv.update(WVA_TORCH_KERNEL_DIR=kernel_dir,
                    WVA_NATIVE_LIB=lay["native"])
    for tool in ("nvcc", "g++"):
        if shutil.which(tool, path=penv["PATH"]):
            raise AssertionError(f"15: {tool} is on the layout's PATH")
    return penv


def resident_kib(pid: int) -> int:
    """A live process's resident set now, in KiB (/proc/PID/statm). The
    card's machine has no VmHWM in /proc/PID/status, and its wait4
    reports one ru_maxrss for every child, so a peak is the largest of
    these samples."""
    with open(f"/proc/{pid}/statm", encoding="utf-8") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") // 1024


def mapped_libraries(pid: int, stem: str) -> set:
    """Paths of the files named lib<stem>_* mapped into a live process."""
    with open(f"/proc/{pid}/maps", encoding="utf-8") as fh:
        return {ln.split(None, 5)[5].strip() for ln in fh
                if len(ln.split(None, 5)) == 6
                and os.path.basename(ln.split(None, 5)[5]).startswith(
                    f"lib{stem}_")}


def shipped_process(rc, c, lay, workdir, shim) -> dict:
    """15a: the controller from the read-only layout; returns its line."""
    import signal

    on_card = SHIPPED_ENV.get("WVA_PLATFORM") != "cpu"

    load = rc.loads(c)
    manifests = os.path.join(workdir, "manifests")
    os.makedirs(manifests)
    write_manifests(rc, c, load, manifests)
    want = polled_reference(rc, c, load)
    penv = shipped_env(lay, shim.url, lay["kernels"])
    before = {k: tree_state(lay[k]) for k in ("app", "kernels", "home")}
    metrics_port, health_port = free_port(), free_port()
    log_path = os.path.join(workdir, "shipped.log")
    t_start = time.perf_counter()
    proc = start_controller(penv, lay["app"], manifests, log_path,
                            health_port, metrics_port)
    try:
        def alive():
            if proc.poll() is not None:
                with open(log_path, encoding="utf-8") as fh:
                    tail = fh.read()[-4000:]
                raise AssertionError(f"15a: the process exited with "
                                     f"{proc.returncode}:\n{tail}")

        sampled = [0]

        def sample():
            alive()
            sampled.append(resident_kib(proc.pid))

        deadline = time.perf_counter() + PROCESS_READY_S
        while http_get(f"http://127.0.0.1:{health_port}/readyz",
                       2.0)[0] != 200:
            sample()
            if time.perf_counter() > deadline:
                raise AssertionError("15a: /readyz never answered 200")
            time.sleep(0.1)
        t_ready = time.perf_counter() - t_start
        base = f"http://127.0.0.1:{metrics_port}"
        got = {}
        while len(got) < c.variants:
            sample()
            if time.perf_counter() > deadline:
                raise AssertionError("15a: the first full pass never "
                                     "published every VA")
            time.sleep(0.1)
            got = scraped_desired(http_get(base + "/metrics")[1])
        t_first = time.perf_counter() - t_start
        if got != want:
            diff = sorted(k for k in want if got.get(k) != want[k])
            raise AssertionError(
                f"15a: {len(diff)} VAs' first published "
                f"inferno_desired_replicas differ from the polled "
                f"reference, e.g. {diff[:1]}: "
                f"{[got.get(k) for k in diff[:1]]} != "
                f"{[want[k] for k in diff[:1]]}")
        sample()
        mapped = mapped_libraries(proc.pid, "bisect_kernel")
        if on_card and mapped != {os.path.realpath(lay["bisect"])}:
            raise AssertionError(f"15a: the process mapped {mapped}, not "
                                 f"the prebuilt {lay['bisect']}")
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc_term = proc.wait(timeout=30)
        t_exit = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    if rc_term != 0:
        with open(log_path, encoding="utf-8") as fh:
            tail = fh.read()[-4000:]
        raise AssertionError(f"15a: the process exited {rc_term} on "
                             f"SIGTERM:\n{tail}")
    lines = log_lines(log_path)
    found = {ln.get("msg"): ln for ln in reversed(lines)}
    built, warmed = found.get("kernel library loaded"), found.get(
        "engine kernels warmed")
    failed = [ln["msg"] for ln in lines if ln.get("level") == "error"]
    if on_card and (
            built is None or not built["prebuilt"] or built["compiled"]
            or built["path"] != lay["bisect"]):
        raise AssertionError(f"15a: library line {built}")
    if failed or warmed is None or warmed["failures"] != 0:
        raise AssertionError(f"15a: the log holds failures {failed[:3]}, "
                             f"warm-up {warmed}")
    after = {k: tree_state(lay[k]) for k in before}
    written = {k: sorted(set(before[k].items()) ^ set(after[k].items()))
               for k in ("app", "kernels")}
    if any(written.values()):
        raise AssertionError(f"15a: the process wrote under the read-only "
                             f"layout: {written}")
    # HOME is read-only to the image's user, not to root: what a process
    # running as root put there (the CUDA driver's compute cache) is
    # reported, not refused
    home = sorted(set(after["home"]) - set(before["home"]))
    return {
        "variants": c.variants, "ready_s": t_ready,
        "first_full_publish_s": t_first, "first_publish_equal": True,
        "library_load_s": built["seconds"] if built else None,
        "prebuilt": built["prebuilt"] if built else None,
        "compiled": built["compiled"] if built else None,
        "library_path": built["path"] if built else None,
        "warmup_s": warmed["seconds"],
        "peak_rss_mib": max(sampled) / 1024, "rss_samples": len(sampled),
        "rss_at_first_publish_mib": sampled[-1] / 1024,
        "sigterm_exit_s": t_exit, "exit_code": rc_term,
        "written_under_app_and_kernels": 0, "new_under_home": home,
        "bytes_under_home": sum(after["home"][k][1] for k in home
                                if not os.path.isdir(
                                    os.path.join(lay["home"], k)))}


def refusal_leg(leg: str, lay, workdir, shim) -> dict:
    """15b: one fresh process whose library cannot be had; it must exit
    1 before /readyz, its error naming the cause."""
    kernel_dir = {"empty": lay["empty"], "stale": lay["stale"],
                  "unset": None}[leg]
    penv = shipped_env(lay, shim.url, kernel_dir)
    manifests = os.path.join(workdir, "manifests")
    health_port = free_port()
    log_path = os.path.join(workdir, f"refusal-{leg}.log")
    t0 = time.perf_counter()
    proc = start_controller(penv, lay["app"], manifests, log_path,
                            health_port, free_port())
    sampled = [0]
    try:
        while True:
            try:
                sampled.append(resident_kib(proc.pid))
            except OSError:         # exited between two samples
                pass
            if proc.poll() is not None:
                break
            if http_get(f"http://127.0.0.1:{health_port}/readyz",
                        2.0)[0] == 200:
                raise AssertionError(f"15b {leg}: the process went ready")
            if time.perf_counter() - t0 > SHIPPED_EXIT_S:
                raise AssertionError(f"15b {leg}: the process did not exit")
            time.sleep(0.1)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    errors = [ln for ln in log_lines(log_path)
              if ln.get("msg", "").startswith(
                  "CRITICAL: the CUDA kernel library failed")]
    cause = errors[0]["error"] if errors else None
    if proc.returncode != 1 or cause is None \
            or SHIPPED_REFUSALS[leg] not in cause \
            or (leg == "empty" and "it holds" in cause):
        with open(log_path, encoding="utf-8") as fh:
            tail = fh.read()[-3000:]
        raise AssertionError(f"15b {leg}: exit {proc.returncode}, cause "
                             f"{cause!r}:\n{tail}")
    # its peak resident set: `import torch`, a CUDA context, no engine
    return {"exit": proc.returncode, "s": time.perf_counter() - t0,
            "peak_rss_mib": max(sampled) / 1024, "cause": cause}


# 15c's worker, run in the layout with the image's environment: B1/B2
# from the prebuilt library over the inputs the smoke saved
PREBUILT_WORKER = """
import sys
import torch
from workload_variant_autoscaler_tpu_torch.ops import _build
from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk
calls = torch.load(sys.argv[1])
x = [bk.bisect(*[a.cuda() if isinstance(a, torch.Tensor) else a
                 for a in args]).cpu() for args in calls]
torch.cuda.synchronize()
torch.save({"x": x, "module": bk.__file__,
            "library": str(_build.library_path("bisect_kernel")),
            "prebuilt": _build.prebuilt_dir() is not None,
            "compiled": sorted(_build.build_logs),
            "launches": dict(bk.launches)}, sys.argv[2])
"""


def prebuilt_equality(lay, workdir, shim):
    """15c: B1/B2 of phase 5's fleet (float32) and phase 2's float64 one,
    launched in this process from the in-tree library and in a worker
    from the prebuilt one, which runs while this returns: (the calls,
    this process's results, the worker, the worker's output file)."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    calls = []
    for n, seed, dtype in ((N_VARIANTS, SEED, torch.float32),
                           (N_VARIANTS_F64, SEED + 1, torch.float64)):
        system, opt = make_system(build_fleet(n, seed), "cuda", dtype)
        calls += [(name, args) for name, args in
                  capture_launches(system, opt)[0]]
    mine = [bk.bisect(*args).cpu() for _n, args in calls]
    torch.cuda.synchronize()
    inputs = os.path.join(lay["tmp"], "calls.pt")
    torch.save([tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                      for a in args) for _n, args in calls], inputs)
    out = os.path.join(lay["tmp"], "prebuilt.pt")
    proc = subprocess.Popen(
        [sys.executable, "-c", PREBUILT_WORKER, inputs, out],
        env=shipped_env(lay, shim.url, lay["kernels"]), cwd=lay["app"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return calls, mine, proc, out


def prebuilt_held(lay, calls, mine, proc, out) -> dict:
    text, _ = proc.communicate(timeout=SHIPPED_EXIT_S)
    if proc.returncode != 0:
        raise AssertionError(f"15c: the worker exited {proc.returncode}:\n"
                             f"{text[-3000:]}")
    got = torch.load(out)
    if not got["prebuilt"] or got["compiled"] \
            or got["library"] != lay["bisect"] \
            or not os.path.realpath(got["module"]).startswith(
                os.path.realpath(lay["app"]) + os.sep):
        raise AssertionError(f"15c: the worker ran {got['module']} on "
                             f"{got['library']} (prebuilt "
                             f"{got['prebuilt']}, compiled "
                             f"{got['compiled']})")
    per_form = {"B1": 0, "B2": 0}
    for (name, _args), a, b in zip(calls, mine, got["x"]):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                a.view(torch.int64 if a.dtype == torch.float64
                       else torch.int32),
                b.view(torch.int64 if b.dtype == torch.float64
                       else torch.int32)):
            raise AssertionError(f"15c: {name} from the prebuilt library "
                                 f"differs from the in-tree library's")
        per_form[name] += 1
    if got["launches"] != {"mean": per_form["B1"], "tail": per_form["B2"]}:
        raise AssertionError(f"15c: the worker launched {got['launches']}")
    return {"bit_equal_calls": per_form, "launches": got["launches"]}


def library_deps(path: str) -> list:
    """`ldd` of a shipped library: what the runtime image must provide."""
    out = subprocess.run(["ldd", path], capture_output=True, text=True,
                         check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def phase_15(card) -> dict:
    """Phase 15 (15a-15c, see SHIPPED_ENV); prints its line and returns
    the 15c worker's launches per form."""
    import logging
    import shutil

    quiet_wva_loggers(logging.ERROR)
    os.environ["LOG_LEVEL"] = "error"   # as phase 9 leaves it
    rc = reconcile_cluster()
    c = stream_cluster(rc)
    log(f"  torch {torch.__version__}, cuda {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, uid {os.geteuid()}")
    workdir = tempfile.mkdtemp(prefix="wva-shipped-")
    feed = rc.Built(pkg=rc.PORT, kube=None,
                    prom=rc.modules(rc.PORT)["col"].FakePromAPI(),
                    emitter=None, rec=None, mods=rc.modules(rc.PORT))
    rc.set_loads(feed, rc.loads(c))
    shim = PromShim(feed.prom)
    try:
        lay = shipped_layout(workdir)
        deps = {os.path.basename(lay[k]): library_deps(lay[k])
                for k in ("bisect", "native")}
        for name, lines in deps.items():
            log(f"  ldd {name}: " + "; ".join(lines))
        if any("libcudart" in ln for ln in deps[os.path.basename(
                lay["bisect"])]):
            raise AssertionError("15: the kernel library links the CUDA "
                                 "runtime dynamically")
        t0 = time.perf_counter()
        line = shipped_process(rc, c, lay, workdir, shim)
        t_15a = time.perf_counter() - t0
        log(f"  15a: ready {line['ready_s']:.3f} s, first full publish "
            f"{line['first_full_publish_s']:.3f} s (equal), peak RSS "
            f"{line['peak_rss_mib']:.1f} MiB, SIGTERM -> 0 in "
            f"{line['sigterm_exit_s']:.3f} s; {t_15a:.1f} s")
        refusals, held = {}, None
        if SHIPPED_ENV.get("WVA_PLATFORM") != "cpu":
            t0 = time.perf_counter()
            calls, mine, worker, out = prebuilt_equality(lay, workdir, shim)
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(len(SHIPPED_REFUSALS)) as pool:
                futures = {leg: pool.submit(refusal_leg, leg, lay, workdir,
                                            shim)
                           for leg in SHIPPED_REFUSALS}
                held = prebuilt_held(lay, calls, mine, worker, out)
                refusals = {leg: f.result() for leg, f in futures.items()}
            for leg, r in refusals.items():
                log(f"  15b {leg}: exit {r['exit']} in {r['s']:.1f} s: "
                    f"{r['cause'][:160]}")
            log(f"  15c: bit-equal {held['bit_equal_calls']}; 15b+15c "
                f"{time.perf_counter() - t0:.1f} s")
        log(json.dumps({
            "phase": "15", "card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda, "uid": os.geteuid(), **line,
            "refusals": {leg: {k: r[k] for k in ("exit", "s",
                                                 "peak_rss_mib")}
                         for leg, r in refusals.items()},
            "prebuilt_worker": held, "ldd": deps}))
    finally:
        shim.stop()
        subprocess.run(["chmod", "-R", "u+w", workdir], check=False)
        shutil.rmtree(workdir, ignore_errors=True)
    return held["launches"] if held else {"mean": 0, "tail": 0}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from workload_variant_autoscaler_tpu_torch.ops import _build
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk
    from workload_variant_autoscaler_tpu_torch.utils.device import device_name

    t_start = time.perf_counter()
    # phases 1-10 hold the card against the batched path on the CPU; the
    # CPU's default backend is the native one, so pin it off until 11
    pinned = contextlib.ExitStack()
    pinned.enter_context(env("WVA_NATIVE_KERNEL", "false"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_name(torch.device("cuda", 0))
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

    log("phase 8: the reconcile cycle (Reconciler.reconcile) on the card")
    gc.collect()
    t8 = time.perf_counter()
    recon_launches = reconcile_phase(card)
    per_cycle = {"B1": [x["B1"] for x in recon_launches],
                 "B2": [x["B2"] for x in recon_launches]}
    for row in rows:
        row["launches_per_reconcile_cycle"] = per_cycle[row["name"]]
    log(f"  phase 8 took {time.perf_counter() - t8:.1f} s")

    log("phase 9: the streaming core and the controller process on the card")
    gc.collect()
    t9 = time.perf_counter()
    stream_launches = stream_phase(card)
    for row in rows:
        key = row["name"]
        row["launches_per_micro_cycle"] = [x[key] for x in stream_launches]
    log(f"  phase 9 took {time.perf_counter() - t9:.1f} s")

    # phase 12's longest closed loop runs beside phases 10 and 11
    wide_pool, wide = wide_loop()
    try:
        return phases_10_to_15(card, kind, rows, pinned, wide, t_start)
    finally:
        stop_pool(wide_pool)


def phases_10_to_15(card, kind, rows, pinned, wide, t_start) -> int:
    """main's phases 10-15 and its last three lines, with phase 12's
    LOOP_WIDE run already started (`wide`)."""
    log("phase 10: the goodput twin and the planner on the card")
    gc.collect()
    t10 = time.perf_counter()
    twin_launches = twin_phase(card)
    for row in rows:
        row["launches_per_twin_cycle"] = \
            twin_launches["per_twin_cycle"][row["name"]]
        row["launches_per_plan"] = {
            form: n[row["name"]]
            for form, n in twin_launches["per_plan"].items()}
    log(f"  phase 10 took {time.perf_counter() - t10:.1f} s")
    pinned.close()

    log("phase 11: the native and scalar backends and the device mesh")
    gc.collect()
    t11 = time.perf_counter()
    per_group = phase_11(card)
    for row in rows:
        row["launches_per_sharded_group"] = {
            form: n[row["name"]] for form, n in per_group.items()}
    log(f"  phase 11 took {time.perf_counter() - t11:.1f} s")

    log("phase 12: the north-star closed loop (bench_torch_loop) and "
        "candidate-sizing throughput (bench_torch) on the card")
    gc.collect()
    t12 = time.perf_counter()
    with env("WVA_NATIVE_KERNEL", "false"):
        loops = phase_12(card, wide)
    for row in rows:
        row["launches_per_closed_loop_cycle"] = {
            key: n[row["name"]] for key, n in loops.items()}
    log(f"  phase 12 took {time.perf_counter() - t12:.1f} s")

    log("phase 13: the cycle and event-path benchmarks (bench_torch_collect, "
        "_profile, _fuse, _stream, _streamload, _streamchaos) on the card")
    gc.collect()
    t13 = time.perf_counter()
    with env("WVA_NATIVE_KERNEL", "false"):
        benches = phase_13(card)
    for row in rows:
        row["launches_per_phase13_cycle"] = {
            script: n[row["name"]] for script, n in benches.items()}
    log(f"  phase 13 took {time.perf_counter() - t13:.1f} s")

    log("phase 14: the engine-scale and goodput-scoreboard benchmarks "
        "(bench_torch_shard, _hier, _goodput, _goodput_live, _adversary) "
        "on the card")
    gc.collect()
    t14 = time.perf_counter()
    with env("WVA_NATIVE_KERNEL", "false"):
        scale = phase_14(card)
    for row in rows:
        row["launches_per_phase14_cycle"] = {
            script: n[row["name"]] for script, n in scale.items()}
    log(f"  phase 14 took {time.perf_counter() - t14:.1f} s")

    log("phase 15: the shipped layout (the controller from a read-only "
        "install with prebuilt libraries and no compiler) on the card")
    gc.collect()
    t15 = time.perf_counter()
    shipped = phase_15(card)
    for row in rows:
        row["launches_from_prebuilt_library"] = shipped[
            "mean" if row["name"] == "B1" else "tail"]
    log(f"  phase 15 took {time.perf_counter() - t15:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
