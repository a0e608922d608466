"""The port's incremental engine, candidate arena and staged path.

- `ops/arena.py`: `CandidateArena.pack` gives tensors bit-identical to
  the list path (`make_queue_batch`, padded, and `make_epilogue_batch`),
  its slabs stay resident, no pack's tensors alias them, and a System
  packs through its arena.
- `solver/incremental.py`: the port's engine publishes exactly what a
  from-scratch port solve publishes over 210 cycles of the churn of
  tests/test_incremental_solve.py, and what the JAX engine publishes
  (decisions equal, latencies within rtol 1e-9, equal SolveStats) over
  40 cycles. The port runs backend="kernel" (the kernels' plain versions
  on the CPU), the JAX package its "batched" backend.
- `models/system.py`: the staged path (WVA_FUSED_SOLVE=off) decides as
  the fused one does.

Everything runs on the CPU in float64 with one torch thread.
"""

from dataclasses import asdict

import numpy as np
import pytest
import torch

import helpers
import test_incremental_solve
from test_fused import SERVICE_CLASSES as FUSED_CLASSES
from test_fused import FusedChurnDriver
from test_incremental_solve import (
    PROFILES,
    SLICES,
    ChurnDriver,
    make_spec,
    run_cycle,
)
from test_torch_cuda import list_path_pack
from workload_variant_autoscaler_tpu.models.spec import OptimizerSpec, \
    SystemSpec
from workload_variant_autoscaler_tpu.ops.arena import CandidateArena as JArena
from workload_variant_autoscaler_tpu.solver import IncrementalSolveEngine as \
    JEngine
from workload_variant_autoscaler_tpu.solver import quantize as jquantize
import workload_variant_autoscaler_tpu_torch as port
from workload_variant_autoscaler_tpu_torch.ops.arena import CandidateArena
from workload_variant_autoscaler_tpu_torch.solver import (
    SOLVE_CACHED,
    SOLVE_INCREMENTAL,
    IncrementalSolveEngine,
    quantize,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's intra-op threads would spin on the cores the other test
    workers run on; these tensors are small, so one thread is enough."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-9
ROWS = test_incremental_solve.TestArenaParity.ROWS
EPI = dict(demand=[12.5, 0.0, 3.25], min_replicas=[1, 0, 3],
           cost_rate=[20.0, 80.0, 340.0])


def port_system(spec, dtype=torch.float64):
    system = port.System(device="cpu", dtype=dtype)
    opt = system.set_from_spec(port.spec_from_reference(asdict(spec)))
    return system, opt


def port_cycle(spec, engine, backend="kernel", rungs=None,
               cycle_rung="healthy"):
    """One analyze + optimize pass of the port through `engine`, as
    tests/test_incremental_solve.py's run_cycle drives the JAX engine."""
    system, opt = port_system(spec)
    stats = engine.calculate(system, backend=backend, optimizer_spec=opt,
                             rungs=rungs, cycle_rung=cycle_rung)
    port.Manager(system, port.Optimizer(opt)).optimize(
        warm=engine.warm_start())
    solution = system.generate_solution()
    engine.finish_cycle(system)
    return solution, stats


def stats_key(stats):
    return (stats.full, stats.reason, stats.lanes_solved,
            stats.lanes_skipped, stats.modes)


def assert_same_solution(got, ref, where):
    """The port's solution against the JAX package's: decisions exact,
    latencies within RTOL."""
    assert set(got.allocations) == set(ref.allocations), where
    for name, data in ref.allocations.items():
        mine = got.allocations[name]
        assert (mine.accelerator, mine.num_replicas, mine.max_batch,
                mine.cost) == (data.accelerator, data.num_replicas,
                               data.max_batch, data.cost), (where, name)
        assert asdict(mine.load) == asdict(data.load), (where, name)
        for f in ("itl_average", "ttft_average"):
            assert getattr(mine, f) == pytest.approx(
                getattr(data, f), rel=RTOL, abs=1e-12), (where, name, f)


# ---------------------------------------------------------------------------
# the resident arena
# ---------------------------------------------------------------------------

def list_pack(rows, dtype):
    return list_path_pack(rows, dtype, torch.device("cpu"))


def arena_pack(arena, rows, dtype):
    system = port.System(device="cpu", dtype=dtype)
    system.arena = arena
    return system._pack_group(rows)


def tensors(packed):
    q, slo, epi = packed
    out = {f"q.{k}": v for k, v in q._asdict().items()}
    out.update({f"slo.{k}": v for k, v in slo._asdict().items()})
    if epi is not None:
        out.update({f"epi.{k}": v for k, v in epi._asdict().items()})
    return out


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_arena_pack_is_bit_identical_to_list_path(dtype, epilogue):
    rows = dict(ROWS, **EPI) if epilogue else dict(ROWS)
    want = tensors(list_pack(rows, dtype))
    got = tensors(arena_pack(CandidateArena(), rows, dtype))
    assert set(got) == set(want)
    assert ("epi.demand" in got) == epilogue
    for name, t in want.items():
        assert got[name].dtype == t.dtype, name
        assert got[name].shape == (16,), name
        assert torch.equal(got[name], t), name


def test_arena_pack_matches_reference_arena():
    q, slo, epi = CandidateArena().pack(dict(ROWS, **EPI), device="cpu",
                                        dtype=torch.float64)
    jq, jslo, jepi = JArena().pack(dict(ROWS, **EPI))
    for mine, theirs in ((q, jq), (slo, jslo), (epi, jepi)):
        for name in mine._fields:
            np.testing.assert_array_equal(
                getattr(mine, name).numpy(),
                np.asarray(getattr(theirs, name)), err_msg=name)


def test_arena_slab_resident_and_stale_lanes_reset():
    arena = CandidateArena()
    arena_pack(arena, dict(ROWS), torch.float64)
    assert arena.slab_allocs == 1
    # a smaller pack reuses the slab and resets the stale lanes
    small = {k: v[:1] for k, v in ROWS.items()}
    q, _slo, _epi = arena_pack(arena, small, torch.float64)
    assert arena.slab_allocs == 1 and arena.packs == 2
    assert bool(q.valid[0]) and not bool(q.valid[1:].any())
    assert float(q.alpha[1]) == 1.0 and int(q.max_batch[1]) == 1
    assert torch.equal(q.alpha, list_pack(small, torch.float64)[0].alpha)


def test_system_packs_through_its_arena():
    """Each System owns an arena and sizes every group through it; the
    engine swaps in its own, which then serves the System's packs."""
    spec = make_spec([
        helpers.server_spec(name="busy:ns", model="m-a", arrival_rpm=600.0),
        helpers.server_spec(name="idle:ns", model="m-a", arrival_rpm=0.0),
    ], {})
    system, _ = port_system(spec)
    own = system.arena
    system.calculate(backend="batched")
    assert own.packs >= 1 and own.slab_allocs >= 1
    engine = IncrementalSolveEngine()
    system, opt = port_system(spec)
    engine.calculate(system, backend="batched", optimizer_spec=opt)
    assert system.arena is engine.arena and engine.arena.packs >= 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_second_pack_leaves_the_first_unchanged(dtype):
    """A pack's tensors own their memory: the next pack into the same
    resident slab must not rewrite them (in float64 on the CPU a
    `torch.as_tensor` of the slab would share it)."""
    arena = CandidateArena()
    rows = dict(ROWS, **EPI)
    first = tensors(arena_pack(arena, rows, dtype))
    before = {k: v.clone() for k, v in first.items()}
    other = {k: [x * 2 for x in v] if k != "max_batch" else [8, 9, 10]
             for k, v in rows.items()}
    second = tensors(arena_pack(arena, other, dtype))
    assert arena.slab_allocs == 1
    assert not torch.equal(second["q.alpha"], first["q.alpha"])
    for name, t in first.items():
        assert torch.equal(t, before[name]), name


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_quantize_matches_reference():
    for v in (0.0, -1.0, 1e-9, 96.0, 100.0, 123.456, 3.5e7):
        for eps in (0.0, 0.02, 0.05):
            assert quantize(v, eps) == jquantize(v, eps)


@pytest.mark.parametrize("unlimited,policy", [(True, "None"),
                                              (False, "RoundRobin")])
def test_churn_equals_from_scratch(unlimited, policy):
    """210 cycles of the JAX suite's seeded churn (grow/shrink,
    epsilon-straddling jitter, capacity changes, rung transitions,
    forced full every 7 cycles): the persistent port engine publishes
    exactly what a from-scratch port engine publishes, every cycle."""
    eps = 0.05
    fleet = ChurnDriver(seed=0x17C, epsilon=eps)
    engine = IncrementalSolveEngine(epsilon=eps, full_every=7)
    cached_cycles = forced_full = 0
    for cycle in range(210):
        fleet.churn()
        spec = make_spec(fleet.servers(), fleet.capacity, unlimited, policy)
        rung = "stale-cache" if fleet.rungs else "healthy"
        sol, stats = port_cycle(spec, engine, rungs=dict(fleet.rungs),
                                cycle_rung=rung)
        scratch = IncrementalSolveEngine(epsilon=eps, full_every=1)
        ref, _ = port_cycle(spec, scratch, rungs=dict(fleet.rungs),
                            cycle_rung=rung)
        assert sol == ref, cycle
        cached_cycles += stats.lanes_skipped > 0
        forced_full += stats.full and "forced" in stats.reason
    assert cached_cycles > 150
    assert forced_full >= 25


@pytest.mark.parametrize("unlimited,policy", [(True, "None"),
                                              (False, "RoundRobin")])
def test_engine_matches_reference_engine(unlimited, policy):
    """40 cycles of the same churn through the port's engine (backend
    "kernel") and the JAX engine (backend "batched"): equal decisions
    and SolveStats every cycle."""
    eps = 0.05
    fleet = ChurnDriver(seed=0x17C, epsilon=eps)
    mine = IncrementalSolveEngine(epsilon=eps, full_every=7)
    theirs = JEngine(epsilon=eps, full_every=7)
    warm = 0
    for cycle in range(40):
        fleet.churn()
        spec = make_spec(fleet.servers(), fleet.capacity, unlimited, policy)
        rung = "stale-cache" if fleet.rungs else "healthy"
        sol, stats = port_cycle(spec, mine, rungs=dict(fleet.rungs),
                                cycle_rung=rung)
        ref, ref_stats = run_cycle(spec, theirs, rungs=dict(fleet.rungs),
                                   cycle_rung=rung)
        assert_same_solution(sol, ref, cycle)
        assert stats_key(stats) == stats_key(ref_stats), cycle
        assert (mine.warm_start() is None) == (theirs.warm_start() is None)
        warm += mine._warm_ok
    assert warm > 20


def test_steady_state_skips_every_lane():
    """Zero churn: after the first cycle every lane is skipped, the
    zero-load fast path included."""
    engine = IncrementalSolveEngine(epsilon=0.02, full_every=0)
    servers = [
        helpers.server_spec(name="busy:ns", model="m-a", arrival_rpm=600.0),
        helpers.server_spec(name="idle:ns", model="m-a", arrival_rpm=0.0),
    ]
    _sol, first = port_cycle(make_spec(servers, {}), engine)
    assert first.full and first.lanes_solved > 0
    for _ in range(3):
        _sol, stats = port_cycle(make_spec(servers, {}), engine)
        assert not stats.full
        assert stats.lanes_solved == 0
        assert stats.lanes_skipped == first.lanes_solved
        assert stats.modes == {SOLVE_INCREMENTAL: 0, SOLVE_CACHED: 2}


def test_sub_epsilon_jitter_reads_as_unchanged():
    engine = IncrementalSolveEngine(epsilon=0.05, full_every=0)

    def servers(rpm):
        return [helpers.server_spec(name="v:ns", model="m-a",
                                    arrival_rpm=rpm)]

    port_cycle(make_spec(servers(600.0), {}), engine)
    # jitter well inside the bucket: same quantized inputs, lane skipped
    _sol, stats = port_cycle(make_spec(servers(600.6), {}), engine)
    assert stats.lanes_solved == 0 and stats.lanes_skipped > 0
    # a 30% step crosses buckets: re-solved
    _sol, stats = port_cycle(make_spec(servers(780.0), {}), engine)
    assert stats.lanes_solved > 0
    assert stats.modes[SOLVE_INCREMENTAL] == 1


# ---------------------------------------------------------------------------
# staged against fused
# ---------------------------------------------------------------------------

def staged_and_fused(monkeypatch, spec, backend, pct=None):
    out = {}
    for mode in ("off", "on"):
        monkeypatch.setenv("WVA_FUSED_SOLVE", mode)
        system, _ = port_system(spec)
        system.calculate(backend=backend, ttft_percentile=pct)
        out[mode] = system
    return out["off"], out["on"]


def assert_same_candidates(a, b):
    for name, server in a.servers.items():
        twin = b.servers[name].all_allocations
        assert set(server.all_allocations) == set(twin), name
        for acc, alloc in server.all_allocations.items():
            other = twin[acc]
            for f in ("num_replicas", "batch_size", "cost", "value",
                      "max_arrv_rate_per_replica"):
                assert getattr(other, f) == getattr(alloc, f), (name, acc, f)
            for f in ("itl", "ttft", "rho"):
                assert getattr(other, f) == pytest.approx(
                    getattr(alloc, f), rel=RTOL, abs=1e-12), (name, acc, f)


@pytest.mark.parametrize("backend", ["kernel", "batched"])
def test_staged_equals_fused_direct_calculate(monkeypatch, backend):
    """tests/test_fused.py's four servers (mean, percentile, zero-load and
    min-replica-clamped lanes) under a global p90: every allocation
    field equal between the two paths."""
    servers = [
        helpers.server_spec(name="mean:ns", model="llama-8b",
                            service_class="Freemium", arrival_rpm=1800.0),
        helpers.server_spec(name="tail:ns", model="llama-8b",
                            service_class="Premium", arrival_rpm=900.0),
        helpers.server_spec(name="idle:ns", model="llama-8b",
                            arrival_rpm=0.0),
        helpers.server_spec(name="floor:ns", model="llama-8b",
                            arrival_rpm=60.0, min_replicas=9),
    ]
    spec = SystemSpec(
        accelerators=list(helpers.SLICES), profiles=list(helpers.PROFILES),
        service_classes=list(helpers.SERVICE_CLASSES), servers=servers,
        optimizer=OptimizerSpec(unlimited=True))
    staged, fused = staged_and_fused(monkeypatch, spec, backend, pct=0.9)
    assert staged.last_unique_lanes == staged.last_solve_lanes - 3
    assert_same_candidates(staged, fused)
    floor = fused.servers["floor:ns"].all_allocations
    assert floor and all(a.num_replicas == 9 for a in floor.values())


def test_staged_equals_fused_over_churn(monkeypatch):
    """30 cycles of tests/test_fused.py's churn (p95 and mean groups,
    zero-load transitions, min-replica floors, grow/shrink): the
    persistent fused engine publishes exactly what a staged from-scratch
    engine publishes."""
    fleet = FusedChurnDriver(seed=0x5EED)
    fused_engine = IncrementalSolveEngine(epsilon=0.05, full_every=9)
    for cycle in range(30):
        fleet.churn()
        spec = SystemSpec(
            accelerators=list(SLICES), profiles=list(PROFILES),
            service_classes=list(FUSED_CLASSES), servers=fleet.servers(),
            capacity=dict(fleet.capacity), optimizer=OptimizerSpec())
        monkeypatch.setenv("WVA_FUSED_SOLVE", "on")
        sol_fused, _ = port_cycle(spec, fused_engine)
        monkeypatch.setenv("WVA_FUSED_SOLVE", "off")
        sol_staged, _ = port_cycle(
            spec, IncrementalSolveEngine(epsilon=0.05, full_every=1))
        assert_same_solution(sol_staged, sol_fused, cycle)
