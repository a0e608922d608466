"""The port's hierarchical engine, its checkpoint and the engine seam.

- `solver/hierarchy.py`: the port's `HierarchicalSolveEngine` publishes
  exactly what a from-scratch port engine publishes over the 210-cycle
  churn of tests/test_hier.py (both optimizer settings), and what the
  JAX hierarchical engine publishes over its first 40 cycles (decisions
  exact, latencies within rtol 1e-9, equal SolveStats, partition and
  capacity slices); its lane digests equal the JAX engine's; the stagger,
  shard-memo, warm-restart and checkpoint-corruption cases of
  tests/test_hier.py hold for it; its checkpoint payload after a drive
  equals the JAX engine's.
- `stream/checkpoint.py` and `CandidateArena.snapshot_slabs` /
  `restore_slabs`: exact round-trips, clean refusals.
- `controller/reconciler.py`: `SolveEngineSelector` picks and rebuilds
  engines as the reference Reconciler does.

Everything runs on the CPU in float64 with one torch thread; the port
runs backend "kernel" (the kernels' plain versions on the CPU), the JAX
package its "batched" backend, as tests/test_hier.py runs it.
"""

import json
from dataclasses import asdict

import numpy as np
import pytest
import torch

import helpers
from test_hier import make_v5e_spec
from test_incremental_solve import ChurnDriver, make_spec, run_cycle
from test_torch_incremental import (
    RTOL,
    ROWS,
    EPI,
    assert_same_solution,
    port_cycle,
    port_system,
)
from workload_variant_autoscaler_tpu.models import System as JSystem
from workload_variant_autoscaler_tpu.solver import (
    HierarchicalSolveEngine as JHier,
)
from workload_variant_autoscaler_tpu.solver import sig_digest as jsig_digest
from workload_variant_autoscaler_tpu_torch.controller import (
    SolveEngineSelector,
)
from workload_variant_autoscaler_tpu_torch.ops.arena import CandidateArena
from workload_variant_autoscaler_tpu_torch.solver import (
    HierarchicalSolveEngine,
    IncrementalSolveEngine,
    sig_digest,
)
from workload_variant_autoscaler_tpu_torch.stream.checkpoint import (
    ARENA_CHECKPOINT_MAGIC,
    ARENA_CHECKPOINT_VERSION,
    CheckpointError,
    load_checkpoint,
    save_checkpoint,
)

EPS = 0.05
SETTINGS = [(True, "None"), (False, "RoundRobin")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's intra-op threads would spin on the cores the other test
    workers run on; these tensors are small, so one thread is enough."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def hier_engine(cls=HierarchicalSolveEngine, **kw):
    """tests/test_hier.py's engine: epsilon 0.05, forced full every 7
    cycles, shards of 4 variants, no small-fleet floor."""
    kw.setdefault("epsilon", EPS)
    kw.setdefault("full_every", 7)
    kw.setdefault("shard_target", 4)
    kw.setdefault("min_variants", 1)
    return cls(**kw)


def scratch_cycle(spec, rungs=None, cycle_rung="healthy"):
    return port_cycle(spec, IncrementalSolveEngine(epsilon=EPS,
                                                   full_every=1),
                      rungs=rungs, cycle_rung=cycle_rung)


def churn_spec(fleet, unlimited=True, policy="None"):
    fleet.churn()
    rung = "stale-cache" if fleet.rungs else "healthy"
    spec = make_spec(fleet.servers(), fleet.capacity, unlimited, policy)
    return spec, dict(fleet.rungs), rung


def drive(engine, fleet, cycles, unlimited=True, policy="None"):
    """`cycles` churned cycles of the port through `engine`."""
    out = []
    for _ in range(cycles):
        spec, rungs, rung = churn_spec(fleet, unlimited, policy)
        out.append(port_cycle(spec, engine, rungs=rungs, cycle_rung=rung))
    return out


def partition_key(part):
    return (part.n_shards, part.shard_of, part.members, part.pool_sets)


# ---------------------------------------------------------------------------
# equivalence: the two-level solve is invisible in the decisions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("unlimited,policy", SETTINGS)
def test_churn_equals_from_scratch(unlimited, policy):
    """tests/test_hier.py's 210 cycles (ChurnDriver seed 0x41E5): the
    port's hierarchical engine (shards of 4, staggered forced-full every
    7 cycles) publishes exactly what a from-scratch port engine
    publishes, every cycle."""
    fleet = ChurnDriver(seed=0x41E5, epsilon=EPS)
    engine = hier_engine()
    cached_cycles = forced_lanes = 0
    for cycle in range(210):
        spec, rungs, rung = churn_spec(fleet, unlimited, policy)
        sol, stats = port_cycle(spec, engine, rungs=rungs, cycle_rung=rung)
        ref, _ = scratch_cycle(spec, rungs=rungs, cycle_rung=rung)
        assert sol == ref, cycle
        cached_cycles += stats.lanes_skipped > 0
        forced_lanes += stats.modes.get("full", 0)
    assert cached_cycles > 100, cached_cycles
    assert forced_lanes > 50, forced_lanes


@pytest.mark.parametrize("unlimited,policy", SETTINGS)
def test_matches_reference_hierarchical_engine(unlimited, policy):
    """The first 40 cycles of the same churn through the port's engine
    and the JAX one: equal decisions and SolveStats (shards, shards
    solved, restored and modes included), equal partitions and capacity
    slices, and the same warm-greedy gate, every cycle."""
    fleet = ChurnDriver(seed=0x41E5, epsilon=EPS)
    mine, theirs = hier_engine(), hier_engine(JHier)
    warm = 0
    for cycle in range(40):
        spec, rungs, rung = churn_spec(fleet, unlimited, policy)
        sol, stats = port_cycle(spec, mine, rungs=rungs, cycle_rung=rung)
        ref, ref_stats = run_cycle(spec, theirs, rungs=dict(rungs),
                                   cycle_rung=rung)
        assert_same_solution(sol, ref, cycle)
        assert asdict(stats) == asdict(ref_stats), cycle
        assert stats.shards > 1
        assert partition_key(mine.last_partition) \
            == partition_key(theirs.last_partition), cycle
        assert mine.last_capacity_slices == theirs.last_capacity_slices
        assert (mine.warm_start() is None) == (theirs.warm_start() is None)
        warm += mine._warm_ok
    assert warm > 10, warm


@pytest.mark.parametrize("pct", [None, 0.9])
def test_lane_digests_match_reference(pct):
    """The same fleet's lane signatures digest alike in both packages,
    through sig_digest and the engine's memoized _lane_digest: a
    checkpoint of one names the lanes of the other."""
    fleet = ChurnDriver(seed=0x41E5, epsilon=EPS)
    for _ in range(6):
        fleet.churn()
    spec = make_spec(fleet.servers(), fleet.capacity)
    mine, theirs = hier_engine(), hier_engine(JHier)
    system, _ = port_system(spec)
    jsystem = JSystem()
    jsystem.set_from_spec(spec)
    rungs = {n: "stale-cache" for n in sorted(system.servers)[::3]}
    for name, server in system.servers.items():
        rung = rungs.get(name, "healthy")
        sig = mine._lane_signature(system, server, pct, rung)
        jsig = theirs._lane_signature(jsystem, jsystem.servers[name], pct,
                                      rung)
        assert sig_digest(sig) == jsig_digest(jsig), name
        assert mine._lane_digest(sig) == theirs._lane_digest(jsig), name
        assert mine._lane_digest(sig) == mine._lane_digest(sig)


def test_limited_homogeneous_fleet_matches_reference():
    """tests/test_hier.py's v5e-only limited fleet, 60 cycles: every
    candidate set is one generation; the port's engine equals the
    from-scratch port engine and the JAX hierarchical engine, and its
    partition keys single-generation components."""
    fleet = ChurnDriver(seed=0xB0B, epsilon=EPS)
    mine, theirs = hier_engine(), hier_engine(JHier)
    for cycle in range(60):
        fleet.churn()
        rung = "stale-cache" if fleet.rungs else "healthy"
        spec = make_v5e_spec(fleet.servers(), fleet.capacity)
        sol, stats = port_cycle(spec, mine, rungs=dict(fleet.rungs),
                                cycle_rung=rung)
        ref, _ = scratch_cycle(spec, rungs=dict(fleet.rungs),
                               cycle_rung=rung)
        assert sol == ref, cycle
        jsol, jstats = run_cycle(spec, theirs, rungs=dict(fleet.rungs),
                                 cycle_rung=rung)
        assert_same_solution(sol, jsol, cycle)
        assert asdict(stats) == asdict(jstats), cycle
        assert stats.shards >= 1
    assert mine.last_capacity_slices is not None
    pool_sets = mine.last_partition.pool_sets.values()
    assert all(pools <= {"v5e"} for pools in pool_sets)
    assert any(pools == {"v5e"} for pools in pool_sets)


@pytest.mark.parametrize("pinned", [False, True])
def test_partition_follows_candidate_accelerators(pinned):
    """Limited mode: the partition unions the chip generations of every
    server's candidate accelerators, which is the whole catalog unless
    keep_accelerator pins the server. Unpinned, this fleet is one
    component although model m-a is profiled on v5e slices only; pinned
    (m-a to v5e-1, m-b to v5p-4), it splits by generation. Equal to the
    JAX engine's partition either way."""
    servers = [helpers.server_spec(
        name=f"v{i}:ns", model="m-b" if i % 2 else "m-a",
        accelerator="v5p-4" if i % 2 else "v5e-1", keep_accelerator=pinned,
        arrival_rpm=300.0 + 40.0 * i) for i in range(12)]
    spec = make_spec(servers, {"v5e": 400, "v5p": 120}, False, "RoundRobin")
    mine, theirs = hier_engine(), hier_engine(JHier)
    system, opt = port_system(spec)
    jsystem = JSystem()
    jopt = jsystem.set_from_spec(spec)
    part = mine._partition(system, opt)
    assert partition_key(part) == partition_key(theirs._partition(jsystem,
                                                                  jopt))
    pools = sorted(map(sorted, part.pool_sets.values()))
    assert pools == ([["v5e"], ["v5p"]] if pinned else [["v5e", "v5p"]])
    assert mine._reconcile_capacity(system, part) == {
        sid: {g: spec.capacity[g] for g in p}
        for sid, p in part.pool_sets.items()}


def test_unlimited_shard_memo_prunes_deleted_servers():
    def fleet(n, bump=0.0):
        return [helpers.server_spec(name=f"v{i}:ns", model="m-a",
                                    arrival_rpm=300.0 + bump + 40.0 * i)
                for i in range(n)]

    # shard_target=100 keeps n_shards constant across the shrink, so
    # pruning (not the n_shards-change reset) is what is exercised
    engine = hier_engine(shard_target=100)
    port_cycle(make_spec(fleet(9), {}), engine)
    assert len(engine._shard_of_memo) == 9
    port_cycle(make_spec(fleet(3, bump=1000.0), {}), engine)
    assert set(engine._shard_of_memo) == {f"v{i}:ns" for i in range(3)}


def test_empty_cycle_leaves_the_system_its_arena():
    """A cycle with nothing to solve still runs System.calculate (with
    only=set()), and the System keeps an arena it can pack through; after
    a cycle that solved shards it holds its own arena again, not a
    shard's."""
    servers = [helpers.server_spec(name=f"v{i}:ns", model="m-a",
                                   arrival_rpm=300.0 + 40.0 * i)
               for i in range(6)]
    spec = make_spec(servers, {})
    engine = hier_engine(full_every=0)
    for expect_lanes in (True, False):
        system, opt = port_system(spec)
        own = system.arena
        stats = engine.calculate(system, backend="kernel", optimizer_spec=opt)
        assert (stats.lanes_solved > 0) == expect_lanes
        assert (stats.shards_solved > 0) == expect_lanes
        assert system.arena is own
        assert all(system.arena is not a
                   for a in engine._shard_arenas.values())
        engine.finish_cycle(system)
        # the System can still size on its own after the engine's cycle
        system.calculate(backend="kernel")
        assert system.last_solve_lanes > 0 and own.packs >= 1


# ---------------------------------------------------------------------------
# staggered forced-full phases
# ---------------------------------------------------------------------------

def test_stagger_never_resolves_whole_fleet_in_one_cycle():
    full_every = 4
    servers = [helpers.server_spec(name=f"v{i}:ns", model="m-a",
                                   arrival_rpm=300.0 + 40.0 * i)
               for i in range(24)]
    spec = make_spec(servers, {"v5e": 4000})
    engine = hier_engine(full_every=full_every, shard_target=2)
    _, stats = port_cycle(spec, engine)     # all-forced cycle
    n_shards = stats.shards
    assert n_shards > full_every
    per_cycle = []
    for _ in range(full_every):
        _, stats = port_cycle(spec, engine)
        per_cycle.append(stats.modes.get("full", 0))
    assert sum(per_cycle) == len(servers), per_cycle
    assert max(per_cycle) < len(servers), per_cycle
    worst_shards = -(-n_shards // full_every)
    assert max(per_cycle) <= worst_shards * (
        -(-len(servers) // n_shards) + 2), (per_cycle, n_shards)


def test_stagger_phases_cover_all_residues_as_reference():
    phases = [HierarchicalSolveEngine._phase(sid, 16) for sid in range(64)]
    assert set(phases) == set(range(16))
    assert phases == [JHier._phase(sid, 16) for sid in range(64)]


# ---------------------------------------------------------------------------
# warm cold-start: the arena checkpoint
# ---------------------------------------------------------------------------

class TestWarmColdStart:
    @pytest.mark.parametrize("unlimited,policy", SETTINGS)
    def test_restored_equals_never_restarted(self, tmp_path, unlimited,
                                             policy):
        """A restarted engine restored from its checkpoint decides what
        the engine that never went away decides; its restore cycle is
        incremental, not the cold all-forced pass, and an unchanged fleet
        solves no lane on it. The greedy writes allocations in limited
        mode, and the checkpoint still saves without an error."""
        path = str(tmp_path / "arena.ckpt")
        da, db = (ChurnDriver(seed=7, epsilon=EPS),
                  ChurnDriver(seed=7, epsilon=EPS))
        a = hier_engine(checkpoint_path=path, checkpoint_every=1)
        b = hier_engine()
        for sa, sb in zip(drive(a, da, 12, unlimited, policy),
                          drive(b, db, 12, unlimited, policy)):
            assert sa[0] == sb[0]
        assert a.ckpt_events["save"] == 12, a.ckpt_events
        assert a.ckpt_events["save_error"] == 0, a.ckpt_events

        a2 = hier_engine(checkpoint_path=path, checkpoint_every=1)
        assert a2.ckpt_events["restore"] == 1, a2.ckpt_events
        # the unchanged fleet first: the restored engine solves nothing
        spec = make_spec(da.servers(), da.capacity, unlimited, policy)
        rung = "stale-cache" if da.rungs else "healthy"
        sol, first = port_cycle(spec, a2, rungs=dict(da.rungs),
                                cycle_rung=rung)
        ref, _ = port_cycle(spec, b, rungs=dict(db.rungs), cycle_rung=rung)
        assert first.restored and not first.full
        assert first.lanes_solved == 0 and first.shards_solved == 0
        assert sol == ref
        for cycle, (sa, sb) in enumerate(zip(
                drive(a2, da, 14, unlimited, policy),
                drive(b, db, 14, unlimited, policy))):
            assert not sa[1].restored
            assert sa[0] == sb[0], cycle
        assert a2.ckpt_events["save_error"] == 0

    def test_restored_arena_slabs_equal_the_saved_ones(self, tmp_path):
        path = str(tmp_path / "arena.ckpt")
        a = hier_engine(checkpoint_path=path, checkpoint_every=1,
                        full_every=32)
        drive(a, ChurnDriver(seed=7, epsilon=EPS), 5)
        saved = {sid: arena.snapshot_slabs()
                 for sid, arena in a._shard_arenas.items()}
        a2 = hier_engine(checkpoint_path=path, checkpoint_every=1,
                         full_every=32)
        for sid in saved:
            assert a2._shard_arena(sid).snapshot_slabs() == saved[sid]
        assert not a2._restored_arena

    def test_checkpoint_saves_respect_cadence(self, tmp_path):
        path = str(tmp_path / "arena.ckpt")
        engine = hier_engine(checkpoint_path=path, checkpoint_every=4)
        drive(engine, ChurnDriver(seed=3, epsilon=EPS), 9)
        # cycles 4 and 8 save; 1-3/5-7/9 don't
        assert engine.ckpt_events["save"] == 2, engine.ckpt_events
        assert engine.drain_ckpt_events() == {"save": 2}
        assert not any(engine.ckpt_events.values())

    def test_unserializable_value_is_a_save_error(self, tmp_path):
        """A value JSON cannot hold (a numpy integer in a cached
        allocation) is counted as a save error, never raised."""
        path = str(tmp_path / "arena.ckpt")
        engine = hier_engine(checkpoint_path=path, checkpoint_every=1)
        drive(engine, ChurnDriver(seed=3, epsilon=EPS), 1)
        assert engine.ckpt_events["save"] == 1
        name = next(iter(engine._alloc_cache))
        alloc = next(iter(engine._alloc_cache[name].values()))
        alloc.num_replicas = np.int64(alloc.num_replicas)
        engine.maybe_checkpoint()
        assert engine.ckpt_events["save_error"] == 1

    @pytest.mark.parametrize("unlimited,policy", SETTINGS)
    def test_payload_matches_reference_engine(self, unlimited, policy):
        """After the same 9-cycle drive, the port's checkpoint payload
        equals the JAX engine's in every key but `taken_at` and the
        backend slot of `analyze_sig` (the port runs "kernel", the JAX
        package "batched"): lane digests, value signatures, pools, shard
        digests and the solve signature exactly; cached allocations and
        choices with their latencies within RTOL; the shard arenas'
        slabs bucket for bucket and byte for byte (both packages pack
        the same deduped rows in the same order)."""
        fleet = ChurnDriver(seed=11, epsilon=EPS)
        mine, theirs = hier_engine(), hier_engine(JHier)
        for _ in range(9):
            spec, rungs, rung = churn_spec(fleet, unlimited, policy)
            port_cycle(spec, mine, rungs=rungs, cycle_rung=rung)
            run_cycle(spec, theirs, rungs=dict(rungs), cycle_rung=rung)
        got = json.loads(json.dumps(mine._checkpoint_payload()))
        want = json.loads(json.dumps(theirs._checkpoint_payload()))
        assert set(got) == set(want)
        assert got["analyze_sig"][0] == "kernel"
        assert want["analyze_sig"][0] == "batched"
        for key in ("cycle", "config", "solve_sig", "shard_digests",
                    "pools", "complete", "arena_mesh"):
            assert got[key] == want[key], key
        assert got["analyze_sig"][1:] == want["analyze_sig"][1:]
        assert got["arena"] == want["arena"]
        assert got["arena"], "no shard arena was snapshotted"

        def same_alloc(a, b, where):
            assert set(a) == set(b), where
            for f in ("accelerator", "num_replicas", "batch_size", "cost",
                      "value"):
                assert a[f] == b[f], (where, f)
            for f in ("itl", "ttft", "rho", "max_arrv_rate_per_replica"):
                assert a[f] == pytest.approx(b[f], rel=RTOL, abs=1e-12), \
                    (where, f)

        assert set(got["lanes"]) == set(want["lanes"])
        for name, rec in want["lanes"].items():
            mine_rec = got["lanes"][name]
            assert mine_rec["sig"] == rec["sig"], name
            assert mine_rec["value_sig"] == rec["value_sig"], name
            assert set(mine_rec["allocs"]) == set(rec["allocs"]), name
            for acc, d in rec["allocs"].items():
                same_alloc(mine_rec["allocs"][acc], d, (name, acc))
        assert set(got["choice"]) == set(want["choice"])
        for name, d in want["choice"].items():
            same_alloc(got["choice"][name], d, name)


class TestCheckpointCorruption:
    """Torn / CRC / version-skew / stale-age / config / mangled-body
    checkpoints each fall back to the cold full pass, with the right
    event: no crash, no partial restore."""

    @pytest.fixture()
    def saved(self, tmp_path):
        path = str(tmp_path / "arena.ckpt")
        engine = hier_engine(checkpoint_path=path, checkpoint_every=1)
        drive(engine, ChurnDriver(seed=11, epsilon=EPS), 6)
        return path

    def _assert_cold(self, engine, event):
        assert engine.ckpt_events[event] == 1, engine.ckpt_events
        assert engine.ckpt_events["restore"] == 0, engine.ckpt_events
        assert not engine._alloc_cache and not engine._restored_digests
        assert not engine._restored_arena
        _, stats = drive(engine, ChurnDriver(seed=11, epsilon=EPS), 1)[0]
        assert stats.full and not stats.restored

    def test_torn_file(self, saved):
        raw = open(saved, "rb").read()
        open(saved, "wb").write(raw[: len(raw) // 2])
        self._assert_cold(hier_engine(checkpoint_path=saved),
                          "discard_corrupt")

    def test_crc_flip(self, saved):
        raw = bytearray(open(saved, "rb").read())
        raw[-5] ^= 0xFF
        open(saved, "wb").write(bytes(raw))
        self._assert_cold(hier_engine(checkpoint_path=saved),
                          "discard_corrupt")

    def test_version_skew(self, saved):
        payload = load_checkpoint(saved, magic=ARENA_CHECKPOINT_MAGIC,
                                  version=ARENA_CHECKPOINT_VERSION)
        save_checkpoint(saved, payload, magic=ARENA_CHECKPOINT_MAGIC,
                        version=ARENA_CHECKPOINT_VERSION + 1)
        self._assert_cold(hier_engine(checkpoint_path=saved),
                          "discard_corrupt")

    def test_stale_age(self, saved):
        self._assert_cold(
            hier_engine(checkpoint_path=saved, checkpoint_max_age_s=1e-6),
            "discard_stale")

    def test_config_mismatch(self, saved):
        self._assert_cold(hier_engine(checkpoint_path=saved, epsilon=0.01),
                          "discard_config")

    def test_missing_file_is_silent(self, tmp_path):
        engine = hier_engine(
            checkpoint_path=str(tmp_path / "never-written.ckpt"))
        assert not any(engine.ckpt_events.values())
        _, stats = drive(engine, ChurnDriver(seed=11, epsilon=EPS), 1)[0]
        assert stats.full and not stats.restored

    def test_mangled_body_fields(self, saved):
        payload = load_checkpoint(saved, magic=ARENA_CHECKPOINT_MAGIC,
                                  version=ARENA_CHECKPOINT_VERSION)
        payload["lanes"] = "not-a-dict"
        save_checkpoint(saved, payload, magic=ARENA_CHECKPOINT_MAGIC,
                        version=ARENA_CHECKPOINT_VERSION)
        self._assert_cold(hier_engine(checkpoint_path=saved),
                          "discard_corrupt")

    def test_stream_and_arena_magics_are_disjoint(self, tmp_path):
        path = str(tmp_path / "x.ckpt")
        save_checkpoint(path, {"taken_at": 1.0})
        with pytest.raises(CheckpointError):
            load_checkpoint(path, magic=ARENA_CHECKPOINT_MAGIC,
                            version=ARENA_CHECKPOINT_VERSION)
        save_checkpoint(path, {"taken_at": 1.0},
                        magic=ARENA_CHECKPOINT_MAGIC,
                        version=ARENA_CHECKPOINT_VERSION)
        with pytest.raises(CheckpointError):
            load_checkpoint(path)
        assert load_checkpoint(path, magic=ARENA_CHECKPOINT_MAGIC,
                               version=ARENA_CHECKPOINT_VERSION) \
            == {"taken_at": 1.0}


def test_checkpoint_files_read_across_packages(tmp_path):
    """The container is the reference's byte for byte: each package
    loads what the other saved."""
    from workload_variant_autoscaler_tpu.stream import checkpoint as jckpt

    payload = {"taken_at": 1.5, "lanes": {"v0:ns": [1, 2.25, None]}}
    for saver, loader in ((save_checkpoint, jckpt.load_checkpoint),
                          (jckpt.save_checkpoint, load_checkpoint)):
        path = str(tmp_path / "x.ckpt")
        saver(path, payload, magic=ARENA_CHECKPOINT_MAGIC,
              version=ARENA_CHECKPOINT_VERSION)
        assert loader(path, magic=jckpt.ARENA_CHECKPOINT_MAGIC,
                      version=jckpt.ARENA_CHECKPOINT_VERSION) == payload
    save_checkpoint(path, payload)
    raw = open(path, "rb").read()
    jckpt.save_checkpoint(path, payload)
    assert open(path, "rb").read() == raw


# ---------------------------------------------------------------------------
# the arena's slab snapshot
# ---------------------------------------------------------------------------

def packed_arena():
    arena = CandidateArena()
    for rows in (dict(ROWS, **EPI), {k: v[:1] for k, v in ROWS.items()},
                 {k: v * 7 for k, v in dict(ROWS, **EPI).items()}):
        arena.pack(rows, device="cpu", dtype=torch.float64)
    return arena


def test_arena_snapshot_round_trips_bytes():
    arena = packed_arena()
    assert sorted(arena._slabs) == [16, 32]
    snap = json.loads(json.dumps(arena.snapshot_slabs()))
    twin = CandidateArena()
    twin.restore_slabs(snap)
    assert sorted(twin._slabs) == sorted(arena._slabs)
    for b, slab in arena._slabs.items():
        for name, buf in slab.items():
            got = twin._slabs[b][name]
            assert got.dtype == buf.dtype and got.tobytes() == buf.tobytes()
            assert got.flags.writeable and got is not buf
    assert twin.snapshot_slabs() == snap
    # a restored slab packs like the original
    rows = {k: v[:2] for k, v in dict(ROWS, **EPI).items()}
    for mine, theirs in zip(twin.pack(rows, device="cpu",
                                      dtype=torch.float64),
                            arena.pack(rows, device="cpu",
                                       dtype=torch.float64)):
        for a, b in zip(mine, theirs):
            assert torch.equal(a, b)


def test_arena_snapshot_matches_reference_arena():
    from workload_variant_autoscaler_tpu.ops.arena import (
        CandidateArena as JArena,
    )

    mine, theirs = CandidateArena(), JArena()
    for rows in (dict(ROWS, **EPI), {k: v[:1] for k, v in ROWS.items()}):
        mine.pack(rows, device="cpu", dtype=torch.float64)
        theirs.pack(rows)
    assert mine.snapshot_slabs() == theirs.snapshot_slabs()
    twin = CandidateArena()
    twin.restore_slabs(theirs.snapshot_slabs())
    assert twin.snapshot_slabs() == mine.snapshot_slabs()


def _mangle_unknown(snap):
    snap["16"]["bogus"] = snap["16"]["alpha"]


def _mangle_missing(snap):
    del snap["32"]["tps"]


def _mangle_length(snap):
    rec = snap["32"]["alpha"]
    rec["data"] = snap["16"]["alpha"]["data"]


@pytest.mark.parametrize("mangle", [_mangle_unknown, _mangle_missing,
                                    _mangle_length])
def test_arena_restore_refuses_and_commits_nothing(mangle):
    """An unknown or missing column, or a slab of the wrong length, is a
    ValueError; the arena keeps its slabs as they were, including the
    buckets of the snapshot that did validate."""
    snap = packed_arena().snapshot_slabs()
    mangle(snap)
    arena = CandidateArena()
    arena.pack({k: v[:1] for k, v in ROWS.items()}, device="cpu",
               dtype=torch.float64)
    before = arena.snapshot_slabs()
    with pytest.raises(ValueError):
        arena.restore_slabs(snap)
    assert arena.snapshot_slabs() == before


# ---------------------------------------------------------------------------
# the reconciler's engine selection
# ---------------------------------------------------------------------------

class TestEngineSelection:
    def test_off_restores_the_flat_engine_class(self):
        """WVA_HIER_SOLVE=off hands back the flat class itself, not a
        subclass with a high floor; flipping back rebuilds the
        hierarchical engine."""
        seam = SolveEngineSelector()
        engine = seam._solve_engine({"WVA_HIER_SOLVE": "off"})
        assert type(engine) is IncrementalSolveEngine
        assert seam._solve_engine({"WVA_HIER_SOLVE": "off"}) is engine
        engine2 = seam._solve_engine({"WVA_HIER_SOLVE": "auto"})
        assert type(engine2) is HierarchicalSolveEngine

    def test_auto_defaults_and_knob_plumbing(self, tmp_path):
        seam = SolveEngineSelector()
        e = seam._solve_engine({})
        assert type(e) is HierarchicalSolveEngine
        assert e.min_variants == 2048 and e.shard_target == 1024
        assert e.full_every == 32 and e.epsilon == 0.02
        assert e.checkpoint_path is None and e.checkpoint_every == 8
        assert e.checkpoint_max_age_s == 3600.0
        assert seam._solve_engine({}) is e          # stable across cycles
        path = str(tmp_path / "wva-arena-test.ckpt")
        e2 = seam._solve_engine({
            "WVA_HIER_SOLVE": "on",
            "WVA_HIER_SHARD_VARIANTS": "256",
            "WVA_ARENA_CHECKPOINT": path,
            "WVA_ARENA_CHECKPOINT_EVERY": "4",
            "WVA_ARENA_CHECKPOINT_MAX_AGE_S": "120"})
        assert e2 is not e and seam.engine is e2
        assert e2.min_variants == 0 and e2.shard_target == 256
        assert e2.checkpoint_path == path
        assert e2.checkpoint_every == 4
        assert e2.checkpoint_max_age_s == 120.0

    def test_environment_first_then_the_configmap(self, monkeypatch):
        seam = SolveEngineSelector(operator_cm={"WVA_SOLVE_FULL_EVERY": "9"})
        assert seam._solve_engine().full_every == 9
        monkeypatch.setenv("WVA_SOLVE_FULL_EVERY", "5")
        assert seam._solve_engine().full_every == 5
        monkeypatch.setenv("WVA_INCREMENTAL_SOLVE", "off")
        assert seam._solve_engine() is None and seam.engine is None
        monkeypatch.delenv("WVA_INCREMENTAL_SOLVE")
        assert seam._hier_solve_mode({"WVA_HIER_SOLVE": "enabled"}) == "on"
        assert seam._hier_solve_mode({"WVA_HIER_SOLVE": "junk"}) == "auto"
        # a malformed or negative value falls back to the default
        engine = seam._solve_engine({"WVA_SOLVE_EPSILON": "-1",
                                     "WVA_HIER_MIN_VARIANTS": "nan"})
        assert engine.epsilon == 0.02 and engine.min_variants == 2048

    def test_small_fleet_delegates_to_flat_path(self):
        engine = hier_engine(min_variants=1000)
        _, stats = drive(engine, ChurnDriver(seed=5, epsilon=EPS), 1)[0]
        assert stats.shards == 0 and stats.shards_solved == 0
        assert not stats.restored
        forced = hier_engine(min_variants=0)
        _, stats = drive(forced, ChurnDriver(seed=5, epsilon=EPS), 1)[0]
        assert stats.shards > 0
