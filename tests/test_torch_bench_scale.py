"""The port's engine-scale benchmarks (bench_torch_shard.py,
bench_torch_hier.py) against bench_shard.py and bench_hier.py on the same
inputs, at smoke sizes.

The port runs `device="cpu"` in float64 on an 8-entry lane mesh of the
CPU (`--mesh-devices 8`), the JAX side on its forced 8-device host mesh
in float64 with its batched backend. The JAX scripts force that device
count when imported, which only works before JAX initializes, so the JAX
side runs in a fresh process: this file run as a script (`jax_side`)
imports them there, spies on the calls the comparison needs and prints
one JSON line. Compared exactly: the 128-variant churn's steady-state
counters (retraces, readbacks and uploads per cycle, the readbacks across
the sharded boundary); the decisions of every timed forced-full cycle at
64 variants, sharded and unsharded; the sequential greedy's allocations
at GREEDY_N variants (the port's vector greedy must equal them too); per
hierarchical smoke size the shard count, the variants forced in each
cycle of the stagger window and the window's decisions; the warm
restart's lanes solved. Walls are never compared; nothing here asserts
a wall-clock bound.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch_hier as ph  # noqa: E402
import bench_torch_shard as ps  # noqa: E402
from workload_variant_autoscaler_tpu_torch.parallel import Mesh  # noqa: E402

CPU = {"device": "cpu", "dtype": torch.float64}
LANES8 = Mesh(("cpu",) * 8, "lanes")
FORCED_N = 64
GREEDY_N = 256


def jax_side() -> dict:
    """Runs in a fresh process (bench_shard and bench_hier force an
    8-device host mesh when imported): what the comparison needs of the
    JAX scripts, from their own functions."""
    import bench_hier as jh
    import bench_shard as js
    from workload_variant_autoscaler_tpu.models import (
        SaturationPolicy,
        System,
    )
    from workload_variant_autoscaler_tpu.solver.greedy import solve_greedy

    digest = ps.digest
    seen: list = []
    generate = System.generate_solution

    def spy(self):
        sol = generate(self)
        seen.append(digest({n: (a.accelerator, a.num_replicas)
                            for n, a in sol.allocations.items()}))
        return sol

    System.generate_solution = spy
    out = {"steady": js.churn_run(js.SMOKE_SIZES[1]), "forced": {}}
    for sharded in (False, True):
        seen.clear()
        js.forced_full_walls(FORCED_N, sharded)
        out["forced"][str(sharded)] = seen[1:]    # the timed cycles

    system = System()
    system.set_from_spec(js.fleet_spec(GREEDY_N, distinct_loads=True,
                                       limited=True))
    system.calculate(backend="batched")
    os.environ["WVA_VECTOR_GREEDY"] = "off"
    solve_greedy(system, SaturationPolicy.NONE)
    out["greedy"] = digest({s.name: (s.allocation.accelerator,
                                     s.allocation.num_replicas)
                            for s in system.servers.values()})

    forced_lanes: list = []
    hier_cycle = jh._cycle

    def spy_cycle(spec, engine, fm):
        wall, stats = hier_cycle(spec, engine, fm)
        forced_lanes.append(stats.modes.get("full", 0))
        return wall, stats

    jh._cycle = spy_cycle
    out["hier"] = {}
    for n in jh.SMOKE_SIZES:
        forced_lanes.clear()
        seen.clear()
        walls = jh.hier_forced_walls(n, shard_target=64)
        out["hier"][str(n)] = {"shards": walls["shards"],
                               "forced_lanes": forced_lanes[1:],
                               "decisions": sorted(set(seen[1:]))}
    out["restart"] = jh.restart_leg(jh.SMOKE_SIZES[1], shard_target=64,
                                    in_process=True)
    out["constants"] = {
        "shard": [js.MESH_DEVICES, js.STEADY_CYCLES, list(js.SIZES),
                  list(js.SMOKE_SIZES), js.GREEDY_N],
        "hier": [list(jh.SIZES), list(jh.SMOKE_SIZES), jh.CYCLE_INTERVAL_S,
                 jh.FULL_EVERY, jh.SHARD_TARGET, jh.EPSILON],
        "specs": {name: [dataclasses.asdict(js.fleet_spec(8, **kw))]
                  for name, kw in SPEC_KW.items()},
    }
    return out


SPEC_KW = {"plain": {}, "distinct": {"distinct_loads": True},
           "limited": {"distinct_loads": True, "limited": True},
           "step": {"load_step": 75.0}}


@pytest.fixture(scope="module")
def jax():
    env = dict(os.environ, JAX_PLATFORMS="cpu", LOG_LEVEL="error",
               WVA_NATIVE_KERNEL="false")
    env.pop("WVA_SHARDED_FLEET", None)
    env.pop("WVA_VECTOR_GREEDY", None)
    r = subprocess.run([sys.executable, __file__], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    for knob in ("WVA_VECTOR_GREEDY", "WVA_FUSED_SOLVE"):
        monkeypatch.delenv(knob, raising=False)
    torch.set_num_threads(1)


def test_constants_equal(jax):
    assert jax["constants"]["shard"] == [
        ps.MESH_DEVICES, ps.STEADY_CYCLES, list(ps.SIZES),
        list(ps.SMOKE_SIZES), ps.GREEDY_N]
    assert jax["constants"]["hier"] == [
        list(ph.SIZES), list(ph.SMOKE_SIZES), ph.CYCLE_INTERVAL_S,
        ph.FULL_EVERY, ph.SHARD_TARGET, ph.EPSILON]


@pytest.mark.parametrize("name", sorted(SPEC_KW))
def test_fleet_spec_equal(jax, name):
    mine = dataclasses.asdict(ps.fleet_spec(8, **SPEC_KW[name]))
    assert json.loads(json.dumps([mine])) == jax["constants"]["specs"][name]


def test_churn_counters_equal(jax):
    """The 10-cycle churn on the 8-entry lane mesh: one readback per
    cycle, across the sharded boundary, as in the JAX script."""
    mine = ps.churn_run(ps.SMOKE_SIZES[1], LANES8, **CPU)
    ps.hold_churn(mine)
    for key in ("cycles", "retraces_total", "d2h_per_cycle",
                "h2d_per_cycle", "sharded_d2h_per_cycle"):
        assert mine[key] == jax["steady"][key], key
    assert mine["mesh_entries"] == 8 and mine["mesh_cards"] == 1
    k = mine["kernel_launches"]
    assert k["cycles"] == ps.STEADY_CYCLES and k["B1"] == k["B2"] == 0


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["unsharded", "sharded"])
def test_forced_full_decisions_equal(jax, sharded):
    mine = ps.forced_full_walls(FORCED_N, LANES8 if sharded else None, **CPU)
    assert mine["decisions"] == jax["forced"][str(sharded)]
    assert len(mine["analyze_optimize_ms"]) == 5


def test_measure_holds_sharded_equal_to_unsharded(jax):
    walls = ps.measure((FORCED_N,), LANES8, **CPU)[str(FORCED_N)]
    assert walls["decisions_equal"]
    assert walls["sharded"]["decisions"] == jax["forced"]["True"]


def test_greedy_equal_vector_on_and_off(jax):
    """The port's greedy, vector sweep on and off, allocates as the JAX
    sequential greedy does."""
    mine = ps.greedy_compare(GREEDY_N, **CPU)
    assert mine["allocations_equal"]
    assert mine["decisions"] == jax["greedy"]
    assert "WVA_VECTOR_GREEDY" not in os.environ


@pytest.mark.parametrize("n", ph.SMOKE_SIZES)
def test_hier_stagger_equal(jax, n):
    """Per smoke size: the shard count, the variants forced in each cycle
    of the stagger window, and the window's decisions."""
    mine = ph.hier_forced_walls(n, LANES8, ph.SMOKE_SHARD_TARGET, **CPU)
    want = jax["hier"][str(n)]
    assert mine["shards"] == want["shards"]
    assert mine["forced_lanes"] == want["forced_lanes"]
    assert mine["decisions"] == want["decisions"]
    assert sum(mine["forced_lanes"]) == n


@pytest.mark.parametrize("n", ph.SMOKE_SIZES)
def test_hier_measure_holds_hier_equal_to_flat(jax, n):
    """measure holds every hierarchical window cycle against a flat
    forced-full pass at the same epsilon, equal to the JAX window's
    decisions."""
    walls = ph.measure((n,), LANES8, ph.SMOKE_SHARD_TARGET, **CPU)[str(n)]
    assert walls["decisions_equal"]
    assert [ph.flat_decisions(n, None, **CPU)] == \
        jax["hier"][str(n)]["decisions"]


def test_hier_measure_raises_when_flat_decides_otherwise(monkeypatch):
    monkeypatch.setattr(ph, "flat_decisions", lambda *a, **k: "another")
    with pytest.raises(AssertionError, match="otherwise than the flat"):
        ph.measure((ph.SMOKE_SIZES[0],), None, ph.SMOKE_SHARD_TARGET, **CPU)


def _strip(out, drop):
    if isinstance(out, dict):
        return {k: _strip(v, drop) for k, v in out.items() if k not in drop}
    if isinstance(out, list):
        return [_strip(v, drop) for v in out]
    return out


@pytest.mark.parametrize("script", ["shard", "hier"])
def test_wall_keys_cover_what_two_runs_may_differ_in(script):
    """Two smoke runs of a script differ only in its WALL_KEYS and the
    reporting keys (bench_torch_loop.WHERE_KEYS): what a comparison of
    decisions across devices drops."""
    import bench_torch_loop as pl

    def record():
        if script == "shard":
            return ps.run(True, 2, **CPU)
        # the hier smoke record's parts, at a 64-variant fleet
        return {"walls": ph.measure((64,), None, 16, **CPU),
                "restart": ph.restart_leg(64, 16, True, 1, **CPU)}

    mod = ps if script == "shard" else ph
    drop = pl.WHERE_KEYS | mod.WALL_KEYS
    first, second = record(), record()
    assert first != second
    assert _strip(first, drop) == _strip(second, drop)
    assert ps.WALL_KEYS <= ph.WALL_KEYS


def test_hier_restart_equal(jax):
    mine = ph.restart_leg(ph.SMOKE_SIZES[1], ph.SMOKE_SHARD_TARGET, True, 8,
                          **CPU)
    assert mine["warm_lanes_solved"] == jax["restart"]["warm_lanes_solved"]
    assert mine["mesh_entries"] == 8
    assert mine["probes"]["warm"]["restored"]


def test_restart_probe_runs_in_a_fresh_process(tmp_path):
    """The full restart leg's path: the warm and cold probes are this
    script in fresh processes, on the arguments the parent passes."""
    out = ph.restart_leg(48, 16, False, 1, **CPU)
    assert out["measured"] == "fresh process"
    warm, cold = out["probes"]["warm"], out["probes"]["cold"]
    assert warm["restored"] and warm["lanes_solved"] < 48
    assert not cold["restored"] and cold["lanes_solved"] == 48
    assert warm["decisions"] == cold["decisions"]
    assert 0 < warm["startup_share"] < 1 and warm["import_torch_s"] > 0


def test_lane_mesh_lists_the_local_devices_in_turn():
    assert ps.lane_mesh(8, "cpu") == LANES8
    assert ps.lane_mesh(1, "cpu") is None
    assert ps.mesh_keys(LANES8) == {"mesh_entries": 8, "mesh_cards": 1}
    assert ph.local_cards("cpu") == 1
    with pytest.raises(ValueError, match="at least 2"):
        ps.run(True, 1, **CPU)


def test_full_size_run_times_the_512_variant_cycle(monkeypatch):
    """run()'s full-size branch, with the churn, the per-size walls and
    the greedy stubbed: the 512-variant reconcile cycle it imports from
    bench_torch_collect runs for real, and its wall is the ratio's
    denominator."""
    monkeypatch.setattr(ps, "churn_run", lambda n, mesh, **on: {"n": n})
    monkeypatch.setattr(ps, "hold_churn", lambda steady: None)
    walls = {str(n): {"sharded": {"analyze_optimize_ms_p50": 100.0}}
             for n in ps.SIZES}
    monkeypatch.setattr(ps, "measure", lambda sizes, mesh, **on: walls)
    monkeypatch.setattr(ps, "greedy_compare",
                        lambda n, **on: {"speedup": 4.0})
    out = ps.run(False, 2, **CPU)
    assert out["steady_state"] == {"n": ps.CHURN_N}
    assert out["reconcile_cycle_512_ms"] > 0
    assert out["vs_512_reconcile_cycle"] == pytest.approx(
        100.0 / out["reconcile_cycle_512_ms"])
    assert [b["budget"] for b in out["budgets"]] == [
        "vs_512_reconcile_cycle", "greedy speedup"]


if __name__ == "__main__":
    print(json.dumps(jax_side()))
