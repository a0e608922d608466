"""The port's device mesh (parallel/), its sharded fleet arena and the
mesh paths of the System, the engines and the knobs, against the port's
unsharded path and the JAX package's 8-device programs.

The port's test mesh lists the CPU eight times (`Mesh(("cpu",) * 8,
...)`): its counterpart of the 8 virtual CPU devices tests/conftest.py
gives JAX. Held here:

- `padded_lanes` / `pad_to_multiple` (global and per shard) equal the
  JAX package's as numpy;
- `size/analyze/decide_batch_sharded` on the 8-entry mesh are bit for
  bit the port's unsharded path (a lane's result does not depend on the
  batch around it) and agree with JAX's 8-device programs (decisions
  exact, floats rel 1e-9);
- `System.calculate(mesh=)` equals the default; the solve-lane ledger
  excludes per-shard padding;
- `ShardedFleetArena`: full upload, then scatter, then no-op, with the
  device audit's counts and the counters JAX's arena reports on the same
  packs; a scatter (and a shrink) equals a fresh upload bit for bit;
- the flat and the hierarchical engine on a lane mesh publish what the
  unsharded engines publish over a seeded churn, limited and unlimited;
- a lane-mesh checkpoint restores across the packages both ways, and
  pre-stages its slabs: an unchanged fleet solves no lane;
- the WVA_MESH_DEVICES / WVA_SHARDED_FLEET / WVA_FLEET_MESH_DEVICES
  parsing equals the JAX package's, warnings included.

Everything runs on the CPU in float64 with one torch thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from test_incremental_solve import ChurnDriver, make_spec
from test_shard import ROWS
from test_torch_incremental import assert_same_solution, port_system
from workload_variant_autoscaler_tpu import parallel as jpar
from workload_variant_autoscaler_tpu.models import System as JSystem
from workload_variant_autoscaler_tpu.obs.profile import JAX_AUDIT
from workload_variant_autoscaler_tpu.ops import batched as jb
from workload_variant_autoscaler_tpu.ops import fused as jfused
from workload_variant_autoscaler_tpu.ops.arena import (
    ShardedFleetArena as JFleetArena,
)
from workload_variant_autoscaler_tpu.solver import (
    HierarchicalSolveEngine as JHier,
)
from workload_variant_autoscaler_tpu.solver import Manager as JManager
from workload_variant_autoscaler_tpu.solver import Optimizer as JOptimizer
import workload_variant_autoscaler_tpu_torch as port
from workload_variant_autoscaler_tpu_torch import parallel as ppar
from workload_variant_autoscaler_tpu_torch.obs import DEVICE_AUDIT
from workload_variant_autoscaler_tpu_torch.ops import batched as pb
from workload_variant_autoscaler_tpu_torch.ops import fused as pfused
from workload_variant_autoscaler_tpu_torch.ops.arena import (
    SCATTER_BUCKET,
    CandidateArena,
    ShardedFleetArena,
)
from workload_variant_autoscaler_tpu_torch.parallel import Mesh
from workload_variant_autoscaler_tpu_torch.solver import (
    HierarchicalSolveEngine,
    IncrementalSolveEngine,
)

RTOL = 1e-9
EPS = 0.05
F64 = torch.float64
CANDIDATES8 = Mesh(("cpu",) * 8, "candidates")
LANES8 = Mesh(("cpu",) * 8, "lanes")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bits(t) -> np.ndarray:
    """Bit pattern of a tensor or array: identical NaNs compare equal."""
    a = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return np.ascontiguousarray(a).view(np.uint8)


def assert_bits(a, b, msg=""):
    np.testing.assert_array_equal(bits(a), bits(b), err_msg=str(msg))


def host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- the mesh and its padding -------------------------------------------------


@pytest.mark.parametrize("b,m,s", [(5, 16, 8), (130, 16, 8), (1, 16, 2),
                                   (16, 16, 1), (8192, 16, 8), (77, 16, 4),
                                   (0, 16, 3), (33, 8, 5)])
def test_padded_lanes_equal_reference(b, m, s):
    got = ppar.padded_lanes(b, m, s)
    assert got == jpar.padded_lanes(b, m, s)
    assert got >= b and got % s == 0 and (got // s) % m == 0


def random_rows(b, seed):
    rng = np.random.default_rng(seed)
    mb = rng.choice([4, 16, 48, 64, 96, 256], b)
    return {
        "alpha": rng.uniform(2.0, 20.0, b), "beta": rng.uniform(0.005, 0.15, b),
        "gamma": rng.uniform(1.0, 15.0, b), "delta": rng.uniform(0.02, 0.3, b),
        "in_tokens": rng.choice([0.0, 128.0, 1024.0], b),
        "out_tokens": rng.choice([32.0, 128.0, 256.0], b),
        "max_batch": mb,
        "ttft": rng.choice([0.0, 500.0, 2000.0], b),
        "itl": rng.choice([0.0, 24.0, 200.0], b),
        "tps": rng.choice([0.0, 0.0, 900.0], b),
        "demand": rng.choice([0.0, 2.5, 40.0, 300.0], b),
        "min_replicas": rng.choice([0, 1, 3], b),
        "cost_rate": rng.choice([20.0, 80.0, 340.0], b),
    }, pb.k_max_bucket(pb.k_max_for(mb))


QCOLS = ("alpha", "beta", "gamma", "delta", "in_tokens", "out_tokens",
         "max_batch")


def port_batch(rows):
    q = pb.make_queue_batch(*(rows[c] for c in QCOLS), dtype=F64,
                            device="cpu")
    t = pb.SLOTargets(*(torch.as_tensor(rows[c], dtype=F64)
                        for c in ("ttft", "itl", "tps")))
    e = pfused.make_epilogue_batch(rows["demand"], rows["min_replicas"],
                                   rows["cost_rate"], F64, "cpu")
    return q, t, e


def jax_batch(rows):
    q = jb.make_queue_batch(*(rows[c] for c in QCOLS))
    t = jb.SLOTargets(*(jnp.asarray(rows[c], q.alpha.dtype)
                        for c in ("ttft", "itl", "tps")))
    e = jfused.make_epilogue_batch(rows["demand"], rows["min_replicas"],
                                   rows["cost_rate"], q.alpha.dtype)
    return q, t, e


@pytest.mark.parametrize("b,m,shards", [(5, 16, 1), (5, 16, 8), (11, 8, 1),
                                        (37, 16, 4), (16, 16, 1)])
def test_pad_to_multiple_equals_reference(b, m, shards):
    rows, _k = random_rows(b, seed=b)
    qp, tp, bp = ppar.pad_to_multiple(*port_batch(rows)[:2], m, shards=shards)
    qj, tj, bj = jpar.pad_to_multiple(*jax_batch(rows)[:2], m, shards=shards)
    assert bp == bj == b
    assert qp.batch_size == qj.batch_size
    for name in qp._fields:
        np.testing.assert_array_equal(host(getattr(qp, name)),
                                      host(getattr(qj, name)), name)
    for name in tp._fields:
        np.testing.assert_array_equal(host(getattr(tp, name)),
                                      host(getattr(tj, name)), name)
    valid = host(qp.valid)
    assert valid[:b].all() and not valid[b:].any()


def test_mesh_identity_and_constructors(monkeypatch):
    assert Mesh(("cpu",) * 2, "lanes") == Mesh((torch.device("cpu"),) * 2,
                                               "lanes")
    assert hash(Mesh(("cpu",) * 2, "lanes")) == hash(LANES8.__class__(
        ("cpu", "cpu"), "lanes"))
    assert Mesh(("cpu",) * 2, "lanes") != Mesh(("cpu",) * 4, "lanes")
    assert Mesh(("cpu",) * 2, "lanes") != Mesh(("cpu",) * 2, "candidates")
    assert LANES8.size == 8 and ppar.mesh_axis(LANES8) == "lanes"
    assert ppar.is_lane_mesh(LANES8) and not ppar.is_lane_mesh(CANDIDATES8)
    assert not ppar.is_lane_mesh(None)
    with pytest.raises(ValueError):
        Mesh((), "lanes")
    with pytest.raises(ValueError):
        Mesh(("cpu",), "rows")
    # the host is one device: a candidate mesh of one, no lane mesh
    assert ppar.candidate_mesh(device="cpu") == Mesh(("cpu",), "candidates")
    assert ppar.candidate_mesh(4, device="cpu").size == 1
    assert ppar.fleet_mesh(device="cpu") is None
    # the card is the default and is never replaced by the host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ppar.candidate_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        ppar.fleet_mesh(2)


def test_shard_batch_splits_contiguously_and_passes_shards_through():
    rows, _k = random_rows(16, seed=3)
    q, _t, _e = port_batch(rows)
    parts = ppar.shard_batch(q, CANDIDATES8)
    assert isinstance(parts, ppar.Shards) and len(parts) == 8
    assert parts.batch_size == 16
    for i, part in enumerate(parts):
        assert_bits(part.alpha, q.alpha[2 * i:2 * i + 2], i)
    assert ppar.shard_batch(parts, CANDIDATES8) is parts
    with pytest.raises(ValueError, match="another mesh"):
        ppar.shard_batch(parts, Mesh(("cpu",) * 4))
    with pytest.raises(ValueError, match="pad first"):
        ppar.shard_batch(port_batch(random_rows(11, 1)[0])[0], CANDIDATES8)


# -- the sharded programs -----------------------------------------------------


@pytest.mark.parametrize("backend", ["kernel", "batched"])
@pytest.mark.parametrize("pct", [None, 0.95])
@pytest.mark.parametrize("b", [8, 11, 37])
def test_size_batch_sharded(b, pct, backend):
    rows, k = random_rows(b, seed=10 + b)
    q, t, _e = port_batch(rows)
    got = ppar.size_batch_sharded(q, t, k, CANDIDATES8, ttft_percentile=pct,
                                  backend=backend)
    plain = pfused.size_stage(q, t, k, pct, backend)
    qj, tj, _ej = jax_batch(rows)
    want = jpar.size_batch_sharded(qj, tj, k, jpar.candidate_mesh(8),
                                   ttft_percentile=pct)
    for name in plain._fields:
        assert getattr(got, name).shape == (b,), name
        assert_bits(getattr(got, name), getattr(plain, name), name)
    np.testing.assert_array_equal(host(got.feasible), host(want.feasible))
    for name in ("lam_star", "lam_ttft", "lam_itl", "throughput", "rho",
                 "avg_wait_time", "token_time"):
        np.testing.assert_allclose(host(getattr(got, name)),
                                   host(getattr(want, name)), rtol=RTOL,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("b", [8, 11])
def test_analyze_batch_sharded(b):
    rows, k = random_rows(b, seed=20 + b)
    q, _t, _e = port_batch(rows)
    rates = np.random.default_rng(1).uniform(0.1, 20.0, b)
    got = ppar.analyze_batch_sharded(q, rates, k, CANDIDATES8)
    plain = pb.analyze_batch(q, rates, k)
    qj, _tj, _ej = jax_batch(rows)
    want = jpar.analyze_batch_sharded(qj, rates, k, jpar.candidate_mesh(8))
    assert set(got) == set(plain) == set(want)
    for name in plain:
        assert got[name].shape == (b,), name
        assert_bits(got[name], plain[name], name)
    np.testing.assert_array_equal(host(got["valid_rate"]),
                                  host(want["valid_rate"]))
    for name in ("throughput", "avg_token_time", "ttft", "rho"):
        np.testing.assert_allclose(host(got[name]), host(want[name]),
                                   rtol=RTOL, err_msg=name)


def decide_rows(packed):
    """The packed decision as (feasible, replicas, cost) exact and the
    latency rows as floats."""
    p = host(packed)
    return p[[pfused.ROW_FEASIBLE, pfused.ROW_REPLICAS, pfused.ROW_COST]], \
        p[[pfused.ROW_ITL, pfused.ROW_TTFT, pfused.ROW_RHO,
           pfused.ROW_RATE_STAR]]


@pytest.mark.parametrize("backend", ["kernel", "batched"])
@pytest.mark.parametrize("pct", [None, 0.95])
@pytest.mark.parametrize("axis", ["candidates", "lanes"])
@pytest.mark.parametrize("b", [5, 11, 37])
def test_decide_batch_sharded(b, axis, pct, backend):
    rows, k = random_rows(b, seed=30 + b)
    mesh = Mesh(("cpu",) * 8, axis)
    q, t, e = port_batch(rows)
    got = ppar.decide_batch_sharded(q, t, e, k, mesh, ttft_percentile=pct,
                                    backend=backend)
    assert got.shape == (pfused.N_ROWS, b)
    plain = pfused.decide_batch(q, t, e, k, ttft_percentile=pct,
                                backend=backend)
    assert_bits(got, plain)
    jmesh = (jpar.fleet_mesh(8) if axis == "lanes"
             else jpar.candidate_mesh(8))
    want = jpar.decide_batch_sharded(*jax_batch(rows), k, jmesh,
                                     ttft_percentile=pct)
    exact, floats = decide_rows(got)
    w_exact, w_floats = decide_rows(want)
    np.testing.assert_array_equal(exact, w_exact)
    ok = exact[0] > 0
    np.testing.assert_allclose(floats[:, ok], w_floats[:, ok], rtol=RTOL)
    assert ok.any()


def test_sharded_decide_launches_each_form_once_per_shard(monkeypatch):
    """Every shard runs the kernel wrapper: 8 mean-form calls for a
    mean group, 8 of each form for a tail group."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    calls = []
    orig = bk.bisect
    monkeypatch.setattr(bk, "bisect", lambda *a: calls.append(
        "tail" if a[4:] and a[4] is not None else "mean") or orig(*a))
    rows, k = random_rows(40, seed=4)
    for pct, want in ((None, {"mean": 8}), (0.95, {"mean": 8, "tail": 8})):
        calls.clear()
        ppar.decide_batch_sharded(*port_batch(rows), k, LANES8,
                                  ttft_percentile=pct)
        assert {f: calls.count(f) for f in set(calls)} == want


# -- the System on a mesh -----------------------------------------------------


def fleet_servers():
    from test_torch_system import fleet_servers as servers

    return servers()


def system_decisions(system):
    return {(n, a): (x.num_replicas, x.batch_size, x.cost, x.value, x.itl,
                     x.ttft, x.rho, x.max_arrv_rate_per_replica)
            for n, s in system.servers.items()
            for a, x in s.all_allocations.items()}


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("mesh", [CANDIDATES8, LANES8, Mesh(("cpu",) * 3)],
                         ids=["candidates8", "lanes8", "candidates3"])
def test_system_calculate_on_mesh_equals_default(mesh, fused, monkeypatch):
    monkeypatch.setenv("WVA_FUSED_SOLVE", fused)
    spec = make_spec(fleet_servers(), {})
    plain, _ = port_system(spec)
    plain.calculate(backend="kernel")
    sharded, _ = port_system(spec)
    sharded.calculate(backend="kernel", mesh=mesh, ttft_percentile=None)
    assert system_decisions(sharded) == system_decisions(plain)
    assert sharded.last_solve_lanes == plain.last_solve_lanes
    assert sharded.last_unique_lanes == plain.last_unique_lanes
    # the JAX System on its 8 virtual devices
    ref = JSystem()
    ref.set_from_spec(spec)
    ref.calculate(mesh=jpar.fleet_mesh(8) if mesh.axis == "lanes"
                  else jpar.candidate_mesh(8))
    for (name, acc), d in system_decisions(sharded).items():
        r = ref.servers[name].all_allocations[acc]
        assert d[:4] == (r.num_replicas, r.batch_size, r.cost, r.value)
        for got, want in zip(d[4:], (r.itl, r.ttft, r.rho,
                                     r.max_arrv_rate_per_replica)):
            assert got == pytest.approx(want, rel=RTOL, abs=1e-12)


def test_group_bucket_is_lcm_on_a_candidate_mesh():
    assert port.System._group_bucket(None) == 16
    assert port.System._group_bucket(LANES8) == 16
    assert port.System._group_bucket(Mesh(("cpu",) * 3)) == 48
    assert port.System._group_bucket(CANDIDATES8) == 16


def test_solve_lane_ledger_excludes_per_shard_padding():
    servers = [helpers.server_spec(name=f"v{i}:ns", model="m-a",
                                   arrival_rpm=300.0 + 40.0 * i)
               for i in range(3)]
    spec = make_spec(servers, {"v5e": 400})
    plain, _ = port_system(spec)
    plain.calculate(backend="kernel")
    lanes = plain.last_solve_lanes
    assert 0 < lanes < ppar.padded_lanes(lanes, 16, 8)
    sharded, _ = port_system(spec)
    sharded.arena = ShardedFleetArena(LANES8, dtype=F64)
    before = DEVICE_AUDIT.snapshot()
    sharded.calculate(backend="kernel", mesh=LANES8)
    delta = DEVICE_AUDIT.delta(before, DEVICE_AUDIT.snapshot())
    assert sharded.last_solve_lanes == lanes
    assert sharded.last_unique_lanes == plain.last_unique_lanes
    # the arena's whole-slab upload and the one gathered readback
    assert delta["sharded"] == {"h2d@8": 15, "d2h@8": 1}
    ref = JSystem()
    ref.set_from_spec(spec)
    ref.calculate(backend="batched", mesh=jpar.fleet_mesh(8))
    assert ref.last_solve_lanes == lanes


# -- the sharded fleet arena --------------------------------------------------


def arena_fields(packed):
    """(name, tensor) of a pack, the Shards gathered into one batch."""
    out = []
    for prefix, tree in zip(("q", "slo", "epi"), packed):
        if tree is None:
            continue
        parts = list(tree) if isinstance(tree, ppar.Shards) else [tree]
        for i, name in enumerate(parts[0]._fields):
            out.append((f"{prefix}.{name}",
                        torch.cat([p[i] for p in parts])))
    return out


def jax_fields(packed):
    out = []
    for prefix, tree in zip(("q", "slo", "epi"), packed):
        if tree is not None:
            out += [(f"{prefix}.{n}", v) for n, v in tree._asdict().items()]
    return out


def pack(arena, rows):
    return arena.pack({k: list(v) for k, v in rows.items()}, device="cpu",
                      dtype=F64)


def test_arena_full_upload_then_scatter_then_noop():
    """The port's arena and the JAX package's, the same three packs:
    the same counters and the same device-audit counts, per shard count
    too."""
    mine, theirs = ShardedFleetArena(LANES8, dtype=F64), \
        JFleetArena(jpar.fleet_mesh(8))
    rows = {k: list(v) for k, v in ROWS.items()}
    churned = dict(rows, alpha=[*rows["alpha"][:2], 9.5, *rows["alpha"][3:]])
    for step in (rows, churned, churned):
        before_p, before_j = DEVICE_AUDIT.snapshot(), JAX_AUDIT.snapshot()
        q, _s, _e = pack(mine, step)
        theirs.pack({k: list(v) for k, v in step.items()})
        dp = DEVICE_AUDIT.delta(before_p, DEVICE_AUDIT.snapshot())
        dj = JAX_AUDIT.delta(before_j, JAX_AUDIT.snapshot())
        assert dp["transfers"] == dj["transfers"]
        assert dp.get("sharded") == dj.get("sharded")
        assert q.batch_size == ppar.padded_lanes(5, 16, 8) == 128
    for counter in ("packs", "full_uploads", "scatter_packs", "noop_packs",
                    "lanes_scattered", "slab_allocs"):
        assert getattr(mine, counter) == getattr(theirs, counter), counter
    assert (mine.full_uploads, mine.scatter_packs, mine.noop_packs,
            mine.lanes_scattered) == (1, 1, 1, 1)


def test_arena_counters_equal_reference_over_a_churn():
    rng = np.random.default_rng(9)
    mine, theirs = ShardedFleetArena(LANES8, dtype=F64), \
        JFleetArena(jpar.fleet_mesh(8))
    rows = {k: list(v) for k, v in ROWS.items()}
    for step in range(12):
        n = int(rng.integers(1, 6))
        cur = {k: list(v)[:n] for k, v in rows.items()}
        if rng.random() < 0.6:
            cur["alpha"][0] = float(rng.uniform(3.0, 9.0))
        if step % 4 == 3:
            cur = {k: v for k, v in cur.items()
                   if k not in ("demand", "min_replicas", "cost_rate")}
        got = pack(mine, cur)
        want = theirs.pack({k: list(v) for k, v in cur.items()})
        for (name, a), (_n, b) in zip(arena_fields(got), jax_fields(want)):
            np.testing.assert_array_equal(host(a), host(b), f"{step} {name}")
    for counter in ("packs", "full_uploads", "scatter_packs", "noop_packs",
                    "lanes_scattered", "slab_allocs"):
        assert getattr(mine, counter) == getattr(theirs, counter), counter
    assert mine.scatter_packs > 3


@pytest.mark.parametrize("change", ["scatter", "shrink", "grow-in-bucket"])
def test_arena_scatter_equals_fresh_upload(change):
    rows = {k: list(v) for k, v in ROWS.items()}
    if change == "scatter":
        new = dict(rows, alpha=[7.25, *rows["alpha"][1:]],
                   demand=[*rows["demand"][:4], 9.75])
    elif change == "shrink":
        new = {k: v[:2] for k, v in rows.items()}
    else:
        new = {k: v + v[:3] for k, v in rows.items()}
    churned = ShardedFleetArena(LANES8, dtype=F64)
    pack(churned, rows)
    out = pack(churned, new)
    assert churned.scatter_packs == 1 and churned.full_uploads == 1
    fresh = pack(ShardedFleetArena(LANES8, dtype=F64), new)
    for (name, a), (_n, b) in zip(arena_fields(out), arena_fields(fresh)):
        assert_bits(a, b, name)
    valid = arena_fields(out)[8][1]
    n = len(new["alpha"])
    assert valid[:n].all() and not valid[n:].any()


def test_arena_pack_matches_the_plain_arena_on_real_lanes():
    sharded = arena_fields(pack(ShardedFleetArena(LANES8, dtype=F64), ROWS))
    plain = arena_fields(CandidateArena().pack(
        {k: list(v) for k, v in ROWS.items()}, device="cpu", dtype=F64))
    for (name, a), (_n, b) in zip(sharded, plain):
        assert_bits(a[:5], b[:5], name)


def test_arena_scatter_pads_its_index_to_the_bucket(monkeypatch):
    arena = ShardedFleetArena(LANES8, dtype=F64)
    pack(arena, ROWS)
    seen = []
    orig = torch.Tensor.index_copy_

    def spy(self, dim, index, source):
        seen.append(index.numel())
        return orig(self, dim, index, source)

    monkeypatch.setattr(torch.Tensor, "index_copy_", spy)
    pack(arena, dict(ROWS, alpha=[6.0, 6.1, 6.2, 6.3, 6.4]))
    # five changed lanes, all in shard 0, padded to one SCATTER_BUCKET
    assert set(seen) == {SCATTER_BUCKET} and len(seen) == 15


def test_arena_restore_stages_slabs_onto_the_mesh():
    saved = ShardedFleetArena(LANES8, dtype=F64)
    pack(saved, ROWS)
    snap = saved.snapshot_slabs()
    restored = ShardedFleetArena(LANES8, dtype=F64)
    before = DEVICE_AUDIT.snapshot()
    restored.restore_slabs(snap)
    delta = DEVICE_AUDIT.delta(before, DEVICE_AUDIT.snapshot())
    assert restored.full_uploads == 1
    assert delta["sharded"] == {"h2d@8": 15}
    out = pack(restored, ROWS)
    assert restored.noop_packs == 1 and restored.full_uploads == 1
    for (name, a), (_n, b) in zip(arena_fields(out),
                                  arena_fields(pack(saved, ROWS))):
        assert_bits(a, b, name)
    # a slab that does not split into the mesh's shards commits nothing
    other = ShardedFleetArena(Mesh(("cpu",) * 3, "lanes"), dtype=F64)
    with pytest.raises(ValueError, match="shards"):
        other.restore_slabs(snap)
    assert not other._slabs and other.full_uploads == 0


# -- the engines on a lane mesh -----------------------------------------------


def mesh_cycle(spec, engine, fleet_mesh=None, mesh=None, rungs=None,
               cycle_rung="healthy", backend="kernel"):
    system, opt = port_system(spec)
    stats = engine.calculate(system, backend=backend, mesh=mesh,
                             fleet_mesh=fleet_mesh, optimizer_spec=opt,
                             rungs=rungs, cycle_rung=cycle_rung)
    port.Manager(system, port.Optimizer(opt)).optimize(
        warm=engine.warm_start())
    solution = system.generate_solution()
    engine.finish_cycle(system)
    return solution, stats, system


def hier(**kw):
    kw.setdefault("epsilon", EPS)
    kw.setdefault("full_every", 7)
    kw.setdefault("shard_target", 4)
    kw.setdefault("min_variants", 1)
    return HierarchicalSolveEngine(**kw)


@pytest.mark.parametrize("engine", ["flat", "hier"])
@pytest.mark.parametrize("unlimited,policy", [(True, "None"),
                                              (False, "RoundRobin")])
def test_sharded_churn_equivalence(engine, unlimited, policy, monkeypatch):
    """Seeded churn (grow/shrink, epsilon-straddling jitter, capacity
    changes, rungs, forced full every 7 cycles) through an engine on the
    8-entry lane mesh and the same engine unsharded: the same solution
    every cycle, with the lane ledger unchanged."""
    monkeypatch.setenv("WVA_VECTOR_GREEDY", "off")
    cycles = 210 if engine == "flat" else 105
    make = ((lambda: IncrementalSolveEngine(epsilon=EPS, full_every=7))
            if engine == "flat" else hier)
    d_mesh, d_ref = (ChurnDriver(seed=0x13D, epsilon=EPS),
                     ChurnDriver(seed=0x13D, epsilon=EPS))
    e_mesh, e_ref = make(), make()
    scattered = 0
    for cycle in range(cycles):
        d_mesh.churn()
        d_ref.churn()
        rung = "stale-cache" if d_mesh.rungs else "healthy"
        sol, stats, _s = mesh_cycle(
            make_spec(d_mesh.servers(), d_mesh.capacity, unlimited, policy),
            e_mesh, fleet_mesh=LANES8, rungs=dict(d_mesh.rungs),
            cycle_rung=rung)
        ref, ref_stats, _r = mesh_cycle(
            make_spec(d_ref.servers(), d_ref.capacity, unlimited, policy),
            e_ref, rungs=dict(d_ref.rungs), cycle_rung=rung)
        assert sol == ref, cycle
        assert (stats.lanes_solved, stats.lanes_skipped) == \
            (ref_stats.lanes_solved, ref_stats.lanes_skipped), cycle
    arenas = ([e_mesh._fleet_arena] if engine == "flat"
              else list(e_mesh._shard_arenas.values()))
    assert arenas and all(isinstance(a, ShardedFleetArena) for a in arenas)
    scattered = sum(a.scatter_packs for a in arenas)
    assert scattered > 0


def test_engine_mesh_change_forces_full_and_rebuilds_the_arena():
    fleet = ChurnDriver(seed=5, epsilon=EPS)
    engine = IncrementalSolveEngine(epsilon=EPS, full_every=0)
    spec = make_spec(fleet.servers(), fleet.capacity)
    _sol, first, _s = mesh_cycle(spec, engine, fleet_mesh=LANES8)
    arena8 = engine._fleet_arena
    _sol, steady, _s = mesh_cycle(spec, engine, fleet_mesh=LANES8)
    assert first.full and not steady.full and steady.lanes_solved == 0
    four = Mesh(("cpu",) * 4, "lanes")
    _sol, moved, _s = mesh_cycle(spec, engine, fleet_mesh=four)
    assert moved.full and "mesh" in moved.reason
    assert engine._fleet_arena is not arena8
    assert engine._fleet_arena.mesh == four
    # an explicit candidate mesh wins over the lane mesh, without an arena
    _sol, cand, system = mesh_cycle(spec, engine, mesh=CANDIDATES8,
                                    fleet_mesh=four)
    assert cand.full and system.arena is None


# -- lane-mesh checkpoints across the packages -------------------------------


V5E_SERVERS = [helpers.server_spec(name=f"v{i}:ns", model="m-a",
                                   arrival_rpm=300.0 + 40.0 * i)
               for i in range(12)]


def jax_cycle(spec, engine, fleet_mesh):
    system = JSystem()
    opt = system.set_from_spec(spec)
    stats = engine.calculate(system, backend="batched",
                             fleet_mesh=fleet_mesh, optimizer_spec=opt)
    JManager(system, JOptimizer(opt)).optimize(warm=engine.warm_start())
    sol = system.generate_solution()
    engine.finish_cycle(system)
    return sol, stats


def test_restore_skips_forced_full_on_lane_mesh(tmp_path):
    """The port's own lane-mesh checkpoint: the restarted engine
    pre-stages the saved slabs, so an unchanged fleet solves no lane and
    no shard arena uploads a whole slab twice."""
    path = str(tmp_path / "arena.ckpt")
    spec = make_spec(V5E_SERVERS, {"v5e": 4000})
    a = hier(checkpoint_path=path, checkpoint_every=1, full_every=32)
    before, _stats, _s = mesh_cycle(spec, a, fleet_mesh=LANES8)
    assert a._checkpoint_payload()["arena_mesh"] == 8
    a2 = hier(checkpoint_path=path, checkpoint_every=1, full_every=32)
    assert a2.ckpt_events["restore"] == 1
    after, stats, _s = mesh_cycle(spec, a2, fleet_mesh=LANES8)
    assert stats.restored and stats.lanes_solved == 0, stats
    assert after == before
    # one variant's load moves: its shard's arena starts from the saved
    # slabs, staged once, and the pack scatters into them
    moved = make_spec([helpers.server_spec(
        name=s.name, model="m-a",
        arrival_rpm=(900.0 if s.name == "v3:ns"
                     else s.current_alloc.load.arrival_rate))
        for s in V5E_SERVERS], {"v5e": 4000})
    _sol, stats, _s = mesh_cycle(moved, a2, fleet_mesh=LANES8)
    assert not stats.full and stats.shards_solved == 1, stats
    assert len(a2._shard_arenas) == 1
    for arena in a2._shard_arenas.values():
        assert isinstance(arena, ShardedFleetArena)
        assert arena.full_uploads == 1 and arena.scatter_packs == 1
    # unsharded, the same checkpoint keeps its cache but stages nothing
    a3 = hier(checkpoint_path=path, checkpoint_every=1, full_every=32)
    _sol, other, _s = mesh_cycle(spec, a3)
    assert not other.restored and other.full


def test_reference_lane_mesh_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint the JAX engine wrote on its 8-device lane mesh
    (`arena_mesh: 8`, backend "batched") restores into the port on an
    8-entry lane mesh: the first cycle is a restore that solves no lane,
    every shard arena starts from the JAX arena's slabs, and the
    decisions equal the JAX engine's."""
    path = str(tmp_path / "arena.ckpt")
    spec = make_spec(V5E_SERVERS, {"v5e": 4000})
    theirs = JHier(epsilon=EPS, full_every=32, shard_target=4,
                   min_variants=1, checkpoint_path=path, checkpoint_every=1)
    want, _ = jax_cycle(spec, theirs, jpar.fleet_mesh(8))
    assert theirs._checkpoint_payload()["arena_mesh"] == 8
    jslabs = {sid: a.snapshot_slabs()
              for sid, a in theirs._shard_arenas.items()}
    mine = hier(checkpoint_path=path, checkpoint_every=1, full_every=32)
    assert mine.ckpt_events["restore"] == 1
    got, stats, _s = mesh_cycle(spec, mine, fleet_mesh=LANES8,
                                backend="batched")
    assert stats.restored and stats.lanes_solved == 0, stats
    assert_same_solution(got, want, 0)
    # every shard arena, built now, starts from the JAX arena's slabs,
    # staged onto the mesh once
    for sid, snap in jslabs.items():
        arena = mine._shard_arena(sid, LANES8, F64)
        assert isinstance(arena, ShardedFleetArena)
        assert arena.full_uploads == 1 and arena.scatter_packs == 0
        assert arena.snapshot_slabs() == snap


def test_port_lane_mesh_checkpoint_restores_into_the_reference(tmp_path):
    path = str(tmp_path / "arena.ckpt")
    spec = make_spec(V5E_SERVERS, {"v5e": 4000})
    mine = hier(checkpoint_path=path, checkpoint_every=1, full_every=32)
    got, _stats, _s = mesh_cycle(spec, mine, fleet_mesh=LANES8,
                                 backend="batched")
    theirs = JHier(epsilon=EPS, full_every=32, shard_target=4,
                   min_variants=1, checkpoint_path=path, checkpoint_every=1)
    assert theirs.ckpt_events["restore"] == 1
    want, stats = jax_cycle(spec, theirs, jpar.fleet_mesh(8))
    assert stats.restored and stats.lanes_solved == 0, stats
    assert_same_solution(got, want, 0)
    for arena in theirs._shard_arenas.values():
        assert arena.full_uploads <= 1


def test_checkpoint_on_another_mesh_size_stages_nothing(tmp_path):
    path = str(tmp_path / "arena.ckpt")
    spec = make_spec(V5E_SERVERS, {"v5e": 4000})
    a = hier(checkpoint_path=path, checkpoint_every=1, full_every=32)
    mesh_cycle(spec, a, fleet_mesh=LANES8)
    b = hier(checkpoint_path=path, checkpoint_every=1, full_every=32)
    four = Mesh(("cpu",) * 4, "lanes")
    _sol, stats, _s = mesh_cycle(spec, b, fleet_mesh=four)
    # the pipeline changed with the mesh: the checkpoint is discarded
    assert b.ckpt_events["discard_config"] == 1 and stats.full


# -- the knobs ---------------------------------------------------------------


def knob_meshes(pkg_translate, backend, args, env, monkeypatch):
    said = []
    with pytest.MonkeyPatch.context() as mp:
        for k in ("WVA_MESH_DEVICES", "WVA_SHARDED_FLEET",
                  "WVA_FLEET_MESH_DEVICES"):
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setattr(pkg_translate.log, "warning",
                   lambda msg, *a, **k: said.append(msg))
        meshes = (pkg_translate.engine_mesh(*args),
                  pkg_translate.sharded_fleet_mesh(*args))

    def shape(m):
        if m is None:
            return None
        size = m.size if hasattr(m, "size") and isinstance(m.size, int) \
            else int(m.devices.size)
        axis = m.axis if isinstance(m, Mesh) else m.axis_names[0]
        return size, axis

    return [shape(m) for m in meshes], said


@pytest.mark.parametrize("backend", ["batched", "native"])
@pytest.mark.parametrize("env", [
    {}, {"WVA_MESH_DEVICES": "all"}, {"WVA_MESH_DEVICES": "2"},
    {"WVA_MESH_DEVICES": "0"}, {"WVA_MESH_DEVICES": "abc"},
    {"WVA_MESH_DEVICES": "16"},
    {"WVA_SHARDED_FLEET": "on"}, {"WVA_SHARDED_FLEET": "auto"},
    {"WVA_SHARDED_FLEET": "off"}, {"WVA_SHARDED_FLEET": "bogus"},
    {"WVA_SHARDED_FLEET": "on", "WVA_FLEET_MESH_DEVICES": "4"},
    {"WVA_SHARDED_FLEET": "on", "WVA_FLEET_MESH_DEVICES": "1"},
    {"WVA_SHARDED_FLEET": "yes", "WVA_FLEET_MESH_DEVICES": "x"},
    {"WVA_SHARDED_FLEET": "auto", "WVA_FLEET_MESH_DEVICES": "-2"},
    {"WVA_MESH_DEVICES": "4", "WVA_SHARDED_FLEET": "on"},
], ids=lambda e: ",".join(f"{k[4:]}={v}" for k, v in e.items()) or "unset")
def test_mesh_knobs_parse_as_reference(env, backend, monkeypatch):
    """The port's knobs over 8 local devices (the host listed eight
    times) against the JAX package's over its 8 virtual devices: the
    same meshes (size and axis), the same warnings. The port's device
    backend ("kernel" on the card) stands where JAX's "batched" does."""
    from workload_variant_autoscaler_tpu.controller import translate as jt
    from workload_variant_autoscaler_tpu_torch.controller import (
        translate as pt,
    )
    from workload_variant_autoscaler_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "_local_devices",
                        lambda device=None: [torch.device("cpu")] * 8)
    want, want_said = knob_meshes(jt, backend, (backend,), env, monkeypatch)
    for mine in ((backend,) if backend == "native"
                 else ("batched", "kernel")):
        got, got_said = knob_meshes(pt, mine, (mine, "cpu"), env,
                                    monkeypatch)
        assert got == want
        assert [s.split(":")[0] for s in got_said] == \
            [s.split(":")[0] for s in want_said]


@pytest.mark.parametrize("mesh_size", [None, 3, 8, 32])
def test_warmup_plan_with_a_mesh_equals_reference(mesh_size):
    from test_torch_controller import cluster_vas
    from reconcile_cluster import JAX, PORT, Cluster

    c = Cluster(variants=40, models=8, percentile=0.95)
    plans = []
    for pkg in (JAX, PORT):
        vas, classes = cluster_vas(pkg, c)
        mod = __import__(f"{pkg}.controller.translate", fromlist=["x"])
        plans.append(mod.warmup_plan(vas, service_class_cm=classes,
                                     mesh_size=mesh_size))
    assert plans[1] == plans[0]


@pytest.mark.parametrize("axis", ["candidates", "lanes"])
def test_warmup_runs_the_sharded_decision(axis, monkeypatch):
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk

    calls = []
    orig = bk.bisect
    monkeypatch.setattr(bk, "bisect", lambda *a: calls.append(1) or orig(*a))
    pfused.warmup(64, 32, None, device="cpu", dtype=F64,
                  mesh=Mesh(("cpu",) * 4, axis))
    assert len(calls) == 4
