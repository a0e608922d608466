"""The port's limited mode (solver/greedy.py) against the JAX package's.

Fleets come from tests/helpers.py and are carried across with
`spec_from_reference`. Candidate sets are drawn from seeds (as
tests/test_shard.py draws them) and written into both Systems, so the
greedy alone is compared: accelerator, replicas, cost and value must be
equal exactly, for every saturation policy, with and without delayed
best effort, with the vector sweep forced on and forced off. The port's
sweep runs on the System's device (the CPU here, in float64 like every
lane value).
"""

import random
from dataclasses import asdict

import pytest
import torch

import helpers
from workload_variant_autoscaler_tpu.models import Allocation as JAllocation
from workload_variant_autoscaler_tpu.models import SaturationPolicy as JPolicy
from workload_variant_autoscaler_tpu.solver import greedy as jg
import workload_variant_autoscaler_tpu_torch as port
from workload_variant_autoscaler_tpu_torch.models import Allocation
from workload_variant_autoscaler_tpu_torch.models import SaturationPolicy
from workload_variant_autoscaler_tpu_torch.solver import greedy as tg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's intra-op threads would spin on the cores the other test
    workers run on; these tensors are small, so one thread is enough."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


POLICIES = [p.value for p in SaturationPolicy]
ACCS = ["v5e-1", "v5e-4", "v5p-4"]
SEEDS = range(12)


def draw_fleet(seed, n=24):
    """(servers, capacity, candidates): server name -> list of
    (accelerator, replicas, cost, value), in insertion order. Half the
    seeds get capacity for everyone's first choice, so the sweep settles
    whole components; the rest are contended."""
    rng = random.Random(seed)
    servers = [helpers.server_spec(
        name=f"s{i:03d}", service_class=rng.choice(["Premium", "Freemium"]))
        for i in range(n)]
    top = 600 if seed % 2 else 60
    capacity = {"v5e": rng.randint(0, top), "v5p": rng.randint(0, top)}
    candidates = {}
    for i in range(n):
        candidates[f"s{i:03d}"] = [
            (acc, rng.randint(0, 4), rng.choice([10.0, 20.0, 20.0, 40.0]),
             rng.choice([5.0, 10.0, 10.0, 30.0]))
            for acc in rng.sample(ACCS, rng.randint(0, len(ACCS)))]
    return servers, capacity, candidates


def install(system, candidates, cls):
    """Fresh Allocation objects (greedy's best effort scales them in
    place) for every server."""
    for name, cands in candidates.items():
        allocs = {}
        for acc, replicas, cost, value in cands:
            a = cls(accelerator=acc, num_replicas=replicas, cost=cost)
            a.value = value
            allocs[acc] = a
        system.servers[name].all_allocations = allocs


def systems(seed):
    """The JAX System and the port's, holding the same drawn fleet."""
    servers, capacity, candidates = draw_fleet(seed)
    ref, _ = helpers.make_system(servers, capacity=capacity)
    got = port.System(device="cpu", dtype=torch.float64)
    got.set_from_spec(port_spec(servers, capacity))
    install(ref, candidates, JAllocation)
    install(got, candidates, Allocation)
    return ref, got, candidates


def port_spec(servers, capacity):
    from workload_variant_autoscaler_tpu.models import OptimizerSpec, \
        SystemSpec

    return port.spec_from_reference(asdict(SystemSpec(
        accelerators=list(helpers.SLICES), profiles=list(helpers.PROFILES),
        service_classes=list(helpers.SERVICE_CLASSES), servers=servers,
        capacity=capacity, optimizer=OptimizerSpec(unlimited=True))))


def snap(system):
    return {name: None if (a := s.allocation) is None
            else (a.accelerator, a.num_replicas, a.cost, a.value)
            for name, s in system.servers.items()}


def by_type(system):
    return {k: (v.count, v.limit, v.cost)
            for k, v in system.allocate_by_type().items()}


@pytest.mark.parametrize("sweep", ["on", "off"])
@pytest.mark.parametrize("delayed", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_solve_greedy_matches_reference(policy, delayed, sweep, monkeypatch):
    monkeypatch.setenv("WVA_VECTOR_GREEDY", sweep)
    settled = 0
    for seed in SEEDS:
        ref, got, _ = systems(seed)
        jg.solve_greedy(ref, JPolicy.parse(policy), delayed)
        available = dict(got.capacity)
        swept = (tg._vector_fast_pass(got, None, available)
                 if sweep == "on" else None)
        settled += swept == set()
        tg.solve_greedy(got, SaturationPolicy.parse(policy), delayed)
        assert snap(got) == snap(ref), seed
        assert by_type(got) == by_type(ref), seed
        # every candidate the best effort may have scaled, too
        for name, server in ref.servers.items():
            mine = got.servers[name].all_allocations
            assert {a: (x.num_replicas, x.cost, x.value)
                    for a, x in mine.items()} == \
                {a: (x.num_replicas, x.cost, x.value)
                 for a, x in server.all_allocations.items()}, (seed, name)
    if sweep == "on":
        assert settled >= 3   # the sweep settled whole fleets, not only fell back


@pytest.mark.parametrize("sweep", ["on", "off"])
@pytest.mark.parametrize("policy", POLICIES)
def test_warm_greedy_equals_full_greedy(policy, sweep, monkeypatch):
    """With the warm start's invariants held (the previous solve over the
    same candidate set, unchanged servers' candidates equal, the same
    capacity), solve_greedy_warm publishes what solve_greedy does, and
    what the JAX package's warm greedy does."""
    monkeypatch.setenv("WVA_VECTOR_GREEDY", sweep)
    pol, jpol = SaturationPolicy.parse(policy), JPolicy.parse(policy)
    for seed in SEEDS:
        ref, warm, cands = systems(seed)
        tg.solve_greedy(warm, pol)
        jg.solve_greedy(ref, jpol)
        prev = {n: s.allocation.clone() for n, s in warm.servers.items()
                if s.allocation is not None}
        jprev = {n: s.allocation.clone() for n, s in ref.servers.items()
                 if s.allocation is not None}
        pools = {n: tuple(sorted(c for c in p))
                 for n, p in tg.server_chip_pools(warm).items()}
        rng = random.Random(seed + 1000)
        changed = set(rng.sample(sorted(cands), 3))
        moved = dict(cands)
        for name in changed:
            moved[name] = [(acc, rng.randint(0, 4), 20.0, rng.choice(
                [5.0, 10.0, 30.0])) for acc in rng.sample(ACCS, 2)]
        install(warm, moved, Allocation)
        install(ref, moved, JAllocation)
        tg.solve_greedy_warm(warm, pol, prev, changed, prev_pools=pools)
        jg.solve_greedy_warm(ref, jpol, jprev, changed, prev_pools=pools)
        _, cold, _ = systems(seed)
        install(cold, moved, Allocation)
        tg.solve_greedy(cold, pol)
        assert snap(warm) == snap(cold), seed
        assert snap(warm) == snap(ref), seed


def test_pool_components_match_reference():
    for seed in SEEDS:
        ref, got, _ = systems(seed)
        for fn in ("server_chip_pools", "candidate_chip_pools"):
            mine = getattr(tg, fn)(got)
            theirs = getattr(jg, fn)(ref)
            assert mine == theirs, (seed, fn)
            assert tg.pool_components(mine) == jg.pool_components(theirs)


def test_knob_parsing(monkeypatch):
    monkeypatch.setenv("WVA_VECTOR_GREEDY", "off")
    assert not tg.vector_greedy_enabled(10**6)
    monkeypatch.setenv("WVA_VECTOR_GREEDY", "on")
    assert tg.vector_greedy_enabled(1)
    monkeypatch.setenv("WVA_VECTOR_GREEDY", "auto")
    assert not tg.vector_greedy_enabled(1023)
    assert tg.vector_greedy_enabled(1024)
    monkeypatch.setenv("WVA_VECTOR_GREEDY_MIN", "64")
    assert tg.vector_greedy_enabled(64)


def test_auto_floor_keeps_small_fleets_sequential(monkeypatch):
    monkeypatch.setenv("WVA_VECTOR_GREEDY", "auto")
    monkeypatch.delenv("WVA_VECTOR_GREEDY_MIN", raising=False)
    _, got, _ = systems(1)
    assert tg._vector_fast_pass(got, None, dict(got.capacity)) is None


def test_default_is_the_sequential_loop(monkeypatch):
    """Unset, the knob keeps every fleet on the sequential loop, however
    many lanes it has."""
    monkeypatch.delenv("WVA_VECTOR_GREEDY", raising=False)
    monkeypatch.delenv("WVA_VECTOR_GREEDY_MIN", raising=False)
    assert not tg.vector_greedy_enabled(10**6)
    _, got, _ = systems(1)
    assert tg._vector_fast_pass(got, None, dict(got.capacity)) is None


def test_uncontended_component_resolved_in_sweep(monkeypatch):
    """Capacity for every first choice: the sweep settles every server,
    picking the first-inserted of two equal-value candidates, and takes
    the chips from the capacity view."""
    monkeypatch.setenv("WVA_VECTOR_GREEDY", "on")
    servers = [helpers.server_spec(name=f"s{i}") for i in range(3)]
    got = port.System(device="cpu", dtype=torch.float64)
    got.set_from_spec(port_spec(servers, {"v5e": 100}))
    install(got, {f"s{i}": [("v5e-4", 1, 80.0, 40.0), ("v5e-1", 2, 40.0, 40.0)]
                  for i in range(3)}, Allocation)
    available = dict(got.capacity)
    assert tg._vector_fast_pass(got, None, available) == set()
    assert {s.allocation.accelerator for s in got.servers.values()} == {"v5e-4"}
    assert available == {"v5e": 100 - 3 * 4}
