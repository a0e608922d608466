"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and carries the `cuda` marker; on a
host without CUDA each one skips. The file imports only the port (no JAX,
no reference package), so on a machine with the card it runs without the
JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_pallas.py: float64 rtol 1e-9, float32
rtol 1e-3 (mean form) and 2e-3 (tail form).
"""

import numpy as np
import pytest
import torch

from workload_variant_autoscaler_tpu_torch.ops import batched as tb
from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as tk

pytestmark = pytest.mark.cuda

QUEUE_COLS = ("alpha", "beta", "gamma", "delta", "in_tokens", "out_tokens",
              "max_batch")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def batch(b, seed, dtype, device, max_batch=(4, 48, 64, 96, 256)):
    rng = np.random.default_rng(seed)
    rows = {
        "alpha": rng.uniform(2.0, 20.0, b), "beta": rng.uniform(0.005, 0.15, b),
        "gamma": rng.uniform(1.0, 15.0, b), "delta": rng.uniform(0.02, 0.3, b),
        "in_tokens": rng.choice([0.0, 128.0, 1024.0], b),
        "out_tokens": rng.choice([32.0, 128.0, 256.0], b),
        "max_batch": rng.choice(max_batch, b),
    }
    q = tb.make_queue_batch(*(rows[c] for c in QUEUE_COLS), dtype=dtype,
                            device=device)
    t = tb.SLOTargets(*(torch.as_tensor(rng.choice(v, b), dtype=dtype,
                                        device=device)
                        for v in ([0.0, 500.0, 2000.0], [0.0, 24.0, 200.0],
                                  [0.0, 900.0])))
    return q, t, tb.k_max_bucket(tb.k_max_for(rows["max_batch"]))


def launch_inputs(q, t, k, pct):
    b = q.batch_size
    if pct is None:
        prob, _ = tb._sizing_problem(q, t, k)
        fcols, icols = tk.columns(prob, slice(0, 2 * b))
    else:
        prob, _ = tb._tail_problem(q, t, k, pct)
        fcols, icols = tk.columns(prob, slice(0, b), slo=t.ttft,
                                  mun=tb._full_batch_mu(q))
    return fcols, icols, tk._full_clm(q, k)


@pytest.mark.parametrize("pct", [None, 0.9, 0.95, 0.99])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_version(card, pct, dtype):
    rtol = 1e-9 if dtype == torch.float64 else (1e-3 if pct is None else 2e-3)
    q, t, k = batch(96, seed=11, dtype=dtype, device=card)
    fcols, icols, clm = launch_inputs(q, t, k, pct)
    form = "mean" if pct is None else "tail"
    before = tk.launches[form]
    got = tk.bisect(fcols, icols, clm, k, pct)
    ref = tk.bisect_plain(fcols, icols, clm, k, pct)
    torch.cuda.synchronize()
    assert tk.launches[form] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol)


def edge_inputs(case, pct, dtype, device):
    """Launch inputs of one edge case: rows of at most one warp's states
    (max_batch 4, 44 states), one state, frozen rows, a zero Poisson
    scale (Q(k, 0) = 1), a prefill over the SLO, a single row, or rows
    longer than 3072 states (max_batch 512, the 256-thread team)."""
    max_batch = {"under_a_warp": (4,), "one_state": (4,),
                 "over_3072_states": (64, 512)}.get(case, (4, 64, 256))
    q, t, k = batch(24, seed=21, dtype=dtype, device=device,
                    max_batch=max_batch)
    fcols, icols, clm = launch_inputs(q, t, k, pct)
    fcols, icols = fcols.clone(), icols.clone()
    if case == "one_state":
        icols[:, tk.I_KOCC] = 1
        icols[:, tk.I_NMAX] = 1
    elif case == "some_done":
        icols[::3, tk.I_DONE] = 1
    elif case == "all_done":
        icols[:, tk.I_DONE] = 1
    elif case == "zero_poisson_scale":
        fcols[:, tk.F_MUN] = 0.0
    elif case == "prefill_over_slo":
        fcols[:, tk.F_SLO] = 0.5
    elif case == "one_row":
        live = int(torch.nonzero(icols[:, tk.I_DONE] == 0)[0])
        fcols, icols = fcols[live:live + 1], icols[live:live + 1]
        clm = clm[live % clm.shape[0]:live % clm.shape[0] + 1]
    return fcols.contiguous(), icols.contiguous(), clm.contiguous(), k


EDGES = [(c, pct) for c in ("under_a_warp", "one_state", "some_done",
                            "all_done", "one_row", "over_3072_states")
         for pct in (None, 0.95)]
EDGES += [(c, 0.95) for c in ("zero_poisson_scale", "prefill_over_slo")]


@pytest.mark.parametrize("case,pct", EDGES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_version_on_edge_rows(card, case, pct, dtype):
    rtol = 1e-9 if dtype == torch.float64 else (1e-3 if pct is None else 2e-3)
    fcols, icols, clm, k = edge_inputs(case, pct, dtype, card)
    form = "mean" if pct is None else "tail"
    before = tk.launches[form]
    got = tk.bisect(fcols, icols, clm, k, pct)
    ref = tk.bisect_plain(fcols, icols, clm, k, pct)
    torch.cuda.synchronize()
    assert tk.launches[form] == before + 1
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol)
    done = icols[:, tk.I_DONE] > 0
    assert torch.equal(got[done], fcols[done, tk.F_X0])


@pytest.mark.parametrize("pct", [None, 0.95])
@pytest.mark.parametrize("k_occ,buckets", [(704, (768, 2816, 3072, 4096)),
                                           (2816, (2816, 3072, 4096)),
                                           (5632, (5632, 6144, 8192))],
                         ids=["warp_row", "block_row", "big_row"])
def test_lane_bits_independent_of_batch_and_bucket(card, pct, k_occ,
                                                   buckets):
    """One live row of 704 states (a warp's team), 2816 states (a
    128-thread team) or 5632 states (a 256-thread team), in a batch of
    16 under several k_max buckets, has the bits it has at full width;
    so has every other row of the batch whose states fit the bucket."""
    big = k_occ > 3072
    q, t, k = batch(64, seed=12, dtype=torch.float32, device=card,
                    max_batch=(4, 48, 64, 96, 256, 512) if big
                    else (4, 48, 64, 96, 256))
    fcols, icols, clm = launch_inputs(q, t, k, pct)
    full = tk.bisect(fcols, icols, clm, k, pct)
    kocc = icols[:, tk.I_KOCC]
    live = torch.nonzero((kocc == k_occ) & (icols[:, tk.I_DONE] == 0))
    others = torch.nonzero(kocc != k_occ).flatten()[:15]
    rows = torch.cat([live.flatten()[:1], others])
    assert len(rows) == 16
    sub_clm = clm[rows % clm.shape[0]]
    for kk in buckets:
        c = sub_clm[:, :kk] if kk <= k else torch.cat(
            [sub_clm, torch.zeros(len(rows), kk - k, dtype=clm.dtype,
                                  device=card)], dim=1)
        got = tk.bisect(fcols[rows].contiguous(), icols[rows].contiguous(),
                        c.contiguous(), kk, pct)
        assert torch.equal(got[0], full[rows[0]])
        fit = kocc[rows] <= kk
        assert torch.equal(got[fit], full[rows][fit])


@pytest.mark.parametrize("pct", [None, 0.95])
@pytest.mark.parametrize("backend", ["kernel", "batched"])
def test_decide_batch_lane_bits_on_card(card, backend, pct):
    """A lane's packed decision has the same bits in a batch of 64 and in
    a batch of 16 of its rows, under its own k_max bucket, 3072 and 4096
    (System._dedup_rows relies on it)."""
    from workload_variant_autoscaler_tpu_torch.ops import fused

    q, t, k = batch(64, seed=14, dtype=torch.float32, device=card)
    epi = fused.make_epilogue_batch(np.full(64, 40.0), np.ones(64),
                                    np.full(64, 3.0), torch.float32, card)
    full = fused.decide_batch(q, t, epi, k, pct, backend)
    idx = torch.arange(16, 32, device=card)

    def sub(x):
        return type(x)(*[a[idx] for a in x])

    for kk in (k, 3072, 4096):
        got = fused.decide_batch(sub(q), sub(t), sub(epi), kk, pct, backend)
        assert torch.equal(got.view(torch.int32),
                           full[:, idx].contiguous().view(torch.int32))


# the longest bucketed k_max whose shared memory (k_max rounded up to 256
# states, clm and, in the tail form, log i) fits the wrapper's limit
LONGEST = {(torch.float32, None): 57856, (torch.float64, None): 28928,
           (torch.float32, 0.95): 28928, (torch.float64, 0.95): 14336}


@pytest.mark.parametrize("dtype,pct", list(LONGEST))
def test_kernel_takes_rows_as_long_as_shared_memory_allows(card, dtype, pct):
    """Rows of up to k_max states, at the longest k_max of each form and
    dtype, against the plain version (the first port took up to 57856
    states in the float32 mean form, 28928 in float64)."""
    k_max = LONGEST[dtype, pct]
    rtol = 1e-9 if dtype == torch.float64 else (1e-3 if pct is None else 2e-3)
    q, t, k = batch(6, seed=16, dtype=dtype, device=card,
                    max_batch=(64, k_max // 11))
    assert k == k_max
    fcols, icols, clm = launch_inputs(q, t, k, pct)
    got = tk.bisect(fcols, icols, clm, k, pct)
    ref = tk.bisect_plain(fcols, icols, clm, k, pct)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol)


@pytest.mark.parametrize("dtype,pct", list(LONGEST))
def test_wrapper_refuses_what_the_kernel_cannot_take(card, dtype, pct):
    k_max = LONGEST[dtype, pct] + 256    # past the shared memory
    q, t, k = batch(4, seed=15, dtype=dtype, device=card)
    fcols, icols, clm = launch_inputs(q, t, k, pct)
    wide = torch.zeros(clm.shape[0], k_max, dtype=dtype, device=card)
    wide[:, :k] = clm
    with pytest.raises(ValueError, match="k_max"):
        tk.bisect(fcols, icols, wide, k_max, pct)


def test_size_batch_kernel_entries_on_card(card):
    q, t, k = batch(48, seed=13, dtype=torch.float64, device=card)
    for pct in (None, 0.95):
        if pct is None:
            ref, got = tb.size_batch(q, t, k), tk.size_batch_kernel(q, t, k)
        else:
            ref = tb.size_batch_tail(q, t, k, pct)
            got = tk.size_batch_tail_kernel(q, t, k, pct)
        assert torch.equal(ref.feasible, got.feasible)
        np.testing.assert_allclose(got.lam_star.cpu().numpy(),
                                   ref.lam_star.cpu().numpy(), rtol=1e-9)


# ---------------------------------------------------------------------------
# limited mode, the candidate arena and the incremental engine on the card
# ---------------------------------------------------------------------------

def port_fleet(servers, capacity, unlimited=True, policy="None"):
    """A SystemSpec of the port: llama-8b on v5e-1, v5e-4 and v5p-4 (the
    profiles of tests/helpers.py), two service classes."""
    from workload_variant_autoscaler_tpu_torch.models import (
        ModelSliceProfile, ModelTarget, OptimizerSpec, ServiceClassSpec,
        SystemSpec, make_slice)

    return SystemSpec(
        accelerators=[make_slice("v5e", 1, "1x1"), make_slice("v5e", 4, "2x2"),
                      make_slice("v5p", 4, "2x2x1")],
        profiles=[
            ModelSliceProfile("llama-8b", "v5e-1", 6.973, 0.027, 5.2, 0.1,
                              max_batch_size=64, at_tokens=128),
            ModelSliceProfile("llama-8b", "v5e-4", 3.2, 0.012, 2.4, 0.04,
                              max_batch_size=192, at_tokens=128),
            ModelSliceProfile("llama-8b", "v5p-4", 2.1, 0.008, 1.5, 0.025,
                              max_batch_size=256, at_tokens=128)],
        service_classes=[
            ServiceClassSpec("Premium", 1, (ModelTarget(
                "llama-8b", slo_itl=24.0, slo_ttft=500.0,
                slo_ttft_percentile=0.95),)),
            ServiceClassSpec("Freemium", 10, (ModelTarget(
                "llama-8b", slo_itl=150.0, slo_ttft=1500.0),))],
        servers=servers, capacity=dict(capacity),
        optimizer=OptimizerSpec(unlimited=unlimited,
                                saturation_policy=policy))


def port_server(name, rpm, service_class="Premium", min_replicas=1):
    from workload_variant_autoscaler_tpu_torch.models import (
        AllocationData, ServerLoadSpec, ServerSpec)

    return ServerSpec(
        name=name, service_class=service_class, model="llama-8b",
        min_num_replicas=min_replicas,
        current_alloc=AllocationData(
            accelerator="v5e-1", num_replicas=1,
            load=ServerLoadSpec(arrival_rate=rpm, avg_in_tokens=128,
                                avg_out_tokens=128)))


@pytest.mark.parametrize("policy", ["None", "PriorityExhaustive",
                                    "PriorityRoundRobin", "RoundRobin"])
def test_greedy_sweep_on_card_equals_sequential(card, policy, monkeypatch):
    """30 random fleets (tests/test_shard.py's draw): the vector sweep on
    the card settles what it settles exactly as the sequential greedy
    does on the host."""
    import random

    from workload_variant_autoscaler_tpu_torch import System
    from workload_variant_autoscaler_tpu_torch.models import (
        Allocation, SaturationPolicy)
    from workload_variant_autoscaler_tpu_torch.solver import greedy

    def fleet(seed):
        rng = random.Random(seed)
        servers = [port_server(f"s{i:03d}", 1200.0, rng.choice(
            ["Premium", "Freemium"])) for i in range(24)]
        top = 600 if seed % 2 else 60
        system = System(device=card, dtype=torch.float32)
        system.set_from_spec(port_fleet(servers, {
            "v5e": rng.randint(0, top), "v5p": rng.randint(0, top)}))
        for i in range(24):
            allocs = {}
            for acc in rng.sample(["v5e-1", "v5e-4", "v5p-4"],
                                  rng.randint(0, 3)):
                a = Allocation(accelerator=acc, num_replicas=rng.randint(0, 4),
                               cost=rng.choice([10.0, 20.0, 20.0, 40.0]))
                a.value = rng.choice([5.0, 10.0, 10.0, 30.0])
                allocs[acc] = a
            system.servers[f"s{i:03d}"].all_allocations = allocs
        return system

    def snap(system):
        return {n: None if (a := s.allocation) is None
                else (a.accelerator, a.num_replicas, a.cost, a.value)
                for n, s in system.servers.items()}

    pol = SaturationPolicy.parse(policy)
    settled = 0
    for seed in range(30):
        monkeypatch.setenv("WVA_VECTOR_GREEDY", "on")
        swept = fleet(seed)
        settled += greedy._vector_fast_pass(
            swept, None, dict(swept.capacity)) == set()
        greedy.solve_greedy(swept, pol)
        monkeypatch.setenv("WVA_VECTOR_GREEDY", "off")
        seq = fleet(seed)
        greedy.solve_greedy(seq, pol)
        assert snap(swept) == snap(seq), seed
    assert settled >= 5


def list_path_pack(rows, dtype, device, quantum=16):
    """The list path the arena must match bit for bit: make_queue_batch
    and the SLO columns, padded to a multiple of `quantum` with benign
    invalid lanes (alpha=1, out_tokens=2, max_batch=occupancy=1,
    valid=False, zeros elsewhere), and make_epilogue_batch."""
    from workload_variant_autoscaler_tpu_torch.ops import fused

    q = tb.make_queue_batch(*(rows[c] for c in QUEUE_COLS), dtype=dtype,
                            device=device)
    slo = tb.SLOTargets(*(torch.as_tensor(rows[c], dtype=dtype,
                                          device=device)
                          for c in ("ttft", "itl", "tps")))
    pad = (-q.batch_size) % quantum

    def pad_with(a, fill):
        return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                        device=a.device)])

    fills = dict(alpha=1.0, out_tokens=2.0, max_batch=1, occupancy=1,
                 valid=False)
    q = tb.QueueBatch(**{k: pad_with(v, fills.get(k, 0.0))
                         for k, v in q._asdict().items()})
    slo = tb.SLOTargets(*(pad_with(t, 0.0) for t in slo))
    epi = None
    if "demand" in rows:
        epi = fused.make_epilogue_batch(
            rows["demand"], rows["min_replicas"], rows["cost_rate"], dtype,
            device, pad_to=q.batch_size)
    return q, slo, epi


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_arena_pack_on_card_is_bit_identical(card, dtype, epilogue):
    from workload_variant_autoscaler_tpu_torch import System

    rows = dict(alpha=[6.973, 3.2, 9.0], beta=[0.027, 0.012, 0.06],
                gamma=[5.2, 2.4, 7.0], delta=[0.1, 0.04, 0.15],
                in_tokens=[128.0, 128.0, 256.0],
                out_tokens=[128.0, 128.0, 200.0], max_batch=[16, 23, 20],
                ttft=[500.0, 500.0, 2000.0], itl=[24.0, 24.0, 80.0],
                tps=[0.0, 0.0, 0.0])
    if epilogue:
        rows.update(demand=[12.5, 0.0, 3.25], min_replicas=[1, 0, 3],
                    cost_rate=[20.0, 80.0, 340.0])
    packs = zip(list_path_pack(rows, dtype, card),
                System(device=card, dtype=dtype)._pack_group(rows))
    for k, (want, got) in enumerate(packs):
        if k == 2 and not epilogue:
            assert want is None and got is None
            continue
        for a, b in zip(want, got):
            assert a.device.type == b.device.type == card.type
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("unlimited,policy", [(True, "None"),
                                              (False, "RoundRobin")])
def test_engine_churn_on_card_equals_from_scratch(card, unlimited, policy):
    """30 cycles of seeded churn (load steps and sub-epsilon jitter,
    zero-load transitions, grow/shrink, capacity changes) through a
    persistent engine and a from-scratch one, both on the card: equal
    solutions every cycle."""
    import random

    from workload_variant_autoscaler_tpu_torch import (
        IncrementalSolveEngine, Manager, Optimizer, System)

    def cycle(spec, engine):
        system = System(device=card, dtype=torch.float32)
        opt = system.set_from_spec(spec)
        stats = engine.calculate(system, backend="kernel",
                                 optimizer_spec=opt)
        Manager(system, Optimizer(opt)).optimize(warm=engine.warm_start())
        solution = system.generate_solution()
        engine.finish_cycle(system)
        return solution, stats

    rng = random.Random(0x17C)
    names = [f"v{i}" for i in range(12)]
    live = set(names[:8])
    loads = {n: 300.0 + 40.0 * i for i, n in enumerate(names)}
    capacity = {"v5e": 40, "v5p": 12}
    engine = IncrementalSolveEngine(epsilon=0.05, full_every=7)
    skipped = 0
    for c in range(30):
        for n in rng.sample(sorted(live), 2):
            f = rng.choice([1.0, 1.3, 0.7, 1.0125, 0.9875, 0.0])
            loads[n] = loads[n] * f if f else 200.0 * rng.randrange(2)
        if rng.random() < 0.15:
            pick = rng.choice(names)
            if pick in live and len(live) > 4:
                live.discard(pick)
            else:
                live.add(pick)
        if rng.random() < 0.1:
            capacity = {"v5e": rng.choice([30, 40, 60]), "v5p": 12}
        servers = [port_server(n, loads[n], "Premium" if int(n[1:]) % 2
                               else "Freemium") for n in sorted(live)]
        spec = port_fleet(servers, capacity, unlimited, policy)
        got, stats = cycle(spec, engine)
        want, _ = cycle(spec, IncrementalSolveEngine(epsilon=0.05,
                                                     full_every=1))
        assert got == want, c
        skipped += stats.lanes_skipped > 0
    assert skipped > 15


def test_hierarchical_engine_on_card_equals_from_scratch(card, tmp_path):
    """A limited three-component fleet through the hierarchical engine
    (shards of 4, forced full every 3 cycles) on the card, float32: equal
    to a from-scratch flat engine every cycle. Each variant is pinned
    (keep_accelerator) to the one slice its model is profiled on, v5e-4,
    v5p-4 or v6e-1: the partition unions the chips of every candidate
    accelerator, which is the whole catalog for a server that is not
    pinned, so only pinned servers split into per-generation components.
    Then one checkpoint round-trip: the restarted engine restores, its
    first cycle on the unchanged fleet is `restored` and solves no lane,
    and it still decides as the from-scratch engine."""
    import dataclasses

    from workload_variant_autoscaler_tpu_torch import (
        HierarchicalSolveEngine, IncrementalSolveEngine, Manager, Optimizer,
        System)
    from workload_variant_autoscaler_tpu_torch.models import (
        ModelSliceProfile, make_slice)

    def cycle(spec, engine):
        system = System(device=card, dtype=torch.float32)
        opt = system.set_from_spec(spec)
        stats = engine.calculate(system, backend="kernel",
                                 optimizer_spec=opt)
        Manager(system, Optimizer(opt)).optimize(warm=engine.warm_start())
        solution = system.generate_solution()
        engine.finish_cycle(system)
        return solution, stats

    # model m<g> runs on one slice of generation g
    pins = {"m0": "v5e-4", "m1": "v5p-4", "m2": "v6e-1"}
    base = port_fleet([], {"v5e": 60, "v5p": 24, "v6e": 12}, False,
                      "PriorityRoundRobin")
    coeffs = {p.accelerator: p for p in base.profiles}
    coeffs["v6e-1"] = dataclasses.replace(coeffs["v5e-1"], alpha=5.0)
    profiles = [ModelSliceProfile(m, acc, c.alpha, c.beta, c.gamma, c.delta,
                                  max_batch_size=c.max_batch_size,
                                  at_tokens=c.at_tokens)
                for m, acc in pins.items() for c in [coeffs[acc]]]
    classes = [dataclasses.replace(svc, model_targets=tuple(
        dataclasses.replace(svc.model_targets[0], model=m) for m in pins))
        for svc in base.service_classes]

    def spec(loads):
        servers = []
        for i, rpm in enumerate(loads):
            server = port_server(f"v{i}", rpm,
                                 "Premium" if i % 2 else "Freemium")
            model = f"m{i % 3}"
            servers.append(dataclasses.replace(
                server, model=model, keep_accelerator=True,
                current_alloc=dataclasses.replace(
                    server.current_alloc, accelerator=pins[model])))
        return dataclasses.replace(
            base, accelerators=base.accelerators + [make_slice("v6e", 1,
                                                               "1x1")],
            profiles=profiles, service_classes=classes, servers=servers)

    path = str(tmp_path / "arena.ckpt")
    kw = dict(epsilon=0.05, full_every=3, shard_target=4, min_variants=1)
    engine = HierarchicalSolveEngine(checkpoint_path=path,
                                     checkpoint_every=2, **kw)
    loads = [300.0 + 40.0 * i for i in range(12)]
    for c in range(6):
        loads[c % 12] *= 1.3
        loads[(5 * c + 3) % 12] *= 0.7
        got, stats = cycle(spec(loads), engine)
        want, _ = cycle(spec(loads), IncrementalSolveEngine(epsilon=0.05,
                                                            full_every=1))
        assert got == want, c
        assert stats.shards == 3 and stats.shards_solved >= 1
    pools = sorted(map(sorted, engine.last_partition.pool_sets.values()))
    assert pools == [["v5e"], ["v5p"], ["v6e"]]
    assert engine.last_capacity_slices is not None
    assert engine.ckpt_events["save"] == 3
    assert engine.ckpt_events["save_error"] == 0

    restarted = HierarchicalSolveEngine(checkpoint_path=path, **kw)
    assert restarted.ckpt_events["restore"] == 1
    got, stats = cycle(spec(loads), restarted)
    assert stats.restored and not stats.full and stats.lanes_solved == 0
    assert got == want
