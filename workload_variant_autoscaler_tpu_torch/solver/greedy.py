"""Greedy capacity-aware solver with saturation policies.

Counterpart of the reference package's `solver/greedy.py` (the Go
reference's pkg/solver/greedy.go). Servers are sorted by (priority,
regret), regret being the value delta to each server's next-best
candidate, then list-scheduled against finite per-generation chip pools.
Capacity is chip-granular: one replica consumes slices_per_replica *
chips_per_slice chips of the slice's generation. Servers that fit no
full allocation get best-effort treatment per the saturation policy.

The vector fast pass (WVA_VECTOR_GREEDY, off unless asked for) settles
every uncontended pool-connected component in one sweep of segment
reductions (`_greedy_sweep`, PyTorch ops on the System's device) and
leaves the rest to the exact sequential loop.
"""

from __future__ import annotations

import bisect
import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import Allocation, SaturationPolicy, System
from ..models.entities import Server
from ..utils.device import readback


def _vector_greedy_mode() -> str:
    return os.environ.get("WVA_VECTOR_GREEDY", "off").strip().lower()


def vector_greedy_enabled(lanes: int) -> bool:
    """WVA_VECTOR_GREEDY: "off" (default), "on", or "auto" (vectorize
    when the candidate lane count reaches WVA_VECTOR_GREEDY_MIN, default
    1024). Off by default: the sweep's build is O(lanes) in Python. On
    an H100 host (bench_torch_host.py, PERF.md section 6) it lost to the
    loop at 4096 lanes, and at every size up to 65536 where each variant
    has its own model; with 8 shared models it won from 16384 lanes."""
    mode = _vector_greedy_mode()
    if mode in ("off", "0", "false", "no"):
        return False
    if mode in ("on", "1", "true", "yes", "force"):
        return True
    try:
        floor = int(os.environ.get("WVA_VECTOR_GREEDY_MIN", "1024"))
    except ValueError:
        floor = 1024
    return lanes >= floor


@dataclass
class _Entry:
    """Per-server scheduling state (reference greedy.go:17-27)."""

    server: Server
    priority: int
    allocations: list[Allocation]  # sorted by value ascending
    cur_index: int = 0
    delta: float = field(default=0.0)  # regret to next-best candidate

    def current(self) -> Allocation:
        return self.allocations[self.cur_index]

    def sort_key(self) -> tuple:
        # priority asc, then regret desc, then current value desc
        # (reference greedy.go:77-88)
        return (self.priority, -self.delta, -self.current().value)


def _chips_per_replica(system: System, server: Server, alloc: Allocation) -> int:
    acc = system.accelerator(alloc.accelerator)
    model = system.model(server.model_name)
    if acc is None or model is None:
        return 0
    return model.num_instances(acc.name) * acc.chips


def _make_entries(system: System, only=None) -> list[_Entry]:
    entries = []
    for server in system.servers.values():
        if only is not None and server.name not in only:
            continue
        server.remove_allocation()
        if not server.all_allocations:
            continue
        allocs = sorted(server.all_allocations.values(), key=lambda a: a.value)
        e = _Entry(server=server, priority=server.priority(system), allocations=allocs)
        e.delta = allocs[1].value - allocs[0].value if len(allocs) > 1 else math.inf
        entries.append(e)
    entries.sort(key=_Entry.sort_key)
    return entries


def _segment_min(values: torch.Tensor, segments: torch.Tensor,
                 num_segments: int, identity) -> torch.Tensor:
    """Per-segment minimum; an empty segment holds `identity`."""
    out = torch.full((num_segments,), identity, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, segments, values, "amin", include_self=True)


def _greedy_sweep(values, lane_server, lane_cnt, lane_pool, lane_has,
                  pool_cap, pool_comp, srv_pool):
    """One allocation sweep over every pool-connected component.

    Per server: segment-min of candidate value, then segment-min of lane
    index among the value-minimal lanes, which is exactly the sequential
    path's stable-sort tie-break (first-inserted candidate wins). Per
    pool: segment-sum of the chosen lanes' chip counts. Per component
    (`pool_comp` is each pool's component id): the min of its pools'
    fits, broadcast back to servers. A component whose every pool fits
    its servers' first choices is identical to the sequential greedy
    there (no pop can fail, so order, priority and best-effort are all
    no-ops); the rest fall back to the sequential loop. Returns the
    chosen lane and the fit flag per server slot (int64)."""
    n_servers = srv_pool.shape[0]
    n_pools = pool_cap.shape[0]
    l_pad = values.shape[0]
    min_val = _segment_min(values, lane_server, n_servers, math.inf)
    lane_idx = torch.arange(l_pad, dtype=torch.int64, device=values.device)
    first = values == min_val[lane_server]
    chosen = _segment_min(torch.where(first, lane_idx, l_pad), lane_server,
                          n_servers, l_pad)
    has = chosen < l_pad
    safe = torch.clamp(chosen, 0, l_pad - 1)
    real = has & lane_has[safe]
    cnt = torch.where(real, lane_cnt[safe], 0)
    pool = torch.where(real, lane_pool[safe], 0)
    demand = torch.zeros(n_pools, dtype=torch.int64, device=values.device)
    demand = demand.scatter_reduce(0, pool, cnt, "sum", include_self=True)
    pool_ok = (demand <= pool_cap).to(torch.int64)
    comp_ok = _segment_min(pool_ok, pool_comp, n_pools, _INT32_MAX)
    ok = comp_ok[pool_comp[srv_pool]] > 0
    return chosen, ok.to(torch.int64)


# lane/server/pool shape quanta, as the reference package's sweep (the +1
# guarantees at least one padded server/pool slot for padded lanes and
# pool-less servers to point at)
_SWEEP_LANE_BUCKET = 64
_SWEEP_POOL_BUCKET = 16
_INT32_MAX = 2**31 - 1


def _bucket(n: int, quantum: int) -> int:
    return max(-(-n // quantum) * quantum, quantum)


def _vector_fast_pass(system: System, only, available: dict[str, int]):
    """Resolve every uncontended pool-connected component in one sweep on
    `system.device`; returns the names still needing the sequential
    greedy, or None when the vector path is disabled or inapplicable
    (the caller runs the sequential greedy over the full scope).

    Exactness contract (mirrors the sequential loop bit for bit):
    - first choice = min-value candidate, ties to first insertion order;
    - a candidate with a vanished accelerator consumes nothing and
      leaves its server unallocated without advancing;
    - values compare in float64 on every device, chip counts sum in
      int64 (past the int32 range the pass stands down, as the
      reference package's does).
    """
    if _vector_greedy_mode() in ("off", "0", "false", "no"):
        return None
    if only is None:
        scoped = list(system.servers.values())
    else:
        scoped = [s for name, s in system.servers.items() if name in only]

    values: list[float] = []
    lane_counts: list[int] = []   # lanes per server -> np.repeat below
    lane_cnt: list[int] = []
    lane_pool: list[int] = []
    lane_has: list[bool] = []
    lane_alloc: list[Allocation] = []
    srv_objs: list[Server] = []
    srv_pool: list[int] = []
    pool_idx: dict[str, int] = {}
    pool_names: list[str] = []
    # (model name, accelerator name) -> (chips per replica, pool index,
    # accelerator exists): one dict hit per lane
    combo_cache: dict[tuple, tuple] = {}
    # int-indexed union-find over pools
    parent: list[int] = []

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def resolve(mname: str, acc_name: str) -> tuple:
        acc = system.accelerator(acc_name)
        if acc is None:
            combo = (0, 0, False)
        else:
            model = system.model(mname)
            units = (0 if model is None
                     else model.num_instances(acc_name) * acc.chips)
            pool = pool_idx.get(acc.chip)
            if pool is None:
                pool = pool_idx[acc.chip] = len(pool_names)
                pool_names.append(acc.chip)
                parent.append(pool)
            combo = (units, pool, True)
        combo_cache[(mname, acc_name)] = combo
        return combo

    for server in scoped:
        server.remove_allocation()
        allocs = server.all_allocations
        if not allocs:
            continue
        mname = server.model_name
        my_first_pool = -1
        for alloc in allocs.values():
            combo = combo_cache.get((mname, alloc.accelerator))
            if combo is None:
                combo = resolve(mname, alloc.accelerator)
            units, pool, has = combo
            if has:
                if my_first_pool < 0:
                    my_first_pool = pool
                elif my_first_pool != pool:
                    ra, rb = find(my_first_pool), find(pool)
                    if ra != rb:
                        parent[ra] = rb
            values.append(alloc.value)
            lane_cnt.append(alloc.num_replicas * units)
            lane_pool.append(pool)
            lane_has.append(has)
            lane_alloc.append(alloc)
        lane_counts.append(len(allocs))
        srv_objs.append(server)
        srv_pool.append(my_first_pool)

    n_l, n_s, n_p = len(values), len(srv_objs), len(pool_names)
    if n_s == 0:
        return set()
    # the auto floor is checked against the true lane count, after the
    # cheap build
    if not vector_greedy_enabled(n_l):
        return None
    if sum(lane_cnt) > _INT32_MAX:
        return None  # the reference's int32 segment sums could wrap there

    l_pad = _bucket(n_l, _SWEEP_LANE_BUCKET)
    s_pad = _bucket(n_s + 1, _SWEEP_LANE_BUCKET)
    p_pad = _bucket(n_p + 1, _SWEEP_POOL_BUCKET)

    values_a = np.full(l_pad, np.inf, dtype=np.float64)
    values_a[:n_l] = values
    # int64 lane columns: server, chip count, pool, accelerator exists
    lanes_a = np.zeros((4, l_pad), dtype=np.int64)
    lanes_a[0] = s_pad - 1
    lanes_a[0, :n_l] = np.repeat(np.arange(n_s), lane_counts)
    lanes_a[1, :n_l] = np.minimum(lane_cnt, _INT32_MAX)
    lanes_a[2, :n_l] = lane_pool
    lanes_a[3, :n_l] = lane_has
    # pool columns: capacity, component id
    pools_a = np.zeros((2, p_pad), dtype=np.int64)
    pools_a[0] = _INT32_MAX
    pools_a[0, :n_p] = np.clip(
        [available.get(c, 0) for c in pool_names], 0, _INT32_MAX)
    pools_a[1] = np.arange(p_pad)
    pools_a[1, :n_p] = [find(p) for p in range(n_p)]
    # pool-less servers (every candidate's accelerator vanished) and the
    # padded server slots point at the first padded pool: always fits
    srv_pool_a = np.full(s_pad, n_p, dtype=np.int64)
    srv_pool_raw = np.asarray(srv_pool, dtype=np.int64)
    srv_pool_a[:n_s] = np.where(srv_pool_raw < 0, n_p, srv_pool_raw)

    dev = system.device
    lanes_d = torch.tensor(lanes_a, device=dev)
    pools_d = torch.tensor(pools_a, device=dev)
    chosen_d, ok_d = _greedy_sweep(
        torch.tensor(values_a, device=dev), lanes_d[0], lanes_d[1],
        lanes_d[2], lanes_d[3] > 0, pools_d[0], pools_d[1],
        torch.tensor(srv_pool_a, device=dev))
    chosen_l, ok_l = readback(torch.stack([chosen_d, ok_d])).tolist()

    remaining: set[str] = set()
    consumed = [0] * n_p
    for sidx, server in enumerate(srv_objs):
        if not ok_l[sidx]:
            remaining.add(server.name)
            continue
        lane = chosen_l[sidx]
        if not lane_has[lane]:
            continue  # vanished accelerator: stays unallocated
        consumed[lane_pool[lane]] += lane_cnt[lane]
        server.set_allocation(lane_alloc[lane])
    for pool, used in enumerate(consumed):
        if used:
            chip = pool_names[pool]
            available[chip] = available.get(chip, 0) - used
    return remaining


def solve_greedy(
    system: System,
    policy: SaturationPolicy,
    delayed_best_effort: bool = False,
) -> None:
    """Entry point (reference greedy.go:35-104)."""
    available = dict(system.capacity)  # chip generation -> chips
    scope = _vector_fast_pass(system, None, available)
    if scope is not None and not scope:
        return  # vector pass settled every server
    entries = _make_entries(system, only=scope)

    if delayed_best_effort:
        unallocated = _allocate(system, entries, available)
        _best_effort(system, unallocated, available, policy)
    else:
        for group in priority_groups(entries):
            unallocated = _allocate(system, group, available)
            _best_effort(system, unallocated, available, policy)


def server_chip_pools(system: System) -> dict[str, list[str]]:
    """Per-server chip pools: the chip generation behind every candidate
    allocation of every server, the coupling graph's edge set (two
    servers interact exactly when these lists intersect, transitively)."""
    server_pools: dict[str, list[str]] = {}
    for name, server in system.servers.items():
        chips = []
        for alloc in server.all_allocations.values():
            acc = system.accelerator(alloc.accelerator)
            if acc is not None:
                chips.append(acc.chip)
        server_pools[name] = chips
    return server_pools


def candidate_chip_pools(system: System) -> dict[str, list[str]]:
    """Like server_chip_pools, but over the PROFILE-feasible candidate
    accelerators instead of the solved allocations: available before (or
    without) any calculate() pass. A superset of the solved pools, so the
    resulting components are only ever coarser."""
    server_pools: dict[str, list[str]] = {}
    for name, server in system.servers.items():
        chips = []
        model = system.models.get(server.model_name)
        for acc_name, acc in server.candidate_accelerators(
                system.accelerators).items():
            if model is None or model.profile(acc_name) is None:
                continue
            chips.append(acc.chip)
        server_pools[name] = chips
    return server_pools


def _chip_union_find(server_pools: dict[str, list[str]]):
    """Union-find over chip pool names, with every server's candidate
    chips pre-unioned; returns the path-compressing `find` closure."""
    parent: dict[str, str] = {}

    def find(x: str) -> str:
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for chips in server_pools.values():
        for chip in chips[1:]:
            ra, rb = find(chips[0]), find(chip)
            if ra != rb:
                parent[ra] = rb
    return find


def pool_components(
    server_pools: dict[str, list[str]],
) -> dict[str, frozenset[str]]:
    """Partition servers into pool-connected components: server ->
    frozenset of every server in its component (itself included).
    Components' chip pools are disjoint by construction, so re-solving
    one component against the FULL capacity view is exact. A server with
    no recognised candidate chips is its own singleton component."""
    find = _chip_union_find(server_pools)
    members: dict[str, set[str]] = {}
    for name, chips in server_pools.items():
        root = find(chips[0]) if chips else f"@chipless:{name}"
        members.setdefault(root, set()).add(name)
    frozen = {root: frozenset(names) for root, names in members.items()}
    return {name: frozen[root]
            for root, names in members.items() for name in names}


def solve_greedy_warm(
    system: System,
    policy: SaturationPolicy,
    prev: dict[str, Allocation],
    changed,
    prev_pools: dict[str, tuple] | None = None,
    delayed_best_effort: bool = False,
) -> None:
    """Greedy solve warm-started from the previous cycle's choices.

    Chip capacity couples servers only through shared generation pools,
    so the full greedy re-runs on exactly the pool-connected components
    containing a changed server; every server in an untouched component
    keeps its previous allocation verbatim (a clone: best-effort
    policies scale an Allocation in place). A changed server's PREVIOUS
    pools (`prev_pools`) count as touched too: capacity it freed would
    go to unchanged competitors in a full solve.

    Exactness relies on the caller's invariants (solver/incremental.py):
    `prev` is the completed previous solve over the same candidate set,
    every unchanged server's candidate allocations (values included)
    equal last cycle's, and the capacity view is unchanged; otherwise
    the caller runs solve_greedy.
    """
    changed = set(changed)
    prev_pools = prev_pools or {}
    server_pools = server_chip_pools(system)
    find = _chip_union_find(server_pools)

    affected_roots = set()
    for name in changed:
        for chip in list(server_pools.get(name, ())) + \
                list(prev_pools.get(name, ())):
            affected_roots.add(find(chip))
    affected = {name for name, chips in server_pools.items()
                if name in changed
                or any(find(c) in affected_roots for c in chips)}

    for name, server in system.servers.items():
        if name in affected:
            continue
        server.remove_allocation()
        prev_alloc = prev.get(name)
        if prev_alloc is not None:
            server.set_allocation(prev_alloc.clone())

    # the full algorithm, restricted to the affected components; their
    # pools are untouched by unaffected servers, so starting from the
    # full capacity view is exact
    available = dict(system.capacity)
    scope = _vector_fast_pass(system, affected, available)
    if scope is not None and not scope:
        return  # vector pass settled every affected server
    entries = _make_entries(system, only=affected if scope is None else scope)
    if delayed_best_effort:
        unallocated = _allocate(system, entries, available)
        _best_effort(system, unallocated, available, policy)
    else:
        for group in priority_groups(entries):
            unallocated = _allocate(system, group, available)
            _best_effort(system, unallocated, available, policy)


def _allocate(
    system: System, entries: list[_Entry], available: dict[str, int]
) -> list[_Entry]:
    """Greedy list allocation; returns servers that fit no candidate
    (reference greedy.go:107-166)."""
    entries = list(entries)
    keys = [e.sort_key() for e in entries]
    unallocated: list[_Entry] = []
    while entries:
        top = entries.pop(0)
        keys.pop(0)
        if not top.allocations:
            continue
        alloc = top.current()
        acc = system.accelerator(alloc.accelerator)
        if acc is None:
            continue
        units = _chips_per_replica(system, top.server, alloc)
        count = alloc.num_replicas * units
        chip = acc.chip
        if available.get(chip, 0) >= count:
            available[chip] = available.get(chip, 0) - count
            top.server.set_allocation(alloc)
        else:
            # advance to the next-best candidate and re-insert in order
            top.cur_index += 1
            if top.cur_index >= len(top.allocations):
                unallocated.append(top)
                continue
            if top.cur_index + 1 < len(top.allocations):
                top.delta = (
                    top.allocations[top.cur_index + 1].value
                    - top.allocations[top.cur_index].value
                )
            else:
                top.delta = math.inf
            key = top.sort_key()
            i = bisect.bisect_left(keys, key)
            entries.insert(i, top)
            keys.insert(i, key)
    return unallocated


def _best_effort(
    system: System,
    unallocated: list[_Entry],
    available: dict[str, int],
    policy: SaturationPolicy,
) -> None:
    """Dispatch on saturation policy (reference greedy.go:169-190)."""
    if policy is SaturationPolicy.PRIORITY_EXHAUSTIVE:
        _allocate_maximally(system, unallocated, available)
    elif policy is SaturationPolicy.PRIORITY_ROUND_ROBIN:
        for group in priority_groups(unallocated):
            _allocate_equally(system, group, available)
    elif policy is SaturationPolicy.ROUND_ROBIN:
        _allocate_equally(system, unallocated, available)
    # NONE: no allocation beyond satisfying SLOs


def _allocate_maximally(
    system: System, entries: list[_Entry], available: dict[str, int]
) -> None:
    """Priority ordering, one server at a time exhaustively (reference
    greedy.go:194-223): give each server as many replicas of its
    best-value candidate as remaining capacity allows (capped at
    desired), scaling cost/value pro rata."""
    for entry in entries:
        for alloc in entry.allocations:
            acc = system.accelerator(alloc.accelerator)
            if acc is None:
                continue
            units = _chips_per_replica(system, entry.server, alloc)
            if units <= 0:
                continue
            max_replicas = min(available.get(acc.chip, 0) // units, alloc.num_replicas)
            if max_replicas <= 0:
                continue
            factor = max_replicas / alloc.num_replicas
            alloc.cost *= factor
            alloc.value *= factor
            alloc.num_replicas = max_replicas
            entry.server.set_allocation(alloc)
            available[acc.chip] = available.get(acc.chip, 0) - max_replicas * units
            break


@dataclass
class _Ticket:
    entry: _Entry
    active: bool = False
    chip: str = ""
    units: int = 0
    num_replicas: int = 0
    final_alloc: Allocation | None = None


def _allocate_equally(
    system: System, entries: list[_Entry], available: dict[str, int]
) -> None:
    """Round-robin one replica per visit until capacity runs out
    (reference greedy.go:239-316). Distribution continues while chips
    remain: best-effort deliberately hands out all remaining capacity."""
    tickets: dict[str, _Ticket] = {}
    for entry in entries:
        if system.model(entry.server.model_name) is None:
            continue
        tickets[entry.server.name] = _Ticket(entry=entry)

    allocated: dict[str, _Ticket] = {}
    while tickets:
        for entry in entries:
            name = entry.server.name
            ticket = tickets.get(name)
            if ticket is None:
                continue
            if not ticket.active:
                for alloc in entry.allocations:
                    acc = system.accelerator(alloc.accelerator)
                    if acc is None:
                        continue
                    units = _chips_per_replica(system, entry.server, alloc)
                    if units > 0 and available.get(acc.chip, 0) >= units:
                        ticket.active = True
                        ticket.chip = acc.chip
                        ticket.units = units
                        ticket.final_alloc = alloc
                        break
                if not ticket.active:
                    del tickets[name]
                    continue
            replicas_available = available.get(ticket.chip, 0) // ticket.units
            if min(replicas_available, ticket.final_alloc.num_replicas) > 0:
                ticket.num_replicas += 1
                available[ticket.chip] -= ticket.units
                allocated[name] = ticket
            else:
                del tickets[name]

    for name, ticket in allocated.items():
        alloc = ticket.final_alloc
        factor = ticket.num_replicas / alloc.num_replicas
        alloc.cost *= factor
        alloc.value *= factor
        alloc.num_replicas = ticket.num_replicas
        ticket.entry.server.set_allocation(alloc)


def priority_groups(entries: list[_Entry]) -> list[list[_Entry]]:
    """Partition a priority-sorted entry list into runs of equal priority
    (reference greedy.go:321-341)."""
    groups: list[list[_Entry]] = []
    for e in entries:
        if groups and groups[-1][0].priority == e.priority:
            groups[-1].append(e)
        else:
            groups.append([e])
    return groups
