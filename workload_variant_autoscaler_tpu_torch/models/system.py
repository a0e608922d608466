"""System: the instance-scoped registry + batched candidate analysis.

Counterpart of the reference package's `models/system.py`: every
(server, slice-shape) candidate of the fleet is sized in one decision
per sizing group (`ops/fused.py decide_batch`), on the device the System
was built for, with one readback of the packed result per group. The
staged path (WVA_FUSED_SOLVE=off) sizes, counts replicas on the host and
re-analyzes in separate steps; it is the fused decision's exactness
reference.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import fused
from ..ops.arena import CandidateArena
from ..ops.batched import analyze_batch, k_max_bucket, k_max_for
from ..utils.device import readback, resolve_device, resolve_dtype
from .allocation import (
    Allocation,
    effective_batch_size,
    replica_demand,
    zero_load_allocation,
)
from .entities import Accelerator, Model, Server, ServiceClass
from .spec import (
    AcceleratorSpec,
    AllocationData,
    AllocationSolution,
    ModelSliceProfile,
    OptimizerSpec,
    ServerSpec,
    ServiceClassSpec,
    SystemSpec,
    resolve_for_context,
)


def fused_solve_enabled() -> bool:
    """WVA_FUSED_SOLVE (default on): decide each sizing group in one
    decide_batch. `off` runs the staged path (size, host replica loop,
    re-analysis); both publish identical decisions."""
    return os.environ.get("WVA_FUSED_SOLVE", "").strip().lower() not in (
        "off", "false", "0", "disabled")


@dataclass
class AllocationByType:
    """Aggregate usage per chip generation: count is in chips."""

    name: str
    count: int = 0
    limit: int = 0
    cost: float = 0.0


def _percentile_groups(pairs, ttft_percentile: float | None):
    """Sizing groups by EFFECTIVE percentile: the service class's own
    slo-ttft-percentile, else the global one, else mean (0.0). A
    homogeneous fleet is exactly one group."""
    groups: dict[float, list] = {}
    for pair in pairs:
        target = pair[3]
        p = target.slo_ttft_percentile or (ttft_percentile or 0.0)
        groups.setdefault(p, []).append(pair)
    return groups


class System:
    """The fleet registry, sized on `device` (default cuda) in `dtype`
    (default float32)."""

    def __init__(self, device=None, dtype=None) -> None:
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.accelerators: dict[str, Accelerator] = {}
        self.models: dict[str, Model] = {}
        self.service_classes: dict[str, ServiceClass] = {}
        self.servers: dict[str, Server] = {}
        self.capacity: dict[str, int] = {}  # chip generation -> chips
        self.allocation_by_type: dict[str, AllocationByType] = {}
        self.allocation_solution: Optional[AllocationSolution] = None
        # resident packing buffers of the sizing groups (ops/arena.py);
        # the incremental engine attaches its own, which outlives the
        # per-cycle System
        self.arena = CandidateArena()
        # candidate lanes examined by the LAST calculate() call (kernel
        # lanes + zero-load allocations), and the distinct lanes it sized
        # after identical-lane dedup (_dedup_rows; all of them on the
        # staged path)
        self.last_solve_lanes = 0
        self.last_unique_lanes = 0

    # -- spec ingestion --------------------------------------------------

    def set_from_spec(self, spec: SystemSpec) -> OptimizerSpec:
        """Ingest a SystemSpec, REPLACING any previously ingested state
        (entities deleted from the spec disappear; derived solve state is
        cleared)."""
        self.accelerators = {}
        self.models = {}
        self.service_classes = {}
        self.servers = {}
        self.capacity = {}
        self.allocation_by_type = {}
        self.allocation_solution = None
        for acc in spec.accelerators:
            self.add_accelerator(acc)
        for profile in spec.profiles:
            self.add_profile(profile)
        for svc in spec.service_classes:
            self.add_service_class_spec(svc)
        for server in spec.servers:
            self.add_server(server)
        self.capacity.update(spec.capacity)
        return spec.optimizer

    def add_accelerator(self, spec: AcceleratorSpec) -> None:
        self.accelerators[spec.name] = Accelerator(spec)

    def remove_accelerator(self, name: str) -> None:
        if name not in self.accelerators:
            raise KeyError(f"accelerator {name} not found")
        del self.accelerators[name]

    def add_profile(self, profile: ModelSliceProfile) -> None:
        model = self.models.get(profile.model)
        if model is None:
            model = self.models[profile.model] = Model(profile.model)
        model.add_profile(profile)

    def add_service_class_spec(self, spec: ServiceClassSpec) -> None:
        self.service_classes[spec.name] = ServiceClass.from_spec(spec)

    def add_server(self, spec: ServerSpec) -> None:
        self.servers[spec.name] = Server(spec)

    def remove_server(self, name: str) -> None:
        if name not in self.servers:
            raise KeyError(f"server {name} not found")
        del self.servers[name]

    # -- lookups ---------------------------------------------------------

    def accelerator(self, name: str) -> Optional[Accelerator]:
        return self.accelerators.get(name)

    def model(self, name: str) -> Optional[Model]:
        return self.models.get(name)

    def service_class(self, name: str) -> Optional[ServiceClass]:
        return self.service_classes.get(name)

    def server(self, name: str) -> Optional[Server]:
        return self.servers.get(name)

    # -- candidate analysis ---------------------------------------------

    def calculate(self, backend: str = "kernel",
                  ttft_percentile: float | None = None,
                  only: Optional[set] = None) -> None:
        """Compute candidate allocations for every server.

        backend="kernel": the bisection runs in the CUDA kernels
        (ops/bisect_kernel.py; on a CPU System, their plain versions).
        backend="batched": the bisection runs as the PyTorch trip loop.
        ttft_percentile: size the TTFT SLO against this percentile of
        the TTFT distribution instead of its mean, for service classes
        without their own slo-ttft-percentile.
        only: restrict candidate computation to these server names,
        leaving every other server's all_allocations untouched (the
        incremental engine sizes its changed sub-batch through here).
        """
        if backend not in fused.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{fused.BACKENDS}")
        self.last_solve_lanes = 0
        self.last_unique_lanes = 0
        for acc in self.accelerators.values():
            acc.calculate()
        pairs = self._candidate_pairs(only=only)
        for p, group in _percentile_groups(pairs, ttft_percentile).items():
            self._size_group(group, backend=backend,
                             ttft_percentile=(p or None))

    def _candidate_pairs(self, only: Optional[set] = None):
        """Feasible (server, acc) candidates with resolved profile/target."""
        sized_pairs = []   # need a kernel solve
        for server in self.servers.values():
            if only is not None and server.name not in only:
                continue
            server.all_allocations = {}
            load = server.load
            if load is None or load.arrival_rate < 0 or load.avg_in_tokens < 0 \
                    or load.avg_out_tokens < 0:
                continue
            model = self.models.get(server.model_name)
            if model is None:
                continue
            svc = self.service_classes.get(server.service_class_name)
            if svc is None:
                continue
            target = svc.target(server.model_name)
            if target is None:
                continue
            for acc_name in server.candidate_accelerators(self.accelerators):
                profile = model.profile(acc_name)
                if profile is None:
                    continue
                if load.arrival_rate == 0 or load.avg_out_tokens == 0:
                    self.last_solve_lanes += 1
                    alloc = zero_load_allocation(self, server.name, acc_name)
                    if alloc is not None:
                        self._value_and_store(server, acc_name, alloc)
                    continue
                # context-resolved coefficients (long context is a profile
                # dimension; see spec.resolve_for_context)
                profile = resolve_for_context(profile, load.avg_in_tokens)
                self.last_solve_lanes += 1
                sized_pairs.append((server, acc_name, profile, target))
        return sized_pairs

    def _value_and_store(self, server: Server, acc_name: str, alloc: Allocation) -> None:
        if server.cur_allocation is not None:
            alloc.value = server.cur_allocation.transition_penalty(alloc)
        server.all_allocations[acc_name] = alloc

    def _size_group(self, pairs, backend: str,
                    ttft_percentile: float | None) -> None:
        if fused_solve_enabled():
            self._size_group_fused(pairs, backend=backend,
                                   ttft_percentile=ttft_percentile)
        else:
            self._size_group_staged(pairs, backend=backend,
                                    ttft_percentile=ttft_percentile)

    def _group_rows(self, pairs, epilogue: bool) -> dict[str, list]:
        """Host rows for one sizing group: the queue and SLO columns and,
        with `epilogue`, the fused decision's inputs (aggregate demand,
        the min-replica floor, the per-replica cost rate)."""
        rows: dict[str, list] = {
            "alpha": [], "beta": [], "gamma": [], "delta": [],
            "in_tokens": [], "out_tokens": [], "max_batch": [],
            "ttft": [], "itl": [], "tps": [],
        }
        if epilogue:
            rows.update(demand=[], min_replicas=[], cost_rate=[])
        for server, acc_name, profile, target in pairs:
            out_tok = server.load.avg_out_tokens
            rows["alpha"].append(profile.alpha)
            rows["beta"].append(profile.beta)
            rows["gamma"].append(profile.gamma)
            rows["delta"].append(profile.delta)
            rows["in_tokens"].append(server.load.avg_in_tokens)
            rows["out_tokens"].append(out_tok)
            rows["max_batch"].append(effective_batch_size(
                profile, server.max_batch_size, out_tok))
            rows["ttft"].append(target.slo_ttft)
            rows["itl"].append(target.slo_itl)
            rows["tps"].append(target.slo_tps)
            if epilogue:
                rows["demand"].append(replica_demand(
                    server.load.arrival_rate, target.slo_tps, out_tok))
                rows["min_replicas"].append(server.min_num_replicas)
                rows["cost_rate"].append(
                    self.accelerators[acc_name].cost
                    * self.models[server.model_name].num_instances(acc_name))
        return rows

    def _pack_group(self, rows):
        """Device-ready (q, slo, epi|None) for one group, padded to the
        arena's lane bucket on the System's device in its dtype."""
        return self.arena.pack(rows, device=self.device, dtype=self.dtype)

    # the columns that fully determine a lane's result (occupancy derives
    # from max_batch; the group's percentile is shared)
    _LANE_KEY_COLUMNS = ("alpha", "beta", "gamma", "delta", "in_tokens",
                         "out_tokens", "max_batch", "ttft", "itl", "tps",
                         "demand", "min_replicas", "cost_rate")

    @staticmethod
    def _dedup_rows(rows: dict) -> tuple[dict, list]:
        """Collapse identical candidate lanes to one representative.
        Solving each distinct problem once is exact: a lane's result does
        not depend on the batch around it. Returns the deduped rows and
        each original lane's index into them."""
        cols = [rows[c] for c in System._LANE_KEY_COLUMNS]
        index: dict[tuple, int] = {}
        lane_of: list[int] = []
        keep: list[int] = []
        for i, key in enumerate(zip(*cols)):
            at = index.get(key)
            if at is None:
                at = index[key] = len(keep)
                keep.append(i)
            lane_of.append(at)
        if len(keep) == len(lane_of):        # nothing shared
            return rows, lane_of
        deduped = {name: [col[i] for i in keep]
                   for name, col in rows.items()}
        return deduped, lane_of

    def _size_group_fused(self, pairs, backend: str = "kernel",
                          ttft_percentile: float | None = None) -> None:
        """One decision per sizing group (ops/fused.py decide_batch):
        size -> replica-count -> re-analyze -> value on the device, ONE
        readback of the packed result, allocations materialized for the
        feasible lanes only. Identical candidate lanes are solved once."""
        all_rows = self._group_rows(pairs, epilogue=True)
        n_eff = all_rows["max_batch"]
        rows, lane_of = self._dedup_rows(all_rows)
        self.last_unique_lanes += len(rows["alpha"])
        # K bucketed for shape stability under load drift (see k_max_bucket)
        k_max = k_max_bucket(k_max_for(rows["max_batch"]))
        q, slo, epi = self._pack_group(rows)
        packed = fused.decide_batch(q, slo, epi, k_max,
                                    ttft_percentile=ttft_percentile,
                                    backend=backend)
        rows_h = readback(packed).tolist()
        feasible = rows_h[fused.ROW_FEASIBLE]
        replicas = rows_h[fused.ROW_REPLICAS]
        costs = rows_h[fused.ROW_COST]
        itls = rows_h[fused.ROW_ITL]
        ttfts = rows_h[fused.ROW_TTFT]
        rhos = rows_h[fused.ROW_RHO]
        rate_stars = rows_h[fused.ROW_RATE_STAR]
        for i, (server, acc_name, _profile, _target) in enumerate(pairs):
            lane = lane_of[i]
            if feasible[lane] <= 0.0:
                continue
            alloc = Allocation(
                accelerator=acc_name,
                num_replicas=int(replicas[lane]),
                batch_size=int(n_eff[i]),
                cost=costs[lane],
                itl=itls[lane],
                ttft=ttfts[lane],
                rho=rhos[lane],
                max_arrv_rate_per_replica=rate_stars[lane] / 1000.0,
            )
            alloc.value = alloc.cost
            self._value_and_store(server, acc_name, alloc)

    def _size_group_staged(self, pairs, backend: str = "kernel",
                           ttft_percentile: float | None = None) -> None:
        """The staged path (WVA_FUSED_SOLVE=off): sizing, the replica
        count as a host loop, then the per-replica re-analysis, with one
        readback after each device step. The reference the fused
        decision is held against."""
        rows = self._group_rows(pairs, epilogue=False)
        n_eff = rows["max_batch"]
        self.last_unique_lanes += len(n_eff)     # no dedup on this path
        # K bucketed for shape stability under load drift (see k_max_bucket)
        k_max = k_max_bucket(k_max_for(n_eff))
        q, slo, _epi = self._pack_group(rows)
        dtype = q.alpha.dtype
        sized = fused.size_stage(q, slo, k_max, ttft_percentile, backend)
        feasible, rate_star = readback(torch.stack(
            [sized.feasible.to(dtype), sized.throughput]))
        rate_star = rate_star * 1000.0  # req/sec per replica

        # replica counts + per-replica rates on the host, sized to the
        # padded batch so the re-analysis reuses the same shape
        num_replicas = np.zeros(q.batch_size, dtype=np.int64)
        per_replica_rate = np.zeros(q.batch_size)
        for i, (server, acc_name, profile, target) in enumerate(pairs):
            if not feasible[i] or rate_star[i] <= 0:
                continue
            total = replica_demand(
                server.load.arrival_rate, target.slo_tps, server.load.avg_out_tokens
            )
            num_replicas[i] = max(
                math.ceil(total / rate_star[i]), server.min_num_replicas
            )
            per_replica_rate[i] = total / num_replicas[i]

        per_rep = analyze_batch(q, per_replica_rate, k_max)
        itl_a, ttft_a, rho_a, rate_ok, max_batch_a = readback(torch.stack([
            per_rep["avg_token_time"], per_rep["ttft"], per_rep["rho"],
            per_rep["valid_rate"].to(dtype), q.max_batch.to(dtype)]))

        for i, (server, acc_name, profile, target) in enumerate(pairs):
            if not feasible[i] or num_replicas[i] <= 0 or not rate_ok[i]:
                continue
            acc = self.accelerators[acc_name]
            model = self.models[server.model_name]
            cost = acc.cost * model.num_instances(acc_name) * int(num_replicas[i])
            alloc = Allocation(
                accelerator=acc_name,
                num_replicas=int(num_replicas[i]),
                batch_size=int(max_batch_a[i]),
                cost=cost,
                itl=float(itl_a[i]),
                ttft=float(ttft_a[i]),
                rho=float(rho_a[i]),
                max_arrv_rate_per_replica=float(rate_star[i]) / 1000.0,
            )
            alloc.value = alloc.cost
            self._value_and_store(server, acc_name, alloc)

    # -- accounting + solution -------------------------------------------

    def allocate_by_type(self) -> dict[str, AllocationByType]:
        self.allocation_by_type = {}
        for server in self.servers.values():
            alloc = server.allocation
            if alloc is None:
                continue
            acc = self.accelerators.get(alloc.accelerator)
            model = self.models.get(server.model_name)
            if acc is None or model is None:
                continue
            chip = acc.chip
            agg = self.allocation_by_type.setdefault(
                chip, AllocationByType(name=chip, limit=self.capacity.get(chip, 0))
            )
            agg.count += alloc.num_replicas * model.num_instances(acc.name) * acc.chips
            agg.cost += alloc.cost
        return self.allocation_by_type

    def generate_solution(self) -> AllocationSolution:
        allocations: dict[str, AllocationData] = {}
        for name, server in self.servers.items():
            if server.allocation is None:
                continue
            allocations[name] = server.allocation.to_data(server.load)
        self.allocation_solution = AllocationSolution(allocations=allocations)
        return self.allocation_solution

    def total_cost(self) -> float:
        return sum(
            s.allocation.cost for s in self.servers.values() if s.allocation is not None
        )

    def total_chips(self) -> int:
        self.allocate_by_type()
        return sum(a.count for a in self.allocation_by_type.values())
