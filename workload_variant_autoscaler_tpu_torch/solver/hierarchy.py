"""Hierarchical two-level solve engine and its warm cold-start.

Counterpart of the reference package's `solver/hierarchy.py`. The flat
incremental engine (solver/incremental.py) makes steady-state cycles
O(changed), but its forced-full backstop (`WVA_SOLVE_FULL_EVERY`) is one
pass over the whole fleet, and a restarted controller pays the same
pass cold. This engine removes both walls:

**Two-level solve.** The fleet is partitioned into pool-connected
super-shards. Chip capacity couples servers only through shared chip
generations (the argument `solve_greedy_warm` rests on too), so a
pool-connected component is the largest unit a solve decision can span;
components are never split. Components hash onto
`ceil(fleet / WVA_HIER_SHARD_VARIANTS)` shards, and each shard packs and
sizes on its own, through its own resident arena: `decide_batch` never
sees the whole fleet in one batch. A lane's decision does not depend on
the batch around it (ops/fused.py; checked on the card by chip_smoke.py
phase 2), so per-shard batches decide exactly what one fleet-wide batch
would. In unlimited mode capacity couples nothing and every variant is
its own component.

**Staggered forced-full.** Each shard re-solves from scratch on its own
hash-offset phase of the `WVA_SOLVE_FULL_EVERY` window instead of every
shard on cycle k*full_every: the forced work of one cycle is
O(fleet / full_every), while every lane is still re-solved from scratch
at least once per window. Forcing a lane that did not change cannot
change its decision, so staggering is invisible to decisions.

**Top-level capacity reconciliation.** Shards solve against per-shard
capacity slices; a coarse top-level pass checks that the slices form a
disjoint cover of the capacity their candidates can reach (guaranteed by
the component construction: two shards sharing a generation would have
been one component). If that ever fails, the cycle falls back to the
exact full greedy instead of trusting the decomposition.

**Warm cold-start.** Between cycles the engine checkpoints its solve
state through the CRC-guarded atomic container of stream/checkpoint.py
(own magic/version): per-variant lane-signature digests and cached
candidate allocations, the warm-greedy seed (previous choices, pools,
value signatures), per-shard solve-signature digests, and the shard
arenas' slabs. A restarted controller reloads it, digest-matches fresh
signatures against it, and lands directly in the incremental steady
state: no forced full pass. Any defect (torn file, CRC mismatch, version
skew, stale age, config mismatch) discards the checkpoint and
cold-starts; a checkpoint can make a restart faster, never different.

On a lane mesh (WVA_SHARDED_FLEET, parallel.fleet_mesh) every shard
arena is a `ShardedFleetArena` resident on the mesh; unsharded, a
`CandidateArena`; under a candidate mesh (WVA_MESH_DEVICES) the groups
pack without an arena. A checkpoint records the mesh size as
`arena_mesh` (None unsharded), and a restore pre-stages the arena slabs
only onto a mesh of the same size. `WVA_HIER_SOLVE=off` selects the
flat engine (controller/reconciler.py); `auto` delegates to the flat
code path below `WVA_HIER_MIN_VARIANTS`, so small fleets keep the flat
behavior.

**Spans.** Inside a cycle trace (obs/trace.py) a two-level cycle opens
`hier.signatures` (the lane and value signatures over the fleet) and
one `hier.shard` per solved shard (its `System.calculate(only=...)`,
under which `system.pack` and `system.decide` nest, and the
allocation-cache clones; attributes `shard`, `variants`, `lanes`). The
delegate branch opens neither.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import time
import zlib
from typing import Optional

from ..models import System
from ..models.allocation import Allocation
from ..models.spec import OptimizerSpec
from ..models.system import fused_solve_enabled
from ..obs import trace as obs_trace
from ..ops.arena import CandidateArena, ShardedFleetArena
from ..parallel import is_lane_mesh
from ..stream.checkpoint import (
    ARENA_CHECKPOINT_MAGIC,
    ARENA_CHECKPOINT_VERSION,
    CheckpointError,
    load_checkpoint,
    save_checkpoint,
)
from .incremental import (
    DEFAULT_EPSILON,
    DEFAULT_FULL_EVERY,
    SOLVE_CACHED,
    SOLVE_FULL,
    SOLVE_INCREMENTAL,
    IncrementalSolveEngine,
    SolveStats,
    quantize_load,
)

log = logging.getLogger("wva.solver.hierarchy")

DEFAULT_SHARD_TARGET = 1024   # WVA_HIER_SHARD_VARIANTS
DEFAULT_MIN_VARIANTS = 2048   # WVA_HIER_MIN_VARIANTS (auto floor)
DEFAULT_CHECKPOINT_EVERY = 8  # WVA_ARENA_CHECKPOINT_EVERY (cycles)
DEFAULT_CHECKPOINT_MAX_AGE_S = 3600.0  # WVA_ARENA_CHECKPOINT_MAX_AGE_S

# deterministic hash offset rotating every shard's forced-full phase
# away from cycle 0 while keeping consecutive shard ids on consecutive
# phases (max shards due on any one cycle = ceil(shards / full_every))
_STAGGER_OFFSET = zlib.crc32(b"wva-hier-stagger")

# checkpoint event keys (a controller turns these into
# inferno_arena_checkpoint_total{event=...} increments)
CKPT_EVENTS = ("save", "save_error", "restore", "discard_corrupt",
               "discard_stale", "discard_config")


def _canon(obj):
    """Canonical, address-free encoding of a signature for digesting:
    dataclasses become (class name, field tuples), containers recurse,
    floats use their shortest exact repr. Two signatures digest equal
    iff they compare equal, the property the warm cold-start rests on."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple((f.name, _canon(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)))
    if isinstance(obj, dict):
        return ("dict", tuple(sorted((repr(k), _canon(v))
                                     for k, v in obj.items())))
    if isinstance(obj, (list, tuple)):
        return ("seq", tuple(_canon(x) for x in obj))
    if isinstance(obj, frozenset):
        return ("fset", tuple(sorted(repr(x) for x in obj)))
    if isinstance(obj, float):
        return ("f", repr(obj))
    return obj


def sig_digest(sig) -> str:
    """Stable hex digest of a signature tuple (lane / solve / shard)."""
    return hashlib.sha256(repr(_canon(sig)).encode("utf-8")).hexdigest()


@dataclasses.dataclass
class Partition:
    """One cycle's super-shard layout."""

    n_shards: int
    shard_of: dict            # server name -> shard id
    members: dict             # shard id -> [server names] (fleet order)
    pool_sets: dict           # shard id -> {chip generations}


class HierarchicalSolveEngine(IncrementalSolveEngine):
    """IncrementalSolveEngine with a two-level (super-shard) solve and a
    CRC-guarded warm cold-start checkpoint. Same external contract as the
    flat engine: calculate / warm_start / finish_cycle / note_failure,
    single-threaded under the reconcile loop."""

    def __init__(self, epsilon: Optional[float] = None,
                 full_every: Optional[int] = None,
                 shard_target: int = DEFAULT_SHARD_TARGET,
                 min_variants: int = DEFAULT_MIN_VARIANTS,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = DEFAULT_CHECKPOINT_EVERY,
                 checkpoint_max_age_s: float = DEFAULT_CHECKPOINT_MAX_AGE_S):
        super().__init__(
            DEFAULT_EPSILON if epsilon is None else epsilon,
            DEFAULT_FULL_EVERY if full_every is None else full_every)
        self.shard_target = max(int(shard_target), 1)
        self.min_variants = max(int(min_variants), 0)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self.checkpoint_max_age_s = float(checkpoint_max_age_s)
        # per-shard resident arenas, keyed by shard id; rebuilt when the
        # effective mesh changes (as the flat engine's fleet arena is)
        self._shard_arenas: dict[int, CandidateArena] = {}
        self._shard_arena_mesh = None
        # per-shard solve-signature digests: committed at finish_cycle,
        # pending between calculate() and finish_cycle(). None pending
        # means this cycle ran the flat delegate path.
        self._shard_sig_digests: dict[int, str] = {}
        self._pending_shard_digests: Optional[dict[int, str]] = None
        # warm cold-start state: lane-sig digests from a restored
        # checkpoint (consumed by the first calculate), deferred arena
        # slab snapshots (materialized when shard arenas are built)
        self._restored_digests: dict[str, str] = {}
        self._restored_arena: dict = {}
        self._restored_arena_mesh = None
        self.ckpt_events = dict.fromkeys(CKPT_EVENTS, 0)
        self.last_partition: Optional[Partition] = None
        self.last_capacity_slices: Optional[dict] = None
        # per-cycle candidate-entry memo (see _candidate_entries)
        self._entry_memo = None
        # structured-part digest memo (see _lane_digest): the SLO target
        # and candidate-entries parts of every lane signature are shared
        # by whole model families, so each is digested once per group
        # instead of once per lane
        self._entries_digest_memo: dict[int, tuple] = {}
        # shard-assignment memo for the separable (unlimited) partition
        self._shard_of_memo: dict[str, int] = {}
        self._shard_memo_key = None
        if self.checkpoint_path:
            self._try_restore()

    # -- signature memo ---------------------------------------------------

    def _candidate_entries(self, system: System, server) -> tuple:
        """Per-cycle memo over the flat engine's candidate-entry tuple:
        entries are a pure function of (model, candidate catalog), which
        whole model families share, so a fleet builds one entry tuple per
        family per cycle. Keyed by the live System (rebuilt every cycle),
        so staleness is impossible."""
        memo = self._entry_memo
        if memo is None or memo[0] is not system:
            memo = self._entry_memo = (system, {})
            # new cycle, new entries objects: drop the digest memo too so
            # stale id() keys can never accumulate
            self._entries_digest_memo.clear()
        key = (server.model_name,
               tuple(sorted(server.candidate_accelerators(
                   system.accelerators))))
        entries = memo[1].get(key)
        if entries is None:
            entries = IncrementalSolveEngine._candidate_entries(
                system, server)
            memo[1][key] = entries
        return entries

    def _part_digest(self, part) -> str:
        """Identity-memoized sig_digest of a structured signature part
        (the SLO target, the candidate-entries tuple). The memo holds a
        strong reference next to each id() key, so a hit proves identity,
        never an address reuse."""
        memo = self._entries_digest_memo
        hit = memo.get(id(part))
        if hit is None or hit[0] is not part:
            memo[id(part)] = hit = (part, sig_digest(part))
        return hit[1]

    def _lane_digest(self, sig: tuple) -> str:
        """sig_digest of a lane signature with its two nested parts
        (target, candidate entries) swapped for their own memoized
        digests. Equal signatures digest equal and distinct ones
        distinct (floats use repr, as _canon does); what remains after
        the swap is primitives only, so the digest input is a plain
        repr."""
        flat = (sig[:3] + (self._part_digest(sig[3]),) + sig[4:-1]
                + (self._part_digest(sig[-1]),))
        return hashlib.sha256(repr(flat).encode("utf-8")).hexdigest()

    # -- partitioning -----------------------------------------------------

    def _partition(self, system: System,
                   optimizer_spec: OptimizerSpec) -> Partition:
        """Super-shard layout for this cycle. Components are the units
        capacity can couple (never split); the component key is canonical
        (the least chip generation, or the server name when separable or
        pool-less), so shard assignment is stable across cycles and
        restarts for an unchanged fleet."""
        servers = system.servers
        n_shards = max(1, -(-len(servers) // self.shard_target))

        if optimizer_spec.unlimited:
            # capacity couples nothing: every variant is its own
            # component. Assignment depends only on (name, n_shards),
            # memoized across cycles: churn costs only the new names.
            memo_key = n_shards
            if self._shard_memo_key != memo_key:
                self._shard_of_memo = {}
                self._shard_memo_key = memo_key
            memo = self._shard_of_memo
            shard_of = {}
            members: dict[int, list] = {}
            pool_sets: dict[int, set] = {}
            for name in servers:
                sid = memo.get(name)
                if sid is None:
                    sid = memo[name] = zlib.crc32(
                        name.encode("utf-8")) % n_shards
                shard_of[name] = sid
                members.setdefault(sid, []).append(name)
            if len(memo) > len(shard_of):
                # churn deleted servers: drop their entries so the memo
                # stays bounded by the live fleet, not its history
                self._shard_of_memo = dict(shard_of)
            return Partition(n_shards, shard_of, members, pool_sets)

        # capacity-coupled: union-find over the chip generations of each
        # server's candidate accelerators (a superset of the allocation
        # pools solve_greedy_warm unions over, so components here are
        # never finer than the solver's)
        self._shard_memo_key = None
        parent: dict[str, str] = {}

        def find(x: str) -> str:
            while parent.setdefault(x, x) != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        server_chips: dict[str, list] = {}
        for name, server in servers.items():
            chips = sorted({
                system.accelerators[a].chip
                for a in server.candidate_accelerators(system.accelerators)})
            server_chips[name] = chips
            # seed every chip into the union-find: a generation that only
            # appears as a server's sole candidate (a homogeneous fleet)
            # would otherwise never enter `parent`
            for chip in chips:
                find(chip)
            for chip in chips[1:]:
                ra, rb = find(chips[0]), find(chip)
                if ra != rb:
                    parent[ra] = rb
        comp_min: dict[str, str] = {}
        for chip in parent:
            root = find(chip)
            cur = comp_min.get(root)
            if cur is None or chip < cur:
                comp_min[root] = chip

        shard_of = {}
        members = {}
        pool_sets = {}
        for name in servers:
            chips = server_chips[name]
            if chips:
                key = "p:" + comp_min[find(chips[0])]
            else:
                key = "s:" + name  # pool-less: couples nothing
            sid = zlib.crc32(key.encode("utf-8")) % n_shards
            shard_of[name] = sid
            members.setdefault(sid, []).append(name)
            pool_sets.setdefault(sid, set()).update(chips)
        return Partition(n_shards, shard_of, members, pool_sets)

    def _reconcile_capacity(self, system: System,
                            part: Partition) -> Optional[dict]:
        """Coarse top-level reconciliation: the per-shard capacity slices
        (the generations each shard's candidates can draw on) must form a
        disjoint cover, which makes independent per-shard solving equal
        to the fleet-wide solve. Guaranteed by the component construction;
        returns None if ever violated, so the caller falls back to the
        exact full greedy instead of trusting the decomposition."""
        slices: dict[int, dict] = {}
        owner: dict[str, int] = {}
        for sid, pools in part.pool_sets.items():
            sl = {}
            for gen in pools:
                if gen in owner:
                    log.warning("hier capacity overlap: generation=%s "
                                "shard=%d other=%d", gen, sid, owner[gen])
                    return None
                owner[gen] = sid
                if gen in system.capacity:
                    sl[gen] = system.capacity[gen]
            slices[sid] = sl
        return slices

    @staticmethod
    def _phase(sid: int, full_every: int) -> int:
        return (sid + _STAGGER_OFFSET) % full_every

    # -- arenas -----------------------------------------------------------

    def _shard_arena(self, sid: int, eff_mesh=None,
                     dtype=None) -> Optional[CandidateArena]:
        if eff_mesh is not None and not is_lane_mesh(eff_mesh):
            return None  # explicit candidate mesh: no resident arena
        if self._shard_arena_mesh != eff_mesh:
            self._shard_arenas = {}
            self._shard_arena_mesh = eff_mesh
        arena = self._shard_arenas.get(sid)
        if arena is None:
            arena = (CandidateArena() if eff_mesh is None
                     else ShardedFleetArena(eff_mesh, dtype=dtype))
            self._materialize_arena_snap(arena, sid, eff_mesh)
            self._shard_arenas[sid] = arena
        return arena

    def _materialize_arena_snap(self, arena: CandidateArena, sid: int,
                                eff_mesh) -> None:
        """Restore a checkpointed shard arena's slabs (and, on a lane
        mesh, stage them onto it) when the snapshot was taken on a mesh
        of the same size (None: unsharded). A malformed snapshot skips
        the pre-warm only: the arena starts fresh."""
        snap = self._restored_arena.pop(str(sid), None)
        if not snap:
            return
        want = eff_mesh.size if eff_mesh is not None else None
        if self._restored_arena_mesh != want:
            return
        try:
            arena.restore_slabs(snap)
        except (AttributeError, ValueError, KeyError, TypeError) as e:
            log.warning("arena slab restore skipped: shard=%d error=%s",
                        sid, e)

    # -- the analyze step -------------------------------------------------

    def calculate(self, system: System, *, backend: str, mesh=None,
                  fleet_mesh=None,
                  ttft_percentile: Optional[float] = None,
                  optimizer_spec: Optional[OptimizerSpec] = None,
                  rungs: Optional[dict] = None,
                  cycle_rung: str = "healthy") -> SolveStats:
        optimizer_spec = optimizer_spec or OptimizerSpec()
        restoring = bool(self._restored_digests) and not self._lane_sigs
        if len(system.servers) < self.min_variants and not restoring:
            # below the auto floor the flat engine is the fast path:
            # delegate, so small fleets keep the flat code path. None
            # marks "no hier partition this cycle".
            self._pending_shard_digests = None
            return super().calculate(
                system, backend=backend, mesh=mesh, fleet_mesh=fleet_mesh,
                ttft_percentile=ttft_percentile,
                optimizer_spec=optimizer_spec, rungs=rungs,
                cycle_rung=cycle_rung)
        return self._calculate_hier(
            system, backend=backend, mesh=mesh, fleet_mesh=fleet_mesh,
            ttft_percentile=ttft_percentile, optimizer_spec=optimizer_spec,
            rungs=rungs or {}, cycle_rung=cycle_rung, restoring=restoring)

    def _calculate_hier(self, system: System, *, backend: str, mesh,
                        fleet_mesh, ttft_percentile, optimizer_spec,
                        rungs: dict, cycle_rung: str,
                        restoring: bool) -> SolveStats:
        self._cycle += 1
        eff_mesh = mesh if mesh is not None else fleet_mesh

        for server in system.servers.values():
            server.load = quantize_load(server.load, self.epsilon)

        analyze_sig = (backend,
                       eff_mesh.size if eff_mesh is not None else None,
                       is_lane_mesh(eff_mesh),
                       ttft_percentile,
                       fused_solve_enabled())
        if restoring and self._analyze_sig != analyze_sig:
            # the checkpoint was taken under a different pipeline
            # (backend/mesh/percentile/fused): its cached allocations may
            # not match this one's, so discard rather than mix
            self._discard_restore("discard_config",
                                  "pipeline config changed")
            restoring = False

        part = self._partition(system, optimizer_spec)
        self.last_partition = part
        cap_slices = None
        if not optimizer_spec.unlimited:
            cap_slices = self._reconcile_capacity(system, part)
        self.last_capacity_slices = cap_slices
        decomposed = optimizer_spec.unlimited or cap_slices is not None

        all_forced = False
        reason = ""
        if not self._lane_sigs and not restoring:
            all_forced, reason = True, "first cycle"
        elif self._analyze_sig != analyze_sig:
            all_forced, reason = True, "backend/mesh/percentile changed"
        self._analyze_sig = analyze_sig

        with obs_trace.span("hier.signatures"):
            lane_sigs = {
                name: self._lane_signature(system, server, ttft_percentile,
                                           rungs.get(name, "healthy"))
                for name, server in system.servers.items()
            }
            self._pending_value_sigs = {
                name: self._value_signature(server)
                for name, server in system.servers.items()
            }

        # changed = lane signature drift; on the restore cycle a fresh
        # signature digest-matching the snapshot adopts the tuple and
        # keeps the cached allocations (the warm start)
        changed = set()
        if all_forced:
            changed = set(system.servers)
        else:
            for name in system.servers:
                known = self._lane_sigs.get(name)
                if known is not None:
                    if known != lane_sigs[name] \
                            or name not in self._alloc_cache:
                        changed.add(name)
                elif restoring \
                        and self._restored_digests.get(name) \
                        == self._lane_digest(lane_sigs[name]) \
                        and name in self._alloc_cache:
                    self._lane_sigs[name] = lane_sigs[name]
                else:
                    changed.add(name)
        if restoring:
            self._restored_digests = {}

        # staggered forced-full: each shard re-solves from scratch on its
        # own phase of the WVA_SOLVE_FULL_EVERY window
        if all_forced:
            due = set(part.members)
        elif restoring or not self.full_every:
            # the restore cycle skips phase-due shards: the checkpoint is
            # younger than the stale-age gate, so every restored lane was
            # solved within the last window; the drift guard resumes on
            # the next phase tick
            due = set()
        else:
            tick = (self._cycle - 1) % self.full_every
            due = {sid for sid in part.members
                   if self._phase(sid, self.full_every) == tick}
        forced = {name for sid in due for name in part.members[sid]}
        to_solve = changed | forced

        skipped_lanes = 0
        for name, server in system.servers.items():
            if name in to_solve:
                continue
            skipped_lanes += self._restore(system, server,
                                           self._alloc_cache[name])

        by_shard: dict[int, set] = {}
        for name in to_solve:
            by_shard.setdefault(part.shard_of[name], set()).add(name)
        total_lanes = 0
        unique_lanes = 0
        own_arena = system.arena
        if not by_shard:
            # no lanes to dispatch; still run the (empty) calculate so
            # accelerator derivations happen as on the flat path. It
            # packs nothing, so the System keeps its own arena.
            system.calculate(backend=backend, mesh=eff_mesh,
                             ttft_percentile=ttft_percentile, only=set())
        for sid in sorted(by_shard):
            sel = by_shard[sid]
            with obs_trace.span("hier.shard", shard=sid, variants=len(sel)):
                system.arena = self._shard_arena(sid, eff_mesh, system.dtype)
                system.calculate(backend=backend, mesh=eff_mesh,
                                 ttft_percentile=ttft_percentile, only=sel)
                obs_trace.set_attribute("lanes", system.last_solve_lanes)
                total_lanes += system.last_solve_lanes
                unique_lanes += system.last_unique_lanes
                for name in sel:
                    server = system.servers[name]
                    self._lane_sigs[name] = lane_sigs[name]
                    self._alloc_cache[name] = {
                        acc: alloc.clone()
                        for acc, alloc in server.all_allocations.items()}
        system.last_solve_lanes = total_lanes
        system.last_unique_lanes = unique_lanes
        # the port's System always packs through `system.arena`: hand it
        # back its own, not a shard's (nor None, which the reference
        # package's System reads as "pack without an arena")
        system.arena = own_arena

        self.solve_modes = {
            name: (SOLVE_FULL if name in forced else
                   SOLVE_INCREMENTAL if name in changed else SOLVE_CACHED)
            for name in system.servers
        }

        # warm-greedy gating: the global solve conditions' digest and the
        # per-shard solve-signature digests (members + capacity slice)
        value_changed = {
            name for name in system.servers
            if self._prev_value_sigs.get(name)
            != self._pending_value_sigs[name]
        }
        solve_sig = ("hier", sig_digest((optimizer_spec, cycle_rung)))
        shard_digests: dict[int, str] = {}
        shard_changed: set = set()
        for sid, names in part.members.items():
            cap_part = ()
            if not optimizer_spec.unlimited and cap_slices is not None:
                cap_part = tuple(sorted(cap_slices[sid].items()))
            # membership digests over the raw sorted name join, not
            # sig_digest: _canon would walk every server name through the
            # canonicalizer each cycle. Names are k8s identifiers (no
            # NUL) and cap_part is (chip, count) pairs with exact reprs,
            # so this stays a stable change detector across restarts.
            d = hashlib.sha256(
                ("\x00".join(sorted(names)) + "|" + repr(cap_part))
                .encode("utf-8")).hexdigest()
            shard_digests[sid] = d
            if self._shard_sig_digests.get(sid) != d:
                shard_changed.update(names)
        if not decomposed:
            shard_changed = set(system.servers)

        self._changed_for_solver = frozenset(
            to_solve | value_changed | shard_changed)
        self._warm_ok = (not all_forced and decomposed
                         and self._prev_complete
                         and self._prev_solve_sig == solve_sig)
        self._pending_solve_sig = solve_sig
        self._pending_shard_digests = shard_digests

        stats = SolveStats(
            full=all_forced,
            reason=(reason if all_forced else
                    "" if self._warm_ok or not self._prev_complete
                    else "optimizer/rung changed"),
            lanes_solved=total_lanes,
            lanes_skipped=skipped_lanes,
            modes={m: c for m, c in (
                (SOLVE_FULL, len(forced)),
                (SOLVE_INCREMENTAL, len(changed - forced)),
                (SOLVE_CACHED,
                 len(system.servers) - len(changed | forced))) if c},
            shards=part.n_shards,
            shards_solved=len(by_shard),
            restored=restoring,
        )
        self.last_stats = stats
        if all_forced:
            log.debug("hier full solve: reason=%s lanes=%d shards=%d",
                      reason, total_lanes, part.n_shards)
        elif restoring:
            log.info("warm restart: lanes=%d cached=%d shards=%d",
                     total_lanes, len(system.servers) - len(to_solve),
                     part.n_shards)
        return stats

    # -- cycle commit + checkpoint ----------------------------------------

    def finish_cycle(self, system: System) -> None:
        super().finish_cycle(system)
        if self._pending_shard_digests is None:
            # flat delegate cycle: hier shard state is unknown, so clear
            # it and the next hier cycle re-marks every shard changed
            self._shard_sig_digests = {}
        else:
            self._shard_sig_digests = self._pending_shard_digests
        self._pending_shard_digests = None
        self.maybe_checkpoint()

    def drain_ckpt_events(self) -> dict:
        """Checkpoint event counts accumulated since the last drain."""
        out = {k: v for k, v in self.ckpt_events.items() if v}
        self.ckpt_events = dict.fromkeys(CKPT_EVENTS, 0)
        return out

    def maybe_checkpoint(self) -> None:
        """Persist the warm cold-start snapshot every
        `checkpoint_every`-th completed cycle. A save failure is counted
        in `ckpt_events["save_error"]` and logged, never raised:
        checkpointing speeds a restart up, decisions never depend on it."""
        if not self.checkpoint_path:
            return
        if self._cycle % self.checkpoint_every != 0:
            return
        try:
            save_checkpoint(self.checkpoint_path,
                            self._checkpoint_payload(),
                            magic=ARENA_CHECKPOINT_MAGIC,
                            version=ARENA_CHECKPOINT_VERSION)
            self.ckpt_events["save"] += 1
        except (OSError, ValueError, TypeError) as e:
            self.ckpt_events["save_error"] += 1
            log.warning("arena checkpoint save failed: %s", e)

    def _checkpoint_payload(self) -> dict:
        lanes = {}
        for name, sig in self._lane_sigs.items():
            allocs = self._alloc_cache.get(name)
            if allocs is None:
                continue
            vs = self._prev_value_sigs.get(name)
            lanes[name] = {
                "sig": self._lane_digest(sig),
                "allocs": {acc: dict(a.__dict__)
                           for acc, a in allocs.items()},
                "value_sig": list(vs) if vs is not None else None,
            }
        arena_snaps = {str(sid): arena.snapshot_slabs()
                       for sid, arena in self._shard_arenas.items()
                       if arena is not None}
        mesh = self._shard_arena_mesh
        return {
            "taken_at": time.time(),
            "cycle": self._cycle,
            "config": {
                "epsilon": self.epsilon,
                "full_every": self.full_every,
                "shard_target": self.shard_target,
            },
            "analyze_sig": (list(self._analyze_sig)
                            if self._analyze_sig is not None else None),
            "solve_sig": (list(self._prev_solve_sig)
                          if isinstance(self._prev_solve_sig, tuple)
                          and len(self._prev_solve_sig) == 2
                          and self._prev_solve_sig[0] == "hier" else None),
            "shard_digests": {str(k): v for k, v
                              in self._shard_sig_digests.items()},
            "lanes": lanes,
            "choice": {name: dict(a.__dict__)
                       for name, a in self._prev_choice.items()},
            "pools": {name: list(chips)
                      for name, chips in self._prev_pools.items()},
            "complete": bool(self._prev_complete),
            "arena": arena_snaps,
            "arena_mesh": mesh.size if mesh is not None else None,
        }

    def _discard_restore(self, event: str, why: str) -> None:
        self.ckpt_events[event] += 1
        self._restored_digests = {}
        self._restored_arena = {}
        self._alloc_cache = {}
        self._lane_sigs = {}
        self._prev_choice = {}
        self._prev_pools = {}
        self._prev_value_sigs = {}
        self._prev_solve_sig = None
        self._prev_complete = False
        self._shard_sig_digests = {}
        self._analyze_sig = None
        log.warning("arena checkpoint discarded: %s", why)

    def _try_restore(self) -> None:
        """Load the warm cold-start snapshot, verifying magic / version /
        CRC / age / engine config. Every defect discards the whole
        checkpoint (a cold start): there is no partial restore."""
        if not os.path.exists(self.checkpoint_path):
            return
        try:
            payload = load_checkpoint(self.checkpoint_path,
                                      magic=ARENA_CHECKPOINT_MAGIC,
                                      version=ARENA_CHECKPOINT_VERSION)
        except CheckpointError as e:
            self.ckpt_events["discard_corrupt"] += 1
            log.warning("arena checkpoint discarded: %s", e)
            return
        try:
            age = time.time() - float(payload["taken_at"])
            if self.checkpoint_max_age_s > 0 \
                    and age > self.checkpoint_max_age_s:
                self.ckpt_events["discard_stale"] += 1
                log.warning("arena checkpoint discarded: stale (%.0fs old)",
                            age)
                return
            cfg = payload["config"]
            if (cfg.get("epsilon") != self.epsilon
                    or cfg.get("full_every") != self.full_every
                    or cfg.get("shard_target") != self.shard_target):
                self.ckpt_events["discard_config"] += 1
                log.warning("arena checkpoint discarded: engine config "
                            "changed")
                return
            # parse everything into locals first: a malformed field can
            # never leave the engine half-restored
            cycle = int(payload["cycle"])
            digests = {str(n): str(rec["sig"])
                       for n, rec in payload["lanes"].items()}
            alloc_cache = {
                n: {acc: Allocation(**d)
                    for acc, d in rec["allocs"].items()}
                for n, rec in payload["lanes"].items()}
            value_sigs = {
                n: (tuple(rec["value_sig"])
                    if rec.get("value_sig") is not None else None)
                for n, rec in payload["lanes"].items()}
            choice = {n: Allocation(**d)
                      for n, d in payload["choice"].items()}
            pools = {n: tuple(chips)
                     for n, chips in payload["pools"].items()}
            shard_digests = {int(k): str(v) for k, v
                             in payload["shard_digests"].items()}
            analyze_sig = (tuple(payload["analyze_sig"])
                           if payload["analyze_sig"] is not None else None)
            solve_sig = (tuple(payload["solve_sig"])
                         if payload.get("solve_sig") is not None else None)
            complete = bool(payload["complete"])
            arena = dict(payload.get("arena") or {})
            arena_mesh = payload.get("arena_mesh")
        except (AttributeError, KeyError, TypeError, ValueError) as e:
            # AttributeError covers a JSON-valid body whose fields hold
            # the wrong shapes (a string where a mapping belongs)
            self.ckpt_events["discard_corrupt"] += 1
            log.warning("arena checkpoint discarded: malformed payload: %s",
                        e)
            return
        self._cycle = cycle
        self._restored_digests = digests
        self._alloc_cache = alloc_cache
        self._prev_value_sigs = value_sigs
        self._prev_choice = choice
        self._prev_pools = pools
        self._prev_solve_sig = solve_sig
        self._prev_complete = complete
        self._shard_sig_digests = shard_digests
        self._analyze_sig = analyze_sig
        self._restored_arena = arena
        self._restored_arena_mesh = arena_mesh
        self.ckpt_events["restore"] += 1
        log.info("arena checkpoint restored: lanes=%d cycle=%d path=%s",
                 len(digests), cycle, self.checkpoint_path)
