"""StreamState: the reconcile engine's long-lived state, made explicit.

Before the streaming core existed, everything the Reconciler carried
across (or within) cycles lived as a bag of private attributes rebuilt
ad hoc: the cycle counter, the per-cycle decision scratchpads, the
degradation tracker, the scale-down stabilization history, the probe
targets, the last-seen operator ConfigMap. A tick-scoped loop can
afford that; a streaming core that runs SCOPED micro-cycles (a handful
of variants re-solved the moment their load signature flips) cannot:
state that a full cycle wholesale-replaces must be MERGED by a scoped
cycle, or every micro-cycle would erase the rest of the fleet from the
exported series.

This module gives that state a name. In the reference package
`StreamState` is owned by the streaming core (`stream/core.py`) and
shared with the Reconciler; the port has the Reconciler's side so far
(the streaming core is a later slice), and `reconcile(scope=...)` runs
its scoped micro-cycles over the same object. Single-threaded by
design: only the reconcile/consumer thread ever touches a StreamState.

`FleetSnapshot` is the piece that makes scoped cycles fast: the last
full pass's parsed ConfigMaps, interval, and working VariantAutoscaling
objects (post-publish copies), so a micro-cycle pays zero ConfigMap
reads and zero fleet-wide LISTs — O(scope) kube traffic only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..ops.arena import CandidateArena


@dataclass
class FleetSnapshot:
    """The last FULL reconcile pass's config + fleet view, reused by
    scoped micro-cycles. `vas` holds the cycle's WORKING CR objects,
    which `_apply` publishes from (status and resourceVersion as
    written), so a later scoped cycle reads the published state it must
    stabilize against. Refreshed by every full pass; invalidated
    semantics are time-based (the backstop cadence bounds its age)."""

    operator_cm: dict
    accelerator_cm: dict            # parsed form (translate.parse_...)
    service_class_cm: dict
    interval_s: float
    vas: dict = field(default_factory=dict)   # full_name -> working VA
    taken_at: float = 0.0
    # limited-mode capacity view frozen by the last full pass: chip ->
    # free count, plus each variant's pool-connected component
    # (full_name -> frozenset of full_names, solver/greedy.
    # pool_components). A scoped LIMITED micro-cycle re-solves a whole
    # component against this frozen view instead of paying a fleet-wide
    # node LIST — exact because components' chip pools are disjoint
    capacity: dict = field(default_factory=dict)
    pool_components: dict = field(default_factory=dict)


class StreamState:
    """All reconcile-engine state that outlives a single stage call,
    cycle-scoped and cross-cycle alike. One instance per Reconciler;
    the streaming core shares (and owns the lifecycle of) the same
    object. Touched only from the reconcile/consumer thread."""

    def __init__(self) -> None:
        # -- cross-cycle bookkeeping (moved off Reconciler attributes) --
        self.cycle_index: int = 0
        self.recommendations: dict[str, list[tuple[float, int]]] = {}
        self.drift_strikes: dict[str, int] = {}
        self.tpu_util_misses: dict[str, tuple[int, int]] = {}
        self.probe_targets: dict[str, tuple[str, float]] = {}
        self.last_operator_cm: dict[str, str] = {}
        self.shared_ns_warned: tuple[str, ...] = ()
        self.last_capacity: dict[str, int] = {}
        # full_name -> (floor, rpm_at_boost, boost_cycle, solver_prev):
        # the standing TTFT-backpressure floor
        # (reconciler._ttft_backpressure) — the minimum published count
        # held while the demand that provoked an observed-latency
        # violation persists; solver_prev is the pre-floor published
        # count the stabilization/step guards baseline on, so a released
        # floor snaps back to the solver's answer in one cycle
        self.backpressure: dict[str, tuple[int, float, int, int]] = {}
        # -- cycle-scoped state, rebuilt at each reconcile() entry ------
        self.cycle_builders: dict = {}
        self.deadline = None                  # utils.Deadline
        self.degradation = None               # DegradationTracker
        self.cycle_condition_vas: dict = {}
        # -- streaming-core inputs for the CURRENT cycle ----------------
        # scope: None = full fleet (the legacy shape); a frozenset of
        # full_name keys = a scoped micro-cycle over just those variants
        self.scope: Optional[frozenset] = None
        # full_name -> CollectedLoad pushed by the ingest layer; consumed
        # by _prepare in place of a Prometheus round-trip (mode "stream")
        self.stream_loads: Optional[dict] = None
        # set by the streaming core when the cycle it is about to run
        # serves a pressured backlog (overload shed, blown lag budget,
        # coalesced limited-mode escalation): the reconciler marks such
        # cycles with the stream-degraded ladder rung; cleared by the
        # core right after the cycle
        self.stream_pressure: Optional[str] = None
        # set by the streaming core around a LIMITED scoped micro-cycle:
        # the scope is closed under the snapshot's pool components, so
        # the reconciler may solve limited against the snapshot's frozen
        # capacity instead of escalating to a full pass
        self.scope_pool_closed: bool = False
        # (model, namespace) -> the CollectedLoad THIS cycle actually
        # sized on, recorded by _prepare; after a full pass the core
        # folds these into its ingest store as the consumed signatures,
        # so a scrape sweep (or push) matching what was just solved
        # reads as "unchanged" instead of triggering a redundant solve
        self.cycle_loads: dict = {}
        self.snapshot: Optional[FleetSnapshot] = None
        # resident packing arena for scoped micro-cycles (the full-cycle
        # path keeps its own inside IncrementalSolveEngine): the
        # per-event sub-batch packs through resident buffers
        self.stream_arena = CandidateArena()
        # -- merged export state (wholesale-replaced series) ------------
        # full cycles replace these dicts; scoped cycles merge their
        # variants in, and the emitter always publishes the merged view
        self.power: dict = {}                 # (name, ns, acc) -> watts
        self.conditions: dict = {}            # (name, ns, type) -> status
        self.drift: dict = {}                 # (name, ns, metric) -> ratio
        self.rungs: dict = {}                 # (name, ns) -> rung int

    def merge_by_variant(self, target: dict, fresh: dict,
                         variants: set) -> list:
        """Replace `variants`' entries in `target` with their entries in
        `fresh` (a variant's whole label set is replaced, so a switched
        accelerator or a removed condition does not leave a stale
        sibling sample behind). Keys are tuples whose first two elements
        are (variant_name, namespace). Returns the keys RETIRED by the
        merge (present before, absent after) — what an incremental
        emitter must remove from the wire."""
        removed = []
        for key in [k for k in target if (k[0], k[1]) in variants]:
            del target[key]
            if key not in fresh:
                removed.append(key)
        for key, value in fresh.items():
            if (key[0], key[1]) in variants:
                target[key] = value
        return removed
