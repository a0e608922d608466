"""Production-shaped scenario library for the fleet goodput twin.

Each `Scenario` is a complete, seeded description of a fleet under
stress: per-variant load schedules (the `RateSchedule` shape the
loadgen already speaks), a deterministic fault timeline (faults.FaultPlan
rules — including the node-pool kinds that withdraw capacity), and a
chip-generation fleet matrix spanning v5e/v5p/v6e with distinct cost
curves (models/chips.py is the price source, spot pricing included).
`emulator.twin.run_scenario` drives the REAL reconciler through a
scenario end-to-end in sim time and scores the run with the goodput
metric from "ML Fleet Efficiency with ML Productivity Goodput"
(PAPERS.md, arxiv 2502.06982): SLO-attained demand-seconds served per
chip-cost-second provisioned, decomposed into badput buckets.

The library below is the committed benchmark surface
(BENCH_goodput_r08.json via `make bench-goodput`): six production
shapes, each with a stated goodput floor that tests/test_perf_claims.py
asserts — a future PR that regresses fleet efficiency fails the gate,
not just a cycle-wall bench. docs/robustness.md carries the scenario
catalog (shape, fault timeline, expected degradation path).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ...faults.plan import (
    CONTROLLER_RESTART,
    NODE_POOL_DRAIN,
    PROM_OUTAGE,
    SPOT_RECLAIM,
    STREAM_FLOOD,
    FaultRule,
)
from ...models.chips import CHIP_CATALOG

# GKE accelerator-label value per generation (the inverse of the
# collector's TPU_ACCELERATOR_GENERATIONS map, for building Node fixtures)
GKE_POOL_LABELS = {
    "v5e": "tpu-v5-lite-podslice",
    "v5p": "tpu-v5p-slice",
    "v6e": "tpu-v6e-slice",
}


@dataclass(frozen=True)
class ChipLane:
    """One slice shape of the fleet matrix: emulator physics (the same
    fitted linear decode/prefill models the analyzer uses — profile ==
    physics, so the controller's model is truthful) plus the price the
    goodput meter charges per replica-hour."""

    slice_name: str       # "v5e-1"
    generation: str       # "v5e"
    chips: int
    alpha: float          # decode msec/token intercept
    beta: float           # decode msec/token per batch slot
    gamma: float          # prefill msec intercept
    delta: float          # prefill msec per (in_token x batch)
    max_batch: int
    cost_per_hour: float       # on-demand, $/hr per slice (whole replica)
    spot_cost_per_hour: float  # interruptible price for the same slice


def _lane(slice_name: str, generation: str, chips: int, alpha: float,
          beta: float, gamma: float, delta: float,
          max_batch: int) -> ChipLane:
    spec = CHIP_CATALOG[generation]
    return ChipLane(
        slice_name=slice_name, generation=generation, chips=chips,
        alpha=alpha, beta=beta, gamma=gamma, delta=delta,
        max_batch=max_batch,
        cost_per_hour=spec.cost_per_chip * chips,
        spot_cost_per_hour=spec.spot_cost_per_chip * chips,
    )


# The chip-generation fleet matrix. Physics per slice shape follow the
# fixture fits used across the test suite (tests/helpers.py PROFILES /
# BASELINE.md): newer generations decode faster per chip and batch
# deeper, and cost more per hour — the cost/performance skew the
# hetero-cost-skew scenario measures.
CHIP_MATRIX: dict[str, ChipLane] = {
    lane.slice_name: lane
    for lane in (
        _lane("v5e-1", "v5e", 1, 6.973, 0.027, 5.2, 0.1, 64),
        _lane("v5e-4", "v5e", 4, 3.2, 0.012, 2.4, 0.04, 192),
        _lane("v5p-4", "v5p", 4, 2.1, 0.008, 1.5, 0.025, 256),
        _lane("v6e-1", "v6e", 1, 4.2, 0.016, 3.1, 0.06, 96),
    )
}


@dataclass(frozen=True)
class VariantSpec:
    """One serving variant: which lane of the fleet matrix it runs on,
    its seeded load schedule, and its SLO targets. `spot=True` prices the
    variant's replicas at the lane's interruptible rate (the capacity a
    spot-reclaim wave takes back)."""

    name: str
    model: str
    chip: str                                   # CHIP_MATRIX key
    schedule: tuple[tuple[float, float], ...]   # (duration_s, rpm)
    namespace: str = "default"
    avg_in_tokens: int = 128
    avg_out_tokens: int = 32
    slo_itl_ms: float = 24.0
    slo_ttft_ms: float = 500.0
    spot: bool = False

    @property
    def cost_per_hour(self) -> float:
        lane = CHIP_MATRIX[self.chip]
        return lane.spot_cost_per_hour if self.spot else lane.cost_per_hour


@dataclass(frozen=True)
class NodePool:
    """A named TPU node pool for limited-mode scenarios: `count` nodes of
    `chips_per_node` google.com/tpu chips each, labelled with the
    generation's GKE accelerator label. Node names are
    `{prefix}-{index}`, the identity the node-pool fault kinds match
    on."""

    prefix: str
    generation: str
    count: int
    chips_per_node: int = 1


@dataclass(frozen=True)
class Scenario:
    """One trace-driven twin run: fleet + load + fault timeline + the
    committed goodput floor the run must clear."""

    name: str
    description: str
    expected_path: str          # degradation path the run should walk
    duration_s: float
    seed: int
    variants: tuple[VariantSpec, ...]
    faults: tuple[FaultRule, ...] = ()
    node_pools: tuple[NodePool, ...] = ()
    limited_mode: bool = False
    reconcile_interval_s: float = 30.0
    tick_s: float = 5.0
    # pod-startup latency the twin models on scale-UP actuations
    # (scheduling + weight load); scale-down applies immediately
    actuation_delay_s: float = 20.0
    operator: dict[str, str] = field(default_factory=dict)
    # committed floor on the run's useful-cost fraction; asserted by
    # test_perf_claims against BENCH_goodput_r08.json
    goodput_floor: float = 0.0
    # drive the run through the streaming core (stream/core.py): every
    # tick pushes the scraped loads through the ingest door and calls
    # process_once(), so signature flips trigger scoped micro-cycles in
    # sim time while the reconcile_interval_s cadence becomes the
    # backstop. False = the polled per-tick loop (the library default)
    streaming: bool = False


def abbreviated(scenario: Scenario, duration_s: float) -> Scenario:
    """The scenario clipped to a shorter horizon (tier-1 smoke runs the
    first `duration_s` of a library scenario in seconds of wall clock)."""
    return replace(scenario, duration_s=min(duration_s,
                                            scenario.duration_s))


_STEP = {"WVA_MAX_REPLICA_STEP": "3"}

SCENARIOS: dict[str, Scenario] = {
    s.name: s
    for s in (
        Scenario(
            name="diurnal-wave",
            description=(
                "Two regions (namespaces) ride phase-shifted diurnal "
                "waves on different chip generations: us peaks while eu "
                "troughs, so fleet cost should track the moving demand"),
            expected_path="healthy throughout; badput is pure "
                          "tracking error (actuation lag on the ramps, "
                          "over-provision on the descents)",
            duration_s=720.0,
            seed=101,
            variants=(
                VariantSpec(
                    name="chat-us", model="llama-8b-us",
                    namespace="region-us", chip="v5e-1",
                    schedule=((120, 900), (120, 2400), (120, 3600),
                              (120, 2400), (120, 900), (120, 450)),
                ),
                VariantSpec(
                    name="chat-eu", model="llama-8b-eu",
                    namespace="region-eu", chip="v6e-1",
                    schedule=((120, 3600), (120, 2400), (120, 900),
                              (120, 900), (120, 2400), (120, 3600)),
                ),
            ),
            operator=dict(_STEP),
            goodput_floor=0.85,
        ),
        Scenario(
            name="flash-crowd",
            description=(
                "A viral moment: steady 10 req/s jumps 8x to 80 req/s "
                "in one step, holds, then decays — the scale-up race "
                "the reconcile cadence and pod startup must win"),
            expected_path="healthy throughout; actuation-lagged badput "
                          "through the step, over-provision on the decay",
            duration_s=600.0,
            seed=102,
            variants=(
                VariantSpec(
                    name="chat-flash", model="llama-8b-flash",
                    chip="v5e-1",
                    schedule=((180, 600), (180, 4800), (240, 900)),
                ),
            ),
            operator=dict(_STEP),
            goodput_floor=0.45,
        ),
        Scenario(
            name="pool-drain",
            description=(
                "GKE maintenance drains 7 of 8 v5e nodes mid-run "
                "(node-pool-drain): limited-mode capacity shrinks from "
                "8 chips to 1 — below what demand needs — and recovers "
                "when the window closes. Shrinking inventory, never a "
                "kube error storm"),
            expected_path="healthy -> capacity-bound under-provision "
                          "while drained (rung stays healthy: metrics "
                          "are fine, chips are not) -> recovery",
            duration_s=720.0,
            seed=103,
            variants=(
                VariantSpec(
                    name="chat-drain", model="llama-8b-drain",
                    chip="v5e-1",
                    schedule=((720, 5400),),
                ),
            ),
            faults=(
                FaultRule(kind=NODE_POOL_DRAIN, match="v5e-maint",
                          after_s=300.0, until_s=420.0),
            ),
            node_pools=(
                NodePool(prefix="v5e-keep", generation="v5e", count=1),
                NodePool(prefix="v5e-maint", generation="v5e", count=7),
            ),
            limited_mode=True,
            operator=dict(_STEP),
            goodput_floor=0.35,
        ),
        Scenario(
            name="spot-reclaim-wave",
            description=(
                "Serving on cheap interruptible capacity: a reclamation "
                "wave (spot-reclaim, p=0.75 per node, stable draws) "
                "takes back the spot v5e pool for two minutes, leaving "
                "one on-demand chip; the spot discount must out-earn "
                "the reclamation badput"),
            expected_path="healthy -> capacity-bound under-provision "
                          "during the wave (reclaimed nodes stay gone, "
                          "no flapping) -> recovery",
            duration_s=720.0,
            seed=104,
            variants=(
                VariantSpec(
                    name="chat-spot", model="llama-8b-spot",
                    chip="v5e-1", spot=True,
                    schedule=((720, 5400),),
                ),
            ),
            faults=(
                FaultRule(kind=SPOT_RECLAIM, match="v5e-spot",
                          probability=0.75, after_s=300.0, until_s=420.0),
            ),
            node_pools=(
                NodePool(prefix="v5e-od", generation="v5e", count=1),
                NodePool(prefix="v5e-spot", generation="v5e", count=7),
            ),
            limited_mode=True,
            operator=dict(_STEP),
            goodput_floor=0.35,
        ),
        Scenario(
            name="prom-outage-spike",
            description=(
                "The worst-correlated failure: Prometheus dies exactly "
                "as demand ramps 30 -> 70 req/s (prom-outage-window "
                "over every query of every backend). The degradation "
                "ladder must ride the last-known-good cache — never "
                "scale to zero — and re-size the moment metrics return"),
            expected_path="healthy -> stale-cache for the whole window "
                          "(sized on the cache, allocation guarded) -> "
                          "healthy re-size after recovery",
            duration_s=720.0,
            seed=105,
            variants=(
                VariantSpec(
                    name="chat-outage", model="llama-8b-outage",
                    chip="v5e-1",
                    schedule=((240, 1800), (150, 4200), (330, 1800)),
                ),
            ),
            faults=(
                FaultRule(kind=PROM_OUTAGE, after_s=230.0, until_s=430.0),
            ),
            operator=dict(_STEP),
            goodput_floor=0.45,
        ),
        Scenario(
            name="hetero-cost-skew",
            description=(
                "The same 40 req/s workload served from three chip "
                "generations (v5e-1 / v5p-4 / v6e-1) with their real "
                "cost curves: per-variant goodput quantifies how much "
                "demand each dollar of each generation buys"),
            expected_path="healthy throughout; the per-variant goodput "
                          "spread IS the result (cost skew, no faults)",
            duration_s=600.0,
            seed=106,
            variants=(
                VariantSpec(
                    name="chat-v5e", model="llama-8b-e",
                    chip="v5e-1", schedule=((600, 2400),),
                ),
                VariantSpec(
                    name="chat-v5p", model="llama-8b-p",
                    chip="v5p-4", schedule=((600, 2400),),
                ),
                VariantSpec(
                    name="chat-v6e", model="llama-8b-v6",
                    chip="v6e-1", schedule=((600, 2400),),
                ),
            ),
            operator=dict(_STEP),
            goodput_floor=0.9,
        ),
    )
}

# Streaming-core twin scenarios, registered SEPARATELY from the goodput
# library: bench_goodput's committed artifact covers exactly SCENARIOS,
# while these exercise the event-driven reconcile path
# (tests/test_stream.py runs flash-crowd-streaming against its polled
# twin and asserts reaction latency + goodput are no worse).
STREAMING_SCENARIOS: dict[str, Scenario] = {
    s.name: s
    for s in (
        replace(
            SCENARIOS["flash-crowd"],
            name="flash-crowd-streaming",
            description=(
                "The flash-crowd 8x step served by the STREAMING core: "
                "every tick pushes the scraped load through the ingest "
                "door, the signature quantizer detects the step, and a "
                "scoped micro-cycle re-sizes within one tick instead of "
                "waiting out the reconcile interval"),
            expected_path="healthy throughout; the scale-up race is won "
                          "by ingest latency + pod startup, not by the "
                          "polling cadence",
            streaming=True,
            # zero debounce: in sim time an event fires on the tick it
            # arrives, making the run deterministic tick-for-tick
            operator={**_STEP, "WVA_STREAM_DEBOUNCE_MS": "0"},
        ),
        replace(
            SCENARIOS["flash-crowd"],
            name="flash-crowd-flood",
            description=(
                "The flash-crowd step arrives as a remote-write FLOOD: "
                "from t=180s every group's push is replayed 100x per "
                "tick with jitter plus phantom relabeling-storm groups. "
                "The store/queue caps must bound memory, the shed "
                "counter must account every refusal, and the coalesced "
                "backstop pass must still converge the decisions the "
                "admitted evidence implies"),
            expected_path="healthy -> stream-degraded while the flood "
                          "sheds (decisions still track the admitted "
                          "evidence) -> healthy once the storm passes",
            seed=107,
            streaming=True,
            faults=(
                FaultRule(kind=STREAM_FLOOD,
                          labels={"multiplier": 100},
                          after_s=180.0, until_s=300.0),
            ),
            operator={**_STEP, "WVA_STREAM_DEBOUNCE_MS": "0",
                      # small caps so the seeded flood actually hits the
                      # shedding wall inside the run's horizon
                      "WVA_STREAM_MAX_GROUPS": "64",
                      "WVA_STREAM_MAX_QUEUE": "32"},
            goodput_floor=0.45,
        ),
        replace(
            SCENARIOS["flash-crowd"],
            name="restart-under-load",
            description=(
                "The controller process dies at t=240s — mid flash "
                "crowd, right after the 8x step — and restarts warm "
                "from its stream checkpoint: the rebuilt core resumes "
                "event-grained decisions without a cold re-learn and "
                "without ever publishing a scale-to-zero flap"),
            expected_path="healthy -> restart (warm checkpoint restore, "
                          "one backstop pass) -> healthy; goodput loss "
                          "is bounded actuation lag, never a zero flap",
            seed=108,
            streaming=True,
            faults=(
                FaultRule(kind=CONTROLLER_RESTART,
                          after_s=240.0, until_s=250.0),
            ),
            operator={**_STEP, "WVA_STREAM_DEBOUNCE_MS": "0"},
            goodput_floor=0.45,
        ),
    )
}

__all__ = [
    "ADVERSARIAL_SCENARIOS",
    "CHIP_MATRIX",
    "ChipLane",
    "GKE_POOL_LABELS",
    "NodePool",
    "SCENARIOS",
    "STREAMING_SCENARIOS",
    "Scenario",
    "VariantSpec",
    "abbreviated",
]

# imported LAST: adversarial.py reads the classes above back off this
# (by then sufficiently-initialized) package. The archive-backed
# adversarial registry lives in its own module so the searchable space
# stays separate from the hand-written libraries.
from .adversarial import ADVERSARIAL_SCENARIOS  # noqa: E402
