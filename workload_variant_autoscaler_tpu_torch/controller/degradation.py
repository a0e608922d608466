"""The degradation ladder: every cycle ends on a documented rung.

The reconcile pipeline's graceful-degradation contract
(docs/robustness.md): when a dependency misbehaves, the controller slides
DOWN the ladder one explicit, observable rung at a time instead of
failing in an undefined way, and climbs back up the moment evidence
returns. Rungs, per variant:

- HEALTHY     fresh metrics, normal sizing.
- STREAM_DEGRADED the streaming ingest path is under pressure (queue
  saturation, lag budget blown, shedding, or a quarantined source):
  decisions still ride fresh evidence — the escalation valve coalesces
  the backlog into one backstop full pass — but event-grained reaction
  latency is not being honored, so the cycle is marked.
- STALE_CACHE sized on the last-known-good load (collector/cache.py
  tiers) under a live dependency failure; actuation guarded (no
  scale-to-zero, bounded step), drift not judged.
- LIMITED     operating with reduced capability: the optimizer failed or
  capacity inventory was unavailable — published state is conditions
  only, no new allocation.
- HOLD        no usable evidence (expired cache, config unreadable,
  circuit open with nothing cached): the published allocation is frozen
  until metrics return. A held variant NEVER actuates — in particular it
  can never scale to zero.

The whole-cycle rung is the worst per-variant rung (a config-read
failure, which aborts before variants exist, is a cycle-level HOLD).
Exported as inferno_degradation_state{variant_name,namespace} and
inferno_cycle_degradation_state so alerts can key on "fleet is degraded"
without parsing logs.
"""

from __future__ import annotations

from enum import IntEnum

from ..collector import TIER_FRESH, TIER_STALE


class DegradationState(IntEnum):
    HEALTHY = 0
    STREAM_DEGRADED = 1
    STALE_CACHE = 2
    LIMITED = 3
    HOLD = 4

    @property
    def label(self) -> str:
        return _LABELS[self]


_LABELS = {
    DegradationState.HEALTHY: "healthy",
    DegradationState.STREAM_DEGRADED: "stream-degraded",
    DegradationState.STALE_CACHE: "stale-cache",
    DegradationState.LIMITED: "limited",
    DegradationState.HOLD: "hold",
}


def state_for_cache_tier(tier: str) -> DegradationState:
    """Ladder rung implied by the staleness tier a variant was sized on.
    FRESH cache under a dependency failure is still degraded operation —
    the evidence is good, the dependency is not — so it lands on
    STALE_CACHE like the stale tier; only a live scrape is HEALTHY."""
    if tier in (TIER_FRESH, TIER_STALE):
        return DegradationState.STALE_CACHE
    return DegradationState.HOLD


class DegradationTracker:
    """Per-cycle rung bookkeeping: variants report their rung as the
    cycle runs; the tracker folds them into the cycle rung and the
    wholesale-replaced per-variant gauge samples."""

    def __init__(self) -> None:
        self.per_variant: dict[tuple[str, str], DegradationState] = {}
        self._cycle_floor = DegradationState.HEALTHY

    def record(self, name: str, namespace: str,
               state: DegradationState) -> None:
        key = (name, namespace)
        prev = self.per_variant.get(key, DegradationState.HEALTHY)
        self.per_variant[key] = max(prev, state)

    def record_cycle(self, state: DegradationState) -> None:
        """A cycle-level event (config unreadable, optimizer down) that
        is not attributable to one variant."""
        self._cycle_floor = max(self._cycle_floor, state)

    def cycle_state(self) -> DegradationState:
        worst = self._cycle_floor
        for state in self.per_variant.values():
            worst = max(worst, state)
        return worst

    def gauge_samples(self) -> dict[tuple[str, str], int]:
        return {key: int(state) for key, state in self.per_variant.items()}
