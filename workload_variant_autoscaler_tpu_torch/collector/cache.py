"""Last-known-good metric cache with explicit staleness tiers.

When Prometheus stops answering (outage, partial scrape, NaN storm), the
reconciler faces a choice the reference never makes explicit: size on
nothing (skip — and freeze the fleet), or size on the last load it
trusted. This cache makes the middle rung of the degradation ladder
(docs/robustness.md: healthy -> stale-cache -> limited -> hold) explicit:

- FRESH   (age <= stale_after_s): normal operation; the cache is only a
  write-through record.
- STALE   (age <= expire_after_s): usable for sizing under a dependency
  failure — demand rarely cliff-drops within minutes, and holding the
  last-known size beats tearing down a loaded fleet — but actuation is
  guarded (no scale-to-zero, bounded step) and drift is not judged on it.
- EXPIRED (older): evidence too old to act on; the variant HOLDS its
  published allocation until metrics return.

Ages are measured on the reconciler's injected clock, so sim-time chaos
scenarios exercise tier transitions deterministically.
"""

from __future__ import annotations

from dataclasses import dataclass

from .collector import CollectedLoad

TIER_FRESH = "fresh"
TIER_STALE = "stale"
TIER_EXPIRED = "expired"

# Defaults: one staleness limit of grace (the scrape gate's 5 min), then
# a hard stop at 15 min — long enough to ride out a Prometheus restart,
# short enough that a real demand collapse can't hold capacity for hours.
DEFAULT_STALE_AFTER_S = 300.0
DEFAULT_EXPIRE_AFTER_S = 900.0


@dataclass(frozen=True)
class CachedLoad:
    load: CollectedLoad
    at: float  # clock reading when the load was last trusted


class LoadCache:
    """Per-variant last-known-good CollectedLoad, keyed by the
    reconciler's full_name key."""

    def __init__(self, stale_after_s: float = DEFAULT_STALE_AFTER_S,
                 expire_after_s: float = DEFAULT_EXPIRE_AFTER_S):
        if expire_after_s < stale_after_s:
            raise ValueError("expire_after_s must be >= stale_after_s")
        self.stale_after_s = stale_after_s
        self.expire_after_s = expire_after_s
        self._entries: dict[str, CachedLoad] = {}

    def put(self, key: str, load: CollectedLoad, now: float) -> None:
        self._entries[key] = CachedLoad(load=load, at=now)

    def tier(self, key: str, now: float) -> str:
        """Staleness tier of the entry (EXPIRED when absent)."""
        entry = self._entries.get(key)
        if entry is None:
            return TIER_EXPIRED
        age = now - entry.at
        if age <= self.stale_after_s:
            return TIER_FRESH
        if age <= self.expire_after_s:
            return TIER_STALE
        return TIER_EXPIRED

    def get(self, key: str, now: float) -> tuple[CollectedLoad | None, str]:
        """(load, tier); load is None when EXPIRED — expired evidence
        must never be handed out for sizing."""
        tier = self.tier(key, now)
        if tier == TIER_EXPIRED:
            return None, TIER_EXPIRED
        return self._entries[key].load, tier

    def drop(self, key: str) -> None:
        self._entries.pop(key, None)

    def prune(self, live_keys: set[str]) -> None:
        """Drop entries for variants that left the fleet (bounds memory
        under namespace churn, same discipline as the recommendation
        history)."""
        for key in [k for k in self._entries if k not in live_keys]:
            del self._entries[key]
