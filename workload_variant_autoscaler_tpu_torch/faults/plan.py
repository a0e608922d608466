"""Scriptable fault plans: one failure model for every dependency.

A `FaultPlan` is a declarative schedule of dependency misbehavior —
Prometheus timeouts, partial series, NaN samples, clock-skewed scrapes,
kube 409-conflict storms, watch-stream drops, ConfigMap disappearance,
remote-write floods, corrupted stream payloads, controller restarts —
that the injection hooks (faults/inject.py, InMemoryKube.attach_fault_plan,
SimPromAPI(fault_plan=...), the emulator server's WVA_FAULT_PLAN env)
consult at call time. The SAME plan object (or its JSON form) drives unit
tests, the sim-time e2e closed loop, and the real-time emulator server,
so a degradation behavior proven in tests/test_chaos.py is exercised
end-to-end unchanged.

Determinism is a hard requirement (the chaos suite asserts byte-identical
outcomes across reruns): every probabilistic rule draws from its own
`random.Random` seeded from (plan.seed, rule index) — never wall-clock
randomness — and schedule windows advance only via `begin_cycle()` /
`tick()`, both driven by the harness clock.
"""

from __future__ import annotations

import json
import random
import threading
import zlib
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Optional

# dependencies
DEP_PROMETHEUS = "prometheus"
DEP_KUBE = "kube"
DEP_WATCH = "watch"
DEP_NODE_POOL = "node-pool"
DEP_STREAM = "stream"
DEP_CONTROLLER = "controller"

# fault kinds (the fault matrix; see docs/robustness.md)
PROM_TIMEOUT = "prom-timeout"        # query raises TimeoutError
PROM_PARTIAL = "prom-partial"        # matching queries return empty vectors
PROM_NAN = "prom-nan"                # matching queries answer NaN samples
PROM_CLOCK_SKEW = "prom-clock-skew"  # sample timestamps shifted into the past
PROM_LABEL_DROP = "prom-label-drop"  # samples matching `labels` dropped from
                                     # answers (one variant's series vanish
                                     # from a grouped fleet result while the
                                     # rest of the vector stays intact)
PROM_OUTAGE = "prom-outage-window"   # hard correlated outage: EVERY query
                                     # times out for the window, whatever
                                     # its text — one shared window covers
                                     # all backends of a MultiPromAPI, so
                                     # start/stop are correlated across the
                                     # fleet (a real TSDB dies whole)
KUBE_CONFLICT = "kube-conflict"      # matching verbs raise 409 ConflictError
KUBE_ERROR = "kube-error"            # matching verbs raise a transport error
KUBE_NOT_FOUND = "kube-not-found"    # matching verbs raise 404 NotFoundError
WATCH_DROP = "watch-drop"            # watch events silently swallowed
NODE_POOL_DRAIN = "node-pool-drain"  # matching nodes read unschedulable
                                     # (GKE pool maintenance: capacity
                                     # withdraws, the apiserver stays up)
SPOT_RECLAIM = "spot-reclaim"        # matching nodes vanish from LISTs
                                     # (preemptible VM reclamation; the
                                     # per-node draw is stable for the
                                     # whole window — a reclaimed node
                                     # stays gone, it does not flap)
STREAM_FLOOD = "stream-flood"        # remote-write arrival amplification:
                                     # the streaming hooks replay each
                                     # matching push N× per tick with
                                     # seeded per-copy jitter plus
                                     # phantom groups (a flash crowd or
                                     # a misconfigured relabeling storm);
                                     # N via labels {"multiplier": N},
                                     # default 100
STREAM_CORRUPT = "stream-corrupt-payload"  # matching remote-write bodies
                                     # have seeded byte flips applied
                                     # before decode (a proxy shredding
                                     # frames; the door must 400, meter,
                                     # and keep serving)
STREAM_CLOCK_SKEW = "stream-clock-skew"  # streamed sample timestamps
                                     # shifted by skew_s into the future
                                     # (an ingester with a broken clock;
                                     # quarantine must catch it)
CONTROLLER_RESTART = "controller-restart"  # the controller process dies
                                     # and restarts at the window edge:
                                     # the harness rebuilds Reconciler +
                                     # StreamCore from scratch (warm via
                                     # WVA_STREAM_CHECKPOINT if set)

PROM_KINDS = (PROM_TIMEOUT, PROM_PARTIAL, PROM_NAN, PROM_CLOCK_SKEW,
              PROM_LABEL_DROP, PROM_OUTAGE)
KUBE_KINDS = (KUBE_CONFLICT, KUBE_ERROR, KUBE_NOT_FOUND)
NODE_POOL_KINDS = (NODE_POOL_DRAIN, SPOT_RECLAIM)
STREAM_KINDS = (STREAM_FLOOD, STREAM_CORRUPT, STREAM_CLOCK_SKEW)
ALL_KINDS = PROM_KINDS + KUBE_KINDS + NODE_POOL_KINDS \
    + STREAM_KINDS + (WATCH_DROP, CONTROLLER_RESTART)

_KIND_DEPS = {
    **{k: DEP_PROMETHEUS for k in PROM_KINDS},
    **{k: DEP_KUBE for k in KUBE_KINDS},
    **{k: DEP_NODE_POOL for k in NODE_POOL_KINDS},
    **{k: DEP_STREAM for k in STREAM_KINDS},
    WATCH_DROP: DEP_WATCH,
    CONTROLLER_RESTART: DEP_CONTROLLER,
}


@dataclass
class FaultRule:
    """One scheduled fault. Active while BOTH windows admit the current
    position: `[after_cycle, until_cycle)` in reconcile cycles (advanced
    by `FaultPlan.begin_cycle()`) and `[after_s, until_s)` in harness
    seconds (advanced by `FaultPlan.tick()`). An unset bound is
    unbounded, so a purely cycle-scheduled plan ignores time and vice
    versa — unit tests script in cycles, the real-time emulator in
    seconds, same rule type.

    match: substring filter on the call being intercepted — the PromQL
    text for prometheus kinds, "verb:Kind" (e.g. "get:ConfigMap",
    "update_status:VariantAutoscaling") for kube kinds,
    "node-name:pool-label" (e.g. ":tpu-v5-lite-podslice" to take a whole
    generation, "spot-" to take nodes by name prefix) for node-pool
    kinds; "" matches every call of the dependency.
    probability: per-call trip chance, drawn from the rule's own seeded
    rng (1.0 = always).
    skew_s: for prom-clock-skew, how far sample timestamps are shifted
    into the past (a skewed scrape looks stale to the collector).
    labels: for prom-label-drop, the label subset identifying the
    samples to drop (e.g. {"model_name": "llama-8b"}) — the grouped
    fleet queries return one sample per variant, and this models ONE
    variant's series vanishing from the scrape while the rest of the
    grouped vector stays healthy.
    """

    kind: str
    match: str = ""
    after_cycle: int = 0
    until_cycle: Optional[int] = None
    after_s: Optional[float] = None
    until_s: Optional[float] = None
    probability: float = 1.0
    skew_s: float = 0.0
    labels: Optional[dict] = field(default=None)

    def __post_init__(self) -> None:
        if self.kind not in ALL_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {sorted(ALL_KINDS)}")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(f"probability must be in [0,1], got "
                             f"{self.probability}")
        if self.kind in (PROM_CLOCK_SKEW, STREAM_CLOCK_SKEW) \
                and self.skew_s <= 0.0:
            raise ValueError(f"{self.kind} needs skew_s > 0")
        if self.kind == PROM_LABEL_DROP and not self.labels:
            raise ValueError("prom-label-drop needs a non-empty labels map")
        if self.kind == STREAM_FLOOD and self.labels:
            mult = self.labels.get("multiplier", 1)
            if not isinstance(mult, (int, float)) or mult < 1:
                raise ValueError("stream-flood multiplier must be >= 1")

    @property
    def dep(self) -> str:
        return _KIND_DEPS[self.kind]

    def multiplier(self) -> int:
        """stream-flood amplification factor (labels {"multiplier": N},
        default 100 — the seeded flash-crowd scale the bench pins)."""
        if self.labels and "multiplier" in self.labels:
            return max(int(self.labels["multiplier"]), 1)
        return 100

    def in_window(self, cycle: int, now_s: float) -> bool:
        if cycle < self.after_cycle:
            return False
        if self.until_cycle is not None and cycle >= self.until_cycle:
            return False
        if self.after_s is not None and now_s < self.after_s:
            return False
        if self.until_s is not None and now_s >= self.until_s:
            return False
        return True


class FaultPlan:
    """A schedule of FaultRules plus the position (cycle, seconds) the
    windows are evaluated against. Hooks ask `prom_fault(promql)` /
    `kube_fault(verb, kind)` / `watch_dropping()` per call; the harness
    advances position with `begin_cycle()` (once per reconcile) and/or
    `tick(now_s)` (scrape ticks, sim clock, wall clock)."""

    def __init__(self, rules: list[FaultRule] | None = None, seed: int = 0):
        self.rules: list[FaultRule] = list(rules or [])
        self.seed = seed
        self.cycle = 0
        self.now_s = 0.0
        self._t0: Optional[float] = None
        self._rngs = [self._rule_rng(i) for i in range(len(self.rules))]
        # observability for tests/debugging: (cycle, kind, match-text)
        self.trips: list[tuple[int, str, str]] = []
        # lookups may arrive concurrently from WVA_COLLECT_FANOUT worker
        # threads; the lock keeps rng draws and the trips log coherent
        # (draw ORDER under probability<1 rules still follows thread
        # scheduling — for strict rerun determinism use probability 1.0
        # or WVA_COLLECT_FANOUT=1)
        self._lock = threading.Lock()

    def _rule_rng(self, index: int) -> random.Random:
        # one independent deterministic stream per rule: adding a rule
        # never perturbs the draws of the ones before it
        return random.Random((self.seed * 1_000_003 + index) & 0xFFFFFFFF)

    def add(self, rule: FaultRule) -> "FaultPlan":
        # locked: a scenario may add rules while fanned-out hooks are
        # mid-lookup in _active (rules/_rngs iterate under the lock)
        with self._lock:
            self.rules.append(rule)
            self._rngs.append(self._rule_rng(len(self.rules) - 1))
        return self

    # -- position ---------------------------------------------------------

    def begin_cycle(self) -> int:
        """Advance to the next reconcile cycle; returns the new index.
        The first reconcile after construction runs as cycle 1, so
        `after_cycle=1` means 'from the first cycle on' and
        `after_cycle=2` 'healthy first cycle, then faults'."""
        with self._lock:
            self.cycle += 1
            return self.cycle

    def tick(self, now_s: float) -> None:
        """Advance the time axis. The clock is rebased to the FIRST tick
        (so `after_s: 60` always means one minute into the run, whether
        the harness feeds sim seconds from ~0 or unix time); stale ticks
        are ignored (monotone)."""
        with self._lock:
            if self._t0 is None:
                self._t0 = now_s
            rel = now_s - self._t0
            if rel > self.now_s:
                self.now_s = rel

    # -- lookups (called by the injection hooks) --------------------------

    def _active(self, kind_filter: tuple[str, ...], text: str):
        with self._lock:
            for i, rule in enumerate(self.rules):
                if rule.kind not in kind_filter:
                    continue
                if not rule.in_window(self.cycle, self.now_s):
                    continue
                if rule.match and rule.match not in text:
                    continue
                if rule.probability < 1.0 and \
                        self._rngs[i].random() >= rule.probability:
                    continue
                self.trips.append((self.cycle, rule.kind, text[:120]))
                return rule
        return None

    def prom_fault(self, promql: str) -> Optional[FaultRule]:
        """First active prometheus rule matching this query, or None."""
        return self._active(PROM_KINDS, promql)

    def kube_fault(self, verb: str, kind: str) -> Optional[FaultRule]:
        """First active kube rule matching this verb:Kind, or None."""
        return self._active(KUBE_KINDS, f"{verb}:{kind}")

    def watch_dropping(self) -> bool:
        """True while a watch-drop window is active (events swallowed)."""
        return self._active((WATCH_DROP,), "") is not None

    def stream_fault(self, kind: str, text: str = "") -> Optional[FaultRule]:
        """First active streaming-ingest rule of `kind` matching `text`
        ("model:namespace" for flood/skew, "" for corrupt-payload which
        intercepts whole request bodies), or None."""
        return self._active((kind,), text)

    def controller_restart(self) -> Optional[FaultRule]:
        """First active controller-restart rule, or None. The harness
        restarts the controller ONCE per rule window (tracking which
        windows already fired is the harness's job — a dead process
        cannot consult a plan)."""
        return self._active((CONTROLLER_RESTART,), "")

    def node_fault(self, node_name: str, pool: str) -> Optional[FaultRule]:
        """First active node-pool rule (drain/reclaim) covering this node,
        or None. Matched against "node-name:pool-label". Unlike the other
        lookups, probability is evaluated per (rule, node) from a STABLE
        seeded hash rather than the rule's rng stream: node LISTs repeat
        every cycle, and a spot node reclaimed by the draw must stay
        reclaimed for the whole window instead of flapping back per LIST.
        Drain rules ignore probability (maintenance takes the whole
        pool)."""
        text = f"{node_name}:{pool}"
        with self._lock:
            for i, rule in enumerate(self.rules):
                if rule.kind not in NODE_POOL_KINDS:
                    continue
                if not rule.in_window(self.cycle, self.now_s):
                    continue
                if rule.match and rule.match not in text:
                    continue
                if rule.kind == SPOT_RECLAIM and rule.probability < 1.0:
                    draw = random.Random(
                        (self.seed * 1_000_003 + i)
                        ^ zlib.crc32(node_name.encode())).random()
                    if draw >= rule.probability:
                        continue
                self.trips.append((self.cycle, rule.kind, text[:120]))
                return rule
        return None

    # -- adversarial reparameterization (emulator/adversary.py) -----------

    def jitter_windows(self, seed: int, max_shift_s: float,
                       max_scale: float = 0.0) -> "FaultPlan":
        """Seeded in-place jitter of every rule's seconds window (shift
        the start by up to ±max_shift_s, stretch the duration by up to
        ±max_scale), so the adversarial search can slide fault windows
        without rebuilding plans by hand. Runs under the plan lock:
        fanned-out hooks may be mid-lookup in `_active`, and the rng
        streams are rebuilt so each rule index keeps its own draw
        sequence (same discipline as `add`)."""
        with self._lock:
            self.rules = jittered_windows(
                self.rules, seed, max_shift_s, max_scale)
            self._rngs = [self._rule_rng(i) for i in range(len(self.rules))]
        return self

    # -- scripting (JSON form: the emulator server's WVA_FAULT_PLAN) ------

    @classmethod
    def from_dict(cls, obj: dict) -> "FaultPlan":
        if not isinstance(obj, dict):
            raise ValueError("fault plan must be a JSON object")
        rules = []
        for i, r in enumerate(obj.get("rules") or []):
            if not isinstance(r, dict):
                raise ValueError(f"rules[{i}] must be an object")
            unknown = set(r) - {
                "kind", "match", "after_cycle", "until_cycle",
                "after_s", "until_s", "probability", "skew_s", "labels",
            }
            if unknown:
                raise ValueError(f"rules[{i}]: unknown keys {sorted(unknown)}")
            rules.append(FaultRule(**r))
        return cls(rules, seed=int(obj.get("seed") or 0))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "rules": [
                {k: v for k, v in vars(r).items() if v not in (None, "", 0.0)
                 or k in ("kind",)}
                for r in self.rules
            ],
        }


# -- window reparameterization helpers (the adversarial search's mutation
#    primitives; pure functions over rules so they compose with frozen
#    Scenario fault tuples as well as live plans) -------------------------

def reparameterized(rule: FaultRule, **overrides) -> FaultRule:
    """A copy of `rule` with the given fields replaced. Validation
    re-runs (`__post_init__`), so a mutated rule can never leave the
    fault matrix — an out-of-range probability or an unknown kind fails
    here, not deep inside a twin run."""
    return _dc_replace(rule, **overrides)


def jittered_windows(rules: list[FaultRule] | tuple,
                     seed: int, max_shift_s: float,
                     max_scale: float = 0.0) -> list[FaultRule]:
    """Deterministically jitter the seconds windows of `rules`: each
    rule's start shifts by uniform(-max_shift_s, +max_shift_s) and its
    duration stretches by a factor in [1-max_scale, 1+max_scale], drawn
    from a PER-RULE rng keyed by (seed, index) — the same stream
    discipline as `FaultPlan._rule_rng`, so jittering rule i never
    perturbs rule j. Rules without a seconds window pass through
    untouched; jittered windows are clamped to start >= 0 and to a
    minimum 1 s duration so a mutation cannot silently erase a fault."""
    out: list[FaultRule] = []
    for i, rule in enumerate(rules):
        if rule.after_s is None and rule.until_s is None:
            out.append(rule)
            continue
        rng = random.Random((seed * 1_000_003 + i) & 0xFFFFFFFF)
        shift = rng.uniform(-max_shift_s, max_shift_s)
        scale = 1.0 + (rng.uniform(-max_scale, max_scale)
                       if max_scale > 0.0 else 0.0)
        start = rule.after_s if rule.after_s is not None else 0.0
        new_start = max(round(start + shift, 3), 0.0)
        after_s = new_start if rule.after_s is not None else None
        until_s = rule.until_s
        if until_s is not None:
            duration = max((until_s - start) * scale, 1.0)
            until_s = round(new_start + duration, 3)
        out.append(_dc_replace(rule, after_s=after_s, until_s=until_s))
    return out
