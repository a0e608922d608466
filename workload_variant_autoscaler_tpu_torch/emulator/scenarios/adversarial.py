"""Adversarially-found twin scenarios: the searchable parameter space
and the committed archive of worst-found attacks.

`emulator/adversary.py` searches this space — a typed, bounded grid over
one canonical single-variant template (ramp slope/magnitude/phase, fault
window timing and duration, node-drain width, spot-reclaim probability,
stream-flood intensity, debounce cadence, stream clock skew, controller
restart timing) — for parameter points that MINIMIZE the run's
cost-weighted goodput through the real Reconciler. Every generation's
worst find that undercuts the hand-written library's minimum is
serialized to `tests/fixtures/adversarial_scenarios.json` (versioned,
committed) and loaded back here as `ADVERSARIAL_SCENARIOS` — a registry
SEPARATE from `SCENARIOS`/`STREAMING_SCENARIOS`, exactly like the
streaming library, so BENCH_goodput semantics never move — with
per-scenario goodput floors that tests/test_adversary.py enforces as
tier-1 regressions. The floor-promotion policy and the search space
itself are documented in docs/robustness.md ("Adversarial scenario
search").

Everything here is pure data plumbing: quantization keeps archived
params on a coarse grid (byte-stable JSON, meaningful dedup), and
`scenario_from_params` is a total function from a grid point to a
`Scenario` — the same point always rebuilds the same frozen scenario,
which is what makes an archived attack a reproducible regression test.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path

from ...faults.plan import (
    CONTROLLER_RESTART,
    NODE_POOL_DRAIN,
    PROM_OUTAGE,
    SPOT_RECLAIM,
    STREAM_CLOCK_SKEW,
    STREAM_FLOOD,
    FaultRule,
)
from . import NodePool, Scenario, VariantSpec, _STEP

# canonical template the whole space perturbs: one chat variant on the
# cheapest lane, the library's cadence (30 s cycles, 5 s ticks, 20 s pod
# startup), seven minutes of sim time — long enough for a ramp, a fault
# window, and a recovery to all fit
DURATION_S = 420.0
TEMPLATE_CHIP = "v5e-1"
TEMPLATE_POOL_NODES = 8     # 1 always-on + 7 attackable (drain/reclaim)


@dataclass(frozen=True)
class ParamSpec:
    """One searchable axis: closed bounds plus the grid quantum every
    value snaps to (archives stay byte-stable and two mutations that
    land within a quantum are the SAME point — no phantom diversity)."""

    name: str
    lo: float
    hi: float
    quantum: float


# The typed, bounded space. Axes whose zero means "off" (outage_dur_s,
# drain_nodes, reclaim_p, flood_mult, skew_s, restart_at_s) make the
# fault families optional, so the search chooses WHICH failures to
# combine, not just when. Bounds keep every point physically meaningful:
# peak demand stays within what an unbounded fleet can serve, so a low
# goodput is always a CONTROLLER failure, never "demand was impossible".
PARAM_SPACE: tuple[ParamSpec, ...] = (
    ParamSpec("base_rpm", 600.0, 2400.0, 60.0),     # pre-ramp demand
    ParamSpec("ramp_mult", 1.0, 8.0, 0.5),          # ramp magnitude
    ParamSpec("ramp_at_s", 60.0, 240.0, 30.0),      # ramp phase
    ParamSpec("ramp_hold_s", 60.0, 180.0, 30.0),    # plateau length
    ParamSpec("decay_mult", 0.1, 1.0, 0.1),         # post-plateau level
    ParamSpec("outage_at_s", 60.0, 300.0, 30.0),    # prom-outage window
    ParamSpec("outage_dur_s", 0.0, 180.0, 30.0),    # 0 = no outage
    ParamSpec("drain_nodes", 0.0, 7.0, 1.0),        # 0 = no drain
    ParamSpec("fault_at_s", 60.0, 300.0, 30.0),     # pool/stream window
    ParamSpec("fault_dur_s", 60.0, 180.0, 30.0),
    ParamSpec("reclaim_p", 0.0, 1.0, 0.25),         # 0 = no spot reclaim
    ParamSpec("flood_mult", 0.0, 100.0, 25.0),      # 0 = polled loop
    ParamSpec("debounce_ms", 0.0, 250.0, 50.0),     # stream debounce
    ParamSpec("skew_s", 0.0, 120.0, 30.0),          # 0 = no clock skew
    ParamSpec("restart_at_s", 0.0, 360.0, 60.0),    # 0 = no restart
)

PARAM_NAMES = tuple(s.name for s in PARAM_SPACE)


def quantize(spec: ParamSpec, value: float) -> float:
    """`value` snapped to the spec's grid and clamped into bounds."""
    snapped = spec.lo + round((value - spec.lo) / spec.quantum) * spec.quantum
    return round(min(max(snapped, spec.lo), spec.hi), 6)


def quantized_params(params: dict) -> dict[str, float]:
    """The full parameter point on the grid; unknown keys are an error
    (a typo'd axis must fail loudly, not silently search nothing)."""
    unknown = set(params) - set(PARAM_NAMES)
    if unknown:
        raise ValueError(f"unknown adversary params {sorted(unknown)}; "
                         f"known: {list(PARAM_NAMES)}")
    missing = set(PARAM_NAMES) - set(params)
    if missing:
        raise ValueError(f"missing adversary params {sorted(missing)}")
    return {s.name: quantize(s, float(params[s.name]))
            for s in PARAM_SPACE}


def scenario_from_params(params: dict, *, name: str, seed: int,
                         duration_s: float = DURATION_S,
                         goodput_floor: float = 0.0,
                         operator_extra: dict[str, str] | None = None,
                         ) -> Scenario:
    """The grid point as a runnable twin Scenario. Streaming mode engages
    exactly when a stream-side axis is live (flood or skew), node pools
    plus limited mode exactly when a capacity axis is live (drain or
    reclaim) — otherwise the template stays on the cheap polled,
    unlimited path the goodput library uses."""
    p = quantized_params(params)
    base = p["base_rpm"]
    ramp_at = p["ramp_at_s"]
    hold = p["ramp_hold_s"]
    tail = max(duration_s - ramp_at - hold, 30.0)
    schedule = (
        (ramp_at, base),
        (hold, round(base * p["ramp_mult"], 6)),
        (tail, round(base * p["decay_mult"], 6)),
    )

    faults: list[FaultRule] = []
    if p["outage_dur_s"] > 0.0:
        faults.append(FaultRule(
            kind=PROM_OUTAGE, after_s=p["outage_at_s"],
            until_s=p["outage_at_s"] + p["outage_dur_s"]))
    fault_at, fault_until = p["fault_at_s"], \
        p["fault_at_s"] + p["fault_dur_s"]
    drained = int(p["drain_nodes"])
    if drained > 0:
        faults.append(FaultRule(kind=NODE_POOL_DRAIN, match="adv-drain",
                                after_s=fault_at, until_s=fault_until))
    if p["reclaim_p"] > 0.0:
        # the always-on "adv-keep" node is on-demand and immune, like the
        # spot-reclaim-wave library scenario's one od chip
        faults.append(FaultRule(kind=SPOT_RECLAIM, match="adv-flex",
                                probability=p["reclaim_p"],
                                after_s=fault_at, until_s=fault_until))
    streaming = p["flood_mult"] > 0.0 or p["skew_s"] > 0.0
    if p["flood_mult"] > 0.0:
        faults.append(FaultRule(
            kind=STREAM_FLOOD,
            labels={"multiplier": int(p["flood_mult"])},
            after_s=fault_at, until_s=fault_until))
    if p["skew_s"] > 0.0:
        faults.append(FaultRule(kind=STREAM_CLOCK_SKEW, skew_s=p["skew_s"],
                                after_s=fault_at, until_s=fault_until))
    if p["restart_at_s"] > 0.0:
        faults.append(FaultRule(kind=CONTROLLER_RESTART,
                                after_s=p["restart_at_s"],
                                until_s=p["restart_at_s"] + 10.0))

    limited = drained > 0 or p["reclaim_p"] > 0.0
    node_pools: tuple[NodePool, ...] = ()
    if limited:
        flex = TEMPLATE_POOL_NODES - 1 - drained
        pools = [NodePool(prefix="adv-keep", generation="v5e", count=1)]
        if drained:
            pools.append(NodePool(prefix="adv-drain", generation="v5e",
                                  count=drained))
        if flex > 0:
            pools.append(NodePool(prefix="adv-flex", generation="v5e",
                                  count=flex))
        node_pools = tuple(pools)

    operator: dict[str, str] = dict(_STEP)
    if streaming:
        operator["WVA_STREAM_DEBOUNCE_MS"] = str(int(p["debounce_ms"]))
        if p["flood_mult"] > 0.0:
            # the flood must meet the shedding wall inside the horizon,
            # same caps the flash-crowd-flood library scenario pins
            operator["WVA_STREAM_MAX_GROUPS"] = "64"
            operator["WVA_STREAM_MAX_QUEUE"] = "32"
    operator.update(operator_extra or {})

    return Scenario(
        name=name,
        description=("Adversarially-found scenario (emulator/adversary.py "
                     f"grid point): {json.dumps(p, sort_keys=True)}"),
        expected_path=("worst-found attack from the seeded search; the "
                       "committed floor is the hardened controller's "
                       "measured goodput minus margin (docs/robustness.md, "
                       "'Adversarial scenario search')"),
        duration_s=duration_s,
        seed=seed,
        variants=(VariantSpec(
            name="chat-adv", model="llama-8b-adv", chip=TEMPLATE_CHIP,
            schedule=schedule, spot=p["reclaim_p"] > 0.0),),
        faults=tuple(faults),
        node_pools=node_pools,
        limited_mode=limited,
        operator=operator,
        goodput_floor=goodput_floor,
        streaming=streaming,
    )


# -- the committed archive -------------------------------------------------

ARCHIVE_VERSION = 1
_REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_ARCHIVE_PATH = \
    _REPO_ROOT / "tests" / "fixtures" / "adversarial_scenarios.json"


def archive_path() -> Path:
    """WVA_ADVERSARY_ARCHIVE env override, else the committed fixture."""
    override = os.environ.get("WVA_ADVERSARY_ARCHIVE", "")
    return Path(override) if override else DEFAULT_ARCHIVE_PATH


def load_archive(path: Path | None = None) -> dict:
    """The versioned archive document; an absent file loads as the empty
    archive (a fresh clone before the first promotion must still
    import), any OTHER malformation raises — a corrupted committed
    fixture is a broken build, not an empty library."""
    path = path or archive_path()
    if not Path(path).exists():
        return {"version": ARCHIVE_VERSION, "scenarios": []}
    doc = json.loads(Path(path).read_text())
    if doc.get("version") != ARCHIVE_VERSION:
        raise ValueError(
            f"adversarial archive {path} has version "
            f"{doc.get('version')!r}, expected {ARCHIVE_VERSION}")
    return doc


def scenarios_from_archive(doc: dict) -> dict[str, Scenario]:
    """Archive entries rebuilt into runnable scenarios, floors attached.
    Each entry re-runs under the operator overlay it was promoted WITH
    (the hardened controller config), so the floor asserts the fix keeps
    working, not that the bug stays lost."""
    out: dict[str, Scenario] = {}
    for entry in doc.get("scenarios", []):
        out[entry["name"]] = scenario_from_params(
            entry["params"],
            name=entry["name"],
            seed=int(entry["seed"]),
            duration_s=float(entry.get("duration_s", DURATION_S)),
            goodput_floor=float(entry["floor"]),
            operator_extra=dict(entry.get("operator") or {}),
        )
    return out


ADVERSARIAL_SCENARIOS: dict[str, Scenario] = \
    scenarios_from_archive(load_archive())
