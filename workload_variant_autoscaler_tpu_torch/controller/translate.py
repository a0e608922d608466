"""ConfigMap/CR -> engine SystemSpec translation.

Equivalent of the Go reference's internal/utils/utils.go:108-383 (CreateSystemData,
AddModelAcceleratorProfileToSystemData, AddServerInfoToSystemData,
FindModelSLO, CreateOptimizedAlloc), TPU-shaped: accelerator ConfigMap
entries describe slice shapes ({"chip": "v5e", "chips": "8", "cost": ...})
and capacity is counted in chips per generation.
"""

from __future__ import annotations

import json
import math
import os
import re
import time

import torch
import yaml

from ..models import (
    AcceleratorSpec,
    ContextBucket,
    AllocationData,
    ModelSliceProfile,
    ModelTarget,
    OptimizerSpec,
    PowerSpec,
    ServerLoadSpec,
    ServerSpec,
    ServiceClassSpec,
    SystemSpec,
)
from ..models.chips import CHIP_CATALOG
from ..models.spec import AllocationSolution, resolve_for_context
from ..ops.arena import LANE_BUCKET
from ..ops.fused import BACKENDS as DEVICE_BACKENDS
from ..utils import full_name, get_logger, knob, kv, parse_float_or
from . import crd

log = get_logger("wva.translate")

SCALE_TO_ZERO_ENV = "WVA_SCALE_TO_ZERO"


def parse_duration(s: str) -> float:
    """Go-style duration ('60s', '2m30s', '1h') -> seconds."""
    s = s.strip()
    if not s:
        raise ValueError("empty duration")
    units = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 0.001}
    total = 0.0
    matched = False
    for value, unit in re.findall(r"(\d+(?:\.\d+)?)(ms|h|m|s)", s):
        total += float(value) * units[unit]
        matched = True
    if not matched:
        raise ValueError(f"invalid duration {s!r}")
    return total


def _chips_from_name(name: str) -> int:
    m = re.search(r"-(\d+)$", name)
    return int(m.group(1)) if m else 1


# content-keyed memo for the service-class YAML: the ConfigMap rarely
# changes, yet every cycle re-reads it — and the streaming core's scoped
# micro-cycles (the streaming core) run many cycles per interval, where
# re-parsing a many-row document each time would dominate the reaction
# budget.
# Consumers below only READ the parsed doc (they build spec objects and
# drop the dict), so sharing the cached object is safe. Bounded: the
# admin CM has a handful of keys; 128 distinct raw strings is churn
# headroom, not a workload.
_YAML_MEMO: dict[str, object] = {}
_YAML_MEMO_MAX = 128


def _safe_load_cached(raw: str):
    """yaml.safe_load memoized by content. The returned object is shared
    across calls — callers must treat it as read-only."""
    if raw in _YAML_MEMO:
        return _YAML_MEMO[raw]
    doc = yaml.safe_load(raw)
    if len(_YAML_MEMO) >= _YAML_MEMO_MAX:
        _YAML_MEMO.clear()
    _YAML_MEMO[raw] = doc
    return doc


def parse_accelerator_configmap(data: dict[str, str]) -> dict[str, dict[str, str]]:
    """accelerator-unit-costs ConfigMap: each entry is a JSON object
    (reference variantautoscaling_controller.go:499-514). Accepts both the
    TPU form {"chip": "v5e", "chips": "8", "cost": "160"} and the
    reference's {"device": ..., "cost": ...}."""
    out: dict[str, dict[str, str]] = {}
    for name, raw in data.items():
        info = json.loads(raw)
        if not isinstance(info, dict):
            raise ValueError(f"accelerator entry {name} must be a JSON object")
        out[name] = {str(k): str(v) for k, v in info.items()}
    return out


def create_system_data(
    accelerator_cm: dict[str, dict[str, str]],
    service_class_cm: dict[str, str],
    capacity: dict[str, int] | None = None,
    unlimited: bool = True,
    saturation_policy: str = "None",
) -> SystemSpec:
    """Static system data from the two admin ConfigMaps
    (reference internal/utils/utils.go:108-182)."""
    accelerators = []
    for name, info in accelerator_cm.items():
        cost = parse_float_or(info.get("cost"), default=float("nan"))
        if cost != cost:  # NaN -> unparseable
            log.warning("skipping accelerator with bad cost", extra=kv(name=name))
            continue
        chip = info.get("chip") or info.get("device") or name.split("-")[0]
        chips = int(parse_float_or(info.get("chips"), _chips_from_name(name)))
        # known chip generations bring their catalog power curve and HBM
        # (the admin CM only carries name/chips/cost, reference
        # utils.go:499-514; power feeds the inferno_*_power_watts gauges)
        catalog = CHIP_CATALOG.get(chip)
        accelerators.append(
            AcceleratorSpec(
                name=name, chip=chip, chips=max(chips, 1),
                mem_gb=parse_float_or(
                    info.get("memGB"),
                    catalog.hbm_gb * max(chips, 1) if catalog else 0.0,
                ),
                power=catalog.power if catalog else PowerSpec(),
                cost=cost,
            )
        )

    service_classes = []
    for key, raw in service_class_cm.items():
        try:
            doc = _safe_load_cached(raw)
        except yaml.YAMLError as e:
            log.warning("skipping unparseable service class", extra=kv(key=key, error=str(e)))
            continue
        if not isinstance(doc, dict):
            continue
        targets = tuple(
            ModelTarget(
                model=row.get("model", ""),
                slo_itl=float(row.get("slo-tpot", 0) or 0),
                slo_ttft=float(row.get("slo-ttft", 0) or 0),
                slo_ttft_percentile=_valid_percentile(
                    row.get("slo-ttft-percentile", 0), key),
            )
            for row in doc.get("data", []) or []
        )
        service_classes.append(
            ServiceClassSpec(
                name=doc.get("name", key),
                priority=int(doc.get("priority", 100) or 100),
                model_targets=targets,
            )
        )

    return SystemSpec(
        accelerators=accelerators,
        profiles=[],
        service_classes=service_classes,
        servers=[],
        capacity=dict(capacity or {}),
        optimizer=OptimizerSpec(
            unlimited=unlimited, saturation_policy=saturation_policy
        ),
    )


def service_class_key_names(service_class_cm: dict[str, str]) -> dict[str, str]:
    """ConfigMap key -> service-class name, parsed once per cycle (the VA's
    sloClassRef.key refers to a key of this ConfigMap). Unparseable entries
    are omitted."""
    out: dict[str, str] = {}
    for key, raw in service_class_cm.items():
        try:
            doc = _safe_load_cached(raw)
        except yaml.YAMLError:
            continue
        if isinstance(doc, dict):
            out[key] = str(doc.get("name", key))
    return out


def find_model_slo_in_spec(
    spec: SystemSpec, model: str, preferred_class: str = ""
) -> tuple[ModelTarget, str]:
    """Locate the SLO target + class name in already-parsed system data
    (avoids re-parsing the service-class YAML per variant). Raises KeyError
    when absent.

    The reference scans all classes for the model id (utils.go:369-383),
    which is ambiguous when several classes target the same model; here the
    class named by the VA's sloClassRef wins, with the scan as fallback."""
    if preferred_class:
        for svc in spec.service_classes:
            if svc.name != preferred_class:
                continue
            for target in svc.model_targets:
                if target.model == model:
                    return target, svc.name
            log.warning(
                "model missing from referenced service class, scanning all",
                extra=kv(model=model, service_class=preferred_class),
            )
    for svc in spec.service_classes:
        for target in svc.model_targets:
            if target.model == model:
                return target, svc.name
    raise KeyError(f"model {model!r} not found in any service class")


def profile_max_batch(va: crd.VariantAutoscaling, acc_name: str) -> int:
    """Max batch from the variant's profile for a slice shape; 0 when the
    profile is absent (shared by status publication and engine translation
    so the two can't diverge)."""
    for ap in va.spec.model_profile.accelerators:
        if ap.acc == acc_name and ap.max_batch_size > 0:
            return ap.max_batch_size
    return 0


def add_profile_to_system_data(
    spec: SystemSpec, model: str, profile: crd.AcceleratorProfile
) -> None:
    """Parse the CR's string-typed alpha/beta/gamma/delta into a
    ModelSliceProfile (reference utils.go:185-234). Raises ValueError on
    missing/invalid parameters."""
    alpha, beta, gamma, delta = _parse_perf_parms(profile.perf_parms)

    buckets = []
    for cp in profile.context_profiles:
        if cp.at_context <= 0:
            raise ValueError("contextProfiles entries need atContext > 0")
        c_alpha, c_beta, c_gamma, c_delta = _parse_perf_parms(cp.perf_parms)
        buckets.append(ContextBucket(
            context_tokens=cp.at_context,
            alpha=c_alpha, beta=c_beta, gamma=c_gamma, delta=c_delta,
            max_batch_size=cp.max_batch_size,
        ))

    spec.profiles.append(
        ModelSliceProfile(
            model=model,
            accelerator=profile.acc,
            alpha=alpha, beta=beta, gamma=gamma, delta=delta,
            max_batch_size=profile.max_batch_size,
            at_tokens=0,
            slices_per_replica=max(profile.acc_count, 1),
            context_buckets=tuple(buckets),
        )
    )


def _parse_perf_parms(parms: crd.PerfParms) -> tuple[float, float, float, float]:
    decode = parms.decode_parms
    prefill = parms.prefill_parms
    if len(decode) < 2:
        raise ValueError("decodeParms must contain alpha and beta")
    if len(prefill) < 2:
        raise ValueError("prefillParms must contain gamma and delta")
    try:
        return (float(decode["alpha"]), float(decode["beta"]),
                float(prefill["gamma"]), float(prefill["delta"]))
    except (KeyError, ValueError) as e:
        raise ValueError(f"bad perf parameters: {e}") from e


def scale_to_zero_enabled() -> bool:
    return os.environ.get(SCALE_TO_ZERO_ENV, "").lower() == "true"


def _warmup_max_batch(va, ap) -> int:
    """The batch bound the reconcile loop will actually size this
    candidate with. A context-bucketed profile resolves its bound at the
    OBSERVED prompt length — warming the static top-level bound can land
    in a different 256-state K bucket than the first real cycle, which
    then runs a shape the warmup never launched. The CR
    status's last-known token averages are the best available stand-in
    for the live load (perf-only: wrong guesses just warm an unused
    shape)."""
    static = ap.max_batch_size if ap.max_batch_size > 0 else 256
    if not ap.context_profiles:
        return static
    in_tok = parse_float_or(
        va.status.current_alloc.load.avg_input_tokens, -1.0)
    if in_tok < 0:
        return static
    tmp = SystemSpec()
    try:
        add_profile_to_system_data(tmp, va.spec.model_id, ap)
    except ValueError:
        return static
    resolved = resolve_for_context(tmp.profiles[-1], in_tok)
    return resolved.max_batch_size if resolved.max_batch_size > 0 else static


def warmup_plan(
    vas, service_class_cm: dict[str, str] | None = None,
    operator_cm: dict[str, str] | None = None,
    mesh_size: int | None = None,
) -> list[tuple[int, int, float | None]]:
    """The kernel shapes the fleet will actually compile, derived from
    the listed VariantAutoscalings + the service-class/operator config:
    one (candidate-lane bucket, max-batch bound, ttft_percentile|None)
    entry per sizing group.

    Mirrors System.calculate's grouping: candidates are GROUPED by their
    effective TTFT percentile (the class's slo-ttft-percentile, else the
    global WVA_TTFT_PERCENTILE, else mean), each group's candidate axis
    is padded to a multiple of the arena's lane quantum (16), or of
    lcm(16, mesh size) under WVA_MESH_DEVICES, and each group takes ONE
    K from its own maximum max-batch. Profiles without a
    batch bound warm the 256 default instead of guessing; VAs whose
    class can't be resolved warm in the global-percentile group."""
    global_p = ttft_percentile(operator_cm) or 0.0
    spec = create_system_data({}, service_class_cm or {})
    class_by_key = service_class_key_names(service_class_cm or {})
    quantum = (LANE_BUCKET if not mesh_size
               else math.lcm(LANE_BUCKET, mesh_size))

    groups: dict[float, dict] = {}
    for va in vas:
        p = global_p
        try:
            target, _cls = find_model_slo_in_spec(
                spec, va.spec.model_id,
                preferred_class=class_by_key.get(
                    va.spec.slo_class_ref.key, ""),
            )
            p = target.slo_ttft_percentile or global_p
        except (KeyError, ValueError):
            pass
        group = groups.setdefault(p, {"candidates": 0, "max_batch": 0})
        for ap in va.spec.model_profile.accelerators:
            group["candidates"] += 1
            group["max_batch"] = max(
                group["max_batch"], _warmup_max_batch(va, ap))
    if not groups:
        groups = {global_p: {"candidates": 0, "max_batch": 256}}
    return [
        (max(quantum, -(-g["candidates"] // quantum) * quantum),
         g["max_batch"] or 256,
         p or None)
        for p, g in sorted(groups.items())
    ]


def _parse_percentile(raw, source: str) -> float | None:
    """One validation rule for every TTFT-percentile knob: valid (0.5, 1)
    value, or None — a typo must degrade to mean sizing (reference
    behavior), never crash or silently misconfigure."""
    try:
        p = float(raw)
    except (TypeError, ValueError):
        log.warning("bad TTFT percentile, sizing on the mean",
                    extra=kv(source=source, value=raw))
        return None
    if not 0.5 < p < 1.0:
        log.warning("TTFT percentile out of range (0.5, 1); "
                    "sizing on the mean", extra=kv(source=source, value=raw))
        return None
    return p


def _valid_percentile(raw, source: str) -> float:
    """Per-class slo-ttft-percentile from a service-class row; 0 = mean."""
    if not raw:
        return 0.0
    return _parse_percentile(raw, f"service class {source}") or 0.0


def ttft_percentile(operator_cm: dict[str, str] | None = None) -> float | None:
    """WVA_TTFT_PERCENTILE (env over ConfigMap): size the TTFT SLO against
    this percentile of the TTFT distribution instead of its mean
    (ops.batched.size_batch_tail — realizes the reference's dead
    percentile-sizing intent, allocation.go:117 + defaults.go:12-15).
    Unset/empty = mean sizing (reference parity); valid range (0.5, 1).
    Unlike utils.knob, an env value of blanks falls through to the
    ConfigMap here, as in the reference."""
    raw = knob("WVA_TTFT_PERCENTILE", operator_cm).strip() \
        or (operator_cm or {}).get("WVA_TTFT_PERCENTILE", "").strip()
    if not raw:
        return None
    return _parse_percentile(raw, "WVA_TTFT_PERCENTILE")


def engine_backend(device) -> str:
    """Analysis backend for the reconcile cycle, by the reference
    package's table with the System's device standing in for its "host
    is CPU-only": "kernel" (the CUDA bisection kernels) is the device's
    backend on `cuda`, "batched" (the PyTorch trip loop) on `cpu`.

    WVA_NATIVE_KERNEL=true  -> "native", the C++ host library
      (ops/native.py), on either device; with a warning and the device's
      backend when it cannot be built;
    WVA_NATIVE_KERNEL=false -> the device's backend, unconditionally;
    unset (the default)     -> "native" on `cpu` when the library
      builds (on the host it beats the trip loop), else the device's
      backend; "kernel" on `cuda`."""
    from ..ops import native

    dev = torch.device(device)
    own = "kernel" if dev.type == "cuda" else "batched"
    raw = os.environ.get("WVA_NATIVE_KERNEL", "").strip().lower()
    if raw in ("1", "true"):
        if native.available():
            return "native"
        log.warning("WVA_NATIVE_KERNEL set but kernel unavailable; "
                    "falling back to the device's backend",
                    extra=kv(backend=own))
        return own
    if raw in ("0", "false"):
        return own
    if dev.type == "cpu" and native.available():
        return "native"
    return own


def engine_mesh(backend: str, device=None):
    """Optional candidate-axis device mesh from WVA_MESH_DEVICES ("all" or
    a device count): splits each sizing group over the local devices of
    `device`'s type (parallel.candidate_mesh; the cards on `cuda`, the
    default, the one host on `cpu`). None (the default) keeps the
    single-device path. Only meaningful for a device backend ("kernel"
    or "batched"); ignored, with a warning, otherwise."""
    raw = os.environ.get("WVA_MESH_DEVICES", "").strip()
    if not raw:
        return None
    if backend not in DEVICE_BACKENDS:
        log.warning("WVA_MESH_DEVICES ignored: mesh sharding requires a "
                    "device backend (kernel or batched)",
                    extra=kv(backend=backend))
        return None
    from ..parallel import candidate_mesh

    if raw.lower() == "all":
        return candidate_mesh(device=device)
    try:
        n = int(raw)
    except ValueError:
        log.warning("bad WVA_MESH_DEVICES, ignoring", extra=kv(value=raw))
        return None
    if n <= 0:
        log.warning("bad WVA_MESH_DEVICES, ignoring", extra=kv(value=raw))
        return None
    return candidate_mesh(n, device=device)


def sharded_fleet_mesh(backend: str, device=None):
    """Optional variant/lane-axis device mesh for whole-fleet solves.

    WVA_SHARDED_FLEET: "auto" (default: shard when more than one local
    device exists), "on" (shard; still degenerates to the unsharded
    program on a one-device host, such as one H100), or "off".
    WVA_FLEET_MESH_DEVICES ("all" default, or a device count) bounds the
    mesh size. Only meaningful for a device backend ("kernel" or
    "batched"); ignored, with a warning, otherwise."""
    raw = os.environ.get("WVA_SHARDED_FLEET", "auto").strip().lower()
    if raw in ("", "off", "0", "false", "no"):
        return None
    if raw not in ("on", "1", "true", "yes", "auto"):
        log.warning("bad WVA_SHARDED_FLEET, ignoring", extra=kv(value=raw))
        return None
    if backend not in DEVICE_BACKENDS:
        if raw != "auto":
            log.warning("WVA_SHARDED_FLEET ignored: fleet sharding "
                        "requires a device backend (kernel or batched)",
                        extra=kv(backend=backend))
        return None
    from ..parallel import fleet_mesh

    size = os.environ.get("WVA_FLEET_MESH_DEVICES", "all").strip().lower()
    n = None
    if size and size != "all":
        try:
            n = int(size)
        except ValueError:
            n = 0
        if n <= 0:
            log.warning("bad WVA_FLEET_MESH_DEVICES, ignoring",
                        extra=kv(value=size))
            n = None
    # fleet_mesh returns None below two devices: "auto" and "on" both
    # degenerate to the unsharded program on a one-device host
    return fleet_mesh(n, device=device)


def add_server_info_to_system_data(
    spec: SystemSpec, va: crd.VariantAutoscaling, class_name: str,
    demand_headroom: float = 0.0,
) -> None:
    """CR status -> ServerSpec (reference utils.go:237-311): pinned to its
    current slice shape, min replicas 1 unless scale-to-zero is enabled,
    NaN-scrubbed load.

    demand_headroom (WVA_DEMAND_HEADROOM) inflates the arrival rate the
    ENGINE sizes for by a relative factor — overprovisioning that absorbs
    ramp steps between reconcile cycles (the TTFT-tail knob). Applied
    here only: the CR status keeps the truthful observed load."""
    cur = va.status.current_alloc
    load = ServerLoadSpec(
        arrival_rate=parse_float_or(cur.load.arrival_rate)
        * (1.0 + max(demand_headroom, 0.0)),
        avg_in_tokens=int(parse_float_or(cur.load.avg_input_tokens)),
        avg_out_tokens=int(parse_float_or(cur.load.avg_output_tokens)),
    )
    alloc = AllocationData(
        accelerator=cur.accelerator,
        num_replicas=cur.num_replicas,
        max_batch=cur.max_batch,
        cost=parse_float_or(cur.variant_cost),
        itl_average=parse_float_or(cur.itl_average),
        ttft_average=parse_float_or(cur.ttft_average),
        load=load,
    )

    acc_name = va.metadata.labels.get(crd.ACCELERATOR_LABEL, "")
    max_batch = profile_max_batch(va, acc_name)

    spec.servers.append(
        ServerSpec(
            name=full_name(va.name, va.namespace),
            service_class=class_name,
            model=va.spec.model_id,
            keep_accelerator=True,
            min_num_replicas=0 if scale_to_zero_enabled() else 1,
            max_batch_size=max_batch,
            current_alloc=alloc,
        )
    )


def create_optimized_alloc(
    name: str, namespace: str, solution: AllocationSolution, now: float | None = None
) -> crd.OptimizedAlloc:
    """Solver output -> CR desired allocation (reference utils.go:314-331).
    Raises KeyError when the server is absent from the solution."""
    key = full_name(name, namespace)
    if key not in solution.allocations:
        raise KeyError(f"server {key} not found in solution")
    data = solution.allocations[key]
    return crd.OptimizedAlloc(
        last_run_time=time.time() if now is None else now,
        accelerator=data.accelerator,
        num_replicas=data.num_replicas,
    )
