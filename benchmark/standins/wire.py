"""A VariantAutoscaling as the API server holds it on the wire: a frozen
copy of the port's `controller/crd.py va_to_dict` (with `to_rfc3339` and
`Condition.to_dict`), which the stand-in's admission validates against
the CRD's structural schema. It reads the program's objects by their
fields and calls nothing of the program, so a change to the program's
own conversion cannot move the stand-in's cost."""

from __future__ import annotations

from datetime import datetime, timezone

API_VERSION = "llmd.ai/v1alpha1"
KIND = "VariantAutoscaling"


def to_rfc3339(ts: float) -> str:
    return datetime.fromtimestamp(ts, tz=timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")


def _perf_parms(pp) -> dict:
    return {"decodeParms": dict(pp.decode_parms),
            "prefillParms": dict(pp.prefill_parms)}


def _accelerator(ap) -> dict:
    out = {"acc": ap.acc, "accCount": ap.acc_count,
           "perfParms": _perf_parms(ap.perf_parms),
           "maxBatchSize": ap.max_batch_size}
    if ap.context_profiles:
        out["contextProfiles"] = [
            {"atContext": cp.at_context, "perfParms": _perf_parms(cp.perf_parms),
             "maxBatchSize": cp.max_batch_size}
            for cp in ap.context_profiles]
    return out


def _condition(c) -> dict:
    return {"type": c.type, "status": c.status, "reason": c.reason,
            "message": c.message, "observedGeneration": c.observed_generation,
            "lastTransitionTime": to_rfc3339(c.last_transition_time)}


def va_to_dict(va) -> dict:
    md = va.metadata
    metadata = {"name": md.name, "namespace": md.namespace,
                "labels": dict(md.labels), "generation": md.generation,
                "ownerReferences": list(md.owner_references)}
    if md.resource_version:
        metadata["resourceVersion"] = md.resource_version
    cur = va.status.current_alloc
    want = va.status.desired_optimized_alloc
    return {
        "apiVersion": API_VERSION,
        "kind": KIND,
        "metadata": metadata,
        "spec": {
            "modelID": va.spec.model_id,
            "sloClassRef": {"name": va.spec.slo_class_ref.name,
                            "key": va.spec.slo_class_ref.key},
            "modelProfile": {"accelerators": [
                _accelerator(ap) for ap in va.spec.model_profile.accelerators]},
        },
        "status": {
            "currentAlloc": {
                "accelerator": cur.accelerator,
                "numReplicas": cur.num_replicas,
                "maxBatch": cur.max_batch,
                "variantCost": cur.variant_cost,
                "itlAverage": cur.itl_average,
                "ttftAverage": cur.ttft_average,
                "load": {"arrivalRate": cur.load.arrival_rate,
                         "avgInputTokens": cur.load.avg_input_tokens,
                         "avgOutputTokens": cur.load.avg_output_tokens},
            },
            "desiredOptimizedAlloc": {
                "lastRunTime": to_rfc3339(want.last_run_time),
                "accelerator": want.accelerator,
                "numReplicas": want.num_replicas,
            },
            "actuation": {"applied": va.status.actuation.applied},
            "conditions": [_condition(c) for c in va.status.conditions],
        },
    }
