"""Actuator: publishes scaling signals; never patches Deployments.

Equivalent of the Go reference's internal/actuator/actuator.go. The controller
emits `inferno_desired_replicas` (and friends); an external HPA/KEDA
actuates GKE TPU node pools from those series
(reference docs/integrations/hpa-integration.md:9-14).
"""

from __future__ import annotations

from ..controller.crd import VariantAutoscaling
from ..controller.kube import KubeClient
from ..metrics import MetricsEmitter
from ..utils import get_logger, kv

log = get_logger("wva.actuator")


class Actuator:
    def __init__(self, kube: KubeClient, emitter: MetricsEmitter):
        self.kube = kube
        self.emitter = emitter

    def current_deployment_replicas(self, va: VariantAutoscaling) -> int:
        """Live replica count from the Deployment, preferring status over
        spec (reference actuator.go:29-48); falls back to the VA status."""
        try:
            deploy = self.kube.get_deployment(va.name, va.namespace)
        except Exception as e:  # noqa: BLE001
            log.warning(
                "could not read deployment, falling back to VA status",
                extra=kv(variant=va.name, error=str(e)),
            )
            return va.status.current_alloc.num_replicas
        return deploy.current_replicas()

    def emit_metrics(self, va: VariantAutoscaling,
                     prev_desired: int | None = None,
                     current: int | None = None) -> bool:
        """Push current/desired/ratio for external autoscalers (reference
        actuator.go:50-84). Returns True when signals were emitted; metric
        emission failures never fail reconciliation.

        prev_desired: the previously PUBLISHED recommendation — a change
        increments inferno_replica_scaling_total (the reference registers
        that counter but never increments it, metrics.go:84-100). Counting
        decision changes, not desired!=current cycles, keeps the churn
        rate honest while slow external actuation catches up.
        current: the live replica count when the caller already holds it
        (the fleet-collection cycle's one-LIST Deployment snapshot) —
        skips the per-variant Deployment re-GET; None re-reads."""
        desired = va.status.desired_optimized_alloc.num_replicas
        if desired < 0:
            log.info("skipping metric emission, negative desired replicas",
                     extra=kv(variant=va.name))
            return False
        if current is None:
            current = self.current_deployment_replicas(va)
        try:
            self.emitter.emit_replica_metrics(
                variant_name=va.name,
                namespace=va.namespace,
                current=current,
                desired=desired,
                accelerator_type=va.status.desired_optimized_alloc.accelerator,
            )
            if prev_desired is not None and desired != prev_desired:
                self.emitter.emit_scaling_event(
                    variant_name=va.name, namespace=va.namespace,
                    direction="up" if desired > prev_desired else "down",
                    reason="optimization",
                )
        except Exception as e:  # noqa: BLE001
            log.error("failed to emit scaling signals", extra=kv(variant=va.name, error=str(e)))
            return False
        log.info(
            "emitted scaling signals",
            extra=kv(variant=va.name, current=current, desired=desired,
                     accelerator=va.status.desired_optimized_alloc.accelerator),
        )
        return True
