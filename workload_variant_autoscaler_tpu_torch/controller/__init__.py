"""Control loop: VariantAutoscaling CRD + reconciler + kube clients."""

from . import crd, translate
from .kube import (
    ConfigMap,
    ConflictError,
    Deployment,
    InMemoryKube,
    InvalidError,
    KubeClient,
    NotFoundError,
    RestKube,
    WatchEvent,
)
from .reconciler import (
    ACCELERATOR_CM_NAME,
    CONFIG_MAP_NAME,
    CONFIG_MAP_NAMESPACE,
    DEFAULT_INTERVAL_SECONDS,
    SERVICE_CLASS_CM_NAME,
    Reconciler,
    ReconcileResult,
    SolveEngineSelector,
)

__all__ = [
    "ACCELERATOR_CM_NAME",
    "CONFIG_MAP_NAME",
    "CONFIG_MAP_NAMESPACE",
    "ConfigMap",
    "ConflictError",
    "DEFAULT_INTERVAL_SECONDS",
    "Deployment",
    "InMemoryKube",
    "InvalidError",
    "KubeClient",
    "NotFoundError",
    "ReconcileResult",
    "Reconciler",
    "RestKube",
    "SERVICE_CLASS_CM_NAME",
    "SolveEngineSelector",
    "WatchEvent",
    "crd",
    "translate",
]
