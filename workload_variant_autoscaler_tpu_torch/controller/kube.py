"""Kubernetes client abstraction: in-memory fake + REST client.

The reference uses controller-runtime's cached client
(the Go reference's internal/utils/utils.go:58-104 wraps it in backoff). Here
the controller talks through a small `KubeClient` protocol with two
implementations:

- `InMemoryKube`: a dict-backed API server used by unit tests and the
  GPU/TPU-free e2e loop (the envtest equivalent in this rebuild's test
  strategy). Supports fault injection per (verb, resource) for backoff and
  degradation tests.
- `RestKube`: a thin HTTPS client for a real cluster (in-cluster service
  account or explicit kubeconfig-style parameters). Speaks the standard
  REST paths for Deployments, ConfigMaps and the VariantAutoscaling CRD.
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Protocol

from ..utils import TerminalError, get_logger, kv
from . import schema
from .crd import GROUP, PLURAL, VERSION, VariantAutoscaling, va_from_dict, va_to_dict


_log = get_logger("wva.kube")


class NotFoundError(TerminalError):
    """Resource does not exist (terminal for gets, reference utils.go:62-64)."""


class InvalidError(TerminalError):
    """Validation failure (terminal for updates, reference utils.go:95-97)."""


class ConflictError(Exception):
    """Stale resourceVersion on update (transient: re-get and retry)."""


@dataclass(frozen=True)
class WatchEvent:
    """One apiserver watch event, reduced to what the controller keys on.

    The reconcile loop is level-triggered (every cycle re-reads all
    state), so events carry identity only — no object payload. Matches
    the reference's event usage: it enqueues a reconcile request and
    drops the object (variantautoscaling_controller.go:456-487).
    """

    type: str        # ADDED | MODIFIED | DELETED
    kind: str        # VariantAutoscaling | ConfigMap | Deployment
    name: str
    namespace: str


@dataclass
class Deployment:
    name: str
    namespace: str = "default"
    spec_replicas: int = 1
    status_replicas: int = -1  # -1: status not reported yet
    uid: str = ""
    labels: dict[str, str] = field(default_factory=dict)

    def current_replicas(self) -> int:
        """Actual replicas, preferring live status (reference
        actuator.go:29-48)."""
        if self.status_replicas >= 0:
            return self.status_replicas
        if self.spec_replicas >= 0:
            return self.spec_replicas
        return 1


@dataclass
class ConfigMap:
    name: str
    namespace: str
    data: dict[str, str] = field(default_factory=dict)


@dataclass
class Node:
    """Cluster node as the inventory collector sees it: TPU labels,
    google.com/tpu allocatable chips, and schedulability."""

    name: str
    labels: dict[str, str] = field(default_factory=dict)
    tpu_capacity: int = 0      # allocatable google.com/tpu chips
    unschedulable: bool = False
    ready: bool = True

    def schedulable(self) -> bool:
        return self.ready and not self.unschedulable


class KubeClient(Protocol):
    def get_configmap(self, name: str, namespace: str) -> ConfigMap: ...
    def get_deployment(self, name: str, namespace: str) -> Deployment: ...
    # one-LIST fleet snapshot (fleet-scale collection: the reconciler
    # indexes all Deployments once per cycle instead of V gets)
    def list_deployments(
        self, namespace: Optional[str] = None) -> list[Deployment]: ...
    def list_variant_autoscalings(self) -> list[VariantAutoscaling]: ...
    def get_variant_autoscaling(self, name: str, namespace: str) -> VariantAutoscaling: ...
    def update_variant_autoscaling_status(self, va: VariantAutoscaling) -> None: ...
    def patch_owner_reference(self, va: VariantAutoscaling, deploy: Deployment) -> None: ...
    # node inventory (limited mode, collector.collect_inventory_k8s)
    def list_nodes(self) -> list[Node]: ...


class InMemoryKube:
    """Dict-backed fake API server with optional fault injection.

    Admission enforces the shipped CRD's structural schema (see schema.py)
    so unit/e2e tests exercise the same validation a real apiserver
    applies in the reference's envtest tier (suite_test.go:56-93)."""

    def __init__(self, validate_schema: Optional[bool] = None) -> None:
        if validate_schema is None:
            validate_schema = schema.DEFAULT_CRD_PATH.is_file()
        self._validate_schema = validate_schema
        self._lock = threading.RLock()
        self.configmaps: dict[tuple[str, str], ConfigMap] = {}
        self.deployments: dict[tuple[str, str], Deployment] = {}
        self.vas: dict[tuple[str, str], VariantAutoscaling] = {}
        self.nodes: dict[str, Node] = {}
        # (verb, kind) -> callable raising the injected error; removed after
        # `count` trips when count > 0
        self._faults: dict[tuple[str, str], tuple[Callable[[], None], int]] = {}
        # scheduled faults (faults.FaultPlan) consulted by every verb and
        # by watch delivery; None = no plan attached
        self._fault_plan = None
        self.status_update_count = 0
        self._watchers: list[Callable[[WatchEvent], None]] = []
        # authn/authz fakes for the metrics endpoint's TokenReview/SAR
        # path: token -> (username, groups); (user, verb, path) grants
        self._tokens: dict[str, tuple[str, list[str]]] = {}
        self._access: set[tuple[str, str, str]] = set()

    # -- watch (the apiserver's ?watch=true, reduced to callbacks) -------

    def add_watch_listener(self, fn: Callable[[WatchEvent], None]) -> None:
        """Register a callback fired on every object mutation. Callbacks
        run on the mutating thread and must be fast and must not call
        back into the kube synchronously (same discipline as informer
        event handlers)."""
        self._watchers.append(fn)

    def _notify(self, event: WatchEvent) -> None:
        plan = self._fault_plan
        if plan is not None and plan.watch_dropping():
            # a dropped ?watch=true stream: the mutation happened, the
            # event never reaches the controller — the level-triggered
            # cadence cycle is the only thing that may notice
            return
        for fn in list(self._watchers):
            fn(event)

    # -- setup helpers ---------------------------------------------------
    # Mutators take the lock (watch wiring makes concurrent mutation
    # during a running reconcile the advertised usage) and notify after
    # releasing it, so a slow listener cannot serialize the API.

    def put_configmap(self, cm: ConfigMap) -> None:
        with self._lock:
            key = (cm.namespace, cm.name)
            etype = "MODIFIED" if key in self.configmaps else "ADDED"
            self.configmaps[key] = cm
        self._notify(WatchEvent(etype, "ConfigMap", cm.name, cm.namespace))

    def put_deployment(self, d: Deployment) -> None:
        if not d.uid:
            d.uid = f"uid-{d.namespace}-{d.name}"
        with self._lock:
            key = (d.namespace, d.name)
            etype = "MODIFIED" if key in self.deployments else "ADDED"
            self.deployments[key] = d
        self._notify(WatchEvent(etype, "Deployment", d.name, d.namespace))

    def put_variant_autoscaling(self, va: VariantAutoscaling) -> None:
        self._admit(va)
        with self._lock:
            key = (va.namespace, va.name)
            etype = "MODIFIED" if key in self.vas else "ADDED"
            stored = copy.deepcopy(va)
            # every write bumps resourceVersion, like the apiserver
            prev = self.vas.get(key)
            stored.metadata.resource_version = str(
                int((prev.metadata.resource_version if prev else "0")
                    or "0") + 1)
            self.vas[key] = stored
            va.metadata.resource_version = stored.metadata.resource_version
        self._notify(
            WatchEvent(etype, "VariantAutoscaling", va.name, va.namespace))

    def _admit(self, va: VariantAutoscaling) -> None:
        """CRD structural-schema admission (apiserver 422 -> InvalidError)."""
        if not self._validate_schema:
            return
        errors = schema.validate_va_dict(va_to_dict(va))
        if errors:
            raise InvalidError(
                f"VariantAutoscaling.{GROUP} \"{va.name}\" is invalid: "
                + "; ".join(errors)
            )

    def inject_fault(self, verb: str, kind: str, exc: Exception, count: int = 0) -> None:
        def raiser() -> None:
            raise exc

        self._faults[(verb, kind)] = (raiser, count)

    def attach_fault_plan(self, plan) -> None:
        """Drive this kube from a scheduled faults.FaultPlan: every verb
        consults the plan (409 storms, NotFound windows, transport
        errors) and watch delivery honors its watch-drop windows. The
        count-based inject_fault remains for one-shot unit faults; a
        plan expresses multi-cycle scenarios the same way for unit tests
        and the emulator loop. Pass None to detach."""
        with self._lock:
            self._fault_plan = plan

    def _trip(self, verb: str, kind: str) -> None:
        plan = self._fault_plan
        if plan is not None:
            rule = plan.kube_fault(verb, kind)
            if rule is not None:
                from ..faults.inject import exception_for_kube_fault
                from ..obs.trace import add_event

                # surface the scheduled fault on the cycle's trace span
                # (no-op outside a trace) before raising its exception
                add_event("fault-injected", dependency="kube",
                          kind=rule.kind, op=f"{verb}:{kind}")
                raise exception_for_kube_fault(rule, verb, kind)
        entry = self._faults.get((verb, kind))
        if entry is None:
            return
        raiser, count = entry
        if count > 0:
            if count == 1:
                del self._faults[(verb, kind)]
            else:
                self._faults[(verb, kind)] = (raiser, count - 1)
        raiser()

    # -- authn/authz (authentication.k8s.io / authorization.k8s.io) ------

    def grant_token(self, token: str, user: str,
                    groups: Optional[list[str]] = None) -> None:
        """Register a valid bearer token resolving to `user` (fake of the
        apiserver's token authenticator)."""
        self._tokens[token] = (user, groups or [])

    def grant_access(self, user: str, verb: str, path: str) -> None:
        """RBAC grant for a nonResourceURL (fake of a ClusterRole rule
        like the reference's metrics-reader: nonResourceURLs /metrics,
        verbs get)."""
        self._access.add((user, verb, path))

    def create_token_review(self, token: str) -> dict:
        """POST tokenreviews — status dict like the apiserver's:
        {"authenticated": bool, "user": {"username":..., "groups": [...]}}."""
        self._trip("create", "TokenReview")
        entry = self._tokens.get(token)
        if entry is None:
            return {"authenticated": False}
        user, groups = entry
        return {"authenticated": True,
                "user": {"username": user, "groups": list(groups)}}

    def create_subject_access_review(self, user: str, groups: list[str],
                                     verb: str, path: str) -> bool:
        """POST subjectaccessreviews with nonResourceAttributes —
        allowed?"""
        self._trip("create", "SubjectAccessReview")
        if (user, verb, path) in self._access:
            return True
        return any((g, verb, path) in self._access for g in groups)

    # -- KubeClient ------------------------------------------------------

    def get_configmap(self, name: str, namespace: str) -> ConfigMap:
        with self._lock:
            self._trip("get", "ConfigMap")
            cm = self.configmaps.get((namespace, name))
            if cm is None:
                raise NotFoundError(f"configmap {namespace}/{name} not found")
            return copy.deepcopy(cm)

    def get_deployment(self, name: str, namespace: str) -> Deployment:
        with self._lock:
            self._trip("get", "Deployment")
            d = self.deployments.get((namespace, name))
            if d is None:
                raise NotFoundError(f"deployment {namespace}/{name} not found")
            return copy.deepcopy(d)

    def list_deployments(
        self, namespace: Optional[str] = None,
    ) -> list[Deployment]:
        with self._lock:
            self._trip("list", "Deployment")
            return [copy.deepcopy(d) for d in self.deployments.values()
                    if namespace is None or d.namespace == namespace]

    def list_variant_autoscalings(self) -> list[VariantAutoscaling]:
        with self._lock:
            self._trip("list", "VariantAutoscaling")
            return [copy.deepcopy(va) for va in self.vas.values()]

    def get_variant_autoscaling(self, name: str, namespace: str) -> VariantAutoscaling:
        with self._lock:
            self._trip("get", "VariantAutoscaling")
            va = self.vas.get((namespace, name))
            if va is None:
                raise NotFoundError(f"variantautoscaling {namespace}/{name} not found")
            return copy.deepcopy(va)

    def update_variant_autoscaling_status(self, va: VariantAutoscaling) -> None:
        with self._lock:
            self._trip("update_status", "VariantAutoscaling")
            key = (va.namespace, va.name)
            if key not in self.vas:
                raise NotFoundError(f"variantautoscaling {key} not found")
            stored = self.vas[key]
            # optimistic concurrency, like the apiserver: a PUT carrying
            # a resourceVersion older than storage is a 409 (the
            # reconciler's conflict-retried writer depends on this;
            # an empty RV skips the check — test-constructed objects)
            req_rv = va.metadata.resource_version
            if req_rv and req_rv != stored.metadata.resource_version:
                raise ConflictError(
                    f"variantautoscaling {key}: stale resourceVersion "
                    f"{req_rv} (storage at {stored.metadata.resource_version})")
            # status subresource: spec comes from storage, status from the
            # request — revalidate the merged object like the apiserver does
            merged = copy.deepcopy(stored)
            merged.status = va.status
            self._admit(merged)
            stored.status = copy.deepcopy(va.status)
            stored.metadata.resource_version = str(
                int(stored.metadata.resource_version or "0") + 1
            )
            # hand the new RV back, like a PUT response body does
            va.metadata.resource_version = stored.metadata.resource_version
            self.status_update_count += 1
        # outside the lock: a slow listener must not serialize the API
        self._notify(WatchEvent(
            "MODIFIED", "VariantAutoscaling", va.name, va.namespace))

    def patch_owner_reference(self, va: VariantAutoscaling, deploy: Deployment) -> None:
        with self._lock:
            self._trip("patch", "VariantAutoscaling")
            key = (va.namespace, va.name)
            if key not in self.vas:
                raise NotFoundError(f"variantautoscaling {key} not found")
            ref = {
                "apiVersion": "apps/v1",
                "kind": "Deployment",
                "name": deploy.name,
                "uid": deploy.uid,
                "controller": True,
                "blockOwnerDeletion": False,
            }
            stored = self.vas[key]
            stored.metadata.owner_references = [ref]
            # a merge-patch is a write: it bumps resourceVersion (a
            # status PUT reusing a pre-patch RV must then conflict)
            stored.metadata.resource_version = str(
                int(stored.metadata.resource_version or "0") + 1)
            va.metadata.owner_references = [ref]
            va.metadata.resource_version = stored.metadata.resource_version

    def put_node(self, node: Node) -> None:
        with self._lock:
            self.nodes[node.name] = node

    def list_nodes(self) -> list[Node]:
        """Node LIST with scheduled capacity withdrawal: an active
        `node-pool-drain` rule makes matching nodes read unschedulable
        (GKE maintenance cordon) and an active `spot-reclaim` rule makes
        them vanish entirely (preemptible VM reclaimed). Either way the
        apiserver keeps answering — a draining pool is SHRINKING
        capacity in the inventory, never a kube error storm."""
        with self._lock:
            self._trip("list", "Node")
            plan = self._fault_plan
            out: list[Node] = []
            for n in self.nodes.values():
                n = copy.deepcopy(n)
                if plan is not None:
                    from ..collector.collector import (
                        GKE_TPU_ACCELERATOR_LABEL,
                    )
                    from ..faults.plan import NODE_POOL_DRAIN

                    rule = plan.node_fault(
                        n.name, n.labels.get(GKE_TPU_ACCELERATOR_LABEL, ""))
                    if rule is not None:
                        if rule.kind == NODE_POOL_DRAIN:
                            n.unschedulable = True
                        else:   # spot-reclaim: the VM is gone
                            continue
                out.append(n)
            return out

    # -- test conveniences ----------------------------------------------

    def delete_deployment(self, name: str, namespace: str) -> None:
        events: list[WatchEvent] = []
        with self._lock:
            if self.deployments.pop((namespace, name), None) is not None:
                events.append(
                    WatchEvent("DELETED", "Deployment", name, namespace))
            # garbage-collect owned VAs (ownerReference semantics)
            uid = f"uid-{namespace}-{name}"
            for key, va in list(self.vas.items()):
                if va.is_controlled_by(uid):
                    del self.vas[key]
                    events.append(WatchEvent(
                        "DELETED", "VariantAutoscaling", va.name,
                        va.namespace))
        for ev in events:
            self._notify(ev)


def _yaml_scalar_str(v) -> str:
    """Coerce a YAML scalar the way its author wrote it: booleans as
    true/false (str(True) would yield Python-style 'True'), None as ''."""
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def in_memory_kube_from_manifests(path: str) -> InMemoryKube:
    """Dev-mode apiserver: an InMemoryKube preloaded from the YAML
    manifests in a directory (ConfigMaps, Deployments, VariantAutoscalings;
    other kinds ignored). Powers `--kube-manifests`, which runs the full
    controller process against the local emulator with no cluster at all —
    the reference has no equivalent (its smallest loop is kind)."""
    import glob as _glob

    import yaml

    kube = InMemoryKube()
    files = sorted(
        _glob.glob(os.path.join(path, "*.yaml"))
        + _glob.glob(os.path.join(path, "*.yml"))
    )
    if not files:
        raise InvalidError(f"no YAML manifests found in {path!r}")
    loadable = ("ConfigMap", "Deployment", "VariantAutoscaling")
    for fp in files:
        with open(fp) as f:
            for doc in yaml.safe_load_all(f):
                if not isinstance(doc, dict):
                    continue
                kind = doc.get("kind", "")
                if kind not in loadable:
                    continue
                # hand-edited manifests: an explicit empty `metadata:`,
                # `spec:`, or scalar (`replicas:`) parses to None, not to
                # the absent-key default
                meta = doc.get("metadata") or {}
                if not isinstance(meta, dict):
                    raise InvalidError(
                        f"{fp}: {kind} metadata must be a mapping"
                    )
                labels = meta.get("labels") or {}
                if not isinstance(labels, dict):
                    raise InvalidError(
                        f"{fp}: {kind} metadata.labels must be a mapping"
                    )
                name = meta.get("name") or ""
                ns = meta.get("namespace") or "default"
                if not name:
                    raise InvalidError(f"{fp}: {kind} without metadata.name")
                if kind == "ConfigMap":
                    data = doc.get("data") or {}
                    if not isinstance(data, dict):
                        raise InvalidError(
                            f"{fp}: ConfigMap {name!r} data must be a mapping"
                        )
                    bad = [k for k, v in data.items()
                           if v is not None and not isinstance(v, (str, int, float, bool))]
                    if bad:
                        # a real apiserver rejects non-string ConfigMap data;
                        # coercing a dict to its Python repr would just fail
                        # confusingly at reconcile time
                        raise InvalidError(
                            f"{fp}: ConfigMap {name!r} data values must be "
                            f"strings (offending keys: {bad}; quote them in YAML)"
                        )
                    kube.put_configmap(ConfigMap(
                        name=name, namespace=ns,
                        data={k: _yaml_scalar_str(v) for k, v in data.items()},
                    ))
                elif kind == "Deployment":
                    spec = doc.get("spec") or {}
                    if not isinstance(spec, dict):
                        raise InvalidError(
                            f"{fp}: Deployment {name!r} spec must be a mapping"
                        )
                    raw = spec.get("replicas")
                    # strict, like the apiserver: integer >= 0 only (no
                    # bools, no truncated floats)
                    if raw is None:
                        replicas = 1
                    elif (isinstance(raw, bool) or not isinstance(raw, int)
                          or raw < 0):
                        raise InvalidError(
                            f"{fp}: Deployment {name!r} spec.replicas must be "
                            f"a non-negative integer, got {raw!r}"
                        )
                    else:
                        replicas = raw
                    kube.put_deployment(Deployment(
                        name=name, namespace=ns,
                        spec_replicas=replicas, status_replicas=replicas,
                        labels=dict(labels),
                    ))
                else:
                    # validate the RAW document: round-tripping through the
                    # dataclasses first would fill defaults and mask missing
                    # required fields (kubectl validates what you submitted).
                    # Same CRD-file guard as InMemoryKube._admit (installed
                    # packages may not carry the manifest).
                    if schema.DEFAULT_CRD_PATH.is_file():
                        errors = schema.validate_va_dict(doc)
                        if errors:
                            raise InvalidError(
                                f"{fp}: VariantAutoscaling {name!r} is invalid: "
                                + "; ".join(errors)
                            )
                    kube.put_variant_autoscaling(va_from_dict(doc))
    return kube


class RestKube:
    """Minimal REST client for a real API server.

    Auth: in-cluster (service account token + CA at the standard paths) or
    explicit base_url/token/ca. Only the verbs the controller needs.
    """

    SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

    def __init__(
        self,
        base_url: Optional[str] = None,
        token: Optional[str] = None,
        ca_cert: Optional[str] = None,
        verify: bool | str = True,
        timeout: float = 10.0,
    ) -> None:
        import requests

        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            base_url = f"https://{host}:{port}"
            token_path = os.path.join(self.SA_DIR, "token")
            if token is None and os.path.exists(token_path):
                with open(token_path) as f:
                    token = f.read().strip()
            ca_path = os.path.join(self.SA_DIR, "ca.crt")
            if ca_cert is None and os.path.exists(ca_path):
                ca_cert = ca_path
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._session = requests.Session()
        if token:
            self._session.headers["Authorization"] = f"Bearer {token}"
        self._session.verify = ca_cert if ca_cert else verify

    def _request(self, method: str, path: str, body: Any = None, content_type: str = "application/json") -> Any:
        url = f"{self.base_url}{path}"
        resp = self._session.request(
            method, url, json=body, timeout=self.timeout,
            headers={"Content-Type": content_type} if body is not None else None,
        )
        if resp.status_code == 404:
            raise NotFoundError(f"{method} {path}: not found")
        if resp.status_code == 409:
            raise ConflictError(f"{method} {path}: conflict")
        if resp.status_code in (400, 422):
            raise InvalidError(f"{method} {path}: {resp.text[:200]}")
        resp.raise_for_status()
        return resp.json() if resp.content else None

    def get_configmap(self, name: str, namespace: str) -> ConfigMap:
        obj = self._request("GET", f"/api/v1/namespaces/{namespace}/configmaps/{name}")
        return ConfigMap(name=name, namespace=namespace, data=obj.get("data", {}))

    @staticmethod
    def _deployment_from_obj(obj: dict, name: str = "",
                             namespace: str = "") -> Deployment:
        meta = obj.get("metadata", {})
        return Deployment(
            name=name or meta.get("name", ""),
            namespace=namespace or meta.get("namespace", ""),
            spec_replicas=obj.get("spec", {}).get("replicas", 1),
            status_replicas=obj.get("status", {}).get("replicas", -1),
            uid=meta.get("uid", ""),
            labels=meta.get("labels", {}),
        )

    def get_deployment(self, name: str, namespace: str) -> Deployment:
        obj = self._request(
            "GET", f"/apis/apps/v1/namespaces/{namespace}/deployments/{name}"
        )
        return self._deployment_from_obj(obj, name=name, namespace=namespace)

    def list_deployments(
        self, namespace: Optional[str] = None,
    ) -> list[Deployment]:
        """One LIST for the fleet's Deployment snapshot (all namespaces
        by default — the cluster-scoped /apis/apps/v1/deployments path,
        which the controller's read RBAC must cover)."""
        path = (f"/apis/apps/v1/namespaces/{namespace}/deployments"
                if namespace else "/apis/apps/v1/deployments")
        obj = self._request("GET", path)
        return [self._deployment_from_obj(item)
                for item in obj.get("items", [])]

    def list_variant_autoscalings(self) -> list[VariantAutoscaling]:
        obj = self._request("GET", f"/apis/{GROUP}/{VERSION}/{PLURAL}")
        return [va_from_dict(item) for item in obj.get("items", [])]

    def get_variant_autoscaling(self, name: str, namespace: str) -> VariantAutoscaling:
        obj = self._request(
            "GET", f"/apis/{GROUP}/{VERSION}/namespaces/{namespace}/{PLURAL}/{name}"
        )
        return va_from_dict(obj)

    def update_variant_autoscaling_status(self, va: VariantAutoscaling) -> None:
        obj = self._request(
            "PUT",
            f"/apis/{GROUP}/{VERSION}/namespaces/{va.namespace}/{PLURAL}/{va.name}/status",
            body=va_to_dict(va),
        )
        # carry the new resourceVersion back onto the caller's object
        # (client-go Update semantics) so a follow-up write isn't stale
        rv = ((obj or {}).get("metadata") or {}).get("resourceVersion")
        if rv:
            va.metadata.resource_version = rv

    def patch_owner_reference(self, va: VariantAutoscaling, deploy: Deployment) -> None:
        patch = {
            "metadata": {
                "ownerReferences": [
                    {
                        "apiVersion": "apps/v1",
                        "kind": "Deployment",
                        "name": deploy.name,
                        "uid": deploy.uid,
                        "controller": True,
                        "blockOwnerDeletion": False,
                    }
                ]
            }
        }
        obj = self._request(
            "PATCH",
            f"/apis/{GROUP}/{VERSION}/namespaces/{va.namespace}/{PLURAL}/{va.name}",
            body=patch,
            content_type="application/merge-patch+json",
        )
        rv = ((obj or {}).get("metadata") or {}).get("resourceVersion")
        if rv:
            va.metadata.resource_version = rv

    # -- authn/authz (metrics-endpoint TokenReview/SAR; reference
    # cmd/main.go:164-168 protects /metrics with controller-runtime's
    # WithAuthenticationAndAuthorization filter, which issues exactly
    # these two POSTs) --------------------------------------------------

    def create_token_review(self, token: str) -> dict:
        obj = self._request(
            "POST", "/apis/authentication.k8s.io/v1/tokenreviews",
            body={
                "apiVersion": "authentication.k8s.io/v1",
                "kind": "TokenReview",
                "spec": {"token": token},
            },
        )
        status = (obj or {}).get("status") or {}
        return {"authenticated": bool(status.get("authenticated")),
                "user": status.get("user") or {}}

    def create_subject_access_review(self, user: str, groups: list[str],
                                     verb: str, path: str) -> bool:
        obj = self._request(
            "POST", "/apis/authorization.k8s.io/v1/subjectaccessreviews",
            body={
                "apiVersion": "authorization.k8s.io/v1",
                "kind": "SubjectAccessReview",
                "spec": {
                    "user": user,
                    "groups": list(groups),
                    "nonResourceAttributes": {"verb": verb, "path": path},
                },
            },
        )
        return bool(((obj or {}).get("status") or {}).get("allowed"))

    # -- watch (?watch=true streaming) -----------------------------------

    def watch_variant_autoscalings(
        self,
        on_event: Callable[[WatchEvent], None],
        stop: threading.Event,
        timeout_seconds: int = 300,
    ) -> None:
        """Blocking watch loop over all VariantAutoscalings; call from a
        dedicated thread. Reconnects forever until `stop` is set."""
        self._watch_loop(
            f"/apis/{GROUP}/{VERSION}/{PLURAL}", "VariantAutoscaling",
            on_event, stop, timeout_seconds=timeout_seconds,
        )

    def watch_configmap(
        self,
        name: str,
        namespace: str,
        on_event: Callable[[WatchEvent], None],
        stop: threading.Event,
        timeout_seconds: int = 300,
    ) -> None:
        """Blocking watch loop over one named ConfigMap (the operator
        config); the apiserver filters via fieldSelector."""
        self._watch_loop(
            f"/api/v1/namespaces/{namespace}/configmaps", "ConfigMap",
            on_event, stop,
            field_selector=f"metadata.name={name}",
            timeout_seconds=timeout_seconds,
        )

    def _watch_loop(
        self,
        list_path: str,
        kind: str,
        on_event: Callable[[WatchEvent], None],
        stop: threading.Event,
        field_selector: Optional[str] = None,
        timeout_seconds: int = 300,
    ) -> None:
        """List-then-watch with resourceVersion bookkeeping.

        Mirrors the informer contract: an initial LIST pins the
        resourceVersion, then a chunked ?watch=true stream delivers
        events from that version on. The stream RV advances with every
        event; on server-side expiry (timeoutSeconds) the watch resumes
        from the last seen RV, and on `410 Gone` / ERROR events the
        outer loop re-LISTs from scratch (the cache window moved on).
        The reconcile loop is level-triggered, so a re-list loses
        nothing — the next cycle re-reads all state anyway.
        """
        backoff = 1.0
        stream_backoff = 2.0
        last_warn = 0.0

        def warn(msg: str, **fields) -> None:
            # rate-limited: a permanently broken watch (401, TLS, bad
            # URL) must be visible without flooding at retry cadence
            nonlocal last_warn
            now = time.monotonic()
            if now - last_warn >= 60.0:
                last_warn = now
                _log.warning(msg, extra=kv(kind=kind, path=list_path,
                                           **fields))

        while not stop.is_set():
            # 1. LIST: pin the resourceVersion to watch from
            try:
                params = {"fieldSelector": field_selector} if field_selector else None
                resp = self._session.get(
                    f"{self.base_url}{list_path}", params=params,
                    timeout=self.timeout)
                resp.raise_for_status()
                rv = (resp.json().get("metadata") or {}).get(
                    "resourceVersion", "")
            except Exception as e:  # noqa: BLE001 — reconnect forever
                warn("watch LIST failed; retrying", error=str(e))
                stop.wait(backoff)
                backoff = min(backoff * 2, 30.0)
                continue
            backoff = 1.0

            # 2. WATCH: stream from rv until expiry or error
            relist = False
            while not stop.is_set() and not relist:
                params = {
                    "watch": "true",
                    "allowWatchBookmarks": "true",
                    "timeoutSeconds": str(timeout_seconds),
                }
                if rv:
                    params["resourceVersion"] = rv
                if field_selector:
                    params["fieldSelector"] = field_selector
                stream = None
                try:
                    stream = self._session.get(
                        f"{self.base_url}{list_path}", params=params,
                        stream=True,
                        timeout=(self.timeout, timeout_seconds + 30),
                    )
                    if stream.status_code == 410:
                        # informers rate-limit relists: never hammer the
                        # apiserver with back-to-back LIST+WATCH cycles
                        relist = True
                        stop.wait(1.0)
                        continue
                    stream.raise_for_status()
                    for line in stream.iter_lines():
                        if stop.is_set():
                            return
                        if not line:
                            continue
                        # stream delivered data: reset the failure
                        # backoff here, not on the 200 alone — a proxy
                        # idle-killing long streams must not escalate
                        # healthy reconnects to the cap, but an
                        # accept-then-drop middlebox still must
                        stream_backoff = 2.0
                        try:
                            ev = json.loads(line)
                        except json.JSONDecodeError:
                            continue
                        etype = ev.get("type", "")
                        obj = ev.get("object") or {}
                        if etype == "ERROR":
                            # e.g. `410 Gone` delivered mid-stream
                            relist = True
                            stop.wait(1.0)
                            break
                        meta = obj.get("metadata") or {}
                        if meta.get("resourceVersion"):
                            rv = meta["resourceVersion"]
                        if etype == "BOOKMARK":
                            continue
                        on_event(WatchEvent(
                            type=etype, kind=kind,
                            name=meta.get("name", ""),
                            namespace=meta.get("namespace", ""),
                        ))
                    # clean server-side expiry: resume from last rv
                except Exception as e:  # noqa: BLE001 — reconnect forever
                    warn("watch stream failed; reconnecting", error=str(e))
                    # exponential, and via a fresh LIST: a persistent
                    # 403/429 on ?watch=true must not retry hot at a
                    # fixed cadence (the LIST path already backs off,
                    # and a re-list is free for a level-triggered loop)
                    stop.wait(stream_backoff)
                    stream_backoff = min(stream_backoff * 2, 60.0)
                    relist = True
                finally:
                    if stream is not None:
                        stream.close()

    # only TPU nodes: the apiserver filters, not the client
    _TPU_NODE_SELECTOR = "cloud.google.com%2Fgke-tpu-accelerator"

    def list_nodes(self) -> list[Node]:
        obj = self._request(
            "GET", f"/api/v1/nodes?labelSelector={self._TPU_NODE_SELECTOR}"
        )
        out = []
        for item in obj.get("items", []):
            meta = item.get("metadata", {})
            status = item.get("status", {})
            # allocatable (what pods can actually request), capacity fallback
            resources = status.get("allocatable") or status.get("capacity", {})
            try:
                tpus = int(resources.get("google.com/tpu", "0"))
            except ValueError:
                tpus = 0
            ready = any(
                c.get("type") == "Ready" and c.get("status") == "True"
                for c in status.get("conditions", [])
            )
            out.append(Node(
                name=meta.get("name", ""),
                labels=dict(meta.get("labels", {})),
                tpu_capacity=tpus,
                unschedulable=bool(item.get("spec", {}).get("unschedulable")),
                ready=ready,
            ))
        return out
