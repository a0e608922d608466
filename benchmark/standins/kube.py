"""The API server the controller talks to: a frozen copy of the port's
`controller/kube.py InMemoryKube`, reduced to the verbs a reconcile
cycle and the harness use.

It keeps that class's behaviour, so the requests the program makes are
what is measured: every read hands out a deep copy, every write bumps
resourceVersion and is checked against it (409 on a stale one), and a
status write is admitted against the shipped CRD's structural schema
(a frozen JSON copy beside this file), in the wire form of `wire.py`.
No latency is added.

The object types (VariantAutoscaling, Deployment, ConfigMap, Node) and
the error types the controller catches are the program's; they come in
through `types`, the port's `controller.kube` module, at construction.
"""

from __future__ import annotations

import copy
import threading

from . import schema, wire


class ApiServer:
    def __init__(self, types) -> None:
        self._t = types
        self._lock = threading.RLock()
        self.configmaps: dict = {}
        self.deployments: dict = {}
        self.vas: dict = {}
        self.nodes: dict = {}
        self._watchers: list = []
        self.status_update_count = 0

    # -- watch callbacks (fired after a mutation, outside the lock) -------

    def add_watch_listener(self, fn) -> None:
        self._watchers.append(fn)

    def _notify(self, etype: str, kind: str, name: str, namespace: str):
        if not self._watchers:
            return
        event = self._t.WatchEvent(etype, kind, name, namespace)
        for fn in list(self._watchers):
            fn(event)

    # -- set-up ---------------------------------------------------------------

    def put_configmap(self, cm) -> None:
        with self._lock:
            key = (cm.namespace, cm.name)
            etype = "MODIFIED" if key in self.configmaps else "ADDED"
            self.configmaps[key] = cm
        self._notify(etype, "ConfigMap", cm.name, cm.namespace)

    def put_deployment(self, d) -> None:
        if not d.uid:
            d.uid = f"uid-{d.namespace}-{d.name}"
        with self._lock:
            key = (d.namespace, d.name)
            etype = "MODIFIED" if key in self.deployments else "ADDED"
            self.deployments[key] = d
        self._notify(etype, "Deployment", d.name, d.namespace)

    def put_variant_autoscaling(self, va) -> None:
        self._admit(va)
        with self._lock:
            key = (va.namespace, va.name)
            etype = "MODIFIED" if key in self.vas else "ADDED"
            stored = copy.deepcopy(va)
            prev = self.vas.get(key)
            stored.metadata.resource_version = str(
                int((prev.metadata.resource_version if prev else "0")
                    or "0") + 1)
            self.vas[key] = stored
            va.metadata.resource_version = stored.metadata.resource_version
        self._notify(etype, "VariantAutoscaling", va.name, va.namespace)

    def put_node(self, node) -> None:
        with self._lock:
            self.nodes[node.name] = node

    def _admit(self, va) -> None:
        errors = schema.validate_va_dict(wire.va_to_dict(va))
        if errors:
            raise self._t.InvalidError(
                f"VariantAutoscaling \"{va.name}\" is invalid: "
                + "; ".join(errors))

    # -- the client protocol ---------------------------------------------

    def get_configmap(self, name: str, namespace: str):
        with self._lock:
            cm = self.configmaps.get((namespace, name))
            if cm is None:
                raise self._t.NotFoundError(
                    f"configmap {namespace}/{name} not found")
            return copy.deepcopy(cm)

    def get_deployment(self, name: str, namespace: str):
        with self._lock:
            d = self.deployments.get((namespace, name))
            if d is None:
                raise self._t.NotFoundError(
                    f"deployment {namespace}/{name} not found")
            return copy.deepcopy(d)

    def list_deployments(self, namespace=None) -> list:
        with self._lock:
            return [copy.deepcopy(d) for d in self.deployments.values()
                    if namespace is None or d.namespace == namespace]

    def list_variant_autoscalings(self) -> list:
        with self._lock:
            return [copy.deepcopy(va) for va in self.vas.values()]

    def get_variant_autoscaling(self, name: str, namespace: str):
        with self._lock:
            va = self.vas.get((namespace, name))
            if va is None:
                raise self._t.NotFoundError(
                    f"variantautoscaling {namespace}/{name} not found")
            return copy.deepcopy(va)

    def update_variant_autoscaling_status(self, va) -> None:
        with self._lock:
            key = (va.namespace, va.name)
            if key not in self.vas:
                raise self._t.NotFoundError(
                    f"variantautoscaling {key} not found")
            stored = self.vas[key]
            req_rv = va.metadata.resource_version
            if req_rv and req_rv != stored.metadata.resource_version:
                raise self._t.ConflictError(
                    f"variantautoscaling {key}: stale resourceVersion "
                    f"{req_rv} (storage at "
                    f"{stored.metadata.resource_version})")
            merged = copy.deepcopy(stored)
            merged.status = va.status
            self._admit(merged)
            stored.status = copy.deepcopy(va.status)
            stored.metadata.resource_version = str(
                int(stored.metadata.resource_version or "0") + 1)
            va.metadata.resource_version = stored.metadata.resource_version
            self.status_update_count += 1
        self._notify("MODIFIED", "VariantAutoscaling", va.name, va.namespace)

    def patch_owner_reference(self, va, deploy) -> None:
        with self._lock:
            key = (va.namespace, va.name)
            if key not in self.vas:
                raise self._t.NotFoundError(
                    f"variantautoscaling {key} not found")
            ref = {"apiVersion": "apps/v1", "kind": "Deployment",
                   "name": deploy.name, "uid": deploy.uid,
                   "controller": True, "blockOwnerDeletion": False}
            stored = self.vas[key]
            stored.metadata.owner_references = [ref]
            stored.metadata.resource_version = str(
                int(stored.metadata.resource_version or "0") + 1)
            va.metadata.owner_references = [ref]
            va.metadata.resource_version = stored.metadata.resource_version

    def list_nodes(self) -> list:
        with self._lock:
            return [copy.deepcopy(n) for n in self.nodes.values()]

    def get_lease(self, name: str, namespace: str):
        raise self._t.NotFoundError(f"lease {namespace}/{name} not found")
