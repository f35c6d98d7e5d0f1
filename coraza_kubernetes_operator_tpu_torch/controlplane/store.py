"""Watch-capable in-memory object store — the kube-apiserver seam.

The reference always reconciles against a *real* API server (envtest/kind,
SURVEY §4); this store is our equivalent seam: controllers speak a tiny
client interface (get/list/create/update/apply/delete + watch), tests use
this in-memory implementation, and a real-cluster adapter can implement the
same interface later. Watch handlers fire synchronously on mutation —
the manager turns them into workqueue items (the watch→queue decoupling of
controller-runtime).
"""

from __future__ import annotations

import threading
import uuid
from collections import defaultdict
from typing import Any, Callable

WatchHandler = Callable[[str, Any], None]  # (event_type, object)


class NotFoundError(KeyError):
    pass


class ObjectStore:
    """Objects bucketed by kind, keyed (namespace, name).

    Cluster write-back seam: ``on_apply`` / ``on_status`` hooks (set by
    ``kubeclient.ClusterSource``) mirror controller writes to a real API
    server; mutations arriving *from* the cluster watch pass
    ``sync=False`` so they don't echo back."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._objects: dict[str, dict[tuple[str, str], Any]] = defaultdict(dict)
        self._watchers: dict[str, list[WatchHandler]] = defaultdict(list)
        self.on_apply: Callable[[Any], None] | None = None
        self.on_status: Callable[[Any], None] | None = None

    # -- client interface ---------------------------------------------------

    def create(self, obj: Any, sync: bool = True) -> Any:
        with self._lock:
            kind = obj.kind
            key = obj.metadata.key
            if key in self._objects[kind]:
                raise ValueError(f"{kind} {key} already exists")
            if hasattr(obj, "validate"):
                obj.validate()
            obj.metadata.uid = obj.metadata.uid or str(uuid.uuid4())
            obj.metadata.resource_version = 1
            self._objects[kind][key] = obj
        self._notify(kind, "ADDED", obj)
        return obj

    def get(self, kind: str, namespace: str, name: str) -> Any:
        with self._lock:
            obj = self._objects[kind].get((namespace, name))
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            return obj

    def try_get(self, kind: str, namespace: str, name: str) -> Any | None:
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: str | None = None) -> list[Any]:
        with self._lock:
            objs = list(self._objects[kind].values())
        if namespace is not None:
            objs = [o for o in objs if o.metadata.namespace == namespace]
        return objs

    def update(self, obj: Any, bump_generation: bool = True, sync: bool = True) -> Any:
        with self._lock:
            kind = obj.kind
            key = obj.metadata.key
            if key not in self._objects[kind]:
                raise NotFoundError(f"{kind} {key} not found")
            if hasattr(obj, "validate"):
                obj.validate()
            obj.metadata.resource_version += 1
            if bump_generation:
                obj.metadata.generation += 1
            self._objects[kind][key] = obj
        self._notify(kind, "MODIFIED", obj)
        return obj

    def update_status(self, obj: Any) -> Any:
        """Status-only patch: no generation bump, no spec validation rerun —
        and no watch event for GenerationChanged-predicated controllers."""
        with self._lock:
            obj.metadata.resource_version += 1
            self._objects[obj.kind][obj.metadata.key] = obj
        if self.on_status is not None:
            self.on_status(obj)
        return obj

    def apply(self, obj: Any) -> Any:
        """Server-side-apply equivalent: create-or-overwrite by key
        (reference ``utils.go:114-138`` with ForceOwnership); mirrored to
        the cluster when a ClusterSource is attached."""
        with self._lock:
            kind = obj.kind
            exists = obj.metadata.key in self._objects[kind]
        out = self.update(obj) if exists else self.create(obj)
        if self.on_apply is not None:
            self.on_apply(out)
        return out

    def delete(self, kind: str, namespace: str, name: str, sync: bool = True) -> None:
        with self._lock:
            obj = self._objects[kind].pop((namespace, name), None)
        if obj is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        obj.metadata.deleted = True
        self._notify(kind, "DELETED", obj)
        # Ownership GC: cascade to owned objects (owner refs by uid).
        self._gc_owned(obj)

    # -- watches ------------------------------------------------------------

    def watch(self, kind: str, handler: WatchHandler) -> None:
        with self._lock:
            self._watchers[kind].append(handler)

    def _notify(self, kind: str, event: str, obj: Any) -> None:
        for handler in list(self._watchers.get(kind, [])):
            handler(event, obj)

    def _gc_owned(self, owner: Any) -> None:
        uid = owner.metadata.uid
        doomed: list[Any] = []
        with self._lock:
            for kind_objs in self._objects.values():
                for obj in list(kind_objs.values()):
                    if any(
                        ref.get("uid") == uid
                        for ref in getattr(obj.metadata, "owner_references", [])
                    ):
                        doomed.append(obj)
        for obj in doomed:
            try:
                self.delete(obj.kind, obj.metadata.namespace, obj.metadata.name)
            except NotFoundError:
                pass
