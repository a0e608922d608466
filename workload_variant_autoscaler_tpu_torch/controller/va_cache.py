"""The full pass's VariantAutoscalings, kept current by watch events.

The reference's `List` goes through controller-runtime's manager
client, which reads the informer cache its watches keep current; it
does not ask the API server for the fleet every pass. `VACache` is that
read for the port. It holds the newest known object for each
(namespace, name): the objects the cycle works on and publishes through
(`Reconciler._apply` writes the status on them), so after a pass they
carry what the API server stores, resourceVersion included.

A full pass takes them as they are after re-reading only the keys that
a foreign watch event marked dirty. The controller's own status writes
are not foreign: a synchronous listener (`InMemoryKube`) fires in the
writing thread while `writing()` names the key there, and an
asynchronous watch (`RestKube`) carries the resourceVersion the write
returned, which the cached object then holds. A write that fails, or
that met a conflict (another writer changed the object), marks its key
dirty too.

The cache serves a pass only while a watch source feeds it (`live`)
and only if no gap was reported since the LIST that primed it: the
first pass, the first after a gap (a dropped event, a reconnect, a
`410 Gone`) and the first after a failure of its own bookkeeping LIST.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Iterator, Optional

from .crd import VariantAutoscaling
from .kube import NotFoundError, WatchEvent

Key = tuple[str, str]   # (namespace, name)


class VACache:
    def __init__(self) -> None:
        # guards the fields the watch threads touch: _dirty, _live,
        # _epoch, _primed. _vas is read and replaced by the cycle alone.
        self._lock = threading.Lock()
        self._vas: dict[Key, VariantAutoscaling] = {}
        # key -> the resourceVersion of its newest foreign event, or None
        # when it must be re-read whatever the cached object holds
        self._dirty: dict[Key, Optional[str]] = {}
        # keys deleted since the last pass: a recreated namesake sits at
        # the end of the API server's order, as a LIST would return it
        self._deleted: set[Key] = set()
        self._live = False
        self._epoch = 0
        self._primed: Optional[int] = None
        self._own = threading.local()

    # -- feeding (watch threads, the writers' threads) ------------------

    def attach(self, kube) -> bool:
        """Listen to a client that calls back on every mutation
        (`add_watch_listener`), and to its gap reports where it makes
        them (`add_gap_listener`). Returns whether it attached."""
        if not hasattr(kube, "add_watch_listener"):
            return False
        kube.add_watch_listener(self.on_event)
        if hasattr(kube, "add_gap_listener"):
            kube.add_gap_listener(self.on_gap)
        with self._lock:
            self._live = True
        return True

    def on_event(self, ev: WatchEvent) -> None:
        if ev.kind != "VariantAutoscaling":
            return
        key = (ev.namespace, ev.name)
        if getattr(self._own, "key", None) == key:
            return
        with self._lock:
            forced = key in self._dirty and self._dirty[key] is None
            if not forced:
                self._dirty[key] = ev.resource_version or None
            if ev.type == "DELETED":
                self._deleted.add(key)

    def on_gap(self, live: bool = True) -> None:
        """The watch stream lost events, or (with `live` False) stopped:
        the next full pass LISTs."""
        with self._lock:
            self._live = live
            self._epoch += 1

    @contextmanager
    def writing(self, va: VariantAutoscaling) -> Iterator[None]:
        """The controller's own write of `va` in this thread: its
        synchronous watch events are not foreign."""
        self._own.key = (va.namespace, va.name)
        try:
            yield
        finally:
            self._own.key = None

    def mark_dirty(self, va: VariantAutoscaling) -> None:
        """The cached `va` may differ from what the API server stores
        (a failed or conflicted write, a status changed and not
        written): re-read it on the next full pass."""
        with self._lock:
            self._dirty[(va.namespace, va.name)] = None

    # -- reading (the cycle's thread) ------------------------------------

    def invalidate(self) -> None:
        with self._lock:
            self._primed = None

    def begin_list(self) -> int:
        """Before a LIST that will prime the cache: what the LIST returns
        covers every event so far. Returns the epoch to prime under."""
        with self._lock:
            self._dirty.clear()
            self._deleted.clear()
            return self._epoch

    def prime(self, vas: list[VariantAutoscaling], epoch: int) -> None:
        """Hold `vas`, the result of the LIST begun at `epoch`. A gap
        reported since leaves the cache unprimed."""
        self._vas = {(va.namespace, va.name): va for va in vas}
        with self._lock:
            self._primed = epoch if self._live else None

    def read(self, get: Callable[[Key], VariantAutoscaling]
             ) -> Optional[list[VariantAutoscaling]]:
        """The fleet for a full pass, or None when the pass must LIST.
        `get` re-reads one dirty key; a NotFoundError drops it, any other
        error leaves the cache unprimed and propagates."""
        with self._lock:
            if not self._live or self._primed != self._epoch:
                return None
            dirty, self._dirty = self._dirty, {}
            deleted, self._deleted = self._deleted, set()
        try:
            for key, rv in dirty.items():
                cached = self._vas.get(key)
                if (rv is not None and key not in deleted
                        and cached is not None
                        and cached.metadata.resource_version == rv):
                    continue   # the echo of this controller's own write
                if key in deleted:
                    self._vas.pop(key, None)
                try:
                    self._vas[key] = get(key)
                except NotFoundError:
                    self._vas.pop(key, None)
        except BaseException:
            self.invalidate()
            raise
        return list(self._vas.values())
