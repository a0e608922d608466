"""Resident candidate arena: persistent packing buffers for the sizing batch.

Counterpart of the reference package's `ops/arena.py` `CandidateArena`.
Every System packs its sizing groups through one (`System.arena`); the
incremental engine (solver/incremental.py) attaches its own, which
outlives the per-cycle System. The arena keeps padded, bucketed host
buffers RESIDENT across packs, keyed by lane-bucket shape: each pack
writes lanes [0, C) and resets [C, b) to the benign-invalid fills, then
stages the columns onto the System's device in its dtype.

Exactness contract: `pack()` gives tensors bit-identical to the list
path (`make_queue_batch`, padded to the lane bucket with the fills
below, and `make_epilogue_batch`): same dtypes (int32 max_batch,
occupancy and min_replicas, bool valid), same fills, float columns
staged through float64 numpy before the cast. `System._dedup_rows` and
the engine's exactness rest on it.

Every pack hands out tensors that own their memory: `torch.tensor`
copies, so no later pack can rewrite an earlier pack's tensors through
the resident slab (`torch.as_tensor` of a float64 slab would share it on
the CPU in float64).

`ShardedFleetArena` is the fleet-mesh form (the reference's class of the
same name): its slabs stay resident on the mesh's devices, one slab per
shard, and each pack moves only the lanes that changed.
"""

from __future__ import annotations

import base64
import math

import numpy as np
import torch

from ..obs.profile import DEVICE_AUDIT
from ..utils.device import resolve_dtype
from .batched import QueueBatch, SLOTargets
from .fused import EpilogueBatch
from .queueing import MAX_QUEUE_TO_BATCH_RATIO

# column -> (numpy staging dtype, pad fill); the fills are benign invalid
# lanes (alpha=1, out_tokens=2, max_batch=occupancy=1, valid=False), as
# the reference package's `parallel.pad_to_multiple` pads
_COLUMNS = {
    "alpha": (np.float64, 1.0),
    "beta": (np.float64, 0.0),
    "gamma": (np.float64, 0.0),
    "delta": (np.float64, 0.0),
    "in_tokens": (np.float64, 0.0),
    "out_tokens": (np.float64, 2.0),
    "max_batch": (np.int64, 1),
    "occupancy": (np.int64, 1),
    "valid": (bool, False),
    "ttft": (np.float64, 0.0),
    "itl": (np.float64, 0.0),
    "tps": (np.float64, 0.0),
}

# epilogue columns (ops/fused.py EpilogueBatch): written and staged only
# when the rows carry them (the fused decision); the staged path packs
# the 12 queue/SLO columns. Zero fills are benign: a zero-demand lane
# sizes to zero replicas.
_EPI_COLUMNS = {
    "demand": (np.float64, 0.0),
    "min_replicas": (np.int64, 0),
    "cost_rate": (np.float64, 0.0),
}

LANE_BUCKET = 16  # candidate-axis quantum: groups pad to a multiple


def lane_bucket(count: int, quantum: int = LANE_BUCKET) -> int:
    """Padded lane count for `count` candidates (min one quantum)."""
    return max(math.ceil(count / quantum) * quantum, quantum)


class CandidateArena:
    """Resident per-shape packing buffers (see module docstring)."""

    def __init__(self) -> None:
        # (padded lane count) -> {column: resident numpy buffer}
        self._slabs: dict[int, dict[str, np.ndarray]] = {}
        self.packs = 0          # pack() calls served
        self.slab_allocs = 0    # fresh slab allocations (0 in steady state)

    def _slab(self, b: int) -> dict[str, np.ndarray]:
        slab = self._slabs.get(b)
        if slab is None:
            slab = {name: np.full(b, fill, dtype=dt)
                    for name, (dt, fill) in (*_COLUMNS.items(),
                                             *_EPI_COLUMNS.items())}
            self._slabs[b] = slab
            self.slab_allocs += 1
        return slab

    # -- warm cold-start snapshot (solver/hierarchy.py checkpoint) --------

    def snapshot_slabs(self) -> dict:
        """JSON-serializable image of the resident slabs: bucket ->
        column -> {numpy dtype, base64 raw bytes}. An exact byte
        round-trip: a restored arena holds precisely the slabs the
        checkpointed process last packed."""
        return {
            str(b): {name: {"dtype": buf.dtype.str,
                            "data": base64.b64encode(
                                buf.tobytes()).decode("ascii")}
                     for name, buf in slab.items()}
            for b, slab in self._slabs.items()
        }

    def restore_slabs(self, snap: dict) -> None:
        """Rebuild the slabs from snapshot_slabs() output. Raises
        ValueError on any malformed entry (unknown or missing column,
        wrong length); nothing is committed until every slab has
        validated, so a failed restore leaves the arena as it was."""
        known = dict(_COLUMNS)
        known.update(_EPI_COLUMNS)
        restored: dict[int, dict[str, np.ndarray]] = {}
        for b_key, cols in snap.items():
            b = int(b_key)
            if set(cols) != set(known):
                raise ValueError(f"arena slab {b}: column set mismatch")
            slab = {}
            for name, rec in cols.items():
                arr = np.frombuffer(
                    base64.b64decode(rec["data"]),
                    dtype=np.dtype(rec["dtype"])).copy()
                if arr.shape != (b,):
                    raise ValueError(
                        f"arena slab {b}.{name}: length mismatch")
                slab[name] = arr
            restored[b] = slab
        self._slabs.update(restored)

    def pack(self, rows: dict[str, list], quantum: int = LANE_BUCKET, *,
             device: torch.device, dtype: torch.dtype):
        """Write `rows` (column -> list of C values) into the resident slab
        of the bucketed shape and return (QueueBatch, SLOTargets,
        EpilogueBatch | None) of length lane_bucket(C) on `device` in
        `dtype`. The epilogue is packed only when `rows` carries it."""
        c = len(rows["alpha"])
        if "occupancy" not in rows:
            rows = dict(rows)
            rows["occupancy"] = [int(m) * (1 + MAX_QUEUE_TO_BATCH_RATIO)
                                 for m in rows["max_batch"]]
        with_epi = "demand" in rows
        b = lane_bucket(c, quantum)
        slab = self._slab(b)
        columns = dict(_COLUMNS)
        if with_epi:
            columns.update(_EPI_COLUMNS)
        for name, (_dt, fill) in columns.items():
            buf = slab[name]
            if name == "valid":
                buf[:c] = True
            else:
                buf[:c] = rows[name]
            buf[c:] = fill
        self.packs += 1
        # one host-to-device copy per staged column (device audit)
        DEVICE_AUDIT.note_transfer("h2d", len(columns))

        def f(name):
            return torch.tensor(slab[name], dtype=dtype, device=device)

        def i(name):
            return torch.tensor(slab[name], dtype=torch.int32, device=device)

        q = QueueBatch(
            alpha=f("alpha"), beta=f("beta"), gamma=f("gamma"),
            delta=f("delta"), in_tokens=f("in_tokens"),
            out_tokens=f("out_tokens"), max_batch=i("max_batch"),
            occupancy=i("occupancy"),
            valid=torch.tensor(slab["valid"], device=device),
        )
        slo = SLOTargets(ttft=f("ttft"), itl=f("itl"), tps=f("tps"))
        if not with_epi:
            return q, slo, None
        epi = EpilogueBatch(demand=f("demand"),
                            min_replicas=i("min_replicas"),
                            cost_rate=f("cost_rate"))
        return q, slo, epi


# scatter index padding quantum: pins the scatter's index count across
# cycles with different churn sizes
SCATTER_BUCKET = 16

_QUEUE_FIELDS = ("alpha", "beta", "gamma", "delta", "in_tokens",
                 "out_tokens", "max_batch", "occupancy", "valid")


class ShardedFleetArena(CandidateArena):
    """CandidateArena whose slabs live resident on the devices of a lane
    mesh (parallel.fleet_mesh), one contiguous slab per shard.

    The inherited numpy slabs become a host mirror used for change
    detection: each pack diffs the incoming rows against the mirror, and
    only the changed lanes (their index padded to SCATTER_BUCKET with
    repeats of the first, which carry identical values) are copied into
    the resident slabs in place: steady-state churn moves O(changed)
    bytes to the devices, a zero-diff pack moves none. Padding lands per
    shard (parallel.padded_lanes), so every shard's slab is a multiple
    of the lane quantum.

    Exactness: values stage through the same numpy dtypes and the same
    casts as CandidateArena.pack, and a scatter writes exactly the lanes
    whose staged values differ, so the resident slabs are bit-identical
    to a fresh upload of the mirror. `pack` returns `parallel.Shards`
    views of the resident slabs: they hold this pack's values until the
    next pack of the same shape.
    """

    def __init__(self, mesh, dtype=None) -> None:
        super().__init__()
        self.mesh = mesh
        self.dtype = resolve_dtype(dtype)
        # (padded lane count) -> {column: [one resident tensor per shard]}
        self._device: dict[int, dict[str, list]] = {}
        self.full_uploads = 0     # whole-slab uploads (1 per shape)
        self.scatter_packs = 0    # packs served by the scatter
        self.noop_packs = 0       # packs with zero changed lanes (no h2d)
        self.lanes_scattered = 0  # total changed lanes scattered

    def _torch_dtype(self, name: str) -> torch.dtype:
        dt = {**_COLUMNS, **_EPI_COLUMNS}[name][0]
        if dt is bool:
            return torch.bool
        return torch.int32 if np.issubdtype(dt, np.integer) else self.dtype

    def _upload(self, b: int, names) -> None:
        """Whole-slab upload of the mirror of shape b: each shard's
        contiguous piece of every column onto its device."""
        slab = self._slabs[b]
        per = b // self.mesh.size
        self._device[b] = {
            name: [torch.tensor(slab[name][i * per:(i + 1) * per],
                                dtype=self._torch_dtype(name), device=dev)
                   for i, dev in enumerate(self.mesh.devices)]
            for name in names}
        self.full_uploads += 1
        DEVICE_AUDIT.note_transfer("h2d", len(names), shards=self.mesh.size)

    def restore_slabs(self, snap: dict) -> None:
        """Restore the host mirrors and stage them onto the mesh, so the
        first pack after a restart rides the scatter (O(changed)) instead
        of a whole-slab upload. Raises ValueError, committing nothing,
        when a slab does not split into the mesh's shards."""
        for b_key in snap:
            if int(b_key) % self.mesh.size:
                raise ValueError(f"arena slab {b_key}: does not split into "
                                 f"{self.mesh.size} shards")
        super().restore_slabs(snap)
        names = [*_COLUMNS, *_EPI_COLUMNS]
        for b in self._slabs:
            if b not in self._device:
                self._upload(b, names)

    def pack(self, rows: dict[str, list], quantum: int = LANE_BUCKET, *,
             device=None, dtype=None):
        """Write `rows` into the mirror, move the changed lanes onto the
        mesh, and return (Shards of QueueBatch, Shards of SLOTargets,
        Shards of EpilogueBatch | None) of padded_lanes(C) lanes in all.
        `device` is the mesh's (ignored); a `dtype` other than the
        arena's re-stages every slab in it."""
        from ..parallel.mesh import Shards, padded_lanes

        if dtype is not None and resolve_dtype(dtype) != self.dtype:
            self.dtype = resolve_dtype(dtype)
            self._device = {}
        c = len(rows["alpha"])
        if "occupancy" not in rows:
            rows = dict(rows)
            rows["occupancy"] = [int(m) * (1 + MAX_QUEUE_TO_BATCH_RATIO)
                                 for m in rows["max_batch"]]
        with_epi = "demand" in rows
        b = padded_lanes(c, quantum, self.mesh.size)
        fresh = b not in self._slabs
        slab = self._slab(b)
        columns = dict(_COLUMNS)
        if with_epi:
            columns.update(_EPI_COLUMNS)

        # diff the incoming rows against the host mirror, then update it:
        # the mirror always holds [0, c) real lanes + [c, b) benign fills
        changed = np.zeros(b, dtype=bool)
        for name, (dt, fill) in columns.items():
            new = np.full(b, fill, dtype=dt)
            if name == "valid":
                new[:c] = True
            else:
                new[:c] = rows[name]
            buf = slab[name]
            changed |= new != buf
            buf[:] = new
        self.packs += 1

        names = list(columns)
        device = self._device.get(b)
        if fresh or device is None or any(n not in device for n in names):
            self._upload(b, names)
        else:
            idx = np.nonzero(changed)[0]
            if idx.size == 0:
                self.noop_packs += 1
            else:
                self.lanes_scattered += int(idx.size)
                self.scatter_packs += 1
                self._scatter(b, names, idx)
        device = self._device[b]

        def shards(cls, fields):
            return Shards(cls(*(device[f][i] for f in fields))
                          for i in range(self.mesh.size))

        q = shards(QueueBatch, _QUEUE_FIELDS)
        slo = shards(SLOTargets, ("ttft", "itl", "tps"))
        if not with_epi:
            return q, slo, None
        return q, slo, shards(EpilogueBatch,
                              ("demand", "min_replicas", "cost_rate"))

    def _scatter(self, b: int, names, idx: np.ndarray) -> None:
        """Copy the mirror's values at lanes `idx` into the resident
        slabs: one index upload and one value slice per column, counted
        as such in the device audit, each shard taking its own lanes."""
        n_idx = lane_bucket(int(idx.size), SCATTER_BUCKET)
        idx_p = np.concatenate(
            [idx, np.full(n_idx - idx.size, idx[0], idx.dtype)])
        DEVICE_AUDIT.note_transfer("h2d", 1 + len(names),
                                   shards=self.mesh.size)
        slab, device = self._slabs[b], self._device[b]
        per = b // self.mesh.size
        for i, dev in enumerate(self.mesh.devices):
            mine = idx_p[(idx_p >= i * per) & (idx_p < (i + 1) * per)]
            if mine.size == 0:
                continue
            local = torch.tensor(mine - i * per, dtype=torch.long,
                                 device=dev)
            for name in names:
                vals = torch.tensor(slab[name][mine],
                                    dtype=self._torch_dtype(name),
                                    device=dev)
                device[name][i].index_copy_(0, local, vals)
        # as the reference's scatter does, keep only the columns this pack
        # staged: a later pack that needs another column uploads afresh
        self._device[b] = {name: device[name] for name in names}
