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
"""

from __future__ import annotations

import base64
import math

import numpy as np
import torch

from ..obs.profile import DEVICE_AUDIT
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
