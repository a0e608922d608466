"""Candidate- and variant-axis sharding helpers.

Counterpart of the reference package's `parallel/mesh.py`. One mesh axis
is enough: each (variant, slice-shape) candidate's queue solve is
independent, so splitting the batch dimension is the whole story. Lane
padding reuses QueueBatch.valid, so padded lanes are benign (batch=1
queues marked invalid) and excluded from feasibility downstream.

A `Mesh` is the port's own small hashable class: a tuple of
`torch.device`s and one axis name. Two axis bindings share the helpers
below:

- "candidates" (`candidate_mesh`): the per-group candidate axis of
  WVA_MESH_DEVICES; a group pads to a multiple of the mesh size.
- "lanes" (`fleet_mesh`): the variant/lane axis the fleet grows along
  (WVA_SHARDED_FLEET); padding lands per shard, each shard's lane count
  a multiple of the lane quantum, so shard shapes stay bucket-stable
  under fleet churn.

A sharded call splits the lane axis into `mesh.size` contiguous shards
(a `Shards` tuple: one batch per shard, each on its shard's device),
runs the port's own decide_batch / size_stage / analyze_batch on every
shard, so on `cuda` each shard launches the bisection kernels on its
card, and gathers the result to the mesh's first device. The mesh may
list one device several times; production meshes come only from
`candidate_mesh` / `fleet_mesh`, which list each local device once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import fused
from ..ops.batched import QueueBatch, SizingResult, SLOTargets, analyze_batch
from ..utils.device import resolve_device

AXIS = "candidates"
LANE_AXIS = "lanes"


def _indexed(dev: torch.device) -> torch.device:
    """`cuda` names the current card, as a tensor's device does."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: its devices in shard order and its axis name.
    Equal (and hashing equal) exactly when both match, so a cache keyed
    on it never serves a mesh of another size or axis."""

    devices: tuple
    axis: str = AXIS

    def __post_init__(self) -> None:
        devices = tuple(_indexed(torch.device(d)) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if self.axis not in (AXIS, LANE_AXIS):
            raise ValueError(f"unknown mesh axis {self.axis!r}")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)


def _local_devices(device=None) -> list:
    """Every local device of `device`'s type: each card on `cuda` (the
    default; raises without CUDA), the one host on `cpu`."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def candidate_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A 1-D candidate mesh over the first n (default: all) local
    devices."""
    devices = _local_devices(device)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(tuple(devices), AXIS)


def fleet_mesh(n_devices: Optional[int] = None,
               device=None) -> Optional[Mesh]:
    """A 1-D mesh binding the variant/lane axis over the first n
    (default: all) local devices. None with fewer than two devices: a
    one-device lane mesh is the unsharded program with extra dispatch,
    so it degenerates to the plain path instead."""
    devices = _local_devices(device)
    if n_devices is not None:
        devices = devices[:n_devices]
    if len(devices) < 2:
        return None
    return Mesh(tuple(devices), LANE_AXIS)


def mesh_axis(mesh: Mesh) -> str:
    """The (single) data axis name of a candidate or lane mesh."""
    return mesh.axis


def is_lane_mesh(mesh: Optional[Mesh]) -> bool:
    """True when `mesh` binds the variant/lane axis (fleet sharding)."""
    return mesh is not None and mesh_axis(mesh) == LANE_AXIS


def padded_lanes(b: int, m: int, shards: int) -> int:
    """Total lane count after per-shard padding: each of `shards` equal
    contiguous shards holds a multiple of m (and at least m) lanes."""
    per = -(-max(b, 1) // shards)
    per = max(-(-per // m) * m, m)
    return per * shards


def _pad_1d(a: torch.Tensor, fill, pad: int) -> torch.Tensor:
    return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                    device=a.device)])


def pad_to_multiple(q: QueueBatch, targets: SLOTargets, m: int,
                    shards: int = 1):
    """Pad the candidate batch to a multiple of m with invalid benign
    lanes (alpha=1, max_batch=1, valid=False). Returns (q, targets,
    original_b). With shards > 1 the padding lands per shard instead: the
    batch grows to `padded_lanes(b, m, shards)`."""
    b = q.batch_size
    pad = (padded_lanes(b, m, shards) - b) if shards > 1 else (-b) % m
    if pad == 0:
        return q, targets, b

    def pad_with(a, fill):
        return _pad_1d(a, fill, pad)

    q = QueueBatch(
        alpha=pad_with(q.alpha, 1.0),
        beta=pad_with(q.beta, 0.0),
        gamma=pad_with(q.gamma, 0.0),
        delta=pad_with(q.delta, 0.0),
        in_tokens=pad_with(q.in_tokens, 0.0),
        out_tokens=pad_with(q.out_tokens, 2.0),
        max_batch=pad_with(q.max_batch, 1),
        occupancy=pad_with(q.occupancy, 1),
        valid=pad_with(q.valid, False),
    )
    targets = SLOTargets(
        ttft=pad_with(targets.ttft, 0.0),
        itl=pad_with(targets.itl, 0.0),
        tps=pad_with(targets.tps, 0.0),
    )
    return q, targets, b


class Shards(tuple):
    """A batch (QueueBatch, SLOTargets or EpilogueBatch) split along its
    lane axis: one batch of the same type per mesh shard, in shard
    order, each on its shard's device."""

    @property
    def batch_size(self) -> int:
        return sum(part[0].shape[0] for part in self)


def shard_batch(tree, mesh: Mesh) -> Shards:
    """Split every field of `tree` into mesh.size equal contiguous shards,
    each on its shard's device. A `Shards` already laid out on this mesh
    (the fleet arena's resident slabs) passes through without a copy."""
    if isinstance(tree, Shards):
        if len(tree) != mesh.size or any(
                part[0].device != dev
                for part, dev in zip(tree, mesh.devices)):
            raise ValueError("batch is sharded over another mesh")
        return tree
    b = tree[0].shape[0]
    if b % mesh.size:
        raise ValueError(f"{b} lanes do not split into {mesh.size} equal "
                         "shards; pad first (pad_to_multiple)")
    per = b // mesh.size
    return Shards(
        type(tree)(*(a[i * per:(i + 1) * per].to(dev) for a in tree))
        for i, dev in enumerate(mesh.devices))


def gather(parts, mesh: Mesh) -> torch.Tensor:
    """Concatenate per-shard tensors along their last (lane) axis on the
    mesh's first device."""
    first = mesh.devices[0]
    return torch.cat([p.to(first) for p in parts], dim=-1)


def _gather_tree(parts: list, mesh: Mesh, b: int):
    """One NamedTuple (or dict) of per-shard results gathered and cut to
    the first b lanes."""
    if isinstance(parts[0], dict):
        return {k: gather([p[k] for p in parts], mesh)[..., :b]
                for k in parts[0]}
    return type(parts[0])(*(gather(col, mesh)[..., :b]
                            for col in zip(*parts)))


def size_batch_sharded(
    q: QueueBatch, targets: SLOTargets, k_max: int, mesh: Mesh,
    ttft_percentile: Optional[float] = None, backend: str = "kernel",
) -> SizingResult:
    """The sizing stage (fused.size_stage) with the candidate axis split
    over `mesh`: pads to a multiple of the mesh size, sizes every shard
    on its device, gathers, and cuts the padding back off. Padded lanes
    come back feasible=False through the valid mask."""
    if isinstance(q, Shards):
        b = q.batch_size
    else:
        q, targets, b = pad_to_multiple(q, targets, mesh.size)
    qs, ts = shard_batch(q, mesh), shard_batch(targets, mesh)
    parts = [fused.size_stage(qi, ti, k_max, ttft_percentile, backend)
             for qi, ti in zip(qs, ts)]
    return _gather_tree(parts, mesh, b)


def analyze_batch_sharded(q: QueueBatch, rates_per_sec, k_max: int,
                          mesh: Mesh) -> dict:
    """analyze_batch with the candidate axis split over `mesh`: the
    per-replica re-analysis runs on the devices the sizing ran on."""
    rates = np.asarray(torch.as_tensor(rates_per_sec).cpu(),
                       dtype=np.float64)
    if isinstance(q, Shards):
        b = q.batch_size
    else:
        b = q.batch_size
        pad = (-b) % mesh.size
        if pad:
            # zero-rate padded lanes ride the benign invalid queues and
            # are flagged by valid_rate downstream
            zeros = torch.zeros(b, dtype=q.alpha.dtype, device=q.alpha.device)
            q, _t, _b = pad_to_multiple(
                q, SLOTargets(ttft=zeros, itl=zeros, tps=zeros), mesh.size)
    rates = np.concatenate([rates, np.zeros(q.batch_size - rates.shape[0])])
    parts, at = [], 0
    for qi in shard_batch(q, mesh):
        n = qi.batch_size
        parts.append(analyze_batch(qi, rates[at:at + n], k_max))
        at += n
    return _gather_tree(parts, mesh, b)


def decide_batch_sharded(q: QueueBatch, targets: SLOTargets, epi,
                         k_max: int, mesh: Mesh,
                         ttft_percentile: Optional[float] = None,
                         backend: str = "kernel") -> torch.Tensor:
    """The decision of one sizing group (fused.decide_batch) with the
    candidate axis split over `mesh`: sizing, replica counting and the
    per-replica re-analysis all run on the device that holds each shard,
    and the packed [N_ROWS, B] result, gathered to the mesh's first
    device, is the only exchange. Padded epilogue lanes are benign zeros.

    On a lane mesh padding lands per shard; the fleet arena's inputs
    arrive as `Shards`, already padded and resident, and pass through."""
    from ..ops.arena import LANE_BUCKET

    if isinstance(q, Shards):
        orig_b = q.batch_size
    else:
        b = q.batch_size
        if is_lane_mesh(mesh):
            q, targets, orig_b = pad_to_multiple(
                q, targets, LANE_BUCKET, shards=mesh.size)
        else:
            q, targets, orig_b = pad_to_multiple(q, targets, mesh.size)
        pad = q.batch_size - b
        if pad:
            epi = fused.EpilogueBatch(
                demand=_pad_1d(epi.demand, 0.0, pad),
                min_replicas=_pad_1d(epi.min_replicas, 0, pad),
                cost_rate=_pad_1d(epi.cost_rate, 0.0, pad),
            )
    qs = shard_batch(q, mesh)
    ts = shard_batch(targets, mesh)
    es = shard_batch(epi, mesh)
    packed = [fused.decide_batch(qi, ti, ei, k_max,
                                 ttft_percentile=ttft_percentile,
                                 backend=backend)
              for qi, ti, ei in zip(qs, ts, es)]
    return gather(packed, mesh)[:, :orig_b]
