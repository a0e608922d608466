"""Device-mesh parallelism for fleet-scale candidate analysis.

Counterpart of the reference package's `parallel/`: the candidate batch
is split over a 1-D mesh of devices, so a fleet of thousands of
(variant, slice-shape) candidates sizes on every card at once. Each
candidate's solve is independent, so there is nothing to exchange on
the forward path: every shard decides on its own device, and the packed
result is gathered once.
"""

from .mesh import (
    Mesh,
    Shards,
    analyze_batch_sharded,
    candidate_mesh,
    decide_batch_sharded,
    fleet_mesh,
    gather,
    is_lane_mesh,
    mesh_axis,
    pad_to_multiple,
    padded_lanes,
    shard_batch,
    size_batch_sharded,
)

__all__ = [
    "Mesh",
    "Shards",
    "analyze_batch_sharded",
    "candidate_mesh",
    "decide_batch_sharded",
    "fleet_mesh",
    "gather",
    "is_lane_mesh",
    "mesh_axis",
    "pad_to_multiple",
    "padded_lanes",
    "shard_batch",
    "size_batch_sharded",
]
