"""Discrete-event TPU serving emulator + loadgen + sim-time Prometheus.

The GPU/TPU-free test backbone: the full collect->analyze->optimize->
actuate loop runs against this package in simulated time (tests) or in
real time over HTTP (`python -m workload_variant_autoscaler_tpu_torch.emulator`).

`emulator.twin` + `emulator.scenarios` build the fleet goodput digital
twin on top: production-shaped scenarios driving the real reconciler to
a single headline efficiency score (imported explicitly — they pull the
controller stack, which this namespace keeps out of the light path).
"""

from .engine import Fleet, MetricsSink, Replica, Request, Simulation, SliceModelConfig
from .loadgen import PoissonLoadGenerator, TokenDistribution, rate_at, total_duration_s
from .metrics import PrometheusSink, RecordingSink
from .simprom import MultiPromAPI, SimPromAPI

__all__ = [
    "Fleet",
    "MetricsSink",
    "PoissonLoadGenerator",
    "PrometheusSink",
    "RecordingSink",
    "Replica",
    "Request",
    "MultiPromAPI",
    "SimPromAPI",
    "Simulation",
    "SliceModelConfig",
    "TokenDistribution",
    "rate_at",
    "total_duration_s",
]
