"""Flight recorder: cycle tracing + decision audit trail (no OTel dep).

Three pieces, all stdlib-only (this package imports nothing from the
rest of the repo, so utils/logging.py and the fault hooks can import it
at module load without cycles):

- `trace`: span tracer with trace/span IDs threaded through every log
  line of a cycle, a bounded ring of finished traces.
- `decision`: immutable per-variant DecisionRecords — solve inputs,
  proposed count, every clamp applied, published count — replayable to
  the published number from the record alone.
- `profile`: the per-cycle wall-clock attribution ledger (exact
  partition of the cycle wall into exclusive buckets + an unattributed
  residual), the device audit (compiles / host<->device
  transfers), the GC audit (the interpreter's collection pauses), and
  the text flamegraph renderers.
- `goodput`: the sim/live-agnostic GoodputMeter — SLO-attained
  demand-seconds over chip-cost-seconds, badput partitioned into the
  GOODPUT_* buckets; driven by the digital twin in sim time and by the
  live Reconciler per cycle, with identical arithmetic.
- `debug`: the /debug/<route> WSGI routes mounted on the metrics
  server (the route table is `debug.DEBUG_ROUTES`).
"""

from .decision import (
    CLAMP_DEGRADED_FREEZE,
    CLAMP_REPLICA_STEP,
    CLAMP_STABILIZATION,
    CLAMP_STALE_VETO,
    CLAMP_TTFT_BACKPRESSURE,
    GOODPUT_BUCKETS,
    GOODPUT_DEGRADED,
    GOODPUT_LAGGED,
    GOODPUT_OVER,
    GOODPUT_UNDER,
    GOODPUT_USEFUL,
    HELD,
    LIMITED,
    PUBLISHED,
    Clamp,
    DecisionBuilder,
    DecisionInputs,
    DecisionLog,
    DecisionRecord,
    explain_text,
    record_from_dict,
)
from .debug import DEBUG_ROUTES, debug_middleware
from .goodput import (
    DEGRADED_RUNGS,
    STALE_ZERO_RUNGS,
    GoodputMeter,
    TickSample,
    VariantLedger,
)
from .profile import (
    DEVICE_AUDIT,
    GC_AUDIT,
    GC_SPAN,
    UNATTRIBUTED,
    DeviceAudit,
    GcAudit,
    ProfileRecord,
    Profiler,
    ResidualSampler,
    build_record,
    render_profile,
    render_tree,
)
from .trace import (
    Span,
    Trace,
    Tracer,
    add_event,
    current_span,
    current_span_id,
    current_trace_id,
    set_attribute,
    span,
)

__all__ = [
    "CLAMP_DEGRADED_FREEZE",
    "CLAMP_REPLICA_STEP",
    "CLAMP_STABILIZATION",
    "CLAMP_STALE_VETO",
    "CLAMP_TTFT_BACKPRESSURE",
    "Clamp",
    "DEBUG_ROUTES",
    "DEGRADED_RUNGS",
    "DEVICE_AUDIT",
    "GC_AUDIT",
    "GC_SPAN",
    "DecisionBuilder",
    "DecisionInputs",
    "DecisionLog",
    "DecisionRecord",
    "DeviceAudit",
    "GcAudit",
    "GOODPUT_BUCKETS",
    "GOODPUT_DEGRADED",
    "GOODPUT_LAGGED",
    "GOODPUT_OVER",
    "GOODPUT_UNDER",
    "GOODPUT_USEFUL",
    "GoodputMeter",
    "HELD",
    "LIMITED",
    "PUBLISHED",
    "ProfileRecord",
    "Profiler",
    "ResidualSampler",
    "STALE_ZERO_RUNGS",
    "Span",
    "TickSample",
    "Trace",
    "Tracer",
    "UNATTRIBUTED",
    "VariantLedger",
    "add_event",
    "build_record",
    "current_span",
    "current_span_id",
    "current_trace_id",
    "debug_middleware",
    "explain_text",
    "record_from_dict",
    "render_profile",
    "render_tree",
    "set_attribute",
    "span",
]
