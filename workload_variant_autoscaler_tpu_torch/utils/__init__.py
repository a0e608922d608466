"""Cross-cutting utilities: device policy, logging, backoff, value
scrubbing."""

import math

from .backoff import (
    CIRCUIT_OPEN,
    DEADLINE,
    EXHAUSTED,
    PROMETHEUS_BACKOFF,
    RECONCILE_BACKOFF,
    RETRY,
    STANDARD_BACKOFF,
    Backoff,
    CircuitBreaker,
    CircuitOpenError,
    Deadline,
    DeadlineExceeded,
    TerminalError,
    with_backoff,
)
from .concurrency import (
    DEFAULT_FANOUT_WORKERS,
    FANOUT_ENV,
    fanout,
    fanout_workers,
)
from .device import DEFAULT_DTYPE, readback, resolve_device, resolve_dtype
from .logging import get_logger, kv


def full_name(name: str, namespace: str) -> str:
    """Unique server key: `name:namespace`."""
    return f"{name}:{namespace}"


def check_value(x: float) -> bool:
    """True when x is a usable number (neither NaN nor infinite)."""
    return not (math.isnan(x) or math.isinf(x))


def fix_value(x: float) -> float:
    """NaN/Inf scrub to 0."""
    return 0.0 if not check_value(x) else x


def parse_float_or(s, default: float = 0.0) -> float:
    """float(s), or `default` when s does not parse or is not finite."""
    try:
        v = float(s)
    except (TypeError, ValueError):
        return default
    return v if check_value(v) else default


__all__ = [
    "Backoff",
    "CIRCUIT_OPEN",
    "CircuitBreaker",
    "CircuitOpenError",
    "DEADLINE",
    "DEFAULT_DTYPE",
    "DEFAULT_FANOUT_WORKERS",
    "Deadline",
    "DeadlineExceeded",
    "EXHAUSTED",
    "FANOUT_ENV",
    "fanout",
    "fanout_workers",
    "PROMETHEUS_BACKOFF",
    "RECONCILE_BACKOFF",
    "RETRY",
    "STANDARD_BACKOFF",
    "TerminalError",
    "check_value",
    "fix_value",
    "full_name",
    "get_logger",
    "kv",
    "parse_float_or",
    "readback",
    "resolve_device",
    "resolve_dtype",
    "with_backoff",
]
