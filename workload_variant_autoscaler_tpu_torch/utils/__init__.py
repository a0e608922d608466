"""Device policy helpers and value scrubbing."""

import math

from .device import DEFAULT_DTYPE, readback, resolve_device, resolve_dtype


def check_value(x: float) -> bool:
    """True when x is a usable number (neither NaN nor infinite)."""
    return not (math.isnan(x) or math.isinf(x))


def parse_float_or(s, default: float = 0.0) -> float:
    """float(s), or `default` when s does not parse or is not finite."""
    try:
        v = float(s)
    except (TypeError, ValueError):
        return default
    return v if check_value(v) else default


__all__ = ["DEFAULT_DTYPE", "check_value", "parse_float_or", "readback",
           "resolve_device", "resolve_dtype"]
