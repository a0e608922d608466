"""Device policy helpers."""

from .device import DEFAULT_DTYPE, readback, resolve_device, resolve_dtype

__all__ = ["DEFAULT_DTYPE", "readback", "resolve_device", "resolve_dtype"]
