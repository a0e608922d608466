"""The knob rule every module of the port reads its settings by."""

from __future__ import annotations

import os
from typing import Optional


def knob(key: str, cm: Optional[dict] = None) -> str:
    """Knob `key` as written: the environment's value unless it is empty,
    else the operator ConfigMap's (`cm`), else "" (the reference's
    env-over-ConfigMap precedence, controller.go:516-538). A value of
    blanks is not empty, so it wins. Each caller strips, parses and
    applies its own default."""
    return os.environ.get(key) or (cm or {}).get(key) or ""
