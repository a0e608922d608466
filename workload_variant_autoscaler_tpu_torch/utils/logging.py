"""Structured JSON logging, level from LOG_LEVEL.

Equivalent of the reference's zap singleton (the Go reference's
internal/logger/logger.go) built on stdlib logging: JSON lines to stdout,
level parsed from the LOG_LEVEL env var, safe to call from multiple
threads.
"""

from __future__ import annotations

import json
import logging
import os
import sys

# stdlib-only by design (obs imports nothing from the repo), so this
# module-load import cannot cycle back through utils
from ..obs.trace import current_span


def _level_from_env() -> int:
    return {
        "debug": logging.DEBUG,
        "info": logging.INFO,
        "warn": logging.WARNING,
        "warning": logging.WARNING,
        "error": logging.ERROR,
    }.get(os.environ.get("LOG_LEVEL", "").lower(), logging.INFO)


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            # record.created, not time.time(): a record serialized late
            # (queued handler, slow sink) must carry the time it was
            # LOGGED, not the time it was formatted
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        # every log line inside a reconcile cycle carries the cycle's
        # trace id (obs/trace.py), so a cycle's logs, spans, and
        # DecisionRecords correlate on one key
        span = current_span()
        if span is not None:
            entry["trace_id"] = span.trace_id
            entry["span_id"] = span.span_id
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "kv", None)
        if extra:
            entry.update(extra)
        return json.dumps(entry, default=str)


def get_logger(name: str = "wva") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(JsonFormatter())
        logger.addHandler(handler)
        logger.setLevel(_level_from_env())
        logger.propagate = False
    return logger


def kv(**kwargs) -> dict:
    """Attach structured key/values: log.info("msg", extra=kv(variant=name))."""
    return {"kv": kwargs}
