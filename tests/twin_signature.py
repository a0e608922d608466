"""The goodput twin's signature, and the comparison of two signatures.

A twin run's signature is what the port is held to against the JAX
package, and the card against the CPU: the score sheet
(`ScenarioResult.to_dict()`), every DecisionRecord of the run
(`DecisionRecord.to_dict()`, newest first) and the meter's per-tick ring
(`GoodputMeter.ledger()`). It imports neither package, so the port's
tests and chip_smoke.py share it.
"""

from __future__ import annotations

import json
import math

LIMIT = 10


def signature(result) -> dict:
    return {"result": result.to_dict(),
            "decisions": [r.to_dict() for r in result.decisions.records()],
            "ticks": result.meter.ledger()}


def differences(a, b, rel: float) -> list:
    """Where two signatures differ: floats beyond `rel` (relative),
    anything else unequal; at most LIMIT paths."""
    out: list = []

    def walk(x, y, at: str) -> None:
        if len(out) >= LIMIT:
            return
        if isinstance(x, dict) and isinstance(y, dict):
            if x.keys() != y.keys():
                out.append((at, sorted(set(x) ^ set(y), key=str)))
                return
            for k in x:
                walk(x[k], y[k], f"{at}/{k}")
        elif isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
            if len(x) != len(y):
                out.append((at, len(x), len(y)))
                return
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{at}[{i}]")
        elif isinstance(x, float) and isinstance(y, float):
            if not (x == y or (math.isnan(x) and math.isnan(y))
                    or math.isclose(x, y, rel_tol=rel, abs_tol=0.0)):
                out.append((at, x, y))
        elif x != y or type(x) is not type(y):
            out.append((at, x, y))

    walk(a, b, "")
    return out


def text(sig: dict) -> str:
    """The byte form two reruns must share."""
    return json.dumps(sig, sort_keys=True)
