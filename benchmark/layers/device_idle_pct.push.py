"""The share of the traced window of pushes in which no operation ran on
the card: 1 - (union of device activity / window)."""


def read(rec: dict):
    tr = rec.get("trace", {})
    if not tr.get("window_s") or not tr.get("events"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
