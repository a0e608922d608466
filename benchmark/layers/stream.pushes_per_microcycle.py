"""Pushes the door accepted over the scoped micro-cycles the core ran in
the window: how many pushes the debounce coalesces into one cycle."""


def read(rec: dict):
    s = rec.get("stream", {})
    if not s.get("microcycles"):
        return None
    return s["accepted"] / s["microcycles"]
