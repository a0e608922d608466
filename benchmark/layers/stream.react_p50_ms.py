"""Per push of the traced window: from when the open-loop schedule said
it was due to when the micro-cycle that took its change had published
(a refused or unpublished push reads as the whole wait); the 50th
percentile over all pushes, ms."""


def read(rec: dict):
    return rec.get("react", {}).get("p50_ms")
