"""Synchronised wall of ops.fused.decide_batch, summed per cycle (the
harness wraps each call), mean over the window's cycles."""


def read(rec: dict):
    return rec.get("decide_ms")
