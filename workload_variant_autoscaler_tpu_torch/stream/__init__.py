"""Streaming reconcile pieces. So far the crash-safe checkpoint
container (`stream/checkpoint.py`), which the hierarchical engine's warm
restart uses, and the engine's long-lived state (`stream/state.py`),
which the Reconciler keeps; the streaming core itself is not ported
yet."""
