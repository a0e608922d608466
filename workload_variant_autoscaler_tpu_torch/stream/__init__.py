"""Streaming reconcile pieces. So far only the crash-safe checkpoint
container (`stream/checkpoint.py`), which the hierarchical engine's warm
restart uses; the streaming core itself is not ported yet."""
