"""Queueing constants of the state-dependent M/M/1/K model.

Copies of the constants the analyze path reads from the reference
package's `ops/queueing.py`; the numpy scalar analyzer is not part of
this package yet.
"""

# Small disturbance used to bound the stable rate range.
EPSILON = 1e-3

# Fraction below the max service throughput used for TPS sizing.
STABILITY_SAFETY_FRACTION = 0.1

# Maximum queue occupancy as a multiple of the max batch size: the state
# bound is K = N * (1 + ratio).
MAX_QUEUE_TO_BATCH_RATIO = 10
