"""Bisection constants: the relative tolerance that freezes a search and
the float64 trip count (copies of the reference package's
`ops/search.py` constants)."""

TOLERANCE = 1e-6
MAX_ITERATIONS = 100
