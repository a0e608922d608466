"""Queueing solve, SLO sizing and the per-group decision in PyTorch, with
the sizing bisection as a CUDA kernel (bisect_kernel)."""
