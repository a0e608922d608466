"""ctypes bindings for the native (host C++) queueing library.

Counterpart of the reference package's `ops/native.py`. The library
(`csrc/wva_queueing.cpp`, a verbatim copy of the reference's
`native/wva_queueing.cpp`) mirrors the scalar analyzer's semantics
exactly; ops/_build.py compiles it with g++ at first use into
`build/torch_kernels/`, or `WVA_NATIVE_LIB` names a pre-built `.so`.
`NativeQueueAnalyzer` has the analyze/size surface of
`ops.analyzer.QueueAnalyzer`, and `size_batch_native` sizes n candidates
in one FFI call. `available()` is False only where no compiler or
library exists; callers then keep to the other backends. This is the
host path of `System.calculate(backend="native")`: numpy on the host,
no device, one FFI call per sizing group.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from . import _build
from .analyzer import (
    AnalysisMetrics,
    InfeasibleTargetError,
    QueueConfig,
    RequestSize,
    SizeResult,
    TargetPerf,
)

_LIB_ENV = "WVA_NATIVE_LIB"  # pre-built .so override
_NAME = "wva_queueing"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        env = os.environ.get(_LIB_ENV)
        try:
            if env and Path(env).exists():
                lib = _build.load_prebuilt(Path(env), _NAME)
            else:
                lib = _build.library(_NAME)
        except (OSError, RuntimeError, AttributeError):
            # RuntimeError: no g++ or a failed build; AttributeError: a
            # symbol is missing (WVA_NATIVE_LIB points at a .so built from
            # an older source). Callers log 'kernel unavailable' and keep
            # to another backend; the reconcile loop never crashes here.
            _load_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _metrics_from(buf, offset: int = 0) -> AnalysisMetrics:
    return AnalysisMetrics(
        throughput=buf[offset + 0],
        avg_resp_time=buf[offset + 1],
        avg_wait_time=buf[offset + 2],
        avg_num_in_serv=buf[offset + 3],
        avg_prefill_time=buf[offset + 4],
        avg_token_time=buf[offset + 5],
        max_rate=buf[offset + 6],
        rho=buf[offset + 7],
    )


class NativeQueueAnalyzer:
    """Drop-in analyze/size on the native library (the dataclasses of
    ops.analyzer.QueueAnalyzer)."""

    def __init__(self, config: QueueConfig, size: RequestSize):
        config.validate()
        size.validate()
        lib = _load()
        if lib is None:
            raise RuntimeError("native queueing kernel unavailable")
        self._lib = lib
        self.config = config
        self.request_size = size
        self.occupancy = config.max_queue_size + config.max_batch_size

    def _args(self):
        p = self.config.parms
        return (p.alpha, p.beta, p.gamma, p.delta,
                self.request_size.avg_input_tokens,
                self.request_size.avg_output_tokens,
                self.config.max_batch_size, self.occupancy)

    def analyze(self, request_rate: float) -> AnalysisMetrics:
        buf = (ctypes.c_double * 8)()
        rc = self._lib.wva_analyze(*self._args(), request_rate, buf)
        if rc == -2:
            raise ValueError(f"rate={request_rate} above max allowed rate")
        if rc != 0:
            raise ValueError(f"invalid analyze input (rc={rc})")
        return _metrics_from(buf)

    def size(self, target: TargetPerf,
             ttft_percentile: float | None = None) -> SizeResult:
        target.validate()
        buf = (ctypes.c_double * 11)()
        if ttft_percentile is not None:
            rc = self._lib.wva_size_tail(
                *self._args(), target.ttft, target.itl, target.tps,
                float(ttft_percentile), buf)
        else:
            rc = self._lib.wva_size(*self._args(), target.ttft, target.itl,
                                    target.tps, buf)
        if rc == 1:
            raise InfeasibleTargetError(
                f"TTFT target {target.ttft} below bounded region")
        if rc == 2:
            raise InfeasibleTargetError(
                f"ITL target {target.itl} below bounded region")
        if rc != 0:
            raise ValueError(f"invalid size input (rc={rc})")
        metrics = _metrics_from(buf, offset=3)
        achieved = TargetPerf(
            ttft=metrics.avg_wait_time + metrics.avg_prefill_time,
            itl=metrics.avg_token_time,
            tps=metrics.throughput * self.request_size.avg_output_tokens,
        )
        return SizeResult(rate_ttft=buf[0], rate_itl=buf[1], rate_tps=buf[2],
                          metrics=metrics, achieved=achieved)


def size_batch_native(alpha, beta, gamma, delta, in_tokens, out_tokens,
                      max_batch, occupancy, ttft, itl, tps,
                      ttft_percentile=None):
    """Sizing of n candidates in one FFI call. Returns (out[n, 11],
    feasible[n]): out rows are [rate_ttft, rate_itl, rate_tps, 8 metric
    slots]. With ttft_percentile, the TTFT lane holds that percentile of
    the TTFT distribution (wva_size_tail, the host twin of
    ops.batched.size_batch_tail)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native queueing kernel unavailable")

    def as_f64(a):
        return np.ascontiguousarray(a, dtype=np.float64)

    def as_i32(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    alpha, beta, gamma, delta = map(as_f64, (alpha, beta, gamma, delta))
    ttft, itl, tps = map(as_f64, (ttft, itl, tps))
    in_tokens, out_tokens, max_batch, occupancy = map(
        as_i32, (in_tokens, out_tokens, max_batch, occupancy))
    n = alpha.shape[0]
    out = np.zeros((n, 11), dtype=np.float64)
    feasible = np.zeros(n, dtype=np.int32)

    PD = ctypes.POINTER(ctypes.c_double)
    PI = ctypes.POINTER(ctypes.c_int32)
    common = (
        alpha.ctypes.data_as(PD), beta.ctypes.data_as(PD),
        gamma.ctypes.data_as(PD), delta.ctypes.data_as(PD),
        in_tokens.ctypes.data_as(PI), out_tokens.ctypes.data_as(PI),
        max_batch.ctypes.data_as(PI), occupancy.ctypes.data_as(PI),
        ttft.ctypes.data_as(PD), itl.ctypes.data_as(PD),
        tps.ctypes.data_as(PD),
    )
    if ttft_percentile is None:
        lib.wva_size_batch(*common, n, out.ctypes.data_as(PD),
                           feasible.ctypes.data_as(PI))
    else:
        lib.wva_size_tail_batch(*common, float(ttft_percentile), n,
                                out.ctypes.data_as(PD),
                                feasible.ctypes.data_as(PI))
    return out, feasible.astype(bool)
