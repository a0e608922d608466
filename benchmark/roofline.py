"""The least time the card could take for the bisection kernels' work,
counted from the shapes of each launch and from the trips the
benchmark's own reference needs for these inputs (never from the
program's count of its trips), so the same work is counted whatever
implements it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full 700 W):
3.35 TB/s of HBM bandwidth and 67 TFLOP/s of FP32 outside the tensor
cores; the special-function rate (exp, log) is 16 results per clock per
SM for compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
instruction throughput table), at the 1.98 GHz boost clock over 132 SMs.

The least arithmetic of one bisection trip (as `chip_smoke.py`
counts it): per state of the row's grid 9 FP32 operations and one exp
(the mean solve); the tail form adds 6 operations per state (the CDF
scan, the count, the Erlang sums) and, per Poisson index of the wait
tail, 6 operations and one exp. Bytes: each input column and grid row
read once, each result written once.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9
FLOPS_PER_STATE, SFU_PER_STATE = 9, 1
TAIL_FLOPS_PER_STATE = 6
FLOPS_PER_ERLANG, SFU_PER_ERLANG = 6, 1

# the kernel's per-row column layout: float columns alpha, beta, gamma,
# delta, in, out, target, lo, hi, x0 (and the TTFT SLO and mu_N in the
# tail form); int32 columns N, K, is_ttft, increasing, done
F_ALPHA, F_TARGET, F_X0, F_SLO = 0, 6, 9, 10
I_NMAX, I_KOCC, I_TTFT, I_DONE = 0, 1, 2, 4


def least_seconds(form: str, trips, k_occ, n_max, k_max: int, rows: int,
                  n_float_cols: int, clm_rows: int, item: int) -> float:
    """The larger of the bytes' time and the arithmetic's time for one
    launch of `rows` rows, each row running trips[i] trips over its
    min(K, k_max) states."""
    trips = np.asarray(trips, dtype=np.float64)
    n_top = np.minimum(np.asarray(k_occ, dtype=np.float64), k_max)
    nbytes = (rows * n_float_cols * item + rows * 5 * 4
              + float(n_top[:clm_rows].sum()) * item + rows * item)
    work = float((trips * n_top).sum())
    flops = work * FLOPS_PER_STATE
    sfu = work * SFU_PER_STATE
    if form == "B2":
        n_wait = np.clip(np.minimum(np.asarray(k_occ, dtype=np.float64) - 1,
                                    n_top) - np.asarray(n_max) + 1, 0, None)
        erlang = float((trips * n_wait).sum())
        flops += work * TAIL_FLOPS_PER_STATE + erlang * FLOPS_PER_ERLANG
        sfu += erlang * SFU_PER_ERLANG
    return max(nbytes / HBM_BYTES_PER_S,
               max(flops / FP32_FLOPS_PER_S, sfu / SFU_OPS_PER_S))


def launch_work(launches: list, ref, item: int = 4) -> tuple:
    """(least seconds per kernel form, row counts per form) over the
    captured launches [(form, fcols, icols, clm rows, k_max)]. Each row
    is matched to the reference's lane by its inputs, and its trips are
    the reference's. Padding rows (no SLO to search: an SLO of 0) count no
    trips; a row that is neither padding nor any reference lane's is
    counted as unmatched, and the readers then report nothing."""
    index = ref.row_index()
    out = {"B1": 0.0, "B2": 0.0}
    rows_by = {f: {"matched": 0, "unmatched": 0, "padding": 0, "trips": 0}
               for f in out}
    for form, fcols, icols, clm_rows, k_max in launches:
        rows = fcols.shape[0]
        trips = np.zeros(rows)
        k_occ = icols[:, I_KOCC].astype(np.float64)
        n_max = icols[:, I_NMAX].astype(np.float64)
        f32 = fcols[:, F_ALPHA:F_TARGET + 1].astype(np.float32)
        count = rows_by[form]
        # the SLO a row searches for: its target in the mean form; the
        # tail form's target is the tail share, its SLO a column of its own
        slo_col = F_TARGET if form == "B1" else F_SLO
        for r in range(rows):
            if fcols[r, slo_col] == 0:
                count["padding"] += 1
                continue
            hit = index.get((f32[r].tobytes(), int(icols[r, I_NMAX]),
                             int(icols[r, I_TTFT])))
            if hit is None:
                count["unmatched"] += 1
            else:
                count["matched"] += 1
                trips[r] = hit
        count["trips"] += int(trips.sum())
        out[form] += least_seconds(form, trips, k_occ, n_max, k_max, rows,
                                   fcols.shape[1], clm_rows, item)
    return out, rows_by


def trips_note(kept: list, ref) -> str:
    """A diagnostic line: for the first launches of the window, the trips
    the reference needs against those the program's own count says its
    kernel ran (`bisect_kernel.trips_run`, read after the window; no
    metric reads it)."""
    from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel

    parts = []
    for form, fcols, icols, clm, k_max, tail_pct in kept:
        program = int(bisect_kernel.trips_run(fcols, icols, clm, k_max,
                                              tail_pct).sum())
        _least, rows = launch_work(
            [(form, fcols.double().cpu().numpy(), icols.cpu().numpy(),
              clm.shape[0], k_max)], ref)
        r = rows[form]
        parts.append(f"{form} {fcols.shape[0]} rows ({r['matched']} matched, "
                     f"{r['unmatched']} unmatched, {r['padding']} padding), "
                     f"k_max {k_max}: reference trips {r['trips']}, "
                     f"the program's trips_run {program}")
    return "first launches of the window: " + "; ".join(parts)
