"""The SLO-sizing bisection as a CUDA kernel (mean and tail forms).

Counterpart of the reference package's `ops/pallas_kernel.py`: the
48/100-trip bisection over the state-dependent M/M/1/K solve runs in one
kernel launch per form (`csrc/bisect_kernel.cu`), one thread block per
row, with the row's full-grid prefix log service rates resident in
shared memory for every trip. The prologue (boundary handling) and the
epilogue (TPS margin, final analysis) are the same `_sizing_problem` /
`_tail_problem` / `_sizing_result` helpers the `"batched"` path uses;
only the trip loop runs in the kernel.

`bisect` is the wrapper: for tensors on the CPU it runs `bisect_plain`,
the same full-grid trip loop written with torch ops; for CUDA tensors
it launches the kernel (and counts the launch in `launches`) or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .batched import (
    QueueBatch,
    SizingProblem,
    SizingResult,
    SLOTargets,
    _cum_log_mu,
    _full_batch_mu,
    _sizing_problem,
    _sizing_result,
    _tail_problem,
    _transition_rates,
    _within_tol,
    bisection_trips,
)

# per-row float columns of `fcols` (the kernel's F_* enum)
F_ALPHA, F_BETA, F_GAMMA, F_DELTA, F_IN, F_OUT, F_TARGET, F_LO, F_HI, \
    F_X0, F_SLO, F_MUN = range(12)
NF_MEAN, NF_TAIL = 10, 12
# per-row int32 columns of `icols` (the kernel's I_* enum)
I_NMAX, I_KOCC, I_TTFT, I_INC, I_DONE = range(5)
NI = 5

# the most dynamic shared memory one block may use on Hopper
SMEM_LIMIT = 227 * 1024

# kernel launches per form since the last reset_launches(); plain-version
# runs on the CPU are not launches
launches = {"mean": 0, "tail": 0}


def reset_launches() -> None:
    for form in launches:
        launches[form] = 0


def _full_clm(q: QueueBatch, k_max: int) -> torch.Tensor:
    """Full-grid prefix log service rates [B, k_max]. The batched path
    carries only the factored basis; the kernel walks every state, so
    it gets the whole grid."""
    return _cum_log_mu(_transition_rates(q, k_max))


def columns(prob: SizingProblem, rows: slice, slo=None, mun=None):
    """(fcols, icols) of the stacked problem's rows `rows`: float
    columns F_* (with slo, mun for the tail form) and int32 columns I_*,
    one contiguous row per bisection."""
    q2 = prob.q2
    f = [q2.alpha, q2.beta, q2.gamma, q2.delta, q2.in_tokens, q2.out_tokens,
         prob.y_targets, prob.lo0, prob.hi0, prob.x0]
    fcols = torch.stack([c[rows] for c in f], dim=1)
    if slo is not None:
        fcols = torch.cat([fcols, torch.stack([slo, mun], dim=1)], dim=1)
    i = [q2.max_batch, q2.occupancy, prob.is_ttft, prob.increasing,
         prob.done0]
    icols = torch.stack([c[rows].to(torch.int32) for c in i], dim=1)
    return fcols.contiguous(), icols.contiguous()


def _plain_loop(fcols, icols, clm, k_max: int, tail_pct: float | None):
    """The kernel's computation in torch ops over the full state grid:
    returns (x_star [rows], trips each row ran before it froze)."""
    dtype = fcols.dtype
    dev = fcols.device
    rows = fcols.shape[0]
    clm = clm.repeat(rows // clm.shape[0], 1)
    tiny = torch.finfo(dtype).tiny

    def col(i):
        return fcols[:, i:i + 1]

    alpha, beta, gamma, delta = col(F_ALPHA), col(F_BETA), col(F_GAMMA), \
        col(F_DELTA)
    in_tok, out_tok, target = col(F_IN), col(F_OUT), col(F_TARGET)
    n_max = icols[:, I_NMAX:I_NMAX + 1]
    k_occ = icols[:, I_KOCC:I_KOCC + 1]
    is_ttft = icols[:, I_TTFT] > 0
    increasing = icols[:, I_INC] > 0
    lane = torch.arange(k_max, device=dev)[None, :]
    n_states = lane + 1                 # lane j holds queue state n = j+1
    nf = n_states.to(dtype)
    in_range = (n_states <= k_occ) & (n_states <= k_max)
    head = n_states <= n_max            # states with n <= N (all in service)
    at_k = n_states == k_occ            # the blocking state
    n_max_f = n_max.to(dtype)
    if tail_pct is not None:
        slo, mun = col(F_SLO), col(F_MUN)
        log_i = torch.log(lane.to(dtype).clamp_min(1.0))
        waiting = in_range & (n_states >= n_max) & (n_states < k_occ)
        accepted = in_range & (n_states < k_occ)

    def eval_y(mid):
        logp = torch.where(in_range, torch.log(mid) * nf - clm, float("-inf"))
        m = torch.amax(logp, dim=1, keepdim=True).clamp_min(0.0)
        p = torch.where(in_range, torch.exp(logp - m), 0.0)
        p0 = torch.exp(-m)
        z = p0 + p.sum(dim=1, keepdim=True)
        avg_n = (nf * p).sum(dim=1, keepdim=True) / z
        head_np = torch.where(head, nf * p, 0.0).sum(dim=1, keepdim=True) / z
        head_p = (p0 + torch.where(head, p, 0.0).sum(dim=1, keepdim=True)) / z
        in_serv = head_np + (1.0 - head_p) * n_max_f
        p_k = torch.where(at_k, p, 0.0).sum(dim=1, keepdim=True) / z
        x = mid * (1.0 - p_k)
        pos = x > 0
        safe_x = torch.where(pos, x, 1.0)
        t = torch.where(pos, avg_n / safe_x, 0.0)
        s = torch.where(pos, in_serv / safe_x, 0.0)
        w = (t - s).clamp_min(0.0)
        # effective concurrency inversion + TTFT/ITL
        tokens = out_tok - 1.0
        numer = s - (gamma + alpha * tokens)
        denom = delta * in_tok + beta * tokens
        conc = torch.where(denom != 0.0,
                           numer / torch.where(denom != 0.0, denom, 1.0),
                           torch.where(numer > 0.0, n_max_f, 0.0))
        conc = torch.minimum(conc.clamp_min(0.0), n_max_f)
        pre = torch.where(in_tok > 0, gamma + delta * in_tok * conc, 0.0)
        ttft = w + pre
        itl = alpha + beta * conc
        if tail_pct is None:
            return torch.where(is_ttft[:, None], ttft, itl)[:, 0]
        # occupancy quantile -> prefill budget -> Erlang wait tail
        tail_z = tail_pct * z
        cdf = p0 + torch.cumsum(p, dim=1)
        nq = (p0 < tail_z).to(dtype) + torch.where(
            cdf < tail_z, 1.0, 0.0).sum(dim=1, keepdim=True)
        bq = torch.minimum(nq, n_max_f)
        prefill_q = torch.where(in_tok > 0, gamma + delta * in_tok * bq, 0.0)
        threshold = (slo - prefill_q).clamp_min(0.0)
        xx = mun * threshold
        safe_xx = xx.clamp_min(tiny)
        incr = torch.where(lane >= 1, torch.log(safe_xx) - log_i, 0.0)
        log_terms = -safe_xx + torch.cumsum(incr, dim=1)
        q_cum = torch.clamp(torch.cumsum(torch.exp(log_terms), dim=1),
                            0.0, 1.0)
        # Q(n - N + 1, x) for state lane n: a read at n - N
        at = lane - (n_max - 1)
        t_erl = torch.where(
            at >= 0, torch.gather(q_cum, 1, at.clamp_min(0)), 0.0)
        t_erl = torch.where(xx <= 0.0, 1.0, t_erl)   # Q(k, 0) = 1
        num = torch.where(waiting, p * t_erl, 0.0).sum(dim=1, keepdim=True)
        den = p0 + torch.where(accepted, p, 0.0).sum(dim=1, keepdim=True)
        tail_p = num / den.clamp_min(tiny)
        tail_p = torch.where(prefill_q >= slo, 1.0, tail_p)
        return torch.where(is_ttft[:, None], tail_p, itl)[:, 0]

    tgt = target[:, 0]
    lo, hi, x_star = col(F_LO)[:, 0], col(F_HI)[:, 0], col(F_X0)[:, 0]
    done = icols[:, I_DONE] > 0
    ran = torch.zeros(rows, dtype=torch.int32, device=dev)
    for _ in range(bisection_trips(dtype)):
        if bool(done.all()):
            break
        ran += (~done).to(torch.int32)
        mid = 0.5 * (lo + hi)
        y = eval_y(mid[:, None])
        conv = _within_tol(y, tgt)
        go_down = (increasing & (tgt < y)) | (~increasing & (tgt > y))
        lo = torch.where(done | go_down, lo, mid)
        hi = torch.where(done | ~go_down, hi, mid)
        x_star = torch.where(done, x_star, mid)
        done = done | conv
    return x_star, ran


def bisect_plain(fcols, icols, clm, k_max: int,
                 tail_pct: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x_star [rows]."""
    return _plain_loop(fcols, icols, clm, k_max, tail_pct)[0]


def trips_run(fcols, icols, clm, k_max: int,
              tail_pct: float | None = None) -> torch.Tensor:
    """Trips each row runs before it freezes (the kernel's early exit):
    the data-dependent work of one launch."""
    return _plain_loop(fcols, icols, clm, k_max, tail_pct)[1]


def _check(fcols, icols, clm, k_max: int, tail_pct) -> None:
    nf = NF_MEAN if tail_pct is None else NF_TAIL
    rows = fcols.shape[0]
    if fcols.dim() != 2 or fcols.shape[1] != nf:
        raise ValueError(f"fcols must be [rows, {nf}], got {tuple(fcols.shape)}")
    if icols.shape != (rows, NI) or icols.dtype != torch.int32:
        raise ValueError("icols must be int32 [rows, 5]")
    if clm.dim() != 2 or clm.shape[1] != k_max or rows % clm.shape[0]:
        raise ValueError("clm must be [R, k_max] with rows a multiple of R")
    if fcols.dtype != clm.dtype or fcols.dtype not in (torch.float32,
                                                       torch.float64):
        raise ValueError("fcols and clm must share a float32/float64 dtype")
    if not (fcols.device == icols.device == clm.device):
        raise ValueError("fcols, icols and clm must be on one device")
    if not (fcols.is_contiguous() and icols.is_contiguous()
            and clm.is_contiguous()):
        raise ValueError("fcols, icols and clm must be contiguous")


def bisect(fcols, icols, clm, k_max: int,
           tail_pct: float | None = None) -> torch.Tensor:
    """x_star [rows] of the bisection rows: the CUDA kernel for tensors on
    the card, the plain version for tensors on the CPU."""
    _check(fcols, icols, clm, k_max, tail_pct)
    if clm.device.type == "cpu":
        return bisect_plain(fcols, icols, clm, k_max, tail_pct)
    if clm.device.type != "cuda":
        raise ValueError(f"unsupported device {clm.device}")
    form = "mean" if tail_pct is None else "tail"
    dtype = clm.dtype
    smem = k_max * clm.element_size() * (1 if tail_pct is None else 3)
    if smem > SMEM_LIMIT:
        raise ValueError(f"k_max={k_max} needs {smem} bytes of shared memory "
                         f"per block; the {form} kernel takes at most "
                         f"{SMEM_LIMIT}")
    rows = fcols.shape[0]
    x_star = torch.empty(rows, dtype=dtype, device=clm.device)
    if rows == 0:
        return x_star
    lib = _build.library("bisect_kernel")
    fn = getattr(lib, f"wva_bisect_{form}_"
                      f"{'f64' if dtype == torch.float64 else 'f32'}")
    with torch.cuda.device(clm.device):
        stream = torch.cuda.current_stream(clm.device).cuda_stream
        err = fn(fcols.data_ptr(), icols.data_ptr(), clm.data_ptr(),
                 x_star.data_ptr(), rows, clm.shape[0], k_max,
                 bisection_trips(dtype),
                 0.0 if tail_pct is None else float(tail_pct), stream)
    if err != 0:
        raise RuntimeError(f"bisect kernel ({form}) launch failed: CUDA error "
                           f"{err} ({lib.wva_error_string(err).decode()})")
    launches[form] += 1
    return x_star


def size_batch_kernel(q: QueueBatch, targets: SLOTargets,
                      k_max: int) -> SizingResult:
    """`size_batch` with the trip loop in the mean-form kernel over the
    2B stacked TTFT/ITL rows."""
    b = q.batch_size
    prob, _eval_y = _sizing_problem(q, targets, k_max)
    fcols, icols = columns(prob, slice(0, 2 * b))
    x_star2 = bisect(fcols, icols, _full_clm(q, k_max), k_max)
    return _sizing_result(q, targets, prob, x_star2, k_max)


def size_batch_tail_kernel(q: QueueBatch, targets: SLOTargets, k_max: int,
                           ttft_percentile: float = 0.95) -> SizingResult:
    """`size_batch_tail` with the trip loop in the kernels: the tail form
    on the TTFT rows only, the mean form on the ITL rows, so no trip
    pays the Erlang scans on rows whose result would be discarded."""
    b = q.batch_size
    prob, _eval_y = _tail_problem(q, targets, k_max, ttft_percentile)
    clm = _full_clm(q, k_max)
    f_t, i_t = columns(prob, slice(0, b),
                       slo=targets.ttft.to(q.alpha.dtype),
                       mun=_full_batch_mu(q))
    x_ttft = bisect(f_t, i_t, clm, k_max, float(ttft_percentile))
    f_i, i_i = columns(prob, slice(b, 2 * b))
    x_itl = bisect(f_i, i_i, clm, k_max)
    return _sizing_result(q, targets, prob, torch.cat([x_ttft, x_itl]), k_max)
