"""Batched queueing solve and SLO sizing in PyTorch.

Counterpart of the reference package's `ops/batched.py`: B independent
state-dependent M/M/1/K queues, one per (variant, slice-shape)
candidate, solved together. The steady state is log-space and FACTORED
(`SolveBasis`): the head states 1..H, where the service rate still
varies with the filling batch, live on an explicit grid; the
constant-rate tail is geometric and every reduction over it is a closed
form. The sizing is a fixed-trip vectorised bisection with TTFT and ITL
searches stacked into one 2B-wide problem.

Plain functions on tensors: every tensor of a batch lives on one device
and has one float dtype (float32 by default, float64 for parity runs).
The operation order of the reference is kept, so float64 results agree
with it to ~1e-9. The bisection trip loop runs here as a Python loop
(the `"batched"` backend); `ops/bisect_kernel.py` runs it as a CUDA
kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device, resolve_dtype
from .queueing import EPSILON, MAX_QUEUE_TO_BATCH_RATIO, STABILITY_SAFETY_FRACTION
from .search import MAX_ITERATIONS, TOLERANCE


class QueueBatch(NamedTuple):
    """B independent queue configurations (all tensors shape [B]).

    max_batch is the per-queue batch bound N (int32); occupancy the state
    bound K = N * (1 + MAX_QUEUE_TO_BATCH_RATIO) (int32); `valid` masks
    padding lanes."""

    alpha: torch.Tensor       # decode base (msec)
    beta: torch.Tensor        # decode slope
    gamma: torch.Tensor       # prefill base (msec)
    delta: torch.Tensor       # prefill slope
    in_tokens: torch.Tensor   # avg input tokens
    out_tokens: torch.Tensor  # avg output tokens (>= 1)
    max_batch: torch.Tensor   # int32 N
    occupancy: torch.Tensor   # int32 K
    valid: torch.Tensor       # bool lane mask

    @property
    def batch_size(self) -> int:
        return self.alpha.shape[0]


class SLOTargets(NamedTuple):
    """Per-queue SLO targets; <= 0 disables a dimension (all shape [B])."""

    ttft: torch.Tensor  # msec
    itl: torch.Tensor   # msec
    tps: torch.Tensor   # tokens/sec


class BatchStats(NamedTuple):
    """Steady-state metrics per queue (rates per msec, times msec)."""

    throughput: torch.Tensor
    avg_resp_time: torch.Tensor
    avg_wait_time: torch.Tensor
    avg_serv_time: torch.Tensor
    avg_num_in_system: torch.Tensor
    avg_num_in_servers: torch.Tensor
    rho: torch.Tensor


class SizingResult(NamedTuple):
    """Output of size_batch (all shape [B]; rates per msec)."""

    lam_ttft: torch.Tensor
    lam_itl: torch.Tensor
    lam_tps: torch.Tensor
    lam_star: torch.Tensor       # binding rate = min of the three
    feasible: torch.Tensor       # bool: every enabled target is achievable
    throughput: torch.Tensor     # at lam_star
    avg_wait_time: torch.Tensor
    prefill_time: torch.Tensor
    token_time: torch.Tensor     # ITL at lam_star
    rho: torch.Tensor
    achieved_ttft: torch.Tensor
    achieved_itl: torch.Tensor
    achieved_tps: torch.Tensor   # tokens/msec * 1000 applied by caller


def make_queue_batch(
    alpha, beta, gamma, delta, in_tokens, out_tokens, max_batch,
    occupancy=None, valid=None, dtype=None, device=None,
) -> QueueBatch:
    """Assemble a QueueBatch from array-likes on `device` (default cuda)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)

    def f(x):
        return torch.as_tensor(np.atleast_1d(np.asarray(x, dtype=np.float64)),
                               dtype=dt, device=dev)

    def i(x):
        return torch.as_tensor(np.atleast_1d(np.asarray(x)),
                               dtype=torch.int32, device=dev)

    mb = i(max_batch)
    occ = mb * (1 + MAX_QUEUE_TO_BATCH_RATIO) if occupancy is None else i(occupancy)
    if valid is None:
        ok = torch.ones(mb.shape[0], dtype=torch.bool, device=dev)
    else:
        ok = torch.as_tensor(np.atleast_1d(np.asarray(valid, dtype=bool)),
                             device=dev)
    return QueueBatch(
        alpha=f(alpha), beta=f(beta), gamma=f(gamma), delta=f(delta),
        in_tokens=f(in_tokens), out_tokens=f(out_tokens),
        max_batch=mb, occupancy=occ, valid=ok,
    )


def _num_decode(q: QueueBatch) -> torch.Tensor:
    """Decodes per request: out-1, with the decode-only single-token
    special case."""
    nd = q.out_tokens - 1.0
    return torch.where((q.in_tokens == 0) & (q.out_tokens == 1.0), 1.0, nd)


def _per_state(x: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """Align a [B] parameter with a per-state [B, K] batch-size tensor."""
    return x[:, None] if bs.dim() == x.dim() + 1 else x


def _prefill(q: QueueBatch, bs: torch.Tensor) -> torch.Tensor:
    it = _per_state(q.in_tokens, bs)
    g = _per_state(q.gamma, bs)
    d = _per_state(q.delta, bs)
    return torch.where(it > 0, g + d * it * bs, 0.0)


def _decode(q: QueueBatch, bs: torch.Tensor) -> torch.Tensor:
    return _per_state(q.alpha, bs) + _per_state(q.beta, bs) * bs


def _transition_rates(q: QueueBatch, k_max: int) -> torch.Tensor:
    """mu[b, n]: service rate governing the n -> n+1 balance,
    n = 0..k_max-1; the batch in service is min(n+1, N)."""
    n = torch.arange(k_max, device=q.alpha.device)
    bs = torch.minimum(n[None, :] + 1, q.max_batch[:, None]).to(q.alpha.dtype)
    total = _prefill(q, bs) + _per_state(_num_decode(q), bs) * _decode(q, bs)
    return bs / total


def _rate_range(q: QueueBatch) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable arrival-rate range per queue, req/msec."""
    one = torch.ones_like(q.alpha)
    bs_n = q.max_batch.to(q.alpha.dtype)
    nd = _num_decode(q)
    r1 = one / (_prefill(q, one) + nd * _decode(q, one))
    rN = bs_n / (_prefill(q, bs_n) + nd * _decode(q, bs_n))
    return r1 * EPSILON, rN * (1.0 - EPSILON)


# Lane independence. `models/system.py _dedup_rows` solves identical lanes
# once, which is exact only if a lane's bits never depend on the batch
# around it or on the k_max bucket (the grid width). torch.cumsum and
# torch.sum on CUDA pick their thread layout from the tensor's shape, so
# their bits do; the two helpers below use only elementwise adds in an
# order fixed by the column index.


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along dim 1 by doubling steps (Hillis-Steele):
    column i adds column i - s for s = 1, 2, 4, ... Column i's value
    depends only on columns 0..i, added in an order set by i alone."""
    s = 1
    while s < x.shape[1]:
        x = torch.cat([x[:, :s], x[:, s:] + x[:, :-s]], dim=1)
        s *= 2
    return x


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum along dim 1 as an aligned pairwise tree: zero-pad the row to a
    power of two, then add neighbour pairs until one column is left.
    Trailing masked zeros add exactly nothing, so a lane's sum is the
    same under any grid width."""
    width = x.shape[1]
    pow2 = 1 << (width - 1).bit_length()
    if pow2 != width:
        x = torch.nn.functional.pad(x, (0, pow2 - width))
    while x.shape[1] > 1:
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


def _cum_log_mu(mu: torch.Tensor) -> torch.Tensor:
    """Prefix sums of log service rates (independent of the arrival
    rate, so callers hoist them out of the bisection loop)."""
    return _prefix_sum(torch.log(mu))


def head_width(k_max: int) -> int:
    """Explicit-state width of the factored solve: states 1..H on the
    grid, H+1..K on the geometric closed form. Every queue built with
    K = N*(1+ratio) has N <= H."""
    return -(-k_max // (1 + MAX_QUEUE_TO_BATCH_RATIO))


class SolveBasis(NamedTuple):
    """Arrival-rate-independent decomposition of the queue batch,
    hoisted out of the bisection loop."""

    clm_head: torch.Tensor     # [B, H] prefix log service rates, states 1..H
    log_mu_head: torch.Tensor  # [B, H] log service rates (the prefix's terms)
    log_mu_full: torch.Tensor  # [B] log full-batch service rate
    clm_anchor: torch.Tensor   # [B] prefix at each lane's own anchor state


def _solve_basis(q: QueueBatch, k_max: int) -> SolveBasis:
    log_mu = torch.log(_transition_rates(q, head_width(k_max)))
    clm = _prefix_sum(log_mu)
    n_anchor = torch.minimum(q.max_batch, q.occupancy.clamp_max(k_max))
    return SolveBasis(
        clm_head=clm,
        log_mu_head=log_mu,
        log_mu_full=torch.log(_full_batch_mu(q)),
        clm_anchor=torch.gather(
            clm, 1, (n_anchor - 1).long()[:, None])[:, 0],
    )


def _geo_sums(m_len: torch.Tensor, delta: torch.Tensor):
    """(S0, S1) = (sum_{i=0..M-1} e^{i*delta}, sum i e^{i*delta}) for
    per-lane lengths M and NON-POSITIVE delta. Closed forms via expm1,
    except |delta|*M < 1e-3, where a 4-term Faulhaber/Taylor expansion
    avoids the closed forms' cancellation. The operation order is the
    reference's, which the float64 parity depends on."""
    dtype = delta.dtype
    mf = m_len.to(dtype).clamp_min(0.0)
    k = mf - 1.0                     # series index runs 0..K = M-1
    em1_d = torch.expm1(delta)
    safe_em1 = torch.where(em1_d != 0, em1_d, 1.0)
    s0_closed = torch.expm1(mf * delta) / safe_em1
    e = torch.exp(delta)
    one_minus_e = -em1_d
    safe_sq = torch.where(one_minus_e != 0, one_minus_e * one_minus_e, 1.0)
    s1_closed = e * (1.0 - mf * e ** k + k * e ** mf) / safe_sq
    # Faulhaber power sums over i = 0..K for the Taylor branch
    j1 = k * (k + 1.0) / 2.0
    j2 = k * (k + 1.0) * (2.0 * k + 1.0) / 6.0
    j3 = j1 * j1
    j4 = k * (k + 1.0) * (2.0 * k + 1.0) * (3.0 * k * k + 3.0 * k - 1.0) \
        / 30.0
    j5 = j3 * (2.0 * k * k + 2.0 * k - 1.0) / 3.0
    d2 = delta * delta
    s0_taylor = mf + delta * j1 + d2 / 2.0 * j2 + d2 * delta / 6.0 * j3 \
        + d2 * d2 / 24.0 * j4
    s1_taylor = j1 + delta * j2 + d2 / 2.0 * j3 + d2 * delta / 6.0 * j4 \
        + d2 * d2 / 24.0 * j5
    small = torch.abs(delta) * mf < 1e-3
    s0 = torch.where(small, s0_taylor, s0_closed)
    s1 = torch.where(small, s1_taylor, s1_closed)
    empty = mf < 1.0
    return torch.where(empty, 0.0, s0), torch.where(empty, 0.0, s1)


def _probs(q: QueueBatch, clm: torch.Tensor, lam: torch.Tensor,
           k_max: int) -> torch.Tensor:
    """Normalized steady-state distribution p[b, n] over 0..k_max,
    log-space; states past each queue's occupancy masked out."""
    dtype = clm.dtype
    dev = clm.device
    lam = lam.to(dtype)
    safe_lam = lam.clamp_min(torch.finfo(dtype).tiny)
    n_tail = torch.arange(1, k_max + 1, dtype=dtype, device=dev)
    logp_tail = torch.log(safe_lam)[:, None] * n_tail[None, :] - clm
    logp = torch.cat(
        [torch.zeros((q.batch_size, 1), dtype=dtype, device=dev), logp_tail],
        dim=1)                                                    # [B, K+1]
    states = torch.arange(k_max + 1, device=dev)
    in_range = states[None, :] <= q.occupancy[:, None]
    logp = torch.where(in_range, logp, float("-inf"))
    logp = logp - torch.amax(logp, dim=1, keepdim=True)
    p = torch.exp(logp)
    return p / _row_sum(p)[:, None]


def _solve(q: QueueBatch, basis: SolveBasis, lam: torch.Tensor,
           k_max: int) -> BatchStats:
    """Log-space steady-state solve + statistics at rates lam [B]:
    explicit grid over the head states, geometric closed forms for the
    constant-rate tail, every tail series folded to decay."""
    clm = basis.clm_head
    dtype = clm.dtype
    dev = clm.device
    h = clm.shape[1]
    lam = lam.to(dtype)
    safe_lam = lam.clamp_min(torch.finfo(dtype).tiny)
    log_lam = torch.log(safe_lam)
    n_head = torch.arange(1, h + 1, dtype=dtype, device=dev)[None, :]
    occ = q.occupancy.clamp_max(k_max)               # the grid's state cap
    # each lane splits at ITS OWN max_batch, never at a shared grid width,
    # so its result depends only on its own columns
    n_anchor = torch.minimum(q.max_batch, occ)       # head states 1..N
    in_range = n_head <= n_anchor[:, None].to(dtype)
    anchor_f = n_anchor.to(dtype)
    anchor = anchor_f * log_lam - basis.clm_anchor
    d = log_lam - basis.log_mu_full
    m_len = (occ - n_anchor).clamp_min(0)            # tail states N+1..K
    has_tail = m_len >= 1
    mf = m_len.to(dtype)
    tail_top = anchor + torch.where(d > 0, mf * d, d)
    # overflow stabilizer without a row max: logp_n is concave in n (mu
    # is non-decreasing), so its head argmax is where log(mu) crosses
    # log(lam) -- a per-row binary search on the sorted log_mu rows
    # ('left' == the strict-< count) and one gather; the endpoints are
    # folded in as well
    n_star = torch.searchsorted(
        basis.log_mu_head.contiguous(), log_lam[:, None].contiguous(),
        side="left")[:, 0].to(torch.int32)
    n_star = torch.minimum(n_star.clamp_min(1), n_anchor)
    clm_star = torch.gather(clm, 1, (n_star - 1).long()[:, None])[:, 0]
    m = (n_star.to(dtype) * log_lam - clm_star).clamp_min(0.0)
    m = torch.maximum(m, log_lam - clm[:, 0])
    m = torch.maximum(m, anchor)
    m = torch.maximum(m, torch.where(has_tail, tail_top, float("-inf")))
    t = torch.where(in_range,
                    torch.exp(log_lam[:, None] * n_head - clm - m[:, None]),
                    0.0)
    p0 = torch.exp(-m)
    # the two head sums (every head state has n <= N, so E[min(n, N)]'s
    # head share IS the n-weighted sum)
    h_sum = _row_sum(t)
    h_n = _row_sum(n_head * t)
    pk_head = torch.exp(anchor - m)    # no tail => the cap is the anchor
    # geometric tail, series folded to the decaying direction
    s0, s1 = _geo_sums(m_len, -torch.abs(d))
    ea = torch.where(has_tail, torch.exp(tail_top - m), 0.0)
    t0 = ea * s0
    # sum_j j e^{jd} for j=1..M: ascending (d<=0) counts up from j=1,
    # descending (d>0) counts down from j=M
    tail_j = torch.where(d > 0, mf * s0 - s1, s0 + s1)
    t1 = ea * (anchor_f * s0 + tail_j)
    pk_tail = ea * torch.where(d > 0, 1.0, torch.exp((mf - 1.0) * d))
    z = p0 + h_sum + t0
    p_k = torch.where(has_tail, pk_tail, pk_head) / z
    avg_n = (h_n + t1) / z
    # E[in service] = E[min(n, N)]: the head by its n-weights, the whole
    # tail at the cap N
    nN = q.max_batch.to(dtype)
    avg_in_serv = (h_n + nN * t0) / z
    x = lam * (1.0 - p_k)
    safe_x = torch.where(x > 0, x, 1.0)
    t_sys = torch.where(x > 0, avg_n / safe_x, 0.0)
    s_sys = torch.where(x > 0, avg_in_serv / safe_x, 0.0)
    w = (t_sys - s_sys).clamp_min(0.0)
    rho = 1.0 - p0 / z
    return BatchStats(
        throughput=x, avg_resp_time=t_sys, avg_wait_time=w,
        avg_serv_time=s_sys, avg_num_in_system=avg_n,
        avg_num_in_servers=avg_in_serv, rho=rho,
    )


def _effective_concurrency(q: QueueBatch,
                           avg_serv_time: torch.Tensor) -> torch.Tensor:
    """Batched inversion of the service-time model."""
    tokens = q.out_tokens - 1.0
    numer = avg_serv_time - (q.gamma + q.alpha * tokens)
    denom = q.delta * q.in_tokens + q.beta * tokens
    nN = q.max_batch.to(q.alpha.dtype)
    conc = torch.where(denom != 0,
                       numer / torch.where(denom != 0, denom, 1.0),
                       torch.where(numer > 0, nN, 0.0))
    return torch.minimum(conc.clamp_min(0.0), nN)


def _ttft_itl(q: QueueBatch, basis: SolveBasis, lam: torch.Tensor,
              k_max: int):
    """(TTFT, ITL, stats, conc) at rates lam: one solve for both."""
    stats = _solve(q, basis, lam, k_max)
    conc = _effective_concurrency(q, stats.avg_serv_time)
    ttft = stats.avg_wait_time + _prefill(q, conc)
    itl = _decode(q, conc)
    return ttft, itl, stats, conc


def _within_tol(y: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (y == target) | (
        (target != 0)
        & (torch.abs((y - target) / torch.where(target != 0, target, 1.0))
           <= TOLERANCE))


def bisection_trips(dtype) -> int:
    """100 trips in float64; in float32 the interval collapses to
    adjacent representable values within ~48 halvings, after which mid
    is constant, so the remaining trips cannot change x_star."""
    return MAX_ITERATIONS if dtype == torch.float64 else 48


class SizingProblem(NamedTuple):
    """The stacked TTFT/ITL bisection problem with boundary outcomes
    resolved. Lanes 0..B-1 are the TTFT searches, B..2B-1 the ITL
    searches."""

    basis: SolveBasis
    q2: QueueBatch
    basis2: SolveBasis
    is_ttft: torch.Tensor     # [2B] bool
    y_targets: torch.Tensor   # [2B]
    enabled: torch.Tensor     # [2B] bool
    increasing: torch.Tensor  # [2B] bool: y grows with lam
    below: torch.Tensor       # [2B] bool: target below region -> infeasible
    lo0: torch.Tensor         # [2B]
    hi0: torch.Tensor         # [2B]
    x0: torch.Tensor          # [2B]
    done0: torch.Tensor       # [2B] bool
    lam_max: torch.Tensor     # [B]


def _full_batch_mu(q: QueueBatch) -> torch.Tensor:
    """servRate[N]: departures per msec with the batch full."""
    bs = q.max_batch.to(q.alpha.dtype)
    nd = _num_decode(q)
    return bs / (_prefill(q, bs) + nd * _decode(q, bs))


def wait_tail_probability(
    q: QueueBatch, clm: torch.Tensor, lam: torch.Tensor, k_max: int,
    threshold_ms: torch.Tensor,
) -> torch.Tensor:
    """P(queueing wait > threshold | request accepted), batched: by PASTA
    an arrival accepted in state n >= N waits Erlang(n-N+1, mu_N), and
    the Erlang survival of integer order is the partial Poisson sum
    Q(k, x) = e^-x sum_{i<k} x^i/i!, so all k come from one log-space
    prefix sum over the state axis."""
    dtype = clm.dtype
    dev = clm.device
    tiny = torch.finfo(dtype).tiny
    p = _probs(q, clm, lam, k_max)
    states = torch.arange(k_max + 1, device=dev)[None, :]
    at_n = q.max_batch[:, None]
    accepted = states < q.occupancy[:, None]   # state K arrivals are blocked
    waiting = accepted & (states >= at_n)
    x = _full_batch_mu(q) * threshold_ms.clamp_min(0.0)         # [B]
    safe_x = x.clamp_min(tiny)[:, None]
    # log term_i = -x + sum_{j<=i} (log x - log j), built from SMALL
    # per-step increments: the direct i*log(x) - lgamma(i+1) cancels two
    # large quantities and loses precision in float32
    i1 = torch.arange(1, k_max, dtype=dtype, device=dev)[None, :]  # 1..K-1
    incr = torch.log(safe_x) - torch.log(i1)                    # [B, K-1]
    log_terms = -safe_x + torch.cat(
        [torch.zeros((q.batch_size, 1), dtype=dtype, device=dev),
         _prefix_sum(incr)], dim=1)                             # [B, K]
    q_cum = torch.clamp(_prefix_sum(torch.exp(log_terms)), 0.0, 1.0)
    k_ahead = (states - at_n + 1).clamp_min(1)                  # [B, K+1]
    tail = torch.gather(q_cum, 1, (k_ahead - 1).clamp_max(k_max - 1).long())
    tail = torch.where(x[:, None] <= 0, 1.0, tail)              # Q(k,0)=1
    num = _row_sum(torch.where(waiting, p * tail, 0.0))
    den = _row_sum(torch.where(accepted, p, 0.0))
    return num / den.clamp_min(tiny)


def _stack2(q: QueueBatch, basis: SolveBasis):
    """Stack the TTFT search lanes on the ITL lanes: one [2B] problem."""
    q2 = QueueBatch(*[torch.cat([a, a]) for a in q])
    basis2 = SolveBasis(*[torch.cat([a, a]) for a in basis])
    b = q.batch_size
    dev = q.alpha.device
    is_ttft = torch.cat([torch.ones(b, dtype=torch.bool, device=dev),
                         torch.zeros(b, dtype=torch.bool, device=dev)])
    return q2, basis2, is_ttft


def _assemble_problem(
    q: QueueBatch, basis: SolveBasis, q2, basis2, is_ttft: torch.Tensor,
    y_targets: torch.Tensor, enabled: torch.Tensor, eval_y,
    increasing: torch.Tensor | None = None,
) -> SizingProblem:
    """Resolve the boundary/region outcomes: converged at a boundary ->
    that boundary; below region -> infeasible; above -> hi. Direction is
    inferred from the boundary evals unless the caller knows it (a tail
    probability can be 0 at both boundaries)."""
    lam_min, lam_max = _rate_range(q)
    lo0 = torch.cat([lam_min, lam_min])
    hi0 = torch.cat([lam_max, lam_max])

    y_lo = eval_y(lo0)
    y_hi = eval_y(hi0)
    conv_lo = _within_tol(y_lo, y_targets)
    conv_hi = _within_tol(y_hi, y_targets)
    if increasing is None:
        increasing = y_lo < y_hi
    below = torch.where(increasing, y_targets < y_lo, y_targets > y_lo) \
        & ~conv_lo & ~conv_hi
    above = torch.where(increasing, y_targets > y_hi, y_targets < y_hi) \
        & ~conv_lo & ~conv_hi
    done0 = conv_lo | conv_hi | below | above
    x0 = torch.where(conv_lo | below, lo0, hi0)
    return SizingProblem(
        basis=basis, q2=q2, basis2=basis2, is_ttft=is_ttft,
        y_targets=y_targets, enabled=enabled, increasing=increasing,
        below=below, lo0=lo0, hi0=hi0, x0=x0, done0=done0, lam_max=lam_max,
    )


def _bisect(prob: SizingProblem, eval_y, dtype) -> torch.Tensor:
    """Fixed-trip vectorised bisection shared by the mean and tail
    sizings. A frozen lane never changes again, so the loop ends early
    once every lane is frozen: the result is the full trip count's."""
    lo, hi, x_star, done = prob.lo0, prob.hi0, prob.x0, prob.done0
    for _ in range(bisection_trips(dtype)):
        if bool(done.all()):
            break
        mid = 0.5 * (lo + hi)
        y = eval_y(mid)
        conv = _within_tol(y, prob.y_targets)
        go_down = torch.where(prob.increasing, prob.y_targets < y,
                              prob.y_targets > y)
        lo = torch.where(done | go_down, lo, mid)
        hi = torch.where(done | ~go_down, hi, mid)
        x_star = torch.where(done, x_star, mid)
        done = done | conv
    return x_star


def _sizing_problem(q: QueueBatch, targets: SLOTargets, k_max: int):
    """Mean-metric sizing problem: TTFT lanes target the MEAN
    time-to-first-token, ITL lanes the mean inter-token latency. Returns
    (problem, eval_y); the same closure drives boundary resolution and
    the bisection."""
    dtype = q.alpha.dtype
    basis = _solve_basis(q, k_max)
    q2, basis2, is_ttft = _stack2(q, basis)
    y_targets = torch.cat([targets.ttft, targets.itl]).to(dtype)
    enabled = y_targets > 0

    def eval_y(lam2):
        ttft, itl, _, _ = _ttft_itl(q2, basis2, lam2, k_max)
        return torch.where(is_ttft, ttft, itl)

    prob = _assemble_problem(q, basis, q2, basis2, is_ttft, y_targets,
                             enabled, eval_y)
    return prob, eval_y


def _tail_problem(q: QueueBatch, targets: SLOTargets, k_max: int,
                  ttft_percentile: float):
    """Tail-aware sizing problem: TTFT lanes target
    P(wait > slo_ttft - prefill(quantile batch)) <= 1 - percentile, ITL
    lanes stay on the mean. A lam where the quantile prefill alone
    exceeds the SLO evaluates to tail probability 1. Both lane evals are
    increasing in lam, so the direction is forced."""
    dtype = q.alpha.dtype
    b = q.batch_size
    clm = _cum_log_mu(_transition_rates(q, k_max))
    basis = _solve_basis(q, k_max)
    q2, basis2, is_ttft = _stack2(q, basis)
    slo_ttft = targets.ttft.to(dtype)
    y_targets = torch.cat([
        torch.full((b,), 1.0 - ttft_percentile, dtype=dtype,
                   device=q.alpha.device),
        targets.itl.to(dtype),
    ])
    enabled = torch.cat([targets.ttft > 0, targets.itl > 0])

    def eval_y(lam2):
        # each half on its own [B] problem: the Erlang sweep runs only on
        # the TTFT lanes
        lam_t, lam_i = lam2[:b], lam2[b:]
        p = _probs(q, clm, lam_t, k_max)
        cum = _prefix_sum(p)
        nq = (cum < ttft_percentile).sum(dim=1).to(dtype)
        bq = torch.minimum(nq, q.max_batch.to(dtype))
        prefill_q = _prefill(q, bq)
        threshold = (slo_ttft - prefill_q).clamp_min(0.0)
        tail = wait_tail_probability(q, clm, lam_t, k_max, threshold)
        tail = torch.where(prefill_q >= slo_ttft, 1.0, tail)
        _ttft, itl, _stats, _conc = _ttft_itl(q, basis, lam_i, k_max)
        return torch.cat([tail, itl])

    prob = _assemble_problem(
        q, basis, q2, basis2, is_ttft, y_targets, enabled, eval_y,
        increasing=torch.ones(2 * b, dtype=torch.bool, device=q.alpha.device))
    return prob, eval_y


def _sizing_result(
    q: QueueBatch, targets: SLOTargets, prob: SizingProblem,
    x_star2: torch.Tensor, k_max: int,
) -> SizingResult:
    """Epilogue shared by both backends: unstack the searches, apply the
    TPS stability margin, and analyse at the binding rate."""
    dtype = q.alpha.dtype
    b = q.batch_size
    lam_max = prob.lam_max
    lam_star2 = torch.where(prob.enabled, x_star2,
                            torch.cat([lam_max, lam_max]))
    infeasible2 = prob.enabled & prob.below
    lam_ttft = lam_star2[:b]
    lam_itl = lam_star2[b:]
    infeasible = infeasible2[:b] | infeasible2[b:]

    lam_tps = torch.where(
        targets.tps > 0, lam_max * (1.0 - STABILITY_SAFETY_FRACTION), lam_max)
    lam_star = torch.minimum(torch.minimum(lam_ttft, lam_itl), lam_tps)

    ttft_f, itl_f, stats, conc = _ttft_itl(q, prob.basis, lam_star, k_max)
    pre_f = _prefill(q, conc)
    rho = torch.clamp(stats.avg_num_in_servers / q.max_batch.to(dtype),
                      0.0, 1.0)

    return SizingResult(
        lam_ttft=lam_ttft,
        lam_itl=lam_itl,
        lam_tps=lam_tps,
        lam_star=lam_star,
        feasible=~infeasible & q.valid,
        throughput=stats.throughput,
        avg_wait_time=stats.avg_wait_time,
        prefill_time=pre_f,
        token_time=itl_f,
        rho=rho,
        achieved_ttft=ttft_f,
        achieved_itl=itl_f,
        achieved_tps=stats.throughput * q.out_tokens,
    )


def size_batch(q: QueueBatch, targets: SLOTargets, k_max: int) -> SizingResult:
    """SLO-size all queues at once: per-queue max stable rates for each
    enabled target, the binding rate, feasibility, and metrics at the
    binding rate. TTFT and ITL bisections run stacked."""
    prob, eval_y = _sizing_problem(q, targets, k_max)
    x_star = _bisect(prob, eval_y, q.alpha.dtype)
    return _sizing_result(q, targets, prob, x_star, k_max)


def size_batch_tail(q: QueueBatch, targets: SLOTargets, k_max: int,
                    ttft_percentile: float = 0.95) -> SizingResult:
    """size_batch with the TTFT lane holding the PERCENTILE of TTFT, not
    its mean: max lam such that P(wait > slo_ttft - prefill) <= 1-p."""
    prob, eval_y = _tail_problem(q, targets, k_max, ttft_percentile)
    x_star = _bisect(prob, eval_y, q.alpha.dtype)
    return _sizing_result(q, targets, prob, x_star, k_max)


def _analyze_core(q: QueueBatch, rates_per_sec, k_max: int) -> dict:
    """analyze_batch's body, shared with the fused decision
    (ops/fused.py)."""
    dtype = q.alpha.dtype
    basis = _solve_basis(q, k_max)
    _, lam_max = _rate_range(q)
    lam = torch.as_tensor(rates_per_sec, dtype=dtype,
                          device=q.alpha.device) / 1000.0
    ttft, itl, stats, conc = _ttft_itl(q, basis, lam, k_max)
    rho = torch.clamp(stats.avg_num_in_servers / q.max_batch.to(dtype),
                      0.0, 1.0)
    return {
        "throughput": stats.throughput * 1000.0,
        "avg_resp_time": stats.avg_resp_time,
        "avg_wait_time": stats.avg_wait_time,
        "avg_num_in_serv": stats.avg_num_in_servers,
        "avg_prefill_time": _prefill(q, conc),
        "avg_token_time": itl,
        "ttft": ttft,
        "max_rate": lam_max * 1000.0,
        "rho": rho,
        "valid_rate": (lam > 0) & (lam <= lam_max),
    }


def analyze_batch(q: QueueBatch, rates_per_sec, k_max: int) -> dict:
    """Metrics at given request rates (req/sec) for all queues; a dict of
    [B] tensors, `valid_rate` flags rates inside (0, max]."""
    return _analyze_core(q, rates_per_sec, k_max)


def k_max_for(max_batch) -> int:
    """Static padded state bound for a set of queue configs."""
    mb = np.max(np.asarray(max_batch))
    return int(mb) * (1 + MAX_QUEUE_TO_BATCH_RATIO)


def k_max_bucket(k: int, quantum: int = 256) -> int:
    """Round a state bound up to a quantum, so drifting loads keep one
    grid width. States past each queue's occupancy are masked, so a
    larger K gives the same result."""
    return max(-(-k // quantum) * quantum, quantum)
