"""Plain sizing of candidate lanes: the state-dependent M/M/1/K queue of
each lane solved over its whole state grid, and the SLO bisection, in
one dtype (float64 for the reference; a lower one for the control).

Written from the model's equations, not from the program's factored
solve: states n = 0..K with K = 11 N (the queue holds ten batches), the
n -> n+1 balance at service rate mu_n = b / (prefill(b) + d decode(b))
with b = min(n + 1, N) in service, log p_n = n log(lam) - sum_{i<n}
log(mu_i). The bisection freezes a lane once its metric is within a
relative 1e-6 of the target (the search's documented semantics), and
counts the trips each lane ran: the benchmark's measure of the work the
kernels have to do.

Plain torch on any device; imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

QUEUE_TO_BATCH = 10          # the queue holds ten batches beyond service
RANGE_EPSILON = 1e-3         # the searched rate range stays inside (0, mu_N)
TOLERANCE = 1e-6             # relative, on the searched metric
TRIPS = 100                  # the float64 bisection's trip bound


@dataclass
class Lanes:
    """Candidate lanes (all [L] tensors): the profile, the tokens, the
    batch bound, the SLO targets, and whether TTFT is held at the
    percentile `pct` (the tail form) or on its mean."""

    alpha: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    delta: torch.Tensor
    in_tok: torch.Tensor
    out_tok: torch.Tensor
    n_max: torch.Tensor        # int64
    slo_ttft: torch.Tensor
    slo_itl: torch.Tensor
    tail: torch.Tensor         # bool
    pct: float

    def to(self, dtype) -> "Lanes":
        f = {k: (v.to(dtype) if v.is_floating_point() else v)
             for k, v in self.__dict__.items() if isinstance(v, torch.Tensor)}
        return Lanes(**f, pct=self.pct)

    def select(self, idx) -> "Lanes":
        f = {k: v[idx] for k, v in self.__dict__.items()
             if isinstance(v, torch.Tensor)}
        return Lanes(**f, pct=self.pct)

    def __len__(self) -> int:
        return self.alpha.shape[0]


@dataclass
class Sized:
    """Per lane: the max rate per replica in req/s (the throughput at the
    binding rate), feasibility, and the trips each search ran (0 where
    the boundary decided it)."""

    rate: torch.Tensor
    feasible: torch.Tensor
    trips_ttft: torch.Tensor
    trips_itl: torch.Tensor


class Queue:
    """The explicit state grid of a block of lanes."""

    def __init__(self, ln: Lanes):
        self.ln = ln
        dt = ln.alpha.dtype
        dev = ln.alpha.device
        self.n = ln.n_max
        self.k = self.n * (1 + QUEUE_TO_BATCH)
        kmax = int(self.k.max())
        self.states = torch.arange(kmax + 1, device=dev)        # 0..K
        nf = self.n.to(dt)
        self.decodes = torch.where((ln.in_tok == 0) & (ln.out_tok == 1),
                                   torch.ones_like(ln.out_tok),
                                   ln.out_tok - 1.0)
        b = torch.minimum(self.states[None, :-1] + 1, self.n[:, None]).to(dt)
        mu = b / (self.prefill(b) + self.decodes[:, None] * self.decode(b))
        self.log_mu_cum = torch.cat(
            [torch.zeros(len(ln), 1, dtype=dt, device=dev),
             torch.cumsum(torch.log(mu), dim=1)], dim=1)       # [L, K+1]
        self.in_range = self.states[None, :] <= self.k[:, None]
        self.mu_full = nf / (self.prefill(nf) + self.decodes
                             * self.decode(nf))
        one = torch.ones_like(nf)
        mu_one = one / (self.prefill(one) + self.decodes * self.decode(one))
        self.lam_min = mu_one * RANGE_EPSILON
        self.lam_max = self.mu_full * (1.0 - RANGE_EPSILON)
        self.in_serv = torch.minimum(self.states[None, :],
                                     self.n[:, None]).to(dt)

    def prefill(self, b):
        ln = self.ln
        it = ln.in_tok if b.dim() == 1 else ln.in_tok[:, None]
        g = ln.gamma if b.dim() == 1 else ln.gamma[:, None]
        d = ln.delta if b.dim() == 1 else ln.delta[:, None]
        return torch.where(it > 0, g + d * it * b, torch.zeros_like(b))

    def decode(self, b):
        ln = self.ln
        if b.dim() == 1:
            return ln.alpha + ln.beta * b
        return ln.alpha[:, None] + ln.beta[:, None] * b

    def probs(self, lam):
        """Normalised p over 0..K per lane (masked past each lane's K)."""
        logp = (torch.log(lam)[:, None] * self.states[None, :].to(lam.dtype)
                - self.log_mu_cum)
        logp = torch.where(self.in_range, logp,
                           torch.full_like(logp, float("-inf")))
        p = torch.exp(logp - logp.amax(dim=1, keepdim=True))
        return p / p.sum(dim=1, keepdim=True)

    def mean_metrics(self, lam):
        """(TTFT, ITL, throughput) at arrival rates lam (req/ms)."""
        ln = self.ln
        p = self.probs(lam)
        p_k = torch.gather(p, 1, self.k[:, None])[:, 0]
        x = lam * (1.0 - p_k)
        avg_n = (p * self.states[None, :].to(lam.dtype)).sum(dim=1)
        avg_s = (p * self.in_serv).sum(dim=1)
        pos = x > 0
        safe_x = torch.where(pos, x, torch.ones_like(x))
        t = torch.where(pos, avg_n / safe_x, torch.zeros_like(x))
        s = torch.where(pos, avg_s / safe_x, torch.zeros_like(x))
        w = (t - s).clamp_min(0.0)
        tokens = ln.out_tok - 1.0
        numer = s - (ln.gamma + ln.alpha * tokens)
        denom = ln.delta * ln.in_tok + ln.beta * tokens
        nf = self.n.to(lam.dtype)
        conc = torch.where(denom != 0,
                           numer / torch.where(denom != 0, denom,
                                               torch.ones_like(denom)),
                           torch.where(numer > 0, nf, torch.zeros_like(nf)))
        conc = torch.minimum(conc.clamp_min(0.0), nf)
        return w + self.prefill(conc), self.decode(conc), x

    def tail_probability(self, lam):
        """P(queueing wait > slo_ttft - prefill(quantile batch) | the
        request is accepted); 1 where that prefill alone breaks the SLO."""
        ln = self.ln
        dt = lam.dtype
        p = self.probs(lam)
        cum = torch.cumsum(p, dim=1)
        nq = torch.where(self.in_range & (cum < ln.pct), 1.0, 0.0).sum(dim=1)
        bq = torch.minimum(nq.to(dt), self.n.to(dt))
        prefill_q = self.prefill(bq)
        threshold = (ln.slo_ttft - prefill_q).clamp_min(0.0)
        x = self.mu_full * threshold
        # Q(k, x) = e^-x sum_{i<k} x^i / i!, for k = 1..K
        i = self.states[:-1].to(torch.float64)
        lgam = torch.lgamma(i + 1.0).to(dt)
        log_x = torch.log(x.clamp_min(torch.finfo(dt).tiny))
        terms = torch.exp(-x[:, None] + i.to(dt)[None, :] * log_x[:, None]
                          - lgam[None, :])
        q_cum = torch.cumsum(terms, dim=1).clamp(0.0, 1.0)      # Q(i+1, x)
        k_ahead = (self.states[None, :] - self.n[:, None] + 1)   # n - N + 1
        waiting = self.in_range & (self.states[None, :] >= self.n[:, None]) \
            & (self.states[None, :] < self.k[:, None])
        accepted = self.in_range & (self.states[None, :] < self.k[:, None])
        q_at = torch.gather(q_cum, 1, (k_ahead - 1).clamp(
            0, q_cum.shape[1] - 1))
        q_at = torch.where(x[:, None] <= 0, torch.ones_like(q_at), q_at)
        num = torch.where(waiting, p * q_at, torch.zeros_like(p)).sum(dim=1)
        den = torch.where(accepted, p, torch.zeros_like(p)).sum(dim=1)
        tail = num / den.clamp_min(torch.finfo(dt).tiny)
        return torch.where(prefill_q >= ln.slo_ttft, torch.ones_like(tail),
                           tail)


def _within(y, target):
    return (y == target) | ((target != 0) & (
        torch.abs((y - target) / torch.where(target != 0, target,
                                             torch.ones_like(target)))
        <= TOLERANCE))


def _search(q: Queue, eval_y, target, increasing, trips: int):
    """(rate, below-region, trips run) of one bisection per lane."""
    lo, hi = q.lam_min.clone(), q.lam_max.clone()
    y_lo, y_hi = eval_y(lo), eval_y(hi)
    if increasing is None:
        increasing = y_lo < y_hi
    conv_lo, conv_hi = _within(y_lo, target), _within(y_hi, target)
    below = torch.where(increasing, target < y_lo, target > y_lo) \
        & ~conv_lo & ~conv_hi
    above = torch.where(increasing, target > y_hi, target < y_hi) \
        & ~conv_lo & ~conv_hi
    done = conv_lo | conv_hi | below | above
    x = torch.where(conv_lo | below, lo, hi)
    ran = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for _ in range(trips):
        if bool(done.all()):
            break
        ran += (~done).to(torch.int64)
        mid = 0.5 * (lo + hi)
        y = eval_y(mid)
        conv = _within(y, target)
        down = torch.where(increasing, target < y, target > y)
        lo = torch.where(done | down, lo, mid)
        hi = torch.where(done | ~down, hi, mid)
        x = torch.where(done, x, mid)
        done = done | conv
    return x, below, ran


def size(lanes: Lanes, trips: int = TRIPS) -> Sized:
    """Size every lane: the largest rate at which each enabled SLO holds
    (TTFT on the mean or at the percentile, ITL on the mean), and the
    throughput there in req/s."""
    q = Queue(lanes)
    dt = lanes.alpha.dtype
    tail = lanes.tail

    def ttft_y(lam):
        mean = q.mean_metrics(lam)[0]
        if not bool(tail.any()):
            return mean
        return torch.where(tail, q.tail_probability(lam), mean)

    target_t = torch.where(tail, torch.full_like(lanes.slo_ttft,
                                                 1.0 - lanes.pct),
                           lanes.slo_ttft)
    inc_t = None
    if bool(tail.all()):
        inc_t = torch.ones_like(tail)
    elif bool(tail.any()):
        raise ValueError("size() takes lanes of one form at a time")
    lam_t, below_t, trips_t = _search(q, ttft_y, target_t, inc_t, trips)
    lam_i, below_i, trips_i = _search(
        q, lambda lam: q.mean_metrics(lam)[1], lanes.slo_itl, None, trips)
    on_t, on_i = lanes.slo_ttft > 0, lanes.slo_itl > 0
    lam_t = torch.where(on_t, lam_t, q.lam_max)
    lam_i = torch.where(on_i, lam_i, q.lam_max)
    lam_star = torch.minimum(torch.minimum(lam_t, lam_i), q.lam_max)
    _ttft, _itl, x = q.mean_metrics(lam_star)
    feasible = ~((on_t & below_t) | (on_i & below_i))
    return Sized(rate=(x * 1000.0).to(dt), feasible=feasible,
                 trips_ttft=trips_t, trips_itl=trips_i)


def search_rows(alpha, beta, gamma, delta, in_tok, out_tok, n_max, target,
                is_ttft, slo_ttft=None, pct=None, trips: int = TRIPS):
    """The arrival rate (req/ms) that one bisection per row settles on:
    the rows of one kernel launch, each searching its TTFT (on the mean,
    or its tail at `pct` when given, against the TTFT SLO `slo_ttft`) or
    its mean ITL for `target`, in the dtype of the float inputs."""
    tail = pct is not None
    zero = torch.zeros_like(alpha)
    ln = Lanes(alpha=alpha, beta=beta, gamma=gamma, delta=delta,
               in_tok=in_tok, out_tok=out_tok, n_max=n_max.to(torch.int64),
               slo_ttft=slo_ttft if tail else zero, slo_itl=zero,
               tail=torch.full_like(is_ttft, tail), pct=pct or 0.0)
    q = Queue(ln)

    def eval_y(lam):
        if tail:
            return q.tail_probability(lam)
        ttft, itl, _x = q.mean_metrics(lam)
        return torch.where(is_ttft, ttft, itl)

    inc = torch.ones_like(is_ttft) if tail else None
    return _search(q, eval_y, target, inc, trips)[0]


def size_blocks(lanes: Lanes, block: int = 256, trips: int = TRIPS) -> Sized:
    """`size` in blocks of lanes of one form each, so the grids fit."""
    parts = []
    idx_all = torch.arange(len(lanes), device=lanes.alpha.device)
    order = []
    for form in (True, False):
        idx = idx_all[lanes.tail == form]
        for s in range(0, idx.shape[0], block):
            sel = idx[s:s + block]
            parts.append(size(lanes.select(sel), trips))
            order.append(sel)
    inv = torch.empty_like(idx_all)
    cat = torch.cat(order)
    inv[cat] = torch.arange(cat.shape[0], device=cat.device)

    def join(name):
        return torch.cat([getattr(p, name) for p in parts])[inv]

    return Sized(**{n: join(n) for n in ("rate", "feasible", "trips_ttft",
                                         "trips_itl")})
