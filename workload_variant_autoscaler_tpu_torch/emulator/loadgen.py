"""Open-loop load generation with piecewise time-varying rates.

Equivalent of the reference loadgen (the Go reference's
tools/vllm-emulator/loadgen.py): Poisson or deterministic arrivals, with a
rate schedule of [duration_seconds, requests_per_minute] segments — e.g.
a ShareGPT-style ramp [[60, 120], [60, 600], [60, 1200]]. Emits into the
simulation's event heap (sim mode) or over HTTP (real-time mode uses the
same schedule logic).
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Sequence

from .engine import Request, Simulation

RateSchedule = Sequence[tuple[float, float]]  # (duration_s, rpm)


def rate_at(elapsed_s: float, schedule: RateSchedule | float) -> float:
    """Current requests-per-minute at an elapsed time
    (reference loadgen.py:10-18). 0 after the schedule ends."""
    if isinstance(schedule, (int, float)):
        return float(schedule)
    marker = 0.0
    for duration, rpm in schedule:
        if elapsed_s <= marker + duration:
            return float(rpm)
        marker += duration
    return 0.0


def next_active_time(elapsed_s: float, schedule: RateSchedule | float) -> float | None:
    """Start of the next segment with rpm > 0 strictly after elapsed_s, or
    None when the schedule has no further active segments. Lets a zero-rpm
    gap pause (not kill) the generator."""
    if isinstance(schedule, (int, float)):
        return None
    marker = 0.0
    for duration, rpm in schedule:
        if marker > elapsed_s and rpm > 0:
            return marker
        marker += duration
    return None


def total_duration_s(schedule: RateSchedule | float) -> float:
    if isinstance(schedule, (int, float)):
        return float("inf")
    return sum(d for d, _ in schedule)


@dataclass
class TokenDistribution:
    """deterministic | uniform (U[1, 2*avg]) | lognormal (heavy-tailed,
    sigma=1, mean-matched — the shape of real ShareGPT length histograms;
    capped at 16*avg, the context-window stand-in)."""

    avg_input_tokens: int = 128
    avg_output_tokens: int = 128
    distribution: str = "deterministic"

    LOGNORMAL_SIGMA = 1.0
    LOGNORMAL_CAP = 16

    def _lognormal(self, rng: random.Random, avg: int) -> int:
        import math

        sigma = self.LOGNORMAL_SIGMA
        mu = math.log(max(avg, 1)) - sigma * sigma / 2.0
        v = rng.lognormvariate(mu, sigma)
        return max(1, min(int(round(v)), self.LOGNORMAL_CAP * avg))

    def __post_init__(self) -> None:
        if self.distribution not in ("deterministic", "uniform", "lognormal"):
            # a typo must not silently degrade a tail-stress benchmark to
            # deterministic lengths
            raise ValueError(
                f"unknown token distribution {self.distribution!r}; expected "
                "deterministic, uniform, or lognormal"
            )

    def sample(self, rng: random.Random) -> tuple[int, int]:
        if self.distribution == "uniform":
            return (
                max(rng.randint(1, 2 * self.avg_input_tokens), 1),
                max(rng.randint(1, 2 * self.avg_output_tokens), 1),
            )
        if self.distribution == "lognormal":
            return (
                self._lognormal(rng, self.avg_input_tokens),
                self._lognormal(rng, self.avg_output_tokens),
            )
        return self.avg_input_tokens, self.avg_output_tokens


class PoissonLoadGenerator:
    """Feeds a Simulation with Poisson (or deterministic) arrivals."""

    def __init__(
        self,
        sim: Simulation,
        schedule: RateSchedule | float,
        tokens: TokenDistribution | None = None,
        poisson: bool = True,
        seed: int = 1,
        fleet=None,  # target fleet in a multi-fleet Simulation
    ):
        self.sim = sim
        self.schedule = schedule
        self.tokens = tokens or TokenDistribution()
        self.poisson = poisson
        self.rng = random.Random(seed)
        self._ids = itertools.count()
        self.start_ms = sim.now_ms
        self.generated = 0
        self.fleet = fleet

    def _next_interval_ms(self, rpm: float) -> float:
        mean_ms = 60000.0 / rpm
        if self.poisson:
            return self.rng.expovariate(1.0 / mean_ms)
        return mean_ms

    def start(self) -> None:
        self._schedule_next()

    def _schedule_next(self) -> None:
        elapsed_s = (self.sim.now_ms - self.start_ms) / 1000.0
        rpm = rate_at(elapsed_s, self.schedule)
        if rpm <= 0:
            resume_s = next_active_time(elapsed_s, self.schedule)
            if resume_s is not None:  # idle gap: pause until the next segment
                # +1ms past the boundary: rate_at treats segment ends as
                # inclusive, so exactly-at-boundary still reads the gap
                delay_ms = (resume_s - elapsed_s) * 1000.0 + 1.0
                self.sim.schedule(delay_ms, "call", lambda _now: self._schedule_next())
            return  # else: schedule exhausted
        self.sim.schedule(self._next_interval_ms(rpm), "call", self._fire)

    def _fire(self, now_ms: float) -> None:
        in_tok, out_tok = self.tokens.sample(self.rng)
        req = Request(
            req_id=next(self._ids),
            in_tokens=in_tok,
            out_tokens=out_tok,
            arrival_ms=now_ms,
        )
        self.sim.submit(req, self.fleet)
        self.generated += 1
        self._schedule_next()


# -- real-time HTTP mode (the in-cluster loadgen Job) -----------------------


def parse_schedule(s: str) -> list[tuple[float, float]]:
    """"60:600,120:3600" -> [(60, 600), (120, 3600)] (duration_s, rpm)."""
    out = []
    for seg in s.split(","):
        duration, rpm = seg.split(":")
        out.append((float(duration), float(rpm)))
    return out


async def run_http(url: str, model: str, schedule: RateSchedule | float,
                   tokens: TokenDistribution, poisson: bool = True,
                   seed: int = 1, concurrency_limit: int = 2048) -> dict:
    """Open-loop Poisson arrivals against an OpenAI-compatible endpoint
    (the reference loadgen's request loop, async instead of threaded).
    Returns summary stats."""
    import asyncio

    import aiohttp

    rng = random.Random(seed)
    sem = asyncio.Semaphore(concurrency_limit)
    stats = {"sent": 0, "ok": 0, "errors": 0, "latency_ms": []}
    start = None
    pending: set[asyncio.Task] = set()

    async def one_request(session):
        in_tok, out_tok = tokens.sample(rng)
        body = {
            "model": model,
            "messages": [{"role": "user", "content": "x " * in_tok}],
            "max_tokens": out_tok,
        }
        import time as _time

        t0 = _time.monotonic()
        try:
            async with sem, session.post(f"{url.rstrip('/')}/v1/chat/completions",
                                         json=body) as resp:
                await resp.read()
                if resp.status == 200:
                    stats["ok"] += 1
                else:
                    stats["errors"] += 1
        except Exception:  # noqa: BLE001 — load tools count, don't crash
            stats["errors"] += 1
        stats["latency_ms"].append((_time.monotonic() - t0) * 1000.0)

    import time as _time

    start = _time.monotonic()
    async with aiohttp.ClientSession(
        timeout=aiohttp.ClientTimeout(total=600)
    ) as session:
        while True:
            elapsed = _time.monotonic() - start
            rpm = rate_at(elapsed, schedule)
            if rpm <= 0:
                resume = next_active_time(elapsed, schedule)
                if resume is None:
                    break
                await asyncio.sleep(resume - elapsed + 0.001)
                continue
            mean_s = 60.0 / rpm
            wait = rng.expovariate(1.0 / mean_s) if poisson else mean_s
            await asyncio.sleep(wait)
            task = asyncio.ensure_future(one_request(session))
            pending.add(task)
            task.add_done_callback(pending.discard)
            stats["sent"] += 1
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)

    lat = sorted(stats.pop("latency_ms"))
    if lat:
        stats["p50_ms"] = lat[len(lat) // 2]
        stats["p95_ms"] = lat[int(len(lat) * 0.95)]
    return stats


def main(argv=None) -> int:
    import argparse
    import asyncio
    import json as _json

    parser = argparse.ArgumentParser(description="open-loop HTTP load generator")
    parser.add_argument("--url", required=True, help="emulator/server base URL")
    parser.add_argument("--model", required=True)
    parser.add_argument("--schedule", required=True,
                        help='piecewise "seconds:rpm,seconds:rpm" ramp')
    parser.add_argument("--input-tokens", type=int, default=128)
    parser.add_argument("--output-tokens", type=int, default=128)
    parser.add_argument("--distribution", default="deterministic",
                        choices=["deterministic", "uniform", "lognormal"])
    parser.add_argument("--deterministic-arrivals", action="store_true")
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)

    stats = asyncio.run(run_http(
        args.url, args.model, parse_schedule(args.schedule),
        TokenDistribution(args.input_tokens, args.output_tokens,
                          args.distribution),
        poisson=not args.deterministic_arrivals, seed=args.seed,
    ))
    print(_json.dumps(stats))
    return 0 if stats.get("errors", 0) == 0 else 1


if __name__ == "__main__":
    main()
