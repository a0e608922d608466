"""Real-time HTTP emulator server (OpenAI-compatible + /metrics).

Equivalent of the reference's FastAPI emulator server
(the Go reference's tools/vllm-emulator/server.py) on aiohttp:

- POST /v1/chat/completions — requests flow through the same discrete-event
  engine, paced in wall-clock time,
- GET  /metrics — Prometheus exposition of the `vllm:*` series,
- GET  /api/v1/query — optional built-in PromQL shim answering exactly the
  collector's five aggregate queries from the local counters, so the
  controller CLI can run a full loop against this one process without a
  Prometheus deployment (enable with --with-prom-api).

Configuration via env, mirroring the reference server's settings
(server.py:22-33), with batch-aware timing instead of fixed decode time:
MODEL_NAME, NAMESPACE, ALPHA/BETA/GAMMA/DELTA (msec), MAX_BATCH_SIZE,
HBM_GB, MODEL_SIZE_GB, KV_MB_PER_TOKEN, AVG_TOKENS, TOKENS_DISTRIBUTION.
"""

from __future__ import annotations

import asyncio
import itertools
import math
import os
import random
import time

from prometheus_client import generate_latest

from ..utils import get_logger, kv
from .engine import Replica, Request, SliceModelConfig
from .loadgen import TokenDistribution
from .metrics import PrometheusSink
from .simprom import SimPromAPI

log = get_logger("wva.emulator.server")


def config_from_env() -> SliceModelConfig:
    e = os.environ.get
    return SliceModelConfig(
        model_name=e("MODEL_NAME", "default"),
        slice_name=e("SLICE_NAME", "v5e-1"),
        alpha=float(e("ALPHA", "6.973")),
        beta=float(e("BETA", "0.027")),
        gamma=float(e("GAMMA", "5.2")),
        delta=float(e("DELTA", "0.1")),
        max_batch_size=int(e("MAX_BATCH_SIZE", "64")),
        hbm_gb=float(e("HBM_GB", "16")),
        model_size_gb=float(e("MODEL_SIZE_GB", "8")),
        kv_mb_per_token=float(e("KV_MB_PER_TOKEN", "0.5")),
    )


class RealtimeEmulator:
    """Wall-clock pacing around the engine's Replica step loop."""

    def __init__(self, config: SliceModelConfig, sink: PrometheusSink):
        self.config = config
        self.sink = sink
        self.replica = Replica(config, sink)
        self._ids = itertools.count()
        self._wake = asyncio.Event()
        self.tokens = TokenDistribution(
            avg_input_tokens=int(os.environ.get("AVG_INPUT_TOKENS", "128")),
            avg_output_tokens=int(os.environ.get("AVG_TOKENS", "128")),
            distribution=os.environ.get("TOKENS_DISTRIBUTION", "uniform"),
        )
        self.rng = random.Random()

    async def run(self) -> None:
        while True:
            if not self.replica.busy():
                self._wake.clear()
                await self._wake.wait()
            now_ms = time.monotonic() * 1000.0
            dt = self.replica.step(now_ms)
            await asyncio.sleep(dt / 1000.0)

    async def handle_request(self, in_tokens: int,
                             max_tokens: int = 0) -> Request:
        # sampled from the configured distribution, capped by the request's
        # max_tokens when given — so an HTTP loadgen's TokenDistribution
        # actually controls output lengths (the reference emulator ignores
        # max_tokens entirely, server.py:92)
        out_tokens = self.tokens.sample(self.rng)[1]
        if max_tokens > 0:
            out_tokens = min(out_tokens, max_tokens)
        done = asyncio.Event()
        req = Request(
            req_id=next(self._ids),
            in_tokens=in_tokens,
            out_tokens=out_tokens,
            arrival_ms=time.monotonic() * 1000.0,
            on_finish=lambda _r: done.set(),
        )
        self.replica.enqueue(req, req.arrival_ms)
        self._wake.set()
        await done.wait()
        return req


def _fault_plan_from_env():
    """WVA_FAULT_PLAN: a path to a FaultPlan JSON file, or inline JSON —
    the scripted chaos schedule (docs/robustness.md) applied to the
    built-in PromQL shim. Same plan format the chaos test suite runs, so
    a degradation scenario can be replayed against this live server.
    A bad plan is a startup error, not a silent no-chaos run."""
    raw = os.environ.get("WVA_FAULT_PLAN", "").strip()
    if not raw:
        return None
    from ..faults import FaultPlan

    if not raw.lstrip().startswith("{"):
        with open(raw) as f:
            raw = f.read()
    plan = FaultPlan.from_json(raw)
    log.warning("fault plan attached to the PromQL shim",
                extra=kv(rules=len(plan.rules), seed=plan.seed))
    return plan


def build_app(config: SliceModelConfig | None = None, with_prom_api: bool = False,
              metric_family: str = "vllm"):
    from aiohttp import web

    from ..collector import METRIC_FAMILIES

    config = config or config_from_env()
    namespace = os.environ.get("NAMESPACE", "default")
    sink = PrometheusSink(config.model_name, namespace, family=metric_family)
    emulator = RealtimeEmulator(config, sink)
    prom_shim = SimPromAPI(sink, config.model_name, namespace,
                           family=METRIC_FAMILIES[metric_family],
                           fault_plan=_fault_plan_from_env()) \
        if with_prom_api else None

    async def chat_completions(request: web.Request):
        try:
            body = await request.json()
        except Exception:  # noqa: BLE001 - malformed body is a client error
            return web.json_response({"error": "invalid JSON body"}, status=400)
        if not isinstance(body, dict):
            return web.json_response({"error": "body must be a JSON object"},
                                     status=400)
        messages = body.get("messages", [])
        if not isinstance(messages, list) or any(
            not isinstance(m, dict) for m in messages
        ):
            return web.json_response(
                {"error": "messages must be a list of objects"}, status=400)
        content = messages[-1].get("content", "") if messages else ""
        if not isinstance(content, str):
            content = str(content)
        try:
            max_tokens = int(body.get("max_tokens", 0))
        except (TypeError, ValueError):
            max_tokens = 0
        req = await emulator.handle_request(in_tokens=max(len(content), 1),
                                            max_tokens=max_tokens)
        return web.json_response({
            "id": str(req.req_id),
            "object": "chat.completion",
            "created": int(time.time()),
            "model": body.get("model", config.model_name),
            "choices": [{
                "index": 0,
                "message": {
                    "role": "assistant",
                    "content": (
                        f"emulated: ttft={req.ttft_ms:.1f}ms "
                        f"e2e={req.e2e_ms:.1f}ms tokens={req.tokens_out}"
                    ),
                },
            }],
            "usage": {
                "prompt_tokens": req.in_tokens,
                "completion_tokens": req.tokens_out,
                "total_tokens": req.in_tokens + req.tokens_out,
            },
        })

    async def metrics(_request: web.Request):
        return web.Response(body=generate_latest(sink.registry),
                            content_type="text/plain")

    async def prom_query(request: web.Request):
        promql = request.query.get("query", "")
        samples = prom_shim.query(promql)
        return web.json_response({
            "status": "success",
            "data": {
                "resultType": "vector",
                "result": [
                    {"metric": s.labels, "value": [s.timestamp, str(s.value)]}
                    for s in samples
                ],
            },
        })

    async def prom_query_range(request: web.Request):
        """Matrix endpoint over the shim's scrape history — lets the
        profile fitter (wvat.fit) run against this one process."""
        try:
            promql = request.query.get("query", "")
            start = float(request.query["start"])
            end = float(request.query["end"])
            step = float(request.query["step"])
        except (KeyError, ValueError):
            return web.json_response(
                {"status": "error", "error": "start/end/step required"},
                status=400)
        if step <= 0 or end < start or (end - start) / step > 11_000:
            # step<=0 would loop the sync shim forever ON the event loop;
            # the point cap mirrors real Prometheus' 11k-sample limit
            return web.json_response(
                {"status": "error",
                 "error": "need step > 0, end >= start, <= 11000 points"},
                status=400)
        samples = prom_shim.query_range(promql, start, end, step)
        # omit NaN points (0/0 windows) like real Prometheus: bare NaN is
        # invalid JSON — strict clients would choke, and the fitter drops
        # NaN anyway so omission is equivalent
        samples = [s for s in samples if not math.isnan(s.value)]
        result = []
        if samples:
            result = [{
                "metric": samples[0].labels,
                "values": [[s.timestamp, str(s.value)] for s in samples],
            }]
        return web.json_response({
            "status": "success",
            "data": {"resultType": "matrix", "result": result},
        })

    engine_task_key = web.AppKey("engine_task", asyncio.Task)
    scrape_task_key = web.AppKey("scrape_task", asyncio.Task)

    async def start_background(app):
        app[engine_task_key] = asyncio.create_task(emulator.run())
        if prom_shim is not None:
            async def scraper():
                while True:
                    prom_shim.scrape(time.time() * 1000.0)
                    await asyncio.sleep(5.0)
            app[scrape_task_key] = asyncio.create_task(scraper())

    async def stop_background(app):
        for key in (engine_task_key, scrape_task_key):
            task = app.get(key)
            if task is not None:
                task.cancel()

    app = web.Application()
    app.router.add_post("/v1/chat/completions", chat_completions)
    app.router.add_get("/metrics", metrics)
    if with_prom_api:
        app.router.add_get("/api/v1/query", prom_query)
        app.router.add_get("/api/v1/query_range", prom_query_range)
    app.on_startup.append(start_background)
    app.on_cleanup.append(stop_background)
    return app


def main(argv=None) -> int:
    import argparse

    from aiohttp import web

    parser = argparse.ArgumentParser(description="TPU serving emulator")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--with-prom-api", action="store_true",
                        help="serve /api/v1/query from local counters")
    parser.add_argument("--metric-family", default="vllm",
                        choices=["vllm", "jetstream"],
                        help="serving-metrics dialect to export")
    args = parser.parse_args(argv)
    app = build_app(with_prom_api=args.with_prom_api,
                    metric_family=args.metric_family)
    log.info("starting emulator", extra=kv(port=args.port))
    web.run_app(app, host=args.host, port=args.port, print=None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
