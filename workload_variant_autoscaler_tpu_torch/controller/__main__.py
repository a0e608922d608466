"""Controller entry point (the reference's cmd/main.go equivalent).

Wires the REST kube client, the HTTPS Prometheus client (validated with
backoff — the controller hard-fails without Prometheus, reference
cmd/main.go + controller SetupWithManager :448-451), the TLS-capable
metrics server (cmd/main.go:122-199), health probes (:252-262), optional
Lease-based leader election (:206-218), and starts the reconcile loop.

Usage:
    python -m workload_variant_autoscaler_tpu_torch.controller \
        [--metrics-port 8443] [--health-port 8081] [--leader-elect] \
        [--config-namespace NS] [--allow-http-prom]

    python -m workload_variant_autoscaler_tpu_torch.controller explain <variant> \
        [--namespace NS] [--url http://HOST:METRICS_PORT] [--json] [--trace]

    python -m workload_variant_autoscaler_tpu_torch.controller profile \
        [--cycle N] [--url http://HOST:METRICS_PORT] [--json]

    python -m workload_variant_autoscaler_tpu_torch.controller goodput \
        [--window N] [--url http://HOST:METRICS_PORT] [--json]

The process runs its engine on the device `WVA_PLATFORM` names: unset,
empty, `cuda`, `gpu` or `ambient` is the card (startup fails without
CUDA, or when the CUDA kernel library does not build), `cpu` the host
(the native C++ backend when it builds and WVA_NATIVE_KERNEL is not
false, else the kernels' plain PyTorch versions); any other value exits
1. WVA_MESH_DEVICES and WVA_SHARDED_FLEET split the solve over the
local cards (controller/translate.py). The
kernel library is built and loaded on the main thread before the process
reports ready.

The `explain` subcommand renders a variant's latest DecisionRecord —
the solve inputs, every clamp applied, and the published replica count,
reproducible from the record alone — fetched from a running
controller's /debug/decisions endpoint (or a saved JSON dump via
--file; see docs/observability.md). `--trace` additionally renders the
decision's cycle span tree with exclusive/inclusive wall columns from
the attribution ledger (/debug/profile).

The `profile` subcommand renders a cycle's full wall-clock attribution
(docs/observability.md "Profiling"): the exact-partition bucket ledger,
a text flamegraph with exclusive/inclusive columns, the device-audit
delta, and the sampled residual itemization when WVA_PROFILE_SAMPLE_HZ
was on.

The `goodput` subcommand renders the live GoodputMeter's rolling ledger
(docs/observability.md "Live goodput"): the windowed goodput fraction,
SLO attainment, and the badput decomposition, fetched from a running
controller's /debug/goodput endpoint. Requires WVA_GOODPUT_LIVE=1 on
the controller (the route 404s when no meter is attached).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import threading
import time

import torch

from ..collector import HTTPPromAPI, PrometheusConfig, validate_prometheus_api
from ..metrics import MetricsEmitter
from ..obs import (
    debug_middleware,
    explain_text,
    record_from_dict,
    render_profile,
    render_tree,
)
from ..utils import get_logger, kv
from ..utils.device import PLATFORM_ENV, platform_device
from .kube import RestKube, in_memory_kube_from_manifests
from .reconciler import CONFIG_MAP_NAMESPACE, Reconciler
from .runtime import HealthServer, LeaderElector

def _fetch_profiles(url: str, file: str | None,
                    cycle: int | None = None) -> list[dict]:
    """The /debug/profile payload (or a saved dump): a list of
    ProfileRecord dicts, newest first."""
    if file:
        with open(file, encoding="utf-8") as f:
            payload = json.load(f)
    else:
        from urllib.parse import urlencode
        from urllib.request import urlopen

        params = {"limit": 64}
        if cycle is not None:
            params["cycle"] = cycle
        query = urlencode(params)
        full = f"{url.rstrip('/')}/debug/profile?{query}"
        with urlopen(full, timeout=10.0) as resp:  # noqa: S310 — operator-supplied URL
            payload = json.load(resp)
    profiles = payload.get("profiles", payload) \
        if isinstance(payload, dict) else payload
    return [p for p in profiles if isinstance(p, dict)]


def profile_main(argv) -> int:
    """The attribution read path: where did cycle N's wall time go.
    Exits 0 with the rendered ledger, 1 when no record exists."""
    parser = argparse.ArgumentParser(
        prog="python -m workload_variant_autoscaler_tpu_torch.controller profile",
        description="Render a reconcile cycle's wall-clock attribution "
                    "ledger from its ProfileRecord")
    parser.add_argument("--cycle", type=int, default=None,
                        help="cycle number (default: the latest profiled "
                             "cycle)")
    parser.add_argument("--url",
                        default=os.environ.get("WVA_DEBUG_URL",
                                               "http://127.0.0.1:8080"),
                        help="base URL of the controller's metrics/debug "
                             "server (default http://127.0.0.1:8080)")
    parser.add_argument("--file", default=None, metavar="PATH",
                        help="read a saved /debug/profile JSON payload "
                             "instead of querying a live controller")
    parser.add_argument("--json", action="store_true",
                        help="print the raw record JSON instead of the "
                             "rendered ledger")
    args = parser.parse_args(argv)

    profiles = _fetch_profiles(args.url, args.file, cycle=args.cycle)
    if args.cycle is not None:
        profiles = [p for p in profiles if p.get("cycle") == args.cycle]
    if not profiles:
        print("no ProfileRecord"
              + (f" for cycle {args.cycle}" if args.cycle is not None
                 else "")
              + " (rotated out of WVA_PROFILE_BUFFER, or no cycle has "
                "run yet)", file=sys.stderr)
        return 1
    record = profiles[0]
    if args.json:
        print(json.dumps(record, indent=2, default=str))
    else:
        print(render_profile(record))
    return 0


def render_goodput(payload: dict) -> str:
    """Text rendering of the /debug/goodput payload: the windowed
    headline numbers plus the badput decomposition, one line each."""
    summary = payload.get("summary", {}) if isinstance(payload, dict) else {}
    lines = [
        "goodput ledger (rolling window "
        f"{summary.get('window_s', 0.0):g} s, "
        f"{summary.get('ticks', 0)} ticks, "
        f"{summary.get('variants', 0)} variants)",
        f"  goodput fraction:  {summary.get('goodput_fraction', 0.0):.1%} "
        "of provisioned $·s was SLO-attained spend",
        f"  slo attainment:    {summary.get('slo_attainment', 0.0):.1%} "
        f"of {summary.get('demand_seconds', 0.0):.1f} demand-seconds",
        f"  provisioned cost:  {summary.get('cost_dollar_seconds', 0.0):.4f}"
        " $·s",
    ]
    badput = summary.get("badput", {}) or {}
    if badput:
        lines.append("  badput:")
        for bucket, frac in sorted(badput.items(),
                                   key=lambda kv: -kv[1]):
            lines.append(f"    {bucket:<22s} {frac:.1%}")
    else:
        lines.append("  badput:            none billed in window")
    return "\n".join(lines)


def goodput_main(argv) -> int:
    """The fleet-efficiency read path: how useful was the fleet's spend
    lately. Exits 0 with the rendered ledger, 1 when the controller has
    no live meter attached (WVA_GOODPUT_LIVE unset)."""
    parser = argparse.ArgumentParser(
        prog="python -m workload_variant_autoscaler_tpu_torch.controller goodput",
        description="Render the live GoodputMeter's rolling ledger "
                    "(goodput fraction, SLO attainment, badput buckets)")
    parser.add_argument("--window", type=int, default=None, metavar="N",
                        help="re-clip the ledger to the trailing N "
                             "seconds (default: the meter's full "
                             "WVA_GOODPUT_WINDOW_S window)")
    parser.add_argument("--url",
                        default=os.environ.get("WVA_DEBUG_URL",
                                               "http://127.0.0.1:8080"),
                        help="base URL of the controller's metrics/debug "
                             "server (default http://127.0.0.1:8080)")
    parser.add_argument("--file", default=None, metavar="PATH",
                        help="read a saved /debug/goodput JSON payload "
                             "instead of querying a live controller")
    parser.add_argument("--json", action="store_true",
                        help="print the raw payload JSON (summary + "
                             "per-tick entries) instead of the rendered "
                             "ledger")
    args = parser.parse_args(argv)

    if args.file:
        with open(args.file, encoding="utf-8") as f:
            payload = json.load(f)
    else:
        from urllib.error import HTTPError
        from urllib.parse import urlencode
        from urllib.request import urlopen

        query = f"?{urlencode({'window': args.window})}" \
            if args.window is not None else ""
        url = f"{args.url.rstrip('/')}/debug/goodput{query}"
        try:
            with urlopen(url, timeout=10.0) as resp:  # noqa: S310 — operator-supplied URL
                payload = json.load(resp)
        except HTTPError as e:
            if e.code == 404:
                print("no live goodput meter (start the controller with "
                      "WVA_GOODPUT_LIVE=1)", file=sys.stderr)
                return 1
            raise

    if args.json:
        print(json.dumps(payload, indent=2, default=str))
    else:
        print(render_goodput(payload))
    return 0


def explain_main(argv) -> int:
    """The decision-audit read path: why did <variant> get its replica
    count. Exits 0 with the rendered record, 1 when no record exists."""
    parser = argparse.ArgumentParser(
        prog="python -m workload_variant_autoscaler_tpu_torch.controller explain",
        description="Explain a variant's latest scaling decision from "
                    "its DecisionRecord")
    parser.add_argument("variant", help="VariantAutoscaling name")
    parser.add_argument("--namespace", default="",
                        help="namespace filter (default: any)")
    parser.add_argument("--url",
                        default=os.environ.get("WVA_DEBUG_URL",
                                               "http://127.0.0.1:8080"),
                        help="base URL of the controller's metrics/debug "
                             "server (default http://127.0.0.1:8080)")
    parser.add_argument("--file", default=None, metavar="PATH",
                        help="read a saved /debug/decisions JSON payload "
                             "instead of querying a live controller")
    parser.add_argument("--json", action="store_true",
                        help="print the raw record JSON instead of the "
                             "rendered explanation")
    parser.add_argument("--trace", action="store_true",
                        help="also render the decision's cycle span tree "
                             "with exclusive/inclusive wall columns (from "
                             "/debug/profile, or --profile-file)")
    parser.add_argument("--profile-file", default=None, metavar="PATH",
                        help="with --trace: read a saved /debug/profile "
                             "payload instead of querying the controller")
    args = parser.parse_args(argv)

    if args.file:
        with open(args.file, encoding="utf-8") as f:
            payload = json.load(f)
    else:
        from urllib.parse import urlencode
        from urllib.request import urlopen

        query = urlencode({"variant": args.variant,
                           "namespace": args.namespace, "limit": 1})
        url = f"{args.url.rstrip('/')}/debug/decisions?{query}"
        with urlopen(url, timeout=10.0) as resp:  # noqa: S310 — operator-supplied URL
            payload = json.load(resp)

    decisions = payload.get("decisions", payload) \
        if isinstance(payload, dict) else payload
    matching = [d for d in decisions
                if d.get("variant") == args.variant
                and (not args.namespace
                     or d.get("namespace") == args.namespace)]
    if not matching:
        print(f"no DecisionRecord for variant {args.variant!r}"
              + (f" in namespace {args.namespace!r}" if args.namespace
                 else ""), file=sys.stderr)
        return 1
    record = record_from_dict(matching[0])
    if args.json:
        print(json.dumps(record.to_dict(), indent=2, default=str))
    else:
        print(explain_text(record))
        replayed = record.replay()
        print(f"  replay check: clamp chain reproduces {replayed} "
              f"({'OK' if replayed == record.published_replicas else 'MISMATCH'})")
    if args.trace:
        # the decision's cycle, through the attribution ledger: the same
        # renderer `controller profile` uses, scoped to the span tree
        try:
            profiles = _fetch_profiles(args.url, args.profile_file,
                                       cycle=record.cycle)
        except OSError as e:
            print(f"  trace unavailable: {e}", file=sys.stderr)
            return 0
        match = [p for p in profiles if p.get("cycle") == record.cycle]
        if not match:
            print(f"  trace unavailable: cycle {record.cycle} rotated "
                  "out of WVA_PROFILE_BUFFER", file=sys.stderr)
            return 0
        prof = match[0]
        print(f"\ncycle {record.cycle} span tree "
              f"(wall {prof.get('wall_ms', 0.0):.3f} ms, attributed "
              f"{prof.get('attributed_fraction', 0.0) * 100.0:.1f}%):")
        print(render_tree(prof.get("tree", {}),
                          wall_ms=prof.get("wall_ms")))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "explain":
        return explain_main(argv[1:])
    if argv and argv[0] == "profile":
        return profile_main(argv[1:])
    if argv and argv[0] == "goodput":
        return goodput_main(argv[1:])
    parser = argparse.ArgumentParser(
        description="Workload variant autoscaler (PyTorch + CUDA engine)")
    parser.add_argument("--metrics-port", type=int, default=8080,
                        help="port for the emitted /metrics endpoint")
    parser.add_argument("--metrics-addr", default="0.0.0.0")
    parser.add_argument("--metrics-cert", default=os.environ.get("METRICS_TLS_CERT", ""),
                        help="TLS cert for the metrics endpoint (serves https)")
    parser.add_argument("--metrics-key", default=os.environ.get("METRICS_TLS_KEY", ""))
    parser.add_argument("--metrics-client-ca", default=os.environ.get("METRICS_CLIENT_CA", ""),
                        help="require+verify client certs against this CA")
    parser.add_argument("--metrics-kube-auth", action="store_true",
                        default=os.environ.get("WVA_METRICS_KUBE_AUTH",
                                               "").lower() in ("1", "true"),
                        help="require a ServiceAccount bearer token on "
                             "/metrics, verified via TokenReview + "
                             "SubjectAccessReview (nonResourceURL "
                             "/metrics, verb get) — how in-cluster "
                             "Prometheus authenticates (reference "
                             "cmd/main.go:164-168)")
    parser.add_argument("--health-port", type=int, default=8081,
                        help="port for /healthz and /readyz probes")
    parser.add_argument("--leader-elect", action="store_true",
                        help="enable Lease-based leader election for HA")
    parser.add_argument("--config-namespace", default=CONFIG_MAP_NAMESPACE)
    parser.add_argument("--kube-url", default=None,
                        help="API server URL (default: in-cluster)")
    parser.add_argument("--allow-http-prom", action="store_true",
                        help="permit plain-http Prometheus (emulation only)")
    parser.add_argument("--kube-manifests", default=None, metavar="DIR",
                        help="dev mode: serve from an in-memory apiserver "
                             "preloaded with the YAML manifests in DIR "
                             "(no cluster needed; pairs with the emulator's "
                             "--with-prom-api shim)")
    args = parser.parse_args(argv)

    log = get_logger("wva.main")
    # The engine's device before any other work. The port's kernels are
    # CUDA, so its default is the card and a host without CUDA fails
    # here; the reference package's default pins JAX to the host CPU,
    # where its analysis kernel runs in well under a millisecond.
    platform, device = platform_device("the controller process")
    if device is None:
        log.error(f"unsupported {PLATFORM_ENV}; expected one of cuda, "
                  "gpu, ambient (the card) or cpu",
                  extra=kv(value=platform))
        return 1
    log.info("device platform pinned",
             extra=kv(platform=platform, device=str(device),
                      name=(torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "host cpu")))

    prom_config = PrometheusConfig.from_env()
    if prom_config is None:
        log.error("no Prometheus configuration found; set PROMETHEUS_BASE_URL")
        return 1
    prom = HTTPPromAPI(prom_config, allow_http=args.allow_http_prom)

    # local config errors fail fast, BEFORE the minutes-long Prometheus
    # connectivity backoff
    if args.kube_manifests:
        log.info("dev mode: in-memory apiserver from manifests",
                 extra=kv(dir=args.kube_manifests))
        try:
            kube = in_memory_kube_from_manifests(args.kube_manifests)
        except Exception as e:  # noqa: BLE001 — startup config error
            log.error("failed to load dev-mode manifests",
                      extra=kv(dir=args.kube_manifests, error=str(e)))
            return 1
    else:
        kube = RestKube(base_url=args.kube_url)

    ready = threading.Event()
    health = HealthServer(args.health_port, ready_check=ready.is_set).start()

    # The kernel modules are imported, and the CUDA library built and
    # loaded, here on the main thread before any worker thread starts:
    # module initialization is not thread-safe against itself, and a
    # process whose kernels cannot build must never go ready.
    from ..ops import _build, fused
    from .reconciler import CONFIG_MAP_NAME, SERVICE_CLASS_CM_NAME
    from .translate import engine_backend, engine_mesh, warmup_plan

    if device.type == "cuda":
        t0 = time.perf_counter()
        try:
            _build.library("bisect_kernel")
        except Exception as e:  # noqa: BLE001 — fatal: log and exit 1
            log.error("CRITICAL: the CUDA kernel library failed to build "
                      "or load", extra=kv(error=str(e)))
            health.stop()
            return 1
        log.info("kernel library loaded",
                 extra=kv(seconds=time.perf_counter() - t0))

    backend = engine_backend(device)
    if backend in fused.BACKENDS and \
            os.environ.get("WVA_WARMUP", "1").lower() not in ("0", "false"):
        # Launch each sizing group's shape off the critical path (while
        # Prometheus validation backs off and leader election contends),
        # so the first reconcile runs at steady-state latency. The
        # native host backend has nothing to warm.
        mesh = engine_mesh(backend, device)
        mesh_size = mesh.size if mesh is not None else None

        def _cm_data(name: str) -> dict:
            try:
                return kube.get_configmap(name, args.config_namespace).data
            except Exception:  # noqa: BLE001 — a missing CM warms defaults
                return {}

        def _warm() -> None:
            t0 = time.perf_counter()
            # the shapes the fleet will launch, per sizing group
            # (percentile classes launch the tail form), from the live
            # VA list + ConfigMaps (fallback: the 256 default when the
            # apiserver isn't reachable yet)
            try:
                plan = warmup_plan(
                    kube.list_variant_autoscalings(),
                    service_class_cm=_cm_data(SERVICE_CLASS_CM_NAME),
                    operator_cm=_cm_data(CONFIG_MAP_NAME),
                    mesh_size=mesh_size,
                )
            except Exception:  # noqa: BLE001
                # apiserver unreachable: the env-only percentile is
                # still readable — a percentile fleet must warm the
                # tail form, not the mean one
                from .translate import ttft_percentile as _global_pct

                plan = [(16 if mesh_size is None else math.lcm(16, mesh_size),
                         int(os.environ.get("WVA_WARMUP_MAX_BATCH", "256")),
                         _global_pct(None))]
            failures = 0
            for bucket, max_batch, pct in plan:
                try:
                    fused.warmup(max_batch=max_batch, bucket=bucket,
                                 ttft_percentile=pct, device=device,
                                 mesh=mesh)
                except Exception as e:  # noqa: BLE001 — counted, logged
                    failures += 1
                    log.error("engine warmup launch failed",
                              extra=kv(lanes=bucket, max_batch=max_batch,
                                       ttft_percentile=pct, error=str(e)))
            log.info("engine kernels warmed",
                     extra=kv(failures=failures, device=str(device),
                              seconds=time.perf_counter() - t0,
                              sharded=mesh is not None,
                              groups=[
                                  {"lanes": b, "max_batch": m,
                                   "ttft_percentile": p}
                                  for b, m, p in plan
                              ]))

        threading.Thread(target=_warm, daemon=True,
                         name="wva-engine-warmup").start()

    log.info("validating Prometheus connectivity", extra=kv(url=prom_config.base_url))
    try:
        validate_prometheus_api(prom)
    except Exception as e:  # noqa: BLE001
        log.error("CRITICAL: cannot reach Prometheus; autoscaling requires it",
                  extra=kv(error=str(e)))
        return 1
    emitter = MetricsEmitter()
    auth_gate = None
    if args.metrics_kube_auth:
        from ..metrics.authz import KubeAuthGate

        auth_gate = KubeAuthGate(kube)
    reconciler = Reconciler(
        kube=kube, prom=prom, emitter=emitter,
        config_namespace=args.config_namespace, device=device, dtype=None,
    )
    stream_middleware = None
    if reconciler._stream_enabled():
        # the streaming core's push door (POST /api/v1/write, Prometheus
        # remote-write) mounts beside /debug on the metrics server —
        # attach the core now so pushes that land before leadership
        # starts the consumer are not dropped
        from ..stream import remote_write_middleware

        stream_middleware = remote_write_middleware(
            reconciler.ensure_stream_core())
    try:
        emitter.serve(
            args.metrics_port, addr=args.metrics_addr,
            certfile=args.metrics_cert or None, keyfile=args.metrics_key or None,
            client_cafile=args.metrics_client_ca or None,
            auth_gate=auth_gate,
            # the flight recorder's read surface (the obs.DEBUG_ROUTES
            # table — docs/observability.md), inside the auth gate when
            # one is configured; the goodput route serves only when
            # WVA_GOODPUT_LIVE attached a meter in Reconciler.__init__
            debug_middleware=debug_middleware(reconciler.tracer,
                                              reconciler.decisions,
                                              reconciler.profiler,
                                              reconciler.goodput_meter),
            stream_middleware=stream_middleware,
        )
    except ValueError as e:
        log.error("invalid metrics TLS configuration", extra=kv(error=str(e)))
        return 1
    stop = threading.Event()
    # Process is serviceable once dependencies are validated; readiness does
    # NOT gate on holding the leader lease (follower replicas must go Ready
    # or rollouts stall — matches controller-runtime's readyz semantics).
    ready.set()

    # Kubernetes terminates pods with SIGTERM: route it through `stop` so
    # the lease is released instead of held for the full lease duration.
    import signal

    def _terminate(*_) -> None:
        stop.set()
        reconciler.kick()  # wake the cadence wait immediately

    signal.signal(signal.SIGTERM, _terminate)

    reconcile_thread: list[threading.Thread] = []

    def lead() -> None:
        log.info("starting reconcile loop")
        thread = threading.Thread(
            target=reconciler.run_forever, args=(stop,), daemon=True,
            name="wva-reconcile",
        )
        thread.start()
        reconcile_thread.append(thread)

    def drain() -> None:
        """Let an in-flight cycle finish before the lease is released, so
        the next leader never overlaps our writes (controller-runtime
        drains runnables before surrendering the lease)."""
        for t in reconcile_thread:
            t.join(timeout=60.0)
            if t.is_alive():
                log.warning("reconcile cycle did not drain within 60s")

    rc = 0
    if args.leader_elect:
        elector = LeaderElector(kube, lease_namespace=args.config_namespace)
        try:
            # run() returns only when leadership is lost -> exit non-zero so
            # the pod restarts and re-contends (controller-runtime policy)
            elector.run(stop, on_started_leading=lead)
            if not stop.is_set():
                log.error("leadership lost; exiting for restart")
                rc = 1
        except KeyboardInterrupt:
            pass
        finally:
            stop.set()
            drain()
            elector.release()
    else:
        lead()
        try:
            stop.wait()
        except KeyboardInterrupt:
            stop.set()
        drain()
    health.stop()
    return rc


if __name__ == "__main__":
    sys.exit(main())
