"""CLI: fit a variant's perf profile from live Prometheus history."""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..collector import HTTPPromAPI, PrometheusConfig
from ..controller.translate import parse_duration
from . import collect_series, crd_patch, fit_profile


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="fit alpha/beta/gamma/delta from serving metrics")
    parser.add_argument("--prom", default=None,
                        help="Prometheus base URL (default: PROMETHEUS_* env)")
    parser.add_argument("--model", required=True)
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--window", default="1h",
                        help="observation window ending now (e.g. 30m, 2h)")
    parser.add_argument("--step", default="30s")
    parser.add_argument("--replicas", type=int, default=1,
                        help="replicas behind the summed gauges (per-replica "
                             "batch = running/replicas)")
    parser.add_argument("--crd-patch", metavar="ACC",
                        help="emit a VariantAutoscaling profile patch for "
                             "this slice shape instead of the report")
    parser.add_argument("--allow-http-prom", action="store_true")
    args = parser.parse_args(argv)

    if args.prom:
        config = PrometheusConfig(base_url=args.prom)
    else:
        config = PrometheusConfig.from_env()
        if config is None:
            print("no Prometheus configured: pass --prom or set "
                  "PROMETHEUS_BASE_URL", file=sys.stderr)
            return 1
    prom = HTTPPromAPI(config, allow_http=args.allow_http_prom)

    end = time.time()
    start = end - parse_duration(args.window)
    data = collect_series(prom, args.model, args.namespace, start, end,
                          parse_duration(args.step),
                          replicas=args.replicas)
    fit = fit_profile(data)

    if args.crd_patch:
        try:
            print(crd_patch(fit, args.crd_patch), end="")
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        return 0

    report = {
        "model": args.model,
        "namespace": args.namespace,
        "samples": len(data.t),
        "batch_range": [round(fit.batch_min, 2), round(fit.batch_max, 2)],
        "alpha_ms": fit.alpha and round(fit.alpha, 4),
        "beta_ms_per_batch": fit.beta and round(fit.beta, 5),
        "gamma_ms": fit.gamma and round(fit.gamma, 4),
        "delta_ms_per_tok_batch": fit.delta and round(fit.delta, 5),
        "decode_r2": fit.decode and round(fit.decode.r2, 4),
        "prefill_r2": fit.prefill and round(fit.prefill.r2, 4),
        "overhead_ms": fit.overhead_ms and round(fit.overhead_ms, 2),
        "notes": fit.notes,
    }
    print(json.dumps(report, indent=2))
    return 0 if (fit.alpha is not None or fit.gamma is not None) else 1


if __name__ == "__main__":
    sys.exit(main())
