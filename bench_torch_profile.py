"""bench_torch_profile: where a 512-variant reconcile cycle's wall goes,
with the port's cycle on the card.

The counterpart of bench_profile.py. It drives bench_torch_collect.py's
fleet (512 variants, 8 models, the 2 ms-per-query Prometheus latency
model, the in-memory kube) through a warm-up cycle and one profiled
whole-fleet load-shift cycle (every signature changes, every lane
re-solves through the resident arena, so the cycle sizes: B1 on the
card), with the residual sampler on (WVA_PROFILE_SAMPLE_HZ=97), and
reports the cycle's attribution ledger (obs/profile.py):

- `buckets` partitions the cycle wall exactly (exclusive buckets plus
  unattributed == wall), among them `kube`, `prometheus` and the
  `stage:*` buckets;
- `value` is the attributed fraction (named buckets / wall), >= 0.9;
- `python_ms` is the stage-exclusive plus unattributed Python time,
  itemized by caller through the stdlib sampler;
- `device_audit` is the profiled cycle's device audit (the JAX script's
  `jax` key): host-to-device copies (the arena's uploads), one
  device-to-host readback per sizing group, and `retraces`, always empty
  (PyTorch runs eagerly; the check is kept, vacuous);
- `determinism`: a full double run; the partition holds in both and the
  bucket keyset and the aggregated span-tree shape are identical (less
  the `gc` pauses, which fall where collections fall).

    python3 bench_torch_profile.py [--device cuda|cpu] [--smoke] [--out PATH]

`--smoke` runs an abbreviated fleet (32 variants) and only checks the
invariants. The engine backend is the device's own (WVA_NATIVE_KERNEL=
false for each cycle's duration, as bench_profile.py pins it): the CUDA
kernels on the card, the PyTorch trip loop on the CPU. Runs in float32 on
`cuda` unless `--device cpu` is asked; raises without CUDA. Prints ONE
JSON line with bench_torch_loop.where's keys and kernel_launches (B1/B2
per reconcile cycle).
"""

from __future__ import annotations

import sys

from bench_torch_collect import (
    N_VARIANTS,
    build_cluster,
    cycle_launches,
    emit,
    knobs,
    launch_summary,
    parse_args,
    seed_prom,
)
from bench_torch_loop import where

SMOKE_VARIANTS = 32
# the device's own backend and the residual sampler, for each profiled
# cycle's duration (bench_profile.py sets them when imported)
KNOBS = {"WVA_NATIVE_KERNEL": "false", "WVA_PROFILE_SAMPLE_HZ": "97"}


def profiled_cycle(n_variants: int, *, device=None, dtype=None) -> dict:
    """One warm-up cycle (the build, the first launch, the first
    publish), then one profiled whole-fleet load-shift cycle: every
    variant's demand moved, so every signature changes and every lane
    re-solves through the resident arena. Returns the profiled cycle's
    ProfileRecord dict, with the two cycles' kernel_launches."""
    with knobs(**KNOBS), cycle_launches() as rows:
        kube, prom, rec = build_cluster(n_variants, device=device,
                                        dtype=dtype)
        rec.reconcile()                     # warm-up
        seed_prom(prom.store, rps=36.0)     # fleet-wide demand step
        result = rec.reconcile()            # the attributed cycle
    if len(result.processed) != n_variants:
        raise RuntimeError(f"profile: {len(result.processed)} of "
                           f"{n_variants} processed, skipped="
                           f"{result.skipped}")
    record = rec.profiler.records()[0].to_dict()
    record["kernel_launches"] = launch_summary(rows)
    return record


def assert_invariants(rec: dict) -> None:
    """The acceptance invariants every run must satisfy; raises
    AssertionError naming the first that fails."""
    wall = rec["wall_ms"]
    total = sum(rec["buckets"].values())
    checks = (
        (wall > 0.0, "profiled cycle recorded no wall time"),
        (abs(total - wall) <= max(1e-6 * wall, 1e-3),
         f"partition broken: buckets sum {total} != wall {wall}"),
        (rec["attributed_fraction"] >= 0.9,
         f"only {rec['attributed_fraction']:.3f} of the wall attributed"),
        (any(k.startswith("stage:") for k in rec["buckets"]),
         "no stage bucket"),
        ("kube" in rec["buckets"] and "prometheus" in rec["buckets"],
         "no kube or prometheus bucket"),
        (not rec["device"]["retraces"],
         f"steady-state cycle retraced: {rec['device']['retraces']}"),
        (rec["device"]["transfers"].get("h2d", 0) > 0,
         "load-shift cycle uploaded nothing (audit hooks dead?)"),
        (bool(rec["residual_by_caller"]),
         "sampler produced no residual itemization (cycle too fast?)"),
    )
    for ok, why in checks:
        if not ok:
            raise AssertionError(why)


# spans the port opens and the reference package does not: a sizing
# group's pack and decision (models/system.py), the drift watchdog's
# batch (controller/reconciler.py _track_drift) and the interpreter's
# gen-2 pauses (obs/profile.py GC_AUDIT)
PORT_ONLY = ("system.pack", "system.decide", "drift.predict", "gc")


def tree_shape(node: dict, skip=("gc",)):
    """The aggregated span tree's names and counts, without the subtrees
    named in `skip`. A `gc` node falls where a collection fell, so two
    runs of the same work need not hold the same ones."""
    return (node["name"], node["count"],
            tuple(tree_shape(c, skip) for c in node.get("children", [])
                  if c["name"] not in skip))


def bucket_keys(rec: dict, skip=("gc",)) -> list:
    """The ledger's bucket names, without those in `skip`."""
    return sorted(k for k in rec["buckets"] if k not in skip)


def run(smoke: bool = False, *, device=None, dtype=None) -> dict:
    with knobs(**KNOBS):
        place = where(device, dtype)
    n = SMOKE_VARIANTS if smoke else N_VARIANTS
    first = profiled_cycle(n, device=device, dtype=dtype)
    assert_invariants(first)
    if smoke:
        return {
            "bench": "profile-smoke", "variants": n,
            "wall_ms": first["wall_ms"],
            "attributed_fraction": first["attributed_fraction"],
            "python_ms": first["python_ms"],
            **place,
            "kernel_launches": first["kernel_launches"],
        }

    second = profiled_cycle(n, device=device, dtype=dtype)
    assert_invariants(second)
    determinism = {
        "partition_holds_both_runs": True,   # assert_invariants raised if not
        "bucket_keys_match": bucket_keys(first) == bucket_keys(second),
        "tree_shape_matches":
            tree_shape(first["tree"]) == tree_shape(second["tree"]),
    }
    if not all(determinism.values()):
        raise AssertionError(f"profile: the double run differs in shape: "
                             f"{determinism}")

    top_residual = dict(sorted(first["residual_by_caller"].items(),
                               key=lambda kv: -kv[1])[:10])
    return {
        "metric": "cycle_wall_attributed_fraction",
        "bench": "profile",
        "variants": n,
        "value": first["attributed_fraction"],
        "unit": "fraction of cycle wall in named buckets",
        "wall_ms": first["wall_ms"],
        "python_ms": first["python_ms"],
        "unattributed_ms": first["unattributed_ms"],
        "buckets": first["buckets"],
        "top_residual_by_caller_ms": top_residual,
        "device_audit": first["device"],
        "determinism": determinism,
        "second_run": {
            "wall_ms": second["wall_ms"],
            "attributed_fraction": second["attributed_fraction"],
            "python_ms": second["python_ms"],
        },
        **place,
        "kernel_launches": first["kernel_launches"],
    }


def main(argv=None) -> int:
    opts = parse_args("bench_torch_profile.py", argv, smoke=True)
    return emit(run(opts.smoke, device=opts.device), opts.out)


if __name__ == "__main__":
    sys.exit(main())
