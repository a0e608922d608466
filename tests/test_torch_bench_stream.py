"""The port's event-path benchmarks (bench_torch_stream.py,
bench_torch_streamload.py, bench_torch_streamchaos.py) against
bench_stream.py, bench_streamload.py and bench_streamchaos.py on the
same inputs, at smoke sizes.

The port runs `device="cpu"` in float64, the JAX side as its own tests
run it; both with WVA_NATIVE_KERNEL=false (the batched backends, whose
readbacks count a cycle as sizing) and WVA_STREAM_DEBOUNCE_MS=0 where
bench_streamload.py sets it when imported. Compared: `run(64, 8, 10, 3)`
of bench_stream (every VA's published decision, the event counts and
the sampled decision), `run(16, 20, 15, smoke=True)` of bench_streamload
(the equivalence and limited dicts, the door's sheds and admitted
series), `flood_phase(315, converge=False)` and `restart_phase(300)` of
bench_streamchaos, floats at rel 1e-9. Host-clock keys (lags, walls,
rates, admission latencies) and the port's reporting keys are excluded
by name; nothing here asserts a wall-clock bound.

The JAX scripts are imported inside the tests, with os.environ restored
afterwards (they set knobs when imported).
"""

import math
import os
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch_loop as pl  # noqa: E402
import bench_torch_stream as ps  # noqa: E402
import bench_torch_streamchaos as px  # noqa: E402
import bench_torch_streamload as pd  # noqa: E402
from bench_parity import capture_kubes, jax_script, published  # noqa: E402

RTOL = 1e-9
CPU = {"device": "cpu", "dtype": torch.float64}
# host-clock values: never compared
WALL_KEYS = {"value", "p50_ms", "p99_ms", "max_ms", "mean_ms",
             "vs_polled_p50", "polled_baseline", "wall_s", "series_per_s",
             "p99_admit_ms", "max_admit_ms"}
REPORTING = pl.WHERE_KEYS


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    for knob in ("WVA_STREAM_DEBOUNCE_MS", "WVA_STREAM_PUSHDOWN",
                 "WVA_STREAM_LAG_BUDGET_MS"):
        monkeypatch.delenv(knob, raising=False)
    torch.set_num_threads(1)


def assert_same(j, p, path=""):
    """The port's dict equals the JAX one key for key, floats at rel
    1e-9, apart from the host-clock keys; the port adds only its
    reporting keys."""
    if isinstance(j, dict):
        assert isinstance(p, dict), path
        extra = set(p) - set(j)
        assert extra <= REPORTING, f"{path}: unexpected keys {extra}"
        for k, v in j.items():
            if k in WALL_KEYS:
                continue
            assert k in p, f"{path}{k} missing"
            assert_same(v, p[k], f"{path}{k}.")
    elif isinstance(j, list):
        assert isinstance(p, list) and len(p) == len(j), path
        for i, (a, b) in enumerate(zip(j, p)):
            assert_same(a, b, f"{path}{i}.")
    elif isinstance(j, float) and not float(j).is_integer():
        assert isinstance(p, float), path
        assert math.isclose(p, j, rel_tol=RTOL), f"{path}: {j!r} != {p!r}"
    else:
        assert j == p, f"{path}: {j!r} != {p!r}"


def no_launches_but_sizing(k: dict) -> None:
    assert k["cycles"] > 0 and k["sizing_cycles"] > 0
    assert k["B1"] == k["B2"] == 0          # nothing launches on the CPU
    assert k["d2h_per_sizing_cycle"] == [1]


def test_constants_equal():
    js = jax_script("bench_stream")
    jd = jax_script("bench_streamload")
    jx = jax_script("bench_streamchaos")
    for name in ("N_VARIANTS", "N_MODELS", "NS", "INTERVAL_S", "BASE_RPM",
                 "EVENTS", "WARMUP_EVENTS"):
        assert getattr(ps, name) == getattr(js, name), name
    for name in ("TARGET_SERIES_PER_S", "ADMIT_BUDGET_MS", "N_MODELS",
                 "RULE_POSTS", "RAW_POSTS", "IN_TOK", "OUT_TOK", "TTFT_S",
                 "ITL_S", "TRAJECTORY_RPM", "RULE_FIELDS"):
        assert getattr(pd, name) == getattr(jd, name), name
    for name in ("LAG_BUDGET_MS", "STORE_CAP", "QUEUE_CAP", "FLOOD_MULT",
                 "WIRE_VARIANTS", "WIRE_MODELS", "WIRE_ROUNDS",
                 "WIRE_WARMUP"):
        assert getattr(px, name) == getattr(jx, name), name


def test_request_bodies_equal():
    js = jax_script("bench_stream")
    jd = jax_script("bench_streamload")
    assert ps.write_request_body("llama-8b-m3", 4803.0, 1_700_000_000_123) \
        == js.write_request_body("llama-8b-m3", 4803.0, 1_700_000_000_123)
    assert pd.rule_sweep_body(8, lambda i: 2400.0 + i, 1_700_000_000_000) \
        == jd.rule_sweep_body(8, lambda i: 2400.0 + i, 1_700_000_000_000)
    assert pd.raw_sweep_body(8, lambda i: 60.0 + i, 1_700_000_000_000) \
        == jd.raw_sweep_body(8, lambda i: 60.0 + i, 1_700_000_000_000)


def test_stream_run_equal(monkeypatch):
    """bench_stream.run(64, 8, 10, 3) through the real door and the
    consumer thread: every VA's published decision after the events,
    the event counts and the sampled decision."""
    js = jax_script("bench_stream")
    jkubes = capture_kubes(monkeypatch, js)
    pkubes = capture_kubes(monkeypatch, ps)
    j = js.run(64, 8, 10, 3)
    p = ps.run(64, 8, 10, 3, **CPU)
    assert_same(j, p)
    assert p["decision_check"]["resized_from_push"]
    assert published(pkubes[0]) == published(jkubes[0])
    k = p["kernel_launches"]
    no_launches_but_sizing(k)
    # every measured event was published by a micro-cycle that sized
    assert k["sizing_cycles"] >= p["events"]
    assert (p["device"], p["dtype"]) == ("cpu", "float64")


def test_streamload_smoke_equal(monkeypatch):
    """bench_streamload.run(16, 20, 15, smoke=True): the equivalence and
    limited dicts, the door's sheds and admitted series; then the gates,
    split into invariants and budgets."""
    jd = jax_script("bench_streamload")
    monkeypatch.setenv("WVA_STREAM_DEBOUNCE_MS", "0")
    j = jd.run(n_models=16, rule_posts=20, raw_posts=15, smoke=True)
    monkeypatch.delenv("WVA_STREAM_DEBOUNCE_MS")
    p = pd.run(n_models=16, rule_posts=20, raw_posts=15, smoke=True, **CPU)
    assert "WVA_STREAM_DEBOUNCE_MS" not in os.environ
    assert_same(j["equivalence"], p["equivalence"])
    assert_same(j["limited"], p["limited"])
    assert_same(j["throughput"], p["throughput"])
    assert p["throughput"]["sheds_by_reason"] == {}
    assert p["throughput"]["kernel_launches"]["cycles"] == 0   # no sizing
    no_launches_but_sizing(p["equivalence"]["kernel_launches"])
    no_launches_but_sizing(p["limited"]["kernel_launches"])
    p["smoke"] = True
    fails, budgets = pd.check(p)
    assert fails == []
    assert [b["budget"] for b in budgets] \
        == ["rules p99_admit_ms", "raw p99_admit_ms"]


def test_streamload_check_splits_invariants_from_budgets():
    out = {"value": 9_000.0,
           "throughput": {"sheds_by_reason": {"store-full": 1},
                          "rules": {"p99_admit_ms": 10.0},
                          "raw": {"p99_admit_ms": 300.0}},
           "equivalence": {"pushdown_equals_rules": True,
                           "off_restores_rule_door": True},
           "limited": {"scoped_solves_component_only": True,
                       "storm_escalates_full": True,
                       "storm_coalesces": True,
                       "lanes": {"scoped": 1, "coalesced": 1},
                       "component_variants": 8, "fleet_variants": 16}}
    fails, budgets = pd.check(out)
    assert fails == ["unexpected sheds {'store-full': 1}"]
    assert [(b["budget"], b["met"]) for b in budgets] == [
        ("series_per_s (min of the lanes)", False),
        ("rules p99_admit_ms", True), ("raw p99_admit_ms", False)]


def test_streamchaos_flood_and_restart_equal(monkeypatch):
    """flood_phase(315, converge=False) and restart_phase(300): the
    twins' store and queue marks, the shed ledger, goodput, restores
    and flaps, floats at rel 1e-9; StreamCore.ingest_push restored."""
    from workload_variant_autoscaler_tpu_torch.stream import StreamCore

    jx = jax_script("bench_streamchaos")
    push = StreamCore.ingest_push
    j = jx.flood_phase(315.0, converge=False)
    p = px.flood_phase(315.0, converge=False, **CPU)
    assert StreamCore.ingest_push is push
    assert_same(j, p)
    no_launches_but_sizing(p["kernel_launches"])
    j = jx.restart_phase(300.0)
    p = px.restart_phase(300.0, **CPU)
    assert_same(j, p)
    no_launches_but_sizing(p["kernel_launches"])


def test_streamchaos_wire_invariants_and_check():
    """A short wire phase on the CPU: the capped store sheds with 429s,
    the pushed loads re-size the fleet; `check` reports the p99 lag as a
    budget and raises nothing."""
    wire = px.wire_phase(n_variants=32, n_models=4, rounds=6, warmup=2,
                         flood_mult=24, **CPU)
    assert wire["store_peak"] <= wire["store_cap"]
    assert wire["partial_429"] > 0
    assert wire["decision_check"]["resized_from_push"]
    assert wire["lag_samples"] > 0
    no_launches_but_sizing(wire["kernel_launches"])
    flood = {"store_peak": 64, "store_cap": 64, "queue_peak": 32,
             "queue_cap": 32, "shed": {"store-full": 1, "queue-full": 1},
             "accounting_ok": True, "backstop_passes": 1.0,
             "goodput_fraction": 0.5, "goodput_floor": 0.45}
    restart = {"fault_trips": 1, "checkpoint_restores": 1.0,
               "checkpoint_saves": 2.0, "goodput_fraction": 0.5,
               "goodput_floor": 0.45, "scale_to_zero_flaps": 0}
    out = {"flood": flood, "wire": {**wire, "p99_ms": 251.0},
           "restart": restart, "lag_budget_ms": 250.0}
    fails, budgets = px.check(out)
    assert fails == []
    assert budgets == [{"budget": "wire p99_ms", "value": 251.0,
                        "limit": 250.0, "met": False}]
    restart["scale_to_zero_flaps"] = 1
    assert px.check(out)[0] == ["restart scale_to_zero_flaps == 0"]
