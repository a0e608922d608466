"""The port's goodput twin against the JAX package's, scenario by scenario.

`emulator.twin.run_scenario` drives the real Reconciler of each package
through a library scenario in simulated time; one flipped replica count
would change every later tick, so the whole run is compared. Each
library scenario (the six `SCENARIOS` and the three
`STREAMING_SCENARIOS`) is clipped with `abbreviated` to a horizon past
its first fault window, run through both packages, and its signature
(tests/twin_signature.py: the score sheet, every DecisionRecord and the
meter's per-tick ring) must be equal: exactly for decisions, within rel
1e-9 for floats.

The JAX side runs with WVA_NATIVE_KERNEL=false (its batched XLA backend
in float64, conftest enables x64); the port runs `device="cpu"` in
float64. The limited-mode and streaming scenarios are compared in
tests/test_torch_twin_faults.py, the two adversarial archive entries in
tests/test_torch_adversary.py.
"""

import pytest
import torch
from twin_signature import differences, signature, text, trace_ranks

from workload_variant_autoscaler_tpu.emulator import scenarios as jsc
from workload_variant_autoscaler_tpu.emulator import twin as jtw
from workload_variant_autoscaler_tpu_torch.emulator import scenarios as psc
from workload_variant_autoscaler_tpu_torch.emulator import twin as ptw
from workload_variant_autoscaler_tpu_torch.obs.goodput import GoodputMeter

RTOL = 1e-9
F64 = torch.float64
# sim seconds per scenario: past the first fault window where there is
# one (pool-drain and spot-reclaim-wave 300-420 s, prom-outage-spike
# 230-430 s, the flood 180-300 s, the restart 240-250 s), past the
# flash crowd's step otherwise
HORIZONS = {
    "diurnal-wave": 240.0,
    "flash-crowd": 300.0,
    "pool-drain": 440.0,
    "spot-reclaim-wave": 440.0,
    "prom-outage-spike": 440.0,
    "hetero-cost-skew": 180.0,
    "flash-crowd-streaming": 240.0,
    "flash-crowd-flood": 310.0,
    "restart-under-load": 260.0,
}
# the unlimited polled scenarios run here; limited mode and the streaming
# core in tests/test_torch_twin_faults.py (each file ~70 s on one worker)
FAULTED = ("pool-drain", "spot-reclaim-wave", "flash-crowd-streaming",
           "flash-crowd-flood", "restart-under-load")
POLLED = tuple(sorted(set(HORIZONS) - set(FAULTED)))


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    torch.set_num_threads(1)


def library(pkg):
    return {**pkg.SCENARIOS, **pkg.STREAMING_SCENARIOS}


def port_run(name, horizon=None, **kw):
    sc = psc.abbreviated(library(psc)[name], horizon or HORIZONS[name])
    return ptw.run_scenario(sc, device="cpu", dtype=F64, **kw)


def jax_run(name, horizon=None):
    return jtw.run_scenario(
        jsc.abbreviated(library(jsc)[name], horizon or HORIZONS[name]))


@pytest.fixture(scope="module")
def port_runs():
    """Port results by scenario, shared by the cases that read one run."""
    return {}


def test_the_library_is_covered():
    """Every library scenario is compared, here or in
    tests/test_torch_twin_faults.py."""
    assert set(HORIZONS) == set(library(jsc)) == set(library(psc))
    assert set(POLLED) | set(FAULTED) == set(HORIZONS)
    for name, sc in library(psc).items():
        ends = [r.until_s for r in sc.faults if r.until_s is not None]
        assert HORIZONS[name] > min(ends, default=0.0), name


def assert_signature_equals_jax(name, port_runs) -> None:
    mine = port_runs[name] = port_run(name)
    ref = jax_run(name)
    a, b = trace_ranks(signature(ref)), trace_ranks(signature(mine))
    assert differences(a, b, RTOL) == []
    d = b["result"]
    assert d["cycles"] >= 6 and d["raised_cycles"] <= d["cycles"]
    assert 0.0 < d["goodput_fraction"] <= 1.0
    assert b["decisions"] and b["ticks"]
    if library(psc)[name].faults:
        assert d["fault_trips"] > 0


@pytest.mark.parametrize("name", POLLED)
def test_scenario_signature_equals_jax(name, port_runs):
    assert_signature_equals_jax(name, port_runs)


def test_rerun_is_byte_identical_in_sim_time(port_runs):
    """Same scenario, same seed: the same signature bytes, and the same
    spans, every one of sim duration 0.0 (the sim clock stands still
    while a cycle runs)."""
    first = port_runs.get("flash-crowd") or port_run("flash-crowd")
    again = port_run("flash-crowd")
    assert text(signature(again)) == text(signature(first))

    def spans(result):
        return sorted((tr.trace_id, s.name, s.duration_ms)
                      for tr in result.tracer.traces() for s in tr.spans)

    assert spans(again) == spans(first) != []
    assert {d for _t, _n, d in spans(first)} == {0.0}


def test_online_meter_ledger_equals_the_twins():
    sc = psc.abbreviated(psc.SCENARIOS["flash-crowd"], 240.0)
    online = GoodputMeter(window_s=sc.duration_s)
    result = ptw.run_scenario(sc, online_meter=online, device="cpu",
                              dtype=F64)
    twin = result.meter
    assert twin.ledger() == online.ledger() != []
    assert sorted(v.key for v in twin.variants()) == \
        sorted(v.key for v in online.variants())
    for led in twin.variants():
        other = online.variant(led.key)
        assert (led.cost_s, led.demand_s, led.slo_demand_s) == \
            (other.cost_s, other.demand_s, other.slo_demand_s)
        assert led.buckets == other.buckets


def test_run_scenario_without_a_device_needs_cuda(monkeypatch):
    """No hidden CPU: without a device the twin runs on the card, and
    raises on a host without CUDA before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = psc.abbreviated(psc.SCENARIOS["flash-crowd"], 30.0)
    with pytest.raises(RuntimeError, match="cuda"):
        ptw.run_scenario(sc)
    with pytest.raises(RuntimeError, match="cuda"):
        ptw.run_scenario(sc, device="cuda", dtype=F64)
