"""The port's goodput twin against the JAX package's: limited mode and
the streaming core.

The scenarios of tests/test_torch_twin.py that run through a fault on
the capacity side (`pool-drain`, `spot-reclaim-wave`: limited mode,
nodes drained or reclaimed under the fleet) or through the streaming
core (`flash-crowd-streaming`, `flash-crowd-flood`, `restart-under-load`:
remote-write ingest, debounced micro-cycles, a flood and a controller
restart from the warm checkpoint), compared in the same way: the
signature of the port's run on the CPU in float64 equals the JAX
package's (WVA_NATIVE_KERNEL=false, float64), exactly for decisions,
within rel 1e-9 for floats.
"""

from dataclasses import replace

import pytest
import torch
from test_torch_twin import (
    F64,
    FAULTED,
    HORIZONS,
    assert_signature_equals_jax,
    port_run,
)

from workload_variant_autoscaler_tpu_torch.emulator import scenarios as psc
from workload_variant_autoscaler_tpu_torch.emulator import twin as ptw


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_runs():
    """Port results by scenario, shared by the cases that read one run."""
    return {}


@pytest.mark.parametrize("name", FAULTED)
def test_scenario_signature_equals_jax(name, port_runs):
    assert_signature_equals_jax(name, port_runs)


def test_restart_restores_warm(port_runs):
    """The restarted controller (a fresh Reconciler and StreamCore on the
    caller's device and dtype) restores the checkpoint its predecessor
    wrote and publishes what a never-restarted run publishes."""
    restarted = port_runs.get("restart-under-load") or \
        port_run("restart-under-load")
    sc = psc.abbreviated(psc.STREAMING_SCENARIOS["restart-under-load"],
                         HORIZONS["restart-under-load"])
    baseline = ptw.run_scenario(replace(sc, name="baseline", faults=()),
                                device="cpu", dtype=F64)
    assert restarted.fault_trips == 1 and baseline.fault_trips == 0
    em = restarted.emitter
    assert em.value("inferno_stream_checkpoint_total", event="restore") == 1.0
    assert em.value("inferno_stream_checkpoint_total", event="save") >= 1.0
    for v in baseline.variants:
        a = baseline.decisions.latest(v.name, v.namespace)
        b = restarted.decisions.latest(v.name, v.namespace)
        assert a is not None and b is not None, v.name
        assert a.published_replicas == b.published_replicas, v.name
    assert all(not v.scaled_to_zero_on_stale for v in restarted.variants)
