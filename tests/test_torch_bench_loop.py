"""bench_torch_loop.py (the port's north-star benchmark) against
bench_loop.py on the same inputs.

The closed loop is the longest chain of dependent decisions in the repo:
one flipped replica count changes every later tick. So each run here
goes through both packages and is compared whole: the decision of every
reconcile cycle (each VA's accelerator and replicas, and the
`inferno_solve_lanes` counts) exactly, and the result dict exactly, key
for key (every float in it is rounded, so exact equality is the stated
tolerance), apart from the host-clock keys, which are excluded by name,
and the port's reporting keys (device, dtype, backend, kernel launches,
the reconcile walls run_scenario adds), which the JAX package has no
counterpart of. Unrounded floats (the oracle, the power curves) are
held within rel 1e-9.

The JAX side runs with WVA_NATIVE_KERNEL=false (its batched XLA backend,
in float64: conftest enables x64); the port runs `device="cpu"` in
float64. The mean-sizing minis size through the port's PyTorch trip
loop (its CPU backend); the p95 minis through the kernel route
(`engine_backend` pinned to "kernel"), so B2's and B1's plain versions
run in closed loop, as the kernels do on the card.
"""

import dataclasses
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_loop as jb  # noqa: E402
import bench_torch_loop as pb  # noqa: E402
from workload_variant_autoscaler_tpu.controller import (  # noqa: E402
    reconciler as jrec,
)
from workload_variant_autoscaler_tpu_torch.controller import (  # noqa: E402
    reconciler as prec,
)
from workload_variant_autoscaler_tpu_torch.controller import (  # noqa: E402
    translate as ptr,
)
from workload_variant_autoscaler_tpu_torch.ops import (  # noqa: E402
    bisect_kernel as pbk,
)

RTOL = 1e-9
F64 = torch.float64
# host-clock values: the only keys of a JAX result allowed to differ
WALL_KEYS = {"reconcile_wall_ms_p50", "reconcile_wall_ms_max", "p50_ms",
             "p95_ms", "max_ms", "p50_ms_per_va", "cycle_wall_ms_p50",
             "cycle_wall_ms_max", "analyze_optimize_ms_p50",
             "wall_speedup_p50", "analyze_optimize_speedup_p50"}
# the minis' ramps: one step up and back, 3 sim minutes, a cycle every 30 s
MINI_RAMPS = {
    "chat-8b": [(60, 300), (60, 1500), (60, 300)],
    "chat-70b": [(60, 60), (60, 300), (60, 60)],
}
MINIS = ("multi-model-mix", "sharegpt-p95-sizing", "sharegpt-fast-probe",
         "multihost-70b-p95")


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    torch.set_num_threads(1)


def cycle_log(monkeypatch, module) -> list:
    """Per reconcile cycle of `module`'s Reconciler: every VA's
    (name, accelerator, replicas) and the solve-lane counts."""
    log = []
    orig = module.Reconciler.reconcile

    def spy(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        log.append((
            tuple(sorted((va.metadata.name,
                          va.status.desired_optimized_alloc.accelerator,
                          va.status.desired_optimized_alloc.num_replicas)
                         for va in self.kube.list_variant_autoscalings())),
            self.emitter.value("inferno_solve_lanes", state="solved"),
            self.emitter.value("inferno_solve_lanes", state="skipped"),
        ))
        return out

    monkeypatch.setattr(module.Reconciler, "reconcile", spy)
    return log


def both(monkeypatch, jax_fn, port_fn):
    """(jax result, its cycles, port result, its cycles)."""
    jlog = cycle_log(monkeypatch, jrec)
    plog = cycle_log(monkeypatch, prec)
    j = jax_fn()
    p = port_fn()
    return j, jlog, p, plog


def assert_same(j, p, skip=frozenset(), path=""):
    """The port's result equals the JAX package's, key for key, apart
    from the keys in `skip` and the host-clock keys; the port may add
    only its reporting keys."""
    if isinstance(j, dict):
        assert isinstance(p, dict), path
        extra = set(p) - set(j)
        assert extra <= pb.WHERE_KEYS, f"{path}: unexpected keys {extra}"
        for k, v in j.items():
            if k in WALL_KEYS or k in skip:
                continue
            assert k in p, f"{path}{k} missing"
            assert_same(v, p[k], skip, f"{path}{k}.")
    elif isinstance(j, float) and math.isnan(j):
        assert isinstance(p, float) and math.isnan(p), path
    else:
        assert type(j) is type(p) and j == p, f"{path}: {j!r} != {p!r}"


def mini(module, key):
    sc = module.SCENARIOS[key]
    return dataclasses.replace(
        sc, variants=[dataclasses.replace(v, ramp=MINI_RAMPS[v.name])
                      for v in sc.variants],
        warmup_ms=60_000.0, reconcile_ms=30_000.0)


def no_launches(result):
    k = result["kernel_launches"]
    assert k["cycles"] > 0 and k["sizing_cycles"] > 0
    assert k["B1"] == k["B2"] == 0   # nothing launches on the CPU


@pytest.mark.parametrize("key", sorted(jb.SCENARIOS))
def test_scenario_definitions_equal(key):
    """Every committed scenario, field by field (the variants' emulator
    physics and token mixes included)."""
    assert set(pb.SCENARIOS) == set(jb.SCENARIOS)
    j, p = jb.SCENARIOS[key], pb.SCENARIOS[key]
    assert ([f.name for f in dataclasses.fields(p)]
            == [f.name for f in dataclasses.fields(j)])
    assert dataclasses.asdict(p) == dataclasses.asdict(j)


def test_constants_equal():
    for name in ("MODEL", "NS", "VARIANT", "SLO_ITL_MS", "SLO_TTFT_MS",
                 "RAMP", "DURATION_MS", "WARMUP_MS", "RECONCILE_MS",
                 "CHIPS_PER_REPLICA", "SEED", "_PREMIUM_YAML",
                 "_FREEMIUM_YAML", "_FULL_SLO_KNOBS", "_MM_ACCELERATORS",
                 "_HF_ACCELERATORS", "_MH_ACCELERATORS"):
        assert getattr(pb, name) == getattr(jb, name), name
    for name in ("CFG", "TOKENS", "_CFG_70B_V5E8", "_CFG_70B_V5P4",
                 "_CFG_70B_V5E16"):
        assert (dataclasses.asdict(getattr(pb, name))
                == dataclasses.asdict(getattr(jb, name))), name


def test_oracle_and_power_curves_equal():
    for ramp in (jb.RAMP, MINI_RAMPS["chat-8b"]):
        assert pb.oracle_chip_hours(ramp) == pytest.approx(
            jb.oracle_chip_hours(ramp), rel=RTOL)
    grid = np.linspace(0.0, 1.0, 41)
    for chip in ("v5e", "v5p"):
        jp, pp = jb._power_curve(chip), pb._power_curve(chip)
        assert [pp(u) for u in grid] == pytest.approx(
            [jp(u) for u in grid], rel=RTOL)


def test_mini_ramp_run_equal(monkeypatch):
    """`run` (mean sizing, the default scenario's loop) on a mini ramp."""
    kw = dict(ramp=MINI_RAMPS["chat-8b"], warmup_ms=60_000.0,
              reconcile_ms=30_000.0)
    j, jlog, p, plog = both(monkeypatch, lambda: jb.run(**kw),
                            lambda: pb.run(**kw, device="cpu", dtype=F64))
    assert plog == jlog and len(jlog) == 6
    assert_same(j, p)
    assert p["device"] == "cpu" and p["dtype"] == "float64"
    assert p["backend"] == "batched"
    no_launches(p)
    assert p["kernel_launches"]["cycles"] == len(plog)


@pytest.mark.parametrize("key", MINIS)
def test_mini_scenario_equal(monkeypatch, key):
    """`run_scenario` on minis of a mean-sized two-model mix and the p95
    scenarios (percentile sizing, the breakout probe, 16-chip slices);
    the p95 minis through the kernels' plain versions."""
    tail_calls = []
    if key != "multi-model-mix":
        monkeypatch.setattr(ptr, "engine_backend", lambda device: "kernel")
        plain = pbk.bisect_plain

        def counted(fcols, icols, clm, k_max, tail_pct=None):
            tail_calls.append(tail_pct)
            return plain(fcols, icols, clm, k_max, tail_pct)

        monkeypatch.setattr(pbk, "bisect_plain", counted)
    j, jlog, p, plog = both(
        monkeypatch, lambda: jb.run_scenario(mini(jb, key)),
        lambda: pb.run_scenario(mini(pb, key), device="cpu", dtype=F64))
    assert plog == jlog and len(jlog) >= 5
    assert_same(j, p)
    no_launches(p)
    assert p["kernel_launches"]["cycles"] == len(plog)
    if key != "multi-model-mix":
        # B2's plain version on the TTFT rows, B1's on the ITL rows
        assert 0.95 in tail_calls and None in tail_calls
    if key == "sharegpt-fast-probe":
        assert p["probe_kicks"] >= 1


def test_fleet_scale_equal(monkeypatch):
    j, jlog, p, plog = both(
        monkeypatch, lambda: jb.run_fleet_scale(sizes=(8, 16), cycles=3),
        lambda: pb.run_fleet_scale(sizes=(8, 16), cycles=3, device="cpu",
                                   dtype=F64))
    assert plog == jlog and len(jlog) == 8
    # value and vs_baseline of fleet-scale are host-clock figures
    assert_same(j, p, skip={"value", "vs_baseline"})
    assert p["backend"] == j["backend"] == "batched"
    assert set(p["fleets"]) == {"8", "16"}
    for row in p["fleets"].values():
        assert row["p50_ms"] > 0
        assert row["kernel_launches"]["cycles"] == 3


def test_solve_churn_equal(monkeypatch):
    j, jlog, p, plog = both(
        monkeypatch, lambda: jb.run_solve_churn(n=32, cycles=4),
        lambda: pb.run_solve_churn(n=32, cycles=4, device="cpu", dtype=F64))
    # two warm-up and four churned cycles per mode, lanes per cycle too
    assert plog == jlog and len(jlog) == 12
    assert_same(j, p)
    assert p["incremental"]["lanes_solved_per_cycle"] < 32.0
    assert p["full"]["lanes_solved_per_cycle"] == 32.0
    assert "WVA_INCREMENTAL_SOLVE" not in os.environ


def test_main_list_and_unknown_key(capsys):
    assert pb.main(["list"]) == jb.main(["list"]) == 0
    assert "solve-churn" in capsys.readouterr().err
    assert pb.main(["no-such-scenario", "--device", "cpu"]) == 2
    assert jb.main(["no-such-scenario"]) == 2
    assert "unknown scenario" in capsys.readouterr().err


def test_main_exits_1_when_the_slo_does_not_hold(monkeypatch, capsys):
    seen = {}

    def run(**kw):
        seen.update(kw)
        return {"metric": "chip_hours_to_hold_p95_itl_slo", "slo_held": False}

    monkeypatch.setattr(pb, "run", run)
    assert pb.main(["--device", "cpu", "--dtype", "float64"]) == 1
    assert '"slo_held": false' in capsys.readouterr().out
    assert seen == {"device": torch.device("cpu"), "dtype": F64}


def test_main_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        pb.main(["sharegpt-ramp"])
    with pytest.raises(RuntimeError, match="cuda"):
        pb.run(ramp=MINI_RAMPS["chat-8b"])
