"""The port's adversarial search against the JAX package's.

The parameter space, its grid and the scenarios built from a grid point
are host code copied into the port; the search is a seeded (1+λ)
descent whose audit trail (`SearchResult.to_dict()`) is its
byte-comparison surface. Compared here, each against the JAX package:

- the space, `quantize` and `quantized_params` (values and errors);
- `scenario_from_params` on seeded grid points (every field);
- `search` with a fake `evaluate`: the same serialized bytes;
- `search` with the default evaluator (the twin, on the CPU in float64)
  over a short horizon: the same audit trail;
- the archive (the committed `tests/fixtures/adversarial_scenarios.json`,
  read and never written, and a `WVA_ADVERSARY_ARCHIVE` file under a tmp
  path): the same document and the same scenarios;
- both archive entries at full duration: the same twin signature, so
  the same goodput. Their floors are printed by the JAX package's own
  tests and not asserted here.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from twin_signature import differences, signature

from workload_variant_autoscaler_tpu.emulator import adversary as jad
from workload_variant_autoscaler_tpu.emulator import twin as jtw
from workload_variant_autoscaler_tpu.emulator.scenarios import (
    adversarial as jav,
)
from workload_variant_autoscaler_tpu_torch.emulator import adversary as pad
from workload_variant_autoscaler_tpu_torch.emulator import twin as ptw
from workload_variant_autoscaler_tpu_torch.emulator.scenarios import (
    adversarial as pav,
)

F64 = torch.float64


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    torch.set_num_threads(1)


def points(seed: int, n: int) -> list[dict]:
    """n seeded points in (and a little past) the space's bounds."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append({s.name: float(rng.uniform(s.lo - s.quantum, s.hi
                                              + s.quantum))
                    for s in jav.PARAM_SPACE})
    return out


def fake(params: dict, name: str) -> float:
    """A deterministic stand-in for the twin: goodput falls with demand
    and with the fault axes."""
    score = 1.0 - params["base_rpm"] * params["ramp_mult"] / 40000.0
    score -= 0.03 * params["drain_nodes"] + 0.1 * params["reclaim_p"]
    return max(score - len(name) * 1e-4, 0.0)


def test_param_space_and_grid_equal_jax():
    assert [dataclasses.astuple(s) for s in pav.PARAM_SPACE] == \
        [dataclasses.astuple(s) for s in jav.PARAM_SPACE]
    assert (pav.DURATION_S, pav.TEMPLATE_CHIP, pav.TEMPLATE_POOL_NODES) == \
        (jav.DURATION_S, jav.TEMPLATE_CHIP, jav.TEMPLATE_POOL_NODES)
    for p in points(0, 40):
        for pspec, jspec in zip(pav.PARAM_SPACE, jav.PARAM_SPACE):
            assert pav.quantize(pspec, p[pspec.name]) == \
                jav.quantize(jspec, p[jspec.name])
        assert pav.quantized_params(p) == jav.quantized_params(p)
    for bad in ({**points(1, 1)[0], "typo": 1.0},
                {k: v for k, v in points(2, 1)[0].items() if k != "skew_s"}):
        with pytest.raises(ValueError) as pe:
            pav.quantized_params(bad)
        with pytest.raises(ValueError) as je:
            jav.quantized_params(bad)
        assert str(pe.value) == str(je.value)


def test_scenarios_from_points_equal_jax():
    for i, p in enumerate(points(3, 24)):
        q = jav.quantized_params(p)
        overlay = {"WVA_MAX_REPLICA_STEP": "2"} if i % 3 == 0 else None
        kw = dict(name=f"adv-{i}", seed=100 + i, goodput_floor=0.25,
                  operator_extra=overlay)
        assert dataclasses.asdict(pav.scenario_from_params(q, **kw)) == \
            dataclasses.asdict(jav.scenario_from_params(q, **kw))


@pytest.mark.parametrize("seed", [3, 14])
def test_search_with_a_fake_evaluator_serializes_as_jax(seed):
    a = jad.search(seed=seed, generations=3, population=4, evaluate=fake)
    b = pad.search(seed=seed, generations=3, population=4, evaluate=fake)
    assert json.dumps(b.to_dict(), sort_keys=True) == \
        json.dumps(a.to_dict(), sort_keys=True)
    assert len(b.evaluations) == b.budget == 13


def test_search_with_the_twin_equals_jax():
    """The default evaluator runs the port's twin on the caller's device
    and dtype; over a short horizon its audit trail equals the JAX
    package's."""
    a = jad.search(seed=14, generations=1, population=2, duration_s=90.0)
    b = pad.search(seed=14, generations=1, population=2, duration_s=90.0,
                   device="cpu", dtype=F64)
    assert b.to_dict() == a.to_dict()
    assert len(b.evaluations) == 3


def test_search_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pad.search(seed=14, generations=1, population=1, duration_s=30.0)
    # an injected evaluator needs no device
    assert pad.search(seed=14, generations=1, population=1,
                      evaluate=fake).budget == 2


def test_committed_archive_loads_into_the_same_scenarios(monkeypatch):
    monkeypatch.delenv("WVA_ADVERSARY_ARCHIVE", raising=False)
    assert pav.archive_path() == jav.archive_path()
    assert pav.archive_path().name == "adversarial_scenarios.json"
    doc = pav.load_archive()
    assert doc == jav.load_archive()
    names = [e["name"] for e in doc["scenarios"]]
    assert names == ["adv-r14-g1", "adv-r14-g2"]
    assert list(pav.ADVERSARIAL_SCENARIOS) == list(jav.ADVERSARIAL_SCENARIOS)
    for name in names:
        assert dataclasses.asdict(pav.ADVERSARIAL_SCENARIOS[name]) == \
            dataclasses.asdict(jav.ADVERSARIAL_SCENARIOS[name])


def test_archive_override_loads_as_jax(monkeypatch, tmp_path):
    path = tmp_path / "archive.json"
    monkeypatch.setenv("WVA_ADVERSARY_ARCHIVE", str(path))
    assert pav.archive_path() == jav.archive_path() == path
    assert pav.load_archive() == jav.load_archive() == {
        "version": pav.ARCHIVE_VERSION, "scenarios": []}
    q = jav.quantized_params(points(4, 1)[0])
    path.write_text(json.dumps({"version": 1, "scenarios": [
        {"name": "adv-t-1", "seed": 9, "floor": 0.1, "params": q,
         "duration_s": 120.0, "operator": {"WVA_MAX_REPLICA_STEP": "2"}}]}))
    pdoc, jdoc = pav.load_archive(), jav.load_archive()
    assert pdoc == jdoc
    a = jav.scenarios_from_archive(jdoc)["adv-t-1"]
    b = pav.scenarios_from_archive(pdoc)["adv-t-1"]
    assert dataclasses.asdict(b) == dataclasses.asdict(a)
    assert b.duration_s == 120.0 and b.goodput_floor == 0.1
    path.write_text(json.dumps({"version": 2, "scenarios": []}))
    for mod in (pav, jav):
        with pytest.raises(ValueError, match="version"):
            mod.load_archive()


@pytest.mark.parametrize("name", ["adv-r14-g1", "adv-r14-g2"])
def test_archive_entry_scores_as_jax(name):
    """Full duration, every fault family the entry carries: the port's
    signature (so its goodput) equals the JAX package's."""
    ref = jtw.run_scenario(jav.ADVERSARIAL_SCENARIOS[name])
    mine = ptw.run_scenario(pav.ADVERSARIAL_SCENARIOS[name], device="cpu",
                            dtype=F64)
    assert differences(signature(ref), signature(mine), 1e-9) == []
    assert mine.goodput_fraction == ref.goodput_fraction
    assert mine.fault_trips == ref.fault_trips > 0
