"""The port's profile fitter against the JAX package's.

The fitter is host code (no device): it pulls aligned range-query
series (`collect_series`), regresses the decode and prefill lines
(`fit_profile`) and renders the VariantAutoscaling patch (`crd_patch`).
On the same seeded series, made with numpy, and on the series each
package's own emulator and SimPromAPI serve for the same seeded run,
every output must equal the JAX package's exactly, including the
refusal paths: too few samples (MIN_SAMPLES), a batch spread too narrow
(MIN_BATCH_SPREAD, MIN_RELATIVE_SPREAD), a line that explains too little
(MIN_R2), no queue-free samples, a missing arrival series, and the patch
refused for an incomplete fit.
"""

from dataclasses import asdict

import numpy as np
import pytest

import workload_variant_autoscaler_tpu.emulator as je
import workload_variant_autoscaler_tpu.fit as jfit
import workload_variant_autoscaler_tpu_torch.emulator as pe
import workload_variant_autoscaler_tpu_torch.fit as pfit
from workload_variant_autoscaler_tpu.fit import __main__ as jmain
from workload_variant_autoscaler_tpu_torch.fit import __main__ as pmain

CONSTANTS = ("MIN_BATCH_SPREAD", "MIN_RELATIVE_SPREAD", "MIN_SAMPLES",
             "MIN_R2", "QUEUE_FREE_THRESHOLD")


def series(mod, seed: int, n: int = 40, batch=(1.0, 40.0), noise=0.05,
           waiting=0.2, arrival=True):
    """A seeded observation window obeying the analyzer's lines (alpha
    7, beta 0.03, gamma 5, delta 0.1) plus gaussian noise."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(*batch, n)
    it = rng.choice([64.0, 128.0, 256.0], n)
    w = rng.uniform(0.0, 2.0 * waiting, n)
    a = rng.uniform(0.002, 0.02, n)
    itl = 7.0 + 0.03 * b + rng.normal(0.0, noise, n)
    ttft = 5.0 + 0.1 * it * (b + 1.0) + w / a + (7.0 + 0.03 * b) / 2.0 \
        + rng.normal(0.0, noise * 10.0, n)
    return mod.FitSeries(
        t=[float(x) for x in np.arange(n) * 15.0],
        itl_ms=[float(x) for x in itl], ttft_ms=[float(x) for x in ttft],
        batch=[float(x) for x in b], in_tokens=[float(x) for x in it],
        waiting=[None if i % 7 == 3 else float(x) for i, x in enumerate(w)],
        arrival_per_ms=[float(x) if arrival else None for x in a])


CASES = {
    "identified": {},
    "few-samples": {"n": 6},
    "narrow-spread": {"batch": (20.0, 21.5)},
    "relative-spread": {"batch": (30.0, 40.0)},
    "noise": {"noise": 5.0},
    "queued": {"waiting": 5.0},
    "no-arrival": {"arrival": False},
}


def test_constants_equal_jax():
    assert [getattr(pfit, c) for c in CONSTANTS] == \
        [getattr(jfit, c) for c in CONSTANTS]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_fit_profile_equals_jax(case, seed):
    a = jfit.fit_profile(series(jfit, seed, **CASES[case]))
    b = pfit.fit_profile(series(pfit, seed, **CASES[case]))
    assert asdict(b) == asdict(a)
    try:
        want = jfit.crd_patch(a, "v5e-4")
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pfit.crd_patch(b, "v5e-4")
        assert str(got.value) == str(e)
        assert case != "identified"
    else:
        assert pfit.crd_patch(b, "v5e-4") == want


def test_the_refusal_paths_are_taken():
    notes = {case: " ".join(pfit.fit_profile(series(pfit, 0, **kw)).notes)
             for case, kw in CASES.items()}
    assert "usable samples" in notes["few-samples"]
    assert "too narrow" in notes["narrow-spread"]
    assert "too narrow" in notes["relative-spread"]
    assert "r2" in notes["noise"]
    assert "queue-free" in notes["queued"]
    assert "lack the arrival series" in notes["no-arrival"]
    fit = pfit.fit_profile(series(pfit, 0))
    assert fit.alpha == pytest.approx(7.0, rel=0.05)
    assert fit.delta == pytest.approx(0.1, rel=0.05)


def observed(e, seed: int):
    """Each package's own emulator and SimPromAPI over a seeded
    staircase (the series the fitter reads from Prometheus)."""
    cfg = e.SliceModelConfig(model_name="m", slice_name="v5e-1",
                             max_batch_size=64, kv_mb_per_token=0.25)
    sink = e.PrometheusSink("m", "default")
    fleet = e.Fleet(cfg, sink, replicas=1)
    sim = e.Simulation(fleet, seed=seed)
    prom = e.SimPromAPI(sink, "m", "default")
    e.PoissonLoadGenerator(
        sim, schedule=[(60, 240), (60, 720), (60, 1440)],
        tokens=e.TokenDistribution(128, 128, "deterministic"),
        seed=seed).start()
    sim.run_until(180_000.0, on_tick=prom.scrape, tick_ms=5000.0)
    return prom


@pytest.mark.parametrize("replicas", [1, 2])
def test_collect_series_from_the_emulator_equals_jax(replicas):
    a = jfit.collect_series(observed(je, 5), "m", "default", 30.0, 180.0,
                            10.0, replicas=replicas)
    b = pfit.collect_series(observed(pe, 5), "m", "default", 30.0, 180.0,
                            10.0, replicas=replicas)
    assert asdict(b) == asdict(a)
    assert len(b.t) >= 8
    assert asdict(pfit.fit_profile(b)) == asdict(jfit.fit_profile(a))


def test_cli_without_prometheus_exits_1(monkeypatch, capsys):
    monkeypatch.delenv("PROMETHEUS_BASE_URL", raising=False)
    argv = ["--model", "m"]
    assert pmain.main(argv) == jmain.main(argv) == 1
    err = capsys.readouterr().err
    assert err.count("no Prometheus configured") == 2
