"""The port's cycle benchmarks (bench_torch_collect.py,
bench_torch_profile.py, bench_torch_fuse.py) against bench_collect.py,
bench_profile.py and bench_fuse.py on the same inputs, at smoke sizes.

The port runs `device="cpu"` in float64; the JAX side as its own tests
run it (its batched XLA backend, float64: conftest enables x64). Both
sides run with WVA_NATIVE_KERNEL=false (bench_profile.py and
bench_fuse.py pin it; the CPU's default would be the native backend,
which reads nothing back and so counts no sizing). Compared exactly:
query, list and get counts and every VA's published accelerator and
replicas (the port's one collection path against both of the JAX
package's); the attribution ledger's bucket
keyset and span-tree shape (less the spans only the port opens,
bench_torch_profile.PORT_ONLY) and the partition invariant; readbacks per
cycle; fused, staged and JAX decisions; the 4096-server fleet's unique
lanes and decisions at a reduced n. Host-clock values (walls, the
fractions and ms of the ledger's buckets) are not compared; nothing here
asserts a wall-clock bound.

The JAX scripts set knobs in os.environ when they are imported
(bench_profile.py: WVA_NATIVE_KERNEL, WVA_PROFILE_SAMPLE_HZ), and every
pytest worker imports every test file, so they are imported here only
inside a test, with the environment restored afterwards.
"""

import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch_collect as pc  # noqa: E402
import bench_torch_fuse as pf  # noqa: E402
import bench_torch_profile as pp  # noqa: E402
from bench_parity import capture_kubes, jax_script, published  # noqa: E402
from workload_variant_autoscaler_tpu_torch.models import (  # noqa: E402
    System as PSystem,
)
from workload_variant_autoscaler_tpu_torch.solver import (  # noqa: E402
    Manager as PManager,
    Optimizer as POptimizer,
)

F64 = torch.float64
CPU = {"device": "cpu", "dtype": F64}
N = 24              # variants of the collect and profile fleets
N_FUSE = 64         # bench_fuse.py's smoke fleet (512 -> 64)
N_FLEET = 256       # the 4096-server fleet, reduced
SCRIPTS = ("bench_torch_collect", "bench_torch_profile", "bench_torch_fuse",
           "bench_torch_stream", "bench_torch_streamload",
           "bench_torch_streamchaos", "bench_torch_shard", "bench_torch_hier",
           "bench_torch_goodput", "bench_torch_goodput_live",
           "bench_torch_adversary")
# measures the host CPU by design: no card, so no cuda default
HOST_SCRIPTS = ("bench_torch_cpu_tail",)


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    for knob in ("WVA_FLEET_COLLECTION", "WVA_FUSED_SOLVE",
                 "WVA_PROFILE_SAMPLE_HZ"):
        monkeypatch.delenv(knob, raising=False)
    torch.set_num_threads(1)


def counts(kube, prom) -> dict:
    return {"prom_queries": prom.count,
            "kube_lists": sum(v for k, v in kube.verb_counts.items()
                              if k.startswith("list:")),
            "kube_gets": sum(v for k, v in kube.verb_counts.items()
                             if k.startswith("get:"))}


def test_constants_equal():
    jc = jax_script("bench_collect")
    jp = jax_script("bench_profile")
    jf = jax_script("bench_fuse")
    for name in ("N_VARIANTS", "N_MODELS", "NS", "LATENCY_S"):
        assert getattr(pc, name) == getattr(jc, name), name
    assert [pc.model_name(i) for i in range(20)] \
        == [jc.model_name(i) for i in range(20)]
    assert pp.SMOKE_VARIANTS == jp.SMOKE_VARIANTS
    assert (pf.SMOKE_VARIANTS, pf.STEADY_CYCLES) \
        == (jf.SMOKE_VARIANTS, jf.STEADY_CYCLES)


@pytest.mark.parametrize("mode", ["on", "off"])
def test_collect_counts_and_decisions_equal(monkeypatch, mode):
    """timed_cycle against bench_collect.py with WVA_FLEET_COLLECTION=
    `mode`: every VA's published decision equals the JAX package's on
    either of its paths, and the port, which reads no such knob, sends
    the timed cycle's queries, LISTs and GETs of the JAX fleet path in
    both cases."""
    jc = jax_script("bench_collect")

    def jax_cycle(jax_mode):
        monkeypatch.setenv("WVA_FLEET_COLLECTION", jax_mode)
        kube, prom, rec = jc.build_cluster(N)
        rec.reconcile()
        prom.count = 0
        kube.verb_counts.clear()
        assert len(rec.reconcile().processed) == N
        return kube, counts(kube, prom)

    kube, sent = jax_cycle(mode)
    want = dict(sent if mode == "on" else jax_cycle("on")[1])
    # the port writes each status on the cycle's own VA object: the JAX
    # package's re-GET before each of the N status writes is not sent;
    # the timed cycle reads the VAs from the cache the warm-up's LIST
    # primed, not from a LIST of its own
    want["kube_gets"] -= N
    want["kube_lists"] -= 1
    monkeypatch.setenv("WVA_FLEET_COLLECTION", mode)

    kubes = capture_kubes(monkeypatch, pc)
    got = pc.timed_cycle(N, **CPU)
    assert {k: got[k] for k in want} == want
    assert published(kubes[0]) == published(kube)
    assert got["wall_s"] > 0
    k = got["kernel_launches"]
    assert k["cycles"] == 2 and k["sizing_cycles"] >= 1
    assert k["B1"] == k["B2"] == 0          # nothing launches on the CPU
    assert os.environ["WVA_FLEET_COLLECTION"] == mode
    assert want["prom_queries"] < N and want["kube_lists"] >= 1
    if mode == "off":
        assert sent["prom_queries"] > 5 * N


def test_collect_run_reports_where(monkeypatch):
    out = pc.run(8, **CPU)
    assert (out["device"], out["dtype"], out["backend"]) \
        == ("cpu", "float64", "batched")
    assert out["fleet_queries_per_cycle"] == out["fleet"]["prom_queries"]
    assert out["variants"] == 8 and out["value"] == out["fleet"]["wall_s"]
    assert "sequential" not in out


def test_profile_ledger_shape_equal(monkeypatch):
    """profiled_cycle: the bucket keyset, the aggregated span-tree shape,
    the partition invariant, an attributed fraction >= 0.9, one readback
    per cycle and the published decisions, JAX against the port."""
    jp = jax_script("bench_profile")
    jkubes = capture_kubes(monkeypatch, jp)
    monkeypatch.setenv("WVA_PROFILE_SAMPLE_HZ", "97")
    j = jp.profiled_cycle(N)
    monkeypatch.delenv("WVA_PROFILE_SAMPLE_HZ")
    jp.assert_invariants(j)

    pkubes = capture_kubes(monkeypatch, pp)
    p = pp.profiled_cycle(N, **CPU)
    pp.assert_invariants(p)
    assert "WVA_PROFILE_SAMPLE_HZ" not in os.environ
    assert pp.bucket_keys(p, pp.PORT_ONLY) == sorted(j["buckets"])
    # the port publishes on the cycle's own VA objects: no re-GET span
    # under stage:publish; and reads them from its cache: no LIST span
    # under stage:config
    assert pp.tree_shape(p["tree"], pp.PORT_ONLY) \
        == pp.tree_shape(j["tree"], ("kube.get:VariantAutoscaling/fresh",
                                     "kube.list:VariantAutoscaling"))
    assert {"system.pack", "system.decide"} <= set(p["buckets"])
    assert p["attributed_fraction"] >= 0.9
    assert p["device"]["retraces"] == {} == j["jax"]["retraces"]
    assert p["device"]["transfers"]["d2h"] \
        == j["jax"]["transfers"]["d2h"] == 1
    assert published(pkubes[0]) == published(jkubes[0])
    k = p["kernel_launches"]
    assert k["cycles"] == k["sizing_cycles"] == 2
    assert k["d2h_per_sizing_cycle"] == [1]


def test_profile_partition_breaks_are_caught():
    rec = {"wall_ms": 10.0, "buckets": {"stage:analyze": 4.0, "kube": 1.0,
                                        "prometheus": 1.0,
                                        "unattributed": 1.0},
           "attributed_fraction": 0.9, "residual_by_caller": {"x": 1.0},
           "device": {"retraces": {}, "transfers": {"h2d": 1}}}
    with pytest.raises(AssertionError, match="partition broken"):
        pp.assert_invariants(rec)
    rec["buckets"]["unattributed"] = 4.0
    pp.assert_invariants(rec)
    rec["device"]["transfers"] = {}
    with pytest.raises(AssertionError, match="uploaded nothing"):
        pp.assert_invariants(rec)


def test_fuse_steady_and_profiled_decisions_equal(monkeypatch):
    """steady_state_run and profiled_cycle at 64 variants: readbacks per
    cycle and retraces equal JAX's; the fused, the staged and the JAX
    fused decisions after the load shifts are equal."""
    jf = jax_script("bench_fuse")
    jkubes = capture_kubes(monkeypatch, jf)
    pkubes = capture_kubes(monkeypatch, pf)
    js = jf.steady_state_run(N_FUSE)
    j_on = jf.profiled_cycle(N_FUSE, "on")
    monkeypatch.delenv("WVA_FUSED_SOLVE")      # the JAX script's leftover
    ps = pf.steady_state_run(N_FUSE, **CPU)
    assert {k: ps[k] for k in ("cycles", "retraces_total", "d2h_per_cycle")} \
        == {k: js[k] for k in ("cycles", "retraces_total", "d2h_per_cycle")}
    assert ps["d2h_per_cycle"] == [1]
    assert published(pkubes[0]) == published(jkubes[0])
    assert ps["kernel_launches"]["sizing_cycles"] == 11

    p_on = pf.profiled_cycle(N_FUSE, "on", **CPU)
    p_off = pf.profiled_cycle(N_FUSE, "off", **CPU)
    assert "WVA_FUSED_SOLVE" not in os.environ
    assert published(pkubes[1]) == published(pkubes[2]) \
        == published(jkubes[1])
    assert p_on["device"]["transfers"]["d2h"] \
        == j_on["jax"]["transfers"]["d2h"] == 1
    assert p_off["device"]["transfers"]["d2h"] > 1     # a readback a step
    assert not p_on["device"]["retraces"]
    assert pp.bucket_keys(p_on, pp.PORT_ONLY) == sorted(j_on["buckets"])
    fails, budgets = pf.check({"steady_state": ps,
                               "fused": {"transfers": p_on["device"][
                                   "transfers"], "retraces": {}}})
    assert fails == [] and budgets == []


def jax_fleet_spec(n: int, distinct_loads: bool):
    """bench_fuse.fleet_4096's spec at `n` servers (the JAX script builds
    it inside the function at n = 4096)."""
    from workload_variant_autoscaler_tpu.models import make_slice
    from workload_variant_autoscaler_tpu.models.spec import (
        AllocationData,
        ModelSliceProfile,
        ModelTarget,
        OptimizerSpec,
        ServerLoadSpec,
        ServerSpec,
        ServiceClassSpec,
        SystemSpec,
    )

    models = [f"llama-8b-m{i}" for i in range(8)]
    return SystemSpec(
        accelerators=[make_slice("v5e", 1, "1x1")],
        profiles=[ModelSliceProfile(model=m, accelerator="v5e-1",
                                    alpha=6.973, beta=0.027, gamma=5.2,
                                    delta=0.1, max_batch_size=64,
                                    at_tokens=128)
                  for m in models],
        service_classes=[ServiceClassSpec(
            name="Premium", priority=1,
            model_targets=tuple(ModelTarget(model=m, slo_itl=24.0,
                                            slo_ttft=500.0)
                                for m in models))],
        servers=[ServerSpec(
            name=f"chat-{i}", service_class="Premium",
            model=models[i % 8], min_num_replicas=1,
            current_alloc=AllocationData(
                accelerator="v5e-1", num_replicas=1,
                load=ServerLoadSpec(
                    arrival_rate=(1200.0 + i * 0.37 if distinct_loads
                                  else 1200.0 + (i % 7) * 60.0),
                    avg_in_tokens=128, avg_out_tokens=128)))
            for i in range(n)],
        capacity={},
        optimizer=OptimizerSpec(unlimited=True),
    )


def decide(system_cls, manager_cls, optimizer_cls, spec, backend, **kw):
    system = system_cls(**kw)
    opt_spec = system.set_from_spec(spec)
    system.calculate(backend=backend)
    manager_cls(system, optimizer_cls(opt_spec)).optimize()
    allocs = system.generate_solution().allocations
    return ({name: (a.accelerator, a.num_replicas)
             for name, a in allocs.items()}, system.last_unique_lanes)


@pytest.mark.parametrize("distinct", [False, True])
def test_fleet_4096_reduced_equal(monkeypatch, distinct):
    """fleet_4096 at 256 servers: the spec, the unique lanes after dedup
    and every server's decision equal JAX's (its batched backend), fused
    and staged alike."""
    from workload_variant_autoscaler_tpu.models import System as JSystem
    from workload_variant_autoscaler_tpu.solver import Manager as JManager
    from workload_variant_autoscaler_tpu.solver import (
        Optimizer as JOptimizer,
    )

    jspec = jax_fleet_spec(N_FLEET, distinct)
    pspec = pf.fleet_spec(N_FLEET, distinct)
    assert dataclasses.asdict(pspec) == dataclasses.asdict(jspec)
    want, j_lanes = decide(JSystem, JManager, JOptimizer, jspec, "batched")
    got = pf.fleet_4096(distinct, N_FLEET, **CPU)
    assert got["unique_lanes"] == j_lanes == (N_FLEET if distinct else 7)
    assert got["distinct_load_levels"] == (N_FLEET if distinct else 7)
    assert got["kernel_launches"]["cycles"] == 6
    assert got["kernel_launches"]["d2h_per_sizing_cycle"] == [1]
    fused, _ = decide(PSystem, PManager, POptimizer, pspec, "batched", **CPU)
    monkeypatch.setenv("WVA_FUSED_SOLVE", "off")
    staged, _ = decide(PSystem, PManager, POptimizer, pspec, "batched",
                       **CPU)
    assert fused == staged == want
    assert len(want) == N_FLEET


def test_fuse_budget_is_reported_not_raised():
    out = {"steady_state": {"retraces_total": 0, "d2h_per_cycle": [1, 2]},
           "fused": {"transfers": {"d2h": 3}, "retraces": {}},
           "fleet_4096": {"analyze_optimize_ms_p50": 100.0}}
    fails, budgets = pf.check(out)
    assert len(fails) == 2
    assert budgets == [{"budget": "fleet_4096 analyze_optimize_ms_p50",
                        "value": 100.0, "limit": 100.0, "met": False}]


def test_knobs_restore_the_environment(monkeypatch):
    monkeypatch.setenv("WVA_FUSED_SOLVE", "auto")
    monkeypatch.delenv("WVA_PROFILE_SAMPLE_HZ", raising=False)
    with pc.knobs(WVA_FUSED_SOLVE="off", WVA_PROFILE_SAMPLE_HZ="50"):
        assert os.environ["WVA_FUSED_SOLVE"] == "off"
        assert os.environ["WVA_PROFILE_SAMPLE_HZ"] == "50"
    assert os.environ["WVA_FUSED_SOLVE"] == "auto"
    assert "WVA_PROFILE_SAMPLE_HZ" not in os.environ


@pytest.mark.parametrize("script", SCRIPTS)
def test_cli_runs_on_cuda_by_default_and_raises_without_it(script):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    module = importlib.import_module(script)
    with pytest.raises(RuntimeError, match="cuda"):
        module.main([])


@pytest.mark.parametrize("script", SCRIPTS)
def test_cli_never_writes_over_a_bench_record(script, tmp_path, capsys):
    module = importlib.import_module(script)
    record = tmp_path / "BENCH_x_r01.json"
    record.write_text("{}\n")
    with pytest.raises(SystemExit) as exc:
        module.main(["--device", "cpu", "--out", str(record)])
    assert exc.value.code == 2
    assert record.read_text() == "{}\n"
    assert "never overwritten" in capsys.readouterr().err


def test_cli_writes_out_only_when_asked(tmp_path, capsys):
    path = tmp_path / "profile.json"
    assert pp.main(["--device", "cpu", "--smoke", "--out", str(path)]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert path.read_text().strip().startswith("{")
    assert '"bench": "profile-smoke"' in line
    assert '"device": "cpu"' in line


def test_imports_neither_jax_nor_the_reference_package():
    """The bench_torch_* ports of the cycle, event-path, engine-scale and
    goodput-scoreboard benchmarks load neither JAX nor the reference
    package."""
    code = (
        "import sys\n"
        f"import {', '.join(SCRIPTS + HOST_SCRIPTS)}\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'workload_variant_autoscaler_tpu'\n"
        "             or m.startswith('workload_variant_autoscaler_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
