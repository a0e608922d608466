"""The port's host backends against the JAX package's.

- `ops/native.py` over `csrc/wva_queueing.cpp`: the port's
  NativeQueueAnalyzer gives outputs equal (==) to the JAX package's on
  every `CASES` row of tests/test_native.py and every percentile, and
  agrees with the port's scalar QueueAnalyzer to rel 1e-9 (wait time rel
  1e-7, abs 1e-9, as tests/test_native.py holds it); `size_batch_native`
  gives arrays and feasibility equal to the JAX package's, mean and
  tail form. Both libraries are built with the same g++ flags from
  sources whose ABI part is byte-equal (checked here), so any difference
  means the copy or the flags drifted.
- `System.calculate(backend="native"|"scalar")`, `Server.calculate`,
  `create_allocation`, `scale_allocation` and `reallocate` against the
  JAX package's on the same fleets: decisions exact, floats rel 1e-9.
- `ops/_build.py`'s host build: the hashed library name, the
  `WVA_NATIVE_LIB` override, and `available()` False for a library that
  lacks the ABI.

Inputs are written out or drawn from a seeded numpy generator; the JAX
side runs in float64 (tests/conftest.py).
"""

import ctypes
import subprocess
from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import pytest
import torch

from test_native import CASES
from test_torch_system import (
    RTOL,
    assert_same_decisions,
    fleet_servers,
    fleet_spec,
    p95_premium,
    run_port,
    run_reference,
)
from tests.helpers import make_system, server_spec
from workload_variant_autoscaler_tpu.models import allocation as jalloc
from workload_variant_autoscaler_tpu.ops import analyzer as jan
from workload_variant_autoscaler_tpu.ops import native as jnative
import workload_variant_autoscaler_tpu_torch as port
from workload_variant_autoscaler_tpu_torch.models import allocation as palloc
from workload_variant_autoscaler_tpu_torch.ops import _build
from workload_variant_autoscaler_tpu_torch.ops import analyzer as pan
from workload_variant_autoscaler_tpu_torch.ops import native as pnative

REPO = Path(__file__).resolve().parent.parent
PCTS = [None, 0.9, 0.95, 0.99]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_port_library_builds_and_loads():
    assert pnative.available()
    assert jnative.available()


def test_cpp_copy_abi_part_is_byte_equal_to_the_reference():
    """Everything after the first #include is the reference's
    native/wva_queueing.cpp byte for byte; only the header comment may
    differ."""
    def abi(path):
        text = path.read_bytes()
        return text[text.index(b"\n#include"):]

    mine = _build.SOURCES["wva_queueing"]
    assert mine == REPO / "workload_variant_autoscaler_tpu_torch" / "csrc" \
        / "wva_queueing.cpp"
    assert abi(mine) == abi(REPO / "native" / "wva_queueing.cpp")


def analyzers(pkg_an, nat, case):
    alpha, beta, gamma, delta, in_tok, out_tok, mb, *_ = case
    config = pkg_an.QueueConfig(max_batch_size=mb, max_queue_size=10 * mb,
                                parms=pkg_an.ServiceParms(alpha, beta, gamma,
                                                          delta))
    size = pkg_an.RequestSize(in_tok, out_tok)
    return pkg_an.QueueAnalyzer(config, size), nat.NativeQueueAnalyzer(
        config, size)


def sized(an, nat, case, pct):
    _py, native_an = analyzers(an, nat, case)
    target = an.TargetPerf(ttft=case[7], itl=case[8], tps=case[9])
    return native_an.size(target, ttft_percentile=pct)


@pytest.mark.parametrize("pct", PCTS)
@pytest.mark.parametrize("case", CASES)
def test_native_size_equals_reference_native(case, pct):
    got = sized(pan, pnative, case, pct)
    want = sized(jan, jnative, case, pct)
    assert (got.rate_ttft, got.rate_itl, got.rate_tps) == \
        (want.rate_ttft, want.rate_itl, want.rate_tps)
    assert asdict(got.metrics) == asdict(want.metrics)
    assert asdict(got.achieved) == asdict(want.achieved)


@pytest.mark.parametrize("pct", PCTS)
@pytest.mark.parametrize("case", CASES)
def test_native_size_matches_the_port_scalar_analyzer(case, pct):
    py, nat = analyzers(pan, pnative, case)
    target = pan.TargetPerf(ttft=case[7], itl=case[8], tps=case[9])
    a = py.size(target, ttft_percentile=pct)
    b = nat.size(target, ttft_percentile=pct)
    assert b.rate_ttft == pytest.approx(a.rate_ttft, rel=1e-9)
    assert b.rate_itl == pytest.approx(a.rate_itl, rel=1e-9)
    assert b.rate_tps == pytest.approx(a.rate_tps, rel=1e-9)
    assert b.metrics.throughput == pytest.approx(a.metrics.throughput,
                                                 rel=1e-9)
    assert b.metrics.avg_wait_time == pytest.approx(
        a.metrics.avg_wait_time, rel=1e-7, abs=1e-9)
    assert b.metrics.avg_token_time == pytest.approx(
        a.metrics.avg_token_time, rel=1e-9)
    assert b.metrics.rho == pytest.approx(a.metrics.rho, rel=1e-9)


@pytest.mark.parametrize("rate_frac", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("case", CASES[::3])
def test_native_analyze_equals_reference_and_scalar(case, rate_frac):
    py, nat = analyzers(pan, pnative, case)
    _jpy, jnat = analyzers(jan, jnative, case)
    rate = py.max_rate * rate_frac
    got = nat.analyze(rate)
    assert asdict(got) == asdict(jnat.analyze(rate))
    ref = py.analyze(rate)
    for f in ("throughput", "avg_resp_time", "avg_prefill_time",
              "avg_token_time", "rho"):
        assert getattr(got, f) == pytest.approx(getattr(ref, f), rel=1e-9)
    assert got.max_rate == pytest.approx(ref.max_rate, rel=1e-12)


def test_native_errors_as_reference():
    infeasible = (18.0, 0.12, 14.0, 0.3, 1024, 256, 48, 0, 0, 0)
    for an, nat in ((pan, pnative), (jan, jnative)):
        _py, n = analyzers(an, nat, infeasible)
        with pytest.raises(an.InfeasibleTargetError):
            n.size(an.TargetPerf(itl=15.0))   # below the 18 ms decode floor
        py, n = analyzers(an, nat, CASES[0])
        with pytest.raises(ValueError, match="above max allowed rate"):
            n.analyze(py.max_rate * 1.1)
    # the port's error is the port's class
    assert issubclass(pan.InfeasibleTargetError, ValueError)


def random_columns(n, seed):
    rng = np.random.default_rng(seed)
    mb = rng.choice([4, 16, 48, 64, 128, 256], n)
    return [rng.uniform(2.0, 20.0, n), rng.uniform(0.005, 0.15, n),
            rng.uniform(1.0, 15.0, n), rng.uniform(0.02, 0.3, n),
            rng.choice([0, 128, 1024], n), rng.choice([1, 32, 128, 256], n),
            mb, 11 * mb,
            rng.choice([0.0, 100.0, 500.0, 2000.0], n),
            rng.choice([0.0, 10.0, 24.0, 200.0], n),
            rng.choice([0.0, 0.0, 900.0], n)]


@pytest.mark.parametrize("pct", [None, 0.95])
def test_size_batch_native_equals_reference(pct):
    cols = random_columns(64, seed=21)
    out, feasible = pnative.size_batch_native(*cols, ttft_percentile=pct)
    want, want_ok = jnative.size_batch_native(*cols, ttft_percentile=pct)
    assert out.dtype == want.dtype and out.shape == (64, 11)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(feasible, want_ok)
    assert 0 < feasible.sum() < 64


def test_size_batch_native_matches_scalar_calls():
    cols = list(zip(*CASES))
    out, feasible = pnative.size_batch_native(
        cols[0], cols[1], cols[2], cols[3], cols[4], cols[5], cols[6],
        [11 * mb for mb in cols[6]], cols[7], cols[8], cols[9])
    assert feasible.all()
    for i, case in enumerate(CASES):
        py, _ = analyzers(pan, pnative, case)
        r = py.size(pan.TargetPerf(ttft=case[7], itl=case[8], tps=case[9]))
        assert out[i, 0] == pytest.approx(r.rate_ttft, rel=1e-9)
        assert out[i, 1] == pytest.approx(r.rate_itl, rel=1e-9)


# -- the System's host backends ----------------------------------------------


def zero_load_servers():
    return fleet_servers() + [
        server_spec(name="silent:free", service_class="Freemium",
                    arrival_rpm=0.0, min_replicas=0),
        server_spec(name="no-out", arrival_rpm=600.0, out_tokens=0)]


@pytest.mark.parametrize("backend", ["native", "scalar"])
@pytest.mark.parametrize("fleet", ["mean", "global-p95", "premium-p95"])
def test_host_backend_matches_reference(backend, fleet, monkeypatch):
    """The port's System on a host backend against the JAX System on the
    same backend, zero-load lanes included: decisions exact, floats rel
    1e-9, the same lane counts."""
    monkeypatch.delenv("WVA_NATIVE_KERNEL", raising=False)
    servers = zero_load_servers()
    classes = p95_premium() if fleet == "premium-p95" else None
    pct = 0.95 if fleet == "global-p95" else None
    spec = fleet_spec(servers) if classes is None else fleet_spec(
        servers, service_classes=classes)
    ref, opt = make_system(servers=servers)
    if classes is not None:
        ref.set_from_spec(replace(spec))
    ref, ref_sol = run_reference(ref, opt, backend, pct)
    got, got_sol = run_port(spec, backend, pct)
    assert_same_decisions(ref, ref_sol, got, got_sol)
    assert got.last_solve_lanes > 0
    assert got.last_unique_lanes == 0 == ref.last_unique_lanes


@pytest.mark.parametrize("backend", ["native", "scalar"])
def test_host_backend_only_and_rejects_a_mesh(backend):
    from workload_variant_autoscaler_tpu_torch.parallel import Mesh

    system = port.System(device="cpu", dtype=torch.float64)
    system.set_from_spec(port.spec_from_reference(asdict(
        fleet_spec(zero_load_servers()))))
    system.calculate(backend=backend, only={"idle", "chat:premium"})
    assert system.servers["idle"].all_allocations
    assert system.servers["chat:premium"].all_allocations
    assert not system.servers["batch:premium"].all_allocations
    with pytest.raises(ValueError, match="mesh"):
        system.calculate(backend=backend, mesh=Mesh(("cpu",)))
    ref, _ = make_system(servers=[server_spec()])
    with pytest.raises(ValueError):
        ref.calculate(backend=backend, mesh=object())


def test_host_backends_agree_with_the_kernel_backend():
    """native, scalar and the kernel backend (plain versions on the CPU)
    decide the same on the same fleet."""
    spec = fleet_spec(fleet_servers(), service_classes=p95_premium())
    out = {}
    for backend in ("native", "scalar", "kernel"):
        system, sol = run_port(spec, backend)
        out[backend] = {n: (a.accelerator, a.num_replicas, a.max_batch,
                            a.cost) for n, a in sol.allocations.items()}
    assert out["native"] == out["scalar"] == out["kernel"]


@pytest.mark.parametrize("native_knob", ["false", "true"])
def test_create_scale_reallocate_equal_reference(native_knob, monkeypatch):
    """create_allocation on every (server, slice), scale_allocation from
    each, and reallocate per server, through the numpy analyzer
    (WVA_NATIVE_KERNEL=false) and the native one, against the JAX
    package's; the global percentile is threaded through all three."""
    monkeypatch.setenv("WVA_NATIVE_KERNEL", native_knob)
    want_cls = (pnative.NativeQueueAnalyzer if native_knob == "true"
                else pan.QueueAnalyzer)
    assert palloc._analyzer_class() is want_cls
    servers = zero_load_servers()
    ref, _ = make_system(servers=servers)
    mine = port.System(device="cpu", dtype=torch.float64)
    mine.set_from_spec(port.spec_from_reference(asdict(fleet_spec(servers))))
    for sys_ in (ref, mine):
        for acc in sys_.accelerators.values():
            acc.calculate()

    def same(a, b, where):
        if b is None:
            assert a is None, where
            return
        for f in ("accelerator", "num_replicas", "batch_size", "cost",
                  "value"):
            assert getattr(a, f) == getattr(b, f), (where, f)
        for f in ("itl", "ttft", "rho", "max_arrv_rate_per_replica"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=RTOL,
                                                  abs=1e-12), (where, f)

    made = 0
    for pct in (None, 0.95):
        for name in ref.servers:
            for acc in ref.accelerators:
                want = jalloc.create_allocation(ref, name, acc, pct)
                got = palloc.create_allocation(mine, name, acc, pct)
                same(got, want, (name, acc, pct))
                made += want is not None
                if want is None:
                    continue
                jnew, jdelta = jalloc.scale_allocation(ref, want, name, pct)
                pnew, pdelta = palloc.scale_allocation(mine, got, name, pct)
                same(pnew, jnew, ("scale", name, acc, pct))
                assert pdelta == jdelta
            jbest, jacc = jalloc.reallocate(ref, name, pct)
            pbest, pacc = palloc.reallocate(mine, name, pct)
            assert pacc == jacc
            same(pbest, jbest, ("reallocate", name, pct))
    assert made > 20
    # the fixed nil-deref: an infeasible recompute is (None, 0)
    gone = palloc.Allocation(accelerator="v5e-16", num_replicas=3)
    assert palloc.scale_allocation(mine, gone, "nope") == (None, 0)
    assert jalloc.scale_allocation(ref, jalloc.Allocation(
        accelerator="v5e-16", num_replicas=3), "nope") == (None, 0)


def test_server_calculate_equals_reference(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "true")
    servers = fleet_servers()
    ref, _ = make_system(servers=servers)
    mine = port.System(device="cpu", dtype=torch.float64)
    mine.set_from_spec(port.spec_from_reference(asdict(fleet_spec(servers))))
    for sys_ in (ref, mine):
        for acc in sys_.accelerators.values():
            acc.calculate()
    for name in ref.servers:
        ref.servers[name].calculate(ref, ttft_percentile=0.9)
        mine.servers[name].calculate(mine, ttft_percentile=0.9)
        a, b = ref.servers[name].all_allocations, \
            mine.servers[name].all_allocations
        assert set(a) == set(b), name
        for acc in a:
            assert (b[acc].num_replicas, b[acc].cost, b[acc].value) == \
                (a[acc].num_replicas, a[acc].cost, a[acc].value)


# -- the host build -----------------------------------------------------------


@pytest.fixture
def fresh_native(monkeypatch):
    """The native module with nothing loaded yet."""
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_load_failed", False)
    return pnative


def test_library_path_carries_the_source_hash():
    import hashlib

    path = _build.library_path("wva_queueing")
    digest = hashlib.sha256(
        _build.SOURCES["wva_queueing"].read_bytes()).hexdigest()[:16]
    assert path.name == f"libwva_queueing_{digest}.so"
    assert path.parent == _build.BUILD_DIR
    assert _build.compile_command("wva_queueing", "out.so")[1:] == [
        "-O3", "-shared", "-fPIC", "-std=c++17", "-o", "out.so",
        str(_build.SOURCES["wva_queueing"])]


def test_build_writes_its_log(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    lib = _build.library("wva_queueing")
    assert _build.library_path("wva_queueing").exists()
    assert "g++ -O3 -shared -fPIC -std=c++17" in \
        _build.build_logs["wva_queueing"]
    buf = (ctypes.c_double * 8)()
    assert lib.wva_analyze(6.973, 0.027, 5.2, 0.1, 128, 128, 64, 704, 1.0,
                           buf) == 0


def test_prebuilt_library_override(fresh_native, monkeypatch):
    prebuilt = _build.library_path("wva_queueing")
    _build.library("wva_queueing")
    monkeypatch.setenv("WVA_NATIVE_LIB", str(prebuilt))
    monkeypatch.setattr(_build, "library", lambda name: pytest.fail(
        "the override must not build"))
    assert fresh_native.available()
    case = CASES[0]
    got = sized(pan, fresh_native, case, None)
    assert got.rate_ttft == sized(jan, jnative, case, None).rate_ttft


def test_library_without_the_abi_is_unavailable(fresh_native, tmp_path,
                                                monkeypatch):
    src = tmp_path / "other.cpp"
    src.write_text('extern "C" int something_else() { return 0; }\n')
    lib = tmp_path / "libother.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    monkeypatch.setenv("WVA_NATIVE_LIB", str(lib))
    assert not fresh_native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        fresh_native.size_batch_native(*random_columns(4, seed=1))
    system = port.System(device="cpu")
    with pytest.raises(RuntimeError, match="unavailable"):
        system.calculate(backend="native")


def test_no_compiler_means_unavailable(fresh_native, tmp_path, monkeypatch):
    monkeypatch.delenv("WVA_NATIVE_LIB", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    assert not fresh_native.available()
