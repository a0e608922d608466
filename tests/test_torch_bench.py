"""bench_torch.py (the port's candidate-sizing benchmark) against
bench.py's measurements on the same inputs.

Tolerances: the candidates exactly; the kernel route's sizings (the
kernels' plain versions on the CPU, float64) against the JAX package's
`size_batch` / `size_batch_tail` (batched XLA, float64: conftest enables
x64) within rel 1e-9 and abs 1e-9 (tests/test_pallas.py's float64
tolerances; a wait time near zero differs in its last digits); the sequential baseline's sizings (the port's
native library) against the JAX package's native analyzer exactly, both
being the same C++; the end-to-end stage's allocation dicts (replicas,
TTFT and ITL to 4 decimals) exactly, between the port's two backends
and against the JAX package's batched backend on the stage's own fleet
(`bench._PALLAS_E2E`'s `build`, at a small WVA_E2E_SERVERS).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench as jbench  # noqa: E402
import bench_torch as pbench  # noqa: E402
from workload_variant_autoscaler_tpu.ops import batched as jbatched  # noqa: E402
from workload_variant_autoscaler_tpu.ops import native as jnative  # noqa: E402
from workload_variant_autoscaler_tpu.ops.analyzer import (  # noqa: E402
    QueueConfig,
    RequestSize,
    ServiceParms,
    TargetPerf,
)
from workload_variant_autoscaler_tpu_torch.ops.bisect_kernel import (  # noqa: E402
    size_batch_kernel,
    size_batch_tail_kernel,
)

RTOL = 1e-9
ATOL = 1e-9
F64 = torch.float64
E2E_SERVERS = 6
FIELDS = ("lam_ttft", "lam_itl", "lam_tps", "lam_star", "throughput",
          "avg_wait_time", "prefill_time", "token_time", "rho",
          "achieved_ttft", "achieved_itl", "achieved_tps")


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    torch.set_num_threads(1)


@pytest.mark.parametrize("b,seed", [(64, 0), (4096, 0), (256, 7)])
def test_build_candidates_equal(b, seed):
    j, p = jbench.build_candidates(b, seed), pbench.build_candidates(b, seed)
    assert list(p) == list(j)
    for k in j:
        assert p[k].dtype == j[k].dtype and np.array_equal(p[k], j[k]), k


def jax_sizing(c, tail: bool):
    q = jbatched.make_queue_batch(
        c["alpha"], c["beta"], c["gamma"], c["delta"], c["in_tokens"],
        c["out_tokens"], c["max_batch"], dtype=jnp.float64)
    targets = jbatched.SLOTargets(
        ttft=jnp.asarray(c["ttft"], jnp.float64),
        itl=jnp.asarray(c["itl"], jnp.float64),
        tps=jnp.zeros(len(c["alpha"]), jnp.float64))
    k_max = jbatched.k_max_for(c["max_batch"])
    if tail:
        return jbatched.size_batch_tail(q, targets, k_max,
                                        ttft_percentile=pbench.TAIL_PCT)
    return jbatched.size_batch(q, targets, k_max)


@pytest.mark.parametrize("tail", [False, True], ids=["mean", "p95"])
def test_kernel_route_sizings_equal_jax(tail):
    """At B = 64 in float64, the sizings bench_card times (B1; B2 on the
    TTFT rows and B1 on the ITL rows at p95) equal JAX's size_batch /
    size_batch_tail."""
    c = pbench.build_candidates(64)
    q, targets, k_max = pbench.card_inputs(c, device="cpu", dtype=F64)
    mine = (size_batch_tail_kernel(q, targets, k_max,
                                   ttft_percentile=pbench.TAIL_PCT)
            if tail else size_batch_kernel(q, targets, k_max))
    ref = jax_sizing(c, tail)
    assert np.array_equal(mine.feasible.numpy(), np.asarray(ref.feasible))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(mine, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def test_bench_card_rates_on_the_cpu():
    """The protocol runs (warm-up, best of n runs); on the CPU the rates
    are the plain versions' and only their shape is checked."""
    rate, runs, tail_rate, tail_runs = pbench.bench_card(
        pbench.build_candidates(8), iters=1, n_runs=2, device="cpu",
        dtype=F64)
    assert len(runs) == len(tail_runs) == 2
    assert rate == max(runs) > 0 and tail_rate == max(tail_runs) > 0


def test_sequential_baseline_sizes_as_the_jax_native_analyzer():
    assert jnative.available()
    c = pbench.build_candidates(16, seed=3)
    mine = pbench.sequential_sizings(c)
    for i, got in enumerate(mine):
        qa = jnative.NativeQueueAnalyzer(
            QueueConfig(
                max_batch_size=int(c["max_batch"][i]),
                max_queue_size=int(c["max_batch"][i]) * 10,
                parms=ServiceParms(
                    alpha=float(c["alpha"][i]), beta=float(c["beta"][i]),
                    gamma=float(c["gamma"][i]), delta=float(c["delta"][i]))),
            RequestSize(avg_input_tokens=int(c["in_tokens"][i]),
                        avg_output_tokens=int(c["out_tokens"][i])))
        ref = qa.size(TargetPerf(ttft=float(c["ttft"][i]),
                                 itl=float(c["itl"][i])))
        assert (got.rate_ttft, got.rate_itl, got.rate_tps) == (
            ref.rate_ttft, ref.rate_itl, ref.rate_tps)
        assert (dataclasses.asdict(got.metrics)
                == dataclasses.asdict(ref.metrics))
    assert pbench.bench_sequential(c) > 0


def test_native_batch_rates():
    mean_runs, tail_runs = pbench.bench_native_batch(
        pbench.build_candidates(16), iters=1, n=2)
    assert len(mean_runs) == len(tail_runs) == 2
    assert min(mean_runs) > 0 and min(tail_runs) > 0


def jax_e2e_allocations(monkeypatch, n_servers: int) -> dict:
    """The JAX package's batched allocations on bench.py's end-to-end
    fleet (the stage's own `build`, run up to the System it returns)."""
    monkeypatch.setenv("WVA_E2E_SERVERS", str(n_servers))
    head = jbench._PALLAS_E2E.split("\nsysm = build()")[0]
    ns: dict = {}
    exec(compile(head, "bench._PALLAS_E2E", "exec"), ns)
    sysm = ns["build"]()
    sysm.calculate(backend="batched")
    return pbench.allocations(sysm)


def test_e2e_stage_backends_agree_and_equal_jax(monkeypatch):
    res = pbench.e2e_stage(E2E_SERVERS, 2, device="cpu", dtype=F64)
    assert res["backends_agree"] is True
    assert res["n_servers"] == E2E_SERVERS
    assert res["n_candidates"] == 2 * E2E_SERVERS
    for backend in ("batched", "kernel"):
        row = res[backend]
        assert row["cycles"] == 2
        assert 0 < row["min_ms"] <= row["p50_ms"]
    sysm = pbench.e2e_system(E2E_SERVERS, device="cpu", dtype=F64)
    sysm.calculate(backend="kernel")
    mine = pbench.allocations(sysm)
    assert mine == jax_e2e_allocations(monkeypatch, E2E_SERVERS)
    # both service classes present: the p95 class runs the tail form
    assert len(mine) == E2E_SERVERS
    assert all(len(accs) == 2 for accs in mine.values())


def test_compose_record():
    card = {"rate": 2.0e6, "runs": [1.5e6, 2.0e6], "tail_rate": 1.0e6,
            "tail_runs": [1.0e6, 0.9e6], "candidates": 4096}
    rec = pbench._compose(card, 1000.0, ([10.0, 12.0], [3.0, 2.0]),
                          {"backends_agree": True}, "cpu", F64)
    assert rec["metric"] == "candidate_sizings_per_sec"
    assert rec["unit"] == "candidates/s"
    assert rec["value"] == 2.0e6 and rec["vs_baseline"] == 2000.0
    assert rec["tail_sizings_per_sec"] == 1.0e6
    assert rec["native_batch"]["rate"] == 12.0
    assert rec["native_batch"]["tail_rate"] == 3.0
    assert rec["device"] == "cpu" and rec["dtype"] == "float64"


def test_max_seconds_guard_raises(monkeypatch):
    monkeypatch.setattr(pbench, "bench_card",
                        lambda c, **kw: (1.0, [1.0], 1.0, [1.0]))
    with pytest.raises(TimeoutError, match="native batch"):
        pbench.run(8, max_seconds=-1.0, device="cpu", dtype=F64)


def test_without_cuda_the_default_device_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        pbench.run(8)
    with pytest.raises(RuntimeError, match="cuda"):
        pbench.main(["--candidates", "8"])


def test_device_name_asks_nvidia_smi_for_the_card_by_uuid(monkeypatch):
    """The label every record carries names torch's card by its UUID
    (torch's index need not be nvidia-smi's), and "cpu" on the host."""
    from types import SimpleNamespace

    from workload_variant_autoscaler_tpu_torch.utils import device as udev

    asked = []

    def smi(cmd, **kw):
        asked.append(cmd)
        return SimpleNamespace(stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")

    monkeypatch.setattr(udev.subprocess, "run", smi)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(uuid=f"uuid-of-{i}"))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert udev.device_name("cpu") == "cpu"
    assert udev.device_name("cuda:1") == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert udev.device_name("cuda") == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert [c[-2:] for c in asked] == [["-i", "GPU-uuid-of-1"],
                                       ["-i", "GPU-uuid-of-2"]]


def test_imports_neither_jax_nor_the_reference_package():
    """bench_torch_loop.py and bench_torch.py load neither JAX nor the
    reference package."""
    code = (
        "import sys\n"
        "import bench_torch_loop, bench_torch\n"
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
