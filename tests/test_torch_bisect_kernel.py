"""The bisection kernel's plain PyTorch version against the Pallas kernel.

On the CPU the wrapper runs the plain version (the kernel's full-grid
trip loop in torch ops); it is held against
`size_batch_pallas(interpret=True)` and
`size_batch_tail_pallas(interpret=True)` on the same numpy inputs, at the
tolerances of tests/test_pallas.py: float64 rtol 1e-9 (both walk the same
bisection trajectory), float32 rtol 1e-3 (mean) and 2e-3 (tail), since
the two order their sums and scans differently and a search can stop
one step apart near the freeze tolerance. Interpret mode costs seconds
per case, so b stays at 1 and 8.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
holds it against this plain version there.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from workload_variant_autoscaler_tpu.ops import batched as jb
from workload_variant_autoscaler_tpu.ops import pallas_kernel as jp
from workload_variant_autoscaler_tpu_torch.ops import batched as tb
from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as tk


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's intra-op threads would spin on the cores the other test
    workers run on; these tensors are small, so one thread is enough."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FIELDS = ("lam_ttft", "lam_itl", "lam_star", "throughput", "token_time",
          "rho")
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32,
                                                       torch.float32)}
QUEUE_COLS = ("alpha", "beta", "gamma", "delta", "in_tokens", "out_tokens",
              "max_batch")


def example_rows(b, seed):
    """The draw of tests/test_pallas.py example_batch, as numpy rows."""
    rng = np.random.default_rng(seed)
    rows = {
        "alpha": rng.uniform(2.0, 20.0, b), "beta": rng.uniform(0.005, 0.15, b),
        "gamma": rng.uniform(1.0, 15.0, b), "delta": rng.uniform(0.02, 0.3, b),
        "in_tokens": rng.choice([0.0, 128.0, 1024.0], b),
        "out_tokens": rng.choice([32.0, 128.0, 256.0], b),
        "max_batch": rng.choice([4, 48, 64, 96], b),
    }
    rows["ttft"] = rng.choice([0.0, 500.0, 2000.0], b)
    rows["itl"] = rng.choice([0.0, 24.0, 200.0], b)
    rows["tps"] = rng.choice([0.0, 900.0], b)
    return rows


def jax_batch(rows, dt):
    q = jb.make_queue_batch(*(rows[c] for c in QUEUE_COLS), dtype=dt)
    t = jb.SLOTargets(*(jnp.asarray(rows[c], q.alpha.dtype)
                        for c in ("ttft", "itl", "tps")))
    return q, t


def torch_batch(rows, dt, device="cpu"):
    q = tb.make_queue_batch(*(rows[c] for c in QUEUE_COLS), dtype=dt,
                            device=device)
    t = tb.SLOTargets(*(torch.as_tensor(rows[c], dtype=dt, device=device)
                        for c in ("ttft", "itl", "tps")))
    return q, t


def assert_sized_equal(ref, got, rtol):
    np.testing.assert_array_equal(np.asarray(ref.feasible),
                                  got.feasible.numpy())
    for field in FIELDS:
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=rtol, atol=1e-9, err_msg=field)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dtype,rtol", [("f64", 1e-9), ("f32", 1e-3)])
def test_plain_mean_form_matches_pallas(b, dtype, rtol):
    rows = example_rows(b, seed=b)
    k = jb.k_max_for(rows["max_batch"])
    jdt, tdt = DTYPES[dtype]
    ref = jp.size_batch_pallas(*jax_batch(rows, jdt), k, interpret=True)
    got = tk.size_batch_kernel(*torch_batch(rows, tdt), k)
    assert_sized_equal(ref, got, rtol)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("pct", [0.9, 0.95, 0.99])
@pytest.mark.parametrize("dtype,rtol", [("f64", 1e-9), ("f32", 2e-3)])
def test_plain_tail_form_matches_pallas(b, pct, dtype, rtol):
    rows = example_rows(b, seed=100 + b)
    k = jb.k_max_for(rows["max_batch"])
    jdt, tdt = DTYPES[dtype]
    ref = jp.size_batch_tail_pallas(*jax_batch(rows, jdt), k,
                                    ttft_percentile=pct, interpret=True)
    got = tk.size_batch_tail_kernel(*torch_batch(rows, tdt), k, pct)
    assert_sized_equal(ref, got, rtol)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("pct", [None, 0.95])
def test_kernel_entries_match_batched_path_at_width(pct, dtype):
    """At widths interpret mode cannot reach, the kernel entries (plain
    versions here) equal the port's own trip-loop path."""
    rows = example_rows(64, seed=7)
    k = jb.k_max_bucket(jb.k_max_for(rows["max_batch"]))
    _, tdt = DTYPES[dtype]
    q, t = torch_batch(rows, tdt)
    if pct is None:
        ref, got = tb.size_batch(q, t, k), tk.size_batch_kernel(q, t, k)
    else:
        ref = tb.size_batch_tail(q, t, k, pct)
        got = tk.size_batch_tail_kernel(q, t, k, pct)
    np.testing.assert_array_equal(ref.feasible.numpy(), got.feasible.numpy())
    rtol = 1e-9 if dtype == "f64" else (1e-3 if pct is None else 2e-3)
    for field in FIELDS:
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   getattr(ref, field).numpy(), rtol=rtol,
                                   atol=1e-9, err_msg=field)


def test_cpu_call_leaves_launch_counters_at_zero():
    tk.reset_launches()
    rows = example_rows(8, seed=3)
    k = jb.k_max_for(rows["max_batch"])
    q, t = torch_batch(rows, torch.float64)
    tk.size_batch_kernel(q, t, k)
    tk.size_batch_tail_kernel(q, t, k, 0.95)
    assert tk.launches == {"mean": 0, "tail": 0}


def test_trips_run_counts_the_early_exit():
    rows = example_rows(8, seed=4)
    k = jb.k_max_for(rows["max_batch"])
    q, t = torch_batch(rows, torch.float64)
    prob, _ = tb._sizing_problem(q, t, k)
    fcols, icols = tk.columns(prob, slice(0, 16))
    clm = tk._full_clm(q, k)
    trips = tk.trips_run(fcols, icols, clm, k)
    done0 = prob.done0.numpy()
    assert (trips.numpy()[done0] == 0).all()
    assert (trips.numpy() <= tb.bisection_trips(torch.float64)).all()
    assert (trips.numpy()[~done0] >= 1).all()


def test_wrapper_rejects_bad_inputs():
    rows = example_rows(2, seed=5)
    k = jb.k_max_for(rows["max_batch"])
    q, t = torch_batch(rows, torch.float64)
    prob, _ = tb._sizing_problem(q, t, k)
    fcols, icols = tk.columns(prob, slice(0, 4))
    clm = tk._full_clm(q, k)
    with pytest.raises(ValueError, match="fcols"):
        tk.bisect(fcols, icols, clm, k, tail_pct=0.95)   # mean columns
    with pytest.raises(ValueError, match="icols"):
        tk.bisect(fcols, icols.long(), clm, k)
    with pytest.raises(ValueError, match="clm"):
        tk.bisect(fcols, icols, clm[:, :-1], k)
    with pytest.raises(ValueError, match="dtype"):
        tk.bisect(fcols, icols, clm.float(), k)


def test_ctypes_signatures_match_the_kernel_source():
    """Every `extern "C"` function of csrc/bisect_kernel.cu is named in
    `_build.SIGNATURES` with its number of arguments, and no other name
    is: a changed launcher must not reach the card with a stale ctypes
    signature."""
    from workload_variant_autoscaler_tpu_torch.ops import _build

    src = _build.SOURCES["bisect_kernel"].read_text()
    exported = src[src.index('extern "C" {'):]
    found = {name: len([a for a in args.split(",") if a.strip()])
             for name, args in re.findall(r"\b(wva_\w+)\(([^)]*)\)\s*\{",
                                          exported)}
    declared = {name: len(argtypes) for name, (argtypes, _)
                in _build.SIGNATURES["bisect_kernel"].items()}
    assert len(found) >= 7
    assert found == declared


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from workload_variant_autoscaler_tpu_torch import System

    with pytest.raises(RuntimeError, match="cuda"):
        tb.make_queue_batch([1.0], [0.1], [1.0], [0.1], [10], [5], [4])
    with pytest.raises(RuntimeError, match="cuda"):
        System()
    with pytest.raises(RuntimeError, match="cuda"):
        System(device="cuda")
