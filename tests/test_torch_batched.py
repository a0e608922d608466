"""The PyTorch port's batched solve and sizing against the JAX reference.

The same inputs, drawn with numpy from a seed, go through
`workload_variant_autoscaler_tpu.ops.batched` (JAX, CPU) and
`workload_variant_autoscaler_tpu_torch.ops.batched` (PyTorch, CPU).
Tolerances: float64 rtol 1e-9 (both keep the same operation order; the
observed gap is ~1e-14). float32 rtol 1e-3 for the mean sizing and 2e-3
for the tail sizing, the float32 tolerances of tests/test_pallas.py: the
two frameworks round sums and transcendentals differently, and near the
bisection's freeze tolerance a search can stop one step apart.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from workload_variant_autoscaler_tpu.ops import batched as jb
from workload_variant_autoscaler_tpu_torch.ops import batched as tb


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
RTOL_MEAN = {"f64": 1e-9, "f32": 1e-3}
RTOL_TAIL = {"f64": 1e-9, "f32": 2e-3}

# (alpha, beta, gamma, delta, in_tok, out_tok, max_batch): the edge cases
# of tests/test_batched.py, decode-only single token included
CASES = [
    (10.0, 0.3, 10.0, 0.001, 1000, 100, 8),
    (6.973, 0.027, 5.2, 0.1, 128, 128, 64),
    (20.58, 0.41, 5.2, 0.1, 64, 100, 4),
    (2.0, 0.05, 1.0, 0.0005, 2048, 256, 32),
    (10.0, 0.3, 10.0, 0.001, 0, 1, 8),
    (5.0, 0.1, 3.0, 0.01, 200, 1, 16),
]


def random_rows(b, seed):
    rng = np.random.default_rng(seed)
    return {
        "alpha": rng.uniform(2.0, 20.0, b), "beta": rng.uniform(0.005, 0.15, b),
        "gamma": rng.uniform(1.0, 15.0, b), "delta": rng.uniform(0.02, 0.3, b),
        "in_tokens": rng.choice([0.0, 128.0, 1024.0], b),
        "out_tokens": rng.choice([32.0, 128.0, 256.0], b),
        "max_batch": rng.choice([4, 48, 64, 96], b),
        "ttft": rng.choice([0.0, 500.0, 2000.0], b),
        "itl": rng.choice([0.0, 24.0, 200.0], b),
        "tps": rng.choice([0.0, 900.0], b),
    }


def case_rows(ttft, itl, tps=0.0):
    a, b, g, d, it, ot, mb = map(np.array, zip(*CASES))
    n = len(CASES)
    return {"alpha": a, "beta": b, "gamma": g, "delta": d, "in_tokens": it,
            "out_tokens": ot, "max_batch": mb, "ttft": np.full(n, ttft),
            "itl": np.full(n, itl), "tps": np.full(n, tps)}


QUEUE_COLS = ("alpha", "beta", "gamma", "delta", "in_tokens", "out_tokens",
              "max_batch")


def jax_batch(rows, dt):
    q = jb.make_queue_batch(*(rows[c] for c in QUEUE_COLS), dtype=dt)
    t = jb.SLOTargets(*(jnp.asarray(rows[c], q.alpha.dtype)
                        for c in ("ttft", "itl", "tps")))
    return q, t


def torch_batch(rows, dt):
    q = tb.make_queue_batch(*(rows[c] for c in QUEUE_COLS), dtype=dt,
                            device="cpu")
    t = tb.SLOTargets(*(torch.as_tensor(rows[c], dtype=dt)
                        for c in ("ttft", "itl", "tps")))
    return q, t


def assert_sized_equal(ref, got, rtol):
    np.testing.assert_array_equal(np.asarray(ref.feasible),
                                  got.feasible.numpy())
    for field in FIELDS:
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=rtol, atol=1e-9, err_msg=field)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("b,seed", [(8, 1), (128, 3)])
def test_size_batch_matches_jax(b, seed, dtype):
    rows = random_rows(b, seed)
    k = jb.k_max_for(rows["max_batch"])
    jdt, tdt = DTYPES[dtype]
    ref = jb.size_batch(*jax_batch(rows, jdt), k)
    got = tb.size_batch(*torch_batch(rows, tdt), k)
    assert_sized_equal(ref, got, RTOL_MEAN[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("pct", [0.9, 0.99])   # 0.95: the edge cases below
def test_size_batch_tail_matches_jax(pct, dtype):
    rows = random_rows(24, int(pct * 100))
    k = jb.k_max_for(rows["max_batch"])
    jdt, tdt = DTYPES[dtype]
    ref = jb.size_batch_tail(*jax_batch(rows, jdt), k, ttft_percentile=pct)
    got = tb.size_batch_tail(*torch_batch(rows, tdt), k, pct)
    assert_sized_equal(ref, got, RTOL_TAIL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_analyze_batch_matches_jax(dtype):
    rows = random_rows(32, 5)
    k = jb.k_max_for(rows["max_batch"])
    jdt, tdt = DTYPES[dtype]
    jq, _ = jax_batch(rows, jdt)
    tq, _ = torch_batch(rows, tdt)
    _lo, lam_max = tb._rate_range(tq)
    # rates inside the stable range, plus zero and above-max lanes
    rates = (lam_max.double().numpy() * 1000.0
             * np.random.default_rng(5).uniform(0.05, 1.2, 32))
    rates[0] = 0.0
    ref = jb.analyze_batch(jq, jnp.asarray(rates), k)
    got = tb.analyze_batch(tq, torch.as_tensor(rates), k)
    np.testing.assert_array_equal(np.asarray(ref["valid_rate"]),
                                  got["valid_rate"].numpy())
    # the wait W = T - S cancels two times of up to ~1e4 ms: in float32
    # it carries an absolute error of a few ulps of T, not of W
    t_ulps = 4 * np.finfo(np.float32).eps * float(
        np.max(np.abs(np.asarray(ref["avg_resp_time"]))))
    for key in ("throughput", "avg_resp_time", "avg_wait_time",
                "avg_num_in_serv", "avg_prefill_time", "avg_token_time",
                "ttft", "max_rate", "rho"):
        atol = t_ulps if dtype == "f32" and key in (
            "avg_wait_time", "ttft") else 1e-9
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=RTOL_MEAN[dtype], atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("sizing", ["mean", "tail"])
@pytest.mark.parametrize("name,targets", [
    # reachable targets: the Llama-8B fit case of test_batched.py
    ("in_region", dict(ttft=500.0, itl=24.0)),
    # ITL below the decode floor: below the region, infeasible
    ("below_region", dict(ttft=0.0, itl=1.0)),
    # every target disabled: each lane runs at its max stable rate
    ("disabled", dict(ttft=0.0, itl=0.0)),
    # a TPS target applies the stability margin
    ("tps_margin", dict(ttft=0.0, itl=0.0, tps=900.0)),
])
def test_edge_cases_match_jax(name, targets, sizing, dtype):
    rows = case_rows(**targets)
    k = jb.k_max_for(rows["max_batch"])
    jdt, tdt = DTYPES[dtype]
    if sizing == "mean":
        ref = jb.size_batch(*jax_batch(rows, jdt), k)
        got = tb.size_batch(*torch_batch(rows, tdt), k)
    else:
        ref = jb.size_batch_tail(*jax_batch(rows, jdt), k,
                                 ttft_percentile=0.95)
        got = tb.size_batch_tail(*torch_batch(rows, tdt), k, 0.95)
    assert_sized_equal(ref, got, (RTOL_MEAN if sizing == "mean"
                                  else RTOL_TAIL)[dtype])
    if name == "below_region":
        assert not got.feasible[:4].any()
    if name == "tps_margin":
        np.testing.assert_allclose(
            got.lam_star.numpy(), (got.lam_tps).numpy(), rtol=0)


def test_decode_only_lane_uses_one_decode():
    """in_tokens=0, out_tokens=1: one decode per request, no prefill."""
    rows = case_rows(ttft=0.0, itl=0.0)
    q, _ = torch_batch(rows, torch.float64)
    nd = tb._num_decode(q).numpy()
    assert nd[4] == 1.0 and nd[5] == 0.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("tail", [False, True])
def test_lane_result_is_bitwise_independent_of_batch_and_bucket(tail, dtype):
    """One lane placed in batches of other sizes and under other k_max
    buckets gives identical bits (what System._dedup_rows relies on)."""
    lane = random_rows(1, 99)
    lane["ttft"][:] = 500.0
    lane["itl"][:] = 200.0
    lane["max_batch"][:] = 64
    got = []
    for b, k in ((16, 768), (16, 3072), (37, 768), (5, 3072)):
        rows = random_rows(b, b)
        rows["max_batch"] = np.minimum(rows["max_batch"], 64)
        for c in rows:
            rows[c][3] = lane[c][0]
        q, t = torch_batch(rows, dtype)
        r = (tb.size_batch_tail(q, t, k, 0.95) if tail
             else tb.size_batch(q, t, k))
        got.append(torch.stack([f[3].to(dtype) for f in r]))
    for other in got[1:]:
        assert torch.equal(other, got[0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lane_stable_reductions(dtype):
    """The prefix and row sums give a row's bits whatever the grid width
    and the rows around it, and agree with torch.cumsum / torch.sum
    (rtol: float64 1e-12, float32 1e-5, rounding of ~300 terms)."""
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.uniform(0.0, 2.0, (6, 1000)), dtype=dtype)
    x[:, 300:] = 0.0                      # masked states past the row's end
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    pre = tb._prefix_sum(x)
    torch.testing.assert_close(pre, torch.cumsum(x, dim=1), rtol=rtol,
                               atol=0.0)
    assert torch.equal(tb._prefix_sum(x[:, :300]), pre[:, :300])
    assert torch.equal(tb._prefix_sum(x[[4, 1]]), pre[[4, 1]])
    sums = tb._row_sum(x)
    torch.testing.assert_close(sums, x.sum(dim=1), rtol=rtol, atol=0.0)
    for width in (300, 512, 769):
        assert torch.equal(tb._row_sum(x[:, :width]), sums)
    assert torch.equal(tb._row_sum(x[2:3]), sums[2:3])


def test_bisection_trips_per_dtype():
    assert tb.bisection_trips(torch.float64) == 100
    assert tb.bisection_trips(torch.float32) == 48


def test_k_max_helpers_match_jax():
    for mb in ([4, 48], [64], [256, 1], [96, 128]):
        assert tb.k_max_for(mb) == jb.k_max_for(mb)
        k = tb.k_max_for(mb)
        assert tb.k_max_bucket(k) == jb.k_max_bucket(k)
    assert tb.head_width(2816) == jb.head_width(2816)


def test_queue_batch_defaults():
    q = tb.make_queue_batch([1.0, 2.0], [0.1, 0.1], [1.0, 1.0], [0.1, 0.1],
                            [10, 10], [5, 5], [4, 8], device="cpu")
    assert q.alpha.dtype == torch.float32
    assert q.max_batch.dtype == torch.int32
    assert q.occupancy.tolist() == [44, 88]
    assert q.valid.tolist() == [True, True]
    assert q.batch_size == 2
