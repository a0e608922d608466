"""The port's packed [7, B] decide_batch against the JAX decide_batch.

Same numpy inputs through `workload_variant_autoscaler_tpu.ops.fused`
(JAX, CPU; its inputs are donated, so they are rebuilt for every call)
and `workload_variant_autoscaler_tpu_torch.ops.fused` on the CPU, with
the sizing stage as the PyTorch trip loop ("batched") or the kernels'
plain versions ("kernel"). float64: the decision rows (feasible,
replicas, cost) are equal exactly and the telemetry rows agree to rtol
1e-9. float32: rtol 1e-3 (mean) / 2e-3 (tail), the tolerances of
tests/test_pallas.py, and replica counts equal wherever demand/rate* is
not within that tolerance of an integer (where ceil may round either
way).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from workload_variant_autoscaler_tpu.ops import batched as jb
from workload_variant_autoscaler_tpu.ops import fused as jf
from workload_variant_autoscaler_tpu_torch.ops import batched as tb
from workload_variant_autoscaler_tpu_torch.ops import fused as tf


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's intra-op threads would spin on the cores the other test
    workers run on; these tensors are small, so one thread is enough."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32,
                                                       torch.float32)}
QUEUE_COLS = ("alpha", "beta", "gamma", "delta", "in_tokens", "out_tokens",
              "max_batch")


def rows_for(b, seed):
    rng = np.random.default_rng(seed)
    rows = {
        "alpha": rng.uniform(3.0, 12.0, b), "beta": rng.uniform(0.01, 0.08, b),
        "gamma": rng.uniform(2.0, 8.0, b), "delta": rng.uniform(0.02, 0.15, b),
        "in_tokens": rng.choice([0.0, 128.0, 512.0], b),
        "out_tokens": rng.choice([64.0, 128.0, 256.0], b),
        "max_batch": rng.choice([16, 48, 64, 96], b),
        "ttft": rng.choice([0.0, 500.0, 2000.0], b),
        "itl": rng.choice([0.0, 24.0, 60.0], b),
        "tps": rng.choice([0.0, 0.0, 900.0], b),
        "demand": rng.uniform(0.0, 60.0, b),
        "min_replicas": rng.choice([0, 1, 2], b),
        "cost_rate": rng.choice([20.0, 80.0, 160.0], b),
    }
    rows["demand"][::7] = 0.0
    return rows


def jax_decide(rows, dt, k, pct):
    q = jb.make_queue_batch(*(rows[c] for c in QUEUE_COLS), dtype=dt)
    d = q.alpha.dtype
    t = jb.SLOTargets(*(jnp.asarray(rows[c], d) for c in ("ttft", "itl", "tps")))
    epi = jf.make_epilogue_batch(rows["demand"], rows["min_replicas"],
                                 rows["cost_rate"], d)
    return np.asarray(jf.decide_batch(q, t, epi, k, ttft_percentile=pct))


def torch_decide(rows, dt, k, pct, backend):
    q = tb.make_queue_batch(*(rows[c] for c in QUEUE_COLS), dtype=dt,
                            device="cpu")
    t = tb.SLOTargets(*(torch.as_tensor(rows[c], dtype=dt)
                        for c in ("ttft", "itl", "tps")))
    epi = tf.make_epilogue_batch(rows["demand"], rows["min_replicas"],
                                 rows["cost_rate"], dt, "cpu")
    return tf.decide_batch(q, t, epi, k, ttft_percentile=pct,
                           backend=backend).numpy()


@pytest.mark.parametrize("backend", ["batched", "kernel"])
@pytest.mark.parametrize("pct", [None, 0.95])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_decide_batch_matches_jax(dtype, pct, backend):
    rows = rows_for(48, seed=21 if pct is None else 22)
    k = jb.k_max_bucket(jb.k_max_for(rows["max_batch"]))
    jdt, tdt = DTYPES[dtype]
    ref = jax_decide(rows, jdt, k, pct)
    got = torch_decide(rows, tdt, k, pct, backend)
    assert got.shape == ref.shape == (tf.N_ROWS, 48)
    assert (tf.ROW_FEASIBLE, tf.ROW_REPLICAS, tf.ROW_COST, tf.ROW_ITL,
            tf.ROW_TTFT, tf.ROW_RHO, tf.ROW_RATE_STAR) == (
        jf.ROW_FEASIBLE, jf.ROW_REPLICAS, jf.ROW_COST, jf.ROW_ITL,
        jf.ROW_TTFT, jf.ROW_RHO, jf.ROW_RATE_STAR)
    assert ref[tf.ROW_FEASIBLE].sum() > 10          # a real mix of lanes
    if dtype == "f64":
        for r in (tf.ROW_FEASIBLE, tf.ROW_REPLICAS, tf.ROW_COST):
            np.testing.assert_array_equal(got[r], ref[r])
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)
        return
    rtol = 1e-3 if pct is None else 2e-3
    np.testing.assert_allclose(got[tf.ROW_RATE_STAR], ref[tf.ROW_RATE_STAR],
                               rtol=rtol, atol=1e-6)
    ratio = rows["demand"] / np.where(ref[tf.ROW_RATE_STAR] > 0,
                                      ref[tf.ROW_RATE_STAR], 1.0)
    clear = np.abs(ratio - np.round(ratio)) > rtol * np.maximum(ratio, 1.0)
    for r in (tf.ROW_FEASIBLE, tf.ROW_REPLICAS, tf.ROW_COST):
        np.testing.assert_array_equal(got[r][clear], ref[r][clear])
    same = clear & (got[tf.ROW_REPLICAS] == ref[tf.ROW_REPLICAS])
    for r in (tf.ROW_ITL, tf.ROW_RHO):
        np.testing.assert_allclose(got[r][same], ref[r][same], rtol=rtol,
                                   atol=1e-6)


def test_padded_epilogue_lanes_size_to_nothing():
    rows = rows_for(5, seed=3)
    k = jb.k_max_for(rows["max_batch"])
    q = tb.make_queue_batch(*(rows[c] for c in QUEUE_COLS),
                            dtype=torch.float64, device="cpu")
    t = tb.SLOTargets(*(torch.as_tensor(rows[c], dtype=torch.float64)
                        for c in ("ttft", "itl", "tps")))
    epi = tf.make_epilogue_batch(rows["demand"], rows["min_replicas"],
                                 rows["cost_rate"], torch.float64, "cpu",
                                 pad_to=8)
    assert epi.demand.shape == (8,) and epi.min_replicas.dtype == torch.int32
    assert epi.demand[5:].tolist() == [0.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="backend"):
        tf.decide_batch(q, t, epi, k, backend="pallas")
