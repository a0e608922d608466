"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and carries the `cuda` marker; on a
host without CUDA each one skips. The file imports only the port (no JAX,
no reference package), so on a machine with the card it runs without the
JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_pallas.py: float64 rtol 1e-9, float32
rtol 1e-3 (mean form) and 2e-3 (tail form).
"""

import numpy as np
import pytest
import torch

from workload_variant_autoscaler_tpu_torch.ops import batched as tb
from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as tk

pytestmark = pytest.mark.cuda

QUEUE_COLS = ("alpha", "beta", "gamma", "delta", "in_tokens", "out_tokens",
              "max_batch")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def batch(b, seed, dtype, device):
    rng = np.random.default_rng(seed)
    rows = {
        "alpha": rng.uniform(2.0, 20.0, b), "beta": rng.uniform(0.005, 0.15, b),
        "gamma": rng.uniform(1.0, 15.0, b), "delta": rng.uniform(0.02, 0.3, b),
        "in_tokens": rng.choice([0.0, 128.0, 1024.0], b),
        "out_tokens": rng.choice([32.0, 128.0, 256.0], b),
        "max_batch": rng.choice([4, 48, 64, 96, 256], b),
    }
    q = tb.make_queue_batch(*(rows[c] for c in QUEUE_COLS), dtype=dtype,
                            device=device)
    t = tb.SLOTargets(*(torch.as_tensor(rng.choice(v, b), dtype=dtype,
                                        device=device)
                        for v in ([0.0, 500.0, 2000.0], [0.0, 24.0, 200.0],
                                  [0.0, 900.0])))
    return q, t, tb.k_max_bucket(tb.k_max_for(rows["max_batch"]))


def launch_inputs(q, t, k, pct):
    b = q.batch_size
    if pct is None:
        prob, _ = tb._sizing_problem(q, t, k)
        fcols, icols = tk.columns(prob, slice(0, 2 * b))
    else:
        prob, _ = tb._tail_problem(q, t, k, pct)
        fcols, icols = tk.columns(prob, slice(0, b), slo=t.ttft,
                                  mun=tb._full_batch_mu(q))
    return fcols, icols, tk._full_clm(q, k)


@pytest.mark.parametrize("pct", [None, 0.9, 0.95, 0.99])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_version(card, pct, dtype):
    rtol = 1e-9 if dtype == torch.float64 else (1e-3 if pct is None else 2e-3)
    q, t, k = batch(96, seed=11, dtype=dtype, device=card)
    fcols, icols, clm = launch_inputs(q, t, k, pct)
    form = "mean" if pct is None else "tail"
    before = tk.launches[form]
    got = tk.bisect(fcols, icols, clm, k, pct)
    ref = tk.bisect_plain(fcols, icols, clm, k, pct)
    torch.cuda.synchronize()
    assert tk.launches[form] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol)


@pytest.mark.parametrize("pct", [None, 0.95])
def test_lane_bits_independent_of_batch_and_bucket(card, pct):
    q, t, k = batch(64, seed=12, dtype=torch.float32, device=card)
    fcols, icols, clm = launch_inputs(q, t, k, pct)
    full = tk.bisect(fcols, icols, clm, k, pct)
    rows = torch.nonzero(icols[:, tk.I_KOCC] <= 704).flatten()[:16]
    sub_clm = clm[rows % clm.shape[0]]
    for kk in (768, 3072):
        c = sub_clm[:, :kk] if kk <= k else torch.cat(
            [sub_clm, torch.zeros(len(rows), kk - k, dtype=clm.dtype,
                                  device=card)], dim=1)
        got = tk.bisect(fcols[rows].contiguous(), icols[rows].contiguous(),
                        c.contiguous(), kk, pct)
        assert torch.equal(got, full[rows])


@pytest.mark.parametrize("pct", [None, 0.95])
@pytest.mark.parametrize("backend", ["kernel", "batched"])
def test_decide_batch_lane_bits_on_card(card, backend, pct):
    """A lane's packed decision has the same bits in a batch of 64 and in
    a batch of 16 of its rows, under its own k_max bucket and under 3072
    (System._dedup_rows relies on it)."""
    from workload_variant_autoscaler_tpu_torch.ops import fused

    q, t, k = batch(64, seed=14, dtype=torch.float32, device=card)
    epi = fused.make_epilogue_batch(np.full(64, 40.0), np.ones(64),
                                    np.full(64, 3.0), torch.float32, card)
    full = fused.decide_batch(q, t, epi, k, pct, backend)
    idx = torch.arange(16, 32, device=card)

    def sub(x):
        return type(x)(*[a[idx] for a in x])

    for kk in (k, 3072):
        got = fused.decide_batch(sub(q), sub(t), sub(epi), kk, pct, backend)
        assert torch.equal(got.view(torch.int32),
                           full[:, idx].contiguous().view(torch.int32))


def test_size_batch_kernel_entries_on_card(card):
    q, t, k = batch(48, seed=13, dtype=torch.float64, device=card)
    for pct in (None, 0.95):
        if pct is None:
            ref, got = tb.size_batch(q, t, k), tk.size_batch_kernel(q, t, k)
        else:
            ref = tb.size_batch_tail(q, t, k, pct)
            got = tk.size_batch_tail_kernel(q, t, k, pct)
        assert torch.equal(ref.feasible, got.feasible)
        np.testing.assert_allclose(got.lam_star.cpu().numpy(),
                                   ref.lam_star.cpu().numpy(), rtol=1e-9)
