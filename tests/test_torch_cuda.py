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


def batch(b, seed, dtype, device, max_batch=(4, 48, 64, 96, 256)):
    rng = np.random.default_rng(seed)
    rows = {
        "alpha": rng.uniform(2.0, 20.0, b), "beta": rng.uniform(0.005, 0.15, b),
        "gamma": rng.uniform(1.0, 15.0, b), "delta": rng.uniform(0.02, 0.3, b),
        "in_tokens": rng.choice([0.0, 128.0, 1024.0], b),
        "out_tokens": rng.choice([32.0, 128.0, 256.0], b),
        "max_batch": rng.choice(max_batch, b),
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


def edge_inputs(case, pct, dtype, device):
    """Launch inputs of one edge case: rows of at most one warp's states
    (max_batch 4, 44 states), one state, frozen rows, a zero Poisson
    scale (Q(k, 0) = 1), a prefill over the SLO, a single row, or rows
    longer than 3072 states (max_batch 512, the 256-thread team)."""
    max_batch = {"under_a_warp": (4,), "one_state": (4,),
                 "over_3072_states": (64, 512)}.get(case, (4, 64, 256))
    q, t, k = batch(24, seed=21, dtype=dtype, device=device,
                    max_batch=max_batch)
    fcols, icols, clm = launch_inputs(q, t, k, pct)
    fcols, icols = fcols.clone(), icols.clone()
    if case == "one_state":
        icols[:, tk.I_KOCC] = 1
        icols[:, tk.I_NMAX] = 1
    elif case == "some_done":
        icols[::3, tk.I_DONE] = 1
    elif case == "all_done":
        icols[:, tk.I_DONE] = 1
    elif case == "zero_poisson_scale":
        fcols[:, tk.F_MUN] = 0.0
    elif case == "prefill_over_slo":
        fcols[:, tk.F_SLO] = 0.5
    elif case == "one_row":
        live = int(torch.nonzero(icols[:, tk.I_DONE] == 0)[0])
        fcols, icols = fcols[live:live + 1], icols[live:live + 1]
        clm = clm[live % clm.shape[0]:live % clm.shape[0] + 1]
    return fcols.contiguous(), icols.contiguous(), clm.contiguous(), k


EDGES = [(c, pct) for c in ("under_a_warp", "one_state", "some_done",
                            "all_done", "one_row", "over_3072_states")
         for pct in (None, 0.95)]
EDGES += [(c, 0.95) for c in ("zero_poisson_scale", "prefill_over_slo")]


@pytest.mark.parametrize("case,pct", EDGES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_version_on_edge_rows(card, case, pct, dtype):
    rtol = 1e-9 if dtype == torch.float64 else (1e-3 if pct is None else 2e-3)
    fcols, icols, clm, k = edge_inputs(case, pct, dtype, card)
    form = "mean" if pct is None else "tail"
    before = tk.launches[form]
    got = tk.bisect(fcols, icols, clm, k, pct)
    ref = tk.bisect_plain(fcols, icols, clm, k, pct)
    torch.cuda.synchronize()
    assert tk.launches[form] == before + 1
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol)
    done = icols[:, tk.I_DONE] > 0
    assert torch.equal(got[done], fcols[done, tk.F_X0])


@pytest.mark.parametrize("pct", [None, 0.95])
@pytest.mark.parametrize("k_occ,buckets", [(704, (768, 2816, 3072, 4096)),
                                           (2816, (2816, 3072, 4096)),
                                           (5632, (5632, 6144, 8192))],
                         ids=["warp_row", "block_row", "big_row"])
def test_lane_bits_independent_of_batch_and_bucket(card, pct, k_occ,
                                                   buckets):
    """One live row of 704 states (a warp's team), 2816 states (a
    128-thread team) or 5632 states (a 256-thread team), in a batch of
    16 under several k_max buckets, has the bits it has at full width;
    so has every other row of the batch whose states fit the bucket."""
    big = k_occ > 3072
    q, t, k = batch(64, seed=12, dtype=torch.float32, device=card,
                    max_batch=(4, 48, 64, 96, 256, 512) if big
                    else (4, 48, 64, 96, 256))
    fcols, icols, clm = launch_inputs(q, t, k, pct)
    full = tk.bisect(fcols, icols, clm, k, pct)
    kocc = icols[:, tk.I_KOCC]
    live = torch.nonzero((kocc == k_occ) & (icols[:, tk.I_DONE] == 0))
    others = torch.nonzero(kocc != k_occ).flatten()[:15]
    rows = torch.cat([live.flatten()[:1], others])
    assert len(rows) == 16
    sub_clm = clm[rows % clm.shape[0]]
    for kk in buckets:
        c = sub_clm[:, :kk] if kk <= k else torch.cat(
            [sub_clm, torch.zeros(len(rows), kk - k, dtype=clm.dtype,
                                  device=card)], dim=1)
        got = tk.bisect(fcols[rows].contiguous(), icols[rows].contiguous(),
                        c.contiguous(), kk, pct)
        assert torch.equal(got[0], full[rows[0]])
        fit = kocc[rows] <= kk
        assert torch.equal(got[fit], full[rows][fit])


@pytest.mark.parametrize("pct", [None, 0.95])
@pytest.mark.parametrize("backend", ["kernel", "batched"])
def test_decide_batch_lane_bits_on_card(card, backend, pct):
    """A lane's packed decision has the same bits in a batch of 64 and in
    a batch of 16 of its rows, under its own k_max bucket, 3072 and 4096
    (System._dedup_rows relies on it)."""
    from workload_variant_autoscaler_tpu_torch.ops import fused

    q, t, k = batch(64, seed=14, dtype=torch.float32, device=card)
    epi = fused.make_epilogue_batch(np.full(64, 40.0), np.ones(64),
                                    np.full(64, 3.0), torch.float32, card)
    full = fused.decide_batch(q, t, epi, k, pct, backend)
    idx = torch.arange(16, 32, device=card)

    def sub(x):
        return type(x)(*[a[idx] for a in x])

    for kk in (k, 3072, 4096):
        got = fused.decide_batch(sub(q), sub(t), sub(epi), kk, pct, backend)
        assert torch.equal(got.view(torch.int32),
                           full[:, idx].contiguous().view(torch.int32))


# the longest bucketed k_max whose shared memory (k_max rounded up to 256
# states, clm and, in the tail form, log i) fits the wrapper's limit
LONGEST = {(torch.float32, None): 57856, (torch.float64, None): 28928,
           (torch.float32, 0.95): 28928, (torch.float64, 0.95): 14336}


@pytest.mark.parametrize("dtype,pct", list(LONGEST))
def test_kernel_takes_rows_as_long_as_shared_memory_allows(card, dtype, pct):
    """Rows of up to k_max states, at the longest k_max of each form and
    dtype, against the plain version (the first port took up to 57856
    states in the float32 mean form, 28928 in float64)."""
    k_max = LONGEST[dtype, pct]
    rtol = 1e-9 if dtype == torch.float64 else (1e-3 if pct is None else 2e-3)
    q, t, k = batch(6, seed=16, dtype=dtype, device=card,
                    max_batch=(64, k_max // 11))
    assert k == k_max
    fcols, icols, clm = launch_inputs(q, t, k, pct)
    got = tk.bisect(fcols, icols, clm, k, pct)
    ref = tk.bisect_plain(fcols, icols, clm, k, pct)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol)


@pytest.mark.parametrize("dtype,pct", list(LONGEST))
def test_wrapper_refuses_what_the_kernel_cannot_take(card, dtype, pct):
    k_max = LONGEST[dtype, pct] + 256    # past the shared memory
    q, t, k = batch(4, seed=15, dtype=dtype, device=card)
    fcols, icols, clm = launch_inputs(q, t, k, pct)
    wide = torch.zeros(clm.shape[0], k_max, dtype=dtype, device=card)
    wide[:, :k] = clm
    with pytest.raises(ValueError, match="k_max"):
        tk.bisect(fcols, icols, wide, k_max, pct)


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
