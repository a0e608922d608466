"""A run with the timed path broken underneath comes out not correct:
the harness's run with its card check skipped (device="cpu", a tiny
fleet), once for each fault a cell of this benchmark can have. The
exchange between chips has no fault here: every cell runs on one card.

- stale: a decision step that returns its previous state (each
  `decide_batch` answers what the call before it computed);
- half: half of each batch's lanes left out (every other lane reads
  infeasible);
- altered: an answer altered where it is produced (the bisection's
  rates 1% high: the CUDA kernel's on the card, the PyTorch trip loop's
  that stands in for it on the CPU)."""

import time

import pytest

from benchmark import spec
from benchmark.run import run_cell
from conftest import TINY

CELLS = [w["name"] for w in spec.bench()["workloads"]]

FUSED = "workload_variant_autoscaler_tpu_torch.ops.fused"
KERNEL = "workload_variant_autoscaler_tpu_torch.ops.bisect_kernel"
LOOP = "workload_variant_autoscaler_tpu_torch.ops.batched"


def stale(orig):
    prev = {}

    def f(q, *a, **kw):
        key = kw.get("ttft_percentile", a[3] if len(a) > 3 else None)
        out = orig(q, *a, **kw)
        last = prev.get(key)
        prev[key] = out
        return out if last is None or last.shape != out.shape else last
    return f


def half(orig):
    def f(*a, **kw):
        out = orig(*a, **kw).clone()
        out[0, 1::2] = 0.0
        return out
    return f


def altered(orig):
    def f(*a, **kw):
        return orig(*a, **kw) * 1.01
    return f


FAULTS = {"stale": {(FUSED, "decide_batch"): stale},
          "half": {(FUSED, "decide_batch"): half},
          "altered": {(KERNEL, "bisect"): altered,
                      (LOOP, "_bisect"): altered}}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault):
    res, lines = run_cell(cell, 2**31 + 3, 3.0, False, device="cpu",
                          t_start=time.perf_counter(), deployment=TINY,
                          traffic=({"rate_per_s": 3.0} if "push" in cell
                                   else None),
                          faults=FAULTS[fault])
    assert res["correct"] is False, lines
