"""The port's capacity planner against the JAX package's.

`planner.plan` sizes every slice option for a load: the mean form on the
host (QueueAnalyzer, numpy, in both packages), the tail form
(`ttft_percentile`) in one batched sizing, which in the port goes
through the kernels' wrappers (B2 on the TTFT rows, B1 on the ITL rows;
their plain versions on the CPU). Over a profile set drawn around the
Llama-3.1-8B fit on every default slice shape, plus options that are
infeasible (an ITL floor above the target, a prefill that leaves no
TTFT slack) or invalid (no batch slot), the rows must equal the JAX
package's: acc, feasibility, reason, replicas and order exactly, every
float within rel 1e-9 (the JAX side in float64, the port on the CPU in
float64).

The CLI (`python -m ...planner`) takes its device from WVA_PLATFORM, as
the controller does: the card unless `cpu`, and it sizes in float32,
the JAX CLI's own default. Its `--json` output on the mean form equals
the JAX CLI's exactly; on the tail form it equals the port's `plan` in
float32 exactly, and the JAX CLI's in rows, feasibility and replicas,
its rates within rel 1e-4 (float32 against the JAX side's float64).
"""

import json
import math
from dataclasses import asdict

import numpy as np
import pytest
import torch
import yaml

from workload_variant_autoscaler_tpu import planner as jp
from workload_variant_autoscaler_tpu.ops.analyzer import TargetPerf as JTarget
from workload_variant_autoscaler_tpu_torch import planner as pp
from workload_variant_autoscaler_tpu_torch.models.chips import DEFAULT_SLICES
from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel as bk
from workload_variant_autoscaler_tpu_torch.ops.analyzer import (
    TargetPerf as PTarget,
)

F64 = torch.float64
# per-slice speed relative to v5e-1 (the decode/prefill times scale by it)
SPEED = (1.0, 0.55, 0.4, 0.3, 0.35, 0.25, 0.65, 0.35, 0.3)


def profiles(seed: int = 0, fits: int = 3) -> list[dict]:
    """`fits` candidate fits per default slice shape around the
    Llama-3.1-8B profile, then four options that cannot hold the SLO
    or hold it only at a trickle."""
    rng = np.random.default_rng(seed)
    out = []
    for s, sl in enumerate(DEFAULT_SLICES):
        for _ in range(fits):
            u = rng.uniform(0.8, 1.25, 4)
            f = SPEED[s] * rng.uniform(0.95, 1.05)
            out.append({"acc": sl.name, "cost": float(sl.cost),
                        "alpha": float(6.973 * u[0] * f),
                        "beta": float(0.027 * u[1] * f),
                        "gamma": float(5.2 * u[2] * f),
                        "delta": float(0.1 * u[3] * f),
                        "maxBatch": int(rng.choice([64, 128, 256])),
                        "accCount": 1 + s % 2})
    out += [
        {"acc": "itl-floor", "cost": 5.0, "alpha": 30.0, "beta": 0.1,
         "gamma": 5.0, "delta": 0.1, "maxBatch": 64},
        {"acc": "no-slot", "cost": 5.0, "alpha": 6.0, "beta": 0.02,
         "gamma": 5.0, "delta": 0.1, "maxBatch": 0},
        {"acc": "prefill-bound", "cost": 5.0, "alpha": 6.0, "beta": 0.02,
         "gamma": 495.0, "delta": 0.1, "maxBatch": 64},
        {"acc": "slow-prefill", "cost": 5.0, "alpha": 6.0, "beta": 0.02,
         "gamma": 480.0, "delta": 0.01, "maxBatch": 128},
    ]
    return out


def options(mod, docs):
    return [mod.SliceOption(
        acc=d["acc"], cost=d["cost"], alpha=d["alpha"], beta=d["beta"],
        gamma=d["gamma"], delta=d["delta"], max_batch=d["maxBatch"],
        acc_count=d.get("accCount", 1)) for d in docs]


def same_rows(a, b, rel: float) -> list:
    """Where two plans differ (floats beyond `rel`)."""
    bad = []
    if len(a) != len(b):
        return [("rows", len(a), len(b))]
    for i, (x, y) in enumerate(zip(a, b)):
        dx, dy = (r if isinstance(r, dict) else asdict(r) for r in (x, y))
        for k, v in dx.items():
            w = dy[k]
            if isinstance(v, float) and isinstance(w, float):
                if not (v == w or math.isclose(v, w, rel_tol=rel)):
                    bad.append((i, k, v, w))
            elif v != w:
                bad.append((i, k, v, w))
    return bad


@pytest.mark.parametrize("pct", [None, 0.9, 0.95, 0.99])
@pytest.mark.parametrize("rate,tps", [(50.0, 0.0), (400.0, 0.0),
                                      (20.0, 3000.0)])
def test_plan_rows_equal_jax(pct, rate, tps):
    docs = profiles()
    a = jp.plan(options(jp, docs), JTarget(ttft=500.0, itl=24.0, tps=tps),
                rate, 128, 128, ttft_percentile=pct)
    b = pp.plan(options(pp, docs), PTarget(ttft=500.0, itl=24.0, tps=tps),
                rate, 128, 128, ttft_percentile=pct, device="cpu",
                dtype=F64)
    assert same_rows(a, b, 1e-9) == []
    feasible = [r for r in b if r.feasible]
    assert 0 < len(feasible) < len(b)
    assert {r.acc for r in b if not r.feasible} >= {"itl-floor", "no-slot"}


def test_tail_form_goes_through_the_kernel_wrappers(monkeypatch):
    """The tail form calls the kernels' wrapper twice (B2 on the TTFT
    rows, B1 on the ITL rows), with the options the analyzer accepts; on
    the CPU each call runs the plain version and counts no launch."""
    calls = []
    orig = bk.bisect

    def spy(fcols, icols, clm, k_max, tail_pct=None):
        calls.append((fcols.shape[0], tail_pct, clm.device.type))
        return orig(fcols, icols, clm, k_max, tail_pct)

    monkeypatch.setattr(bk, "bisect", spy)
    bk.reset_launches()
    docs = profiles()
    pp.plan(options(pp, docs), PTarget(ttft=500.0, itl=24.0), 50.0, 128,
            128, ttft_percentile=0.95, device="cpu", dtype=F64)
    rows = len(docs) - 1    # the no-slot option is not sized
    assert calls == [(rows, 0.95, "cpu"), (rows, None, "cpu")]
    assert bk.launches == {"mean": 0, "tail": 0}
    calls.clear()
    pp.plan(options(pp, docs), PTarget(ttft=500.0, itl=24.0), 50.0, 128,
            128, device="cpu", dtype=F64)
    assert calls == []


def test_plan_needs_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opts = options(pp, profiles()[:3])
    for pct in (None, 0.95):
        with pytest.raises(RuntimeError, match="cuda"):
            pp.plan(opts, PTarget(ttft=500.0, itl=24.0), 50.0, 128, 128,
                    ttft_percentile=pct)
    assert pp.plan([], PTarget(ttft=500.0), 1.0, 128, 128,
                   device="cpu") == []


def test_load_options_and_table_equal_jax(tmp_path):
    path = tmp_path / "profiles.yaml"
    path.write_text(yaml.safe_dump(profiles(1, fits=1)))
    a, b = jp.load_options(str(path)), pp.load_options(str(path))
    assert [asdict(o) for o in b] == [asdict(o) for o in a]
    rows_a = jp.plan(a, JTarget(ttft=500.0, itl=24.0), 30.0, 128, 128)
    rows_b = pp.plan(b, PTarget(ttft=500.0, itl=24.0), 30.0, 128, 128,
                     device="cpu")
    assert pp.format_table(rows_b) == jp.format_table(rows_a)
    for bad in ("- acc: x\n", "acc: x\n", "- [1, 2]\n",
                "- {acc: x, cost: y, alpha: 1, beta: 1, gamma: 1, "
                "delta: 1}\n"):
        path.write_text(bad)
        with pytest.raises(ValueError) as pe:
            pp.load_options(str(path))
        with pytest.raises(ValueError) as je:
            jp.load_options(str(path))
        assert str(pe.value) == str(je.value)


def cli(mod, argv, capsys) -> tuple[int, str]:
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


def test_cli_json_equals_jax(tmp_path, capsys, monkeypatch):
    path = tmp_path / "profiles.yaml"
    path.write_text(yaml.safe_dump(profiles(2, fits=2)))
    argv = ["--profiles", str(path), "--rate", "60", "--slo-ttft", "500",
            "--slo-itl", "24", "--json"]
    monkeypatch.setenv("WVA_PLATFORM", "cpu")
    rc_j, out_j = cli(jp, argv, capsys)
    rc_p, out_p = cli(pp, argv, capsys)
    assert rc_j == rc_p == 0
    assert out_p == out_j
    tail = argv + ["--ttft-percentile", "0.95"]
    rc_j, out_j = cli(jp, tail, capsys)
    rc_p, out_p = cli(pp, tail, capsys)
    assert rc_j == rc_p == 0
    mine = json.loads(out_p)
    own = pp.plan(pp.load_options(str(path)),
                  PTarget(ttft=500.0, itl=24.0), 60.0, 128, 128,
                  ttft_percentile=0.95, device="cpu", dtype=torch.float32)
    assert mine == [asdict(r) for r in own]
    ref = json.loads(out_j)
    assert [(r["acc"], r["feasible"], r["replicas"]) for r in mine] == \
        [(r["acc"], r["feasible"], r["replicas"]) for r in ref]
    assert same_rows(ref, mine, 1e-4) == []


def test_cli_device_follows_wva_platform(tmp_path, capsys, monkeypatch):
    """WVA_PLATFORM unset (or a spelling of the card) sizes on the card
    and fails without CUDA, naming the knob; `cpu` runs on the host; any
    other value exits 1 — the controller's mapping."""
    path = tmp_path / "profiles.yaml"
    path.write_text(yaml.safe_dump(profiles(3, fits=1)))
    argv = ["--profiles", str(path), "--rate", "10", "--slo-ttft", "500",
            "--json"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for value in (None, "", "cuda", "GPU", "ambient"):
        if value is None:
            monkeypatch.delenv("WVA_PLATFORM", raising=False)
        else:
            monkeypatch.setenv("WVA_PLATFORM", value)
        with pytest.raises(RuntimeError, match="cuda.*WVA_PLATFORM=cpu"):
            pp.main(argv)
    for value in ("tpu", "rocm"):
        monkeypatch.setenv("WVA_PLATFORM", value)
        assert pp.main(argv) == 1
    monkeypatch.setenv("WVA_PLATFORM", "cpu")
    capsys.readouterr()     # the refusals' log lines
    rc, out = cli(pp, argv, capsys)
    assert rc == 0 and json.loads(out)
