"""The yardstick's own pieces, on the CPU at a tiny size: the roofline's
row matching counts every launched row as matched, padding or unmatched
(and the readers report nothing while any row is unmatched), and the API
server stand-in's frozen wire form equals the program's own conversion
on every VA a reconcile cycle has written."""

import copy

import numpy as np
import torch

from benchmark import roofline, spec
from benchmark.build import Clock, build
from benchmark.fleet import Fleet
from benchmark.reference.decide import Reference
from conftest import TINY


def _fleet():
    cell = spec.resolve("va512-shift")
    cell.config["deployment"].update(TINY)
    return cell, Fleet.from_config(cell.config)


def _rows(ref):
    """Kernel rows (mean form) for the reference's first lane: its ITL
    search, a padding row and the same search with alpha moved."""
    ln = ref.lanes
    base = [float(getattr(ln, c)[0]) for c in
            ("alpha", "beta", "gamma", "delta", "in_tok", "out_tok")]
    real = base + [float(ln.slo_itl[0]), 0.0, 0.0, 0.0]
    pad = [1.0, 0.0, 0.0, 0.0, 0.0, 2.0, 0.0, 0.0, 0.0, 0.0]
    moved = [base[0] * 1.5] + real[1:]
    fcols = np.array([real, pad, moved], dtype=np.float64)
    n = int(ln.n_max[0])
    icols = np.array([[n, 11 * n, 0, 0, 0], [1, 1, 0, 0, 1],
                      [n, 11 * n, 0, 0, 0]], dtype=np.int32)
    return fcols, icols, n


def _tail_rows(ref):
    """Kernel rows (tail form) for the first lane held at the
    percentile: its TTFT search, and a padding row (no TTFT SLO)."""
    ln = ref.lanes
    k = int(torch.nonzero(ln.tail)[0])
    base = [float(getattr(ln, c)[k]) for c in
            ("alpha", "beta", "gamma", "delta", "in_tok", "out_tok")]
    share = 1.0 - ln.pct
    real = base + [share, 0.0, 0.0, 0.0, float(ln.slo_ttft[k]), 1.0]
    pad = [1.0, 0.0, 0.0, 0.0, 0.0, 2.0, share, 0.0, 0.0, 0.0, 0.0, 0.0]
    n = int(ln.n_max[k])
    icols = np.array([[n, 11 * n, 1, 1, 0], [1, 1, 1, 1, 1]], dtype=np.int32)
    return np.array([real, pad]), icols, n, int(ref.sized.trips_ttft[k])


def test_roofline_counts_matched_padding_and_unmatched_rows():
    _cell, fleet = _fleet()
    ref = Reference(fleet, fleet.base_loads(), device="cpu")
    fcols, icols, n = _rows(ref)
    f2, i2, n2, trips2 = _tail_rows(ref)
    least, rows = roofline.launch_work(
        [("B1", fcols, icols, 1, 11 * n), ("B2", f2, i2, 1, 11 * n2)], ref)
    assert rows["B1"] == {"matched": 1, "unmatched": 1, "padding": 1,
                          "trips": int(ref.sized.trips_itl[0])}
    assert rows["B2"] == {"matched": 1, "unmatched": 0, "padding": 1,
                          "trips": trips2}
    assert least["B1"] > 0 and least["B2"] > 0
    b1 = spec.load_module(spec.HERE / "layers" / "b1_roofline.py", "b1_t")
    rec = {"trace": {"kernel_s": {"B1": 1.0}}, "least_s": least,
           "rows": rows}
    assert b1.read(rec) is None
    rec["rows"] = {"B1": dict(rows["B1"], unmatched=0)}
    assert b1.read(rec) == 100.0 * least["B1"]


def test_wire_form_equals_the_program_conversion():
    from benchmark.standins import wire
    from workload_variant_autoscaler_tpu_torch.controller import crd

    cell, fleet = _fleet()
    loads = copy.deepcopy(fleet.base_loads())
    b = build(fleet, cell.config, Clock(), loads, "cpu", torch.float32)
    b.rec.reconcile()
    vas = list(b.kube.vas.values())
    assert len(vas) == fleet.variants
    assert any(va.status.conditions for va in vas)
    for va in vas:
        assert wire.va_to_dict(va) == crd.va_to_dict(va)
