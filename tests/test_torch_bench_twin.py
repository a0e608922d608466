"""The port's goodput-scoreboard benchmarks (bench_torch_goodput.py,
bench_torch_goodput_live.py, bench_torch_adversary.py) against
bench_goodput.py, bench_goodput_live.py and bench_adversary.py on the same
inputs, and bench_torch_cpu_tail.py's record.

The port runs `device="cpu"` in float64; the JAX side runs in a fresh
process (this file run as a script, `jax_side`), where each JAX script's
own `main` prints its record. Both sides run with WVA_NATIVE_KERNEL=false
(the batched backends). Compared exactly: the goodput record of
COMPARED (WVA_GOODPUT_SCENARIOS), per-scenario dict for dict; the
goodput-live smoke line (ticks, variants, goodput); the adversary smoke
record (budget, worst) and the search's every evaluation. Walls go to
stderr on both sides and are never compared. Also: the outputs the
scripts refuse, and that `--out` is the only file a script writes.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch_adversary as pa  # noqa: E402
import bench_torch_cpu_tail as pt  # noqa: E402
import bench_torch_goodput as pg  # noqa: E402
import bench_torch_goodput_live as pv  # noqa: E402

CPU = {"device": "cpu", "dtype": torch.float64}
COMPARED = "flash-crowd"
REPORTING = {"device", "dtype", "backend", "kernel_launches"}


def jax_side() -> dict:
    """Runs in a fresh process: each JAX script's printed record, and the
    smoke search's audit trail (a spy on bench_adversary.search)."""
    import bench_adversary as ja
    import bench_goodput as jg
    import bench_goodput_live as jv

    def printed(main, argv) -> dict:
        buf = io.StringIO()
        sys.argv = ["jax", *argv]
        with contextlib.redirect_stdout(buf):
            assert main() == 0
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    os.environ["WVA_GOODPUT_SCENARIOS"] = COMPARED
    out = {"goodput": printed(jg.main, [])}
    del os.environ["WVA_GOODPUT_SCENARIOS"]
    out["live"] = printed(jv.main, ["--smoke"])
    searches = []
    search = ja.search

    def spy(**kwargs):
        result = search(**kwargs)
        searches.append(result.to_dict())
        return result

    ja.search = spy
    out["adversary"] = printed(ja.main, ["--smoke"])
    out["search"] = searches[0]
    out["constants"] = [ja.SMOKE_GENERATIONS, ja.SMOKE_POPULATION,
                        ja.SMOKE_DURATION_S, ja.FLOOR_MARGIN,
                        ja.HARDENED_OPERATOR, jv.SMOKE_DURATION_S]
    return out


@pytest.fixture(scope="module")
def jax():
    env = dict(os.environ, JAX_PLATFORMS="cpu", LOG_LEVEL="error",
               WVA_NATIVE_KERNEL="false")
    for knob in ("WVA_GOODPUT_SCENARIOS", "WVA_ADVERSARY_SEED",
                 "WVA_ADVERSARY_GENERATIONS", "WVA_ADVERSARY_POPULATION"):
        env.pop(knob, None)
    r = subprocess.run([sys.executable, __file__], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def _pins(monkeypatch):
    monkeypatch.setenv("WVA_NATIVE_KERNEL", "false")
    monkeypatch.delenv("WVA_GOODPUT_SCENARIOS", raising=False)
    torch.set_num_threads(1)


def test_constants_equal(jax):
    assert jax["constants"] == [
        pa.SMOKE_GENERATIONS, pa.SMOKE_POPULATION, pa.SMOKE_DURATION_S,
        pa.FLOOR_MARGIN, pa.HARDENED_OPERATOR, pv.SMOKE_DURATION_S]


def test_goodput_record_equal(jax):
    """The scoreboard of one scenario, per-scenario dict for dict; the
    port adds only where it ran and its launches."""
    record, walls = pg.run([COMPARED], **CPU)
    assert set(record) - set(jax["goodput"]) == REPORTING
    assert {k: record[k] for k in jax["goodput"]} == jax["goodput"]
    assert list(walls) == [COMPARED] and walls[COMPARED] > 0
    k = record["kernel_launches"][COMPARED]
    assert k["cycles"] >= 1 and k["B1"] == k["B2"] == 0


def test_goodput_live_smoke_equal(jax):
    line = pv.run(True, **CPU)
    for key in ("scenario", "ticks", "variants", "goodput_fraction",
                "bench", "equivalent", "duration_s"):
        assert line[key] == jax["live"][key], key


def test_goodput_live_meters_must_match():
    """assert_equivalent names the first tick where the meters differ."""
    from workload_variant_autoscaler_tpu_torch.obs.goodput import (
        GoodputMeter,
    )

    class Ring(GoodputMeter):
        def __init__(self, ticks):
            super().__init__(window_s=60.0)
            self._ticks = ticks

        def ledger(self, window_s=None):
            return self._ticks

    same = [{"t": 0.0, "cost": 1.0}, {"t": 30.0, "cost": 2.0}]
    assert pv.assert_equivalent(Ring(same), Ring(list(same))) == 2
    with pytest.raises(AssertionError, match="tick 1"):
        pv.assert_equivalent(Ring(same), Ring([same[0], {"t": 30.0,
                                                         "cost": 2.5}]))
    with pytest.raises(AssertionError, match="lengths differ"):
        pv.assert_equivalent(Ring(same), Ring(same[:1]))


def test_adversary_smoke_record_equal(jax):
    first = pa.run_search(14, pa.SMOKE_GENERATIONS, pa.SMOKE_POPULATION,
                          pa.SMOKE_DURATION_S, **CPU)
    record = pa.smoke_record(first, {})
    assert {k: record[k] for k in jax["adversary"]} == jax["adversary"]
    assert first["result"] == jax["search"]
    assert len(first["result"]["evaluations"]) == record["budget"] == 3


def test_adversary_finish_holds_the_rerun_and_reports_results(jax):
    """`finish` refuses a rerun that differs; with an equal one it runs
    the hardened scenario and the promotion and reports both results."""
    first = {"result": jax["search"], "kernel_launches": {}}
    other = json.loads(json.dumps(first))
    other["result"]["evaluations"][0]["goodput"] += 1e-6
    with pytest.raises(AssertionError, match="not deterministic"):
        pa.finish(first, other, 0.5, {}, **CPU)
    record = pa.finish(first, json.loads(json.dumps(first)), 2.0, {}, **CPU)
    assert record["deterministic"] and record["hand_library_min"] == 2.0
    assert [r["met"] for r in record["results"]][0] == "met"
    assert [p["name"] for p in record["promoted"]] == ["adv-r14-g1"]
    assert pa.archive(record)["scenarios"][0]["floor"] \
        == record["promoted"][0]["floor"]


SCRIPTS = {
    "bench_torch_goodput": ["--device", "cpu"],
    "bench_torch_goodput_live": ["--device", "cpu", "--smoke"],
    "bench_torch_adversary": ["--device", "cpu", "--smoke"],
    "bench_torch_shard": ["--device", "cpu", "--smoke"],
    "bench_torch_hier": ["--device", "cpu", "--smoke"],
    "bench_torch_cpu_tail": ["8"],
}


@pytest.mark.parametrize("where", ["fixtures", "record"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_refuses_the_jax_package_records(script, where, tmp_path, capsys):
    """A path under tests/fixtures/ or named BENCH_*.json is refused
    before anything runs, whether it exists or not."""
    module = __import__(script)
    path = {"fixtures": tmp_path / "tests" / "fixtures" / "x.json",
            "record": tmp_path / "BENCH_new_r99.json"}[where]
    with pytest.raises(SystemExit) as exc:
        module.main([*SCRIPTS[script], "--out", str(path)])
    assert exc.value.code == 2
    assert not path.exists()
    assert "never" in capsys.readouterr().err


def test_adversary_refuses_the_jax_archive(tmp_path, capsys):
    path = tmp_path / "tests" / "fixtures" / "adversarial_scenarios.json"
    with pytest.raises(SystemExit) as exc:
        pa.main(["--device", "cpu", "--archive-out", str(path)])
    assert exc.value.code == 2
    assert "tests/fixtures/" in capsys.readouterr().err


def test_out_is_the_only_write(tmp_path, monkeypatch, capsys):
    """Run in an empty directory, the smoke writes its record to --out and
    nothing else there."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "adv.json"
    assert pa.main(["--device", "cpu", "--dtype", "float64", "--smoke",
                    "--out", str(out)]) == 0
    assert [p.name for p in tmp_path.iterdir()] == ["adv.json"]
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(out.read_text()) == json.loads(line)


def test_cpu_tail_record_shape_and_equal_sizings():
    record = pt.run((8, 16), window_s=0.01)
    assert record["device"] == "cpu" and record["host_cpu"]
    assert record["measures"].startswith("the host CPU")
    assert set(record["sizes"]) == {"8", "16"}
    for row in record["sizes"].values():
        assert len(row["native_runs"]) == len(row["batched_runs"]) == 3
        assert row["native_iters"] >= 1 and row["batched_iters"] >= 1
        assert row["sizings"]["feasible_equal"]
        assert row["sizings"]["rate_max_rel_diff"] <= pt.RATE_RTOL
    assert record["sizings_equal"]
    assert record["native_wins"] == all(
        r["native_over_batched"] > 1.0 for r in record["sizes"].values())


if __name__ == "__main__":
    print(json.dumps(jax_side()))
