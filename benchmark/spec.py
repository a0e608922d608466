"""Resolves a cell of BENCHMARK.json to its files, by name alone.

A configuration is `configs/<config>.json`, a traffic mix
`traffic/<traffic>.json` whose `generator` names `traffic/<generator>.py`
and whose `mode` names the window's loop `loops/<mode>.py`, and a
per-layer metric is `layers/<metric>.py`. A later change adds a cell by
adding files and entries; nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path, name: str):
    """Import a file by its path (metric names carry dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # the cell's end-to-end metric entries
    per_layer: list         # the cell's per-layer metric entries
    generator_path: Path
    loop_path: Path
    reader_paths: dict      # per-layer metric name -> reader file


def bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    b = bench(root)
    cells = {w["name"]: w for w in b["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in b["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in b["end_to_end"]
           if name in m.get("workloads", (name,))]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in b["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    gen = here / "traffic" / f"{traffic['generator']}.py"
    loop = here / "loops" / f"{traffic['mode']}.py"
    readers = {m["name"]: here / "layers" / f"{m['name']}.py"
               for m in per_layer}
    for p in [gen, loop, *readers.values()]:
        if not p.is_file():
            raise FileNotFoundError(f"cell {name}: missing {p}")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                generator_path=gen, loop_path=loop, reader_paths=readers)
