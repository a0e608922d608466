"""Host paths of the PyTorch port on one NVIDIA GPU: the greedy's vector
sweep against its sequential loop, and the candidate arena's pack
against the list path.

Run from the repository root on a machine with the card:

    python3 bench_torch_host.py [--reps 5]

Greedy: `solve_greedy` (SaturationPolicy None) with WVA_VECTOR_GREEDY on
and off, on Systems whose candidates are drawn from a seed: every
variant has one candidate on each of the first 8 default slice shapes
(4096, 16384 and 65536 lanes at 512, 2048 and 8192 variants), and the
capacity fits every first choice, so the sweep settles every server (its
best case). Two fleet shapes: 8 models shared by all variants, and a
model per variant (the sweep's build resolves every lane there). The
two runs' decisions must be equal.

Pack: `CandidateArena.pack` (what `System` runs) against the list path
(`make_queue_batch` and the SLO columns, padded to the lane bucket, and
`make_epilogue_batch`) at 80 and 4096 lanes, float32, on the card,
synchronized; the tensors must be bit-identical.

Prints one line per cell, the card's name and power limit, then one JSON
object with every time: the median ms of 2 x --reps runs per mode, run in
turns (sweep, loop, loop, sweep), and of 2 x 50 per pack path.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
SIZES = (512, 2048, 8192)
SHARED_MODELS = 8
PACK_LANES = (80, 4096)
PACK_REPS = 50
DEVICE = "cuda"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def greedy_fleet(n_variants: int, n_models: int, seed: int):
    """A limited-mode System on the card with drawn candidates on each
    of the 8 slice shapes, and capacity for every first choice."""
    from workload_variant_autoscaler_tpu_torch import System
    from workload_variant_autoscaler_tpu_torch.models import Allocation
    from workload_variant_autoscaler_tpu_torch.models.chips import (
        DEFAULT_SLICES)
    from workload_variant_autoscaler_tpu_torch.models.spec import (
        ModelSliceProfile, ModelTarget, OptimizerSpec, ServerSpec,
        ServiceClassSpec, SystemSpec)

    rng = np.random.default_rng(seed)
    slices = list(DEFAULT_SLICES[:8])
    models = [f"m{i}" for i in range(n_models)]
    spec = SystemSpec(
        accelerators=slices,
        service_classes=[ServiceClassSpec(
            name="c", priority=1, model_targets=tuple(
                ModelTarget(model=m, slo_itl=24.0, slo_ttft=500.0)
                for m in models))],
        optimizer=OptimizerSpec(unlimited=False))
    for m in models:
        for acc in slices:
            spec.profiles.append(ModelSliceProfile(
                model=m, accelerator=acc.name, alpha=6.973, beta=0.027,
                gamma=5.2, delta=0.1, max_batch_size=64))
    for i in range(n_variants):
        spec.servers.append(ServerSpec(name=f"s{i}", model=models[i % n_models],
                                       service_class="c", min_num_replicas=1))
    system = System(device=DEVICE, dtype=torch.float32)
    system.set_from_spec(spec)
    replicas = rng.integers(1, 8, (n_variants, len(slices)))
    costs = rng.uniform(1.0, 100.0, (n_variants, len(slices)))
    candidates = {}
    for i, name in enumerate(system.servers):
        candidates[name] = [(acc.name, int(replicas[i, j]), float(costs[i, j]))
                            for j, acc in enumerate(slices)]
    system.capacity = {chip: 10**8 for chip in {a.chip for a in slices}}

    def install():
        for name, server in system.servers.items():
            allocs = {}
            for acc, reps, cost in candidates[name]:
                a = Allocation(accelerator=acc, num_replicas=reps, cost=cost)
                a.value = cost
                allocs[acc] = a
            server.all_allocations = allocs

    return system, install


def greedy_cell(n_variants: int, n_models: int, reps: int) -> dict:
    from workload_variant_autoscaler_tpu_torch.models import SaturationPolicy
    from workload_variant_autoscaler_tpu_torch.solver import greedy

    system, install = greedy_fleet(n_variants, n_models, SEED)
    times, chosen = {}, {}
    saved = os.environ.get("WVA_VECTOR_GREEDY")
    try:
        for mode in ("on", "off", "off", "on"):
            os.environ["WVA_VECTOR_GREEDY"] = mode
            for _ in range(reps):
                install()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                greedy.solve_greedy(system, SaturationPolicy.NONE)
                torch.cuda.synchronize()
                times.setdefault(mode, []).append(
                    (time.perf_counter() - t0) * 1e3)
            chosen[mode] = {n: (s.allocation.accelerator,
                                s.allocation.num_replicas)
                            for n, s in system.servers.items()}
    finally:
        if saved is None:
            os.environ.pop("WVA_VECTOR_GREEDY", None)
        else:
            os.environ["WVA_VECTOR_GREEDY"] = saved
    if chosen["on"] != chosen["off"]:
        raise AssertionError(f"{n_variants} variants, {n_models} models: the "
                             f"sweep's decisions differ from the loop's")
    return {"variants": n_variants, "lanes": 8 * n_variants,
            "models": n_models, "sweep_ms": statistics.median(times["on"]),
            "sequential_ms": statistics.median(times["off"])}


def pack_rows(lanes: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "alpha": rng.uniform(2.0, 20.0, lanes).tolist(),
        "beta": rng.uniform(0.005, 0.15, lanes).tolist(),
        "gamma": rng.uniform(1.0, 15.0, lanes).tolist(),
        "delta": rng.uniform(0.02, 0.3, lanes).tolist(),
        "in_tokens": rng.choice([128.0, 256.0, 512.0], lanes).tolist(),
        "out_tokens": rng.choice([128.0, 256.0], lanes).tolist(),
        "max_batch": rng.choice([64, 128, 256], lanes).tolist(),
        "ttft": [500.0] * lanes, "itl": [24.0] * lanes, "tps": [0.0] * lanes,
        "demand": rng.uniform(1.0, 50.0, lanes).tolist(),
        "min_replicas": [1] * lanes,
        "cost_rate": rng.uniform(10.0, 400.0, lanes).tolist(),
    }


def list_path_pack(rows, dtype, device, quantum):
    """make_queue_batch and the SLO columns, padded to a multiple of
    quantum with the arena's fills, and make_epilogue_batch."""
    from workload_variant_autoscaler_tpu_torch.ops import batched, fused

    q = batched.make_queue_batch(
        rows["alpha"], rows["beta"], rows["gamma"], rows["delta"],
        rows["in_tokens"], rows["out_tokens"], rows["max_batch"],
        dtype=dtype, device=device)
    slo = batched.SLOTargets(*(torch.as_tensor(rows[c], dtype=dtype,
                                               device=device)
                               for c in ("ttft", "itl", "tps")))
    pad = (-q.batch_size) % quantum

    def pad_with(a, fill):
        return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                        device=a.device)])

    fills = dict(alpha=1.0, out_tokens=2.0, max_batch=1, occupancy=1,
                 valid=False)
    q = batched.QueueBatch(**{k: pad_with(v, fills.get(k, 0.0))
                              for k, v in q._asdict().items()})
    slo = batched.SLOTargets(*(pad_with(t, 0.0) for t in slo))
    epi = fused.make_epilogue_batch(rows["demand"], rows["min_replicas"],
                                    rows["cost_rate"], dtype, device,
                                    pad_to=q.batch_size)
    return q, slo, epi


def pack_cell(lanes: int) -> dict:
    from workload_variant_autoscaler_tpu_torch.ops.arena import (
        LANE_BUCKET, CandidateArena)

    rows = pack_rows(lanes, SEED)
    arena = CandidateArena()
    dev, dt = torch.device(DEVICE), torch.float32

    def arena_pack():
        return arena.pack(rows, device=dev, dtype=dt)

    def list_pack():
        return list_path_pack(rows, dt, dev, LANE_BUCKET)

    for got, want in zip(arena_pack(), list_pack()):
        for a, b in zip(got, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"{lanes} lanes: the arena's pack "
                                     f"differs from the list path")
    times = {}
    for name, fn in (("arena", arena_pack), ("list", list_pack),
                     ("list", list_pack), ("arena", arena_pack)):
        for _ in range(PACK_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
    return {"lanes": lanes, "arena_ms": statistics.median(times["arena"]),
            "list_ms": statistics.median(times["list"])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_host: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card {card}; torch {torch.__version__}", flush=True)
    greedy_cells = []
    for n_models in (SHARED_MODELS, None):
        for n in SIZES:
            cell = greedy_cell(n, n_models or n, args.reps)
            greedy_cells.append(cell)
            print(f"greedy, {cell['lanes']} lanes, {n} variants, "
                  f"{'a model per variant' if n_models is None else f'{n_models} shared models'}: "
                  f"sweep {cell['sweep_ms']:.3f} ms, sequential "
                  f"{cell['sequential_ms']:.3f} ms", flush=True)
    pack_cells = []
    for lanes in PACK_LANES:
        cell = pack_cell(lanes)
        pack_cells.append(cell)
        print(f"pack, {lanes} lanes, float32 with the epilogue: arena "
              f"{cell['arena_ms']:.4f} ms, list path {cell['list_ms']:.4f} ms",
              flush=True)
    print(card)
    print(json.dumps({"greedy": greedy_cells, "pack": pack_cells}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
