"""What every window loop shares: the run's context, the probes the
harness puts around the program's calls from its own files, and the
record of each number the comparison reads beside its limit.

Probes wrap the program from outside, on its classes and modules, for
the run's duration:
- `System.generate_solution` hands the harness each cycle's System, so
  the sized lane of every VA can be judged (every run);
- in a `--trace 1` run, `ops.fused.decide_batch` is timed to a
  synchronise, each kernel launch's inputs are kept for the roofline's
  count of work (the first few whole, for a note on the trips run after
  the window), and host spans around the stages (`_prepare`,
  `System.calculate`, `Manager.optimize`, `_apply`, `decide_batch`) name
  what the host was doing while the device sat idle.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import time
from dataclasses import dataclass, field

import torch

from .spec import HERE, Cell

LIMITS = json.loads((HERE / "limits.json").read_text())

# a traced run keeps the inputs of its window's first launches whole (one
# polled cycle of the 512-VA fleet: two B1, one B2) for a note on trips
KEPT_LAUNCHES = 3


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float                  # the process's first statement, perf_counter
    generator: object = None        # the traffic mix's module
    # test-only breakage: (module, attribute) -> wrapper of the original
    faults: dict = field(default_factory=dict)

    @property
    def dtype(self):
        return getattr(torch, self.cell.config["controller"]["dtype"])


def apply_env(cell: Cell) -> None:
    """The controller's settings as the configuration states them, and
    the traffic mix's (the streaming core on or off), set before the
    program is imported."""
    for src in (cell.config["controller"].get("env", {}),
                cell.traffic.get("env", {})):
        for k, v in src.items():
            os.environ[k] = str(v)
    os.environ.setdefault("LOG_LEVEL", "error")


def quiet_loggers() -> None:
    import logging

    for name in list(logging.root.manager.loggerDict):
        if name.startswith("wva"):
            logging.getLogger(name).setLevel(logging.ERROR)


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def patched(obj, name: str, make):
    """Replace obj.name with make(original) for the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


class Probes:
    """The harness's wrappers around the program (see the module doc)."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.systems: list = []     # each finished cycle's System, drained
        self.decide_s: list = []    # synchronised decide_batch walls
        self.launches: list = []    # (form, fcols, icols, clm rows, k_max)
        self.kept: list = []        # the window's first launches, whole
        self.spans: list = []       # (perf_counter start, end, label)
        self._stack = contextlib.ExitStack()

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((t0, time.perf_counter(), label))

    def _spanned(self, label: str):
        probes = self

        def make(orig):
            def spy(*a, **kw):
                with probes.span(label):
                    return orig(*a, **kw)
            return spy
        return make

    def watch(self, rec) -> None:
        """Span the Reconciler's own collect/prepare and publish steps (a
        `--trace 1` run only)."""
        if self.ctx.trace:
            for name, label in (("_prepare", "prepare (collect, status)"),
                                ("_apply", "publish")):
                self._stack.enter_context(
                    patched(rec, name, self._spanned(label)))

    def __enter__(self):
        from workload_variant_autoscaler_tpu_torch.models import system as sysm
        from workload_variant_autoscaler_tpu_torch.ops import bisect_kernel
        from workload_variant_autoscaler_tpu_torch.ops import fused
        from workload_variant_autoscaler_tpu_torch.solver import optimizer

        probes = self

        def gen_solution(orig):
            def spy(system):
                out = orig(system)
                probes.systems.append(system)
                return out
            return spy

        self._stack.enter_context(
            patched(sysm.System, "generate_solution", gen_solution))
        for (module, name), make in self.ctx.faults.items():
            self._stack.enter_context(
                patched(importlib.import_module(module), name, make))
        if self.ctx.trace:
            dev = self.ctx.device

            def decide(orig):
                def spy(*a, **kw):
                    with probes.span("decide_batch"):
                        sync(dev)
                        t0 = time.perf_counter()
                        out = orig(*a, **kw)
                        sync(dev)
                        probes.decide_s.append(time.perf_counter() - t0)
                    return out
                return spy

            def bisect(orig):
                def spy(fcols, icols, clm, k_max, tail_pct=None):
                    form = "B1" if tail_pct is None else "B2"
                    probes.launches.append(
                        (form, fcols, icols, clm.shape[0], k_max))
                    if len(probes.kept) < KEPT_LAUNCHES:
                        probes.kept.append(
                            (form, fcols, icols, clm, k_max, tail_pct))
                    return orig(fcols, icols, clm, k_max, tail_pct)
                return spy

            self._stack.enter_context(patched(fused, "decide_batch", decide))
            self._stack.enter_context(
                patched(bisect_kernel, "bisect", bisect))
            self._stack.enter_context(patched(
                sysm.System, "calculate", self._spanned("analyze")))
            self._stack.enter_context(patched(
                optimizer.Manager, "optimize", self._spanned("optimize")))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def reset(self) -> None:
        """Forget what set-up's passes left."""
        self.systems, self.decide_s, self.launches = [], [], []
        self.spans, self.kept = [], []

    def take_systems(self) -> list:
        out, self.systems = self.systems, []
        return out

    def take_launches(self) -> list:
        """The launches since the last call, their inputs on the host."""
        out = [(f, fc.double().cpu().numpy(), ic.cpu().numpy(), r, k)
               for f, fc, ic, r, k in self.launches]
        self.launches = []
        return out


class GcClock:
    """The interpreter's garbage-collection pauses over a block, per
    generation: (collections, seconds). A diagnostic the run prints on
    standard error; it changes nothing the program does."""

    def __init__(self):
        self.by_gen: dict = {}
        self._t0 = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            n, sec = self.by_gen.get(info["generation"], (0, 0.0))
            self.by_gen[info["generation"]] = (
                n + 1, sec + time.perf_counter() - self._t0)
            self._t0 = None

    def __enter__(self):
        import gc

        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)
        return False

    def note(self) -> str:
        return "gc in the window: " + ", ".join(
            f"gen{g} {n} x, {sec * 1e3:.1f} ms"
            for g, (n, sec) in sorted(self.by_gen.items()))


class Checks:
    """Each number the comparison reads, with its limit: the run is
    correct when every number is at or under its limit."""

    def __init__(self):
        self.rows: list = []

    def add(self, name: str, value: float) -> None:
        self.rows.append((name, float(value), float(LIMITS[name])))

    @property
    def correct(self) -> bool:
        return all(v <= lim for _n, v, lim in self.rows)

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.rows}

    def lines(self) -> list:
        return [f"check {n}: {v!r} (limit {lim!r}) "
                f"{'ok' if v <= lim else 'FAILED'}" for n, v, lim in self.rows]


def published_mismatch(b, fleet) -> int:
    """VAs whose inferno_desired_replicas differs from the replica count
    their status on the API server holds."""
    desired = {}
    for metric in b.emitter.registry.collect():
        for s in metric.samples:
            if s.name == "inferno_desired_replicas":
                desired[(s.labels["variant_name"], s.labels["namespace"],
                         s.labels["accelerator_type"])] = s.value
    bad = 0
    for i in range(fleet.variants):
        name, ns = fleet.va_key(i)
        d = b.kube.vas[(ns, name)].status.desired_optimized_alloc
        bad += desired.get((name, ns, d.accelerator)) != d.num_replicas
    return bad


def lane_gap(ref, i: int, got: float) -> float:
    """Relative gap of the program's rate for VA i's lane to the
    reference's; 1 where one side finds the lane feasible and the other
    does not."""
    r, ok = ref.va_rate(i)
    have = got == got and got > 0          # not NaN, and sized
    if not ok:
        return 1.0 if have else 0.0
    return abs(got - r) / r if have else 1.0


def admissible(ref, fleet, i: int, rpm: float, tau: float, acc: int,
               reps: int) -> bool:
    """Whether VA i's published slice index and replica count are what
    the reference admits at `rpm`. Where the reference finds no feasible
    allocation there is no count to judge: the lane's own check holds
    the program to that."""
    rng = ref.replicas_range(i, rpm, tau)
    if rng is None:
        return True
    return acc == i % fleet.profiles and rng[0] <= reps <= rng[1]


def percentile(values: list, q: float) -> float:
    """Nearest rank: the smallest value with at least q of all values at
    or below it."""
    s = sorted(values)
    k = max(int(-(-q * len(s) // 1)) - 1, 0)
    return s[min(k, len(s) - 1)]


def device_record(device: str) -> dict:
    """The card the run used, its power limit, and its peak memory."""
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import subprocess

    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        limit = float(out.splitlines()[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        limit = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)),
            "power_limit_w": limit}

