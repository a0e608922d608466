"""The port's System + Manager against the JAX System + Manager.

Fleets come from tests/helpers.py (make_system's slices, profiles and
service classes) and are carried across with
`spec_from_reference(dataclasses.asdict(spec))`. Both packages run the
analyze + optimize path on the CPU in float64; the port's "kernel"
backend runs the kernels' plain versions here. Decisions (accelerator,
replicas, batch, cost) must be equal; latencies agree to rtol 1e-9 (the
port keeps the reference's operation order; observed gaps are ~1e-14).
"""

import os
import subprocess
import sys
from dataclasses import asdict, replace

import pytest
import torch

from tests.helpers import PROFILES, SERVICE_CLASSES, SLICES, make_system, \
    server_spec
from workload_variant_autoscaler_tpu.models import OptimizerSpec, System, \
    SystemSpec
from workload_variant_autoscaler_tpu.solver.optimizer import Manager, Optimizer
import workload_variant_autoscaler_tpu_torch as port


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's intra-op threads would spin on the cores the other test
    workers run on; these tensors are small, so one thread is enough."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-9


def fleet_servers():
    return [
        server_spec(name="chat:premium", arrival_rpm=1800.0),
        server_spec(name="batch:premium", arrival_rpm=420.0, in_tokens=512,
                    out_tokens=256),
        server_spec(name="chat:free", service_class="Freemium",
                    arrival_rpm=3600.0, out_tokens=64),
        server_spec(name="big:premium", model="llama-70b",
                    arrival_rpm=300.0, in_tokens=1024, out_tokens=256,
                    accelerator="v5e-8"),
        server_spec(name="big:free", model="llama-70b",
                    service_class="Freemium", arrival_rpm=900.0,
                    accelerator="v5e-16", min_replicas=2),
        server_spec(name="idle", arrival_rpm=0.0),
        server_spec(name="pinned", arrival_rpm=2400.0, accelerator="v5e-4",
                    keep_accelerator=True),
        server_spec(name="capped", arrival_rpm=1200.0, max_batch=32),
    ]


def fleet_spec(servers, service_classes=SERVICE_CLASSES):
    """The SystemSpec tests.helpers.make_system builds."""
    return SystemSpec(
        accelerators=list(SLICES), profiles=list(PROFILES),
        service_classes=list(service_classes), servers=servers,
        capacity={}, optimizer=OptimizerSpec(unlimited=True))


def p95_premium():
    return [replace(c, model_targets=tuple(
        replace(t, slo_ttft_percentile=0.95) for t in c.model_targets))
        if c.name == "Premium" else c for c in SERVICE_CLASSES]


def run_reference(system, opt, backend, pct=None):
    system.calculate(backend=backend, ttft_percentile=pct)
    Manager(system, Optimizer(opt)).optimize()
    return system, system.generate_solution()


def run_port(spec, backend, pct=None):
    system = port.System(device="cpu", dtype=torch.float64)
    opt = system.set_from_spec(port.spec_from_reference(asdict(spec)))
    system.calculate(backend=backend, ttft_percentile=pct)
    port.Manager(system, port.Optimizer(opt)).optimize()
    return system, system.generate_solution()


def assert_same_decisions(ref, ref_sol, got, got_sol):
    assert set(ref.servers) == set(got.servers)
    for name, server in ref.servers.items():
        twin = got.servers[name]
        assert set(server.all_allocations) == set(twin.all_allocations), name
        for acc, alloc in server.all_allocations.items():
            other = twin.all_allocations[acc]
            assert other.num_replicas == alloc.num_replicas, (name, acc)
            assert other.batch_size == alloc.batch_size, (name, acc)
            assert other.cost == alloc.cost, (name, acc)
            assert other.value == alloc.value, (name, acc)
            for f in ("itl", "ttft", "rho", "max_arrv_rate_per_replica"):
                assert getattr(other, f) == pytest.approx(
                    getattr(alloc, f), rel=RTOL, abs=1e-12), (name, acc, f)
        if server.allocation is None:
            assert twin.allocation is None, name
        else:
            assert twin.allocation.accelerator == server.allocation.accelerator
            assert twin.allocation.num_replicas == server.allocation.num_replicas
    assert set(ref_sol.allocations) == set(got_sol.allocations)
    for name, data in ref_sol.allocations.items():
        mine = got_sol.allocations[name]
        assert (mine.accelerator, mine.num_replicas, mine.max_batch,
                mine.cost) == (data.accelerator, data.num_replicas,
                               data.max_batch, data.cost)
    assert {k: (v.count, v.cost) for k, v in got.allocate_by_type().items()} \
        == {k: (v.count, v.cost) for k, v in ref.allocate_by_type().items()}
    assert got.total_cost() == ref.total_cost()
    assert got.last_solve_lanes == ref.last_solve_lanes
    assert got.last_unique_lanes == ref.last_unique_lanes


@pytest.mark.parametrize("backend", ["kernel", "batched"])
def test_mean_fleet_matches_reference(backend):
    servers = fleet_servers()
    ref, opt = make_system(servers=servers)
    ref, ref_sol = run_reference(ref, opt, "batched")
    got, got_sol = run_port(fleet_spec(servers), backend)
    assert len(got_sol.allocations) >= 6
    assert_same_decisions(ref, ref_sol, got, got_sol)


@pytest.mark.parametrize("backend", ["kernel", "batched"])
def test_mixed_p95_and_mean_fleet_matches_reference(backend):
    spec = fleet_spec(fleet_servers(), p95_premium())
    ref = System()
    ref, ref_sol = run_reference(ref, ref.set_from_spec(spec), "batched")
    got, got_sol = run_port(spec, backend)
    assert_same_decisions(ref, ref_sol, got, got_sol)


def test_global_percentile_matches_reference():
    servers = fleet_servers()[:4]
    ref, opt = make_system(servers=servers)
    ref, ref_sol = run_reference(ref, opt, "batched", pct=0.9)
    got, got_sol = run_port(fleet_spec(servers), "kernel", pct=0.9)
    assert_same_decisions(ref, ref_sol, got, got_sol)


@pytest.mark.parametrize("pct", [None, 0.95])
def test_kernel_backend_matches_reference_pallas_backend(pct):
    """JAX backend="pallas" (interpret mode on the CPU) on a two-server
    fleet, as tests/test_pallas.py drives it, against the port's kernel
    backend."""
    servers = [server_spec(name="chat:premium", arrival_rpm=1800.0),
               server_spec(name="batch:premium", arrival_rpm=420.0)]
    ref, opt = make_system(servers=servers)
    ref, ref_sol = run_reference(ref, opt, "pallas", pct=pct)
    got, got_sol = run_port(fleet_spec(servers), "kernel", pct=pct)
    assert_same_decisions(ref, ref_sol, got, got_sol)


def test_spec_from_reference_carries_every_field():
    spec = fleet_spec(fleet_servers(), p95_premium())
    spec.capacity.update({"v5e": 64, "v5p": 16})
    carried = port.spec_from_reference(asdict(spec))
    assert asdict(carried) == asdict(spec)


@pytest.mark.parametrize("policy", ["None", "PriorityExhaustive",
                                    "PriorityRoundRobin", "RoundRobin"])
def test_limited_mode_matches_reference(policy):
    """Limited mode on fleet_servers() with capacity for fewer v5e chips
    than the unlimited solution takes (76): the greedy must move some
    servers to v5p or best-effort, as the JAX package does."""
    spec = fleet_spec(fleet_servers())
    spec.capacity.update({"v5e": 48, "v5p": 8})
    spec.optimizer = OptimizerSpec(unlimited=False, saturation_policy=policy)
    ref = System()
    ref, ref_sol = run_reference(ref, ref.set_from_spec(spec), "batched")
    got, got_sol = run_port(spec, "kernel")
    assert_same_decisions(ref, ref_sol, got, got_sol)
    used = got.allocate_by_type()
    assert used["v5e"].count <= 48 < 76


def test_unknown_backend_rejected():
    system = port.System(device="cpu")
    with pytest.raises(ValueError, match="backend"):
        system.calculate(backend="pallas")


def test_port_imports_neither_jax_nor_the_reference_package():
    code = (
        "import sys\n"
        "import workload_variant_autoscaler_tpu_torch as p\n"
        "import workload_variant_autoscaler_tpu_torch.ops.fused\n"
        "import workload_variant_autoscaler_tpu_torch.ops.bisect_kernel\n"
        "import workload_variant_autoscaler_tpu_torch.ops.arena\n"
        "import workload_variant_autoscaler_tpu_torch.ops.native\n"
        "import workload_variant_autoscaler_tpu_torch.parallel\n"
        "import workload_variant_autoscaler_tpu_torch.parallel.mesh\n"
        "import workload_variant_autoscaler_tpu_torch.solver.greedy\n"
        "import workload_variant_autoscaler_tpu_torch.solver.incremental\n"
        "import workload_variant_autoscaler_tpu_torch.solver.hierarchy\n"
        "import workload_variant_autoscaler_tpu_torch.stream.checkpoint\n"
        "import workload_variant_autoscaler_tpu_torch.controller.reconciler\n"
        "import workload_variant_autoscaler_tpu_torch.controller\n"
        "import workload_variant_autoscaler_tpu_torch.controller.drift\n"
        "import workload_variant_autoscaler_tpu_torch.controller.schema\n"
        "import workload_variant_autoscaler_tpu_torch.actuator\n"
        "import workload_variant_autoscaler_tpu_torch.collector\n"
        "import workload_variant_autoscaler_tpu_torch.faults\n"
        "import workload_variant_autoscaler_tpu_torch.metrics\n"
        "import workload_variant_autoscaler_tpu_torch.obs\n"
        "import workload_variant_autoscaler_tpu_torch.ops.analyzer\n"
        "import workload_variant_autoscaler_tpu_torch.stream.state\n"
        "import workload_variant_autoscaler_tpu_torch.utils\n"
        "import workload_variant_autoscaler_tpu_torch.stream\n"
        "import workload_variant_autoscaler_tpu_torch.stream.core\n"
        "import workload_variant_autoscaler_tpu_torch.stream.ingest\n"
        "import workload_variant_autoscaler_tpu_torch.controller.__main__\n"
        "import workload_variant_autoscaler_tpu_torch.controller.runtime\n"
        "import workload_variant_autoscaler_tpu_torch.metrics.authz\n"
        "import workload_variant_autoscaler_tpu_torch.emulator\n"
        "import workload_variant_autoscaler_tpu_torch.emulator.twin\n"
        "import workload_variant_autoscaler_tpu_torch.emulator.adversary\n"
        "import workload_variant_autoscaler_tpu_torch.emulator.experiment\n"
        "import workload_variant_autoscaler_tpu_torch.emulator.server\n"
        "import workload_variant_autoscaler_tpu_torch.emulator.scenarios\n"
        "import workload_variant_autoscaler_tpu_torch.planner\n"
        "import workload_variant_autoscaler_tpu_torch.fit\n"
        "import workload_variant_autoscaler_tpu_torch.fit.__main__\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'workload_variant_autoscaler_tpu'\n"
        "             or m.startswith('workload_variant_autoscaler_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=repo)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_controller_help_imports_neither_jax_nor_the_reference_package():
    """`python -m workload_variant_autoscaler_tpu_torch.controller --help`
    prints its usage and exits 0 without loading JAX or the reference
    package (checked inside the process, at exit)."""
    code = (
        "import atexit, runpy, sys\n"
        "def check():\n"
        "    bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "                 or m.startswith(('jax.', 'jaxlib'))\n"
        "                 or m == 'workload_variant_autoscaler_tpu'\n"
        "                 or m.startswith('workload_variant_autoscaler_tpu.'))\n"
        "    print('loaded', bad)\n"
        "atexit.register(check)\n"
        "sys.argv = ['controller', '--help']\n"
        "runpy.run_module('workload_variant_autoscaler_tpu_torch.controller',\n"
        "                 run_name='__main__')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=repo)
    assert out.returncode == 0, out.stderr
    assert "--leader-elect" in out.stdout
    assert out.stdout.strip().endswith("loaded []")


@pytest.mark.parametrize("module,usage", [
    ("planner", "--ttft-percentile"),
    ("emulator", "--with-prom-api"),
    ("emulator.experiment", "--mode"),
    ("fit", "--crd-patch"),
])
def test_slice_clis_help_imports_neither(module, usage):
    """The planner's, the emulator's and the fitter's `python -m ...
    --help` print their usage and exit 0 without loading JAX or the
    reference package."""
    code = (
        "import atexit, runpy, sys\n"
        "def check():\n"
        "    bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "                 or m.startswith(('jax.', 'jaxlib'))\n"
        "                 or m == 'workload_variant_autoscaler_tpu'\n"
        "                 or m.startswith('workload_variant_autoscaler_tpu.'))\n"
        "    print('loaded', bad)\n"
        "atexit.register(check)\n"
        f"sys.argv = ['{module}', '--help']\n"
        f"runpy.run_module('workload_variant_autoscaler_tpu_torch.{module}',\n"
        "                 run_name='__main__')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=repo)
    assert out.returncode == 0, out.stderr
    assert usage in out.stdout
    assert out.stdout.strip().endswith("loaded []")
