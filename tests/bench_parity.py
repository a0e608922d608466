"""What the tests of the bench_torch_* ports of the cycle and event-path
benchmarks share: importing a JAX root script without the knobs it sets,
and reading what a script's clusters published. Imports neither package,
so the card's tests (tests/test_torch_cuda.py, port imports only) use it
too."""

import importlib
import os


def jax_script(name: str):
    """Import a JAX root script, dropping the knobs it sets in os.environ
    when it is imported (every pytest worker imports every test file, so
    a knob set at import would hold for every later test)."""
    saved = dict(os.environ)
    try:
        return importlib.import_module(name)
    finally:
        os.environ.clear()
        os.environ.update(saved)


def capture_kubes(monkeypatch, module) -> list:
    """The kubes that `module.build_cluster` builds from here on (its
    result's first item)."""
    kubes = []
    orig = module.build_cluster

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        kubes.append(out[0])
        return out

    monkeypatch.setattr(module, "build_cluster", spy)
    return kubes


def published(kube) -> list:
    """Every VA's published (name, accelerator, replicas)."""
    return sorted((va.metadata.name,
                   va.status.desired_optimized_alloc.accelerator,
                   va.status.desired_optimized_alloc.num_replicas)
                  for va in kube.list_variant_autoscalings())
