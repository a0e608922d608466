"""Domain entities: Accelerator (slice shape), Model, ServiceClass, Server.

Instance-scoped equivalents of the Go reference's pkg/core/{accelerator,model,
serviceclass,server}.go — no package-global singleton (the reference's
`core.TheSystem`, pkg/core/system.go:10-13, makes the engine single-threaded;
here every entity holds no references into a global registry).
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import TYPE_CHECKING, Optional

from .spec import (
    DEFAULT_HIGH_PRIORITY,
    DEFAULT_LOW_PRIORITY,
    DEFAULT_SERVICE_CLASS_NAME,
    DEFAULT_SERVICE_CLASS_PRIORITY,
    AcceleratorSpec,
    AllocationData,
    ModelSliceProfile,
    ModelTarget,
    ServerLoadSpec,
    ServerSpec,
    ServiceClassSpec,
)
from .allocation import Allocation

if TYPE_CHECKING:
    from .system import System


class Accelerator:
    """A TPU slice shape with its piecewise-linear power curve
    (reference pkg/core/accelerator.go)."""

    def __init__(self, spec: AcceleratorSpec):
        self.spec = spec
        self._slope_low = 0.0
        self._slope_high = 0.0

    def calculate(self) -> None:
        p = self.spec.power
        if p.mid_util > 0:
            self._slope_low = (p.mid_power - p.idle) / p.mid_util
        if p.mid_util < 1:
            self._slope_high = (p.full - p.mid_power) / (1 - p.mid_util)

    def power(self, util: float) -> float:
        """Chip power draw at a utilisation in [0, 1] (per chip); multiply
        by `chips` for slice power."""
        p = self.spec.power
        if util <= p.mid_util:
            return p.idle + self._slope_low * util
        return p.mid_power + self._slope_high * (util - p.mid_util)

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def chip(self) -> str:
        return self.spec.chip

    @property
    def chips(self) -> int:
        return self.spec.chips

    @property
    def cost(self) -> float:
        return self.spec.cost

    @property
    def mem_gb(self) -> float:
        return self.spec.mem_gb


class Model:
    """An inference model with per-slice-shape perf profiles
    (reference pkg/core/model.go)."""

    def __init__(self, name: str):
        self.name = name
        self._profiles: dict[str, ModelSliceProfile] = {}

    def add_profile(self, profile: ModelSliceProfile) -> None:
        if profile.model == self.name:
            self._profiles[profile.accelerator] = profile

    def remove_profile(self, acc_name: str) -> None:
        self._profiles.pop(acc_name, None)

    def profile(self, acc_name: str) -> Optional[ModelSliceProfile]:
        return self._profiles.get(acc_name)

    @property
    def profiles(self) -> dict[str, ModelSliceProfile]:
        return self._profiles

    def num_instances(self, acc_name: str) -> int:
        """Slice units per replica (reference model.go:37-39,48-52)."""
        p = self._profiles.get(acc_name)
        if p is None:
            return 0
        return max(p.slices_per_replica, 1)


class ServiceClass:
    """A named priority class with per-model SLO targets
    (reference pkg/core/serviceclass.go). Priority 1 is highest, 100 lowest;
    out-of-range priorities fall back to the default."""

    def __init__(self, name: str, priority: int):
        if priority < DEFAULT_HIGH_PRIORITY or priority > DEFAULT_LOW_PRIORITY:
            priority = DEFAULT_SERVICE_CLASS_PRIORITY
        self.name = name
        self.priority = priority
        self._targets: dict[str, ModelTarget] = {}

    @classmethod
    def from_spec(cls, spec: ServiceClassSpec) -> "ServiceClass":
        svc = cls(spec.name, spec.priority)
        for t in spec.model_targets:
            svc.add_target(t)
        return svc

    def add_target(self, target: ModelTarget) -> ModelTarget:
        self._targets[target.model] = target
        return target

    def remove_target(self, model_name: str) -> None:
        self._targets.pop(model_name, None)

    def target(self, model_name: str) -> Optional[ModelTarget]:
        return self._targets.get(model_name)

    @property
    def targets(self) -> dict[str, ModelTarget]:
        return self._targets

    def to_spec(self) -> ServiceClassSpec:
        return ServiceClassSpec(
            name=self.name, priority=self.priority,
            model_targets=tuple(self._targets.values()),
        )


class Server:
    """A variant server: one (service class, model) deployment whose
    candidate allocations the optimizer chooses among
    (reference pkg/core/server.go)."""

    def __init__(self, spec: ServerSpec):
        self._spec = spec
        self._desired_stale = False
        self.name = spec.name
        self.service_class_name = spec.service_class or DEFAULT_SERVICE_CLASS_NAME
        self.model_name = spec.model
        self.keep_accelerator = spec.keep_accelerator
        self.min_num_replicas = spec.min_num_replicas
        self.max_batch_size = spec.max_batch_size

        self.load: ServerLoadSpec = spec.current_alloc.load
        self.cur_allocation: Optional[Allocation] = Allocation.from_data(spec.current_alloc)
        self.all_allocations: dict[str, Allocation] = {}
        self.allocation: Optional[Allocation] = None

    @property
    def spec(self) -> ServerSpec:
        """The server spec with `desired_alloc` synced to the chosen
        allocation. The sync is LAZY: ServerSpec is a frozen dataclass,
        so each sync is a full reconstruction, and the greedy solver
        re-assigns allocations many times per solve — paying the
        rebuild once per spec READ instead of once per assignment takes
        the rebuild off the optimize hot loop entirely for the
        (majority of) cycles that never read the spec afterwards."""
        if self._desired_stale:
            self._desired_stale = False
            if self.allocation is not None:
                self._spec = dc_replace(
                    self._spec,
                    desired_alloc=self.allocation.to_data(self.load))
            else:
                self._spec = dc_replace(self._spec,
                                        desired_alloc=AllocationData())
        return self._spec

    @spec.setter
    def spec(self, value: ServerSpec) -> None:
        self._spec = value
        self._desired_stale = False

    def priority(self, system: "System") -> int:
        svc = system.service_class(self.service_class_name)
        return svc.priority if svc else DEFAULT_SERVICE_CLASS_PRIORITY

    def candidate_accelerators(
        self, accelerators: dict[str, Accelerator]
    ) -> dict[str, Accelerator]:
        """Pin to the current slice shape when keep_accelerator is set
        (reference server.go:70-82)."""
        if self.keep_accelerator and self.cur_allocation is not None:
            cur = self.cur_allocation.accelerator
            if cur:
                return {cur: accelerators[cur]} if cur in accelerators else {}
        return accelerators

    def calculate(self, system: "System",
                  ttft_percentile: Optional[float] = None) -> None:
        """Scalar-path candidate computation (the Go reference's
        server.go:55-67): `System.calculate(backend="scalar")` runs it for
        every server; the other backends size the candidates in batches."""
        from .allocation import create_allocation

        self.all_allocations = {}
        for g_name in self.candidate_accelerators(system.accelerators):
            alloc = create_allocation(system, self.name, g_name,
                                      ttft_percentile=ttft_percentile)
            if alloc is not None:
                if self.cur_allocation is not None:
                    alloc.value = self.cur_allocation.transition_penalty(alloc)
                self.all_allocations[g_name] = alloc

    def set_allocation(self, alloc: Optional[Allocation]) -> None:
        self.allocation = alloc
        self.update_desired_alloc()

    def remove_allocation(self) -> None:
        self.allocation = None

    def saturated(self) -> bool:
        return (
            self.allocation is not None
            and self.load is not None
            and self.allocation.saturated(self.load.arrival_rate)
        )

    def update_desired_alloc(self) -> None:
        """Mark `spec.desired_alloc` out of sync with the chosen
        allocation; the spec property rebuilds it on next read."""
        self._desired_stale = True

    def apply_desired_alloc(self) -> None:
        """Promote desired -> current (reference server.go:155-161)."""
        self.spec = dc_replace(self.spec, current_alloc=self.spec.desired_alloc)
        self.cur_allocation = Allocation.from_data(self.spec.current_alloc)
        self.load = self.spec.current_alloc.load
