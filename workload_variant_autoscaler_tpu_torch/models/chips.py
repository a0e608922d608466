"""TPU chip generations and slice-shape catalog.

The reference models accelerators as GPU SKUs with a unit cost
(the Go reference's test/utils/unitutils.go:64-85: A100/MI300X/G2). The TPU
equivalent is a chip generation (capacity pool) plus the slice shapes GKE
can provision from it. Costs are cents/chip-hour defaults in the spirit of
the reference's fixture costs — operators override them via the
accelerator-unit-costs ConfigMap.

Slice shapes follow GKE TPU topology naming: a v5e-8 is a 2x4 single-host
slice; v5e-16 (4x4) is multi-host and is an atomic allocation unit — the
optimizer can only scale it in whole slices.
"""

from __future__ import annotations

from dataclasses import dataclass

from .spec import AcceleratorSpec, PowerSpec


@dataclass(frozen=True)
class ChipSpec:
    """One TPU generation."""

    name: str
    cost_per_chip: float   # cents/hr
    hbm_gb: float          # per chip
    power: PowerSpec       # per chip
    chips_per_host: int    # max chips on one host (single-host slice bound)
    # spot/preemptible price as a fraction of on-demand (GCP spot TPUs
    # run at a steep discount; the exact ratio is region/time-varying —
    # these are fixture defaults in the same spirit as cost_per_chip).
    # Interruptible capacity is cheap precisely because it can be
    # reclaimed mid-serve: the goodput twin prices spot pools with this
    # and then charges the reclamation wave's badput against the savings.
    spot_discount: float = 0.35

    @property
    def spot_cost_per_chip(self) -> float:
        """cents/hr for interruptible (spot/preemptible) capacity."""
        return self.cost_per_chip * self.spot_discount


# Default catalog. Costs are illustrative defaults (same role as the
# reference's fixture ConfigMap costs); HBM/power from public TPU specs.
CHIP_CATALOG: dict[str, ChipSpec] = {
    "v5e": ChipSpec(
        name="v5e", cost_per_chip=20.0, hbm_gb=16.0,
        power=PowerSpec(idle=60, full=200, mid_power=150, mid_util=0.6),
        chips_per_host=8,
    ),
    "v5p": ChipSpec(
        name="v5p", cost_per_chip=85.0, hbm_gb=95.0,
        power=PowerSpec(idle=120, full=450, mid_power=350, mid_util=0.6),
        chips_per_host=4,
    ),
    "v6e": ChipSpec(
        name="v6e", cost_per_chip=55.0, hbm_gb=32.0,
        power=PowerSpec(idle=80, full=300, mid_power=220, mid_util=0.6),
        chips_per_host=8,
    ),
}


def make_slice(
    chip: str,
    num_chips: int,
    topology: str = "",
    cost_per_chip: float | None = None,
    catalog: dict[str, ChipSpec] | None = None,
) -> AcceleratorSpec:
    """Build an AcceleratorSpec for a slice shape of `num_chips` chips."""
    spec = (catalog or CHIP_CATALOG)[chip]
    per_chip = spec.cost_per_chip if cost_per_chip is None else cost_per_chip
    return AcceleratorSpec(
        name=f"{chip}-{num_chips}",
        chip=chip,
        chips=num_chips,
        topology=topology,
        multi_host=num_chips > spec.chips_per_host,
        mem_gb=spec.hbm_gb * num_chips,
        power=spec.power,
        cost=per_chip * num_chips,
    )


# Slice shapes offered by default (GKE-supported topologies).
DEFAULT_SLICES: tuple[AcceleratorSpec, ...] = (
    make_slice("v5e", 1, "1x1"),
    make_slice("v5e", 4, "2x2"),
    make_slice("v5e", 8, "2x4"),
    make_slice("v5e", 16, "4x4"),    # multi-host
    make_slice("v5p", 4, "2x2x1"),
    make_slice("v5p", 8, "2x2x2"),   # multi-host
    make_slice("v6e", 1, "1x1"),
    make_slice("v6e", 4, "2x2"),
    make_slice("v6e", 8, "2x4"),
)


def default_slice_map() -> dict[str, AcceleratorSpec]:
    return {s.name: s for s in DEFAULT_SLICES}
