"""The port's own copy of ``repro/core/availability.py``, held to the original by
``tests/test_torch_topology.py``; only its imports of the package differ.

Reliability / availability analysis (paper §3.3.2, §6.6, Table 6).

MTBF  = 8760 / AFR_total          (hours; AFR = failures per year)
Avail = MTBF / (MTBF + MTTR)

Two layers:

* component-count based — AFRs derived from the actual cable/switch counts
  of a topology (via `core/topology`), using per-unit AFRs;
* the paper's Table 6 headline numbers, reproduced exactly for the 8K
  SuperPod comparison benchmark.

Plus the 64+1 backup-NPU model: the probability that a rack survives an NPU
failure without losing capacity, and the effective job-level MTBF gain.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .topology import ClosFabric, LINK_SPECS, SuperPod

HOURS_PER_YEAR = 365 * 24


@dataclass(frozen=True)
class AFRBreakdown:
    name: str
    electrical_cable: float
    optical_cable: float
    lrs: float
    hrs: float

    @property
    def total(self) -> float:
        return self.electrical_cable + self.optical_cable + self.lrs + self.hrs

    @property
    def mtbf_hours(self) -> float:
        return HOURS_PER_YEAR / self.total if self.total else math.inf

    def availability(self, mttr_hours: float = 1.25) -> float:
        m = self.mtbf_hours
        return m / (m + mttr_hours)


# --- paper Table 6 (8K-NPU SuperPod) ---------------------------------------
PAPER_UB_MESH = AFRBreakdown("UB-Mesh", 5.82, 1.55, 81.0, 0.56)
PAPER_CLOS = AFRBreakdown("Clos", 13.8, 574.0, 18.0, 27.0)
PAPER_MTTR_HOURS = 1.25            # 75 minutes
FAST_MTTR_HOURS = 13.0 / 60.0      # 10 min locate + 3 min migrate (§6.6)


# per-unit AFRs (failures/year/unit), calibrated against Table 6 given the
# component counts of an 8K system — shared by `derived_afr`, the per-
# GeometryCandidate availability scoring (`superpod_afr`) and the campaign's
# failure-class rate builder
AFR_PER_UNIT = {
    "passive_electrical": 1.0e-4,
    "active_electrical": 6.0e-4,
    "optical_100m": 1.3e-3,
    "optical_1km": 1.3e-3,
    "lrs": 3.5e-2,
    "hrs": 3.5e-2,
}


def superpod_afr(sp: SuperPod, name: str = "UB-Mesh(derived)") -> AFRBreakdown:
    """Component-count AFR breakdown for an arbitrary SuperPod geometry —
    the per-candidate form of :func:`derived_afr`'s UB-Mesh leg, so the
    codesign sweep can score availability for every `GeometryCandidate`."""
    cb = sp.cables_by_link_type()
    return AFRBreakdown(
        name,
        electrical_cable=(
            cb.get("passive_electrical", 0) * AFR_PER_UNIT["passive_electrical"]
            + cb.get("active_electrical", 0) * AFR_PER_UNIT["active_electrical"]
        ),
        optical_cable=(
            cb.get("optical_100m", 0) * AFR_PER_UNIT["optical_100m"]
            + cb.get("optical_1km", 0) * AFR_PER_UNIT["optical_1km"]
        ),
        lrs=sp.lrs_count() * AFR_PER_UNIT["lrs"],
        hrs=sp.hrs_count() * AFR_PER_UNIT["hrs"],
    )


def clos_afr(n_npus: int, name: str = "Clos(derived)") -> AFRBreakdown:
    """Component-count AFR breakdown for the Clos baseline fabric."""
    fab = ClosFabric(n_npus=n_npus)
    cc = fab.cables_by_link_type()
    return AFRBreakdown(
        name,
        electrical_cable=n_npus * 2 * AFR_PER_UNIT["passive_electrical"],
        optical_cable=(
            cc.get("optical_100m", 0) * AFR_PER_UNIT["optical_100m"]
            + cc.get("optical_1km", 0) * AFR_PER_UNIT["optical_1km"]
        ),
        lrs=0.0,
        hrs=fab.hrs_count() * AFR_PER_UNIT["hrs"],
    )


def derived_afr(n_npus: int = 8192) -> tuple[AFRBreakdown, AFRBreakdown]:
    """AFRs computed from our topology objects' component counts.

    Per-unit AFRs (failures/year/unit) calibrated against Table 6 given the
    component counts of an 8K system.
    """
    sp = SuperPod(n_pods=max(1, n_npus // 1024))
    return superpod_afr(sp), clos_afr(n_npus)


# --- 64+1 backup NPU (paper §3.3.2, Fig. 9) --------------------------------


@dataclass(frozen=True)
class BackupAnalysis:
    """Effect of the +1 backup NPU per 64-NPU rack."""

    npu_afr: float = 0.25        # NPU failures / year / NPU
    rack_size: int = 64
    n_backups: int = 1

    def rack_failure_rate_no_backup(self) -> float:
        """Rack loses capacity on ANY NPU failure."""
        return self.rack_size * self.npu_afr

    def rack_failure_rate_with_backup(self, repair_hours: float = 24.0) -> float:
        """Rack loses capacity only if a SECOND NPU fails while the first is
        being repaired/replaced (backup already holding the slot).
        Birthday-style thinning: rate2 ~ rate1 * (rate_rest * window).
        """
        rate1 = self.rack_size * self.npu_afr / HOURS_PER_YEAR  # per hour
        rate_rest = (self.rack_size - 1) * self.npu_afr / HOURS_PER_YEAR
        p_second_in_window = 1.0 - math.exp(-rate_rest * repair_hours)
        return rate1 * p_second_in_window * HOURS_PER_YEAR  # per year

    def capacity_loss_improvement(self, repair_hours: float = 24.0) -> float:
        return self.rack_failure_rate_no_backup() / max(
            self.rack_failure_rate_with_backup(repair_hours), 1e-12
        )

    def redirected_path_penalty_hops(self) -> int:
        """Fig. 9: direct link 5-3 becomes 5-LRS-B — one extra hop."""
        return 1
