"""The port's own copy of ``repro/core/capex.py``, held to the original by
``tests/test_torch_topology.py``; only its imports of the package differ.

CapEx / OpEx / cost-efficiency model (paper §6.4, Fig. 21).

Relative cost units (NPU := 100).  The paper reports only ratios, so unit
prices are calibrated to land its headline numbers:

* 4D-FM+Clos vs {2D-FM+x16Clos, 1D-FM+x16Clos, x64T Clos}: 1.18x / 1.26x /
  1.65x / 2.46x CapEx reduction,
* network share of system cost: 67% (Clos) -> 20% (UB-Mesh),
* 98% of HRS and 93% of optical modules saved,
* OpEx ~ 30% of the Clos system's TCO, UB-Mesh OpEx ~ 35-40% lower,
* cost-efficiency = perf / (CapEx + OpEx)  =>  ~2.04x.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .topology import (
    ClosFabric,
    LINK_SPECS,
    OPTICAL_1KM,
    OPTICAL_100M,
    SuperPod,
    ub_mesh_pod,
)

# relative unit prices (NPU = 100)
# Calibrated against the paper's published ratios (network share 67% for
# Clos / 20% for UB-Mesh, 2.46x CapEx gap => in NPU=100 units the 8K system
# needs Clos-network ~= 1.73M and UB-network ~= 0.21M; solved per component
# against the 8192-chip BOM counts — with these constants
# ``compare_architectures()`` lands CE gain 2.046, CapEx gain 2.446 and
# network shares 0.673 / 0.201, all within 1% of the paper (pinned at
# +-2% by ``tests/test_codesign.py``)
PRICE = {
    "npu": 100.0,
    "cpu": 12.0,
    "lrs": 34.0,
    "hrs": 150.0,
    "passive_electrical": 0.9,
    "active_electrical": 2.0,
    "optical_100m": 7.0,         # cable + 2 transceivers
    "optical_1km": 9.2,
    "nic": 1.0,
}

WATTS = {  # OpEx drivers, relative (NPU board incl. memory/VRM dominates)
    "npu": 140.0,
    "cpu": 25.0,
    "lrs": 8.0,
    "hrs": 90.0,
    "passive_electrical": 0.0,
    "active_electrical": 0.5,
    "optical_100m": 3.0,
    "optical_1km": 3.6,
}


@dataclass(frozen=True)
class BOM:
    """Bill of materials for one architecture at a given NPU count."""

    name: str
    n_npus: int
    n_cpus: int
    n_lrs: int
    n_hrs: int
    cables: dict[str, int]
    optical_modules: int

    def capex(self) -> float:
        c = (
            self.n_npus * PRICE["npu"]
            + self.n_cpus * PRICE["cpu"]
            + self.n_lrs * PRICE["lrs"]
            + self.n_hrs * PRICE["hrs"]
        )
        for k, v in self.cables.items():
            c += v * PRICE[k]
        return c

    def network_capex(self) -> float:
        c = self.n_lrs * PRICE["lrs"] + self.n_hrs * PRICE["hrs"]
        for k, v in self.cables.items():
            c += v * PRICE[k]
        return c

    def network_share(self) -> float:
        return self.network_capex() / self.capex()

    def power(self) -> float:
        w = (
            self.n_npus * WATTS["npu"]
            + self.n_cpus * WATTS["cpu"]
            + self.n_lrs * WATTS["lrs"]
            + self.n_hrs * WATTS["hrs"]
        )
        for k, v in self.cables.items():
            w += v * WATTS[k]
        return w

    def opex(self, years: float = 4.0, price_per_watt_year: float = 0.12) -> float:
        """Lifetime energy + maintenance; calibrated so OpEx ~ 30% of TCO."""
        maint = 0.05 * self.capex() * years / 4.0
        return self.power() * price_per_watt_year * years + maint

    def tco(self) -> float:
        return self.capex() + self.opex()


def superpod_bom(
    sp: SuperPod,
    *,
    name: str = "UB-Mesh(4D-FM+Clos)",
    uplink_provisioning: float = 1.0,
) -> BOM:
    """BOM of an arbitrary ``SuperPod`` geometry (co-design candidates).

    ``uplink_provisioning`` thins the pod->HRS Clos tier consistently across
    cables, transceivers and switches — the paper's Table-2 estimation prices
    the uplink for the <2% long-range DP share, not the full x256.
    """
    return BOM(
        name=name,
        n_npus=sp.num_nodes,
        n_cpus=sp.num_nodes // 8,
        n_lrs=sp.lrs_count(),
        n_hrs=sp.hrs_count(uplink_provisioning),
        cables=sp.cables_by_link_type(uplink_provisioning),
        optical_modules=sp.optical_modules(uplink_provisioning),
    )


def ub_mesh_bom(n_npus: int = 8192, uplink_provisioning: float = 1.0) -> BOM:
    """UB-Mesh SuperPod: 4D-FM pods + HRS Clos pod tier."""
    sp = SuperPod(n_pods=max(1, n_npus // 1024))
    return BOM(
        name="UB-Mesh(4D-FM+Clos)",
        n_npus=sp.num_nodes,
        n_cpus=sp.num_nodes // 8,
        n_lrs=sp.lrs_count(),
        n_hrs=sp.hrs_count(uplink_provisioning),
        cables=sp.cables_by_link_type(uplink_provisioning),
        optical_modules=sp.optical_modules(uplink_provisioning),
    )


def clos_bom(n_npus: int = 8192, lanes_per_npu: int = 72, name: str = "Clos(x64T)") -> BOM:
    fab = ClosFabric(n_npus=n_npus, lanes_per_npu=lanes_per_npu)
    return BOM(
        name=name,
        n_npus=n_npus,
        n_cpus=n_npus // 8,
        n_lrs=0,
        n_hrs=fab.hrs_count(),
        cables=fab.cables_by_link_type(),
        optical_modules=fab.optical_modules(),
    )


def hybrid_bom(n_npus: int = 8192, fm_dims: int = 2, inter_lanes: int = 16) -> BOM:
    """2D-FM or 1D-FM intra-rack + x{inter_lanes} Clos beyond (Fig. 16 b/c).

    The full-mesh part keeps its electrical cables; everything beyond the
    rack (or board for 1D) goes through a non-oversubscribed Clos built for
    ``inter_lanes`` per NPU.
    """
    pod = ub_mesh_pod()
    n_pods = max(1, n_npus // 1024)
    if fm_dims == 2:
        # keep X+Y cliques; Z/A/pod traffic switched
        per_pod = {
            k: v
            for k, v in pod.cables_by_link_type().items()
            if k == "passive_electrical"
        }
        kept_lanes = 56
        name = f"2D-FM+x{inter_lanes}Clos"
    else:
        # keep only the board X clique
        x = pod.dims[0]
        n_links = pod.link_count(0)
        cables_per_link = max(1, math.ceil(x.lanes_per_peer / x.link.lanes_per_cable))
        per_pod = {"passive_electrical": n_links * cables_per_link}
        kept_lanes = 28
        name = f"1D-FM+x{inter_lanes}Clos"
    cables = {k: v * n_pods for k, v in per_pod.items()}
    fab = ClosFabric(n_npus=n_npus, lanes_per_npu=inter_lanes)
    clos_cables = fab.cables_by_link_type()
    for k, v in clos_cables.items():
        cables[k] = cables.get(k, 0) + v
    lrs = 18 * 16 * n_pods if fm_dims == 2 else 18 * 16 * n_pods
    return BOM(
        name=name,
        n_npus=n_npus,
        n_cpus=n_npus // 8,
        n_lrs=lrs,
        n_hrs=fab.hrs_count(),
        cables=cables,
        optical_modules=fab.optical_modules(),
    )


@dataclass(frozen=True)
class CostEfficiency:
    name: str
    capex: float
    opex: float
    performance: float          # relative training throughput (Clos = 1.0)

    @property
    def tco(self) -> float:
        return self.capex + self.opex

    @property
    def cost_efficiency(self) -> float:
        return self.performance / self.tco


def compare_architectures(
    n_npus: int = 8192, perf: dict[str, float] | None = None
) -> list[CostEfficiency]:
    """The Fig. 21 comparison.  ``perf`` maps arch name -> relative perf
    (defaults to the paper's ~0.95 for UB-Mesh vs 1.0 Clos).
    """
    perf = perf or {}
    boms = [
        ub_mesh_bom(n_npus),
        hybrid_bom(n_npus, fm_dims=2, inter_lanes=16),
        hybrid_bom(n_npus, fm_dims=1, inter_lanes=16),
        clos_bom(n_npus),
    ]
    default_perf = {
        "UB-Mesh(4D-FM+Clos)": 0.95,
        "2D-FM+x16Clos": 0.97,
        "1D-FM+x16Clos": 0.985,
        "Clos(x64T)": 1.0,
    }
    out = []
    for b in boms:
        out.append(
            CostEfficiency(
                name=b.name,
                capex=b.capex(),
                opex=b.opex(),
                performance=perf.get(b.name, default_perf.get(b.name, 1.0)),
            )
        )
    return out
