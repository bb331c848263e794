"""The port's own copy of ``repro/core/ub.py``, held to the original by
``tests/test_torch_topology.py``; only its imports of the package differ.

Unified Bus (UB) IO model (paper §3.2.2, Fig. 5-6).

Every component (NPU / CPU / LRS / HRS) exposes a number of UB *lanes* that
can be flexibly budgeted across uses — inter-NPU dimensions, CPU traffic,
switch uplinks.  This module is the single source of truth for lane budgets;
the topology, cost model, planner and roofline all derive bandwidth from it,
which is the paper's "flexible IO resource allocation" made concrete.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Table 3 IO capabilities
NPU_LANES = 72
CPU_LANES = 32
LRS_LANES = 72
HRS_LANES = 512

GBPS_PER_LANE = 6.25  # GB/s per UB lane (x72 => 450 GB/s ~= 3.6 Tbps, R2)


@dataclass(frozen=True)
class LaneAllocation:
    """Per-NPU lane budget across the nD-FullMesh dims + switched IO."""

    per_dim: dict[str, int] = field(
        default_factory=lambda: {"X": 28, "Y": 28, "Z": 6, "A": 6}
    )
    switched: int = 4  # LRS uplink share (CPU traffic, backup NPU, borrow)

    @property
    def total(self) -> int:
        return sum(self.per_dim.values()) + self.switched

    def validate(self, budget: int = NPU_LANES) -> None:
        if self.total > budget:
            raise ValueError(
                f"lane allocation {self.total} exceeds UB x{budget} budget"
            )

    def bandwidth_gbs(self, dim: str) -> float:
        return self.per_dim.get(dim, 0) * GBPS_PER_LANE

    def intra_rack_gbs(self) -> float:
        return (self.per_dim.get("X", 0) + self.per_dim.get("Y", 0)) * GBPS_PER_LANE

    def inter_rack_gbs(self) -> float:
        return (self.per_dim.get("Z", 0) + self.per_dim.get("A", 0)) * GBPS_PER_LANE

    def rebalance(self, **per_dim: int) -> "LaneAllocation":
        """The Fig. 5-(b) knob: shift lanes between dimensions."""
        new = dict(self.per_dim)
        new.update(per_dim)
        alloc = LaneAllocation(per_dim=new, switched=self.switched)
        alloc.validate()
        return alloc


DEFAULT_ALLOCATION = LaneAllocation()
# paper §6.3: inter-rack UB x16 per NPU default; x32 favored for >=64K seq.
LONG_CONTEXT_ALLOCATION = LaneAllocation(
    per_dim={"X": 20, "Y": 20, "Z": 14, "A": 14}, switched=4
)
