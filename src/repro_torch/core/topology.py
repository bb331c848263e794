"""The port's own copy of ``repro/core/topology.py``, held to the original by
``tests/test_torch_topology.py``; only its imports of the package differ.

nD-FullMesh topology — the core abstraction of UB-Mesh (paper §3.1).

An n-dimensional full-mesh ("Hamming graph") places every node at a coordinate
``(c_0, ..., c_{n-1})`` with ``c_i in [0, dims[i])``.  Two nodes are directly
linked iff their coordinates differ in exactly ONE dimension — i.e. along each
dimension, the nodes sharing all other coordinates form a clique (a 1D
full-mesh).  Recursively, adjacent 1D meshes form a 2D mesh, and so on —
exactly the paper's "board -> rack -> rack-row -> pod" hierarchy.

The concrete UB-Mesh-Pod (paper §3.3) is the 4D instance ``dims=(8, 8, 4, 4)``:

* dim 0 ("X"):  8 NPUs on a board              — passive electrical, ~1 m
* dim 1 ("Y"):  8 boards in a rack             — passive electrical, ~1 m
* dim 2 ("Z"):  4 racks in a row               — active electrical, ~10 m
* dim 3 ("A"):  4 rack-rows in a pod           — optical, ~100 m

SuperPod = several pods joined by high-radix switches (HRS) in a Clos tier
("B"/"G" dimensions, ~1 km optical).  Beyond that, the DCN.

This module is pure Python/numpy — it is the *model* of the network that the
APR router, the multi-ring collective planner, the cost model, the
parallelization planner and the reliability analysis all share.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field, replace
from functools import cached_property, lru_cache
from typing import Iterator, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Link / cable taxonomy  (paper Table 2)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinkSpec:
    """Physical characteristics of one cable class."""

    name: str
    reach_m: float            # typical reach
    lanes_per_cable: int      # UB lanes carried by one physical cable
    gbps_per_lane: float      # line rate of one UB lane (GByte/s)
    afr_per_unit: float       # annualized failure rate, % per cable (rel.)
    cost_per_cable: float     # relative cost units
    watts_per_cable: float    # OpEx model input


# Calibrated so the Table-2 cable-ratio benchmark lands near the paper's
# 86.7 / 7.2 / 4.8 / 1.2 split and Table-6 AFRs are reproducible.
PASSIVE_ELECTRICAL = LinkSpec("passive_electrical", 1.0, 4, 6.25, 0.0020, 1.0, 0.1)
ACTIVE_ELECTRICAL = LinkSpec("active_electrical", 10.0, 5, 6.25, 0.0060, 4.0, 2.5)
OPTICAL_100M = LinkSpec("optical_100m", 100.0, 8, 6.25, 0.0400, 25.0, 7.0)
OPTICAL_1KM = LinkSpec("optical_1km", 1000.0, 8, 6.25, 0.0450, 40.0, 9.0)

LINK_SPECS = {
    s.name: s
    for s in (PASSIVE_ELECTRICAL, ACTIVE_ELECTRICAL, OPTICAL_100M, OPTICAL_1KM)
}


@dataclass(frozen=True)
class DimSpec:
    """One dimension of the nD-FullMesh."""

    name: str                 # "X", "Y", "Z", "A", ...
    size: int                 # clique size along this dim
    link: LinkSpec            # cable class used for this dim
    lanes_per_peer: int       # UB lanes allocated to EACH peer in the clique
    trunk_width: int = 1      # NPUs aggregated per physical trunk (LRS dims:
                              # 64 NPUs share one UB x128 rack-to-rack trunk,
                              # paper Fig. 8-(d))

    @property
    def gbs_per_peer(self) -> float:
        return self.lanes_per_peer * self.link.gbps_per_lane

    @property
    def gbs_total(self) -> float:
        """Aggregate bandwidth of one node into this dimension."""
        return self.gbs_per_peer * (self.size - 1)


# ---------------------------------------------------------------------------
# The nD-FullMesh graph
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1 << 20)
def _coords(shape: tuple[int, ...], node: int) -> tuple[int, ...]:
    """Row-major node id -> coordinate tuple (memoized: id decoding is the
    single hottest scalar call in netsim DAG compilation and routing)."""
    out = []
    for size in reversed(shape):
        out.append(node % size)
        node //= size
    return tuple(reversed(out))


@dataclass(frozen=True)
class NDFullMesh:
    """An n-dimensional full-mesh of NPUs.

    Node ids are row-major over ``dims`` (last dim fastest), so the id is also
    the paper's *structured address*: the coordinate tuple IS the
    (pod, row, rack, board, npu) hierarchy and each dimension is a segment.
    """

    dims: tuple[DimSpec, ...]

    # -- basic shape ------------------------------------------------------
    # shape/num_nodes are cached per instance (frozen dataclass, so the
    # dims never change): the netsim hot paths call them millions of times
    @property
    def ndim(self) -> int:
        return len(self.dims)

    @cached_property
    def shape(self) -> tuple[int, ...]:
        return tuple(d.size for d in self.dims)

    @cached_property
    def num_nodes(self) -> int:
        return int(np.prod(self.shape))

    # -- addressing (paper §4.1.2: structured addressing) -----------------
    def coords(self, node: int) -> tuple[int, ...]:
        return _coords(self.shape, node)

    def node_id(self, coords: Sequence[int]) -> int:
        nid = 0
        for c, size in zip(coords, self.shape):
            if not (0 <= c < size):
                raise ValueError(f"coordinate {coords} out of range for {self.shape}")
            nid = nid * size + c
        return nid

    # -- adjacency ---------------------------------------------------------
    def neighbors(self, node: int, dim: int) -> list[int]:
        """All peers of ``node`` in the clique of dimension ``dim``."""
        c = list(self.coords(node))
        out = []
        for v in range(self.shape[dim]):
            if v != c[dim]:
                cc = list(c)
                cc[dim] = v
                out.append(self.node_id(cc))
        return out

    def all_neighbors(self, node: int) -> list[tuple[int, int]]:
        """(peer, dim) for every direct link of ``node``."""
        return [(p, d) for d in range(self.ndim) for p in self.neighbors(node, d)]

    def are_adjacent(self, u: int, v: int) -> int | None:
        """Return the dimension of the direct link u-v, or None."""
        cu, cv = self.coords(u), self.coords(v)
        diff = [i for i, (a, b) in enumerate(zip(cu, cv)) if a != b]
        return diff[0] if len(diff) == 1 else None

    def hop_distance(self, u: int, v: int) -> int:
        """Shortest-path hops = Hamming distance of the coordinates."""
        cu, cv = self.coords(u), self.coords(v)
        return sum(a != b for a, b in zip(cu, cv))

    def links(self, dim: int | None = None) -> Iterator[tuple[int, int, int]]:
        """Iterate (u, v, dim) over every direct link, u < v."""
        dims = range(self.ndim) if dim is None else (dim,)
        for d in dims:
            for node in range(self.num_nodes):
                for peer in self.neighbors(node, d):
                    if node < peer:
                        yield node, peer, d

    def link_count(self, dim: int) -> int:
        """Number of direct links in dimension ``dim``."""
        k = self.shape[dim]
        groups = self.num_nodes // k
        return groups * k * (k - 1) // 2

    # -- physical accounting (Table 2 / CapEx / AFR) ----------------------
    def _cables_for_dim(self, i: int) -> int:
        """Physical cable count for dimension ``i``.

        Direct dims (trunk_width=1): one cable bundle per NPU pair.
        Trunked dims (e.g. inter-rack via LRS): the ``trunk_width`` NPU-pairs
        between two groups share one fat trunk of
        ``lanes_per_peer * trunk_width`` lanes (paper Fig. 8-(d): UB x128).
        """
        d = self.dims[i]
        n_links = self.link_count(i)
        if d.trunk_width <= 1:
            per = max(1, math.ceil(d.lanes_per_peer / d.link.lanes_per_cable))
            return n_links * per
        n_trunks = n_links // d.trunk_width
        lanes = d.lanes_per_peer * d.trunk_width
        return n_trunks * max(1, math.ceil(lanes / d.link.lanes_per_cable))

    def cables_by_dim(self) -> dict[str, int]:
        return {d.name: self._cables_for_dim(i) for i, d in enumerate(self.dims)}

    def cables_by_link_type(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for i, d in enumerate(self.dims):
            out[d.link.name] = out.get(d.link.name, 0) + self._cables_for_dim(i)
        return out

    # -- per-node bandwidth ------------------------------------------------
    def node_bandwidth_gbs(self) -> float:
        """Aggregate injection bandwidth of one NPU (all dims)."""
        return sum(d.gbs_total for d in self.dims)

    def dim_bandwidth_gbs(self, dim: int) -> float:
        return self.dims[dim].gbs_total

    def bisection_bandwidth_gbs(self, dim: int) -> float:
        """Bisection bandwidth cutting dimension ``dim`` in half."""
        k = self.shape[dim]
        half = k // 2
        cross_links_per_group = half * (k - half)
        groups = self.num_nodes // k
        return groups * cross_links_per_group * self.dims[dim].gbs_per_peer

    # -- derived topologies -------------------------------------------------
    def subgroup_nodes(self, fixed: dict[int, int]) -> list[int]:
        """All node ids whose coordinate matches ``fixed`` {dim: value}."""
        ranges = [
            [fixed[i]] if i in fixed else list(range(s))
            for i, s in enumerate(self.shape)
        ]
        return [self.node_id(c) for c in itertools.product(*ranges)]


# ---------------------------------------------------------------------------
# UB-Mesh reference instances
# ---------------------------------------------------------------------------


def ub_mesh_pod(
    *,
    board: int = 8,
    boards_per_rack: int = 8,
    racks_per_row: int = 4,
    rows: int = 4,
    x_lanes: int = 4,
    y_lanes: int = 4,
    z_lanes: int = 2,
    a_lanes: int = 2,
) -> NDFullMesh:
    """The paper's 4D-FullMesh UB-Mesh-Pod: 8x8 NPUs per rack, 4x4 racks.

    Per-NPU UB x72 budget (Table 3): 7 X-peers * 4 + 7 Y-peers * 4 = 56 lanes
    intra-rack, plus x16 inter-rack IO (paper §6.3 default) split between the
    Z and A dimensions through the LRS backplane (3 peers * 2 lanes each + HRS
    uplink headroom).
    """
    rack = board * boards_per_rack
    return NDFullMesh(
        dims=(
            DimSpec("X", board, PASSIVE_ELECTRICAL, x_lanes),
            DimSpec("Y", boards_per_rack, PASSIVE_ELECTRICAL, y_lanes),
            DimSpec("Z", racks_per_row, ACTIVE_ELECTRICAL, z_lanes, trunk_width=rack),
            DimSpec("A", rows, OPTICAL_100M, a_lanes, trunk_width=rack),
        )
    )


def ub_mesh_rack() -> NDFullMesh:
    """One rack = 2D-FullMesh of 64 NPUs (8 per board x 8 boards)."""
    return NDFullMesh(
        dims=(
            DimSpec("X", 8, PASSIVE_ELECTRICAL, 4),
            DimSpec("Y", 8, PASSIVE_ELECTRICAL, 4),
        )
    )


@dataclass(frozen=True)
class SuperPod:
    """UB-Mesh-SuperPod: ``n_pods`` 4D-FullMesh pods + HRS Clos tier (§3.3.4).

    The pod-level interconnection is symmetrical Clos via HRS so the cloud
    manager can slice the SuperPod; we model it as a single-stage non-blocking
    abstraction with per-rack uplink bandwidth ``uplink_lanes_per_rack``.
    """

    pod: NDFullMesh = field(default_factory=ub_mesh_pod)
    n_pods: int = 8
    uplink_lanes_per_rack: int = 256     # four UB x256 backplane IO, 1 to HRS
    hrs_radix: int = 512

    @property
    def num_nodes(self) -> int:
        return self.pod.num_nodes * self.n_pods

    @property
    def racks_per_pod(self) -> int:
        # rack = (X, Y) subgroup => racks = product of inter-rack dims
        return int(np.prod(self.pod.shape[2:])) if self.pod.ndim > 2 else 1

    @property
    def n_racks(self) -> int:
        return self.racks_per_pod * self.n_pods

    def hrs_count(self, uplink_provisioning: float = 1.0) -> int:
        """High-radix switches needed for the pod-level Clos tier.

        ``uplink_provisioning`` mirrors the knob on
        ``cables_by_link_type``: a thinner pod->HRS tier needs
        proportionally fewer switch ports, hence fewer HRS.
        """
        lanes = self.uplink_lanes_per_rack * uplink_provisioning
        total_uplinks = self.n_racks * lanes
        return max(1, math.ceil(total_uplinks / self.hrs_radix))

    def optical_modules(self, uplink_provisioning: float = 1.0) -> int:
        """Optical transceivers: 2 per optical cable (both ends)."""
        per_pod = self.pod.cables_by_link_type()
        pod_optical = sum(
            v for k, v in per_pod.items() if k.startswith("optical")
        )
        lanes = self.uplink_lanes_per_rack * uplink_provisioning
        uplink_cables = self.n_racks * math.ceil(
            lanes / OPTICAL_1KM.lanes_per_cable
        )
        return 2 * (pod_optical * self.n_pods + uplink_cables)

    def lrs_count(self) -> int:
        # paper §3.3.1: 18 LRS per rack backplane (x4 switch planes worth are
        # folded into the 18 fully-connected LRS of one plane description).
        return 18 * self.n_racks

    def cables_by_link_type(self, uplink_provisioning: float = 1.0) -> dict[str, int]:
        """Cable counts.  ``uplink_provisioning < 1`` models a thinner
        pod->HRS tier (the paper's Table-2 estimation assumes the Clos tier
        is provisioned for the <2% long-range DP traffic, not full x256).
        """
        out: dict[str, int] = {}
        per_pod = self.pod.cables_by_link_type()
        for k, v in per_pod.items():
            out[k] = out.get(k, 0) + v * self.n_pods
        lanes = self.uplink_lanes_per_rack * uplink_provisioning
        uplink_cables = self.n_racks * math.ceil(
            lanes / OPTICAL_1KM.lanes_per_cable
        )
        out[OPTICAL_1KM.name] = out.get(OPTICAL_1KM.name, 0) + uplink_cables
        return out


# ---------------------------------------------------------------------------
# Baseline fabrics for comparison (paper §2.3, §6)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClosFabric:
    """Non-oversubscribed 2-tier (leaf/spine) Clos of HRS switches.

    Every NPU port goes to a leaf; leaves connect to spines with full
    bisection.  This is the paper's cost baseline: all NPU bandwidth is
    switched, every inter-switch link is optical.
    """

    n_npus: int
    lanes_per_npu: int = 72
    hrs_radix: int = 512

    def leaf_count(self) -> int:
        # half the radix faces NPUs, half faces spines (non-oversubscribed)
        down = self.hrs_radix // 2
        return math.ceil(self.n_npus * self.lanes_per_npu / down)

    def spine_count(self) -> int:
        up_total = self.leaf_count() * (self.hrs_radix // 2)
        return math.ceil(up_total / self.hrs_radix)

    def hrs_count(self) -> int:
        return self.leaf_count() + self.spine_count()

    def optical_modules(self) -> int:
        # NPU->leaf may be short DAC in-rack for a fraction; the paper's
        # baseline assumes optical everywhere above the NIC: 2 modules/cable.
        npu_leaf_cables = self.n_npus * math.ceil(
            self.lanes_per_npu / OPTICAL_100M.lanes_per_cable
        )
        leaf_spine_cables = self.leaf_count() * (self.hrs_radix // 2) // OPTICAL_1KM.lanes_per_cable
        return 2 * (npu_leaf_cables + leaf_spine_cables)

    def cables_by_link_type(self) -> dict[str, int]:
        npu_leaf = self.n_npus * math.ceil(
            self.lanes_per_npu / OPTICAL_100M.lanes_per_cable
        )
        leaf_spine = self.leaf_count() * (self.hrs_radix // 2) // OPTICAL_1KM.lanes_per_cable
        return {OPTICAL_100M.name: npu_leaf, OPTICAL_1KM.name: leaf_spine}


@dataclass(frozen=True)
class Torus3D:
    """3D torus baseline (paper Fig. 3): 6 neighbors per node."""

    shape: tuple[int, int, int]
    lanes_per_link: int = 12

    @property
    def n_npus(self) -> int:
        return int(np.prod(self.shape))

    def link_count(self) -> int:
        return 3 * self.n_npus  # each node owns +1 link per dim (torus wrap)

    def node_bandwidth_gbs(self) -> float:
        return 6 * self.lanes_per_link * PASSIVE_ELECTRICAL.gbps_per_lane


# ---------------------------------------------------------------------------
# Mapping the logical JAX mesh onto the UB-Mesh hierarchy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshView:
    """How a logical ``jax.sharding.Mesh`` axis maps onto UB-Mesh dimensions.

    The production mesh is ("data", "model") = (16, 16) per pod (and a "pod"
    axis across pods).  "model" = the intra-rack high-bandwidth domain
    (paper's TP/SP domain), "data" = inter-rack 2D-FullMesh, "pod" = HRS Clos.

    ``axis_gbs`` is the per-chip bandwidth available to collectives running
    over that axis; the cost model and the roofline collective term both read
    it, so topology-awareness is one consistent story end-to-end.
    """

    axis_dims: dict[str, tuple[int, ...]]   # mesh axis -> UB-Mesh dims it spans
    axis_gbs: dict[str, float]              # mesh axis -> per-chip GB/s
    axis_latency_us: dict[str, float]       # mesh axis -> per-hop latency


def production_mesh_view(topo: NDFullMesh | None = None, *, multi_pod: bool = False) -> MeshView:
    """The canonical mapping used by cost model + roofline.

    model axis (16) = one board X-clique x 2 lanes-groups... concretely we map
    it to the intra-rack 2D-FM slice (X full-mesh of 8 x 2 boards) giving each
    chip the full intra-rack allocation; data axis (16) = inter-rack (Z, A)
    2D-FM; pod axis (2) = HRS Clos tier.
    """
    topo = topo or ub_mesh_pod()
    x, y, z, a = topo.dims
    intra_gbs = x.gbs_total + y.gbs_total          # 56 lanes * 6.25 = 350 GB/s
    inter_gbs = z.gbs_total + a.gbs_total          # x16-ish inter-rack IO
    view = {
        "model": ((0, 1), intra_gbs, 0.5),
        "data": ((2, 3), inter_gbs, 2.0),
    }
    if multi_pod:
        # HRS Clos tier: one x256 uplink shared by the 64 NPUs of a rack.
        uplink_per_chip = 256 * OPTICAL_1KM.gbps_per_lane / 64.0
        view["pod"] = ((), uplink_per_chip, 5.0)
    return MeshView(
        axis_dims={k: v[0] for k, v in view.items()},
        axis_gbs={k: v[1] for k, v in view.items()},
        axis_latency_us={k: v[2] for k, v in view.items()},
    )
