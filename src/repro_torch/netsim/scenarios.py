"""The port's own copy of ``repro/netsim/scenarios.py``, held to the original by
``tests/test_torch_netsim.py``; only its imports of the package differ.

Canonical netsim scenarios shared by benchmarks and tests.

Keeping these in the package (rather than duplicated in
``benchmarks/netsim_bench.py`` and ``tests/test_netsim.py``) means the
benchmark and the regression test always validate the *same* traffic
pattern.
"""

from __future__ import annotations

from typing import NamedTuple

from ..core.topology import ACTIVE_ELECTRICAL, DimSpec, NDFullMesh, OPTICAL_100M
from .collectives import FlowDAG


def inter_rack_mesh(z: int = 4, a: int = 4) -> NDFullMesh:
    """Rack-level 2D-FullMesh: the (Z, A) inter-rack fabric of one pod."""
    return NDFullMesh(
        dims=(
            DimSpec("Z", z, ACTIVE_ELECTRICAL, 2),
            DimSpec("A", a, OPTICAL_100M, 2),
        )
    )


def hotspot_dag(topo: NDFullMesh, size: float = 8e6) -> FlowDAG:
    """Cross-rack hotspot: in every row a, rack (0,a) sends to (1, a+k) for
    k=0..2 — the three dimension-ordered paths collide on link
    (0,a)->(1,a) while other links idle.  Multipath routes around it, which
    is what separates the §6.3 strategies (Fig. 19 ordering)."""
    dag = FlowDAG(name="hotspot")
    for a in range(topo.shape[1]):
        for k in range(3):
            dag._add(
                src=topo.node_id((0, a)),
                dst=topo.node_id((1, (a + k) % topo.shape[1])),
                size=size,
                tag=f"h{a}.{k}",
            )
    return dag


class TrunkCongestion(NamedTuple):
    """One trunk-congestion scenario: run ``dag`` on ``topo`` with
    ``rx_gbs`` and watch ``hot_link``."""

    topo: NDFullMesh
    dag: FlowDAG
    hot_link: tuple[int, int]            # the trunk every shortest path shares
    rx_gbs: float                        # receiver-egress cap to run with


def trunk_congestion(
    z: int = 4, a: int = 4, size: float = 32e6, fan: int = 3
) -> TrunkCongestion:
    """Fig. 19 in miniature, built to make the congested trunk *visible*
    in telemetry: rack (0,0) sends ``fan`` transfers to (1,1)..(1,fan) —
    never to (1,0) directly — so every dimension-ordered shortest path
    funnels through the single Z-trunk (0,0)->(1,0) while the A-dim
    links sit idle.

    The returned ``rx_gbs`` (half the trunk's per-peer bandwidth) makes
    the strategies separate cleanly in *peak trunk utilization*, not just
    throughput: under SHORTEST the trunk carries all ``fan`` transfers
    and saturates (peak 1.0; per-flow share trunk/fan < rx, so bottleneck
    attribution names the trunk); under DETOUR/BORROW each transfer
    splits over ~4 APR paths and the rx cap binds every subflow at
    rx/4 — the trunk then carries only ~fan * rx/4, measurably below
    capacity.
    """
    if z < 2 or fan < 1 or fan > a - 1:
        raise ValueError(
            f"need z >= 2 and 1 <= fan <= a-1 (got z={z}, a={a}, fan={fan})"
        )
    topo = inter_rack_mesh(z, a)
    dag = FlowDAG(name="trunk-congestion")
    src = topo.node_id((0, 0))
    for k in range(1, fan + 1):
        dag._add(
            src=src, dst=topo.node_id((1, k)), size=size, tag=f"tc{k}"
        )
    return TrunkCongestion(
        topo=topo,
        dag=dag,
        hot_link=(src, topo.node_id((1, 0))),
        rx_gbs=topo.dims[0].gbs_per_peer / 2,
    )
