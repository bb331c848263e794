"""The port's own copy of ``repro/core/alltoall.py``, held to the original by
``tests/test_torch_topology.py``; only its imports of the package differ.

Topology-aware All-to-All (paper §5.1, Fig. 14).

Two schemes on the 2D-FullMesh (generalizing to nD):

* **Multi-Path All2All** — each (src, dst) message is split into two
  partitions sent simultaneously over the X-then-Y and Y-then-X paths
  (at most one relay hop), doubling the usable bandwidth and balancing
  link load.
* **Hierarchical Broadcast+Reduce** — MoE token dispatch/combine is
  semantically overlapping broadcasts (tokens to experts) and reduces
  (expert outputs back); doing them hierarchically (intra-clique first,
  then one inter-clique copy) removes duplicate bytes from the long links.

These functions compute exact per-link loads so the benchmarks and cost
model can quantify the claims; the runtime lowering of the same idea lives
in ``repro/parallel/collectives.py`` (hierarchical all_to_all in shard_map).
"""

from __future__ import annotations

import itertools
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from .topology import NDFullMesh


@dataclass(frozen=True)
class A2AReport:
    scheme: str
    total_bytes: float            # bytes crossing links, summed over links
    max_link_bytes: float         # the bottleneck link load
    mean_link_bytes: float
    links_used: int
    max_hops: int

    @property
    def balance(self) -> float:
        """max/mean link load — 1.0 is perfectly balanced."""
        return self.max_link_bytes / self.mean_link_bytes if self.mean_link_bytes else 0.0


def _link(u: int, v: int) -> tuple[int, int]:
    return (u, v) if u < v else (v, u)


def multipath_a2a_loads(
    topo: NDFullMesh, msg_bytes: float = 1.0, *, split: bool = True
) -> A2AReport:
    """Uniform All-to-All on a 2D (or nD) full-mesh with XY/YX path splitting.

    ``split=False`` gives the single-path (dimension-ordered) baseline.
    """
    loads: dict[tuple[int, int], float] = defaultdict(float)
    n = topo.num_nodes
    max_hops = 0
    for src in range(n):
        cs = topo.coords(src)
        for dst in range(n):
            if src == dst:
                continue
            cd = topo.coords(dst)
            diff = [i for i in range(topo.ndim) if cs[i] != cd[i]]
            # enumerate the k! dimension orders; use 2 of them (or 1)
            orders = list(itertools.permutations(diff))
            chosen = orders if split else orders[:1]
            if split and len(orders) > 2:
                chosen = [orders[0], orders[-1]]       # XY... and reversed
            share = msg_bytes / len(chosen)
            for order in chosen:
                cur = list(cs)
                prev = src
                hops = 0
                for d in order:
                    cur[d] = cd[d]
                    nxt = topo.node_id(cur)
                    loads[_link(prev, nxt)] += share
                    prev = nxt
                    hops += 1
                max_hops = max(max_hops, hops)
    vals = np.array(list(loads.values())) if loads else np.zeros(1)
    return A2AReport(
        scheme="multipath" if split else "single-path",
        total_bytes=float(vals.sum()),
        max_link_bytes=float(vals.max()),
        mean_link_bytes=float(vals.mean()),
        links_used=len(loads),
        max_hops=max_hops,
    )


def permutation_a2a_pair_bandwidth(
    topo: NDFullMesh, *, multipath: bool = True
) -> float:
    """Per-pair bandwidth (GB/s) for permutation / skewed traffic.

    A single (src, dst) flow on the 2D-FullMesh uses ONE egress link under
    dimension-ordered routing; Multi-Path All2All (Fig. 14-(a)) splits it
    over the X-then-Y and Y-then-X paths simultaneously — 2x the per-flow
    bandwidth (and more with deeper APR detours).
    """
    # both paths' first hops leave on different dims => bandwidth adds
    gbs = [d.gbs_per_peer for d in topo.dims]
    return (gbs[0] + gbs[1]) if multipath and topo.ndim >= 2 else gbs[0]


@dataclass(frozen=True)
class MoEDispatchReport:
    """Long-link bytes for MoE dispatch/combine (paper Fig. 14-(b/c))."""

    scheme: str
    long_link_bytes_per_token: float   # expected bytes crossing clique edges
    local_bytes_per_token: float

    @property
    def total(self) -> float:
        return self.long_link_bytes_per_token + self.local_bytes_per_token


def hierarchical_moe_dispatch(
    n_cliques: int,
    topk: int,
    bytes_per_token: float = 1.0,
    *,
    local_clique_size: int = 8,
) -> tuple[MoEDispatchReport, MoEDispatchReport]:
    """Direct A2A vs hierarchical broadcast+reduce for MoE token dispatch.

    Token semantics: the SAME activation goes to ``topk`` experts (dispatch
    = overlapping broadcasts) and the ``topk`` expert outputs are SUMMED
    (combine = overlapping reduces).  Direct A2A ships ``topk`` copies over
    the long links; the hierarchical scheme ships ONE copy per *distinct
    destination clique* (broadcast dedup) and pre-reduces expert outputs
    inside each clique before the return trip.

    Expected distinct cliques for k uniform draws over c cliques:
        E[distinct] = c * (1 - (1 - 1/c)^k)

    Returns (direct, hierarchical) per-token byte reports.
    """
    c = n_cliques
    k = topk
    e_distinct = c * (1.0 - (1.0 - 1.0 / c) ** k)
    # probability a given expert lands in the source's own clique
    p_local = 1.0 / c
    direct = MoEDispatchReport(
        scheme="direct-a2a",
        long_link_bytes_per_token=bytes_per_token * k * (1 - p_local),
        local_bytes_per_token=bytes_per_token * k * p_local,
    )
    # hierarchical: one copy per distinct remote clique + local fan-out
    e_remote_distinct = e_distinct - (1.0 - (1.0 - 1.0 / c) ** k)  # exclude own
    hier = MoEDispatchReport(
        scheme="hierarchical",
        long_link_bytes_per_token=bytes_per_token * e_remote_distinct,
        local_bytes_per_token=bytes_per_token * k,  # fan-out within cliques
    )
    return direct, hier


def moe_dispatch_savings(n_cliques: int, topk: int) -> float:
    """Long-link byte reduction factor of the hierarchical scheme."""
    d, h = hierarchical_moe_dispatch(n_cliques, topk)
    if h.long_link_bytes_per_token == 0:
        return float("inf")
    return d.long_link_bytes_per_token / h.long_link_bytes_per_token


def a2a_time_s(
    topo: NDFullMesh,
    bytes_per_pair: float,
    *,
    multipath: bool = True,
    latency_s: float = 1e-6,
) -> float:
    """Completion time of a uniform A2A: bottleneck link load / link bw."""
    rep = multipath_a2a_loads(topo, bytes_per_pair, split=multipath)
    # a link in dim d has lanes_per_peer * gbps_per_lane bandwidth; use the
    # weakest dim the traffic crosses for a conservative bound.
    link_gbs = min(d.gbs_per_peer for d in topo.dims)
    return rep.max_link_bytes / (link_gbs * 1e9) + rep.max_hops * latency_s
