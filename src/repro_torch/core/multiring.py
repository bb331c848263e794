"""The port's own copy of ``repro/core/multiring.py``, held to the original by
``tests/test_torch_topology.py``; only its imports of the package differ.

Multi-Ring AllReduce planner (paper §5.1, Fig. 13).

In a full-mesh clique of ``n`` nodes a single ring uses only ``n`` of the
``n(n-1)/2`` links — the rest idle.  The paper's Multi-Ring algorithm maps
the AllReduce onto MANY edge-disjoint rings simultaneously ("ensuring
exclusive path usage without traffic conflicts"), then *borrows* the links
that are still idle via APR to carry overflow traffic.

This module plans those rings:

* odd  n: Walecki decomposition — (n-1)/2 edge-disjoint Hamiltonian cycles
  covering EVERY clique link.
* even n: zig-zag decomposition — n/2 edge-disjoint Hamiltonian paths
  covering every link ("multi-chain"; a chain AllReduce has the same
  asymptotic per-link traffic as a ring).
* **cross-dimension 2D grids** (paper Fig. 13's joint (X, Y) schedule):
  ``grid_ring_decomposition`` decomposes the 2D Hamming graph
  ``K_x [] K_y`` — the graph whose edges are BOTH cliques' links — into
  edge-disjoint Hamiltonian cycles that zig-zag between X and Y links.
  A per-dimension hierarchical schedule drives only one dimension's links
  per phase, so a rack measures ~half its clique allocation; cross-dim
  rings keep X and Y links busy simultaneously and recover it.

Every decomposition is verified by construction (`verify=True` asserts
edge-disjointness + full coverage), and the planner computes the effective
per-chip AllReduce bandwidth the cost model uses.
"""

from __future__ import annotations

import itertools
import logging
import random
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .topology import NDFullMesh

log = logging.getLogger(__name__)

Ring = tuple[int, ...]   # cyclic order of nodes (cycle: implicit wrap) / path


def _edges_of_cycle(cycle: Ring) -> set[tuple[int, int]]:
    return {
        tuple(sorted((cycle[i], cycle[(i + 1) % len(cycle)])))
        for i in range(len(cycle))
    }


def _edges_of_path(path: Ring) -> set[tuple[int, int]]:
    return {tuple(sorted(e)) for e in zip(path, path[1:])}


def walecki_cycles(n: int) -> list[Ring]:
    """Edge-disjoint Hamiltonian cycles of K_n for ODD n ((n-1)/2 of them).

    Classical construction: hub vertex ``n-1``; the other ``n-1`` vertices sit
    on a circle (Z_{n-1}); cycle k is the hub plus the zig-zag
    k, k+1, k-1, k+2, k-2, ... rotated by k.
    """
    if n % 2 == 0:
        raise ValueError("walecki_cycles needs odd n")
    if n == 1:
        return []
    m = (n - 1) // 2
    # zig-zag 0, 1, -1, 2, -2, ... over Z_{n-1}
    zig = [0]
    for j in range(1, n - 1):
        k = (j + 1) // 2
        zig.append(k if j % 2 == 1 else -k)
    cycles = []
    for k in range(m):
        cyc = [n - 1] + [(k + z) % (n - 1) for z in zig]
        cycles.append(tuple(cyc))
    return cycles


def zigzag_paths(n: int) -> list[Ring]:
    """Edge-disjoint Hamiltonian paths of K_n for EVEN n (n/2 of them)."""
    if n % 2 == 1:
        raise ValueError("zigzag_paths needs even n")
    m = n // 2
    zig = [0]
    for j in range(1, n):
        k = (j + 1) // 2
        zig.append(k if j % 2 == 1 else -k)
    # zig has n entries; differences are +1,-2,+3,... covering 1..n-1 once
    paths = []
    for k in range(m):
        paths.append(tuple((k + z) % n for z in zig))
    return paths


def clique_decomposition(n: int, verify: bool = True) -> tuple[list[Ring], bool]:
    """Decompose K_n into edge-disjoint Hamiltonian rings/chains.

    Returns (rings, closed) where ``closed`` says whether entries are cycles
    (odd n) or open chains (even n).
    """
    if n < 2:
        return [], False
    if n == 2:
        return [(0, 1)], False
    rings = walecki_cycles(n) if n % 2 == 1 else zigzag_paths(n)
    closed = n % 2 == 1
    if verify:
        edge_fn = _edges_of_cycle if closed else _edges_of_path
        all_edges: set[tuple[int, int]] = set()
        for r in rings:
            assert len(set(r)) == n, f"not Hamiltonian: {r}"
            e = edge_fn(r)
            assert not (e & all_edges), f"rings not edge-disjoint for n={n}"
            all_edges |= e
        expected = n * (n - 1) // 2
        assert len(all_edges) == expected, (
            f"decomposition covers {len(all_edges)}/{expected} edges of K_{n}"
        )
    return rings, closed


@dataclass(frozen=True)
class MultiRingPlan:
    """A planned multi-ring AllReduce over one full-mesh clique."""

    n: int
    rings: tuple[Ring, ...]
    closed: bool            # cycles (True) or chains (False)
    lanes_per_peer: int     # UB lanes on each clique link
    gbps_per_lane: float

    @property
    def links_used(self) -> int:
        per = self.n if self.closed else self.n - 1
        return per * len(self.rings)

    @property
    def links_total(self) -> int:
        return self.n * (self.n - 1) // 2

    @property
    def utilization(self) -> float:
        """Fraction of clique links carrying AllReduce traffic."""
        return self.links_used / max(1, self.links_total)

    def effective_bandwidth_gbs(self) -> float:
        """Per-chip AllReduce *algorithm* bandwidth.

        Single ring: per-chip injection = one link's bandwidth.
        Multi-ring: data is split across R rings => R links inject in
        parallel from every chip => R x one-link bandwidth, which for a full
        decomposition equals (almost) the node's whole clique allocation —
        the paper's "fully utilize the bandwidth of direct links".
        """
        link_gbs = self.lanes_per_peer * self.gbps_per_lane
        return len(self.rings) * link_gbs

    def allreduce_wire_bytes_per_chip(self, size_bytes: int) -> float:
        """Ring/chain AllReduce: each chip sends 2(n-1)/n of its shard count
        per ring; total across rings is still 2(n-1)/n * size (the split
        shrinks per-ring payload, not the total).
        """
        n = self.n
        if n <= 1:
            return 0.0
        return 2.0 * (n - 1) / n * size_bytes

    def allreduce_time_s(self, size_bytes: int, latency_s: float = 1e-6) -> float:
        n = self.n
        if n <= 1:
            return 0.0
        wire = self.allreduce_wire_bytes_per_chip(size_bytes)
        bw = self.effective_bandwidth_gbs() * 1e9
        steps = 2 * (n - 1)
        return wire / bw + steps * latency_s


def plan_multiring(topo: NDFullMesh, dim: int) -> MultiRingPlan:
    """Plan the multi-ring AllReduce for the clique of dimension ``dim``."""
    n = topo.shape[dim]
    rings, closed = clique_decomposition(n)
    d = topo.dims[dim]
    return MultiRingPlan(
        n=n,
        rings=tuple(rings),
        closed=closed,
        lanes_per_peer=d.lanes_per_peer,
        gbps_per_lane=d.link.gbps_per_lane,
    )


def single_ring_bandwidth_gbs(topo: NDFullMesh, dim: int) -> float:
    """Baseline: one ring through the clique uses one link per chip."""
    d = topo.dims[dim]
    return d.lanes_per_peer * d.link.gbps_per_lane


def borrowed_bandwidth_gbs(
    topo: NDFullMesh, dim: int, *, borrow_lanes: int = 0
) -> float:
    """`Borrow` strategy (paper §6.3): racks may route overflow through the
    LRS/HRS switch plane, adding ``borrow_lanes`` of switched bandwidth on
    top of the direct-link multi-ring.
    """
    plan = plan_multiring(topo, dim)
    return plan.effective_bandwidth_gbs() + borrow_lanes * topo.dims[dim].link.gbps_per_lane


# ---------------------------------------------------------------------------
# Cross-dimension 2D multi-ring (rings spanning the (X, Y) cliques jointly)
# ---------------------------------------------------------------------------
#
# The 2D Hamming graph K_n [] K_n (nodes (i, j); edges between nodes that
# differ in exactly one coordinate) is (2n-2)-regular with n^2(n-1) edges, so
# a perfect decomposition has exactly n-1 Hamiltonian cycles of n^2 edges.
#
# * even n — "rainbow rotation": let phi rotate both coordinates by the
#   (n-1)-cycle (0 1 ... n-2), fixing n-1.  Every edge orbit under phi has
#   size exactly n-1 (a smaller orbit would need 2k = 0 mod n-1 with n-1
#   odd), giving n^2 orbits.  A base Hamiltonian cycle that uses each orbit
#   at most once therefore has n-1 pairwise edge-disjoint images covering
#   every edge.  Base cycles for the UB-Mesh sizes (4, 6, 8) were found by
#   ``_search_rainbow_cycle`` and are inlined; other even sizes fall back to
#   the same deterministic search at runtime.
# * odd n — Walecki pairing: pair the i-th Walecki Hamiltonian cycle of the
#   row clique with the i-th of the column clique; their Cartesian product
#   is an n x n torus, which splits into two "helix" Hamiltonian cycles
#   (right n-1 / down 1 vs. down n-1 / right 1, entry points matched so the
#   leftover diagonals complement each other) — 2 * (n-1)/2 = n-1 cycles.
#
# Both constructions are re-verified at runtime (edge-disjointness + full
# coverage) before any schedule is built on them.

# base rainbow cycles (local ids i*n + j), discovered by _search_rainbow_cycle
_RAINBOW_BASE: dict[int, tuple[int, ...]] = {
    4: (15, 7, 11, 8, 12, 4, 0, 3, 2, 1, 9, 10, 6, 5, 13, 14),
    6: (35, 17, 16, 22, 18, 20, 26, 2, 0, 6, 30, 24, 12, 15, 27, 29, 28, 10,
        9, 21, 19, 23, 5, 11, 8, 7, 1, 4, 3, 33, 32, 14, 13, 25, 31, 34),
    8: (63, 59, 57, 56, 60, 52, 51, 55, 23, 15, 31, 28, 4, 12, 20, 36, 39,
        32, 33, 49, 48, 50, 58, 42, 44, 47, 40, 41, 1, 25, 30, 54, 62, 46,
        38, 34, 37, 45, 43, 3, 35, 27, 24, 0, 16, 17, 21, 18, 19, 22, 14,
        6, 2, 26, 10, 8, 9, 11, 13, 53, 61, 29, 5, 7),
}


def _rot(k: int, n: int) -> int:
    """The coordinate rotation phi: (n-1)-cycle on 0..n-2, fixing n-1."""
    return k if k == n - 1 else (k + 1) % (n - 1)


def _grid_orbit_id(u: tuple[int, int], v: tuple[int, int], n: int) -> tuple:
    """Canonical representative of edge {u, v}'s orbit under phi x phi."""
    best = None
    a, b = u, v
    for _ in range(n - 1):
        a = (_rot(a[0], n), _rot(a[1], n))
        b = (_rot(b[0], n), _rot(b[1], n))
        e = (a, b) if a < b else (b, a)
        if best is None or e < best:
            best = e
    return best


def _grid_neighbors(u: tuple[int, int], n: int) -> list[tuple[int, int]]:
    i, j = u
    return [(i, jj) for jj in range(n) if jj != j] + [
        (ii, j) for ii in range(n) if ii != i
    ]


def _search_rainbow_cycle(
    n: int, *, seeds: int = 64, max_steps: int = 400_000
) -> tuple[int, ...] | None:
    """Deterministic Warnsdorff-style DFS for a Hamiltonian cycle of
    K_n [] K_n using at most one edge per phi-orbit (even n only)."""
    start = (n - 1, n - 1)
    for seed in range(seeds):
        rng = random.Random(seed)
        used: set[tuple] = set()
        path = [start]
        on = {start}
        steps = 0

        def options(u):
            out = []
            for v in _grid_neighbors(u, n):
                if v in on:
                    continue
                oid = _grid_orbit_id(u, v, n)
                if oid not in used:
                    out.append((v, oid))
            return out

        def dfs() -> bool:
            nonlocal steps
            steps += 1
            if steps > max_steps:
                raise TimeoutError
            u = path[-1]
            if len(path) == n * n:
                return _grid_orbit_id(u, start, n) not in used
            scored = []
            for v, oid in options(u):
                used.add(oid)
                on.add(v)
                scored.append((len(options(v)), rng.random(), v, oid))
                used.discard(oid)
                on.discard(v)
            scored.sort()
            for _k, _r, v, oid in scored:
                used.add(oid)
                path.append(v)
                on.add(v)
                if dfs():
                    return True
                used.discard(oid)
                path.pop()
                on.discard(v)
            return False

        try:
            if dfs():
                return tuple(i * n + j for i, j in path)
        except TimeoutError:
            continue
    return None


def _helix_pair(C: Ring, D: Ring) -> tuple[Ring, Ring]:
    """Split the torus C [] D (product of two n-cycles) into two Hamiltonian
    "helix" cycles.  Helix A repeats [n-1 steps along D, 1 step along C];
    helix B repeats [n-1 steps along C, 1 step along D].  With matched entry
    points A's skipped diagonal is exactly the set of edges B uses, so the
    two are edge-disjoint and together cover the torus."""
    n = len(C)
    a_seq, b_seq = [], []
    t = s = 0
    for _ in range(n):
        for _ in range(n - 1):
            a_seq.append((t, s))
            s = (s + 1) % n
        a_seq.append((t, s))
        t = (t + 1) % n
    t = s = 0
    for _ in range(n):
        for _ in range(n - 1):
            b_seq.append((t, s))
            t = (t + 1) % n
        b_seq.append((t, s))
        s = (s + 1) % n
    to_grid = lambda seq: tuple(C[t] * n + D[s] for t, s in seq)  # noqa: E731
    return to_grid(a_seq), to_grid(b_seq)


def _verify_grid_rings(rings: list[Ring], n: int) -> None:
    all_edges: set[tuple[int, int]] = set()
    for r in rings:
        assert len(set(r)) == n * n, "grid ring is not Hamiltonian"
        for t in range(len(r)):
            a, b = r[t], r[(t + 1) % len(r)]
            ai, aj = divmod(a, n)
            bi, bj = divmod(b, n)
            assert (ai == bi) != (aj == bj), f"not a grid edge: {a}-{b}"
            e = (a, b) if a < b else (b, a)
            assert e not in all_edges, "grid rings are not edge-disjoint"
            all_edges.add(e)
    expected = n * n * (n - 1)
    assert len(all_edges) == expected, (
        f"grid decomposition covers {len(all_edges)}/{expected} edges"
    )


class UnsupportedGridError(ValueError):
    """No cross-dim Hamiltonian ring decomposition exists for this plane.

    Structured signal (rather than a silent ``None``) so callers must
    explicitly acknowledge — and can log — the fall-back to the
    per-dimension hierarchical schedule, which only drives one dimension's
    links per phase (~half the plane's bandwidth).
    """

    def __init__(self, x: int, y: int, reason: str):
        self.x = x
        self.y = y
        self.reason = reason
        super().__init__(
            f"no grid ring decomposition for K_{x} □ K_{y}: {reason}"
        )


@lru_cache(maxsize=32)
def _grid_ring_decomposition_cached(x: int, y: int) -> tuple[Ring, ...] | None:
    """Cached construction; ``None`` marks an impossible/failed plane so a
    miss (including an exhausted runtime search) is only paid once."""
    if x != y or x < 2:
        return None
    n = x
    if n == 2:  # K_2 [] K_2 is a single 4-cycle
        rings = [(0, 1, 3, 2)]
    elif n % 2 == 1:
        rings = []
        for C, D in zip(walecki_cycles(n), walecki_cycles(n)):
            rings.extend(_helix_pair(C, D))
    else:
        base = _RAINBOW_BASE.get(n)
        if base is None:
            # runtime search for even sizes outside the inlined bases: can
            # take seconds-to-minutes for large n; cached, and a miss just
            # means callers keep the per-dim hierarchical schedule
            log.warning(
                "no inlined rainbow base for K_%d [] K_%d; running the "
                "Hamiltonian-decomposition search (one-time, may be slow)",
                n, n,
            )
            base = _search_rainbow_cycle(n)
        if base is None:
            return None
        rings = []
        cyc = [divmod(v, n) for v in base]
        for _ in range(n - 1):
            rings.append(tuple(i * n + j for i, j in cyc))
            cyc = [(_rot(i, n), _rot(j, n)) for i, j in cyc]
    _verify_grid_rings(rings, n)
    return tuple(rings)


def grid_ring_decomposition(x: int, y: int) -> tuple[Ring, ...]:
    """Edge-disjoint Hamiltonian cycles of the 2D Hamming graph K_x [] K_y.

    Returns ``n-1`` cycles over local node ids ``i * y + j`` (a perfect
    decomposition: every X and Y link of the grid carries exactly one
    ring).  Raises :class:`UnsupportedGridError` when no construction is
    available — non-square (K_x != K_y) planes, or an even size the
    rainbow-cycle search cannot reach — so callers explicitly fall back to
    (and log) the per-dimension hierarchical schedule instead of silently
    degrading.
    """
    rings = _grid_ring_decomposition_cached(x, y)
    if rings is None:
        if x != y:
            reason = "non-square planes have no known decomposition"
        elif x < 2:
            reason = "plane is degenerate (fewer than 2x2 nodes)"
        else:
            reason = "rainbow-cycle search exhausted for this even size"
        raise UnsupportedGridError(x, y, reason)
    return rings


def grid_effective_bandwidth_gbs(topo: NDFullMesh, dims: tuple[int, int]) -> float | None:
    """Per-chip AllReduce bandwidth of the cross-dim 2D multi-ring over the
    plane spanned by ``dims``: each of the R rings injects on one distinct
    link per chip in parallel, so R x the slower dimension's link bandwidth
    (rings alternate between both dims' links, the slower bounds the step).
    ``None`` when no grid decomposition exists for this plane."""
    d0, d1 = (topo.dims[d] for d in dims)
    try:
        rings = grid_ring_decomposition(
            topo.shape[dims[0]], topo.shape[dims[1]]
        )
    except UnsupportedGridError as e:
        log.info("grid bandwidth unavailable for dims %s (%s)", dims, e.reason)
        return None
    return len(rings) * min(d0.gbs_per_peer, d1.gbs_per_peer)
