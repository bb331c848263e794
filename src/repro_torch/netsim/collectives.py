"""The port's own copy of ``repro/netsim/collectives.py``, held to the original by
``tests/test_torch_netsim.py``; only its imports of the package differ, and one
comment line that named the change request it came from is reworded.

Collective -> flow-DAG compiler (netsim layer 4).

Compiles the planner-side collective schedules into executable DAGs of
``FlowTask``s with explicit dependencies:

* **Multi-Ring AllReduce** (§5.1, Fig. 13) — ``core/multiring.py``'s clique
  decomposition (Walecki cycles for odd n, zig-zag chains for even n) is
  unrolled into 2(n-1) steps per ring, one task per (ring, step, position).
  Each task carries two deps: the data dep (the chunk a node forwards at
  step s is the one it received at step s-1) and the port dep (a node
  serializes its own sends).  Chains are modeled as rings minus the
  wrap-around edge — per-link load matches the schedule exactly, including
  the paper's observation that even-n chains lose endpoint bandwidth.
* **ReduceScatter / AllGather** — the (n-1)-step halves of the same rings.
* **Cross-dim 2D multi-ring** (Fig. 13's joint (X, Y) schedule) —
  ``core/multiring.grid_ring_decomposition``'s Hamiltonian cycles over the
  whole (X, Y) plane, driving both dimensions' links in every step; this is
  what closes the gap between the measured and analytic "model"-axis
  bandwidth that the per-dimension hierarchical schedule leaves open.
* **Hierarchical AllReduce / AllGather** — the cost model's schedule
  (reduce-scatter up the dimension list, allreduce at the top, all-gather
  back down) with phase barriers.
* **All-to-All** (§5.1, Fig. 14) — one independent task per ordered pair;
  the Router's multi-path split supplies the XY/YX partitioning.
* **traffic-table compilation** — maps ``core/traffic.py`` entries
  (TP/SP/EP/PP/DP) onto representative node groups of the concrete
  topology, so a (workload, parallel spec) prices directly on the network.

Ring steps are adjacent-pair transfers and are pinned ``single_path``: the
multi-ring schedule already IS the multipath structure, so re-splitting
them would double-count links.  A2A/P2P tasks use the router's policy.
"""

from __future__ import annotations

import itertools
import logging
import math
from dataclasses import dataclass, field

from ..core.multiring import (
    UnsupportedGridError,
    clique_decomposition,
    grid_ring_decomposition,
)
from ..core.topology import NDFullMesh
from ..core.traffic import ParallelSpec, TrafficTable, WorkloadSpec, analyze_traffic

log = logging.getLogger(__name__)

Ring = tuple[int, ...]


@dataclass(frozen=True)
class FlowTask:
    """One point-to-point message inside a collective schedule — or, when
    ``pairs`` is set, one *aggregate* of symmetric adjacent-pair sends
    (the parallel positions of one multi-ring step): ``size`` is then the
    per-pair byte count and ``src``/``dst`` name the representative first
    pair.  Aggregates execute as a single weighted flow
    (``FluidNetwork.add_aggregate_flow``) unless the run expands them
    (failure injection / parity checks)."""

    tid: int
    src: int
    dst: int
    size: float                       # bytes (per pair, for aggregates)
    deps: tuple[int, ...] = ()
    single_path: bool = False         # ring steps pin their direct link
    tag: str = ""
    pairs: tuple[tuple[int, int], ...] = ()   # () = plain point-to-point

    @property
    def n_flows(self) -> int:
        return len(self.pairs) or 1

    @property
    def total_bytes(self) -> float:
        return self.size * self.n_flows

    def endpoints(self) -> set[int]:
        """All nodes this task touches (aggregate-aware)."""
        if self.pairs:
            return {n for p in self.pairs for n in p}
        return {self.src, self.dst}


@dataclass
class FlowDAG:
    """A dependency DAG of transfers; completion = all tasks done."""

    name: str
    tasks: list[FlowTask] = field(default_factory=list)

    def _add(self, **kw) -> FlowTask:
        t = FlowTask(tid=len(self.tasks), **kw)
        self.tasks.append(t)
        return t

    @property
    def total_bytes(self) -> float:
        return sum(t.total_bytes for t in self.tasks)

    def frontier(self) -> tuple[int, ...]:
        """Tasks no other task depends on (the DAG's exit set)."""
        dep_of = {d for t in self.tasks for d in t.deps}
        return tuple(t.tid for t in self.tasks if t.tid not in dep_of)


# ---------------------------------------------------------------------------
# DAG transforms (mixed-granularity support)
# ---------------------------------------------------------------------------


def remap_dag(dag: FlowDAG, mapping) -> FlowDAG:
    """A copy of ``dag`` with every node id passed through ``mapping`` (a
    dict or a callable); sizes, deps, tags and single-path flags are
    preserved.  Lets a collective compile on a small standalone topology
    (e.g. the chip-level 2D rack mesh, where all the multi-ring / relay-A2A
    conventions already exist) and execute inside a larger one (the
    mixed-granularity coarse mesh, where that rack's chips sit at offset
    node ids)."""
    f = mapping.__getitem__ if isinstance(mapping, dict) else mapping
    out = FlowDAG(name=dag.name)
    for t in dag.tasks:
        out._add(
            src=f(t.src),
            dst=f(t.dst),
            size=t.size,
            deps=t.deps,
            single_path=t.single_path,
            tag=t.tag,
            pairs=tuple((f(u), f(v)) for u, v in t.pairs),
        )
    return out


def splice_dag(dag: FlowDAG, expand) -> FlowDAG:
    """Rewrite a super-node-granularity DAG onto a mixed-granularity mesh.

    ``expand(node)`` returns the member chip ids of a detail super-node
    (or ``None`` for nodes that exist as-is in the target mesh).  Every
    task pair with a detail endpoint is split across the members, each
    carrying ``1/len(members)`` of the pair's bytes — a rack-level send
    becomes its chips' trunk/uplink shares, the same unit conversion
    ``coarse_calibrated_profile`` applies to payloads.  A pair whose BOTH
    endpoints are detail racks pairs members index-to-index (the trunk's
    chip-to-chip lanes, paper Fig. 8-(d)).

    Aggregate ``FlowTask``s require symmetric members (one per-member
    size and one shared rate), so a spliced task splits into one task per
    SYMMETRY CLASS — (member count, src-side detail?, dst-side detail?) —
    all sharing the original task's deps; downstream tasks depend on
    every piece, preserving the ring-step barrier.  The class split
    matters for fidelity: a detail rack's inbound trunk shares (bounded
    by its chips' ejection ports) and outbound shares (bounded by their
    injection caps) can drain at different rates, and lumping them into
    one aggregate would pin the faster class at the slower class's rate
    for the whole step instead of letting it finish early.  The step
    barrier still completes at the slowest class, so under symmetric
    capacities spliced coarse runs stay aligned with pure-coarse ones
    (the pure aggregate also completes at its slowest member)."""
    out = FlowDAG(name=dag.name)
    tid_map: dict[int, tuple[int, ...]] = {}
    for t in dag.tasks:
        deps = tuple(nt for d in t.deps for nt in tid_map[d])
        groups: dict[tuple, list[tuple[int, int]]] = {}
        for (u, v) in (t.pairs or ((t.src, t.dst),)):
            eu, ev = expand(u), expand(v)
            if eu is None and ev is None:
                groups.setdefault((1, False, False), []).append((u, v))
            elif eu is not None and ev is not None:
                if len(eu) != len(ev):
                    raise ValueError(
                        f"detail super-nodes {u} and {v} have mismatched "
                        f"member counts ({len(eu)} vs {len(ev)})"
                    )
                groups.setdefault((len(eu), True, True), []).extend(
                    zip(eu, ev)
                )
            elif eu is not None:
                groups.setdefault((len(eu), True, False), []).extend(
                    (m, v) for m in eu
                )
            else:
                groups.setdefault((len(ev), False, True), []).extend(
                    (u, m) for m in ev
                )
        new_tids = []
        for (div, _su, _sv), pairs in sorted(groups.items()):
            nt = out._add(
                src=pairs[0][0],
                dst=pairs[0][1],
                size=t.size / div,
                deps=deps,
                single_path=t.single_path,
                tag=t.tag,
                pairs=tuple(pairs) if (len(pairs) > 1 or t.pairs) else (),
            )
            new_tids.append(nt.tid)
        tid_map[t.tid] = tuple(new_tids)
    return out


# ---------------------------------------------------------------------------
# clique helpers
# ---------------------------------------------------------------------------


def clique_nodes(
    topo: NDFullMesh, dim: int, fixed: dict[int, int] | None = None
) -> list[int]:
    """Node ids of one clique along ``dim`` (other coords from ``fixed``,
    defaulting to 0)."""
    fixed = dict(fixed or {})
    for i in range(topo.ndim):
        if i != dim:
            fixed.setdefault(i, 0)
    fixed.pop(dim, None)
    return topo.subgroup_nodes(fixed)


# ---------------------------------------------------------------------------
# ring-schedule compilers
# ---------------------------------------------------------------------------


def _ring_steps(
    dag: FlowDAG,
    nodes: list[int],
    rings: list[Ring],
    closed: bool,
    n_steps: int,
    chunk: float,
    deps0: tuple[int, ...],
    tag: str,
) -> None:
    """Unroll ``n_steps`` pipeline steps of every ring, ONE aggregate task
    per (ring, step).

    All positions of one ring step are symmetric — same chunk size, one
    flow per edge-disjoint ring link — so they start together, drain at
    the same max-min rate, and finish together.  The aggregate task
    carries every position's (sender, receiver) pair and depends only on
    the previous step's aggregate, which subsumes the per-position data
    dep (the chunk forwarded at step s arrived at step s-1) and port dep
    (each node serializes its own injections).  This collapses a clique
    collective from O(rings * steps * positions) tasks to
    O(rings * steps) while reproducing the per-position schedule's
    completion times exactly (the parity suite pins aggregate vs expanded
    runs against each other).

    Known coarsening of the DAG itself: under failure injection the run
    expands aggregates into per-pair sends but keeps the per-step barrier
    dep, so a slow rerouted pair stalls its whole ring step instead of
    propagating diagonally as the earlier per-position deps did — a slightly
    pessimistic recovery model (the ``netsim_failure`` benchmark guards
    it stays within sane bounds).
    """
    for r, ring in enumerate(rings):
        m = len(ring)
        prev: tuple[int, ...] = ()      # previous step's aggregate tid
        for s in range(n_steps):
            senders = range(m) if closed else range(m - 1)
            pairs = tuple(
                (nodes[ring[i]], nodes[ring[(i + 1) % m]]) for i in senders
            )
            t = dag._add(
                src=pairs[0][0],
                dst=pairs[0][1],
                size=chunk,
                deps=deps0 if s == 0 else prev,
                single_path=True,
                tag=f"{tag}/r{r}s{s}",
                pairs=pairs,
            )
            prev = (t.tid,)


def _ring_collective(
    topo: NDFullMesh,
    nodes: list[int],
    size_bytes: float,
    n_steps_fn,
    deps0: tuple[int, ...],
    dag: FlowDAG | None,
    tag: str,
) -> FlowDAG:
    dag = dag or FlowDAG(name=tag)
    n = len(nodes)
    if n < 2 or size_bytes <= 0:
        return dag
    rings, closed = clique_decomposition(n, verify=False)
    chunk = size_bytes / (max(1, len(rings)) * n)
    _ring_steps(dag, nodes, rings, closed, n_steps_fn(n), chunk, deps0, tag)
    return dag


def ring_allreduce(
    topo: NDFullMesh,
    nodes: list[int],
    size_bytes: float,
    *,
    deps0: tuple[int, ...] = (),
    dag: FlowDAG | None = None,
    tag: str = "allreduce",
) -> FlowDAG:
    """Multi-ring AllReduce over one clique's ``nodes``: 2(n-1) steps,
    per-ring chunk = size / (rings * n) — wire bytes per chip equal the
    analytic 2(n-1)/n * size."""
    return _ring_collective(
        topo, nodes, size_bytes, lambda n: 2 * (n - 1), deps0, dag, tag
    )


def ring_reduce_scatter(
    topo: NDFullMesh,
    nodes: list[int],
    size_bytes: float,
    *,
    deps0: tuple[int, ...] = (),
    dag: FlowDAG | None = None,
    tag: str = "rs",
) -> FlowDAG:
    """(n-1)-step half of the ring schedule; ``size_bytes`` is the per-node
    input (RS) or gathered output (AG) size, matching the cost model."""
    return _ring_collective(
        topo, nodes, size_bytes, lambda n: n - 1, deps0, dag, tag
    )


ring_all_gather = ring_reduce_scatter      # same wire schedule, reversed data


# ---------------------------------------------------------------------------
# cross-dim 2D multi-ring (rings spanning the (X, Y) plane jointly)
# ---------------------------------------------------------------------------


def grid_plane_nodes(
    topo: NDFullMesh, dims: tuple[int, int], *, base_node: int = 0
) -> list[int]:
    """Node ids of the 2D plane spanned by ``dims`` through ``base_node``,
    ordered so index ``i * shape[dims[1]] + j`` is the grid-local id."""
    base = list(topo.coords(base_node))
    nodes = []
    for i in range(topo.shape[dims[0]]):
        for j in range(topo.shape[dims[1]]):
            c = list(base)
            c[dims[0]] = i
            c[dims[1]] = j
            nodes.append(topo.node_id(c))
    return nodes


def _grid_collective(
    topo: NDFullMesh,
    dims: tuple[int, int],
    size_bytes: float,
    n_steps_fn,
    base_node: int,
    deps0: tuple[int, ...],
    dag: FlowDAG | None,
    tag: str,
) -> FlowDAG | None:
    try:
        rings = grid_ring_decomposition(
            topo.shape[dims[0]], topo.shape[dims[1]]
        )
    except UnsupportedGridError as e:
        log.info(
            "%s: no cross-dim grid rings for dims %s (%s); falling back to "
            "the per-dimension hierarchical schedule",
            tag, dims, e.reason,
        )
        return None
    dag = dag or FlowDAG(name=tag)
    if size_bytes <= 0:
        return dag
    nodes = grid_plane_nodes(topo, dims, base_node=base_node)
    n = len(nodes)
    chunk = size_bytes / (len(rings) * n)
    _ring_steps(dag, nodes, list(rings), True, n_steps_fn(n), chunk, deps0, tag)
    return dag


def grid_allreduce(
    topo: NDFullMesh,
    dims: tuple[int, int],
    size_bytes: float,
    *,
    base_node: int = 0,
    deps0: tuple[int, ...] = (),
    dag: FlowDAG | None = None,
    tag: str = "grid-ar",
) -> FlowDAG | None:
    """Single-phase AllReduce over the WHOLE (dims[0], dims[1]) plane on the
    cross-dim Hamiltonian rings: 2(n-1) steps over n = x*y nodes, every ring
    driving one X or Y link per node per step — both dimensions' links stay
    busy simultaneously, unlike the phase-per-dimension hierarchical
    schedule.  Returns ``None`` when no grid decomposition exists for this
    plane (callers fall back to ``hierarchical_allreduce``)."""
    return _grid_collective(
        topo, dims, size_bytes, lambda n: 2 * (n - 1), base_node, deps0, dag, tag
    )


def grid_all_gather(
    topo: NDFullMesh,
    dims: tuple[int, int],
    size_bytes: float,
    *,
    base_node: int = 0,
    deps0: tuple[int, ...] = (),
    dag: FlowDAG | None = None,
    tag: str = "grid-ag",
) -> FlowDAG | None:
    """(n-1)-step AllGather half of the cross-dim grid ring schedule."""
    return _grid_collective(
        topo, dims, size_bytes, lambda n: n - 1, base_node, deps0, dag, tag
    )


def all_to_all(
    topo: NDFullMesh,
    nodes: list[int],
    per_pair_bytes: float,
    *,
    deps0: tuple[int, ...] = (),
    dag: FlowDAG | None = None,
    tag: str = "a2a",
) -> FlowDAG:
    """Uniform A2A: one independent task per ordered pair; the router's
    policy supplies the Fig. 14 multi-path splitting."""
    dag = dag or FlowDAG(name=tag)
    for src, dst in itertools.permutations(nodes, 2):
        dag._add(src=src, dst=dst, size=per_pair_bytes, deps=deps0, tag=tag)
    return dag


def multipath_all_to_all(
    topo: NDFullMesh,
    nodes: list[int],
    per_pair_bytes: float,
    *,
    deps0: tuple[int, ...] = (),
    dag: FlowDAG | None = None,
    tag: str = "mp-a2a",
) -> FlowDAG:
    """Multi-Path A2A (§5.1, Fig. 14-(a)) with EXPLICIT relay hops.

    Each (src, dst) message whose coordinates differ in k ≥ 2 dimensions is
    split in half over the first and last dimension orders (X-then-Y /
    Y-then-X on a 2D plane), exactly the partitioning
    ``core/alltoall.multipath_a2a_loads`` prices analytically; same-clique
    pairs go direct.  Unlike :func:`all_to_all` — which hands whole
    messages to the router's path policy — every hop here is its own
    ``FlowTask`` chained by a data dep, so relays store-and-forward and the
    many-to-one bursts at relay and destination nodes are visible to the
    fluid model's receiver-egress (incast) caps.  Hops pin ``single_path``:
    the XY/YX split IS the multipath structure, re-splitting would
    double-count links.
    """
    dag = dag or FlowDAG(name=tag)
    for src, dst in itertools.permutations(nodes, 2):
        cs, cd = topo.coords(src), topo.coords(dst)
        diff = [i for i in range(topo.ndim) if cs[i] != cd[i]]
        orders = list(itertools.permutations(diff))
        chosen = [orders[0], orders[-1]] if len(orders) > 1 else orders[:1]
        share = per_pair_bytes / len(chosen)
        for o, order in enumerate(chosen):
            cur = list(cs)
            prev = src
            deps = deps0
            for d in order:
                cur[d] = cd[d]
                nxt = topo.node_id(cur)
                t = dag._add(
                    src=prev,
                    dst=nxt,
                    size=share,
                    deps=deps,
                    single_path=True,
                    tag=f"{tag}/o{o}",
                )
                deps = (t.tid,)
                prev = nxt
    return dag


def moe_dispatch(
    topo: NDFullMesh,
    senders: list[int],
    experts: list[int],
    bytes_per_sender: float,
    *,
    deps0: tuple[int, ...] = (),
    dag: FlowDAG | None = None,
    tag: str = "moe-dispatch",
) -> FlowDAG:
    """MoE token dispatch (Fig. 14-(b)): every sender ships its routed
    token tile, split uniformly, to the expert-owning nodes.  With more
    senders than experts this is a many-to-one burst — the pattern whose
    completion time the fluid model understates unless receiver-egress
    (incast) caps are enabled; combine is the same DAG with the roles
    swapped.  Tasks use the router's multi-path policy like
    :func:`all_to_all`."""
    dag = dag or FlowDAG(name=tag)
    remote = [e for e in experts]
    if not remote:
        return dag
    per_expert = bytes_per_sender / len(remote)
    for src in senders:
        for dst in remote:
            if src == dst:
                continue
            dag._add(src=src, dst=dst, size=per_expert, deps=deps0, tag=tag)
    return dag


def _cliques_of(
    topo: NDFullMesh,
    dim: int,
    dims: tuple[int, ...],
    sub_fixed: dict[int, int],
    dim_coords: dict[int, tuple[int, ...]] | None = None,
) -> list[list[int]]:
    """Every clique of ``dim`` inside the subgroup spanned by ``dims``.

    ``dim_coords`` restricts a dimension to a coordinate subset (a subset
    of a clique is still a clique), so a 16-chip TP group can span the
    full X clique but only 2 of the 8 Y boards.
    """

    def coords_for(d: int) -> tuple[int, ...]:
        if dim_coords and d in dim_coords:
            return tuple(dim_coords[d])
        return tuple(range(topo.shape[d]))

    others = [d for d in dims if d != dim]
    out = []
    for combo in itertools.product(*(coords_for(d) for d in others)):
        fixed = dict(sub_fixed)
        fixed.update(dict(zip(others, combo)))
        clique = clique_nodes(topo, dim, fixed)
        keep = set(coords_for(dim))
        out.append([n for n in clique if topo.coords(n)[dim] in keep])
    return out


def hierarchical_allreduce(
    topo: NDFullMesh,
    dims: tuple[int, ...],
    size_bytes: float,
    *,
    base_node: int = 0,
    dim_coords: dict[int, tuple[int, ...]] | None = None,
    dag: FlowDAG | None = None,
    tag: str = "hier-ar",
) -> FlowDAG:
    """RS up ``dims[:-1]``, AllReduce on ``dims[-1]``, AG back down — the
    cost model's hierarchical schedule on the subgroup of ``dims`` that
    contains ``base_node``, with phase barriers between dims.
    ``dim_coords`` narrows a dimension to a coordinate subset (partial-
    width groups like a 16-chip TP domain inside the 64-chip rack)."""
    dag = dag or FlowDAG(name=tag)
    base = topo.coords(base_node)
    sub_fixed = {i: base[i] for i in range(topo.ndim) if i not in dims}

    def width(d: int) -> int:
        return len(dim_coords[d]) if dim_coords and d in dim_coords else topo.shape[d]

    frontier: tuple[int, ...] = ()
    frac = size_bytes
    for phase, dim in enumerate(dims[:-1]):
        start = len(dag.tasks)
        for nodes in _cliques_of(topo, dim, dims, sub_fixed, dim_coords):
            ring_reduce_scatter(
                topo, nodes, frac, deps0=frontier, dag=dag,
                tag=f"{tag}/rs{phase}",
            )
        frontier = tuple(range(start, len(dag.tasks)))
        frac /= width(dim)
    start = len(dag.tasks)
    for nodes in _cliques_of(topo, dims[-1], dims, sub_fixed, dim_coords):
        ring_allreduce(topo, nodes, frac, deps0=frontier, dag=dag, tag=f"{tag}/ar")
    frontier = tuple(range(start, len(dag.tasks)))
    for phase, dim in enumerate(reversed(dims[:-1])):
        frac *= width(dim)
        start = len(dag.tasks)
        for nodes in _cliques_of(topo, dim, dims, sub_fixed, dim_coords):
            ring_all_gather(
                topo, nodes, frac, deps0=frontier, dag=dag,
                tag=f"{tag}/ag{phase}",
            )
        frontier = tuple(range(start, len(dag.tasks)))
    return dag


def hierarchical_all_gather(
    topo: NDFullMesh,
    dims: tuple[int, ...],
    size_bytes: float,
    *,
    base_node: int = 0,
    dim_coords: dict[int, tuple[int, ...]] | None = None,
    dag: FlowDAG | None = None,
    tag: str = "hier-ag",
) -> FlowDAG:
    """AG fast dim first, growing the gathered tile each phase;
    ``size_bytes`` is the final gathered size per node."""
    dag = dag or FlowDAG(name=tag)
    base = topo.coords(base_node)
    sub_fixed = {i: base[i] for i in range(topo.ndim) if i not in dims}

    def width(d: int) -> int:
        return len(dim_coords[d]) if dim_coords and d in dim_coords else topo.shape[d]

    span = math.prod(width(d) for d in dims)
    frac = size_bytes / span
    frontier: tuple[int, ...] = ()
    for phase, dim in enumerate(dims):
        frac *= width(dim)
        start = len(dag.tasks)
        for nodes in _cliques_of(topo, dim, dims, sub_fixed, dim_coords):
            ring_all_gather(
                topo, nodes, frac, deps0=frontier, dag=dag,
                tag=f"{tag}/ag{phase}",
            )
        frontier = tuple(range(start, len(dag.tasks)))
    return dag


# ---------------------------------------------------------------------------
# traffic-table compilation (core/traffic.py -> DAGs)
# ---------------------------------------------------------------------------


def model_group(topo: NDFullMesh, width: int) -> list[int]:
    """A representative TP/SP group: one X clique widened across Y boards
    until ``width`` chips (the intra-rack high-bandwidth domain)."""
    x = topo.shape[0]
    boards = max(1, min(topo.shape[1] if topo.ndim > 1 else 1, -(-width // x)))
    nodes: list[int] = []
    for y in range(boards):
        nodes.extend(clique_nodes(topo, 0, {1: y} if topo.ndim > 1 else None))
    return nodes[:width]


def compile_traffic_entry(
    topo: NDFullMesh,
    technique: str,
    per_transfer_bytes: float,
    p: ParallelSpec,
) -> FlowDAG:
    """One transfer of one Table-1 technique as a flow DAG on ``topo``."""
    x = topo.shape[0]
    if technique in ("TP", "SP"):
        group = model_group(topo, p.tp * p.sp)
        if len(group) <= x:
            fn = ring_allreduce if technique == "TP" else ring_all_gather
            return fn(topo, group, per_transfer_bytes, tag=technique)
        boards = -(-len(group) // x)
        if topo.ndim > 1 and boards == topo.shape[1]:
            # full (X, Y) plane: cross-dim 2D multi-ring when available
            grid_fn = grid_allreduce if technique == "TP" else grid_all_gather
            dag = grid_fn(topo, (0, 1), per_transfer_bytes, tag=technique)
            if dag is not None:
                return dag
        # partial-width group: full X clique x only the Y boards in use
        coords = {0: tuple(range(x)), 1: tuple(range(boards))}
        fn = (
            hierarchical_allreduce if technique == "TP"
            else hierarchical_all_gather
        )
        return fn(
            topo, (0, 1), per_transfer_bytes, dim_coords=coords, tag=technique
        )
    if technique == "EP":
        group = model_group(topo, min(p.ep * 2, 2 * x))
        per_pair = per_transfer_bytes / max(1, len(group) - 1)
        return all_to_all(topo, group, per_pair, tag="EP")
    if technique == "PP":
        # boundary activations hop to the next rack (first inter-rack dim)
        dag = FlowDAG(name="PP")
        inter = 2 if topo.ndim > 2 else topo.ndim - 1
        peers = clique_nodes(topo, inter)
        peer = peers[1] if len(peers) > 1 else 0
        dag._add(src=0, dst=peer, size=per_transfer_bytes, tag="PP")
        return dag
    if technique == "DP":
        dims = tuple(range(2, topo.ndim)) if topo.ndim > 2 else (topo.ndim - 1,)
        if len(dims) == 2:
            dag = grid_allreduce(topo, dims, per_transfer_bytes, tag="DP")
            if dag is not None:
                return dag
        return hierarchical_allreduce(topo, dims, per_transfer_bytes, tag="DP")
    raise ValueError(f"unknown technique {technique}")


def compile_workload(
    topo: NDFullMesh, w: WorkloadSpec, p: ParallelSpec
) -> dict[str, tuple[FlowDAG, float]]:
    """technique -> (one-transfer DAG, effective transfer count).

    Each technique is compiled once at its largest per-transfer volume; the
    effective count scales the simulated single-transfer time back to the
    technique's total bytes (SP's two size classes fold into one)."""
    table: TrafficTable = analyze_traffic(w, p)
    vols: dict[str, float] = {}
    totals: dict[str, float] = {}
    for e in table.entries:
        vol = e.volume_per_transfer
        if e.technique == "EP":
            vol *= p.ep                # ledger stores the per-peer chunk
        vols[e.technique] = max(vols.get(e.technique, 0.0), vol)
        totals[e.technique] = totals.get(e.technique, 0.0) + (
            e.total_bytes * (p.ep if e.technique == "EP" else 1)
        )
    out: dict[str, tuple[FlowDAG, float]] = {}
    for tech, vol in vols.items():
        out[tech] = (
            compile_traffic_entry(topo, tech, vol, p),
            totals[tech] / vol,
        )
    return out
