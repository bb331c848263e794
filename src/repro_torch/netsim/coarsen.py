"""The port's own copy of ``repro/netsim/coarsen.py``, held to the original by
``tests/test_torch_coarsen.py``; only its imports of the package differ, and one
comment line that named the change request it came from is reworded.

Rack-coarsened SuperPod topologies for multi-pod netsim runs.

A 8192-chip SuperPod is far beyond flow-level simulation at chip
granularity (a single 1024-chip pod already compiles ~60k-task ring DAGs).
The cross-pod questions the planner asks — how fast is a DP AllReduce over
the HRS Clos tier, how much does inter-rack contention cost at multi-pod
scale — do not depend on intra-rack detail, so this module coarsens the
topology the way RailX-style hyper-scale studies do: **racks (or whole
pods) become super-nodes**, with link capacities aggregated from
``core/topology.SuperPod``:

* the inter-rack full-mesh dims (Z, A) keep their clique structure, one
  super-link per rack pair carrying the whole trunk
  (``chips_per_rack x lanes_per_peer`` — exactly the paper's Fig. 8-(d)
  LRS trunk aggregation);
* the pod-level HRS Clos tier becomes one extra "P" dimension.  A
  non-blocking switch tier is NOT a mesh: any single rack pair may burst
  the full ``uplink_lanes_per_rack`` bandwidth, while each rack's
  *aggregate* injection/ejection into the tier is bounded by that same
  uplink.  The coarse mesh therefore gives the P dimension full-uplink
  per-peer capacity plus a per-node IO cap (``FluidNetwork.dim_io_gbs``)
  of one uplink per direction.

What coarsening loses, by construction: intra-rack (X, Y) contention and
incast detail — every rack is a perfect fluid source/sink.  Calibrations
of the intra-rack "model" axis must keep running on the chip-level pod
topology; the coarse mesh is for the "data"/"pod" axes
(``core.perf_model.NetsimPerfModel`` composes both automatically when
given a ``superpod=``).

``coarse_calibrated_profile`` converts between chip units and super-node
units: a rack aggregates ``chips_per_node`` chips' payloads (64 DP groups
of S bytes each behave like one allreduce of 64*S at rack granularity),
so it measures with ``per_chip_bytes * chips_per_node`` and divides the
resulting bandwidth back down to per-chip GB/s — the units ``CommModel``
carries.

**Mixed granularity** (``coarsen_superpod(..., detail_racks=(r, ...))``):
pure coarsening's blind spot is intra-rack contention — every rack is a
perfect fluid source/sink, so coarse runs cannot price model-axis
interference from cross-pod traffic.  A :class:`MixedMesh` keeps the
designated racks at chip granularity — real K_x/K_y cliques with
per-chip links — inside an otherwise rack-coarsened SuperPod, splicing
each detail chip's trunk/uplink SHARE onto the coarse Z/A/P dimensions
(a chip carries ``1/chips_per_rack`` of its rack's super-link to every
coarse peer; two detail racks that are peers pair chips index-to-index,
the Fig. 8-(d) trunk lanes).  This is the Rail-only / RailX evaluation
shape: fine-grained intra-domain detail composed with aggregated
inter-domain capacity.  ``mixed_calibrated_profile`` measures the model
axis INSIDE the embedded rack — optionally while a cross-pod DP
background AllReduce crosses the same rack's uplinks
(``background_per_chip_bytes``), which is what finally exposes
ejection-port and trunk sharing between DCN traffic and the TP/SP
domain.  With ``detail_racks=()`` nothing changes: the coarse-only path
is byte-for-byte the first pure-coarse construction (regression-pinned).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..core.cost_model import COLLECTIVE_SHAPES, CalibrationProfile, Routing
from ..core.topology import (
    DimSpec,
    NDFullMesh,
    OPTICAL_1KM,
    SuperPod,
)

COARSEN_LEVELS = ("rack", "pod")


class MixedMesh:
    """A rack-coarsened SuperPod with designated racks at chip granularity.

    Node numbering: coarse super-nodes keep their ids from the pure
    coarse mesh (``coarse``, 0..R-1); each detail rack ``r`` contributes
    ``chips_per_rack`` chip nodes at ``detail_base[r] + local`` (local =
    the standalone 2D rack mesh's row-major id) and its own coarse id is
    left DANGLING — no links touch it, so no flow can route through it
    (``netsim.collectives.splice_dag`` rewrites every coarse-DAG
    reference to the chips).

    Boundary capacities splice each chip onto the coarse dims: a chip
    carries its ``1/chips_per_rack`` share of the rack's super-link to
    every coarse Z/A peer (exactly the chip-level ``lanes_per_peer``, the
    trunk aggregation run backwards) and of the HRS uplink to every P
    peer; the per-chip HRS IO cap is the same uplink share, so the rack's
    aggregate cap is preserved (64 x uplink/64 = uplink).

    Not a Hamming graph — instead of ``core/apr``'s coordinate-based
    enumeration it provides the graph-generic hooks the netsim layers
    dispatch on: ``apr_shortest_paths`` / ``apr_all_paths`` (BFS shortest
    paths + single-relay detours, already loop-free so the Router skips
    TFC admission), ``hop_distance`` (BFS, for failure notification),
    ``link_gbs`` (heterogeneous capacities) and ``node_rx_gbs``
    (chip-level vs rack-level ejection bandwidths for ``rx_gbs="auto"``).
    """

    MAX_ENUM = 24           # shortest-path enumeration cap per (src, dst)

    def __init__(
        self,
        pod: NDFullMesh,
        coarse: NDFullMesh,
        detail_racks: tuple[int, ...],
    ) -> None:
        from .flows import default_rx_gbs  # deferred: no cycle at init

        self.pod = pod
        self.coarse = coarse
        self.rack_topo = NDFullMesh(dims=pod.dims[:2])
        self.chips_per_rack = self.rack_topo.num_nodes
        self.detail_racks = tuple(detail_racks)
        self.detail_base: dict[int, int] = {}
        base = coarse.num_nodes
        for r in self.detail_racks:
            self.detail_base[r] = base
            base += self.chips_per_rack
        self.num_nodes = base
        nc = coarse.ndim
        self.dims = coarse.dims + self.rack_topo.dims
        self._adj: dict[int, dict[int, int]] = {}     # u -> {v: dim}
        self._gbs: dict[tuple[int, int], float] = {}  # directed link -> GB/s
        self._dist_cache: dict[int, dict[int, int]] = {}
        dset = set(self.detail_racks)
        # per-chip share of each coarse dim's super-link: Z/A trunks give
        # back exactly the chip-level lanes_per_peer, the HRS "P" dim the
        # chip's uplink share
        share = {
            i: d.gbs_per_peer / self.chips_per_rack
            for i, d in enumerate(coarse.dims)
        }
        for u, v, d in coarse.links():
            if u not in dset and v not in dset:
                self._add_link(u, v, d, coarse.dims[d].gbs_per_peer)
        for r in self.detail_racks:
            for d in range(nc):
                for peer in coarse.neighbors(r, d):
                    if peer in dset:
                        if peer < r:
                            continue      # added once, from the lower id
                        for k in range(self.chips_per_rack):
                            self._add_link(
                                self.detail_base[r] + k,
                                self.detail_base[peer] + k,
                                d,
                                share[d],
                            )
                    else:
                        for k in range(self.chips_per_rack):
                            self._add_link(
                                self.detail_base[r] + k, peer, d, share[d]
                            )
            b = self.detail_base[r]
            for u, v, d in self.rack_topo.links():
                self._add_link(
                    b + u, b + v, nc + d, self.rack_topo.dims[d].gbs_per_peer
                )
        rack_rx = default_rx_gbs(coarse)
        chip_rx = max(d.gbs_total for d in self.rack_topo.dims)
        self.node_rx_gbs: dict[int, float] = {}
        for n in range(coarse.num_nodes):
            if n not in dset:
                self.node_rx_gbs[n] = rack_rx
        for r in self.detail_racks:
            for k in range(self.chips_per_rack):
                self.node_rx_gbs[self.detail_base[r] + k] = chip_rx

    def _add_link(self, u: int, v: int, dim: int, gbs: float) -> None:
        self._adj.setdefault(u, {})[v] = dim
        self._adj.setdefault(v, {})[u] = dim
        self._gbs[(u, v)] = gbs
        self._gbs[(v, u)] = gbs

    # -- NDFullMesh-facing surface the netsim layers consume ---------------
    @property
    def ndim(self) -> int:
        return len(self.dims)

    def links(self, dim: int | None = None):
        """Iterate (u, v, dim) over every link, u < v."""
        for u in sorted(self._adj):
            for v, d in sorted(self._adj[u].items()):
                if u < v and (dim is None or d == dim):
                    yield u, v, d

    def link_gbs(self, u: int, v: int) -> float:
        return self._gbs[(u, v)]

    def expand(self, node: int) -> tuple[int, ...] | None:
        """Member chip ids of a detail rack's coarse id (None otherwise) —
        the ``splice_dag`` expansion function."""
        b = self.detail_base.get(node)
        if b is None:
            return None
        return tuple(range(b, b + self.chips_per_rack))

    def chips_of(self, rack: int) -> tuple[int, ...]:
        chips = self.expand(rack)
        if chips is None:
            raise KeyError(f"rack {rack} is not a detail rack")
        return chips

    # -- graph-generic APR hooks -------------------------------------------
    def _dists(self, src: int) -> dict[int, int]:
        d = self._dist_cache.get(src)
        if d is None:
            d = {src: 0}
            frontier = [src]
            while frontier:
                nxt = []
                for u in frontier:
                    for v in self._adj.get(u, ()):
                        if v not in d:
                            d[v] = d[u] + 1
                            nxt.append(v)
                frontier = nxt
            self._dist_cache[src] = d
        return d

    def hop_distance(self, u: int, v: int) -> int:
        dist = self._dists(u).get(v)
        if dist is None:
            raise ValueError(f"{u} and {v} are disconnected")
        return dist

    def _hop_order(self, u: int) -> list[int]:
        """Neighbor iteration order: detail chips BEFORE coarse super-
        nodes.  Ties in path length between two embedded chips exist
        through ANY adjacent coarse peer (it neighbors all 64 chips),
        but those relays ride 1/chips_per_rack trunk shares that also
        carry real cross-pod traffic — the intra-rack clique links are
        both the faithful route and ~5x wider, so they must win the
        Router's in-order link-disjoint path selection."""
        first_coarse = self.coarse.num_nodes
        return sorted(self._adj.get(u, ()), key=lambda v: (v < first_coarse, v))

    def apr_shortest_paths(self, src: int, dst: int) -> list[tuple[int, ...]]:
        """All shortest src->dst paths (BFS DAG walk), capped at
        ``MAX_ENUM``; deterministic order, chip-relayed paths before
        coarse-relayed ties (see :meth:`_hop_order`)."""
        if src == dst:
            return [(src,)]
        dist = self._dists(dst)
        if src not in dist:
            return []
        paths: list[tuple[int, ...]] = []

        def walk(u: int, acc: list[int]) -> None:
            if len(paths) >= self.MAX_ENUM:
                return
            if u == dst:
                paths.append(tuple(acc))
                return
            du = dist[u]
            for v in self._hop_order(u):
                if dist.get(v, math.inf) == du - 1 and v not in acc:
                    acc.append(v)
                    walk(v, acc)
                    acc.pop()

        walk(src, [src])
        return paths

    def apr_all_paths(self, src: int, dst: int) -> list[tuple[int, ...]]:
        """Shortest paths + single-relay detours (replace one hop u-v by
        u-w-v through a common neighbor w) — the APR all-path set of a
        non-Hamming mesh.  Simple loop-free paths by construction."""
        sp = self.apr_shortest_paths(src, dst)
        out = list(sp)
        seen = set(out)
        for p in sp[:4]:
            for i in range(len(p) - 1):
                u, v = p[i], p[i + 1]
                for w in self._hop_order(u):
                    if w in p or v not in self._adj.get(w, ()):
                        continue
                    cand = p[: i + 1] + (w,) + p[i + 1 :]
                    if cand not in seen:
                        seen.add(cand)
                        out.append(cand)
                if len(out) >= 2 * self.MAX_ENUM:
                    return out
        return out


@dataclass(frozen=True)
class CoarseMesh:
    """A coarsened SuperPod: super-node topology + unit conversions.

    ``axis_dims`` maps the logical calibration axes onto the coarse dims
    (the coarse layout differs from the chip-level pod convention), and
    ``dim_io_gbs`` carries the per-super-node IO caps of the switched
    (HRS) dims — hand both to ``NetSim`` / ``FluidNetwork``.  With
    ``detail_racks`` set, ``topo`` is a :class:`MixedMesh` (those racks
    at chip granularity) and the HRS IO caps become per-node dicts.
    """

    topo: "NDFullMesh | MixedMesh"
    chips_per_node: int
    axis_dims: dict[str, tuple[int, ...]]
    dim_io_gbs: "dict[int, float | dict[int, float]]" = field(
        default_factory=dict
    )
    level: str = "rack"
    detail_racks: tuple[int, ...] = ()

    @property
    def num_chips(self) -> int:
        nodes = getattr(self.topo, "coarse", self.topo)
        return nodes.num_nodes * self.chips_per_node


def coarsen_superpod(
    sp: SuperPod,
    *,
    level: str = "rack",
    detail_racks: "tuple[int, ...] | list[int]" = (),
) -> CoarseMesh:
    """Coarsen ``sp`` to rack- or pod-granularity super-nodes.

    * ``"rack"`` — nodes are racks, dims = the pod's inter-rack dims with
      trunk-aggregated capacities plus the HRS "P" dimension (IO-capped).
    * ``"pod"`` — nodes are whole pods, a single HRS "P" dimension whose
      per-node IO cap is the pod's aggregate uplink.

    ``detail_racks`` (rack-level only) keeps the named racks — ids in the
    coarse numbering, rack 0 = coarse node 0 = (Z=0, A=0, pod 0) — at
    chip granularity inside the coarse mesh (see :class:`MixedMesh`).
    ``detail_racks=()`` reproduces the pure-coarse construction exactly.
    """
    if level not in COARSEN_LEVELS:
        raise ValueError(f"unknown coarsening level {level!r}; pick from {COARSEN_LEVELS}")
    if detail_racks and level != "rack":
        raise ValueError("detail_racks needs rack-level coarsening")
    pod = sp.pod
    uplink_gbs = sp.uplink_lanes_per_rack * OPTICAL_1KM.gbps_per_lane
    if level == "pod":
        pod_uplink = uplink_gbs * sp.racks_per_pod
        topo = NDFullMesh(
            dims=(
                DimSpec("P", sp.n_pods, OPTICAL_1KM, sp.uplink_lanes_per_rack * sp.racks_per_pod),
            )
        )
        return CoarseMesh(
            topo=topo,
            chips_per_node=pod.num_nodes,
            axis_dims={"pod": (0,)},
            dim_io_gbs={0: pod_uplink},
            level=level,
        )
    if pod.ndim <= 2:
        raise ValueError("rack-level coarsening needs a pod with inter-rack dims")
    chips_per_rack = pod.shape[0] * pod.shape[1]
    dims: list[DimSpec] = []
    for d in pod.dims[2:]:
        # one super-link per rack pair = the aggregated trunk of all
        # chips_per_rack point-to-point allocations (Fig. 8-(d))
        dims.append(
            DimSpec(d.name, d.size, d.link, d.lanes_per_peer * chips_per_rack)
        )
    axis_dims: dict[str, tuple[int, ...]] = {
        "data": tuple(range(len(dims)))
    }
    dim_io: dict = {}
    if sp.n_pods > 1:
        hrs_dim = len(dims)
        # non-blocking Clos: full uplink per peer PAIR, one uplink of
        # aggregate IO per rack (the dim_io cap)
        dims.append(DimSpec("P", sp.n_pods, OPTICAL_1KM, sp.uplink_lanes_per_rack))
        axis_dims["pod"] = (hrs_dim,)
        dim_io[hrs_dim] = uplink_gbs
    coarse_topo = NDFullMesh(dims=tuple(dims))
    if not detail_racks:
        return CoarseMesh(
            topo=coarse_topo,
            chips_per_node=chips_per_rack,
            axis_dims=axis_dims,
            dim_io_gbs=dim_io,
            level=level,
        )
    detail = tuple(sorted(set(int(r) for r in detail_racks)))
    for r in detail:
        if not (0 <= r < coarse_topo.num_nodes):
            raise ValueError(
                f"detail rack {r} out of range for the "
                f"{coarse_topo.num_nodes}-rack coarse mesh"
            )
    mm = MixedMesh(pod, coarse_topo, detail)
    mixed_io: dict = {}
    if sp.n_pods > 1:
        hrs_dim = coarse_topo.ndim - 1
        # heterogeneous HRS caps: coarse racks keep the whole uplink, each
        # detail chip is bounded by its own uplink share (their sum equals
        # the rack's cap, so rack-level accounting is preserved)
        caps = {
            r: uplink_gbs
            for r in range(coarse_topo.num_nodes)
            if r not in set(detail)
        }
        for r in detail:
            for c in mm.chips_of(r):
                caps[c] = uplink_gbs / chips_per_rack
        mixed_io[hrs_dim] = caps
    model_dims = (coarse_topo.ndim, coarse_topo.ndim + 1)
    return CoarseMesh(
        topo=mm,
        chips_per_node=chips_per_rack,
        axis_dims={**axis_dims, "model": model_dims},
        dim_io_gbs=mixed_io,
        level=level,
        detail_racks=detail,
    )


def coarse_netsim(
    cm: CoarseMesh,
    *,
    routing: Routing = Routing.DETOUR,
    latency_s: float = 5e-6,
    rx_gbs: "float | str | None" = "auto",
    solver: str = "vectorized",
    telemetry: bool = False,
    **kw,
):
    """A ``NetSim`` over the coarse topology with the coarse axis layout
    and the HRS IO caps pre-wired.  ``telemetry=True`` records link
    timelines / bottleneck attribution exactly as on chip-level meshes
    (coarse trunk links show up as one capacity-aggregated link each)."""
    from .api import NetSim  # deferred: avoid import cycle at package init

    return NetSim(
        cm.topo,
        routing=routing,
        latency_s=latency_s,
        rx_gbs=rx_gbs,
        solver=solver,
        telemetry=telemetry,
        axis_dims=cm.axis_dims,
        dim_io_gbs=cm.dim_io_gbs or None,
        **kw,
    )


def coarse_calibrated_profile(
    cm: CoarseMesh,
    per_chip_bytes: float = 64e6,
    *,
    comm=None,
    axis_sizes: dict[str, int] | None = None,
    widths: dict | None = None,
    axes: tuple[str, ...] | None = None,
    shapes: tuple[str, ...] = COLLECTIVE_SHAPES,
    sim=None,
    **netsim_kw,
) -> CalibrationProfile:
    """Per-chip effective GB/s per (axis, shape), measured at super-node
    granularity: payloads are scaled up by ``chips_per_node`` (a rack
    carries its chips' aggregate collective traffic) and the measured
    bandwidth scaled back down to per-chip units."""
    sim = sim or coarse_netsim(cm, **netsim_kw)
    prof = sim.calibrated_profile(
        per_chip_bytes * cm.chips_per_node,
        comm=comm,
        axis_sizes=axis_sizes,
        widths=widths,
        axes=axes,
        shapes=shapes,
    )
    return CalibrationProfile(
        gbs={k: g / cm.chips_per_node for k, g in prof.gbs.items()}
    )


# ---------------------------------------------------------------------------
# mixed granularity: one (or more) chip-level racks inside the coarse mesh
# ---------------------------------------------------------------------------


def mixed_netsim(
    cm: CoarseMesh,
    *,
    routing: Routing = Routing.DETOUR,
    latency_s: float = 5e-6,
    rx_gbs: "float | str | None" = "auto",
    solver: str = "vectorized",
    telemetry: bool = False,
    **kw,
):
    """A ``NetSim`` over a mixed-granularity mesh: heterogeneous per-node
    ejection caps ("auto" rx resolves to the MixedMesh's per-node dict)
    and per-node HRS IO caps pre-wired."""
    if not isinstance(cm.topo, MixedMesh):
        raise TypeError("mixed_netsim needs a coarsening with detail_racks")
    return coarse_netsim(
        cm,
        routing=routing,
        latency_s=latency_s,
        rx_gbs=rx_gbs,
        solver=solver,
        telemetry=telemetry,
        **kw,
    )


def cross_pod_background_dag(
    cm: CoarseMesh,
    per_chip_bytes: float,
    *,
    rack: int | None = None,
    tag: str = "bg-cross-pod-dp",
):
    """Cross-pod DP background traffic: a rack-granularity AllReduce over
    the HRS ("P") clique CONTAINING the detail rack, spliced onto its
    chips — so the background demonstrably crosses the embedded rack's
    uplinks and shares its chips' ejection ports.  ``None`` on a
    single-pod SuperPod (no HRS tier to cross)."""
    from .collectives import clique_nodes, ring_allreduce, splice_dag

    mm = cm.topo
    if not isinstance(mm, MixedMesh):
        raise TypeError("cross_pod_background_dag needs detail_racks")
    rack = cm.detail_racks[0] if rack is None else rack
    pod_dims = cm.axis_dims.get("pod")
    if not pod_dims:
        return None
    hrs = pod_dims[0]
    coords = mm.coarse.coords(rack)
    fixed = {i: coords[i] for i in range(mm.coarse.ndim) if i != hrs}
    nodes = clique_nodes(mm.coarse, hrs, fixed)
    dag = ring_allreduce(
        mm.coarse, nodes, per_chip_bytes * cm.chips_per_node, tag=tag
    )
    return splice_dag(dag, mm.expand)


def mixed_calibrated_profile(
    cm: CoarseMesh,
    per_chip_bytes: float = 64e6,
    *,
    comm=None,
    axis_sizes: dict[str, int] | None = None,
    widths: dict | None = None,
    axes: tuple[str, ...] | None = None,
    shapes: tuple[str, ...] = COLLECTIVE_SHAPES,
    background_per_chip_bytes: float = 0.0,
    detail_rack: int | None = None,
    sim=None,
    **netsim_kw,
) -> CalibrationProfile:
    """Per-chip effective GB/s per (axis, shape) on a MIXED-granularity
    mesh.

    * ``"model"`` — measured INSIDE the embedded chip-level rack (the
      first detail rack, or ``detail_rack``): the DAG is compiled on the
      standalone 2D rack mesh by the standard chip-level conventions
      (cross-dim grid rings for full planes, hierarchical schedules for
      partial widths, the Fig. 14 relay A2A) and remapped onto the
      embedded rack's node ids.  With ``background_per_chip_bytes > 0`` a
      cross-pod DP AllReduce over the rack's HRS clique runs
      CONCURRENTLY on the same network, so the measurement prices the
      model-axis interference from DCN traffic — the ejection-port and
      trunk sharing neither the pure-coarse nor the pure-chip path can
      see.
    * ``"data"`` / ``"pod"`` — compiled at super-node granularity on the
      coarse companion topology (payloads scaled by ``chips_per_node``
      exactly like ``coarse_calibrated_profile``) and SPLICED across the
      granularity boundary, so ring/A2A steps touching a detail rack run
      as its chips' trunk shares.
    """
    from .api import NetSim
    from .collectives import remap_dag, splice_dag

    mm = cm.topo
    if not isinstance(mm, MixedMesh):
        raise TypeError(
            "mixed_calibrated_profile needs a coarsening with detail_racks"
        )
    rack = cm.detail_racks[0] if detail_rack is None else detail_rack
    sim = sim or mixed_netsim(cm, **netsim_kw)
    if axis_sizes is None and comm is not None:
        axis_sizes = {k: a.size for k, a in comm.axes.items()}
    sizes = axis_sizes or {"model": 16, "data": 16}

    # DAG compilers: NetSim instances used only to build calibration DAGs
    # with the canonical width/footprint conventions
    local = NetSim(mm.rack_topo, axis_dims={"model": (0, 1)})
    coarse = NetSim(
        mm.coarse,
        axis_dims={k: v for k, v in cm.axis_dims.items() if k != "model"},
    )
    base = mm.detail_base[rack]
    bg_dag = None
    if background_per_chip_bytes > 0:
        bg_dag = cross_pod_background_dag(
            cm, background_per_chip_bytes, rack=rack
        )
        if bg_dag is None or not bg_dag.tasks:
            # a single-pod SuperPod has no HRS tier to cross: measuring
            # "with background" would silently return the idle numbers
            raise ValueError(
                "background_per_chip_bytes > 0 needs a multi-pod SuperPod "
                "(no cross-pod dimension to run DP background over)"
            )

    axis_dims = dict(cm.axis_dims)
    if axes is not None:
        axis_dims = {k: v for k, v in axis_dims.items() if k in axes}
    gbs: dict[tuple[str, str], float] = {}
    for axis, dims in axis_dims.items():
        n = sizes.get(axis, 16)
        for shape in NetSim._measured_shapes(shapes):
            w = NetSim._width_of(widths, axis, shape)
            tag = f"mixed-cal-{axis}-{shape}"
            if axis == "model":
                dag = local._axis_shape_dag(
                    (0, 1), shape, per_chip_bytes, w, tag
                )
                if dag is not None and dag.tasks:
                    dag = remap_dag(dag, lambda l, b=base: b + l)
            else:
                dag = coarse._axis_shape_dag(
                    dims, shape, per_chip_bytes * cm.chips_per_node, w, tag
                )
                if dag is not None and dag.tasks:
                    dag = splice_dag(dag, mm.expand)
            if dag is None or not dag.tasks:
                continue
            if axis == "model" and bg_dag is not None and bg_dag.tasks:
                t = sim.run_dags([dag, bg_dag])[0].makespan_s
            else:
                t = sim.run_dag(dag).makespan_s
            if t <= 0:
                continue
            # unit conversion: coarse-axis payloads were scaled up by
            # chips_per_node and the bandwidth scales back down by the
            # same factor, so per-chip wire bytes / time works for both
            wire = NetSim._wire_fraction(shape, n) * per_chip_bytes
            gbs[(axis, shape)] = wire / t / 1e9
        NetSim._alias_reduce_scatter(gbs, axis, shapes)
    return CalibrationProfile(gbs=gbs)
