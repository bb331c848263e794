"""The port's own copy of ``repro/netsim/flows.py``, held to the original by
``tests/test_torch_netsim_solver.py``; only its imports of the package differ.

Fluid flow model with max-min fair bandwidth sharing (netsim layer 2).

Flows are fluid: each active flow drains at a rate set by progressive-
filling max-min fairness over the *directed* links it traverses (full-mesh
links are full-duplex, so each physical cable contributes one directed link
per direction at the dimension's ``gbs_per_peer``).  Between events the
rates are constant, so the next state change is the earliest flow
completion — the classic flow-level discrete-event scheme (cf. flow-level
validation in Rail-only / RailX).

The link inventory comes straight from ``core/topology.NDFullMesh``: every
``(u, v, dim)`` edge becomes two directed links of capacity
``dims[dim].gbs_per_peer``.  Extra links (e.g. the Borrow strategy's
switch-plane uplinks) can be added on top.

The rate allocator itself lives in ``netsim/solver.py``: the default
``"vectorized"`` numpy water-filling (incremental group CSR, symmetric
flows aggregated by identical constraint multisets) or the original
``"reference"`` pure-Python progressive filling kept as the parity oracle.

**Aggregate flows** (:meth:`FluidNetwork.add_aggregate_flow`): the N
parallel sends of one multi-ring step are symmetric — same size, same
per-link contention — so they are carried as ONE flow whose link set is
the union of the member links and whose ``multiplicity`` counts the
members.  The max-min solver naturally gives such a flow the min fair
share across its links, which under symmetry equals every member's
individual rate — collapsing the dominant collective DAGs from O(N)
flows per step to O(rings) while reproducing the exact completion times.

**Receiver-egress (incast) contention**: fluid max-min over per-link
capacities alone resolves many-to-one bursts instantaneously — N senders on
N distinct full-mesh links all drain at full link rate, so the receiver
absorbs N links' worth of traffic at once.  Real NPUs cannot: the ejection
port into memory is finite, and MoE dispatch/combine or DP gradient bursts
serialize behind it (pause/backpressure).  ``rx_gbs`` models this as one
virtual ingress link per destination node, capacity = the node's ejection
bandwidth, shared by every flow terminating there; the max-min allocator
treats it exactly like a wire.  ``default_rx_gbs`` sizes it at the node's
largest single-dimension clique allocation — wide enough that multi-ring
collectives (≤ one inbound flow per ring per node) keep their full
bandwidth, tight enough that cross-dimension incast serializes.

**Per-dimension IO caps** (``dim_io_gbs``): a dimension whose "links" are
really a non-blocking switch tier (the SuperPod's HRS pod-level Clos,
§3.3.4) is constrained per NODE, not per peer-pair — each rack's uplink
bundle bounds its aggregate injection AND ejection into that tier while
any single pair may burst the full uplink.  ``dim_io_gbs={dim: gbs}``
adds one virtual TX and one virtual RX link per node per capped
dimension, shared by every flow whose path crosses that dimension at that
node.  ``netsim/coarsen.py`` uses this to model the HRS tier of the
rack-coarsened SuperPod.

Invariants maintained (and unit-tested):
* sum of flow rates on a link never exceeds its capacity,
* bytes delivered per flow equals the requested flow size,
* identical scenarios produce identical event traces (determinism).
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field
from typing import Callable, Hashable

from ..core.topology import NDFullMesh
from .events import Event, EventEngine
from .solver import make_solver

DirectedLink = tuple[int, int]          # (u, v), u -> v

_EPS_BYTES = 1e-6                       # "done" threshold
_EPS_RATE = 1e-12

RX_PORT = -1                            # sentinel endpoint of virtual ingress
                                        # links: (RX_PORT, node) caps the
                                        # receiver-egress bandwidth of `node`
IO_TX = -2                              # (IO_TX, dim, node): per-dim injection
IO_RX = -3                              # (IO_RX, dim, node): per-dim ejection


def default_rx_gbs(topo: NDFullMesh) -> float:
    """Default per-node receiver-egress (ejection) bandwidth, GB/s.

    The node's largest single-dimension clique allocation: the UB IO die is
    provisioned so its widest collective domain can sink at full multi-ring
    rate (at most one inbound flow per ring per node — exactly the per-dim
    allocation), while many-to-one bursts that fan in across several
    dimensions at once exceed it and serialize.
    """
    return max(d.gbs_total for d in topo.dims)


@dataclass(slots=True)
class Flow:
    """One fluid flow — a single explicit path, or an aggregate of
    ``multiplicity`` symmetric single-hop members (``links`` then holds one
    directed link per member and ``size``/``remaining``/``rate`` are
    per-member)."""

    fid: int
    path: tuple[int, ...]
    size: float                          # bytes requested (per member)
    remaining: float                     # bytes left to send (per member)
    on_complete: Callable[["Flow"], None] | None = None
    meta: object = None                  # opaque owner handle (Transfer, task)
    rate: float = 0.0                    # bytes/s, set by the allocator
    start_s: float = 0.0
    end_s: float | None = None
    multiplicity: int = 1                # symmetric members carried
    credited: float = 0.0                # bytes already added to link ledger
    links: tuple[DirectedLink, ...] = ()   # wire links (member links if agg)
    constraints: tuple[Hashable, ...] = ()  # links + virtual rx/io links

    def __post_init__(self) -> None:
        self.links = tuple(zip(self.path, self.path[1:]))
        self.constraints = self.links

    @property
    def done(self) -> bool:
        return self.remaining <= _EPS_BYTES

    @property
    def total_bytes(self) -> float:
        return self.size * self.multiplicity


# wire-structure template cache: (capacity, link->dim) per topology.  The
# two dicts are a pure function of the topology (links x per-dim or
# per-link gbs), yet building them walks every directed link (~82k on a
# 1024-chip pod) — which used to dominate FluidNetwork construction and
# thereby the per-key cost of planner calibration (one fresh network per
# measured key).  Keyed weakly on the topology object itself: value-hashed
# frozen ``NDFullMesh`` instances share one template across equal meshes,
# identity-hashed coarse/mixed meshes get one template each.  ``capacity``
# is copied per network (callers mutate it: ``add_link``, failure tests);
# ``_link_dim`` is read-only after construction and shared.
_WIRE_TEMPLATES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _build_wire_structure(
    topo: NDFullMesh,
) -> tuple[dict[DirectedLink, float], dict[DirectedLink, int]]:
    capacity: dict[DirectedLink, float] = {}
    link_dim: dict[DirectedLink, int] = {}
    link_gbs = getattr(topo, "link_gbs", None)
    for u, v, d in topo.links():
        gbs = (
            link_gbs(u, v) if link_gbs is not None
            else topo.dims[d].gbs_per_peer
        ) * 1e9
        capacity[(u, v)] = gbs
        capacity[(v, u)] = gbs
        link_dim[(u, v)] = d
        link_dim[(v, u)] = d
    return capacity, link_dim


def _wire_structure(
    topo: NDFullMesh,
) -> tuple[dict[DirectedLink, float], dict[DirectedLink, int]]:
    try:
        cached = _WIRE_TEMPLATES.get(topo)
    except TypeError:               # unhashable / non-weakrefable topology
        cached = None
    if cached is not None:
        return cached
    out = _build_wire_structure(topo)
    try:
        _WIRE_TEMPLATES[topo] = out
    except TypeError:
        pass
    return out


class FluidNetwork:
    """Directed-capacitated network running fluid flows on an EventEngine."""

    def __init__(
        self,
        topo: NDFullMesh,
        engine: EventEngine | None = None,
        *,
        record_rates: bool = False,
        rx_gbs: float | dict[int, float] | None = None,
        dim_io_gbs: "dict[int, float | dict[int, float]] | None" = None,
        solver: str = "vectorized",
        telemetry: "object | None" = None,
        reuse_wire_template: bool = True,
    ) -> None:
        self.topo = topo
        self.engine = engine or EventEngine()
        # a topology carrying its own ``link_gbs(u, v)`` has heterogeneous
        # per-link capacities (the mixed-granularity coarse meshes: chip
        # links next to rack trunks); a plain NDFullMesh prices every link
        # of a dimension at that dim's gbs_per_peer.  The (capacity,
        # link->dim) pair comes from the per-topology template cache;
        # capacity is copied because this network may mutate it.
        # ``reuse_wire_template=False`` bypasses the cache (the benchmark
        # baseline that prices the pre-cache construction cost).
        if reuse_wire_template:
            cap_template, link_dim = _wire_structure(topo)
        else:
            cap_template, link_dim = _build_wire_structure(topo)
        self.capacity: dict[DirectedLink, float] = dict(cap_template)
        self._link_dim: dict[DirectedLink, int] = link_dim
        # receiver-egress caps, bytes/s per node (empty = unconstrained)
        if rx_gbs is None:
            self.rx_cap: dict[int, float] = {}
        elif isinstance(rx_gbs, dict):
            self.rx_cap = {n: g * 1e9 for n, g in rx_gbs.items()}
        else:
            self.rx_cap = {n: rx_gbs * 1e9 for n in range(topo.num_nodes)}
        # per-dimension per-node IO caps (switched tiers), bytes/s.  A
        # dict-valued entry carries heterogeneous per-node caps (mixed-
        # granularity meshes: each detail chip is bounded by its own
        # uplink share, each coarse rack by the whole uplink); nodes
        # absent from a per-node dict are uncapped on that dimension.
        self.dim_io_cap: dict[int, "float | dict[int, float]"] = {}
        for d, g in (dim_io_gbs or {}).items():
            if isinstance(g, dict):
                self.dim_io_cap[d] = {n: gn * 1e9 for n, gn in g.items()}
            else:
                self.dim_io_cap[d] = g * 1e9
        self.failed: set[DirectedLink] = set()
        self.flows: dict[int, Flow] = {}                 # active flows
        self.completed: dict[int, Flow] = {}
        self._next_fid = 0
        self._last_update = 0.0
        self._completion_ev: Event | None = None
        self._flush_ev: Event | None = None
        self._dirty = False
        self._in_completion = False
        self._flowing: list[Flow] = []                   # rate > 0 after solve
        self._link_bytes: dict[DirectedLink, float] = {}  # credited per link
        self.record_rates = record_rates
        self.rate_log: list[tuple[float, DirectedLink, float, float]] = []
        # opt-in telemetry recorder (netsim/telemetry.Telemetry); every
        # hot-path hook is a single `is not None` check when disabled
        self.telemetry = telemetry
        if telemetry is not None:
            telemetry._attach(self)
        self.solver = make_solver(solver, self)

    # -- topology edits ----------------------------------------------------
    def add_link(self, u: int, v: int, gbs: float, *, duplex: bool = True) -> None:
        """Add an extra directed link (e.g. a switch-plane uplink)."""
        self.capacity[(u, v)] = gbs * 1e9
        if duplex:
            self.capacity[(v, u)] = gbs * 1e9
        self.solver.capacity_changed()

    def fail_link(self, u: int, v: int) -> list[Flow]:
        """Zero both directions of u-v; returns the flows that crossed it."""
        self._advance()
        self.failed |= {(u, v), (v, u)}
        self.solver.capacity_changed()
        hit = [
            f for f in self.flows.values()
            if (u, v) in f.links or (v, u) in f.links
        ]
        self._mark_dirty()
        return hit

    def link_ok(self, u: int, v: int) -> bool:
        return (u, v) in self.capacity and (u, v) not in self.failed

    def effective_capacity(self, link: DirectedLink) -> float:
        return 0.0 if link in self.failed else self.capacity.get(link, 0.0)

    def constraint_capacity(self, key: Hashable) -> float:
        """Capacity (bytes/s) of any constraint key a flow may carry: a
        wire link, a virtual receiver-egress port, or a per-dim IO port."""
        k0 = key[0]
        if k0 == RX_PORT:
            return self.rx_cap[key[1]]
        if k0 == IO_TX or k0 == IO_RX:
            cap = self.dim_io_cap[key[1]]
            if isinstance(cap, dict):
                return cap[key[2]]
            return cap
        return self.effective_capacity(key)

    def _constraints_for(
        self, links: tuple[DirectedLink, ...], dsts: tuple[int, ...]
    ) -> tuple[Hashable, ...]:
        """Wire links + the virtual rx / per-dim IO ports they imply."""
        extra: list[Hashable] = []
        for dst in dsts:
            if dst in self.rx_cap:
                extra.append((RX_PORT, dst))
        if self.dim_io_cap:
            for (u, v) in links:
                d = self._link_dim.get((u, v))
                cap = self.dim_io_cap.get(d) if d is not None else None
                if cap is None:
                    continue
                if isinstance(cap, dict):
                    if u in cap:
                        extra.append((IO_TX, d, u))
                    if v in cap:
                        extra.append((IO_RX, d, v))
                else:
                    extra.append((IO_TX, d, u))
                    extra.append((IO_RX, d, v))
        return links + tuple(extra) if extra else links

    # -- flow lifecycle ----------------------------------------------------
    def add_flow(
        self,
        path: tuple[int, ...],
        size: float,
        on_complete: Callable[[Flow], None] | None = None,
        meta: object = None,
    ) -> Flow:
        fid = self._next_fid
        self._next_fid += 1
        flow = Flow(
            fid=fid,
            path=tuple(path),
            size=float(size),
            remaining=float(size),
            on_complete=on_complete,
            meta=meta,
            start_s=self.engine.now,
        )
        for l in flow.links:
            if l not in self.capacity:
                raise ValueError(f"path {path} uses nonexistent link {l}")
        flow.constraints = self._constraints_for(flow.links, (flow.path[-1],))
        if len(path) < 2 or size <= _EPS_BYTES:
            # degenerate: local copy, completes instantly
            flow.remaining = 0.0
            flow.end_s = self.engine.now
            self.completed[fid] = flow
            if self.telemetry is not None:
                self.telemetry.flow_completed(flow)
            if on_complete:
                on_complete(flow)
            return flow
        self._advance()
        self.flows[fid] = flow
        self.solver.flow_added(flow)
        if self.telemetry is not None:
            self.telemetry.flow_started(flow)
        self._mark_dirty()
        return flow

    def add_aggregate_flow(
        self,
        pairs: tuple[DirectedLink, ...],
        size: float,
        on_complete: Callable[[Flow], None] | None = None,
        meta: object = None,
    ) -> Flow:
        """One weighted flow carrying ``len(pairs)`` symmetric single-hop
        members of ``size`` bytes each (e.g. the parallel sends of one
        multi-ring step).  Every member link constrains the shared rate, so
        the aggregate completes exactly when its slowest member would —
        identical to the member-by-member run whenever the members are
        symmetric, ~N x cheaper to simulate."""
        fid = self._next_fid
        self._next_fid += 1
        flow = Flow(
            fid=fid,
            path=tuple(pairs[0]),
            size=float(size),
            remaining=float(size),
            on_complete=on_complete,
            meta=meta,
            start_s=self.engine.now,
            multiplicity=len(pairs),
        )
        for l in pairs:
            if l not in self.capacity:
                raise ValueError(f"aggregate flow uses nonexistent link {l}")
        flow.links = tuple(pairs)
        flow.constraints = self._constraints_for(
            flow.links, tuple(v for _u, v in pairs)
        )
        if size <= _EPS_BYTES:
            flow.remaining = 0.0
            flow.end_s = self.engine.now
            self.completed[fid] = flow
            if self.telemetry is not None:
                self.telemetry.flow_completed(flow)
            if on_complete:
                on_complete(flow)
            return flow
        self._advance()
        self.flows[fid] = flow
        self.solver.flow_added(flow)
        if self.telemetry is not None:
            self.telemetry.flow_started(flow)
        self._mark_dirty()
        return flow

    def remove_flow(self, flow: Flow) -> float:
        """Withdraw an active flow; returns its un-sent bytes."""
        self._advance()
        if self.flows.pop(flow.fid, None) is not None:
            self._credit(flow)
            self.solver.flow_removed(flow)
            if self.telemetry is not None:
                self.telemetry.flow_withdrawn(flow)
        self._mark_dirty()
        return max(0.0, flow.remaining)

    # -- fluid mechanics ---------------------------------------------------
    def _advance(self) -> None:
        """Accrue bytes sent at current rates since the last state change.

        Only flows the last solve left with a positive rate are walked,
        and the per-link byte ledger is NOT touched here — progress is
        credited lazily per flow on completion/withdrawal (or when the
        ledger is read), so the hot path is one subtraction per flowing
        flow per completion wave.
        """
        now = self.engine.now
        dt = now - self._last_update
        self._last_update = now
        if dt <= 0:
            return
        for f in self._flowing:
            moved = f.rate * dt
            f.remaining = f.remaining - moved if moved < f.remaining else 0.0

    def _credit(self, flow: Flow) -> None:
        """Post a flow's un-credited progress to the per-link byte ledger
        (one entry per wire-link occurrence; aggregate members credit their
        own link)."""
        delta = (flow.size - max(0.0, flow.remaining)) - flow.credited
        if delta <= 0:
            return
        flow.credited += delta
        lb = self._link_bytes
        for l in flow.links:
            lb[l] = lb.get(l, 0.0) + delta

    @property
    def link_bytes(self) -> dict[DirectedLink, float]:
        """Bytes delivered per directed link, including in-flight progress
        (flushes the lazy ledger on access)."""
        self._advance()
        for f in self.flows.values():
            self._credit(f)
        return self._link_bytes

    def _maxmin_rates(self) -> None:
        """Delegate the progressive-filling allocation to the configured
        solver (``netsim/solver.py``); remembers the flowing set so
        ``_advance`` can skip zero-rate flows up front."""
        self._flowing = self.solver.solve()
        if self.telemetry is not None:
            self.telemetry.record_solve(
                self.engine.now,
                self.flows,
                getattr(self.solver, "last_attribution", None),
                self._flowing,
            )
        if self.record_rates:
            used: dict[DirectedLink, float] = {}
            for f in self._flowing:
                for l in f.links:
                    used[l] = used.get(l, 0.0) + f.rate
            for l in sorted(used):
                self.rate_log.append(
                    (self.engine.now, l, used[l], self.effective_capacity(l))
                )

    def _mark_dirty(self) -> None:
        """Request a rate recompute; same-timestamp changes batch into one
        zero-delay flush so a 50-flow collective step costs one allocation,
        not fifty."""
        self._dirty = True
        if self._in_completion:
            return  # the completion handler recomputes once at exit
        if self._flush_ev is None:
            self._flush_ev = self.engine.schedule(0.0, self._flush)

    def _flush(self) -> None:
        self._flush_ev = None
        if self._dirty:
            self._recompute()

    def _recompute(self) -> None:
        if self._in_completion:
            self._dirty = True
            return  # batched: the completion handler recomputes once at exit
        self._dirty = False
        self._maxmin_rates()
        if self._completion_ev is not None:
            self._completion_ev.cancel()
            self._completion_ev = None
        ttc = math.inf
        for f in self._flowing:
            t = f.remaining / f.rate
            if t < ttc:
                ttc = t
        if math.isfinite(ttc):
            self._completion_ev = self.engine.schedule(
                max(0.0, ttc), self._on_completion
            )

    def _on_completion(self) -> None:
        self._completion_ev = None
        self._advance()
        done = [f for f in self.flows.values() if f.done]
        self._in_completion = True
        try:
            for f in done:
                del self.flows[f.fid]
                f.remaining = 0.0
                self._credit(f)
                self.solver.flow_removed(f)
                f.end_s = self.engine.now
                self.completed[f.fid] = f
                if self.telemetry is not None:
                    self.telemetry.flow_completed(f)
            for f in done:
                if f.on_complete:
                    f.on_complete(f)
        finally:
            self._in_completion = False
        self._recompute()

    # -- results -----------------------------------------------------------
    def run(self, until: float | None = None) -> float:
        return self.engine.run(until=until)

    def utilization(self, elapsed_s: float | None = None) -> dict[DirectedLink, float]:
        """Per-link mean utilization over ``elapsed_s`` (default: now)."""
        t = elapsed_s if elapsed_s is not None else self.engine.now
        lb = self.link_bytes
        if t <= 0:
            return {l: 0.0 for l in lb}
        return {l: b / (self.capacity[l] * t) for l, b in sorted(lb.items())}

    @property
    def bytes_delivered(self) -> float:
        """Total bytes delivered end-to-end (per-flow, not per-link)."""
        return sum(f.total_bytes for f in self.completed.values())
