"""The port's own copy of ``repro/core/cost_model.py``, held to the original by
``tests/test_torch_topology.py``; only its imports of the package, and the
package's name where its docstring gives it, differ.

Topology-aware communication cost model (paper §5.2, step 2).

Alpha-beta costs for every collective the training workloads emit, priced on
the UB-Mesh topology: each logical mesh axis maps to a set of full-mesh
dimensions with a concrete per-chip bandwidth (multi-ring effective BW for
AllReduce-like ops, bottleneck-link BW for All2All), plus per-hop latency.

**Collective-shape awareness** (§2.2 / §5.1): AllReduce-shaped and
All-to-All-shaped traffic stress an nD-FullMesh very differently — MoE
dispatch rides relay hops and many-to-one bursts a ring-calibrated scalar
cannot price.  ``AxisCost`` therefore optionally carries per-shape
effective bandwidths (``shape_gbs``), and every collective method resolves
its own shape before falling back to the scalar ``gbs_per_chip``.  A
``CalibrationProfile`` — effective GB/s keyed by ``(axis, shape)``,
measured by ``repro_torch.netsim``'s ``NetSim.calibrated_profile`` — stamps
those per-shape bandwidths onto a ``CommModel``.

The same model is used by
* the parallelization planner (`core/planner.py`) to rank configs,
* the training-iteration simulator (`core/simulator.py`) for Figs 17/19/20/22,
* the roofline collective refinement in `benchmarks/roofline.py`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from enum import Enum
from typing import Mapping

from .topology import MeshView, NDFullMesh, production_mesh_view, ub_mesh_pod
from .multiring import plan_multiring


class Routing(str, Enum):
    SHORTEST = "shortest"   # single shortest path / single ring
    DETOUR = "detour"       # APR multi-ring / multi-path
    BORROW = "borrow"       # detour + switch-plane bandwidth borrowing


# the collective shapes a CalibrationProfile distinguishes; reduce_scatter
# and all_gather share one wire schedule (the (n-1)-step ring half) so a
# measurement of one prices both
COLLECTIVE_SHAPES = (
    "allreduce",
    "all_gather",
    "reduce_scatter",
    "all_to_all",
    "p2p",
)

# upper bound on the node count of an A2A calibration group: a full-plane
# explicit-relay A2A DAG is ~8k tasks, while the EP footprint convention
# never exceeds two first-dim cliques.  Shared by the netsim measurement
# (``NetSim.a2a_group_cap``) and the calibration-cache width
# canonicalization (``perf_model.NetsimPerfModel._widths``) — one source
# of truth so cache keys always match the group actually measured.
A2A_CALIBRATION_MAX_NODES = 16


@dataclass(frozen=True)
class AxisCost:
    """Communication characteristics of one logical mesh axis.

    ``shape_gbs`` optionally refines the scalar ``gbs_per_chip`` with
    per-collective-shape effective bandwidths (shape ∈ COLLECTIVE_SHAPES);
    ``bw_for(shape)`` resolves shape-first with scalar fallback, so a
    profile-free AxisCost prices exactly as before.
    """

    size: int
    gbs_per_chip: float       # effective per-chip injection bandwidth
    latency_s: float          # per step
    shape_gbs: tuple[tuple[str, float], ...] = ()   # ((shape, GB/s), ...)

    def __post_init__(self) -> None:
        if isinstance(self.shape_gbs, Mapping):   # accept dicts for ergonomics
            object.__setattr__(
                self, "shape_gbs", tuple(sorted(self.shape_gbs.items()))
            )

    def bw_for(self, shape: str) -> float:
        """Effective GB/s for ``shape``, falling back to the scalar."""
        for s, gbs in self.shape_gbs:
            if s == shape:
                return gbs
        return self.gbs_per_chip

    def has_shape(self, shape: str) -> bool:
        return any(s == shape for s, _ in self.shape_gbs)


@dataclass(frozen=True)
class CommModel:
    """Cost model over named logical axes.

    A ``CommModel`` is itself the closed-form (analytic) backend of the
    ``core.perf_model.PerfModel`` protocol: ``comm_model()`` returns the
    model unchanged for every candidate spec.  The netsim-calibrated
    backend lives in ``core/perf_model.py``.
    """

    axes: dict[str, AxisCost]
    routing: Routing = Routing.DETOUR

    # ---- PerfModel protocol ----------------------------------------------
    @property
    def backend(self) -> str:
        return "analytic"

    def comm_model(self, p=None) -> "CommModel":
        """Resolve to a concrete cost model for spec ``p`` (spec-invariant
        for the analytic backend)."""
        return self

    def override_axis(self, name: str, cost: AxisCost) -> "CommModel":
        """A copy with one axis replaced (added if absent)."""
        axes = dict(self.axes)
        axes[name] = cost
        return CommModel(axes=axes, routing=self.routing)

    # ---- primitive collectives (per-chip completion time, seconds) -------
    def allreduce(self, axis: str, size_bytes: float) -> float:
        a = self.axes[axis]
        if a.size <= 1 or size_bytes <= 0:
            return 0.0
        wire = 2.0 * (a.size - 1) / a.size * size_bytes
        steps = 2 * (a.size - 1)
        return wire / (a.bw_for("allreduce") * 1e9) + steps * a.latency_s

    def reduce_scatter(self, axis: str, size_bytes: float) -> float:
        a = self.axes[axis]
        if a.size <= 1 or size_bytes <= 0:
            return 0.0
        wire = (a.size - 1) / a.size * size_bytes
        return wire / (a.bw_for("reduce_scatter") * 1e9) + (a.size - 1) * a.latency_s

    def all_gather(self, axis: str, size_bytes: float) -> float:
        a = self.axes[axis]
        if a.size <= 1 or size_bytes <= 0:
            return 0.0
        wire = (a.size - 1) / a.size * size_bytes
        return wire / (a.bw_for("all_gather") * 1e9) + (a.size - 1) * a.latency_s

    def all_to_all(self, axis: str, size_bytes: float) -> float:
        """Per-chip A2A of ``size_bytes`` total payload per chip."""
        a = self.axes[axis]
        if a.size <= 1 or size_bytes <= 0:
            return 0.0
        wire = (a.size - 1) / a.size * size_bytes
        if a.has_shape("all_to_all"):
            # a measured A2A bandwidth already embodies the routing policy
            # (relay hops, multipath splits, incast serialization)
            bw = a.bw_for("all_to_all")
        else:
            # multi-path A2A recovers full clique bandwidth; single path
            # halves it
            bw = (
                a.gbs_per_chip
                if self.routing != Routing.SHORTEST
                else a.gbs_per_chip / 2
            )
        return wire / (bw * 1e9) + a.latency_s * 2

    def p2p(self, axis: str, size_bytes: float) -> float:
        a = self.axes[axis]
        if size_bytes <= 0:
            return 0.0
        return size_bytes / (a.bw_for("p2p") * 1e9) + a.latency_s

    # ---- hierarchical collectives ----------------------------------------
    def hierarchical_allreduce(
        self, axes: list[str], size_bytes: float
    ) -> float:
        """Reduce-scatter up the hierarchy, all-reduce at the top, gather
        back down — the Multi-Ring schedule across tiers (fast axes first).
        """
        if not axes:
            return 0.0
        if len(axes) == 1:
            return self.allreduce(axes[0], size_bytes)
        t = 0.0
        frac = size_bytes
        # scatter down fast->slow
        for ax in axes[:-1]:
            t += self.reduce_scatter(ax, frac)
            frac /= self.axes[ax].size
        t += self.allreduce(axes[-1], frac)
        for ax in reversed(axes[:-1]):
            frac *= self.axes[ax].size
            t += self.all_gather(ax, frac)
        return t


@dataclass(frozen=True)
class CalibrationProfile:
    """Measured effective bandwidths keyed by ``(axis, collective shape)``.

    Produced by executing each shape's flow DAG on the flow-level simulator
    (``NetSim.calibrated_profile``), in the per-chip GB/s units ``CommModel``
    carries: plugging ``gbs[(axis, shape)]`` into the matching closed-form
    collective formula reproduces the measured completion time.  Because
    A2A rides relay hops and incast-capped receivers while AllReduce rides
    edge-disjoint rings, ``gbs[(ax, "all_to_all")] < gbs[(ax, "allreduce")]``
    on any multi-dimension axis — the whole point of shape-aware pricing.
    """

    gbs: dict[tuple[str, str], float] = field(default_factory=dict)

    def get(self, axis: str, shape: str, default: float | None = None):
        return self.gbs.get((axis, shape), default)

    def axis_shapes(self, axis: str) -> dict[str, float]:
        """shape -> GB/s of every measurement for ``axis``."""
        return {s: g for (a, s), g in sorted(self.gbs.items()) if a == axis}

    def merged(self, other: "CalibrationProfile") -> "CalibrationProfile":
        return CalibrationProfile(gbs={**self.gbs, **other.gbs})

    def apply(self, comm: CommModel, *, clamp: bool = True) -> CommModel:
        """Stamp the profile onto ``comm``: each measured axis gains
        per-shape bandwidths, and its scalar ``gbs_per_chip`` drops to the
        AllReduce measurement (so shape-unaware consumers see the same
        number the scalar calibration used to produce).  ``clamp`` keeps
        every measured bandwidth at or below the analytic value — a flow-
        level measurement can only tighten the closed-form bound."""
        axes = {}
        for name, a in comm.axes.items():
            shapes = self.axis_shapes(name)
            if not shapes:
                axes[name] = a
                continue
            if clamp:
                shapes = {s: min(g, a.gbs_per_chip) for s, g in shapes.items()}
            scalar = shapes.get("allreduce", a.gbs_per_chip)
            axes[name] = replace(
                a, gbs_per_chip=scalar, shape_gbs=tuple(sorted(shapes.items()))
            )
        return CommModel(axes=axes, routing=comm.routing)


# the collective shapes a LatencyProfile distinguishes: the decode-serving
# per-token ops (TP allreduce, EP dispatch/combine A2A, PP boundary p2p) —
# latency calibration is for small-message shapes, so the bandwidth-only
# all_gather/reduce_scatter pair stays out
LATENCY_SHAPES = ("allreduce", "all_to_all", "p2p")


def _percentile(sorted_vals: "list[float]", q: float) -> float:
    """Nearest-rank-with-interpolation percentile over a pre-sorted list
    (pure python — deterministic, no numpy dependency in core)."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


@dataclass(frozen=True)
class LatencyStats:
    """Message-level latency measurement of one (axis, shape) collective.

    ``total_s`` is the collective's completion time (the number a
    per-token decode step pays); ``p50_s``/``p99_s``/``mean_s`` summarize
    the distribution of per-message ready-to-delivery latencies *within*
    the run — queueing-inclusive, so an incast-heavy A2A dispatch shows a
    p99 far above its p50 while an uncongested p2p has p50 == p99.
    """

    p50_s: float
    p99_s: float
    mean_s: float
    total_s: float
    n: int = 0

    @staticmethod
    def from_samples(samples: "list[float]", total_s: float) -> "LatencyStats":
        vals = sorted(samples)
        mean = sum(vals) / len(vals) if vals else 0.0
        return LatencyStats(
            p50_s=_percentile(vals, 0.50),
            p99_s=_percentile(vals, 0.99),
            mean_s=mean,
            total_s=total_s,
            n=len(vals),
        )


@dataclass(frozen=True)
class LatencyProfile:
    """Measured message-level latencies keyed by ``(axis, shape)``.

    The latency-side sibling of :class:`CalibrationProfile`: where that
    one carries effective GB/s from fluid (bandwidth) runs, this one
    carries :class:`LatencyStats` from message-level runs
    (``NetSim.measure_latency_profile``) at a decode-sized payload —
    serialization + per-hop propagation + FIFO queueing, phenomena the
    fluid model's single flat ``latency_s`` cannot see.  ``size_bytes``
    records the per-chip payload the profile was measured at.
    """

    lat: dict[tuple[str, str], LatencyStats] = field(default_factory=dict)
    size_bytes: float = 0.0

    def get(self, axis: str, shape: str) -> "LatencyStats | None":
        return self.lat.get((axis, shape))

    def collective_s(
        self, axis: str, shape: str, default: float | None = None
    ) -> "float | None":
        """Completion latency of one ``shape`` collective on ``axis``."""
        st = self.lat.get((axis, shape))
        return st.total_s if st is not None else default

    def axis_shapes(self, axis: str) -> dict[str, LatencyStats]:
        return {s: st for (a, s), st in sorted(self.lat.items()) if a == axis}

    def merged(self, other: "LatencyProfile") -> "LatencyProfile":
        return LatencyProfile(
            lat={**self.lat, **other.lat},
            size_bytes=other.size_bytes or self.size_bytes,
        )


def build_comm_model(
    topo: NDFullMesh | None = None,
    *,
    multi_pod: bool = False,
    routing: Routing = Routing.DETOUR,
    borrow_gbs: float = 50.0,
    inter_rack_lanes: int | None = None,
) -> CommModel:
    """CommModel for the production mesh mapped onto the UB-Mesh pod.

    ``routing`` reproduces the §6.3 strategies:
      * SHORTEST — single-ring / single-path (baseline Fig. 10-(a))
      * DETOUR   — APR multi-ring & multi-path (full direct-link bandwidth)
      * BORROW   — DETOUR + switch-plane bandwidth on the inter-rack axis
    ``inter_rack_lanes`` rescales the Z/A allocation (Fig. 20 sweep).
    """
    topo = topo or ub_mesh_pod()
    if inter_rack_lanes is not None:
        per_peer = max(1, inter_rack_lanes // 8)  # split over 3+3 peers + HRS
        dims = list(topo.dims)
        dims[2] = replace(dims[2], lanes_per_peer=per_peer)
        dims[3] = replace(dims[3], lanes_per_peer=per_peer)
        topo = replace(topo, dims=tuple(dims))
    view = production_mesh_view(topo, multi_pod=multi_pod)

    def axis_bw(axis: str) -> float:
        if axis == "pod":
            return view.axis_gbs["pod"]
        dims = view.axis_dims[axis]
        if routing == Routing.SHORTEST:
            # one ring per dimension only
            bw = sum(
                topo.dims[d].gbs_per_peer for d in dims
            )
        else:
            bw = sum(
                plan_multiring(topo, d).effective_bandwidth_gbs() for d in dims
            )
        if routing == Routing.BORROW and axis == "data":
            bw += borrow_gbs
        return bw

    sizes = {"model": 16, "data": 16}
    lat = view.axis_latency_us
    axes = {
        name: AxisCost(size, axis_bw(name), lat[name] * 1e-6)
        for name, size in sizes.items()
    }
    if multi_pod:
        axes["pod"] = AxisCost(2, view.axis_gbs["pod"], lat["pod"] * 1e-6)
    return CommModel(axes=axes, routing=routing)


def clos_comm_model(*, multi_pod: bool = False, gbs: float = 450.0) -> CommModel:
    """Ideal non-oversubscribed Clos: full symmetric bandwidth everywhere."""
    axes = {
        "model": AxisCost(16, gbs, 2e-6),
        "data": AxisCost(16, gbs, 2e-6),
    }
    if multi_pod:
        axes["pod"] = AxisCost(2, gbs, 3e-6)
    return CommModel(axes=axes, routing=Routing.SHORTEST)
