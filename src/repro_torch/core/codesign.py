"""The port's own copy of ``repro/core/codesign.py``, held to the original by
``tests/test_torch_netsim_parity.py`` and against it by
``tests/test_torch_codesign_parity.py``; only its
imports of the package, and the package's name where its docstring
gives it, differ.

Topology co-design: SuperPod geometry candidates, a winner-safe
analytic cull, and capex/perf Pareto dominance (paper §6.4, Fig. 21).

The paper's headline 2.04x cost-efficiency claim is a *co-design* result:
SuperPod geometry (per-dim lane provisioning, rack arrangement, HRS
uplink width) traded against measured collective bandwidth.  This module
supplies the pieces the search in ``benchmarks/topo_search.py`` composes:

* ``GeometryCandidate`` — one parameterized SuperPod geometry, with its
  pod topology, BOM (``core/capex.superpod_bom``), analytic ``CommModel``
  and netsim-calibrated ``NetsimPerfModel`` all derived consistently;
* ``enumerate_geometries`` — the candidate grid;
* ``prefilter_geometries`` — a ``planner.Prefilter``-style cull over
  *geometries*: closed-form capex plus analytic iteration-time bounds
  (``planner.analytic_iteration_arrays``) as numpy batch ops, discarding
  candidates that are Pareto-dominated before any netsim pricing.
  Winner-safe by the same clamp argument as the spec pre-filter: the
  measured backend prices comm at or *below* the analytic bandwidth
  (``CalibrationProfile.apply(clamp=True)``), so the analytic iteration
  is a lower bound ``LB`` on any candidate's measured step time, and
  ``compute + bubble + margin * comm`` an upper bound ``UB`` (margin 5x
  covers the worst observed analytic/netsim divergence, the ~4.2x
  relay-priced A2A).  A candidate is culled only when another candidate's
  UB beats its LB at no greater TCO — then the measured search could
  never put it on the frontier;
* ``DesignPoint`` / ``pareto_frontier`` — the multi-objective dominance
  relation (the NoC-optimisation ``__gt__`` idiom from SNIPPETS): a
  point dominates when it is no worse on every objective and strictly
  better on at least one; the frontier is the undominated set.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Sequence

import numpy as np

from .capex import BOM, superpod_bom
from .cost_model import AxisCost, CommModel, Routing
from .multiring import plan_multiring
from .planner import (
    analytic_iteration_arrays,
    enumerate_specs,
    memory_feasible,
)
from .topology import NDFullMesh, OPTICAL_1KM, SuperPod, ub_mesh_pod
from .traffic import WorkloadSpec

if TYPE_CHECKING:  # pragma: no cover
    from .perf_model import NetsimPerfModel


# ---------------------------------------------------------------------------
# Geometry candidates
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GeometryCandidate:
    """One SuperPod geometry in the co-design grid.

    The intra-rack board/rack shape stays the paper's 8x8 (the NPU and
    board form factors are fixed); the *provisioning* knobs — per-dim UB
    lane allocation, rack arrangement and the pod->HRS uplink width —
    are the search dimensions, exactly the §6.4 trade: thinner lanes and
    uplinks cut the network BOM but shrink the bandwidth the calibrated
    planner can schedule around.
    """

    x_lanes: int = 4
    y_lanes: int = 4
    z_lanes: int = 2
    a_lanes: int = 2
    racks_per_row: int = 4
    rows: int = 4
    uplink_lanes_per_rack: int = 256
    board: int = 8
    boards_per_rack: int = 8

    @property
    def name(self) -> str:
        return (
            f"xy{self.x_lanes}{self.y_lanes}"
            f"-za{self.z_lanes}{self.a_lanes}"
            f"-r{self.racks_per_row}x{self.rows}"
            f"-u{self.uplink_lanes_per_rack}"
        )

    @property
    def rack_size(self) -> int:
        return self.board * self.boards_per_rack

    @property
    def chips_per_pod(self) -> int:
        return self.rack_size * self.racks_per_row * self.rows

    def n_pods(self, chips: int) -> int:
        return max(1, chips // self.chips_per_pod)

    def pod(self) -> NDFullMesh:
        return ub_mesh_pod(
            board=self.board,
            boards_per_rack=self.boards_per_rack,
            racks_per_row=self.racks_per_row,
            rows=self.rows,
            x_lanes=self.x_lanes,
            y_lanes=self.y_lanes,
            z_lanes=self.z_lanes,
            a_lanes=self.a_lanes,
        )

    def superpod(self, chips: int) -> SuperPod:
        return SuperPod(
            pod=self.pod(),
            n_pods=self.n_pods(chips),
            uplink_lanes_per_rack=self.uplink_lanes_per_rack,
        )

    def bom(self, chips: int) -> BOM:
        """Capex/opex BOM — the uplink is *built* at
        ``uplink_lanes_per_rack``, so it is priced fully provisioned (a
        thin uplink is a thin ``uplink_lanes_per_rack``, not an
        accounting discount)."""
        return superpod_bom(self.superpod(chips), name=self.name)

    def comm_model(
        self, chips: int, *, routing: Routing = Routing.DETOUR
    ) -> CommModel:
        """The candidate's analytic cost model — the generalization of
        ``cost_model.build_comm_model`` to arbitrary geometry: multi-ring
        effective bandwidth per axis, and the pod axis at the rack
        uplink's per-chip share (the ``production_mesh_view``
        convention)."""
        topo = self.pod()

        def axis_bw(dims: tuple[int, ...]) -> float:
            if routing == Routing.SHORTEST:
                return sum(topo.dims[d].gbs_per_peer for d in dims)
            return sum(
                plan_multiring(topo, d).effective_bandwidth_gbs()
                for d in dims
            )

        axes = {
            "model": AxisCost(16, axis_bw((0, 1)), 0.5e-6),
            "data": AxisCost(
                16, axis_bw(tuple(range(2, topo.ndim))), 2.0e-6
            ),
        }
        if self.n_pods(chips) > 1:
            uplink_per_chip = (
                self.uplink_lanes_per_rack
                * OPTICAL_1KM.gbps_per_lane
                / self.rack_size
            )
            axes["pod"] = AxisCost(2, uplink_per_chip, 5.0e-6)
        return CommModel(axes=axes, routing=routing)

    def perf_model(
        self,
        chips: int,
        *,
        size_bytes: float = 64e6,
        routing: Routing = Routing.DETOUR,
        **kw,
    ) -> "NetsimPerfModel":
        """The netsim-calibrated backend for this geometry: chip-level
        calibration on the candidate pod, pod-axis calibration on its
        rack-coarsened SuperPod (when multi-pod)."""
        from .perf_model import NetsimPerfModel

        sp = self.superpod(chips)
        return NetsimPerfModel(
            self.comm_model(chips, routing=routing),
            topo=self.pod(),
            size_bytes=size_bytes,
            superpod=sp if sp.n_pods > 1 else None,
            **kw,
        )


def enumerate_geometries(
    *,
    x_lanes: Sequence[int] = (4, 3),
    y_lanes: Sequence[int] = (4, 3),
    z_lanes: Sequence[int] = (2, 1),
    a_lanes: Sequence[int] = (2, 1),
    uplinks: Sequence[int] = (256, 128, 64, 32),
    arrangements: Sequence[tuple[int, int]] = ((4, 4),),
) -> list[GeometryCandidate]:
    """The candidate grid (defaults: 2*2*2*2*4*1 = 64 candidates)."""
    return [
        GeometryCandidate(
            x_lanes=xl,
            y_lanes=yl,
            z_lanes=zl,
            a_lanes=al,
            racks_per_row=rpr,
            rows=rows,
            uplink_lanes_per_rack=u,
        )
        for xl, yl, zl, al, u, (rpr, rows) in itertools.product(
            x_lanes, y_lanes, z_lanes, a_lanes, uplinks, arrangements
        )
    ]


# ---------------------------------------------------------------------------
# Winner-safe analytic cull over geometries
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GeometryBounds:
    """Closed-form per-candidate bounds the cull decides on."""

    candidate: GeometryCandidate
    tco: float                  # exact (capex is closed-form)
    step_lb_s: float            # lower bound on the measured best step
    step_ub_s: float            # upper bound (margin-degraded analytic)
    n_specs: int                # feasible specs priced


def geometry_bounds(
    w: WorkloadSpec,
    candidates: Sequence[GeometryCandidate],
    chips: int,
    *,
    margin: float = 5.0,
    max_tp: int = 64,
    microbatch_options: tuple[int, ...] = (1, 2, 4, 8, 13, 16, 32),
) -> list[GeometryBounds]:
    """Analytic (TCO, step-time LB/UB) per candidate, no netsim work.

    ``LB = min_spec(compute + bubble + analytic_comm)`` — below any
    measured step time because the calibrated backend clamps at the
    analytic bandwidth; ``UB = min_spec(compute + bubble + margin *
    analytic_comm)`` — above the measured time of the spec attaining it
    as long as no bandwidth degrades by more than ``margin`` (the
    ``planner.Prefilter`` soundness argument, applied per geometry)."""
    out = []
    for cand in candidates:
        tco = cand.bom(chips).tco()
        comm = cand.comm_model(chips)
        specs = [
            p
            for p in enumerate_specs(
                w,
                chips,
                rack_size=cand.rack_size,
                max_tp=max_tp,
                microbatch_options=microbatch_options,
            )
            if memory_feasible(w, p)
        ]
        if not specs:
            # unplannable geometry: infinitely slow, cullable by any
            # candidate that can run the workload at all
            out.append(
                GeometryBounds(cand, tco, float("inf"), float("inf"), 0)
            )
            continue
        try:
            compute_s, comm_s, bubble_s = analytic_iteration_arrays(
                w, specs, comm, rack_size=cand.rack_size
            )
        except Exception:
            # unpriceable analytically: keep it, price it in full
            out.append(GeometryBounds(cand, tco, 0.0, float("inf"), len(specs)))
            continue
        lb = float(np.min(compute_s + bubble_s + comm_s))
        ub = float(np.min(compute_s + bubble_s + margin * comm_s))
        out.append(GeometryBounds(cand, tco, lb, ub, len(specs)))
    return out


def prefilter_geometries(
    w: WorkloadSpec,
    candidates: Sequence[GeometryCandidate],
    chips: int,
    *,
    margin: float = 5.0,
    max_tp: int = 64,
    microbatch_options: tuple[int, ...] = (1, 2, 4, 8, 13, 16, 32),
    unavailability: "Sequence[float] | None" = None,
) -> tuple[list[GeometryCandidate], list[GeometryCandidate], list[GeometryBounds]]:
    """Cull Pareto-dominated geometries before netsim pricing.

    Candidate ``i`` is culled iff some ``j`` has ``tco_j <= tco_i`` and
    ``UB_j <= LB_i`` with at least one strict — then whatever the
    measured step times turn out to be, ``j``'s (step, TCO) dominates
    ``i``'s, so ``i`` cannot sit on the measured frontier.  Winner-safe:
    TCO is exact and the step bounds bracket the measurement (see
    :func:`geometry_bounds`).

    ``unavailability`` (aligned with ``candidates``) extends dominance to
    the third Pareto axis: when given, ``j`` must ALSO be no less
    available than ``i`` to cull it — the scores are exact per candidate
    (the same deterministic Monte-Carlo number later attached to the
    ``DesignPoint``), so the cull stays winner-safe on the 3-axis
    frontier.  Returns ``(survivors, culled, bounds)``.
    """
    bounds = geometry_bounds(
        w,
        candidates,
        chips,
        margin=margin,
        max_tp=max_tp,
        microbatch_options=microbatch_options,
    )
    tco = np.array([b.tco for b in bounds])
    lb = np.array([b.step_lb_s for b in bounds])
    ub = np.array([b.step_ub_s for b in bounds])
    # [i, j] True when j proves i off-frontier (diagonal safe: UB >= LB)
    cheaper_eq = tco[None, :] <= tco[:, None]
    faster_eq = ub[None, :] <= lb[:, None]
    strict = (tco[None, :] < tco[:, None]) | (ub[None, :] < lb[:, None])
    dominated = cheaper_eq & faster_eq & strict
    if unavailability is not None:
        if len(unavailability) != len(candidates):
            raise ValueError("unavailability must align with candidates")
        ua = np.array(list(unavailability), dtype=float)
        dominated &= ua[None, :] <= ua[:, None]
    culled_mask = dominated.any(axis=1)
    survivors = [c for c, x in zip(candidates, culled_mask) if not x]
    culled = [c for c, x in zip(candidates, culled_mask) if x]
    return survivors, culled, bounds


# ---------------------------------------------------------------------------
# Pareto dominance (the SNIPPETS NoC-optimisation idiom)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DesignPoint:
    """One evaluated design in objective space (all objectives minimized).

    ``a > b`` reads "a dominates b": no worse on every objective,
    strictly better on at least one — the comparison-operator dominance
    idiom of the NoC-optimisation exemplar.  Equal-fitness points do not
    dominate each other, so exact ties coexist on the frontier."""

    name: str
    step_time_s: float
    tco: float
    # third dominance axis (minimized): 1 - measured availability from the
    # Monte-Carlo campaign (`runtime.campaign.availability_score`).  The
    # default 0.0 keeps two-objective usage byte-identical: equal third
    # components never decide dominance.
    unavailability: float = 0.0
    meta: dict = field(default_factory=dict, compare=False)

    @property
    def fitness(self) -> tuple[float, ...]:
        return (self.step_time_s, self.tco, self.unavailability)

    def __gt__(self, other: "DesignPoint") -> bool:
        s, o = self.fitness, other.fitness
        return all(a <= b for a, b in zip(s, o)) and any(
            a < b for a, b in zip(s, o)
        )

    def __lt__(self, other: "DesignPoint") -> bool:
        return other > self

    @property
    def cost_efficiency(self) -> float:
        """Perf per TCO unit (higher is better), the Fig. 21 metric."""
        return 1.0 / (self.step_time_s * self.tco)


def pareto_frontier(points: Sequence[DesignPoint]) -> list[DesignPoint]:
    """The undominated subset, sorted by step time."""
    front = [p for p in points if not any(q > p for q in points)]
    return sorted(front, key=lambda p: (p.step_time_s, p.tco))
