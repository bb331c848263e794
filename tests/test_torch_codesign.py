"""The reference's ``tests/test_codesign.py`` restated against the port's
``repro_torch.core.codesign``.  ``TestCrossTopologyCalibration``'s three
cases (``test_batched_matches_sequential_bitwise``,
``test_reduced_sweep_same_frontier_and_winners``,
``test_cull_winner_safe_on_measured_sweep``) call
``benchmarks/topo_search.py``, which belongs to the reference's benchmark and
imports ``repro``: they wait for the port's benchmark (ROADMAP).

Topology co-design: Pareto dominance, the winner-safe
analytic geometry cull, cross-topology batched calibration parity, and
the Fig. 21 capex/cost-efficiency goldens.

The contracts under test:

* ``DesignPoint.__gt__`` is a strict partial order (irreflexive,
  antisymmetric) and ``pareto_frontier`` returns exactly the
  undominated set, ties included.
* ``prefilter_geometries`` never culls a candidate that the *measured*
  search would put on the frontier: the analytic step-time bounds
  bracket the netsim-measured best step (LB <= measured <= UB), and at
  the sound default margin the cull is conservative.  At ``margin=1``
  (bounds collapse to the analytic step itself) the machinery provably
  fires.
* ``perf_model.precalibrate_models`` (cross-topology batched
  calibration) produces bit-compatible measurements with each model's
  own sequential ``precalibrate`` while sharing solver sessions, and a
  reduced sweep ranks candidates identically in both modes.
* ``capex.compare_architectures`` stays on the paper's Fig. 21 numbers:
  ~2.04x cost-efficiency, 2.46x CapEx, network share 67% -> 20%.
"""

import os
import tempfile

import pytest

from repro_torch.core import perf_model as pm
from repro_torch.core.capex import (
    clos_bom,
    compare_architectures,
    ub_mesh_bom,
)
from repro_torch.core.codesign import (
    DesignPoint,
    GeometryCandidate,
    enumerate_geometries,
    geometry_bounds,
    pareto_frontier,
    prefilter_geometries,
)
from repro_torch.core.perf_model import (
    precalibrate_models,
    reset_calibration_stats,
)
from repro_torch.core.planner import Prefilter, plan
from repro_torch.core.topology import SuperPod
from repro_torch.core.traffic import backend_comparison_workloads

W_DENSE, _ = backend_comparison_workloads()


def _fresh_calibration():
    pm._CALIBRATION_CACHE.clear()
    pm._DISK_CACHES.clear()
    reset_calibration_stats()


# ---------------------------------------------------------------------------
# Pareto dominance
# ---------------------------------------------------------------------------


class TestDominance:
    def test_strict_partial_order(self):
        a = DesignPoint("a", 1.0, 100.0)
        b = DesignPoint("b", 2.0, 200.0)
        assert a > b and not b > a          # antisymmetry
        assert not a > a and not b > b      # irreflexivity

    def test_equal_fitness_ties_coexist(self):
        a = DesignPoint("a", 1.0, 100.0)
        b = DesignPoint("b", 1.0, 100.0)
        assert not a > b and not b > a
        assert set(p.name for p in pareto_frontier([a, b])) == {"a", "b"}

    def test_partial_improvement_does_not_dominate(self):
        fast_pricey = DesignPoint("fast", 1.0, 200.0)
        slow_cheap = DesignPoint("cheap", 2.0, 100.0)
        assert not fast_pricey > slow_cheap
        assert not slow_cheap > fast_pricey

    def test_hand_built_frontier(self):
        pts = [
            DesignPoint("fast", 1.0, 300.0),
            DesignPoint("mid", 2.0, 200.0),
            DesignPoint("cheap", 3.0, 100.0),
            DesignPoint("dominated", 2.5, 250.0),   # beaten by "mid"
            DesignPoint("worst", 4.0, 400.0),       # beaten by all three
        ]
        front = pareto_frontier(pts)
        assert [p.name for p in front] == ["fast", "mid", "cheap"]

    def test_lt_is_the_mirror(self):
        a = DesignPoint("a", 1.0, 100.0)
        b = DesignPoint("b", 2.0, 200.0)
        assert b < a and not a < b


# ---------------------------------------------------------------------------
# Winner-safe geometry cull
# ---------------------------------------------------------------------------


def _tiny_grid():
    """A 4-candidate slice of the grid, single-pod sized for speed."""
    return enumerate_geometries(
        x_lanes=(4, 3), y_lanes=(4,), z_lanes=(2,), a_lanes=(2,),
        uplinks=(256, 64), arrangements=((4, 4),),
    )


class TestGeometryCull:
    def test_bounds_are_ordered(self):
        for b in geometry_bounds(W_DENSE, _tiny_grid(), 1024):
            assert b.step_lb_s <= b.step_ub_s
            assert b.tco > 0

    def test_margin_default_is_conservative(self):
        cands = _tiny_grid()
        survivors, culled, _ = prefilter_geometries(W_DENSE, cands, 1024)
        assert len(survivors) + len(culled) == len(cands)
        # the paper-default geometry always survives the sound margin
        assert any(c.name == GeometryCandidate().name for c in survivors)

    def test_cull_fires_at_margin_one(self):
        # margin=1 collapses UB onto LB: the cull degenerates to exact
        # analytic dominance and must remove the dominated bulk of the
        # full grid (cost-monotone at equal arrangement)
        cands = enumerate_geometries()
        survivors, culled, _ = prefilter_geometries(
            W_DENSE, cands, 8192, margin=1.0
        )
        assert len(culled) > len(cands) // 2
        assert survivors  # never empties the grid

    def test_cull_never_removes_an_analytic_frontier_member(self):
        # at margin=1 the bounds ARE the analytic objectives, so the
        # survivors must contain the full analytic Pareto frontier
        cands = enumerate_geometries()
        survivors, culled, bounds = prefilter_geometries(
            W_DENSE, cands, 8192, margin=1.0
        )
        pts = {
            b.candidate.name: DesignPoint(b.candidate.name, b.step_lb_s, b.tco)
            for b in bounds
        }
        front = {p.name for p in pareto_frontier(list(pts.values()))}
        assert front <= {c.name for c in survivors}
        assert not front & {c.name for c in culled}

    def test_unplannable_candidate_is_cullable(self):
        bounds = geometry_bounds(
            W_DENSE, [GeometryCandidate()], 1024,
            microbatch_options=(10_000_000,),   # no feasible spec
        )
        assert bounds[0].n_specs == 0
        assert bounds[0].step_lb_s == float("inf")

    def test_bounds_bracket_the_measured_step(self):
        # the soundness contract on a real netsim-measured candidate:
        # LB <= best measured step <= UB at the default margin
        cand = GeometryCandidate()
        chips = 1024
        _fresh_calibration()
        rep = plan(
            W_DENSE, chips, cand.perf_model(chips),
            rack_size=cand.rack_size, top_k=1,
            prefilter=Prefilter(keep_k=8),
        )
        (b,) = geometry_bounds(W_DENSE, [cand], chips)
        assert b.step_lb_s <= rep[0].iteration_s <= b.step_ub_s


# ---------------------------------------------------------------------------
# Fig. 21 goldens (paper §6.4)
# ---------------------------------------------------------------------------


class TestFig21Goldens:
    def test_cost_efficiency_gain(self):
        ce = {r.name: r.cost_efficiency for r in compare_architectures()}
        gain = ce["UB-Mesh(4D-FM+Clos)"] / ce["Clos(x64T)"]
        assert gain == pytest.approx(2.04, rel=0.02)

    def test_capex_gain(self):
        rows = {r.name: r for r in compare_architectures()}
        gain = rows["Clos(x64T)"].capex / rows["UB-Mesh(4D-FM+Clos)"].capex
        assert gain == pytest.approx(2.46, rel=0.02)

    def test_network_share_collapse(self):
        assert clos_bom(8192).network_share() == pytest.approx(0.67, rel=0.02)
        assert ub_mesh_bom(8192).network_share() == pytest.approx(0.20, rel=0.02)

    def test_ce_ordering_matches_fig21(self):
        # UB-Mesh best, Clos worst, both hybrids strictly in between
        ce = {r.name: r.cost_efficiency for r in compare_architectures()}
        ub, clos = ce["UB-Mesh(4D-FM+Clos)"], ce["Clos(x64T)"]
        for hybrid in ("2D-FM+x16Clos", "1D-FM+x16Clos"):
            assert clos < ce[hybrid] < ub


# ---------------------------------------------------------------------------
# Satellite: uplink provisioning in the BOM
# ---------------------------------------------------------------------------


class TestUplinkProvisioning:
    def test_hrs_count_scales_with_provisioning(self):
        sp = SuperPod(n_pods=8)
        full, half = sp.hrs_count(1.0), sp.hrs_count(0.5)
        assert 0 < half < full
        assert half >= full * 0.5 - 1  # ceil granularity, never below

    def test_thin_uplink_candidate_is_cheaper(self):
        thick = GeometryCandidate(uplink_lanes_per_rack=256)
        thin = GeometryCandidate(uplink_lanes_per_rack=32)
        assert thin.bom(8192).capex() < thick.bom(8192).capex()
