"""The port's copy of ``core/codesign.py`` held against the reference's by
``==``: the candidate grid, each candidate's models and bill of materials,
the analytic bounds and cull, the cross-topology batched calibration's
statistics, and the measured Pareto frontier of the co-design test grid
(``tests/test_codesign.py``'s ``_tiny_grid``) at 1024 chips.  Each side
calibrates from nothing into a cache directory of its own."""

import pytest

from _torch_netsim_parity import both, calibrated, counts, measured, outcome

MODS = "core.codesign core.perf_model core.planner core.traffic core.capex runtime.campaign"


def tiny_grid(cd):
    """A 4-candidate slice of the grid, single-pod sized for speed."""
    return cd.enumerate_geometries(x_lanes=(4, 3), y_lanes=(4,), z_lanes=(2,), a_lanes=(2,),
                                   uplinks=(256, 64), arrangements=((4, 4),))


def test_candidate_grid():
    """Every candidate of the default grid: its name, sizes, pod, SuperPod
    and analytic model at two scales, and its bill of materials."""
    def run(cd, pm, planner, traffic, capex, campaign):
        out = []
        for c in cd.enumerate_geometries():
            row = [c, c.name, c.rack_size, c.chips_per_pod]
            for chips in (1024, 8192):
                bom = c.bom(chips)
                row += [c.n_pods(chips), c.superpod(chips).n_pods, c.comm_model(chips),
                        c.comm_model(chips, routing=cd.Routing.SHORTEST),
                        bom.capex(), bom.tco(), bom.network_share()]
            out.append(row)
        return out
    both(MODS, run)


@pytest.mark.parametrize("chips,margin", [(1024, 5.0), (8192, 5.0), (8192, 1.0)])
def test_bounds_and_cull(chips, margin):
    def run(cd, pm, planner, traffic, capex, campaign):
        w = traffic.backend_comparison_workloads()[0]
        cands = cd.enumerate_geometries()
        bounds = cd.geometry_bounds(w, cands, chips, margin=margin)
        survivors, culled, b2 = cd.prefilter_geometries(w, cands, chips, margin=margin)
        ua = [float(i % 3) * 1e-3 for i in range(len(cands))]
        s3, c3, _ = cd.prefilter_geometries(w, cands, chips, margin=margin, unavailability=ua)
        return bounds, [c.name for c in survivors], [c.name for c in culled], b2, \
            [c.name for c in s3], [c.name for c in c3]
    both(MODS, run)


def test_dominance_and_frontier():
    def run(cd, pm, planner, traffic, capex, campaign):
        P = cd.DesignPoint
        pts = [P("a", 1.0, 2.0), P("b", 2.0, 1.0), P("c", 2.0, 2.0), P("d", 1.0, 2.0),
               P("e", 1.0, 2.0, 0.1), P("f", 3.0, 0.5, 0.0, {"x": 1})]
        return ([[x > y for y in pts] for x in pts], [[x < y for y in pts] for x in pts],
                [p.fitness for p in pts], [p.cost_efficiency for p in pts], cd.pareto_frontier(pts),
                cd.pareto_frontier([]))
    both(MODS, run)


def test_measured_frontier_of_the_test_grid(tmp_path, monkeypatch):
    """The co-design sweep over the test grid at 1024 chips, as the
    reference's topology search makes it: availability scores, the cull,
    ``precalibrate_models`` over the survivors' feasible specs (its
    statistics), a plan a survivor on the calibrated backend, the design
    points and their frontier."""
    def run(cd, pm, planner, traffic, capex, campaign):
        w, chips = traffic.backend_comparison_workloads()[0], 1024
        cands = tiny_grid(cd)
        ua = {c.name: campaign.availability_score(c, chips) for c in cands}
        survivors, culled, bounds = cd.prefilter_geometries(
            w, cands, chips, unavailability=[ua[c.name] for c in cands])
        models = [c.perf_model(chips, size_bytes=16e6) for c in survivors]
        specs_by = [[p for p in planner.enumerate_specs(w, chips, rack_size=c.rack_size)
                     if planner.memory_feasible(w, p)] for c in survivors]
        stats = counts(pm.precalibrate_models(models, specs_by))
        points = []
        for c, m in zip(survivors, models):
            best = planner.plan(w, chips, m, rack_size=c.rack_size, top_k=1,
                                prefilter=planner.Prefilter(keep_k=8), precalibrate=False)[0]
            bom = c.bom(chips)
            points.append(cd.DesignPoint(name=c.name, step_time_s=best.iteration_s, tco=bom.tco(),
                                         unavailability=ua[c.name],
                                         meta={"spec": best.spec, "capex": bom.capex()}))
        return ua, [c.name for c in culled], bounds, stats, points, cd.pareto_frontier(points), \
            counts(pm.calibration_stats())
    out, port_stats = calibrated(MODS, run, tmp_path, monkeypatch)
    assert measured(port_stats)
    stats, frontier = out[3], out[5]
    assert stats["deduped"] > 0 and stats["session_keys"] >= stats["sessions"] > 0
    assert frontier


def test_precalibrate_models_sequential_agree(tmp_path, monkeypatch):
    """``precalibrate_models`` with default widths (``None`` spec lists) and
    each model's own ``precalibrate`` on a second model set: their counts
    and the models' resulting ``CommModel``s."""
    def run(cd, pm, planner, traffic, capex, campaign):
        cands = tiny_grid(cd)[:3]
        models = [c.perf_model(1024, size_bytes=16e6) for c in cands]
        batched = counts(pm.precalibrate_models(models, None))
        seq = [counts(c.perf_model(1024, size_bytes=4e6).precalibrate(
            planner.enumerate_specs(traffic.backend_comparison_workloads()[0], 1024)[:20])) for c in cands]
        return batched, seq, [m.comm_model(None) for m in models], outcome(lambda: counts(pm.precalibrate_models([])))
    _, stats = calibrated(MODS, run, tmp_path, monkeypatch)
    assert measured(stats)
