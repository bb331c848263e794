"""The port's copy of ``core/simulator.py`` held against the reference's by
``==``: ``simulate`` (every backend), ``linearity_curve`` (Fig. 22) and the
Fig. 18/19 comparison models give the same values in both packages."""

import pytest

from _torch_netsim_parity import both, calibrated, measured

MODS = "core.cost_model core.perf_model core.simulator core.topology core.traffic"


@pytest.mark.parametrize("routing", ["shortest", "detour", "borrow"])
def test_simulate_analytic(routing):
    def run(cm, pm, sim, topo, traffic):
        comm = cm.build_comm_model(multi_pod=True, routing=cm.Routing(routing))
        dense = traffic.backend_comparison_workloads()[0]
        out = []
        for w, p in (traffic.moe_2t_workload(),
                     (dense, traffic.ParallelSpec(tp=8, sp=8, pp=1, dp=32, microbatches=4)),
                     (traffic.a2a_divergence_workload(),
                      traffic.ParallelSpec(tp=4, sp=2, pp=2, dp=16, ep=8, microbatches=8))):
            r = sim.simulate(w, p, comm, name="x")
            out.append((r, r.tokens_per_s, r.comm_total_s))
            r = sim.simulate(w, p, pm.AnalyticPerfModel(comm, axis_gbs={"model": 120.0, "data": 40.0}))
            out.append((r, r.tokens_per_s, r.comm_total_s))
        return out
    both(MODS, run)


def test_simulate_netsim(tmp_path, monkeypatch):
    """``simulate`` on the netsim backend for both comparison workloads at a
    spec the planner picks."""
    def run(cm, pm, sim, topo, traffic):
        comm = cm.build_comm_model(multi_pod=False, routing=cm.Routing.DETOUR)
        perf = pm.NetsimPerfModel(comm, topo=topo.ub_mesh_pod(), size_bytes=16e6)
        out = []
        for w in traffic.backend_comparison_workloads():
            p = traffic.ParallelSpec(tp=8, sp=4, pp=2, dp=4, ep=4 if w.n_experts else 1, microbatches=8)
            out.append(sim.simulate(w, p, perf))
        return out
    _, stats = calibrated(MODS, run, tmp_path, monkeypatch)
    assert measured(stats)


@pytest.mark.parametrize("variant", ["intra", "inter"])
def test_comparison_models(variant):
    def run(cm, pm, sim, topo, traffic):
        if variant == "intra":
            return {v: sim.intra_rack_comm_model(v, multi_pod=mp)
                    for v in sim.INTRA_RACK_GBS for mp in (True, False)}
        return {(s, mp): sim.inter_rack_comm_model(s, multi_pod=mp)
                for s in ("Shortest", "Detour", "Borrow", "Clos") for mp in (True, False)}
    both(MODS, run)


def test_linearity_curve():
    """Fig. 22's weak-scaling curve, analytic and with an explicit backend,
    across the SuperPod boundary."""
    def run(cm, pm, sim, topo, traffic):
        w, _ = traffic.moe_2t_workload()
        comm = cm.build_comm_model(multi_pod=True, routing=cm.Routing.BORROW)
        return (sim.linearity_curve(w, 1024, [1, 2, 4, 8, 16, 64]),
                sim.linearity_curve(w, 512, [1, 4, 32], perf=pm.AnalyticPerfModel(comm)))
    out = both(MODS, run)
    assert out[0][1] == 1.0
