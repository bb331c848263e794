"""The port's copy of ``core/planner.py`` held against the reference's by
``==``: the same workload, chips and backend, built in each package, give
the same ranked ``PlanReport`` (results, bookkeeping, calibration counts),
the same enumerations, memory filter and best spec.  The netsim backend
calibrates on each side from nothing, into a cache directory of its own
(``_torch_netsim_parity.calibrated``)."""

import pytest

from _torch_netsim_parity import both, calibrated, measured, outcome, plan_fields

ROUTINGS = ("shortest", "detour", "borrow")
MODS = "core.cost_model core.perf_model core.planner core.topology core.traffic"


def _perf(cm, pm, topo, routing, backend, multi_pod=False):
    comm = cm.build_comm_model(multi_pod=multi_pod, routing=cm.Routing(routing))
    if backend == "analytic":
        return comm
    return pm.NetsimPerfModel(comm, topo=topo.ub_mesh_pod(), size_bytes=16e6)


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("backend", ["analytic", "netsim"])
@pytest.mark.parametrize("which", [0, 1], ids=["dense-70B", "moe-600B"])
def test_plan_top_k(which, backend, routing, tmp_path, monkeypatch):
    """``plan``'s top five for ``backend_comparison_workloads()`` on
    ``ub_mesh_pod()`` at 256 chips, analytic and netsim, each routing."""
    def run(cm, pm, planner, topo, traffic):
        w = traffic.backend_comparison_workloads()[which]
        return plan_fields(planner.plan(w, 256, _perf(cm, pm, topo, routing, backend), top_k=5))
    out, stats = calibrated(MODS, run, tmp_path, monkeypatch)
    assert len(out["results"]) == 5
    if backend == "netsim":
        assert measured(stats) and out["calibration"]["misses"] > 0


@pytest.mark.parametrize("prefilter", ["default", "none", "narrow"])
def test_plan_prefilter_options(prefilter, tmp_path, monkeypatch):
    """The pre-filter's settings and the search's narrowing options."""
    def run(cm, pm, planner, topo, traffic):
        w = traffic.backend_comparison_workloads()[1]
        perf = _perf(cm, pm, topo, "detour", "netsim")
        kw = {"default": {}, "none": {"prefilter": None},
              "narrow": {"prefilter": planner.Prefilter(keep_k=4, margin=1.5), "max_tp": 8,
                         "microbatch_options": (1, 4, 16), "precalibrate": False}}[prefilter]
        return plan_fields(planner.plan(w, 256, perf, top_k=3, **kw))
    out, stats = calibrated(MODS, run, tmp_path, monkeypatch)
    assert measured(stats) and len(out["results"]) == 3


def test_auto_parallel_search():
    """The search ``--auto-parallel`` runs: 512 chips, two pods, BORROW,
    top three, for a dense and a MoE workload."""
    def run(cm, planner, traffic):
        comm = cm.build_comm_model(multi_pod=True, routing=cm.Routing.BORROW)
        dense = traffic.WorkloadSpec(name="granite-8b", n_layers=36, hidden=4096, n_heads=32,
                                     head_dim=128, seq_len=256, global_batch=256, params_total=8.2e9)
        moe, _ = traffic.moe_2t_workload()
        return [plan_fields(planner.plan(w, 512, comm, top_k=3)) for w in (dense, moe)]
    both("core.cost_model core.planner core.traffic", run)


@pytest.mark.parametrize("chips", [64, 256, 1024])
def test_enumerations_and_memory_filter(chips):
    """``enumerate_specs``, ``enumerate_decode_specs``, ``memory_feasible``
    over every enumerated spec, and the analytic arrays over them."""
    def run(cm, planner, traffic):
        out = []
        for w in traffic.backend_comparison_workloads():
            specs = planner.enumerate_specs(w, chips)
            narrow = planner.enumerate_specs(w, chips, max_tp=8, microbatch_options=(1, 8))
            decode = planner.enumerate_decode_specs(w, chips)
            feas = [planner.memory_feasible(w, p) for p in specs]
            tight = [planner.memory_feasible(w, p, hbm=16e9) for p in specs]
            comm = cm.build_comm_model(multi_pod=False, routing=cm.Routing.DETOUR)
            arrays = planner.analytic_iteration_arrays(w, specs, comm)
            out.append((specs, narrow, decode, feas, tight, arrays))
        return out
    out = both("core.cost_model core.planner core.traffic", run)
    assert all(o[0] for o in out)


def test_best_parallel_spec_and_errors():
    def run(cm, planner, traffic):
        comm = cm.build_comm_model(multi_pod=True, routing=cm.Routing.DETOUR)
        out = [planner.best_parallel_spec(w, chips, comm)
               for w in traffic.backend_comparison_workloads() for chips in (128, 512)]
        tiny = traffic.WorkloadSpec("tiny", 2, 256, 4, 64, 4, seq_len=64, global_batch=1,
                                    params_total=1e15)
        out.append(outcome(planner.best_parallel_spec, tiny, 64, comm))
        out.append(outcome(lambda: plan_fields(planner.plan(tiny, 64, comm))))
        return out
    out = both("core.cost_model core.planner core.traffic", run)
    assert out[-2][0] == "raised"
