"""The port's copy of ``core/perf_model.py`` held against the reference's by
``==``: the analytic backend, and the netsim backend's spec-narrowed
``CommModel``s, calibration and latency profiles, pre-calibration counts,
the rack-coarsened pod axis, the mixed-granularity model axis and degraded
meshes.  Each side measures from nothing into a cache directory of its own
(``_torch_netsim_parity.calibrated``), and each netsim case checks that
the port's side ran its measurements rather than reading them back."""

from dataclasses import replace

import pytest

from _torch_netsim_parity import both, calibrated, counts, measured, outcome

MODS = "core.cost_model core.perf_model core.topology core.traffic"


def _specs(traffic):
    P = traffic.ParallelSpec
    return [P(tp=8, sp=8, pp=1, dp=4), P(tp=4, sp=4, pp=4, dp=1, ep=4), P(tp=2, sp=1, pp=1, dp=32),
            P(tp=8, sp=2, pp=2, dp=2, ep=8), None]


def test_analytic_backend():
    def run(cm, pm, topo, traffic):
        comm = cm.build_comm_model(multi_pod=True, routing=cm.Routing.DETOUR)
        prof = cm.CalibrationProfile({("model", "allreduce"): 150.0, ("data", "all_to_all"): 30.0})
        a = pm.AnalyticPerfModel(comm, axis_gbs={"model": 120.0})
        b = pm.AnalyticPerfModel(comm, profile=prof)
        c = a.override_axis("model", cm.AxisCost(size=4, gbs_per_chip=77.0, latency_s=2e-6))
        return [(m.backend, m.comm_model(p)) for m in (a, b, c) for p in _specs(traffic)]
    both(MODS, run)


@pytest.mark.parametrize("routing", ["shortest", "detour", "borrow"])
@pytest.mark.parametrize("shapes", ["all", "allreduce"])
def test_netsim_comm_models(routing, shapes, tmp_path, monkeypatch):
    """``comm_model(p)`` and ``calibration_profile(p)`` for specs of every
    width, then ``precalibrate`` of the same specs on a fresh instance
    (all memo hits) and an override."""
    def run(cm, pm, topo, traffic):
        comm = cm.build_comm_model(multi_pod=False, routing=cm.Routing(routing))
        kw = {} if shapes == "all" else {"shapes": ("allreduce",)}
        perf = pm.NetsimPerfModel(comm, topo=topo.ub_mesh_pod(), size_bytes=16e6, **kw)
        out = [(perf.backend, perf.comm_model(p), perf.calibration_profile(p)) for p in _specs(traffic)]
        pre = pm.NetsimPerfModel(comm, topo=topo.ub_mesh_pod(), size_bytes=16e6, **kw).precalibrate(
            [p for p in _specs(traffic) if p is not None])
        over = perf.override_axis("data", cm.AxisCost(size=8, gbs_per_chip=50.0, latency_s=1e-6))
        return out, counts(pre), over.comm_model(_specs(traffic)[0]), counts(pm.calibration_stats())
    _, stats = calibrated(MODS, run, tmp_path, monkeypatch)
    assert measured(stats)


def test_latency_profiles(tmp_path, monkeypatch):
    """Message-level latency stats per (axis, shape) at decode payloads, for
    several widths, on the serving rack."""
    def run(cm, pm, topo, traffic):
        perf = pm.NetsimPerfModel(cm.build_comm_model(), topo=topo.ub_mesh_rack())
        P = traffic.ParallelSpec
        return [perf.latency_profile(p, size_bytes=b)
                for p in (P(tp=8, sp=1, pp=1, dp=8), P(tp=4, sp=1, pp=1, dp=16), P(tp=64, sp=1, pp=1, dp=1))
                for b in (64e3, 1e6)]
    _, stats = calibrated(MODS, run, tmp_path, monkeypatch)
    assert measured(stats)


def test_superpod_and_mixed_granularity(tmp_path, monkeypatch):
    """The rack-coarsened "pod" axis of a 4-pod SuperPod, and the model axis
    of a rack embedded at chip level in it (``detail_racks``)."""
    def run(cm, pm, topo, traffic):
        base = cm.build_comm_model(multi_pod=True, routing=cm.Routing.DETOUR)
        base = base.override_axis("pod", replace(base.axes["pod"], size=4))
        sp = topo.SuperPod(pod=topo.ub_mesh_pod(), n_pods=4)
        iso = pm.NetsimPerfModel(base, topo=topo.ub_mesh_pod(), size_bytes=64e6, superpod=sp)
        mix = pm.NetsimPerfModel(base, topo=topo.ub_mesh_pod(), size_bytes=64e6, superpod=sp,
                                 detail_racks=(0,))
        narrow = traffic.ParallelSpec(tp=4, sp=2, pp=1, dp=8)
        return [(m.comm_model(None), m.comm_model(narrow)) for m in (iso, mix)]
    _, stats = calibrated(MODS, run, tmp_path, monkeypatch)
    assert measured(stats)


def test_degraded_mesh(tmp_path, monkeypatch):
    """A mesh with dead links (the campaign's repricing) measures only the
    axes the links hit."""
    def run(cm, pm, topo, traffic):
        comm = cm.build_comm_model(multi_pod=False, routing=cm.Routing.DETOUR)
        perf = pm.NetsimPerfModel(comm, topo=topo.ub_mesh_pod(), size_bytes=4e6)
        deg = replace(perf, failed_links=((0, perf.topo.neighbors(0, 0)[0]),))
        p = traffic.ParallelSpec(tp=8, sp=8, pp=1, dp=4)
        return perf.comm_model(p), deg.comm_model(p), counts(pm.calibration_stats())
    _, stats = calibrated(MODS, run, tmp_path, monkeypatch)
    assert measured(stats)


def test_invalid_configurations():
    def run(cm, pm, topo, traffic):
        base = cm.build_comm_model(multi_pod=True, routing=cm.Routing.DETOUR)
        return [outcome(pm.NetsimPerfModel, base, topo=topo.ub_mesh_pod(), detail_racks=(0,)),
                outcome(pm.NetsimPerfModel, base, topo=topo.ub_mesh_pod(), detail_racks=(0,),
                        failed_links=((0, 1),)),
                outcome(pm.NetsimPerfModel, base, topo=topo.ub_mesh_pod(), shapes=("nope",))]
    out = both(MODS, run)
    assert out[0][0] == "raised"
