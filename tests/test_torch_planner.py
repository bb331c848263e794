"""The reference's ``tests/test_planner.py`` restated against the port's
``repro_torch.core.planner``, ``core.perf_model`` and ``core.simulator``.

Planner + PerfModel backends: memory model, linearity, skip accounting,
and the analytic-vs-netsim backend contract (agree when uncongested,
diverge — documented below — when the model-axis groups are contended)."""

import time

import pytest

from repro_torch.core import planner
from repro_torch.core.cost_model import (
    AxisCost,
    CommModel,
    Routing,
    build_comm_model,
    clos_comm_model,
)
from repro_torch.core.perf_model import (
    AnalyticPerfModel,
    NetsimPerfModel,
    PerfModel,
)
from repro_torch.core.planner import PlanReport, memory_feasible, plan
from repro_torch.core.simulator import linearity_curve, simulate
from repro_torch.core.topology import ub_mesh_pod
from repro_torch.core import traffic as traffic_mod
from repro_torch.core.traffic import ParallelSpec, WorkloadSpec


def _dense(params=8e9, **kw):
    kw.setdefault("seq_len", 512)
    kw.setdefault("global_batch", 16)
    return WorkloadSpec(
        "dense-test", 8, 1024, 8, 128, 8, params_total=params, **kw
    )


class TestMemoryFeasible:
    def test_zero1_optimizer_shards_scale_with_dp(self):
        # params alone fit (2+2 bytes/param = 32 GB < 48), the fp32 ZeRO-1
        # optimizer state (12 bytes/param) only fits once sharded over dp
        w = _dense(params=8e9)
        assert not memory_feasible(w, ParallelSpec(tp=1, sp=1, pp=1, dp=1, microbatches=1))
        assert memory_feasible(w, ParallelSpec(tp=1, sp=1, pp=1, dp=16, microbatches=1))

    def test_dense_branch_tp_pp_shard_params(self):
        w = _dense(params=64e9)
        assert not memory_feasible(w, ParallelSpec(tp=1, sp=1, pp=1, dp=64, microbatches=1))
        assert memory_feasible(w, ParallelSpec(tp=8, sp=1, pp=2, dp=64, microbatches=2))

    def test_moe_branch_ep_shards_expert_params_only(self):
        # 16B params, 80% in experts: dense 3.2B replicated, experts 12.8B
        # sharded over ep — ep=8 fits where ep=1 cannot
        w = _dense(params=16e9)
        w = WorkloadSpec(
            w.name, w.n_layers, w.hidden, w.n_heads, w.head_dim, 8,
            seq_len=512, global_batch=64, params_total=16e9,
            n_experts=8, topk=2, moe_param_frac=0.8,
        )
        infeasible = ParallelSpec(tp=1, sp=1, pp=1, dp=64, ep=1, microbatches=1)
        feasible = ParallelSpec(tp=1, sp=1, pp=1, dp=64, ep=8, microbatches=1)
        assert not memory_feasible(w, infeasible)
        assert memory_feasible(w, feasible)


class _SpyPerf:
    """PerfModel wrapper recording override_axis calls (protocol probe)."""

    def __init__(self, base, log=None):
        self.base = base
        self.overrides = log if log is not None else []

    @property
    def backend(self):
        return self.base.backend

    def comm_model(self, p=None):
        return self.base.comm_model(p)

    def override_axis(self, name, cost):
        self.overrides.append((name, cost))
        return _SpyPerf(self.base.override_axis(name, cost), self.overrides)


class TestLinearityCurve:
    W = WorkloadSpec(
        "lin-test", 48, 8192, 64, 128, 8,
        seq_len=16384, global_batch=64, params_total=7e10,
    )

    def test_weak_scaling_sane_within_pod(self):
        lin = linearity_curve(self.W, 1024, [1, 4])
        assert lin[1] == pytest.approx(1.0)
        # weak scaling inside the pod fabric: near-linear, never a free lunch
        assert 0.90 <= lin[4] <= 1.05

    def test_dcn_penalty_branch_above_8192_chips(self):
        comm = build_comm_model(multi_pod=True, routing=Routing.BORROW)
        spy = _SpyPerf(comm)
        lin = linearity_curve(self.W, 2048, [4, 8], perf=spy)
        # scale 4 (8192 chips) stays on the HRS pod tier; scale 8 (16384)
        # crosses the DCN: the pod axis must be re-pinned at 1/2.5 bandwidth
        pods = [(n, c) for n, c in spy.overrides if n == "pod"]
        assert len(pods) == 1
        _, cost = pods[0]
        assert cost.gbs_per_chip == pytest.approx(
            comm.axes["pod"].gbs_per_chip / 2.5
        )
        assert cost.size == 2
        # and the penalized point scales worse than the in-fabric one
        assert lin[8] < lin[4]


class TestPlanReport:
    W = WorkloadSpec(
        "report-test", 16, 4096, 32, 128, 8,
        seq_len=8192, global_batch=64, params_total=1e10,
    )

    def test_simulate_errors_are_counted_not_swallowed(self, caplog):
        # a cost model without the "data" axis makes PP/DP pricing raise
        # KeyError for every spec that needs it — previously silently eaten
        broken = CommModel(axes={"model": AxisCost(16, 200.0, 1e-6)})
        with caplog.at_level("WARNING", logger="repro_torch.core.planner"):
            rep = plan(self.W, 64, broken)
        assert isinstance(rep, PlanReport)
        assert rep.skipped.get("KeyError", 0) > 0
        assert rep.n_skipped == sum(rep.skipped.values())
        assert any("skipped by simulate errors" in r.message for r in caplog.records)

    def test_healthy_plan_reports_zero_skips(self):
        comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
        rep = plan(self.W, 64, comm)
        assert rep.n_skipped == 0 and rep.skipped == {}
        assert rep.n_enumerated > len(rep)
        # sequence protocol: iteration, len, indexing all work
        assert [r.spec for r in rep][0] == rep[0].spec


class TestPerfModelBackends:
    # the canonical (uncongested -> agree, contended -> diverge) pair,
    # shared with benchmarks/planner_bench.py; the helper's docstring
    # documents WHY the contended MoE config flips the winner (narrow
    # hierarchical model groups measure ~2x below the full-plane 2D
    # multi-ring that the analytic backend prices identically)
    W_CLEAN, W_CONTENDED = traffic_mod.backend_comparison_workloads()

    @pytest.fixture(scope="class")
    def backends(self):
        comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
        return (
            AnalyticPerfModel(comm),
            NetsimPerfModel(comm, topo=ub_mesh_pod(), size_bytes=64e6),
        )

    def test_both_backends_satisfy_protocol(self, backends):
        analytic, netsim = backends
        assert isinstance(analytic, PerfModel)
        assert isinstance(netsim, PerfModel)
        assert isinstance(analytic.comm_model(None), CommModel)
        assert isinstance(netsim.comm_model(None), CommModel)

    def test_backends_agree_on_uncongested_config(self, backends):
        analytic, netsim = backends
        sa = planner.best_parallel_spec(self.W_CLEAN, 256, analytic)
        sn = planner.best_parallel_spec(self.W_CLEAN, 256, netsim)
        assert sa == sn

    def test_backends_diverge_on_contended_config(self, backends):
        analytic, netsim = backends
        sa = planner.best_parallel_spec(self.W_CONTENDED, 256, analytic)
        sn = planner.best_parallel_spec(self.W_CONTENDED, 256, netsim)
        assert sa != sn
        # the netsim winner buys a wider model-axis group (full plane ->
        # cross-dim rings) precisely because narrow groups measure slower
        assert sn.tp * sn.sp >= sa.tp * sa.sp
        # and under the measured bandwidths its own winner really is faster
        t_sa = simulate(self.W_CONTENDED, sa, netsim).iteration_s
        t_sn = simulate(self.W_CONTENDED, sn, netsim).iteration_s
        assert t_sn <= t_sa

    def test_netsim_backend_full_plan_1024_chips_under_60s(self, backends):
        _, netsim = backends
        w = WorkloadSpec(
            "dense-70B-1k", 80, 8192, 64, 128, 8,
            seq_len=8192, global_batch=512, params_total=7e10,
        )
        t0 = time.time()
        rep = plan(w, 1024, netsim)
        elapsed = time.time() - t0
        assert len(rep) > 0
        assert elapsed < 60.0, f"netsim-backed plan took {elapsed:.1f}s"

    def test_calibration_memoized_per_width_not_per_spec(self, backends):
        from repro_torch.core import perf_model as pm

        _, netsim = backends
        plan(self.W_CLEAN, 256, netsim)  # warm
        before = len(pm._CALIBRATION_CACHE)
        plan(self.W_CLEAN, 256, netsim)  # hundreds of specs, zero new keys
        assert len(pm._CALIBRATION_CACHE) == before

    def test_netsim_never_prices_above_analytic(self, backends):
        analytic, netsim = backends
        ca = analytic.comm_model(None)
        cn = netsim.comm_model(None)
        for name, a in cn.axes.items():
            assert a.gbs_per_chip <= ca.axes[name].gbs_per_chip * 1.001


class TestAnalyticPrefilter:
    """Pre-filter: the vectorized analytic cull must never change
    the winner on any bench config (prefilter=None is the proven-equal
    escape hatch), must actually cull, and must fall back to the
    unfiltered path on models it cannot price."""

    def _configs(self):
        moe2t, _ = traffic_mod.moe_2t_workload()
        for w in traffic_mod.backend_comparison_workloads():
            yield w, 1024
            yield w, 4096
        yield traffic_mod.a2a_divergence_workload(), 1024
        yield moe2t, 4096

    @pytest.mark.parametrize("factory,label", [
        (lambda: build_comm_model(multi_pod=True, routing=Routing.DETOUR), "ubmesh"),
        (lambda: clos_comm_model(multi_pod=True), "clos"),
    ])
    def test_winner_preserved_on_every_bench_config(self, factory, label):
        comm = factory()
        for w, chips in self._configs():
            full = plan(w, chips, comm, prefilter=None)
            fast = plan(w, chips, comm)
            assert fast[0].spec == full[0].spec, (label, w.name, chips)
            assert fast[0].iteration_s == pytest.approx(
                full[0].iteration_s, rel=1e-12
            )
            # the filter genuinely culls (these spaces are all 200+ specs)
            assert fast.n_prefiltered > 0, (label, w.name, chips)
            assert full.n_prefiltered == 0

    def test_winner_preserved_on_netsim_backend(self):
        comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
        netsim = NetsimPerfModel(comm, topo=ub_mesh_pod(), size_bytes=16e6)
        w = traffic_mod.a2a_divergence_workload()
        fast = plan(w, 256, netsim)
        full = plan(w, 256, netsim, prefilter=None, precalibrate=False)
        assert fast[0].spec == full[0].spec
        assert fast[0].iteration_s == pytest.approx(
            full[0].iteration_s, rel=1e-12
        )
        assert fast.n_prefiltered > 0

    def test_unpriceable_model_falls_back_to_unfiltered(self):
        # no "data" axis: the prefilter cannot price PP/DP and must get out
        # of the way — same skip accounting as the unfiltered path
        broken = CommModel(axes={"model": AxisCost(16, 200.0, 1e-6)})
        w = TestPlanReport.W
        rep = plan(w, 64, broken)
        assert rep.n_prefiltered == 0
        assert rep.skipped.get("KeyError", 0) > 0

    def test_enumeration_knobs_thread_through(self):
        w = TestPlanReport.W
        comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
        wide = plan(w, 64, comm)
        narrow = plan(w, 64, comm, max_tp=2, microbatch_options=(1,))
        assert narrow.n_enumerated < wide.n_enumerated
        assert all(r.spec.tp <= 2 and r.spec.microbatches == 1 for r in narrow)
        s = planner.best_parallel_spec(
            w, 64, comm, max_tp=2, microbatch_options=(1,)
        )
        assert s.tp <= 2 and s.microbatches == 1


class TestBatchedPrecalibration:
    """Batched calibration: precalibrate() front-loads every key a
    spec set needs, and the relocated concurrent DAGs measure exactly what
    sequential runs measure (the box-disjointness invariant)."""

    def test_precalibrate_covers_plan_keys(self):
        from repro_torch.core import perf_model as pm

        comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
        netsim = NetsimPerfModel(
            comm, topo=ub_mesh_pod(), size_bytes=16e6, cache_dir=None
        )
        w = TestPerfModelBackends.W_CLEAN
        specs = planner.enumerate_specs(w, 256)
        info = netsim.precalibrate(specs)
        assert info["keys"] > 0
        # a subsequent plan over the same space measures nothing new
        before = len(pm._CALIBRATION_CACHE)
        rep = plan(w, 256, netsim, prefilter=None)
        assert len(pm._CALIBRATION_CACHE) == before
        assert rep.calibration["misses"] == 0

    def test_batched_measurement_matches_sequential(self):
        from repro_torch.netsim import NetSim

        comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
        sim = NetSim(ub_mesh_pod(), routing=Routing.DETOUR)
        reqs = [
            ("model", "allreduce", None), ("model", "all_gather", 8),
            ("model", "all_to_all", 4), ("data", "allreduce", None),
            ("data", "p2p", None), ("model", "allreduce", 16),
        ]
        batched = sim.measure_profile_batch(16e6, reqs, comm=comm, batch_size=6)
        sequential = sim.measure_profile_batch(16e6, reqs, comm=comm, batch_size=1)
        for key in reqs:
            assert batched[key] == pytest.approx(sequential[key], rel=1e-9), key

    def test_borrow_routing_disables_batching(self):
        from repro_torch.netsim import NetSim

        sim = NetSim(ub_mesh_pod(), routing=Routing.BORROW)
        assert not sim.can_batch_calibration()
        # sequential fallback still measures every key
        comm = build_comm_model(multi_pod=False, routing=Routing.BORROW)
        out = sim.measure_profile_batch(
            16e6, [("model", "allreduce", None)], comm=comm
        )
        assert out[("model", "allreduce", None)] > 0


class TestShapeAwareProfile:
    """AllReduce-proxy vs CalibrationProfile pricing:
    one scalar per axis systematically flatters expert parallelism; the
    shape-keyed profile prices EP's A2A on its own measured bandwidth and
    flips the planner's winner on the canonical divergence config."""

    W_DIV = traffic_mod.a2a_divergence_workload()

    @pytest.fixture(scope="class")
    def backends(self):
        comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
        kw = dict(topo=ub_mesh_pod(), size_bytes=16e6)
        return (
            NetsimPerfModel(comm, shapes=("allreduce",), **kw),   # the AllReduce proxy
            NetsimPerfModel(comm, **kw),                          # full profile
        )

    def test_winner_flips_on_a2a_pricing(self, backends):
        proxy, profile = backends
        sp = planner.best_parallel_spec(self.W_DIV, 256, proxy)
        sf = planner.best_parallel_spec(self.W_DIV, 256, profile)
        assert sp != sf
        # the proxy maxes out expert parallelism because the dispatch A2A
        # is priced at ring bandwidth; the profile retreats to smaller,
        # clique-local EP groups
        assert sf.ep < sp.ep
        # and under the shape-aware prices its own winner really is faster
        t_sp = simulate(self.W_DIV, sp, profile).iteration_s
        t_sf = simulate(self.W_DIV, sf, profile).iteration_s
        assert t_sf <= t_sp

    def test_profile_comm_model_carries_shape_bandwidths(self, backends):
        _, profile = backends
        p = ParallelSpec(tp=2, sp=4, pp=1, dp=32, ep=8, microbatches=1)
        a = profile.comm_model(p).axes["model"]
        assert a.has_shape("all_to_all")
        # ep=8 spans two boards: A2A rides the cross-board cut, well below
        # the ring bandwidth
        assert a.bw_for("all_to_all") < a.bw_for("allreduce")

    def test_proxy_backend_prices_all_shapes_on_scalar(self, backends):
        proxy, _ = backends
        a = proxy.comm_model(None).axes["model"]
        assert not a.has_shape("all_to_all")
        assert a.bw_for("all_to_all") == a.gbs_per_chip

    def test_analytic_perf_model_carries_profile(self):
        from repro_torch.core.cost_model import CalibrationProfile

        comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
        prof = CalibrationProfile(gbs={("model", "all_to_all"): 45.0})
        pm = AnalyticPerfModel(comm, profile=prof)
        assert pm.comm_model(None).axes["model"].bw_for("all_to_all") == 45.0
        # override_axis must not drop the profile
        pm2 = pm.override_axis("pod", AxisCost(2, 10.0, 1e-6))
        assert pm2.profile is prof
