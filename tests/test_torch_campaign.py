"""The reference's ``tests/test_campaign.py`` restated against the port's
``repro_torch.runtime.campaign``.

Monte-Carlo availability campaign tests (`runtime/campaign.py`):
seeded determinism, the recovery policy engine, netsim degraded-mesh
repricing (incremental keying + memoization), and the codesign
availability axis."""

from __future__ import annotations

from dataclasses import replace

import pytest

from repro_torch.core.availability import PAPER_CLOS, PAPER_UB_MESH
from repro_torch.core.codesign import (
    DesignPoint,
    GeometryCandidate,
    pareto_frontier,
    prefilter_geometries,
)
from repro_torch.runtime.campaign import (
    CampaignConfig,
    DegradedRepricer,
    FailureEvent,
    availability_score,
    campaign_trace,
    canonical_failed_links,
    failure_class_rates,
    head_to_head,
    replay_seed,
    run_campaign,
    sample_events,
    scale_afr,
    unavailability_for_afr,
    _union_hours,
)

import numpy as np

SMOKE = GeometryCandidate(board=4, boards_per_rack=4)   # (4,4,4,4) = 256
CAL_BYTES = 4e6


@pytest.fixture(scope="module")
def smoke_campaign():
    cfg = CampaignConfig(
        candidate=SMOKE, chips=256, seeds=(0, 1, 2), size_bytes=CAL_BYTES
    )
    return run_campaign(cfg)


class TestSampling:
    def test_events_deterministic_per_seed(self):
        rates = failure_class_rates(PAPER_UB_MESH, SMOKE, 256)
        a = sample_events(rates, 672.0, np.random.default_rng(42),
                          npu_rate_per_year=30.0, n_racks=16)
        b = sample_events(rates, 672.0, np.random.default_rng(42),
                          npu_rate_per_year=30.0, n_racks=16)
        assert a == b
        c = sample_events(rates, 672.0, np.random.default_rng(43),
                          npu_rate_per_year=30.0, n_racks=16)
        assert a != c

    def test_event_rate_unbiased(self):
        rates = {"x": 632.8}
        n = np.mean([
            len(sample_events(rates, 672.0, np.random.default_rng(s)))
            for s in range(24)
        ])
        assert n == pytest.approx(632.8 * 672.0 / 8760.0, rel=0.1)

    def test_scale_afr_proportional(self):
        half = scale_afr(PAPER_CLOS, 0.5)
        assert half.total == pytest.approx(PAPER_CLOS.total / 2)
        assert half.optical_cable == pytest.approx(574.0 / 2)

    def test_union_hours_merges_overlaps(self):
        assert _union_hours([(0, 2), (1, 3), (10, 11)], 100.0) == 4.0
        assert _union_hours([(-5, 1), (99, 200)], 100.0) == 2.0
        assert _union_hours([], 100.0) == 0.0


class TestCanonicalLinks:
    def test_classes_survivable_on_smoke_pod(self):
        topo = SMOKE.pod()
        for cls in ("x_link", "y_link", "z_trunk", "a_trunk", "lrs"):
            links = canonical_failed_links(topo, cls)
            assert links, cls
            for u, v in links:
                assert topo.are_adjacent(u, v) is not None

    def test_trunk_classes_need_detour_clique(self):
        # z/a depth 2: a trunk failure leaves no same-clique relay, so
        # the class is charged availability but no measured degradation
        thin = GeometryCandidate(z_lanes=2, a_lanes=2).pod()
        assert thin.shape[2] == 4               # default is deep enough
        two_deep = replace(SMOKE, rows=2, racks_per_row=2).pod()
        assert two_deep.shape[2] == 2
        assert canonical_failed_links(two_deep, "z_trunk") == ()

    def test_staggered_lrs_leaves_every_chip_a_detour(self):
        topo = SMOKE.pod()
        links = canonical_failed_links(topo, "lrs")
        per_chip_dim: dict[tuple[int, int], int] = {}
        for u, v in links:
            d = topo.are_adjacent(u, v)
            for node in (u, v):
                per_chip_dim[(node, d)] = per_chip_dim.get((node, d), 0) + 1
        # no chip loses more than one link in any dimension's clique
        assert max(per_chip_dim.values()) == 1


class TestRepricing:
    @pytest.fixture(scope="class")
    def repricer(self):
        from repro_torch.core.planner import best_parallel_spec
        from repro_torch.runtime.campaign import _default_workload

        perf = SMOKE.perf_model(256, size_bytes=CAL_BYTES)
        w = _default_workload()
        spec = best_parallel_spec(w, 256, perf, rack_size=SMOKE.rack_size)
        return DegradedRepricer(
            perf, w, spec, rack_size=SMOKE.rack_size,
            hrs_count=SMOKE.superpod(256).hrs_count(),
        )

    def test_trunk_failure_reprices_through_netsim(self, repricer):
        # the degraded number comes from the flow simulator's APR reroute
        # on the failed mesh — a_trunk/lrs must cost a measurable slowdown
        assert repricer.delta_s("a_trunk") > 0.01
        assert repricer.delta_s("lrs") > 0.01

    def test_single_link_absorbed_by_detour(self, repricer):
        # the paper's graceful-degradation claim: one intra-rack cable
        # loss detours inside the 4-clique with no step-time cost
        assert repricer.delta_s("x_link") == 0.0
        assert repricer.delta_s("y_link") == 0.0

    def test_deltas_memoized(self, repricer):
        d1 = repricer.delta_s("a_trunk")
        assert repricer._memo["a_trunk"] == d1
        assert repricer.delta_s("a_trunk") == d1

    def test_degraded_axes_incremental_keying(self):
        perf = SMOKE.perf_model(256, size_bytes=CAL_BYTES)
        links = canonical_failed_links(perf.topo, "a_trunk")
        deg = replace(perf, failed_links=links)
        # chip-level trunk failures touch only the data axis: model keys
        # stay healthy cache hits, the pod axis is never degraded
        assert deg._degraded_axes() == frozenset({"data"})
        x = replace(perf, failed_links=canonical_failed_links(perf.topo, "x_link"))
        assert x._degraded_axes() == frozenset({"model"})

    def test_degraded_bandwidth_below_healthy(self):
        from repro_torch.netsim.api import NetSim

        topo = SMOKE.pod()
        links = canonical_failed_links(topo, "a_trunk")
        req = [("data", "allreduce", None)]
        healthy = NetSim(topo).measure_profile_batch(CAL_BYTES, req)[req[0]]
        degraded = NetSim(topo, failed_links=links).measure_profile_batch(
            CAL_BYTES, req
        )[req[0]]
        assert degraded < healthy * 0.9


class TestReplayPolicyEngine:
    def _cfg(self, **kw) -> CampaignConfig:
        base = dict(candidate=SMOKE, chips=256, seeds=(0,),
                    netsim_reprice=False)
        base.update(kw)
        return CampaignConfig(**base)

    def test_replay_deterministic(self, smoke_campaign):
        a = replay_seed(smoke_campaign.config, 1, None)
        b = replay_seed(smoke_campaign.config, 1, None)
        assert a.availability == b.availability
        assert a.goodput == b.goodput
        assert a.timeline == b.timeline

    def test_backup_swap_charges_fast_mttr_only(self):
        cfg = self._cfg(npu_afr_per_year=2.0)   # dense NPU failures
        r = replay_seed(cfg, 3, None)
        swaps = [e for e in r.timeline if e["action"] == "backup_swap"]
        assert swaps
        for e in swaps:
            assert e["stall_h"] == pytest.approx(13.0 / 60.0)
        assert r.lost_work_hours == 0.0 or any(
            e["action"] != "backup_swap" for e in r.timeline
        )

    def test_clos_pays_checkpoint_restore_per_npu_failure(self):
        cfg = self._cfg(arch="clos", npu_afr_per_year=2.0)
        r = replay_seed(cfg, 3, None)
        restores = [e for e in r.timeline if e["action"] == "checkpoint_restore"]
        assert restores
        for e in restores:
            assert e["stall_h"] == pytest.approx(1.25)
            assert 0.0 <= e["lost_work_h"] <= cfg.checkpoint_interval_hours
        assert r.lost_work_hours > 0.0
        assert r.policies["backup"] == 0

    def test_spares_exhausted_falls_back_to_policy_choice(self):
        # huge NPU rate on one tiny horizon -> same rack fails repeatedly
        # before the 24 h restock, exhausting the +1 spare
        cfg = self._cfg(npu_afr_per_year=80.0, horizon_weeks=1.0)
        r = replay_seed(cfg, 0, None)
        assert r.policies["backup"] > 0
        assert r.policies["wait"] + r.policies["shrink"] > 0

    def test_network_availability_excludes_npu_stalls(self):
        # NPU-only failures: job availability dips, network metric doesn't
        cfg = self._cfg(npu_afr_per_year=5.0, profile=scale_afr(PAPER_UB_MESH, 0.0))
        r = replay_seed(cfg, 2, None)
        assert r.availability == 1.0
        assert r.job_availability < 1.0

    def test_goodput_discounts_degraded_windows(self, smoke_campaign):
        for run in smoke_campaign.runs:
            assert 0.0 <= run.goodput <= run.job_availability + 1e-9


class TestCampaignAggregation:
    def test_summary_shape(self, smoke_campaign):
        s = smoke_campaign.summary()
        assert s["arch"] == "ub-mesh"
        assert s["seeds"] == 3
        assert 0.9 <= s["availability"] <= 1.0
        assert set(s["policies"]) <= {"backup", "restore", "shrink", "wait"}
        assert s["healthy_step_s"] > 0

    def test_head_to_head_gap_band(self):
        h = head_to_head(chips=8192, seeds=tuple(range(16)),
                         netsim_reprice=False)
        assert h["ub"].availability > h["clos"].availability
        assert abs(h["availability_gap"] - 0.072) <= 0.02
        assert h["goodput_gap"] > 0

    def test_trace_export(self, smoke_campaign, tmp_path):
        run = max(smoke_campaign.runs, key=lambda r: r.n_events)
        doc = campaign_trace(run, path=str(tmp_path / "trace.json"))
        assert (tmp_path / "trace.json").exists()
        kinds = {e["ph"] for e in doc["traceEvents"]}
        assert "C" in kinds                     # goodput counter track
        if run.timeline:
            assert "X" in kinds and "i" in kinds


class TestCodesignAvailabilityAxis:
    def test_score_deterministic_and_ordered(self):
        ua = availability_score(SMOKE, 256)
        assert ua == availability_score(SMOKE, 256)
        # more chips -> more components -> strictly less available
        assert availability_score(GeometryCandidate(), 8192) > ua
        # the optical-heavy Clos profile is worse than the paper's 64-chip
        # -rack geometry at equal scale (the tiny-rack SMOKE pod is NOT —
        # 32x the racks means 32x the LRS fleet, a real co-design tension
        # the third Pareto axis is there to expose)
        from repro_torch.core.availability import clos_afr, superpod_afr

        paper_geom = GeometryCandidate()
        assert unavailability_for_afr(
            clos_afr(8192)
        ) > unavailability_for_afr(superpod_afr(paper_geom.superpod(8192)))
        assert unavailability_for_afr(
            superpod_afr(SMOKE.superpod(8192))
        ) > unavailability_for_afr(superpod_afr(paper_geom.superpod(8192)))

    def test_three_axis_dominance(self):
        a = DesignPoint("a", 1.0, 100.0, unavailability=0.01)
        b = DesignPoint("b", 1.1, 110.0, unavailability=0.02)  # dominated
        c = DesignPoint("c", 1.1, 110.0, unavailability=0.005)  # saved by axis 3
        front = pareto_frontier([a, b, c])
        names = {p.name for p in front}
        assert names == {"a", "c"}

    def test_default_zero_axis_keeps_two_axis_behavior(self):
        a = DesignPoint("a", 1.0, 100.0)
        b = DesignPoint("b", 2.0, 200.0)
        assert {p.name for p in pareto_frontier([a, b])} == {"a"}

    def test_prefilter_availability_conjunct_winner_safe(self):
        from repro_torch.runtime.campaign import _default_workload

        cands = [SMOKE, GeometryCandidate(board=4, boards_per_rack=4,
                                          uplink_lanes_per_rack=64)]
        w = _default_workload()
        # identical perf/tco bounds candidate can only be culled if its
        # availability is also no better — give the second candidate a
        # strictly better (lower) score and require it survives
        ua = [0.5, 0.001]
        survivors, culled, _ = prefilter_geometries(
            w, cands, 256, margin=5.0, unavailability=ua
        )
        assert cands[1] in survivors
        with pytest.raises(ValueError):
            prefilter_geometries(w, cands, 256, unavailability=[0.1])
