"""The reference's ``tests/test_netsim.py`` restated against the port's
``repro_torch.netsim`` (the one case that needs ``core.perf_model`` and
``core.simulator`` waits for their copies: ROADMAP A12c).

repro_torch.netsim: event engine, fluid fair sharing, APR routing, collectives.

Covers the subsystem's contract: deterministic event order, per-flow byte
conservation, the max-min fair-share capacity invariant, agreement with the
analytic multi-ring model on uncongested cliques, Fig. 19 strategy
ordering under contention, and completion under link failure.
"""

import math

import pytest

from repro_torch.core.cost_model import Routing
from repro_torch.core.multiring import plan_multiring
from repro_torch.core.topology import (
    ACTIVE_ELECTRICAL,
    DimSpec,
    NDFullMesh,
    OPTICAL_100M,
    PASSIVE_ELECTRICAL,
    ub_mesh_rack,
)
from repro_torch.netsim import (
    EventEngine,
    FluidNetwork,
    NetSim,
    Router,
    Telemetry,
    hotspot_dag,
    ring_allreduce,
    trunk_congestion,
)
from repro_torch.netsim.collectives import clique_nodes, hierarchical_allreduce
from repro_torch.netsim.scenarios import inter_rack_mesh as mesh_2d


class TestEventEngine:
    def test_fires_in_time_then_seq_order(self):
        eng = EventEngine()
        fired = []
        eng.schedule(2.0, lambda: fired.append("late"))
        eng.schedule(1.0, lambda: fired.append("a"))
        eng.schedule(1.0, lambda: fired.append("b"))  # same time: seq order
        eng.run()
        assert fired == ["a", "b", "late"]
        assert eng.now == 2.0

    def test_cancel_is_skipped(self):
        eng = EventEngine()
        fired = []
        ev = eng.schedule(1.0, lambda: fired.append("x"))
        eng.schedule(2.0, lambda: fired.append("y"))
        ev.cancel()
        eng.run()
        assert fired == ["y"]

    def test_no_scheduling_in_the_past(self):
        eng = EventEngine()
        eng.schedule(1.0, lambda: None)
        eng.run()
        with pytest.raises(ValueError):
            eng.schedule_at(0.5, lambda: None)

    def test_budget_raises_before_excess_event_fires(self):
        # the guard must trip BEFORE event max_events+1 runs: exactly
        # max_events callbacks fire, the raise preempts the next one
        eng = EventEngine()
        fired = []
        for i in range(5):
            eng.schedule(float(i + 1), lambda i=i: fired.append(i))
        with pytest.raises(RuntimeError, match="event budget"):
            eng.run(max_events=3)
        assert fired == [0, 1, 2]
        assert eng.events_fired == 3

    def test_until_advances_now_when_queue_drains_early(self):
        # run(until=T) with the last event before T must still land now
        # exactly on T, so back-to-back windows tile virtual time
        eng = EventEngine()
        eng.schedule(0.25, lambda: None)
        assert eng.run(until=1.0) == 1.0
        assert eng.now == 1.0
        # an empty queue behaves the same
        assert eng.run(until=2.0) == 2.0
        assert eng.now == 2.0
        # and a future event past the window is untouched
        fired = []
        eng.schedule_at(5.0, lambda: fired.append("x"))
        assert eng.run(until=3.0) == 3.0
        assert not fired
        assert eng.pending == 1


class TestFairShare:
    def test_single_flow_gets_full_link(self):
        topo = ub_mesh_rack()
        net = FluidNetwork(topo)
        done = []
        net.add_flow((0, 1), 25e9, on_complete=lambda f: done.append(f))
        net.run()
        # X link = 4 lanes * 6.25 GB/s: 25 GB in exactly 1 s
        assert done and math.isclose(net.engine.now, 1.0, rel_tol=1e-9)

    def test_two_flows_share_one_link_fairly(self):
        topo = ub_mesh_rack()
        net = FluidNetwork(topo)
        net.add_flow((0, 1), 25e9)
        net.add_flow((0, 1), 25e9)
        net.run()
        assert math.isclose(net.engine.now, 2.0, rel_tol=1e-9)

    def test_rates_never_exceed_capacity(self):
        topo = mesh_2d()
        net = FluidNetwork(topo, record_rates=True)
        router = Router(net, Routing.DETOUR)
        for t in hotspot_dag(topo).tasks:
            router.send(t.src, t.dst, t.size)
        net.run()
        assert net.rate_log, "no rate snapshots recorded"
        for _t, _l, used, cap in net.rate_log:
            assert used <= cap * (1 + 1e-6) + 1e-3

    def test_byte_conservation_single_paths(self):
        topo = ub_mesh_rack()
        nodes = clique_nodes(topo, 0)
        dag = ring_allreduce(topo, nodes, 32e6)
        sim = NetSim(topo, routing=Routing.DETOUR)
        r = sim.run_dag(dag)
        net = sim.last_network
        assert r.incomplete == 0
        # every launched flow delivered exactly its size (aggregate ring
        # steps deliver size x multiplicity)...
        assert not net.flows
        total_flow = sum(f.total_bytes for f in net.completed.values())
        assert math.isclose(total_flow, dag.total_bytes, rel_tol=1e-9)
        # ...and each byte crossed exactly one link (1-hop ring steps)
        assert math.isclose(
            sum(net.link_bytes.values()), dag.total_bytes, rel_tol=1e-6
        )

    def test_byte_conservation_across_source_cut_multipath(self):
        # adaptive re-splitting must not resend or drop bytes: everything a
        # transfer delivers crosses the {src} cut exactly once
        topo = mesh_2d()
        net = FluidNetwork(topo)
        router = Router(net, Routing.DETOUR)
        src, dst = topo.node_id((0, 0)), topo.node_id((1, 1))
        size = 16e6
        router.send(src, dst, size)
        net.run()
        egress = sum(
            b for (u, _v), b in net.link_bytes.items() if u == src
        )
        assert math.isclose(egress, size, rel_tol=1e-6)


class TestDeterminism:
    def test_identical_runs_identical_traces(self):
        topo = mesh_2d()
        dag = hotspot_dag(topo)
        r1 = NetSim(topo, routing=Routing.DETOUR).run_dag(dag)
        r2 = NetSim(topo, routing=Routing.DETOUR).run_dag(dag)
        assert r1.task_end_s == r2.task_end_s     # exact float equality
        assert r1.events == r2.events
        assert r1.link_utilization == r2.link_utilization


class TestAnalyticAgreement:
    @pytest.mark.parametrize("n,lanes", [(5, 4), (8, 4), (4, 2)])
    def test_clique_allreduce_within_15pct(self, n, lanes):
        # odd n: Walecki cycles; even n: zig-zag chains — both must agree
        topo = NDFullMesh(dims=(DimSpec("X", n, PASSIVE_ELECTRICAL, lanes),))
        size = 48e6
        sim = NetSim(topo, routing=Routing.DETOUR)
        t = sim.allreduce_time(0, size)
        ta = plan_multiring(topo, 0).allreduce_time_s(size)
        assert abs(t - ta) / ta <= 0.15

    def test_hierarchical_allreduce_runs_full_2d(self):
        topo = mesh_2d(3, 3)
        dag = hierarchical_allreduce(topo, (0, 1), 8e6)
        r = NetSim(topo, routing=Routing.DETOUR).run_dag(dag)
        assert r.incomplete == 0
        assert r.makespan_s > 0


class TestGridMultiRing:
    def test_grid_allreduce_completes_and_beats_hierarchical(self):
        from repro_torch.netsim.collectives import grid_allreduce

        topo = ub_mesh_rack()
        size = 64e6
        sim = NetSim(topo, routing=Routing.DETOUR)
        grid = sim.run_dag(grid_allreduce(topo, (0, 1), size))
        hier = sim.run_dag(hierarchical_allreduce(topo, (0, 1), size))
        assert grid.incomplete == 0
        # both dims' links carry traffic in the same run, so the joint
        # schedule must finish well ahead of the phase-per-dim one
        assert grid.makespan_s < hier.makespan_s * 0.75

    @pytest.mark.slow
    def test_calibrated_model_axis_reaches_80pct_of_analytic(self):
        # the tentpole acceptance number: cross-dim 2D multi-ring lifts the
        # measured "model"-axis bandwidth from ~87-95 GB/s (hierarchical)
        # to >= 160 GB/s = 80% of the analytic 200 GB/s (per-chip X+Y
        # multi-ring allocation) at a bandwidth-dominated payload
        from repro_torch.core.cost_model import build_comm_model

        comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
        analytic_model_gbs = comm.axes["model"].gbs_per_chip
        sim = NetSim(ub_mesh_rack(), routing=Routing.DETOUR)
        cal = sim.calibrated_axis_gbs(512e6, comm=comm)
        assert cal["model"] >= 160.0
        assert cal["model"] >= 0.80 * analytic_model_gbs


class TestIncast:
    """Receiver-egress caps: many-to-one bursts serialize."""

    def test_n_to_one_takes_n_times_single_flow_under_egress_cap(self):
        # 7 senders on 7 DISTINCT X links into node 0: the fluid model
        # resolves this at full rate per link; under an egress cap of one
        # link's bandwidth it must take ~7x the single-flow time
        topo = ub_mesh_rack()
        x_gbs = topo.dims[0].gbs_per_peer
        net = FluidNetwork(topo, rx_gbs=x_gbs)
        net.add_flow((1, 0), 25e9)
        net.run()
        t1 = net.engine.now
        net = FluidNetwork(topo, rx_gbs=x_gbs)
        for s in range(1, 8):
            net.add_flow((s, 0), 25e9)
        net.run()
        assert math.isclose(net.engine.now, 7 * t1, rel_tol=1e-6)
        # without the cap the same burst resolves in single-flow time
        net = FluidNetwork(topo)
        for s in range(1, 8):
            net.add_flow((s, 0), 25e9)
        net.run()
        assert math.isclose(net.engine.now, t1, rel_tol=1e-6)

    def test_rx_cap_never_exceeded(self):
        # sum of inbound flow rates at a capped node stays <= the cap
        topo = ub_mesh_rack()
        cap_gbs = 40.0
        net = FluidNetwork(topo, rx_gbs=cap_gbs)
        for s in range(1, 8):
            net.add_flow((s, 0), 5e9)
        net._recompute()
        inbound = sum(
            f.rate for f in net.flows.values() if f.path[-1] == 0
        )
        assert inbound <= cap_gbs * 1e9 * (1 + 1e-6)

    def test_moe_dispatch_strictly_slower_than_incast_blind_fluid(self):
        # 64 token-holders dispatching to 4 hot expert chips: the MoE
        # all_to_all burst must strictly exceed its no-incast fluid time
        from repro_torch.netsim.collectives import model_group, moe_dispatch

        topo = ub_mesh_rack()
        dag = moe_dispatch(
            topo, list(range(topo.num_nodes)), model_group(topo, 4), 16e6
        )
        capped = NetSim(topo, routing=Routing.DETOUR).run_dag(dag)
        fluid = NetSim(topo, routing=Routing.DETOUR, rx_gbs=None).run_dag(dag)
        assert capped.incomplete == 0 and fluid.incomplete == 0
        assert capped.makespan_s > fluid.makespan_s * 1.2

    def test_default_rx_cap_preserves_multiring_allreduce(self):
        # the auto cap (largest per-dim clique allocation) must NOT slow
        # the multi-ring AllReduce: <= one inbound flow per ring per node
        topo = ub_mesh_rack()
        nodes = clique_nodes(topo, 0)
        dag = ring_allreduce(topo, nodes, 32e6)
        with_cap = NetSim(topo, routing=Routing.DETOUR).run_dag(dag)
        without = NetSim(topo, routing=Routing.DETOUR, rx_gbs=None).run_dag(dag)
        assert math.isclose(
            with_cap.makespan_s, without.makespan_s, rel_tol=1e-9
        )


class TestCalibrationProfile:
    """(axis, collective-shape)-keyed calibration."""

    def test_a2a_calibrated_at_most_allreduce_on_model_axis(self):
        # the crossval contract: the Multi-Path A2A rides relay hops and
        # the cross-board cut, so its effective bandwidth must sit at or
        # below (in practice far below) the multi-ring AllReduce number
        from repro_torch.core.cost_model import build_comm_model

        comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
        sim = NetSim(ub_mesh_rack(), routing=Routing.DETOUR)
        prof = sim.calibrated_profile(
            16e6, comm=comm, axes=("model",),
            shapes=("allreduce", "all_to_all"),
        )
        ar = prof.get("model", "allreduce")
        a2a = prof.get("model", "all_to_all")
        assert ar is not None and a2a is not None
        assert a2a <= ar
        assert a2a < 0.6 * ar          # relay + cut effects are large

    def test_reduce_scatter_aliases_all_gather(self):
        from repro_torch.core.cost_model import build_comm_model

        comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
        sim = NetSim(ub_mesh_rack(), routing=Routing.DETOUR)
        prof = sim.calibrated_profile(
            8e6, comm=comm, axes=("model",),
            shapes=("all_gather", "reduce_scatter"),
        )
        assert prof.get("model", "reduce_scatter") == prof.get(
            "model", "all_gather"
        )

    def test_calibrated_axis_gbs_matches_profile_allreduce(self):
        # the legacy scalar entry point is the allreduce slice of the
        # profile — back-compat for the scalar's consumers
        sim = NetSim(ub_mesh_rack(), routing=Routing.DETOUR)
        scalar = sim.calibrated_axis_gbs(8e6)
        prof = sim.calibrated_profile(8e6, shapes=("allreduce",))
        assert scalar["model"] == pytest.approx(
            prof.get("model", "allreduce")
        )

    def test_profile_apply_prices_shapes_separately(self):
        from repro_torch.core.cost_model import (
            CalibrationProfile, build_comm_model,
        )

        comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
        prof = CalibrationProfile(
            gbs={("model", "allreduce"): 140.0, ("model", "all_to_all"): 45.0}
        )
        cm = prof.apply(comm)
        size = 64e6
        assert cm.axes["model"].gbs_per_chip == pytest.approx(140.0)
        # A2A rides its own (much lower) measured bandwidth...
        assert cm.all_to_all("model", size) > comm.all_to_all("model", size)
        # ...while an unmeasured axis is untouched
        assert cm.axes["data"] == comm.axes["data"]


class TestRoutingPolicies:
    def test_fig19_ordering_under_contention(self):
        topo = mesh_2d()
        dag = hotspot_dag(topo)
        total = sum(t.size for t in dag.tasks)
        tput = {}
        for pol in (Routing.SHORTEST, Routing.DETOUR, Routing.BORROW):
            r = NetSim(topo, routing=pol).run_dag(dag)
            assert r.incomplete == 0
            tput[pol] = total / r.makespan_s
        assert tput[Routing.SHORTEST] < tput[Routing.DETOUR] < tput[Routing.BORROW]

    def test_detour_splits_isolated_transfer_over_disjoint_paths(self):
        topo = mesh_2d()
        net = FluidNetwork(topo)
        router = Router(net, Routing.DETOUR)
        paths = router.candidate_paths(
            topo.node_id((0, 0)), topo.node_id((1, 1))
        )
        assert len(paths) >= 2
        used = set()
        for p in paths:
            edges = {tuple(sorted(e)) for e in zip(p, p[1:])}
            assert not (edges & used)
            used |= edges


class TestFailureRecovery:
    def test_failure_reroute_completes_all_flows(self):
        topo = ub_mesh_rack()
        nodes = clique_nodes(topo, 0)
        dag = ring_allreduce(topo, nodes, 32e6)
        sim = NetSim(topo, routing=Routing.DETOUR)
        healthy = sim.run_dag(dag)
        failed = sim.run_dag(
            dag,
            fail_link=(nodes[0], nodes[1]),
            fail_at_s=healthy.makespan_s / 3,
        )
        assert failed.incomplete == 0
        assert failed.bytes_delivered == pytest.approx(dag.total_bytes)
        assert failed.makespan_s >= healthy.makespan_s * 0.999
        # the failed link carried nothing after the failure instant
        net = sim.last_network
        a, b = nodes[0], nodes[1]
        assert net.effective_capacity((a, b)) == 0.0

    def test_failure_before_start_avoids_link_entirely(self):
        topo = ub_mesh_rack()
        nodes = clique_nodes(topo, 0)
        dag = ring_allreduce(topo, nodes, 8e6)
        sim = NetSim(topo, routing=Routing.DETOUR)
        r = sim.run_dag(dag, fail_link=(nodes[2], nodes[3]), fail_at_s=0.0)
        assert r.incomplete == 0
        net = sim.last_network
        u, v = nodes[2], nodes[3]
        assert net.link_bytes.get((u, v), 0.0) == 0.0
        assert net.link_bytes.get((v, u), 0.0) == 0.0


class TestWorkloadRun:
    def test_moe_workload_collectives_complete(self):
        # tiny 4D mesh keeps the DAGs small but exercises every technique
        topo = NDFullMesh(
            dims=(
                DimSpec("X", 4, PASSIVE_ELECTRICAL, 4),
                DimSpec("Y", 2, PASSIVE_ELECTRICAL, 4),
                DimSpec("Z", 2, ACTIVE_ELECTRICAL, 2),
                DimSpec("A", 2, OPTICAL_100M, 2),
            )
        )
        from repro_torch.core.traffic import ParallelSpec, WorkloadSpec

        w = WorkloadSpec(
            name="tiny-moe", n_layers=4, hidden=1024, n_heads=8, head_dim=64,
            seq_len=4096, global_batch=16, params_total=1e9,
            n_experts=4, topk=2,
        )
        p = ParallelSpec(tp=4, sp=2, pp=2, dp=2, ep=2, microbatches=4)
        r = NetSim(topo, routing=Routing.DETOUR).run(w, p)
        assert r.incomplete == 0
        assert set(r.collective_s) == {"TP", "SP", "EP", "PP", "DP"}
        assert all(v > 0 for v in r.collective_s.values())
        assert r.iteration_comm_s > 0

    def test_tp_group_width_respected(self):
        # tp*sp=16 on the 64-chip rack: the TP DAG must span exactly the
        # 16-chip group (full X clique x 2 Y boards), not the whole plane
        from repro_torch.core.traffic import ParallelSpec
        from repro_torch.netsim.collectives import compile_traffic_entry

        topo = ub_mesh_rack()
        p = ParallelSpec(tp=8, sp=2, pp=1, dp=1)
        dag = compile_traffic_entry(topo, "TP", 8e6, p)
        touched = {n for t in dag.tasks for n in t.endpoints()}
        assert len(touched) == 16
        assert all(topo.coords(n)[1] < 2 for n in touched)

class TestScenarios:
    def test_trunk_congestion_geometry(self):
        sc = trunk_congestion()
        src = sc.topo.node_id((0, 0))
        assert sc.hot_link == (src, sc.topo.node_id((1, 0)))
        assert len(sc.dag.tasks) == 3
        # never sends to (1, 0) directly: the trunk is only ever a relay
        dsts = {t.dst for t in sc.dag.tasks}
        assert sc.hot_link[1] not in dsts
        assert all(t.src == src for t in sc.dag.tasks)
        assert sc.rx_gbs == pytest.approx(sc.topo.dims[0].gbs_per_peer / 2)

    def test_trunk_congestion_validates_geometry(self):
        with pytest.raises(ValueError):
            trunk_congestion(z=1)
        with pytest.raises(ValueError):
            trunk_congestion(a=4, fan=4)     # fan must leave (1,0) alone

    def test_shortest_saturates_trunk_and_attribution_names_it(self):
        sc = trunk_congestion()
        sim = NetSim(
            sc.topo, routing=Routing.SHORTEST, rx_gbs=sc.rx_gbs,
            telemetry=True,
        )
        res = sim.run_dag(sc.dag)
        assert res.incomplete == 0
        tel = res.telemetry
        assert tel.peak_utilization(sc.hot_link) == pytest.approx(1.0)
        # every flow rides the trunk and the solver blames it, not rx
        assert set(tel.flow_bottlenecks().values()) == {sc.hot_link}

    def test_borrow_relieves_trunk(self):
        sc = trunk_congestion()
        peaks = {}
        for pol in (Routing.SHORTEST, Routing.BORROW):
            sim = NetSim(
                sc.topo, routing=pol, rx_gbs=sc.rx_gbs, telemetry=True
            )
            res = sim.run_dag(sc.dag)
            assert res.incomplete == 0
            peaks[pol] = res.telemetry.peak_utilization(sc.hot_link)
        assert peaks[Routing.BORROW] < peaks[Routing.SHORTEST] - 0.2


class TestTelemetry:
    def test_disabled_by_default_and_zero_cost(self):
        topo = ub_mesh_rack()
        sim = NetSim(topo, routing=Routing.DETOUR)
        res = sim.run_dag(ring_allreduce(topo, clique_nodes(topo, 0), 8e6))
        assert res.telemetry is None
        assert sim.last_telemetry is None
        net = sim.last_network
        assert net.telemetry is None
        # the solver skips attribution work entirely when nobody listens
        assert net.solver.last_attribution is None

    def test_timeline_integral_matches_byte_ledger(self):
        topo = mesh_2d()
        tel = Telemetry()
        net = FluidNetwork(topo, telemetry=tel)
        router = Router(net, Routing.DETOUR)
        for t in hotspot_dag(topo).tasks:
            router.send(t.src, t.dst, t.size)
        net.run()
        assert net.link_bytes, "scenario must use links"
        for link, b in net.link_bytes.items():
            assert tel.link_bytes(link) == pytest.approx(b, rel=1e-6)
        # and links the ledger never saw are absent from the series too
        assert set(tel.link_series) <= set(net.link_bytes)

    def test_summary_schema_and_byte_audit(self):
        sc = trunk_congestion()
        sim = NetSim(
            sc.topo, routing=Routing.DETOUR, rx_gbs=sc.rx_gbs, telemetry=True
        )
        res = sim.run_dag(sc.dag)
        s = res.telemetry.summary()
        assert set(s) == {
            "duration_s", "events", "solver_samples", "links",
            "bottlenecks", "flows", "router",
        }
        assert s["duration_s"] == pytest.approx(res.makespan_s)
        assert s["solver_samples"] > 0
        assert s["links"]["top"] and "peak_util" in s["links"]["top"][0]
        assert set(s["links"]["per_dim"]) <= {"Z", "A"}
        f = s["flows"]
        # congestion re-splits withdraw subflows and relaunch the
        # remainder, so launched = completed + withdrawn — and the byte
        # audit still closes over the withdrawn-unsent bucket
        assert f["launched"] == f["completed"] + f["withdrawn"]
        assert f["bytes_delivered"] + f["bytes_withdrawn_unsent"] == (
            pytest.approx(f["bytes_requested"])
        )
        assert abs(f["stranded_bytes"]) < 1.0
        # detour throttles on the rx cap: the class accounting must see it
        assert s["bottlenecks"]["by_class"].get("rx", 0.0) > 0.0

    def test_perfetto_export_is_valid_trace_json(self, tmp_path):
        import json

        sc = trunk_congestion()
        sim = NetSim(
            sc.topo, routing=Routing.BORROW, rx_gbs=sc.rx_gbs, telemetry=True
        )
        res = sim.run_dag(sc.dag)
        path = tmp_path / "trace.json"
        trace = res.telemetry.to_perfetto(str(path))
        on_disk = json.loads(path.read_text())
        assert on_disk == trace
        evs = trace["traceEvents"]
        phases = {e["ph"] for e in evs}
        assert {"M", "C", "X", "b", "e"} <= phases
        assert all(
            e["ts"] >= 0 for e in evs if "ts" in e
        )
        # async transfer spans pair up per id
        b_ids = sorted(e["id"] for e in evs if e["ph"] == "b")
        e_ids = sorted(e["id"] for e in evs if e["ph"] == "e")
        assert b_ids == e_ids and len(b_ids) == len(sc.dag.tasks)
        # counter samples never exceed capacity
        assert all(
            0.0 <= e["args"]["util"] <= 1.0 + 1e-9
            for e in evs if e["ph"] == "C"
        )

    def test_failure_instants_and_reroute_counters(self):
        topo = ub_mesh_rack()
        nodes = clique_nodes(topo, 0)
        dag = ring_allreduce(topo, nodes, 32e6)
        sim = NetSim(topo, routing=Routing.DETOUR, telemetry=True)
        healthy = sim.run_dag(dag)
        failed = sim.run_dag(
            dag,
            fail_link=(nodes[0], nodes[1]),
            fail_at_s=healthy.makespan_s / 3,
        )
        assert failed.incomplete == 0
        tel = failed.telemetry
        assert tel is not healthy.telemetry     # fresh recorder per run
        c = tel.router_counters
        assert c["link_failures"] == 1
        assert c["reroutes"] >= 1
        names = [name for _, name, _ in tel.instants]
        assert "link_failures" in names and "reroutes" in names
        t_fail = next(
            t for t, name, _ in tel.instants if name == "link_failures"
        )
        assert t_fail == pytest.approx(healthy.makespan_s / 3)
        # withdrawn flows keep the byte audit closed
        f = tel.summary()["flows"]
        assert f["withdrawn"] >= 1
        assert f["bytes_delivered"] + f["bytes_withdrawn_unsent"] == (
            pytest.approx(f["bytes_requested"])
        )

    def test_one_recorder_per_network(self):
        tel = Telemetry()
        FluidNetwork(ub_mesh_rack(), telemetry=tel)
        with pytest.raises(ValueError):
            FluidNetwork(ub_mesh_rack(), telemetry=tel)
