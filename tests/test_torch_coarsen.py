"""The reference's ``tests/test_coarsen.py`` restated against the port's
``repro_torch.netsim.coarsen`` and ``core.perf_model``.

Rack-coarsened SuperPod calibration (netsim/coarsen.py).

Contracts:
* the coarse mesh's aggregate capacities follow from SuperPod geometry
  (trunked inter-rack cliques, one HRS uplink of IO per rack),
* coarse-measured cross-pod DP bandwidth lands within 20% of the analytic
  DCN ("pod" axis) model on an uncontended config — the acceptance bar —
  and coarse-measured inter-rack ("data") bandwidth within a few % of the
  exact chip-level pod measurement,
* ``NetsimPerfModel(superpod=...)`` prices the pod axis on the coarse
  measurement (memo key carries the coarsening level) and a 4-pod
  4096-chip ``plan()`` stays fast.
"""

import time
from dataclasses import replace

import pytest

from repro_torch.core.cost_model import Routing, build_comm_model
from repro_torch.core.perf_model import NetsimPerfModel
from repro_torch.core.topology import SuperPod, ub_mesh_pod
from repro_torch.netsim import NetSim
from repro_torch.netsim.coarsen import (
    MixedMesh,
    coarse_calibrated_profile,
    coarse_netsim,
    coarsen_superpod,
    cross_pod_background_dag,
    mixed_calibrated_profile,
    mixed_netsim,
)
from repro_torch.netsim.collectives import (
    FlowDAG,
    clique_nodes,
    ring_allreduce,
    splice_dag,
)


@pytest.fixture(scope="module")
def superpod4() -> SuperPod:
    return SuperPod(pod=ub_mesh_pod(), n_pods=4)


@pytest.fixture(scope="module")
def mixed4(superpod4):
    """The 4-pod SuperPod with rack 0 = (Z0, A0, pod 0) at chip level."""
    return coarsen_superpod(superpod4, detail_racks=(0,))


class TestCoarseMesh:
    def test_rack_level_geometry(self, superpod4):
        cm = coarsen_superpod(superpod4)
        pod = superpod4.pod
        assert cm.topo.shape == (pod.shape[2], pod.shape[3], 4)
        assert cm.chips_per_node == pod.shape[0] * pod.shape[1]
        assert cm.num_chips == superpod4.num_nodes == 4096
        # trunk aggregation: 64 chips x 2 lanes x 6.25 GB/s = 800 per peer
        assert cm.topo.dims[0].gbs_per_peer == pytest.approx(
            cm.chips_per_node * pod.dims[2].gbs_per_peer
        )
        # the HRS dim carries the full uplink per pair, capped per rack
        uplink = superpod4.uplink_lanes_per_rack * 6.25
        assert cm.topo.dims[2].gbs_per_peer == pytest.approx(uplink)
        assert cm.dim_io_gbs == {2: pytest.approx(uplink)}
        assert cm.axis_dims == {"data": (0, 1), "pod": (2,)}

    def test_pod_level_geometry(self, superpod4):
        cm = coarsen_superpod(superpod4, level="pod")
        assert cm.topo.shape == (4,)
        assert cm.chips_per_node == superpod4.pod.num_nodes
        assert cm.axis_dims == {"pod": (0,)}

    def test_unknown_level_rejected(self, superpod4):
        with pytest.raises(ValueError):
            coarsen_superpod(superpod4, level="board")

    def test_single_pod_has_no_hrs_dim(self):
        cm = coarsen_superpod(SuperPod(pod=ub_mesh_pod(), n_pods=1))
        assert "pod" not in cm.axis_dims
        assert cm.dim_io_gbs == {}


class TestCoarseAccuracy:
    def test_cross_pod_dp_bw_within_20pct_of_analytic(self, superpod4):
        # uncontended cross-pod DP: the HRS tier is a non-blocking Clos,
        # so the measured AllReduce bandwidth must track the analytic
        # uplink allocation (25 GB/s per chip) within the 20% bar
        comm = build_comm_model(multi_pod=True, routing=Routing.DETOUR)
        cm = coarsen_superpod(superpod4)
        prof = coarse_calibrated_profile(
            cm, 64e6, axis_sizes={"pod": 4}, axes=("pod",),
            shapes=("allreduce",),
        )
        measured = prof.get("pod", "allreduce")
        analytic = comm.axes["pod"].gbs_per_chip
        assert measured is not None
        assert abs(measured - analytic) / analytic <= 0.20

    def test_coarse_data_axis_tracks_chip_level_measurement(self, superpod4):
        # rack granularity loses intra-rack detail but must keep the
        # inter-rack trunks' effective bandwidth: within 5% of the exact
        # 1024-chip pod measurement
        comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
        exact = NetSim(ub_mesh_pod(), routing=Routing.DETOUR).calibrated_profile(
            16e6, comm=comm, axes=("data",), shapes=("allreduce",)
        ).get("data", "allreduce")
        cm = coarsen_superpod(superpod4)
        coarse = coarse_calibrated_profile(
            cm, 16e6, axis_sizes={"data": 16}, axes=("data",),
            shapes=("allreduce",), latency_s=1e-6,   # match the exact run
        ).get("data", "allreduce")
        assert coarse == pytest.approx(exact, rel=0.05)

    def test_hrs_io_cap_binds_on_fanout(self, superpod4):
        # one rack bursting to every peer pod at once must be squeezed to
        # its single uplink, not n_pods-1 uplinks
        cm = coarsen_superpod(superpod4)
        sim = coarse_netsim(cm)
        net = sim._fresh().net
        uplink = cm.dim_io_gbs[2] * 1e9
        hrs_peers = [
            v for v in range(cm.topo.num_nodes)
            if cm.topo.are_adjacent(0, v) == 2
        ]
        flows = [net.add_flow((0, v), 1e9) for v in hrs_peers]
        net._recompute()
        total = sum(f.rate for f in flows)
        assert total <= uplink * (1 + 1e-6)
        assert total == pytest.approx(uplink, rel=1e-6)


class TestSuperpodPerfModel:
    def test_pod_axis_priced_on_coarse_measurement(self, superpod4):
        base = build_comm_model(multi_pod=True, routing=Routing.DETOUR)
        base = base.override_axis("pod", replace(base.axes["pod"], size=4))
        perf = NetsimPerfModel(
            base, topo=ub_mesh_pod(), size_bytes=64e6, superpod=superpod4
        )
        cm = perf.comm_model(None)
        pod = cm.axes["pod"]
        assert pod.has_shape("allreduce")
        # measured, clamped at the analytic bound, and within the 20% bar
        assert pod.gbs_per_chip <= base.axes["pod"].gbs_per_chip + 1e-9
        assert pod.gbs_per_chip >= 0.80 * base.axes["pod"].gbs_per_chip

    def test_without_superpod_pod_axis_stays_analytic(self):
        base = build_comm_model(multi_pod=True, routing=Routing.DETOUR)
        perf = NetsimPerfModel(base, topo=ub_mesh_pod(), size_bytes=64e6)
        cm = perf.comm_model(None)
        assert cm.axes["pod"].gbs_per_chip == base.axes["pod"].gbs_per_chip
        assert not cm.axes["pod"].has_shape("allreduce")

    def test_4096_chip_plan_under_budget(self, superpod4):
        from repro_torch.core.planner import plan
        from repro_torch.core.traffic import moe_2t_workload

        base = build_comm_model(multi_pod=True, routing=Routing.DETOUR)
        base = base.override_axis("pod", replace(base.axes["pod"], size=4))
        perf = NetsimPerfModel(
            base, topo=ub_mesh_pod(), size_bytes=64e6, superpod=superpod4
        )
        w, _ = moe_2t_workload()
        t0 = time.perf_counter()
        rep = plan(w, 4096, perf)
        wall = time.perf_counter() - t0
        assert len(rep) > 0
        assert rep[0].spec.chips == 4096
        assert wall < 60.0


class TestMixedMeshGeometry:
    def test_empty_detail_racks_is_pure_coarse(self, superpod4):
        # the coarse-only path must stay byte-for-byte the first
        # pure-coarse construction: same topology object type, dims, caps, layout
        cm0 = coarsen_superpod(superpod4)
        cm1 = coarsen_superpod(superpod4, detail_racks=())
        assert type(cm1.topo) is type(cm0.topo)
        assert cm1.topo == cm0.topo
        assert cm1.dim_io_gbs == cm0.dim_io_gbs
        assert cm1.axis_dims == cm0.axis_dims
        assert cm1.detail_racks == ()
        p0 = coarse_calibrated_profile(
            cm0, 16e6, axis_sizes={"pod": 4}, axes=("pod",),
            shapes=("allreduce",),
        )
        p1 = coarse_calibrated_profile(
            cm1, 16e6, axis_sizes={"pod": 4}, axes=("pod",),
            shapes=("allreduce",),
        )
        assert p0.gbs == p1.gbs           # bit-identical, not approx

    def test_mixed_geometry_and_boundary_capacities(self, superpod4, mixed4):
        mm = mixed4.topo
        pod = superpod4.pod
        assert isinstance(mm, MixedMesh)
        cpr = pod.shape[0] * pod.shape[1]
        # 64 coarse ids (rack 0 dangling) + 64 chips
        assert mm.num_nodes == mm.coarse.num_nodes + cpr
        assert mixed4.num_chips == superpod4.num_nodes == 4096
        assert mm.expand(0) == tuple(range(64, 128))
        assert mm.expand(1) is None
        chips = mm.chips_of(0)
        # the dangling coarse id has no links; every chip has X+Y+Z+A+P
        assert all(u != 0 and v != 0 for u, v, _ in mm.links())
        z_peers = [v for v in range(mm.coarse.num_nodes)
                   if mm.coarse.are_adjacent(0, v) == 0]
        c = chips[0]
        # chip's trunk share on Z = the chip-level lanes (12.5 GB/s)
        assert mm.link_gbs(c, z_peers[0]) == pytest.approx(
            pod.dims[2].gbs_per_peer
        )
        # chip's HRS uplink share = uplink / chips_per_rack (25 GB/s)
        uplink = superpod4.uplink_lanes_per_rack * 6.25
        hrs_dim = mixed4.axis_dims["pod"][0]
        p_peer = next(
            v for v, d in mm._adj[c].items() if d == hrs_dim
        )
        assert mm.link_gbs(c, p_peer) == pytest.approx(uplink / cpr)
        # per-node HRS IO caps: chips' shares sum to the rack's cap
        caps = mixed4.dim_io_gbs[hrs_dim]
        assert caps[1] == pytest.approx(uplink)
        assert sum(caps[ch] for ch in chips) == pytest.approx(uplink)
        assert 0 not in caps
        # heterogeneous ejection: chip-level vs rack-level rx
        assert mm.node_rx_gbs[chips[0]] == pytest.approx(
            pod.dims[0].gbs_total
        )
        assert mm.node_rx_gbs[1] > 10 * mm.node_rx_gbs[chips[0]]

    def test_detail_racks_validation(self, superpod4):
        with pytest.raises(ValueError):
            coarsen_superpod(superpod4, level="pod", detail_racks=(0,))
        with pytest.raises(ValueError):
            coarsen_superpod(superpod4, detail_racks=(999,))
        # detail_racks without a SuperPod to embed them in must not
        # silently fall back to the isolated chip-level calibration
        base = build_comm_model(multi_pod=True, routing=Routing.DETOUR)
        with pytest.raises(ValueError):
            NetsimPerfModel(base, topo=ub_mesh_pod(), detail_racks=(0,))
        # background on a single-pod SuperPod has no HRS tier to cross —
        # measuring "with background" would silently return idle numbers
        single = coarsen_superpod(
            SuperPod(pod=ub_mesh_pod(), n_pods=1), detail_racks=(0,)
        )
        with pytest.raises(ValueError):
            mixed_calibrated_profile(
                single, 8e6, axes=("model",), shapes=("allreduce",),
                background_per_chip_bytes=8e6,
            )

    def test_splice_dag_classes_and_barrier(self, mixed4):
        mm = mixed4.topo
        dag = FlowDAG(name="t")
        # one aggregate step mixing all three pair classes
        t0 = dag._add(src=1, dst=2, size=64.0, single_path=True,
                      pairs=((1, 2), (0, 3), (2, 0)))
        t1 = dag._add(src=2, dst=1, size=64.0, deps=(t0.tid,))
        out = splice_dag(dag, mm.expand)
        # classes: coarse-coarse, detail->coarse, coarse->detail
        assert len(out.tasks) == 4
        first = [t for t in out.tasks if not t.deps]
        assert len(first) == 3
        sizes = sorted(t.size for t in first)
        assert sizes == [1.0, 1.0, 64.0]     # 64-way splits carry 1/64th
        assert sum(t.total_bytes for t in first) == pytest.approx(3 * 64.0)
        # the barrier: the dependent task waits on every spliced piece
        last = out.tasks[-1]
        assert set(last.deps) == {t.tid for t in first}

    def test_intra_rack_routing_prefers_clique_links(self, mixed4):
        # two embedded chips differing in both X and Y reach each other
        # in 2 hops via a sibling chip (25 GB/s clique links) OR via any
        # adjacent coarse rack (12.5 GB/s trunk shares that also carry
        # cross-pod traffic); the chip relays must win the Router's
        # in-order link-disjoint selection
        mm = mixed4.topo
        chips = mm.chips_of(0)
        c1, c2 = chips[0], chips[9]          # local (0,0) and (1,1)
        first_coarse = mm.coarse.num_nodes
        sp = mm.apr_shortest_paths(c1, c2)
        assert len(sp[0]) == 3
        assert all(n >= first_coarse for n in sp[0])
        router = mixed_netsim(mixed4)._fresh()
        cand = router.candidate_paths(c1, c2)
        assert len(cand) >= 2
        assert all(n >= first_coarse for p in cand[:2] for n in p), (
            "multi-path split between embedded chips must lead with the "
            "intra-rack clique relays, not coarse trunk shares"
        )

    def test_apr_hooks_on_mixed_mesh(self, mixed4):
        mm = mixed4.topo
        chips = mm.chips_of(0)
        c = chips[0]
        z_peer = next(v for v, d in mm._adj[c].items() if d == 0)
        # adjacent: one direct shortest path
        assert mm.apr_shortest_paths(c, z_peer)[0] == (c, z_peer)
        assert mm.hop_distance(c, z_peer) == 1
        # detours relay through the rack's other chips (X/Y) or racks
        detours = [p for p in mm.apr_all_paths(c, z_peer) if len(p) == 3]
        assert detours
        assert all(p[0] == c and p[-1] == z_peer for p in detours)


class TestMixedAccuracy:
    def test_pod_axis_matches_pure_coarse_within_2pct(self, superpod4, mixed4):
        coarse = coarse_calibrated_profile(
            coarsen_superpod(superpod4), 64e6, axis_sizes={"pod": 4},
            axes=("pod",), shapes=("allreduce",),
        ).get("pod", "allreduce")
        mixed = mixed_calibrated_profile(
            mixed4, 64e6, axis_sizes={"pod": 4}, axes=("pod",),
            shapes=("allreduce",),
        ).get("pod", "allreduce")
        assert mixed == pytest.approx(coarse, rel=0.02)

    def test_pod_axis_within_pr4_bound_of_analytic(self, superpod4, mixed4):
        comm = build_comm_model(multi_pod=True, routing=Routing.DETOUR)
        mixed = mixed_calibrated_profile(
            mixed4, 64e6, axis_sizes={"pod": 4}, axes=("pod",),
            shapes=("allreduce",),
        ).get("pod", "allreduce")
        analytic = comm.axes["pod"].gbs_per_chip
        assert abs(mixed - analytic) / analytic <= 0.20

    def test_idle_model_axis_matches_chip_level(self, mixed4):
        # with zero background the embedded rack is the chip-level rack:
        # same links, same rx caps, same DAG conventions
        chip = NetSim(ub_mesh_pod(), routing=Routing.DETOUR).calibrated_profile(
            64e6, axis_sizes={"model": 16}, axes=("model",),
            shapes=("allreduce",),
        ).get("model", "allreduce")
        mixed = mixed_calibrated_profile(
            mixed4, 64e6, axis_sizes={"model": 16}, axes=("model",),
            shapes=("allreduce",), latency_s=1e-6,
        ).get("model", "allreduce")
        assert mixed == pytest.approx(chip, rel=0.02)

    def test_background_dp_degrades_model_axis_over_5pct(self, mixed4):
        # the acceptance bar: cross-pod DP background crossing the
        # embedded rack's uplinks must shave >5% off the measured
        # model-axis bandwidth (ejection-port sharing the pure paths
        # cannot see)
        iso = mixed_calibrated_profile(
            mixed4, 64e6, axis_sizes={"model": 16}, axes=("model",),
            shapes=("allreduce",), latency_s=1e-6,
        ).get("model", "allreduce")
        loaded = mixed_calibrated_profile(
            mixed4, 64e6, axis_sizes={"model": 16}, axes=("model",),
            shapes=("allreduce",), latency_s=1e-6,
            background_per_chip_bytes=64e6,
        ).get("model", "allreduce")
        assert loaded < iso
        assert 1 - loaded / iso > 0.05

    def test_spliced_a2a_spans_detail_chips_and_coarse_racks(self, mixed4):
        # the Fig. 14 relay A2A at rack granularity, spliced: store-and-
        # forward hops through the embedded rack run as 64 trunk-share
        # flows terminating/originating at its chips
        prof = mixed_calibrated_profile(
            mixed4, 8e6, axis_sizes={"data": 16}, axes=("data",),
            shapes=("all_to_all",),
        )
        val = prof.get("data", "all_to_all")
        assert val is not None and val > 0
        # the A2A group (Z clique widened over A) contains rack 0, so the
        # spliced run must touch the detail chips
        net = mixed_netsim(mixed4)
        mm = mixed4.topo
        from repro_torch.netsim import NetSim as _NS

        coarse_sim = _NS(mm.coarse, axis_dims={"data": (0, 1)})
        dag = coarse_sim._axis_shape_dag(
            (0, 1), "all_to_all", 8e6 * mixed4.chips_per_node, None, "a2a"
        )
        spliced = splice_dag(dag, mm.expand)
        chips = set(mm.chips_of(0))
        endpoints = {n for t in spliced.tasks for n in t.endpoints()}
        assert endpoints & chips and 0 not in endpoints
        r = net.run_dag(spliced)
        assert r.incomplete == 0
        assert r.bytes_delivered == pytest.approx(spliced.total_bytes)

    def test_background_dag_crosses_detail_uplinks(self, mixed4):
        mm = mixed4.topo
        dag = cross_pod_background_dag(mixed4, 8e6)
        chips = set(mm.chips_of(0))
        endpoints = {n for t in dag.tasks for n in t.endpoints()}
        assert endpoints & chips            # spliced onto the chips
        assert 0 not in endpoints           # dangling coarse id rewritten
        r = mixed_netsim(mixed4).run_dag(dag)
        assert r.incomplete == 0
        assert r.bytes_delivered == pytest.approx(dag.total_bytes)


class TestMixedFailureReroute:
    def test_trunk_failure_adjacent_to_detail_rack_recovers(self, mixed4):
        # kill a chip's Z-trunk share mid-run: APR must reroute through a
        # sibling chip's X/Y links and the byte accounting must balance
        mm = mixed4.topo
        sim = mixed_netsim(mixed4, latency_s=1e-6)
        chips = mm.chips_of(0)
        c = chips[0]
        z_peer = next(v for v, d in mm._adj[c].items() if d == 0)
        nodes = clique_nodes(mm.coarse, 0, {1: 0, 2: 0})   # Z clique of rack 0
        dag = splice_dag(
            ring_allreduce(mm.coarse, nodes, 64e6 * mixed4.chips_per_node,
                           tag="z-ar"),
            mm.expand,
        )
        clean = sim.run_dag(dag)
        assert clean.incomplete == 0
        r = sim.run_dag(
            dag, fail_link=(c, z_peer), fail_at_s=clean.makespan_s / 4
        )
        assert r.failure_stats["affected_transfers"] > 0
        assert r.incomplete == 0                        # everything recovered
        assert r.bytes_delivered == pytest.approx(dag.total_bytes)
        assert r.makespan_s >= clean.makespan_s         # rerouting cannot win
        # the failed trunk share carried no bytes after the failure:
        # utilization stays below the clean run's on that link
        net = sim.last_network
        assert (c, z_peer) in net.failed


class TestMixedPerfModel:
    def test_detail_racks_degrade_planner_model_axis(self, superpod4):
        base = build_comm_model(multi_pod=True, routing=Routing.DETOUR)
        base = base.override_axis(
            "pod", replace(base.axes["pod"], size=4)
        )
        iso = NetsimPerfModel(
            base, topo=ub_mesh_pod(), size_bytes=64e6, superpod=superpod4
        )
        mix = NetsimPerfModel(
            base, topo=ub_mesh_pod(), size_bytes=64e6, superpod=superpod4,
            detail_racks=(0,),
        )
        cm_iso = iso.comm_model(None)
        cm_mix = mix.comm_model(None)
        # model axis priced lower under DCN interference; memo keys are
        # distinct so the isolated number is not clobbered
        ar_iso = cm_iso.axes["model"].bw_for("allreduce")
        ar_mix = cm_mix.axes["model"].bw_for("allreduce")
        assert ar_mix < ar_iso
        assert 1 - ar_mix / ar_iso > 0.05
        # pod axis still priced on the (cached) coarse measurement
        assert cm_mix.axes["pod"].gbs_per_chip == pytest.approx(
            cm_iso.axes["pod"].gbs_per_chip
        )
        # re-resolving the isolated backend returns the isolated number
        assert iso.comm_model(None).axes["model"].bw_for(
            "allreduce"
        ) == pytest.approx(ar_iso)

    def test_spec_narrowed_mixed_calibration(self, superpod4):
        # partial-width TP*SP groups ride the hierarchical schedule
        # inside the embedded rack too (same conventions as chip level),
        # still with the DCN background applied
        from repro_torch.core.traffic import ParallelSpec

        base = build_comm_model(multi_pod=True, routing=Routing.DETOUR)
        base = base.override_axis(
            "pod", replace(base.axes["pod"], size=4)
        )
        mix = NetsimPerfModel(
            base, topo=ub_mesh_pod(), size_bytes=64e6, superpod=superpod4,
            detail_racks=(0,),
        )
        spec = ParallelSpec(tp=8, sp=2, pp=2, dp=16, ep=2)
        cm = mix.comm_model(spec)
        full = mix.comm_model(None)
        narrow = cm.axes["model"].bw_for("allreduce")
        wide = full.axes["model"].bw_for("allreduce")
        assert narrow > 0
        # a 16-chip group cannot beat the full-plane grid rings
        assert narrow <= wide * (1 + 1e-6)
