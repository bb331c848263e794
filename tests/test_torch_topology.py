"""The reference's ``tests/test_topology.py`` restated against the port's
``repro_torch.core``, every case, followed by the cross-package cases: the
port's ``core/`` copies held equal by ``==`` to the reference's on the same
inputs.

Core topology + APR unit & property tests."""

import itertools

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st  # hypothesis or skip-shim
from _torch_netsim_parity import both, outcome, pkgs

from repro_torch.core import apr, topology
from repro_torch.core.topology import DimSpec, NDFullMesh, PASSIVE_ELECTRICAL, ub_mesh_pod


def small_mesh(shape=(3, 2, 2)):
    return NDFullMesh(
        dims=tuple(
            DimSpec(f"D{i}", s, PASSIVE_ELECTRICAL, 2) for i, s in enumerate(shape)
        )
    )


class TestNDFullMesh:
    def test_pod_shape(self):
        pod = ub_mesh_pod()
        assert pod.num_nodes == 1024
        assert pod.shape == (8, 8, 4, 4)

    def test_coords_roundtrip(self):
        t = small_mesh()
        for n in range(t.num_nodes):
            assert t.node_id(t.coords(n)) == n

    def test_neighbors_are_single_dim(self):
        t = small_mesh()
        for n in range(t.num_nodes):
            for peer, dim in t.all_neighbors(n):
                assert t.are_adjacent(n, peer) == dim

    def test_link_count_formula(self):
        t = small_mesh((4, 3))
        # dim0: 3 groups * C(4,2)=6 -> 18 ; dim1: 4 groups * C(3,2)=3 -> 12
        assert t.link_count(0) == 18
        assert t.link_count(1) == 12

    def test_hop_distance_is_hamming(self):
        t = small_mesh()
        assert t.hop_distance(0, t.node_id((2, 1, 1))) == 3

    @given(st.integers(0, 1023), st.integers(0, 1023))
    @settings(max_examples=50, deadline=None)
    def test_hop_distance_symmetric_pod(self, u, v):
        pod = ub_mesh_pod()
        assert pod.hop_distance(u, v) == pod.hop_distance(v, u)
        assert pod.hop_distance(u, v) <= pod.ndim


class TestAPR:
    def test_shortest_path_count_is_factorial(self):
        pod = ub_mesh_pod()
        src = 0
        dst = pod.node_id((1, 1, 1, 1))
        paths = apr.shortest_paths(pod, src, dst)
        assert len(paths) == 24  # 4 differing dims -> 4!
        for p in paths:
            assert len(p) == 5
            assert p[0] == src and p[-1] == dst

    @given(st.integers(0, 1023), st.integers(0, 1023))
    @settings(max_examples=30, deadline=None)
    def test_all_paths_valid(self, src, dst):
        pod = ub_mesh_pod()
        for p in apr.all_paths(pod, src, dst):
            assert p[0] == src and p[-1] == dst
            for a, b in zip(p, p[1:]):
                assert pod.are_adjacent(a, b) is not None
            assert len(set(p)) == len(p)  # loop-free

    def test_sr_header_roundtrip(self):
        pod = ub_mesh_pod()
        paths = apr.all_paths(pod, 0, pod.node_id((1, 1, 0, 0)))
        for p in paths[:10]:
            hdr = apr.encode_path(pod, p)
            assert apr.walk_header(pod, p[0], hdr) == p
            assert len(hdr.pack()) == 8
            assert apr.SourceRouteHeader.unpack(hdr.pack()) == hdr

    def test_linear_table_routes(self):
        pod = ub_mesh_pod()
        lrt = apr.LinearRouteTable(pod)
        rng = np.random.default_rng(0)
        for _ in range(50):
            s, d = rng.integers(0, pod.num_nodes, 2)
            path = lrt.route(int(s), int(d))
            assert path[0] == s and path[-1] == d
            assert len(path) - 1 == pod.hop_distance(int(s), int(d))

    def test_linear_table_space_is_linear(self):
        pod = ub_mesh_pod()
        lrt = apr.LinearRouteTable(pod)
        # linear in sum(dims), NOT product: 1024 * (8+8+4+4)
        assert lrt.table_entries() == 1024 * 24

    def test_tfc_deadlock_free_random_traffic(self):
        pod = ub_mesh_pod()
        rng = np.random.default_rng(1)
        paths = []
        for _ in range(100):
            s, d = rng.integers(0, pod.num_nodes, 2)
            if s != d:
                paths.extend(apr.all_paths(pod, int(s), int(d)))
        assert apr.verify_deadlock_free(pod, paths, n_vls=2)

    def test_tfc_admissible_nonempty(self):
        pod = ub_mesh_pod()
        paths = apr.all_paths(pod, 0, pod.node_id((1, 1, 1, 1)))
        adm = apr.tfc_admissible(pod, paths)
        assert len(adm) >= 1
        # the in-dimension-order shortest path is always admissible
        assert any(len(p) == 5 for p, _ in adm)

    def test_reroute_avoids_failed_link(self):
        pod = ub_mesh_pod()
        plan = apr.RoutePlan(pod)
        dst = pod.node_id((1, 1, 0, 0))
        plan.install(0, dst, apr.shortest_paths(pod, 0, dst)[0])
        link = (0, pod.node_id((1, 0, 0, 0)))
        if plan.affected_flows(link):
            fixed = plan.reroute(link)
            for p in fixed.values():
                edges = {tuple(sorted(e)) for e in zip(p, p[1:])}
                assert tuple(sorted(link)) not in edges

    def test_direct_notification_fewer_messages(self):
        pod = ub_mesh_pod()
        plan = apr.RoutePlan(pod)
        rng = np.random.default_rng(2)
        for _ in range(64):
            s, d = rng.integers(0, pod.num_nodes, 2)
            if s != d:
                plan.install(int(s), int(d), apr.shortest_paths(pod, int(s), int(d))[0])
        link = next(iter(plan._by_link))
        direct = plan.direct_notify(link)
        flood = plan.hop_by_hop_notify(link)
        assert len(direct) <= pod.num_nodes
        for src in direct:
            assert direct[src] <= flood[src]


class TestCables:
    def test_table2_ratios(self):
        sp = topology.SuperPod()
        cb = sp.cables_by_link_type(uplink_provisioning=0.25)
        tot = sum(cb.values())
        frac = {k: v / tot for k, v in cb.items()}
        # paper Table 2: 86.7 / 7.2 / 4.8 / 1.2
        assert frac["passive_electrical"] > 0.80
        assert frac["active_electrical"] < 0.12
        assert frac["optical_100m"] + frac["optical_1km"] < 0.10

    def test_switch_and_optics_savings(self):
        sp = topology.SuperPod()
        clos = topology.ClosFabric(8192)
        assert 1 - sp.hrs_count() / clos.hrs_count() > 0.95      # paper: 98%
        assert 1 - sp.optical_modules() / clos.optical_modules() > 0.90  # 93%


# ---------------------------------------------------------------------------
# cross-package: the port's ``core/`` copies against the reference's, by ==
# ---------------------------------------------------------------------------

MESHES = ("rack", "pod", "mixed3", "rect8x4")
SIZES = (64e3, 64e6, 512e6)


def build_mesh(top, name):
    """One of the four meshes, built from the package ``top``
    (``core.topology`` of either side)."""
    if name == "rack":
        return top.ub_mesh_rack()
    if name == "pod":
        return top.ub_mesh_pod()
    if name == "mixed3":
        return top.NDFullMesh(dims=(
            top.DimSpec("D0", 4, top.PASSIVE_ELECTRICAL, 2),
            top.DimSpec("D1", 3, top.ACTIVE_ELECTRICAL, 1),
            top.DimSpec("D2", 2, top.OPTICAL_100M, 2, trunk_width=2),
        ))
    return top.NDFullMesh(dims=(
        top.DimSpec("X", 8, top.PASSIVE_ELECTRICAL, 4),
        top.DimSpec("Y", 4, top.PASSIVE_ELECTRICAL, 4),
    ))


def sample_pairs(n, k, seed):
    rng = np.random.default_rng(seed)
    return [tuple(int(v) for v in rng.integers(0, n, 2)) for _ in range(k)]


class TestCrossPackageTopology:
    @pytest.mark.parametrize("name", MESHES)
    def test_mesh_links_and_counts(self, name):
        def figures(top):
            t = build_mesh(top, name)
            dims = range(t.ndim)
            return {
                "mesh": t, "shape": t.shape, "num_nodes": t.num_nodes,
                "links": [(u, v, d, t.dims[d].link) for u, v, d in t.links()],
                "link_count": [t.link_count(d) for d in dims],
                "cables_by_dim": t.cables_by_dim(),
                "cables_by_link_type": t.cables_by_link_type(),
                "node_gbs": t.node_bandwidth_gbs(),
                "dim_gbs": [t.dim_bandwidth_gbs(d) for d in dims],
                "bisection_gbs": [t.bisection_bandwidth_gbs(d) for d in dims],
                "neighbors": [t.all_neighbors(n) for n in range(0, t.num_nodes, 7)],
                "subgroup": t.subgroup_nodes({0: 1}),
            }
        both("core.topology", figures)

    @pytest.mark.parametrize("name", MESHES)
    def test_hop_distance_matrix(self, name):
        def matrix(top):
            t = build_mesh(top, name)
            n = t.num_nodes
            return [[t.hop_distance(u, v) for v in range(n)] for u in range(n)]
        both("core.topology", matrix)

    def test_superpod_clos_torus_and_views(self):
        def figures(top):
            sp = top.SuperPod()
            out = {"superpod": sp, "nodes": sp.num_nodes, "racks": sp.n_racks,
                   "racks_per_pod": sp.racks_per_pod, "lrs": sp.lrs_count()}
            for prov in (1.0, 0.25):
                out[prov] = (sp.hrs_count(prov), sp.optical_modules(prov),
                             sp.cables_by_link_type(prov))
            for n in (1024, 8192):
                c = top.ClosFabric(n)
                out[n] = (c, c.leaf_count(), c.spine_count(), c.hrs_count(),
                          c.optical_modules(), c.cables_by_link_type())
            tor = top.Torus3D((8, 8, 16))
            out["torus"] = (tor.n_npus, tor.link_count(), tor.node_bandwidth_gbs())
            out["views"] = [top.production_mesh_view(multi_pod=m) for m in (False, True)]
            out["specs"] = top.LINK_SPECS
            return out
        both("core.topology", figures)

    def test_ub_lane_budget(self):
        def figures(ub):
            out = {}
            for name, a in (("default", ub.DEFAULT_ALLOCATION),
                            ("long", ub.LONG_CONTEXT_ALLOCATION)):
                out[name] = (a, a.total, a.intra_rack_gbs(), a.inter_rack_gbs(),
                             [a.bandwidth_gbs(d) for d in "XYZAB"])
            out["rebalanced"] = outcome(ub.DEFAULT_ALLOCATION.rebalance, Z=8, A=8)
            out["over"] = outcome(ub.DEFAULT_ALLOCATION.rebalance, X=40)
            return out
        both("core.ub", figures)


class TestCrossPackageAPR:
    @pytest.mark.parametrize("name", MESHES)
    def test_paths_and_tfc(self, name):
        def figures(top, apr):
            t = build_mesh(top, name)
            out = []
            for s, d in sample_pairs(t.num_nodes, 12, seed=3):
                sp = apr.shortest_paths(t, s, d)
                ap = apr.all_paths(t, s, d)
                out.append((s, d, sp, ap, apr.path_diversity(t, s, d),
                            apr.tfc_admissible(t, ap), apr.detour_paths(t, s, d)))
            return out
        both("core.topology core.apr", figures)

    def test_headers_tables_and_recovery(self):
        def figures(top, apr):
            pod = top.ub_mesh_pod()
            lrt = apr.LinearRouteTable(pod)
            pairs = sample_pairs(pod.num_nodes, 16, seed=4)
            out = {"entries": lrt.table_entries(),
                   "routes": [lrt.route(s, d) for s, d in pairs]}
            ps = apr.all_paths(pod, 0, pod.node_id((1, 1, 0, 0)))[:10]
            out["headers"] = [apr.encode_path(pod, p).pack() for p in ps]
            out["walks"] = [apr.walk_header(pod, p[0], apr.encode_path(pod, p)) for p in ps]
            paths = [p for s, d in pairs if s != d for p in apr.all_paths(pod, s, d)]
            out["deadlock_free"] = apr.verify_deadlock_free(pod, paths, n_vls=2)
            plan = apr.RoutePlan(pod)
            for s, d in pairs:
                if s != d:
                    plan.install(s, d, apr.shortest_paths(pod, s, d)[0])
            link = sorted(plan._by_link)[0]
            out["direct"] = plan.direct_notify(link)
            out["flood"] = plan.hop_by_hop_notify(link)
            out["reroute"] = plan.reroute(link)
            out["plan"] = plan
            return out
        both("core.topology core.apr", figures)


class TestCrossPackageMultiRing:
    @pytest.mark.parametrize("name", MESHES)
    def test_plan_multiring_every_dim(self, name):
        def figures(top, mr):
            t = build_mesh(top, name)
            out = []
            for d in range(t.ndim):
                p = mr.plan_multiring(t, d)
                out.append((p, p.links_used, p.links_total, p.utilization,
                            p.effective_bandwidth_gbs(),
                            [p.allreduce_wire_bytes_per_chip(int(s)) for s in SIZES],
                            [p.allreduce_time_s(int(s)) for s in SIZES],
                            mr.single_ring_bandwidth_gbs(t, d),
                            mr.borrowed_bandwidth_gbs(t, d, borrow_lanes=8)))
            if t.ndim >= 2:
                out.append(mr.grid_effective_bandwidth_gbs(t, (0, 1)))
            return out
        both("core.topology core.multiring", figures)

    @pytest.mark.parametrize("xy", [(8, 8), (4, 4), (8, 4)])
    def test_grid_ring_decomposition(self, xy):
        ref, port = pkgs("core.multiring")
        a = outcome(ref.grid_ring_decomposition, *xy)
        assert a == outcome(port.grid_ring_decomposition, *xy)
        assert a[0] == ("raised" if xy == (8, 4) else "ok")
        if xy == (8, 4):
            errs = []
            for m in (ref, port):
                with pytest.raises(m.UnsupportedGridError) as ei:
                    m.grid_ring_decomposition(*xy)
                errs.append((ei.value.x, ei.value.y, str(ei.value)))
            assert errs[0] == errs[1]


class TestCrossPackageFigures:
    @pytest.mark.parametrize("name", ("rack", "mixed3", "rect8x4"))
    def test_alltoall(self, name):
        def figures(top, a2a):
            t = build_mesh(top, name)
            out = {}
            for split in (True, False):
                r = a2a.multipath_a2a_loads(t, 1e6, split=split)
                out[split] = (r, r.balance)
                out[("perm", split)] = a2a.permutation_a2a_pair_bandwidth(t, multipath=split)
                out[("time", split)] = a2a.a2a_time_s(t, 1e6, multipath=split)
            for nc, k in ((4, 2), (8, 2), (16, 8)):
                rep = a2a.hierarchical_moe_dispatch(nc, k, 4096.0)
                out[(nc, k)] = (rep, [r.total for r in rep], a2a.moe_dispatch_savings(nc, k))
            return out
        both("core.topology core.alltoall", figures)

    def test_capex(self):
        def figures(top, cx):
            boms = [cx.superpod_bom(top.SuperPod()),
                    cx.superpod_bom(top.SuperPod(n_pods=4), uplink_provisioning=0.25),
                    cx.ub_mesh_bom(), cx.clos_bom(),
                    cx.hybrid_bom(fm_dims=2), cx.hybrid_bom(fm_dims=1)]
            out = [(b, b.capex(), b.network_capex(), b.network_share(), b.power(),
                    b.opex(), b.tco()) for b in boms]
            ce = cx.compare_architectures()
            out.append([(c, c.tco, c.cost_efficiency) for c in ce])
            clos = ce[-1]
            out.append([c.cost_efficiency / clos.cost_efficiency for c in ce])
            out.append([(c.capex / clos.capex, c.opex / clos.opex) for c in ce])
            return out
        both("core.topology core.capex", figures)

    def test_availability_table6(self):
        def figures(av):
            out = {}
            for b in (av.PAPER_UB_MESH, av.PAPER_CLOS, *av.derived_afr(8192),
                      *av.derived_afr(1024)):
                out[b.name, b.total] = (b, b.mtbf_hours,
                                        b.availability(av.PAPER_MTTR_HOURS),
                                        b.availability(av.FAST_MTTR_HOURS))
            out["gap"] = (av.PAPER_UB_MESH.availability(av.PAPER_MTTR_HOURS)
                          - av.PAPER_CLOS.availability(av.PAPER_MTTR_HOURS))
            b = av.BackupAnalysis()
            out["backup"] = (b.rack_failure_rate_no_backup(),
                             b.rack_failure_rate_with_backup(),
                             b.rack_failure_rate_with_backup(72.0),
                             b.capacity_loss_improvement(),
                             b.redirected_path_penalty_hops())
            return out
        both("core.availability", figures)

    @pytest.mark.parametrize("model", ["shortest", "detour", "borrow", "detour-multi-pod",
                                       "lanes-32", "clos", "clos-multi-pod"])
    def test_comm_model_collective_times(self, model):
        def figures(cm):
            if model.startswith("clos"):
                m = cm.clos_comm_model(multi_pod=model.endswith("multi-pod"))
            elif model == "lanes-32":
                m = cm.build_comm_model(inter_rack_lanes=32)
            else:
                m = cm.build_comm_model(multi_pod=model.endswith("multi-pod"),
                                        routing=cm.Routing(model.split("-")[0]))
            out = {"model": m, "backend": m.backend}
            for axis in m.axes:
                for s in SIZES:
                    out[axis, s] = (m.allreduce(axis, s), m.reduce_scatter(axis, s),
                                    m.all_gather(axis, s), m.all_to_all(axis, s),
                                    m.p2p(axis, s))
            for s in SIZES:
                out["hier", s] = m.hierarchical_allreduce(list(m.axes), s)
            return out
        both("core.cost_model", figures)

    @pytest.mark.parametrize("pair", ["moe-2t", "dense-70b-tp8"])
    def test_analyze_traffic(self, pair):
        def figures(tr):
            if pair == "moe-2t":
                w, p = tr.moe_2t_workload()
            else:
                w = tr.backend_comparison_workloads()[0]
                p = tr.ParallelSpec(tp=8, sp=4, pp=4, dp=16)
            t = tr.analyze_traffic(w, p)
            techs = sorted({e.technique for e in t.entries})
            return (w, p, p.chips, t, t.total_bytes, t.local_share(),
                    [t.share(k) for k in techs],
                    [(e.shape, e.volume_mb, e.total_gb) for e in t.entries])
        both("core.traffic", figures)
