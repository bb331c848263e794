"""The port's copy of ``netsim/`` held against the reference's by ``==``: the
same scenario, built in each package from the same arguments, gives the same
``NetSimResult`` fields, DAGs, per-flow rates, calibration profiles,
coarse and mixed profiles, telemetry summary and Perfetto JSON."""

import json

import numpy as np
import pytest

from _torch_netsim_parity import outcome, pkgs, plain

ROUTINGS = ("shortest", "detour", "borrow")


class Side:
    """One package's copies of the modules a scenario needs."""

    def __init__(self, root):
        import importlib

        def mod(name):
            return importlib.import_module(f"{root}.{name}")

        self.root = root
        self.top = mod("core.topology")
        self.cm = mod("core.cost_model")
        self.traffic = mod("core.traffic")
        self.netsim = mod("netsim")
        self.col = mod("netsim.collectives")
        self.scen = mod("netsim.scenarios")
        self.coarsen = mod("netsim.coarsen")
        self.api = mod("netsim.api")
        self.flows = mod("netsim.flows")
        self.solver = mod("netsim.solver")


SIDES = (Side("repro"), Side("repro_torch"))


def result_fields(r):
    """Every field of a ``NetSimResult`` but the telemetry recorder, with its
    two derived figures."""
    d = {f: plain(getattr(r, f)) for f in r.__dataclass_fields__ if f != "telemetry"}
    d["max_link_utilization"] = r.max_link_utilization
    d["iteration_comm_s"] = r.iteration_comm_s
    return d


def same(fn):
    """``fn(side)`` on each package; the two results equal, returned."""
    ref, port = (outcome(fn, s) for s in SIDES)
    assert ref[0] == "ok", ref
    assert ref == port
    return ref[1]


def test_readme_quick_start():
    def run(s):
        sim = s.netsim.NetSim(s.top.ub_mesh_rack(), routing=s.cm.Routing.DETOUR)
        return sim.allreduce_time(dim=0, size_bytes=64e6)
    t = same(run)
    assert t > 0


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("pattern", ["hotspot", "trunk_congestion", "trunk_failure"])
def test_scenarios(pattern, routing):
    def run(s):
        R = s.cm.Routing(routing)
        if pattern == "hotspot":
            topo = s.scen.inter_rack_mesh()
            dag = s.scen.hotspot_dag(topo)
            sim = s.netsim.NetSim(topo, routing=R)
            return dag, result_fields(sim.run_dag(dag))
        tc = s.scen.trunk_congestion()
        sim = s.netsim.NetSim(tc.topo, routing=R, rx_gbs=tc.rx_gbs)
        if pattern == "trunk_congestion":
            return tc.dag, tc.hot_link, tc.rx_gbs, result_fields(sim.run_dag(tc.dag))
        r = sim.run_dag(tc.dag, fail_link=tc.hot_link, fail_at_s=1e-4)
        return result_fields(r), plain(sim.last_network.link_bytes)
    same(run)


@pytest.mark.parametrize("dag_kind", ["ring_x", "ring_y", "grid", "hierarchical",
                                      "hierarchical_all_gather", "multipath_a2a",
                                      "ring_reduce_scatter"])
def test_allreduce_dags(dag_kind):
    def run(s):
        topo = s.top.ub_mesh_rack()
        c = s.col
        if dag_kind == "ring_x":
            dag = c.ring_allreduce(topo, c.clique_nodes(topo, 0), 32e6, tag="x")
        elif dag_kind == "ring_y":
            dag = c.ring_allreduce(topo, c.clique_nodes(topo, 1, {0: 3}), 32e6, tag="y")
        elif dag_kind == "grid":
            dag = c.grid_allreduce(topo, (0, 1), 64e6, tag="g")
        elif dag_kind == "hierarchical":
            dag = c.hierarchical_allreduce(topo, (0, 1), 64e6, tag="h")
        elif dag_kind == "hierarchical_all_gather":
            dag = c.hierarchical_all_gather(topo, (0, 1), 16e6, tag="hg")
        elif dag_kind == "multipath_a2a":
            group = c.clique_nodes(topo, 0)
            dag = c.multipath_all_to_all(topo, group, 1e6, tag="a")
        else:
            dag = c.ring_reduce_scatter(topo, c.clique_nodes(topo, 0), 32e6, tag="rs")
        sims = [s.netsim.NetSim(topo, routing=s.cm.Routing.DETOUR),
                s.netsim.NetSim(topo, routing=s.cm.Routing.DETOUR, solver="reference")]
        if dag_kind != "grid":          # the plane's rings expanded pair by pair: slow
            sims.append(s.netsim.NetSim(topo, routing=s.cm.Routing.DETOUR, aggregate=False))
        return dag, dag.total_bytes, dag.frontier(), [result_fields(m.run_dag(dag)) for m in sims]
    same(run)


def test_moe_incast_auto_rx():
    def run(s):
        topo = s.top.ub_mesh_rack()
        dag = s.col.moe_dispatch(topo, list(range(topo.num_nodes)),
                                 s.col.model_group(topo, 4), 16e6)
        sim = s.netsim.NetSim(topo, routing=s.cm.Routing.DETOUR, rx_gbs="auto")
        blind = s.netsim.NetSim(topo, routing=s.cm.Routing.DETOUR, rx_gbs=None)
        return (dag, sim.rx_gbs, s.flows.default_rx_gbs(topo),
                result_fields(sim.run_dag(dag)), result_fields(blind.run_dag(dag)))
    same(run)


def test_message_level():
    def run(s):
        topo = s.top.ub_mesh_rack()
        c = s.col
        dags = [c.ring_allreduce(topo, c.clique_nodes(topo, 0), 64e3, tag="r"),
                c.hierarchical_allreduce(topo, (0, 1), 64e3, tag="h"),
                c.multipath_all_to_all(topo, c.clique_nodes(topo, 1), 8e3, tag="a")]
        sim = s.netsim.NetSim(topo, routing=s.cm.Routing.DETOUR, message_level=True,
                              dim_latency_s={1: 2e-6})
        out = [result_fields(sim.run_dag(d)) for d in dags]
        out.append([result_fields(r) for r in sim.run_dags(dags)])
        out.append(plain(s.netsim.NetSim(topo).measure_latency_profile(64e3)))
        return out
    same(run)


def test_workload_run():
    def run(s):
        top = s.top
        topo = top.NDFullMesh(dims=(
            top.DimSpec("X", 4, top.PASSIVE_ELECTRICAL, 4),
            top.DimSpec("Y", 2, top.PASSIVE_ELECTRICAL, 4),
            top.DimSpec("Z", 2, top.ACTIVE_ELECTRICAL, 2),
            top.DimSpec("A", 2, top.OPTICAL_100M, 2),
        ))
        w = s.traffic.WorkloadSpec(
            name="tiny-moe", n_layers=4, hidden=1024, n_heads=8, head_dim=64,
            seq_len=4096, global_batch=16, params_total=1e9, n_experts=4, topk=2)
        p = s.traffic.ParallelSpec(tp=4, sp=2, pp=2, dp=2, ep=2, microbatches=4)
        return (result_fields(s.netsim.NetSim(topo, routing=s.cm.Routing.DETOUR).run(w, p)),
                s.col.compile_workload(topo, w, p))
    same(run)


def test_link_failure():
    def run(s):
        rack = s.top.ub_mesh_rack()
        nodes = s.col.clique_nodes(rack, 0)
        dag = s.col.ring_allreduce(rack, nodes, 32e6)
        sim = s.netsim.NetSim(rack, routing=s.cm.Routing.DETOUR)
        out = [result_fields(sim.run_dag(dag, fail_link=(nodes[0], nodes[1]),
                                         fail_at_s=5e-4))]
        dead = s.netsim.NetSim(rack, failed_links=((nodes[2], nodes[3]),))
        out.append(plain(dead.calibrated_profile(8e6, axes=("model",), widths={"model": 8})))
        return out
    same(run)


def test_solver_rates_per_flow():
    """The same random flow set on each package's two solvers: every flow's
    rate equal across packages, solver by solver, and the two solvers
    within 1e-6 of each other (the reference's own parity bar)."""
    rng = np.random.default_rng(11)
    topo_shape = (4, 3, 2)
    n_nodes = int(np.prod(topo_shape))
    flows = []
    while len(flows) < 40:
        a, b, c = (int(v) for v in rng.integers(0, n_nodes, 3))
        flows.append((a, b, c, float(rng.uniform(1e6, 1e9))))

    def run(s):
        top = s.top
        topo = top.NDFullMesh(dims=(
            top.DimSpec("D0", 4, top.PASSIVE_ELECTRICAL, 4),
            top.DimSpec("D1", 3, top.PASSIVE_ELECTRICAL, 2),
            top.DimSpec("D2", 2, top.ACTIVE_ELECTRICAL, 1),
        ))
        out = {}
        for solver in ("reference", "vectorized"):
            net = s.flows.FluidNetwork(topo, rx_gbs=30.0, dim_io_gbs={2: 8.0}, solver=solver)
            for a, b, c, size in flows:
                # a walk a -> b -> c, each hop a direct link of one dim
                path = [a]
                for nxt in (b, c):
                    ca, cn = topo.coords(path[-1]), topo.coords(nxt)
                    for d in range(topo.ndim):
                        if ca[d] != cn[d]:
                            ca = ca[:d] + (cn[d],) + ca[d + 1:]
                            path.append(topo.node_id(ca))
                if len(path) >= 2 and len(set(path)) == len(path):
                    net.add_flow(tuple(path), size)
            net._recompute()
            out[solver] = {fid: (f.path, f.rate) for fid, f in net.flows.items()}
            net.run()
            out[solver, "end"] = (net.engine.now, plain(net.link_bytes), net.bytes_delivered)
        return out
    out = same(run)
    ref, vec = out["reference"], out["vectorized"]
    assert len(ref) >= 20 and ref.keys() == vec.keys()
    for fid in ref:
        r, v = ref[fid][1], vec[fid][1]
        assert abs(r - v) <= 1e-6 * max(abs(r), abs(v), 1e-30)
    assert out["reference", "end"][0] == pytest.approx(out["vectorized", "end"][0], rel=1e-6)


def test_calibrated_profile_rack():
    def run(s):
        sim = s.netsim.NetSim(s.top.ub_mesh_rack(), routing=s.cm.Routing.DETOUR)
        comm = s.cm.build_comm_model(routing=s.cm.Routing.DETOUR)
        prof = sim.calibrated_profile(64e6, comm=comm)
        narrow = sim.calibrated_profile(16e6, widths={"model": 16, ("model", "all_to_all"): 8})
        return (prof, prof.apply(comm), narrow, sim.calibrated_axis_gbs(4e6),
                sim.can_batch_calibration(), sim.a2a_group_cap((0, 1)))
    same(run)


def test_profile_batch_and_cross_topology():
    def run(s):
        rack = s.top.ub_mesh_rack()
        sim = s.netsim.NetSim(rack, routing=s.cm.Routing.DETOUR)
        reqs = [("model", "allreduce", 8), ("model", "allreduce", 16),
                ("model", "all_to_all", 8), ("model", "all_gather", None)]
        stats = {}
        batch = sim.measure_profile_batch(8e6, reqs, axis_sizes={"model": 64}, stats=stats)
        top = s.top
        other = top.NDFullMesh(dims=(
            top.DimSpec("X", 4, top.PASSIVE_ELECTRICAL, 4),
            top.DimSpec("Y", 4, top.PASSIVE_ELECTRICAL, 4),
        ))
        jobs = [(sim, 8e6, reqs, {"model": 64}),
                (s.netsim.NetSim(other, routing=s.cm.Routing.DETOUR), 8e6,
                 [("model", "allreduce", 4), ("model", "allreduce", None)], {"model": 16})]
        xstats = {}
        cross = s.api.measure_cross_topology(jobs, stats=xstats)
        return batch, stats, cross, xstats
    same(run)


def test_coarse_and_mixed_profiles():
    def run(s):
        sp = s.top.SuperPod(pod=s.top.ub_mesh_pod(), n_pods=4)
        cm = s.coarsen.coarsen_superpod(sp)
        coarse = s.coarsen.coarse_calibrated_profile(
            cm, 64e6, axis_sizes={"pod": 4}, axes=("pod", "data"),
            shapes=("allreduce", "all_to_all"))
        mixed = s.coarsen.coarsen_superpod(sp, detail_racks=(0,))
        prof = s.coarsen.mixed_calibrated_profile(
            mixed, 8e6, axes=("model",), shapes=("allreduce", "all_to_all"),
            background_per_chip_bytes=8e6)
        idle = s.coarsen.mixed_calibrated_profile(
            mixed, 8e6, axes=("model",), shapes=("allreduce",))
        return (cm.topo, cm.chips_per_node, cm.num_chips, coarse,
                mixed.topo.num_nodes, mixed.topo.dims, mixed.topo.detail_base,
                mixed.topo.node_rx_gbs, mixed.topo._gbs, mixed.dim_io_gbs, prof, idle,
                s.coarsen.cross_pod_background_dag(mixed, 8e6))
    same(run)


def test_telemetry_summary_and_perfetto(tmp_path):
    def run(s):
        tc = s.scen.trunk_congestion()
        sim = s.netsim.NetSim(tc.topo, routing=s.cm.Routing.SHORTEST, rx_gbs=tc.rx_gbs,
                              telemetry=True)
        r = sim.run_dag(tc.dag, fail_link=tc.hot_link, fail_at_s=2e-4)
        path = tmp_path / f"{s.root}.json"
        doc = r.telemetry.to_perfetto(str(path))
        return (result_fields(r), r.telemetry.summary(), r.telemetry.summary(top=3),
                doc, json.loads(path.read_text()))
    out = same(run)
    text = json.dumps(out[3])
    assert "repro" not in text and "repro" not in json.dumps(out[1])


def test_versioned_constants():
    def run(s):
        return (s.solver.SOLVER_VERSION, s.api.CALIBRATION_SCHEMA_VERSION,
                sorted(s.solver.SOLVERS), s.cm.COLLECTIVE_SHAPES, s.cm.LATENCY_SHAPES,
                s.cm.A2A_CALIBRATION_MAX_NODES)
    same(run)


COPIES = ["core/topology.py", "core/ub.py", "core/traffic.py", "core/apr.py", "core/multiring.py",
          "core/alltoall.py", "core/capex.py", "core/availability.py", "core/cost_model.py",
          "netsim/__init__.py", "netsim/events.py", "netsim/solver.py", "netsim/flows.py",
          "netsim/telemetry.py", "netsim/collectives.py", "netsim/routing.py", "netsim/messages.py",
          "netsim/scenarios.py", "netsim/api.py", "netsim/coarsen.py", "runtime/elastic.py",
          "runtime/fault_tolerance.py", "core/calib_cache.py", "core/perf_model.py",
          "core/simulator.py", "core/planner.py", "core/codesign.py", "runtime/campaign.py"]


# The port's wording of the reference's comment lines that name the change
# request they came from (program files of the port name none).
REWORDED = {
    "netsim/coarsen.py": ["is byte-for-byte the first pure-coarse construction (regression-pinned)."],
    "netsim/collectives.py": ["    propagating diagonally as the earlier per-position deps did — a slightly"],
    "netsim/solver.py": ['    """Pure-Python progressive filling (the first implementation).'],
    "core/perf_model.py": ["    earlier AllReduce-proxy backend, where every collective is priced on"],
}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_reference_but_the_package_name(rel):
    """Each copy is the reference's file with the package's name changed
    (its imports, and where its docstring names the package), a first
    paragraph naming its original, and the lines of ``REWORDED`` in place
    of lines that name a change request: nothing else."""
    import pathlib
    import re

    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    port = (src / "repro_torch" / rel).read_text()
    ref = (src / "repro" / rel).read_text().split("\n")
    head, _, body = port.partition("\n\n")
    assert head.startswith(f'"""The port\'s own copy of ``repro/{rel}``')
    body = ('"""' + body.replace("repro_torch", "repro")).split("\n")
    assert len(body) == len(ref)
    apart = [(r, b) for r, b in zip(ref, body) if r != b]
    assert [b for _, b in apart] == REWORDED.get(rel, [])
    assert all(re.search(r"\bPR-\d+", r) for r, _ in apart)
