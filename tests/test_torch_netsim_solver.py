"""The reference's ``tests/test_netsim_solver.py`` restated against the
port's ``repro_torch.netsim``, every case.

Parity suite: vectorized max-min solver vs the pure-Python reference.

The vectorized numpy water-filling (``netsim/solver.py``) must reproduce
the reference progressive filling's rates to 1e-6 on randomized
topologies and flow sets — including receiver-egress (incast) caps,
per-dim IO caps, link failures and aggregate flows — and whole DAG runs
must produce identical completion times under either solver and under
aggregate-vs-expanded ring-step execution.

Also pins the freeze-tolerance regression: the old absolute ``+ 1e-9``
epsilon over-froze links whose fair share is itself ~1e-9 bytes/s.
"""

import math
import random

import pytest

from repro_torch.core.cost_model import Routing
from repro_torch.core.topology import (
    ACTIVE_ELECTRICAL,
    DimSpec,
    NDFullMesh,
    PASSIVE_ELECTRICAL,
    ub_mesh_rack,
)
from repro_torch.netsim import FluidNetwork, NetSim, ring_allreduce
from repro_torch.netsim.collectives import clique_nodes, hierarchical_allreduce
from repro_torch.netsim.solver import SOLVERS


def _random_topo(rng: random.Random) -> NDFullMesh:
    ndim = rng.randint(1, 3)
    dims = tuple(
        DimSpec(
            f"D{i}",
            rng.randint(2, 5),
            PASSIVE_ELECTRICAL if i < 2 else ACTIVE_ELECTRICAL,
            rng.choice((1, 2, 4)),
        )
        for i in range(ndim)
    )
    return NDFullMesh(dims=dims)


def _random_path(topo: NDFullMesh, rng: random.Random) -> tuple[int, ...]:
    """A random dimension-hopping walk of 1-3 hops (every hop is a direct
    full-mesh link)."""
    node = rng.randrange(topo.num_nodes)
    path = [node]
    for _ in range(rng.randint(1, 3)):
        c = list(topo.coords(path[-1]))
        d = rng.randrange(topo.ndim)
        choices = [v for v in range(topo.shape[d]) if v != c[d]]
        c[d] = rng.choice(choices)
        nxt = topo.node_id(c)
        if nxt != path[-1]:
            path.append(nxt)
    return tuple(path)


def _pair_networks(topo, rng, *, rx_gbs=None, dim_io_gbs=None, n_flows=24):
    """Two FluidNetworks (reference / vectorized) loaded with the same
    random flow set; returns (ref_net, vec_net, flows_per_net)."""
    nets = [
        FluidNetwork(topo, rx_gbs=rx_gbs, dim_io_gbs=dim_io_gbs, solver=s)
        for s in ("reference", "vectorized")
    ]
    paths = []
    for _ in range(n_flows):
        p = _random_path(topo, rng)
        if len(p) >= 2:
            paths.append((p, rng.uniform(1e6, 1e9)))
    for net in nets:
        for p, size in paths:
            net.add_flow(p, size)
    return nets[0], nets[1]


def _assert_rates_match(ref: FluidNetwork, vec: FluidNetwork, tol=1e-6):
    ref._recompute()
    vec._recompute()
    assert set(ref.flows) == set(vec.flows)
    for fid, rf in ref.flows.items():
        vf = vec.flows[fid]
        scale = max(abs(rf.rate), abs(vf.rate), 1e-30)
        assert abs(rf.rate - vf.rate) / scale <= tol, (
            f"flow {fid} on {rf.path}: ref={rf.rate} vec={vf.rate}"
        )


class TestSolverParity:
    @pytest.mark.parametrize("seed", range(8))
    def test_random_flow_sets_match_reference(self, seed):
        rng = random.Random(seed)
        topo = _random_topo(rng)
        ref, vec = _pair_networks(topo, rng)
        _assert_rates_match(ref, vec)

    @pytest.mark.parametrize("seed", range(4))
    def test_incast_rx_caps_match_reference(self, seed):
        rng = random.Random(1000 + seed)
        topo = _random_topo(rng)
        ref, vec = _pair_networks(topo, rng, rx_gbs=rng.uniform(1.0, 20.0))
        _assert_rates_match(ref, vec)

    @pytest.mark.parametrize("seed", range(4))
    def test_link_failure_match_reference(self, seed):
        rng = random.Random(2000 + seed)
        topo = _random_topo(rng)
        ref, vec = _pair_networks(topo, rng)
        links = [l for l in ref.capacity if l[0] < l[1]]
        u, v = rng.choice(links)
        ref.fail_link(u, v)
        vec.fail_link(u, v)
        _assert_rates_match(ref, vec)

    def test_dim_io_caps_match_reference(self):
        rng = random.Random(42)
        topo = _random_topo(rng)
        ref, vec = _pair_networks(
            topo, rng, dim_io_gbs={topo.ndim - 1: 3.0}
        )
        _assert_rates_match(ref, vec)

    def test_aggregate_flows_match_reference(self):
        topo = ub_mesh_rack()
        nodes = clique_nodes(topo, 0)
        pairs = tuple(
            (nodes[i], nodes[(i + 1) % len(nodes)]) for i in range(len(nodes))
        )
        nets = [FluidNetwork(topo, solver=s) for s in ("reference", "vectorized")]
        for net in nets:
            net.add_aggregate_flow(pairs, 8e6)
            net.add_flow((nodes[0], nodes[1]), 4e6)   # contends with member 0
        _assert_rates_match(*nets)

    @pytest.mark.parametrize("solver", sorted(SOLVERS))
    def test_full_run_times_identical_across_solvers(self, solver):
        # same DAG, either solver: identical completion times (the solvers
        # are exact, not approximations of each other)
        topo = ub_mesh_rack()
        dag = hierarchical_allreduce(topo, (0, 1), 16e6)
        r = NetSim(topo, routing=Routing.DETOUR, solver=solver).run_dag(dag)
        ref = NetSim(topo, routing=Routing.DETOUR, solver="reference").run_dag(dag)
        assert r.incomplete == 0
        for tid, t in ref.task_end_s.items():
            assert r.task_end_s[tid] == pytest.approx(t, rel=1e-6)

    @pytest.mark.slow
    def test_reference_solver_pod_clique_crossval(self):
        # the reference slow path still reproduces the analytic multi-ring
        # number on a pod-scale clique (the crossval contract)
        from repro_torch.core.multiring import plan_multiring
        from repro_torch.core.topology import ub_mesh_pod

        topo = ub_mesh_pod()
        sim = NetSim(topo, routing=Routing.DETOUR, solver="reference")
        t = sim.allreduce_time(0, 48e6)
        ta = plan_multiring(topo, 0).allreduce_time_s(48e6)
        assert abs(t - ta) / ta <= 0.15


class TestAggregateExecution:
    """Aggregate ring steps vs per-pair expansion: same physics."""

    @pytest.mark.parametrize("solver", sorted(SOLVERS))
    def test_ring_allreduce_aggregate_equals_expanded(self, solver):
        topo = ub_mesh_rack()
        nodes = clique_nodes(topo, 0)
        dag = ring_allreduce(topo, nodes, 32e6)
        agg = NetSim(topo, solver=solver, aggregate=True).run_dag(dag)
        exp = NetSim(topo, solver=solver, aggregate=False).run_dag(dag)
        assert agg.incomplete == 0 and exp.incomplete == 0
        assert agg.makespan_s == pytest.approx(exp.makespan_s, rel=1e-9)
        assert agg.bytes_delivered == pytest.approx(exp.bytes_delivered)

    def test_grid_allreduce_aggregate_equals_expanded(self):
        from repro_torch.netsim.collectives import grid_allreduce

        topo = ub_mesh_rack()
        dag = grid_allreduce(topo, (0, 1), 64e6)
        agg = NetSim(topo, aggregate=True).run_dag(dag)
        exp = NetSim(topo, aggregate=False).run_dag(dag)
        assert agg.makespan_s == pytest.approx(exp.makespan_s, rel=1e-9)

    def test_failure_injection_expands_and_completes(self):
        # fail_link runs force per-pair expansion so APR rerouting stays
        # live; every task must still finish
        topo = ub_mesh_rack()
        nodes = clique_nodes(topo, 0)
        dag = ring_allreduce(topo, nodes, 16e6)
        sim = NetSim(topo, routing=Routing.DETOUR)
        healthy = sim.run_dag(dag)
        failed = sim.run_dag(
            dag,
            fail_link=(nodes[1], nodes[2]),
            fail_at_s=healthy.makespan_s / 3,
        )
        assert failed.incomplete == 0
        assert failed.makespan_s >= healthy.makespan_s * 0.999


class TestFreezeTolerance:
    """Regression: the freeze level must be RELATIVE to the round's best
    share.  The old absolute ``+ 1e-9`` epsilon froze every link whose
    share was within 1e-9 bytes/s of the minimum — at nano-scale
    capacities that is *every* link, collapsing distinct fair shares."""

    @pytest.mark.parametrize("solver", sorted(SOLVERS))
    def test_tiny_capacities_keep_distinct_fair_shares(self, solver):
        topo = NDFullMesh(
            dims=(DimSpec("X", 3, PASSIVE_ELECTRICAL, 1),)
        )
        net = FluidNetwork(topo, solver=solver)
        # shrink two links into the nano-bytes/s regime with distinct caps
        net.capacity[(0, 1)] = 1.0e-9
        net.capacity[(0, 2)] = 1.5e-9
        net.solver.capacity_changed()
        f1 = net.add_flow((0, 1), 1.0)
        f2 = net.add_flow((0, 2), 1.0)
        net._recompute()
        assert f1.rate == pytest.approx(1.0e-9, rel=1e-6)
        # the old absolute epsilon froze f2 at 1.0e-9 as well
        assert f2.rate == pytest.approx(1.5e-9, rel=1e-6)

    @pytest.mark.parametrize("solver", sorted(SOLVERS))
    def test_shared_tiny_link_splits_fairly(self, solver):
        topo = NDFullMesh(
            dims=(DimSpec("X", 2, PASSIVE_ELECTRICAL, 1),)
        )
        net = FluidNetwork(topo, solver=solver)
        net.capacity[(0, 1)] = 4e-9
        net.solver.capacity_changed()
        flows = [net.add_flow((0, 1), 1.0) for _ in range(4)]
        net._recompute()
        for f in flows:
            assert f.rate == pytest.approx(1e-9, rel=1e-6)


class TestLazyLinkBytes:
    """The per-link byte ledger is credited lazily (on completion /
    withdrawal / read), but must stay exact whenever it is read."""

    def test_mid_run_read_includes_in_flight_progress(self):
        topo = ub_mesh_rack()
        net = FluidNetwork(topo)
        net.add_flow((0, 1), 25e9)          # 1 s at the 25 GB/s X link
        net.engine.schedule(0.5, lambda: None)
        net.run(until=0.5)                   # halfway through the flow
        assert net.link_bytes[(0, 1)] == pytest.approx(12.5e9, rel=1e-9)
        net.run()
        assert net.link_bytes[(0, 1)] == pytest.approx(25e9, rel=1e-9)

    def test_multi_hop_flow_credits_every_link(self):
        topo = ub_mesh_rack()
        net = FluidNetwork(topo)
        path = (0, 1, 9)                    # X hop then Y hop
        net.add_flow(path, 5e9)
        net.run()
        for l in zip(path, path[1:]):
            assert net.link_bytes[l] == pytest.approx(5e9, rel=1e-9)

    def test_aggregate_members_credit_their_own_links(self):
        topo = ub_mesh_rack()
        nodes = clique_nodes(topo, 0)
        pairs = tuple((nodes[i], nodes[i + 1]) for i in range(4))
        net = FluidNetwork(topo)
        net.add_aggregate_flow(pairs, 2e9)
        net.run()
        for l in pairs:
            assert net.link_bytes[l] == pytest.approx(2e9, rel=1e-9)
        assert net.bytes_delivered == pytest.approx(8e9, rel=1e-9)


class TestDimIOCaps:
    """Per-dim per-node IO caps: the switched-tier (HRS) constraint."""

    def test_fanout_over_capped_dim_serializes(self):
        # 3 concurrent sends out of node 0 across the capped dim: per-pair
        # capacity alone would run all three at full rate; the IO cap
        # must squeeze them to a third each
        topo = NDFullMesh(dims=(DimSpec("P", 4, ACTIVE_ELECTRICAL, 8),))
        per_peer = topo.dims[0].gbs_per_peer
        net = FluidNetwork(topo, dim_io_gbs={0: per_peer})
        flows = [net.add_flow((0, v), 1e9) for v in (1, 2, 3)]
        net._recompute()
        for f in flows:
            assert f.rate == pytest.approx(per_peer * 1e9 / 3, rel=1e-9)

    def test_single_pair_bursts_full_uplink(self):
        topo = NDFullMesh(dims=(DimSpec("P", 4, ACTIVE_ELECTRICAL, 8),))
        per_peer = topo.dims[0].gbs_per_peer
        net = FluidNetwork(topo, dim_io_gbs={0: per_peer})
        f = net.add_flow((0, 1), 1e9)
        net._recompute()
        assert f.rate == pytest.approx(per_peer * 1e9, rel=1e-9)
