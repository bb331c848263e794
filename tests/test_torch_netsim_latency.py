"""The reference's ``tests/test_netsim_latency.py`` restated against the
port's ``repro_torch.netsim``, ``core.perf_model`` and ``launch.serve``'s
decode-serving simulator.

Message-level latency mode + SLO-driven decode serving.

Covers the message-level contract end to end:

* ``MessageNetwork`` — store-and-forward pricing: exact closed forms on
  idle links, FIFO queueing behind busy links, ejection-port incast
  serialization, bit-identical determinism;
* ``NetSim(message_level=True)`` — same FlowDAG compiler, per-task
  latency distributions, fluid-divergence on small payloads, and the
  hard mode-off guarantee: ``message_level=False`` is bit-identical to a
  default-constructed sim across a seeded collective corpus;
* ``NetsimPerfModel.latency_profile`` — memoization, persistent-store
  round-trip, width canonicalization, failed-links rejection;
* ``launch.serve`` — the continuous-batching simulator's conservation /
  queueing behavior and the bandwidth-vs-SLO planning divergence.
"""

import pytest

from repro_torch.core.cost_model import (
    LATENCY_SHAPES,
    LatencyStats,
    Routing,
    build_comm_model,
)
from repro_torch.core.topology import ub_mesh_rack
from repro_torch.core.traffic import ParallelSpec, WorkloadSpec
from repro_torch.netsim import EventEngine, MessageNetwork, NetSim
from repro_torch.netsim.collectives import (
    clique_nodes,
    hierarchical_allreduce,
    multipath_all_to_all,
    ring_allreduce,
)

SIZE = 64e3                       # decode-sized payload
X_CAP = 25e9                      # 4-lane passive-electrical X link


def serve_workload() -> WorkloadSpec:
    return WorkloadSpec(
        "dense-70B-serve", 80, 8192, 64, 128, 8,
        seq_len=8192, global_batch=512, params_total=7e10,
    )


# ---------------------------------------------------------------------------
# MessageNetwork: transport-level pricing
# ---------------------------------------------------------------------------


class TestMessageNetwork:
    def _net(self, **kw) -> MessageNetwork:
        return MessageNetwork(ub_mesh_rack(), EventEngine(), **kw)

    def test_single_hop_closed_form(self):
        net = self._net()
        msg = net.send((0, 1), SIZE)
        net.engine.run()
        assert msg.t_end == pytest.approx(SIZE / X_CAP + net.latency_s)

    def test_multi_hop_adds_serialization_and_latency_per_hop(self):
        # X hop then Y hop: store-and-forward pays both hops in full
        net = self._net()
        msg = net.send((0, 1, 9), SIZE)
        net.engine.run()
        assert msg.t_end == pytest.approx(2 * (SIZE / X_CAP + net.latency_s))

    def test_fifo_queueing_behind_busy_link(self):
        # second message on the same directed link waits out the first's
        # serialization; its latency grows by exactly one serialization
        net = self._net()
        m1 = net.send((0, 1), SIZE)
        m2 = net.send((0, 1), SIZE)
        net.engine.run()
        ser = SIZE / X_CAP
        assert m1.t_end == pytest.approx(ser + net.latency_s)
        assert m2.t_end == pytest.approx(2 * ser + net.latency_s)

    def test_reverse_direction_does_not_queue(self):
        # (0,1) and (1,0) are distinct directed links
        net = self._net()
        m1 = net.send((0, 1), SIZE)
        m2 = net.send((1, 0), SIZE)
        net.engine.run()
        assert m1.t_end == pytest.approx(m2.t_end)

    def test_dim_latency_override(self):
        plain = self._net()
        d01 = plain._link_dim[(0, 1)]
        net = self._net(dim_latency_s={d01: 5e-6})
        m_over = net.send((0, 1), SIZE)      # overridden dim
        m_base = net.send((0, 8), SIZE)      # the other dim: default
        net.engine.run()
        assert net._link_dim[(0, 8)] != d01
        assert m_over.t_end - m_base.t_end == pytest.approx(
            5e-6 - net.latency_s
        )

    def test_incast_serializes_at_ejection_port(self):
        # 7 clique peers converge on node 0: with an rx cap the ejection
        # port serializes them; without one they all land together
        free = self._net()
        capped = self._net(rx_gbs=25.0)
        for src in range(1, 8):
            free.send((src, 0), SIZE)
            capped.send((src, 0), SIZE)
        free.engine.run()
        capped.engine.run()
        ser = SIZE / X_CAP
        assert free.engine.now == pytest.approx(ser + 1e-6)
        # cut-through port: the first message is free, the other 6 drain
        # back to back at 25 GB/s behind it
        assert capped.engine.now > free.engine.now
        assert capped.engine.now == pytest.approx(ser + 1e-6 + 6 * ser)

    def test_uncontended_rx_port_is_free(self):
        # cut-through: a single message pays NO extra rx term
        capped = self._net(rx_gbs=25.0)
        msg = capped.send((1, 0), SIZE)
        capped.engine.run()
        assert msg.t_end == pytest.approx(SIZE / X_CAP + 1e-6)

    def test_deterministic_replay(self):
        def run():
            net = self._net(rx_gbs=25.0)
            out = []
            for src in range(1, 8):
                net.send((src, 0), SIZE, on_complete=lambda m: out.append(
                    (m.mid, m.t_end)
                ))
            net.engine.run()
            return out

        assert run() == run()

    def test_rejects_degenerate_path_and_non_links(self):
        net = self._net()
        with pytest.raises(ValueError):
            net.send((3,), SIZE)
        with pytest.raises(KeyError):
            net.send((0, 9), SIZE)      # diagonal: not a physical link
            net.engine.run()


# ---------------------------------------------------------------------------
# NetSim message mode
# ---------------------------------------------------------------------------


class TestMessageMode:
    def test_run_dag_populates_task_latencies(self):
        topo = ub_mesh_rack()
        sim = NetSim(topo, message_level=True)
        dag = ring_allreduce(topo, clique_nodes(topo, 0), SIZE, tag="t")
        res = sim.run_dag(dag)
        assert res.incomplete == 0
        assert set(res.task_latency_s) == set(res.task_end_s)
        assert all(v > 0 for v in res.task_latency_s.values())
        assert res.makespan_s >= max(res.task_latency_s.values())

    def test_message_mode_is_deterministic(self):
        topo = ub_mesh_rack()
        dag = multipath_all_to_all(
            topo, clique_nodes(topo, 0), SIZE / 8, tag="a2a"
        )
        r1 = NetSim(topo, message_level=True).run_dag(dag)
        r2 = NetSim(topo, message_level=True).run_dag(dag)
        assert r1.task_end_s == r2.task_end_s
        assert r1.makespan_s == r2.makespan_s

    def test_diverges_from_fluid_on_small_payloads(self):
        # the whole point of the mode: at decode payloads the fluid
        # model's single flat launch latency misprices the plane-wide
        # collective by a wide margin
        topo = ub_mesh_rack()
        sim_fluid = NetSim(topo)
        sim_msg = NetSim(topo, message_level=True)
        prof = sim_msg.measure_latency_profile(SIZE)
        msg_t = prof.get("model", "allreduce").total_s
        comm = build_comm_model()
        analytic_t = comm.allreduce("model", SIZE)
        assert abs(msg_t - analytic_t) / analytic_t > 0.10

    def test_failure_injection_is_fluid_only(self):
        topo = ub_mesh_rack()
        with pytest.raises(ValueError, match="failed_links"):
            NetSim(topo, message_level=True, failed_links=((0, 1),))
        sim = NetSim(topo, message_level=True)
        dag = ring_allreduce(topo, clique_nodes(topo, 0), SIZE, tag="t")
        with pytest.raises(ValueError, match="fail_link"):
            sim.run_dag(dag, fail_link=(0, 1))

    def test_measure_latency_profile_validates_shapes(self):
        sim = NetSim(ub_mesh_rack(), message_level=True)
        with pytest.raises(ValueError, match="latency profiles"):
            sim.measure_latency_profile(SIZE, shapes=("all_gather",))

    def test_stats_are_internally_consistent(self):
        sim = NetSim(ub_mesh_rack())
        prof = sim.measure_latency_profile(SIZE)
        assert set(s for (_, s) in prof.lat) <= set(LATENCY_SHAPES)
        for st in prof.lat.values():
            assert 0 < st.p50_s <= st.p99_s <= st.total_s
            assert st.n > 0


class TestModeOffParity:
    """``message_level=False`` must be BIT-identical to a sim that never
    heard of the flag — across a seeded corpus of collective DAGs."""

    SCENARIOS = []
    for seed in range(3):
        SCENARIOS.append(("ring", seed))
        SCENARIOS.append(("hier", seed))
        SCENARIOS.append(("a2a", seed))

    @staticmethod
    def _dag(kind: str, seed: int, topo):
        import random

        rng = random.Random(seed)
        if kind == "ring":
            dim = rng.choice((0, 1))
            return ring_allreduce(
                topo, clique_nodes(topo, dim), SIZE * (seed + 1), tag="r"
            )
        if kind == "hier":
            return hierarchical_allreduce(
                topo, (0, 1), SIZE * (seed + 1), tag="h"
            )
        group = clique_nodes(topo, rng.choice((0, 1)))
        return multipath_all_to_all(
            topo, group, SIZE * (seed + 1) / len(group), tag="a"
        )

    @pytest.mark.parametrize("kind,seed", SCENARIOS)
    def test_mode_off_bit_identical(self, kind, seed):
        topo = ub_mesh_rack()
        dag = self._dag(kind, seed, topo)
        base = NetSim(topo, rx_gbs=25.0).run_dag(dag)
        off = NetSim(topo, rx_gbs=25.0, message_level=False).run_dag(dag)
        # exact float equality, not approx: mode off may not perturb the
        # fluid path in any way
        assert off.task_end_s == base.task_end_s
        assert off.makespan_s == base.makespan_s
        assert off.link_utilization == base.link_utilization


# ---------------------------------------------------------------------------
# perf_model threading
# ---------------------------------------------------------------------------


class TestLatencyProfileThreading:
    def _pm(self, cache_dir=None):
        from repro_torch.core.perf_model import NetsimPerfModel

        return NetsimPerfModel(
            base=build_comm_model(),
            topo=ub_mesh_rack(),
            cache_dir=cache_dir,
        )

    def test_memoized_across_calls_and_instances(self):
        from repro_torch.core.perf_model import calibration_stats

        pm = self._pm()
        p = ParallelSpec(tp=8, sp=1, pp=1, dp=8, ep=1)
        prof1 = pm.latency_profile(p)
        before = calibration_stats()
        prof2 = self._pm().latency_profile(p)     # fresh instance, same key
        after = calibration_stats()
        assert prof2.lat == prof1.lat
        assert after["misses"] == before["misses"]
        assert after["hits"] > before["hits"]

    @staticmethod
    def _wipe_latency_memo():
        from repro_torch.core import perf_model as pmod

        for k in [k for k in pmod._LATENCY_CACHE if "latency-mode" in k]:
            del pmod._LATENCY_CACHE[k]

    def test_disk_round_trip(self, tmp_path):
        from repro_torch.core import perf_model as pmod

        # cold memo first, so EVERY key is measured into this tmp store
        self._wipe_latency_memo()
        pm = self._pm(cache_dir=str(tmp_path))
        p = ParallelSpec(tp=4, sp=1, pp=1, dp=16, ep=1)
        prof1 = pm.latency_profile(p)
        # wipe the in-memory memo again: the second resolution must come
        # from the persistent store, stats intact to full precision
        self._wipe_latency_memo()
        before = pmod.calibration_stats()
        prof2 = self._pm(cache_dir=str(tmp_path)).latency_profile(p)
        after = pmod.calibration_stats()
        assert prof2.lat == prof1.lat
        assert after["disk_hits"] - before["disk_hits"] == len(prof1.lat)
        assert isinstance(next(iter(prof2.lat.values())), LatencyStats)

    def test_width_canonicalization_shares_full_plane_key(self):
        from repro_torch.core.perf_model import calibration_stats

        pm = self._pm()
        full = ParallelSpec(tp=64, sp=1, pp=1, dp=1, ep=1)
        pm.latency_profile(full)
        before = calibration_stats()
        # tp*sp = 8*8 also covers the 64-chip plane -> same (None) key
        pm.latency_profile(ParallelSpec(tp=8, sp=8, pp=1, dp=1, ep=1))
        after = calibration_stats()
        assert after["misses"] == before["misses"]

    def test_latency_and_bandwidth_keys_never_alias(self):
        from repro_torch.core import perf_model as pmod

        pm = self._pm()
        p = ParallelSpec(tp=8, sp=1, pp=1, dp=8, ep=1)
        pm.latency_profile(p)
        lat_keys = [k for k in pmod._LATENCY_CACHE if "latency-mode" in k]
        assert lat_keys
        assert not any("latency-mode" in k for k in pmod._CALIBRATION_CACHE)

    def test_failed_links_rejected(self):
        from dataclasses import replace

        pm = replace(self._pm(), failed_links=((0, 1),))
        with pytest.raises(ValueError, match="healthy mesh"):
            pm.latency_profile(ParallelSpec(tp=8, sp=1, pp=1, dp=8, ep=1))

    def test_shapes_restricted_to_latency_set(self):
        pm = self._pm()
        prof = pm.latency_profile(ParallelSpec(tp=8, sp=1, pp=1, dp=8, ep=2))
        assert {s for (_, s) in prof.lat} <= set(LATENCY_SHAPES)
        assert ("model", "allreduce") in prof.lat
        assert ("model", "all_to_all") in prof.lat   # ep=2 has A2A traffic


# ---------------------------------------------------------------------------
# decode serving
# ---------------------------------------------------------------------------


class TestDecodeServing:
    def test_simulator_conserves_tokens(self):
        from repro_torch.launch.serve import simulate_decode_serving

        res = simulate_decode_serving(
            5e-3, qps=10.0, slots=16, gen_tokens=32, duration_s=5.0
        )
        assert res["tokens"] == res["requests"] * 32
        assert res["tokens_per_s"] > 0
        assert 0 < res["utilization"] <= 1

    def test_unloaded_p99_is_one_step(self):
        from repro_torch.launch.serve import simulate_decode_serving

        res = simulate_decode_serving(
            1e-3, qps=1.0, slots=64, gen_tokens=16, duration_s=10.0
        )
        # almost every token is a steady-state inter-token gap
        assert res["p50_s"] == pytest.approx(1e-3)
        assert res["p99_s"] < 3e-3

    def test_overload_shows_queueing_tail(self):
        from repro_torch.launch.serve import simulate_decode_serving

        light = simulate_decode_serving(
            5e-3, qps=2.0, slots=4, gen_tokens=32, duration_s=10.0,
            slo_s=20e-3,
        )
        heavy = simulate_decode_serving(
            5e-3, qps=50.0, slots=4, gen_tokens=32, duration_s=10.0,
            slo_s=20e-3,
        )
        assert heavy["p99_s"] > 10 * light["p99_s"]
        assert heavy["attainment"] < light["attainment"]

    def test_simulator_is_deterministic(self):
        from repro_torch.launch.serve import simulate_decode_serving

        kw = dict(qps=8.0, slots=8, gen_tokens=16, duration_s=5.0, seed=3)
        assert simulate_decode_serving(2e-3, **kw) == simulate_decode_serving(
            2e-3, **kw
        )

    def test_enumerate_decode_specs_memory_filter(self):
        from repro_torch.core.planner import enumerate_decode_specs

        w = serve_workload()              # 140 GB of bf16 weights
        specs = enumerate_decode_specs(w, 64)
        assert specs
        for p in specs:
            assert p.tp * p.dp == 64
            assert p.pp == 1 and p.sp == 1 and p.ep == 1
            # 48 GB HBM: tp < 4 cannot hold the shard
            assert p.tp >= 4

    def test_plan_decode_diverges_from_bandwidth_optimal(self):
        from repro_torch.launch.serve import plan_decode, rack_perf_model

        res = plan_decode(
            serve_workload(), 64, rack_perf_model(cache_dir=None),
            qps=30.0, slo_s=0.012, batch=8, duration_s=5.0,
        )
        bw, slo = res["bandwidth_choice"], res["slo_choice"]
        # bandwidth pricing (spec-invariant latency term) maxes out TP;
        # the measured width-scaled latency makes that the WORST p99
        assert bw["tp"] == 64
        assert slo["tp"] < bw["tp"]
        assert res["diverged"]
        assert slo["meets_slo"] and not bw["meets_slo"]

    def test_latency_pricing_requires_capable_backend(self):
        from repro_torch.core.perf_model import AnalyticPerfModel
        from repro_torch.launch.serve import decode_step_s

        perf = AnalyticPerfModel(base=build_comm_model())
        with pytest.raises(TypeError, match="latency-calibrated"):
            decode_step_s(
                serve_workload(),
                ParallelSpec(tp=8, sp=1, pp=1, dp=8, ep=1),
                perf,
                pricing="latency",
            )
