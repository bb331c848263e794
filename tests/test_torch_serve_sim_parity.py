"""The decode-serving simulator of the port's ``launch/serve.py`` held
against the reference's (``repro/launch/serve.py``, which loads without JAX)
by ``==``: the decode payload, a decode step priced by bandwidth and by
the measured latency profile, the continuous-batching simulation under
light and heavy load, and ``plan_decode``'s bandwidth-optimal and SLO
choices on the serving rack.  Each side calibrates from nothing into a
cache directory of its own."""

import pytest

from _torch_netsim_parity import both, calibrated, measured, outcome

MODS = "launch.serve core.perf_model core.cost_model core.traffic"


def serve_workload(traffic):
    return traffic.WorkloadSpec("dense-70B-serve", 80, 8192, 64, 128, 8,
                                seq_len=8192, global_batch=512, params_total=7e10)


def test_constants_and_payload():
    def run(serve, pm, cm, traffic):
        w = serve_workload(traffic)
        return (serve.DECODE_HBM_GBS, serve.DECODE_MSG_BYTES,
                [serve.decode_comm_bytes(w, b) for b in (1, 8, 64)])
    both(MODS, run)


@pytest.mark.parametrize("step_s,qps,slots,gen,slo", [
    (5e-3, 10.0, 16, 32, None), (1e-3, 1.0, 64, 16, None), (5e-3, 2.0, 4, 32, 20e-3),
    (5e-3, 50.0, 4, 32, 20e-3), (2e-3, 8.0, 8, 16, 1e-3)])
def test_simulate_decode_serving(step_s, qps, slots, gen, slo):
    def run(serve, pm, cm, traffic):
        return [serve.simulate_decode_serving(step_s, qps=qps, slots=slots, gen_tokens=gen,
                                              duration_s=5.0, seed=s, slo_s=slo) for s in (0, 3)]
    both(MODS, run)


def test_simulate_decode_serving_rejects():
    def run(serve, pm, cm, traffic):
        return [outcome(serve.simulate_decode_serving, s, qps=q, slots=n)
                for s, q, n in ((0.0, 1.0, 1), (1e-3, 0.0, 1), (1e-3, 1.0, 0))]
    both(MODS, run)


def test_decode_step_pricing(tmp_path, monkeypatch):
    """Every decode sharding of 64 chips, priced both ways; an analytic
    backend asked for latency pricing, and an unknown pricing, raise."""
    def run(serve, pm, cm, traffic):
        from importlib import import_module
        planner = import_module(serve.__name__.split(".")[0] + ".core.planner")
        w = serve_workload(traffic)
        perf = serve.rack_perf_model()
        out = [(p, serve.decode_step_s(w, p, perf, batch=8, pricing="bandwidth"),
                serve.decode_step_s(w, p, perf, batch=8, pricing="latency"))
               for p in planner.enumerate_decode_specs(w, 64)]
        one = traffic.ParallelSpec(tp=1, sp=1, pp=1, dp=64, ep=1)
        out.append(serve.decode_step_s(w, one, perf, pricing="latency"))
        analytic = pm.AnalyticPerfModel(base=cm.build_comm_model())
        p8 = traffic.ParallelSpec(tp=8, sp=1, pp=1, dp=8, ep=1)
        out.append(outcome(serve.decode_step_s, w, p8, analytic, pricing="latency"))
        out.append(outcome(serve.decode_step_s, w, p8, perf, pricing="other"))
        return out
    out, stats = calibrated(MODS, run, tmp_path, monkeypatch)
    assert measured(stats)
    assert out[-2][0] == "raised" and out[-1][0] == "raised"


@pytest.mark.parametrize("qps,slo_s", [(30.0, 0.012), (5.0, 0.05), (200.0, 0.001)])
def test_plan_decode(qps, slo_s, tmp_path, monkeypatch):
    """``plan_decode``'s candidates and its two choices: the bandwidth-optimal
    sharding and the one that meets the p99 SLO (the reference test's case
    first, where they part)."""
    def run(serve, pm, cm, traffic):
        return serve.plan_decode(serve_workload(traffic), 64, serve.rack_perf_model(cache_dir=None),
                                 qps=qps, slo_s=slo_s, batch=8, duration_s=5.0)
    out, stats = calibrated(MODS, run, tmp_path, monkeypatch)
    assert measured(stats)
    assert out["bandwidth_choice"] and out["slo_choice"]
    if (qps, slo_s) == (30.0, 0.012):
        assert out["diverged"] and out["bandwidth_choice"]["tp"] == 64


def test_rack_perf_model_stores_in_its_directory(tmp_path, monkeypatch):
    def run(serve, pm, cm, traffic):
        perf = serve.rack_perf_model(cache_dir=str(tmp_path / serve.__name__.split(".")[0]))
        prof = perf.latency_profile(traffic.ParallelSpec(tp=8, sp=1, pp=1, dp=8, ep=1))
        return perf.backend, perf.cache_dir.endswith(serve.__name__.split(".")[0]), prof, \
            sorted(p.name for p in (tmp_path / serve.__name__.split(".")[0]).iterdir())
    _, stats = calibrated(MODS, run, tmp_path, monkeypatch)
    assert measured(stats)
