"""The port's copy of ``runtime/campaign.py`` held against the reference's by
``==``: seeded event sampling, the canonical failed links, the recovery
policy engine's timelines, the netsim-repriced smoke campaign, Table 6's
head-to-head and the linearity under failures at the golden tests' sizes
(``tests/test_golden_numbers.py``), the availability scores and the
Perfetto trace of a seed.  Each netsim-repricing side calibrates from
nothing into a cache directory of its own."""

import json
from dataclasses import replace

import numpy as np
import pytest

from _torch_netsim_parity import both, calibrated, counts, measured, outcome

MODS = "runtime.campaign core.codesign core.availability"


def smoke(cd):
    return cd.GeometryCandidate(board=4, boards_per_rack=4)      # (4, 4, 4, 4) = 256 chips


def test_sampling_and_rates():
    def run(cp, cd, av):
        out = []
        for afr in (av.PAPER_UB_MESH, av.PAPER_CLOS):
            rates = cp.failure_class_rates(afr, smoke(cd), 256)
            out.append((rates, cp.clos_class_rates(afr), cp.scale_afr(afr, 0.5), cp.scale_afr(afr, 3.0)))
            for seed in (0, 42):
                out.append(cp.sample_events(rates, 672.0, np.random.default_rng(seed),
                                            npu_rate_per_year=30.0, n_racks=16))
        out.append(cp.failure_class_rates(av.PAPER_UB_MESH, cd.GeometryCandidate(), 8192))
        out.append([cp._union_hours(w, 100.0) for w in ([(0, 2), (1, 3), (10, 11)], [(-5, 1), (99, 200)], [])])
        return out
    both(MODS, run)


@pytest.mark.parametrize("cls", ["x_link", "y_link", "z_trunk", "a_trunk", "lrs", "nope"])
def test_canonical_failed_links(cls):
    def run(cp, cd, av):
        return [outcome(cp.canonical_failed_links, c.pod(), cls)
                for c in (smoke(cd), cd.GeometryCandidate(),
                          replace(smoke(cd), rows=2, racks_per_row=2))]
    both(MODS, run)


@pytest.mark.parametrize("arch", ["ub-mesh", "clos"])
@pytest.mark.parametrize("npu_afr", [None, 2.0])
def test_replay_policy_engine(arch, npu_afr):
    """Each seed's timeline, policies and hours without repricing."""
    def run(cp, cd, av):
        kw = {} if npu_afr is None else {"npu_afr_per_year": npu_afr}
        cfg = cp.CampaignConfig(candidate=smoke(cd), chips=256, seeds=(0, 1, 2, 3), arch=arch,
                                netsim_reprice=False, **kw)
        res = cp.run_campaign(cfg)
        return (res.runs, res.summary(), res.availability, res.job_availability, res.goodput,
                cfg.horizon_hours, cfg.n_racks, cfg.afr(), cfg.class_rates())
    both(MODS, run)


def test_repriced_smoke_campaign(tmp_path, monkeypatch):
    """The smoke campaign of the reference's tests with netsim repricing:
    the degraded step deltas by class, every seed, and the trace."""
    def run(cp, cd, av, pm):
        cfg = cp.CampaignConfig(candidate=smoke(cd), chips=256, seeds=(0, 1, 2), size_bytes=4e6)
        res = cp.run_campaign(cfg)
        return (res.healthy_step_s, res.deltas_by_class, res.runs, res.summary(),
                cp.campaign_trace(res.runs[1]), counts(pm.calibration_stats()))
    out, stats = calibrated(MODS + " core.perf_model", run, tmp_path, monkeypatch)
    assert measured(stats)
    assert out[1]


def test_table6_head_to_head():
    """Table 6's 8K-NPU UB-Mesh vs Clos over 16 seeds, sampling only (the
    golden test's call)."""
    def run(cp, cd, av):
        h = cp.head_to_head(chips=8192, seeds=tuple(range(16)), netsim_reprice=False)
        return {k: (v.runs, v.summary(), v.availability) if hasattr(v, "runs") else v
                for k, v in h.items()}
    out = both(MODS, run)
    assert 0.05 < out["availability_gap"] < 0.1


@pytest.mark.parametrize("arch", ["ub-mesh", "clos"])
def test_linearity_under_failures(arch):
    """1K to 8K weak scaling under failures, 8 seeds, the analytic backend
    (the golden test's calls)."""
    def run(cp, cd, av):
        kw = {"perf_backend": "analytic"} if arch == "ub-mesh" else {"arch": "clos"}
        return cp.linearity_under_failures(1024, 8192, seeds=tuple(range(8)), netsim_reprice=False, **kw)
    both(MODS, run)


def test_availability_scores():
    def run(cp, cd, av):
        grid = cd.enumerate_geometries(x_lanes=(4, 3), y_lanes=(4,), z_lanes=(2,), a_lanes=(2,),
                                       uplinks=(256, 64))
        return ([cp.availability_score(c, chips) for c in grid for chips in (1024, 8192)],
                cp.unavailability_for_afr(av.PAPER_CLOS), cp.unavailability_for_afr(
                    av.PAPER_UB_MESH, seeds=(1, 2), horizon_weeks=2.0, mttr_hours=3.0))
    both(MODS, run)


def test_campaign_trace_document(tmp_path):
    """The Perfetto document of one seed, returned and written."""
    def run(cp, cd, av):
        cfg = cp.CampaignConfig(candidate=smoke(cd), chips=256, seeds=(3,), arch="clos",
                                netsim_reprice=False, npu_afr_per_year=2.0)
        r = cp.run_campaign(cfg).runs[0]
        path = tmp_path / f"{cp.__name__.split('.')[0]}.json"
        doc = cp.campaign_trace(r, str(path))
        return doc, json.loads(path.read_text())
    doc, written = both(MODS, run)
    assert doc["traceEvents"] and "repro" not in json.dumps(written)
