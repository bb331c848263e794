"""The reference's ``tests/test_calib_cache.py`` restated against the port's
``repro_torch.core.calib_cache`` and ``core.perf_model``.

Persistent calibration cache: disk-warm plan() parity,
store-key invalidation, and corruption robustness.

The contract under test: a second *process* (simulated by clearing the
in-memory memo) that plans the same workload on the same configuration
must read every calibration entry back from disk and produce a
bit-identical ``PlanReport`` ranking — while any change to what defines
a measurement (topology, routing, schema versions) lands in a different
file, and a damaged file is ignored with a warning, never a crash.
"""

import json
import os

import pytest

from repro_torch.core import calib_cache as cc
from repro_torch.core import perf_model as pm
from repro_torch.core.calib_cache import CalibCache, default_cache_dir
from repro_torch.core.cost_model import Routing, build_comm_model
from repro_torch.core.perf_model import NetsimPerfModel, reset_calibration_stats
from repro_torch.core.planner import plan
from repro_torch.core.topology import ub_mesh_pod
from repro_torch.core.traffic import backend_comparison_workloads

W_CLEAN, _ = backend_comparison_workloads()


def _perf(tmp_path, **kw):
    comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
    kw.setdefault("cache_dir", str(tmp_path / "store"))
    return NetsimPerfModel(comm, topo=ub_mesh_pod(), size_bytes=16e6, **kw)


def _restart():
    """Simulate a process restart: drop every in-memory calibration."""
    pm._CALIBRATION_CACHE.clear()
    pm._DISK_CACHES.clear()
    reset_calibration_stats()


class TestDiskWarmParity:
    def test_cold_then_warm_plan_bit_identical(self, tmp_path):
        perf = _perf(tmp_path)
        _restart()
        cold = plan(W_CLEAN, 256, perf)
        assert cold.calibration["misses"] > 0
        assert cold.calibration["disk_hits"] == 0
        files = list((tmp_path / "store").glob("calib-*.json"))
        assert files, "cold plan must write the store"

        _restart()
        warm = plan(W_CLEAN, 256, _perf(tmp_path))
        # every miss served from disk, nothing re-measured
        assert warm.calibration["disk_hits"] == warm.calibration["misses"] > 0
        assert warm.calibration["measure_s"] == 0.0
        # bit-identical ranking: JSON float repr roundtrips exactly
        assert [(r.spec, r.iteration_s) for r in warm] == [
            (r.spec, r.iteration_s) for r in cold
        ]

    def test_precalibrate_reports_disk_hits(self, tmp_path):
        from repro_torch.core.planner import enumerate_specs

        perf = _perf(tmp_path)
        specs = enumerate_specs(W_CLEAN, 256)
        _restart()
        first = perf.precalibrate(specs)
        assert first["measured"] == first["keys"] > 0
        _restart()
        second = _perf(tmp_path).precalibrate(specs)
        assert second["disk_hits"] == second["keys"] == first["keys"]
        assert second["measured"] == 0


class TestStoreInvalidation:
    def test_config_changes_land_in_different_files(self, tmp_path):
        cache = CalibCache(tmp_path)
        base = ["topo", "detour", 16e6]
        assert cache.path_for(base) == cache.path_for(list(base))
        assert cache.path_for(base) != cache.path_for(["topo2", "detour", 16e6])
        assert cache.path_for(base) != cache.path_for(["topo", "shortest", 16e6])

    def test_schema_bump_changes_the_store_key(self, tmp_path, monkeypatch):
        cache = CalibCache(tmp_path)
        p_old = cache.path_for(["cfg"])
        monkeypatch.setattr(cc, "SCHEMA_VERSION", cc.SCHEMA_VERSION + 1)
        assert cache.path_for(["cfg"]) != p_old

    def test_routing_change_remeasures_end_to_end(self, tmp_path):
        _restart()
        plan(W_CLEAN, 256, _perf(tmp_path))
        _restart()
        comm = build_comm_model(multi_pod=False, routing=Routing.SHORTEST)
        other = NetsimPerfModel(
            comm, topo=ub_mesh_pod(), size_bytes=16e6,
            cache_dir=str(tmp_path / "store"),
        )
        rep = plan(W_CLEAN, 256, other)
        # nothing from the DETOUR store may serve a SHORTEST measurement
        assert rep.calibration["disk_hits"] == 0
        assert rep.calibration["misses"] > 0

    def test_version_skewed_file_ignored_with_warning(self, tmp_path, caplog):
        cache = CalibCache(tmp_path)
        cache.update(["cfg"], {("model", "allreduce", None): 100.0})
        path = cache.path_for(["cfg"])
        doc = json.loads(path.read_text())
        doc["solver"] = -1
        path.write_text(json.dumps(doc))
        with caplog.at_level("WARNING", logger="repro_torch.core.calib_cache"):
            assert CalibCache(tmp_path).get_profile(["cfg"]) == {}
        assert any("re-measuring" in r.message for r in caplog.records)


class TestCorruptionRobustness:
    def test_truncated_file_warns_once_and_remeasures(self, tmp_path, caplog):
        perf = _perf(tmp_path)
        _restart()
        plan(W_CLEAN, 256, perf)
        for f in (tmp_path / "store").glob("calib-*.json"):
            f.write_text(f.read_text()[: len(f.read_text()) // 2])
        _restart()
        with caplog.at_level("WARNING", logger="repro_torch.core.calib_cache"):
            rep = plan(W_CLEAN, 256, _perf(tmp_path))
        assert rep.calibration["disk_hits"] == 0
        assert rep.calibration["misses"] > 0
        assert len(rep) > 0
        warned = [r for r in caplog.records if "unreadable" in r.message]
        assert warned, "corruption must be logged"
        # ...once per file, not once per key
        assert len(warned) <= len(list((tmp_path / "store").glob("*.json")))

    def test_garbage_json_returns_empty(self, tmp_path, caplog):
        cache = CalibCache(tmp_path)
        cache.update(["cfg"], {("model", "allreduce", None): 100.0})
        cache.path_for(["cfg"]).write_text("{not json")
        with caplog.at_level("WARNING", logger="repro_torch.core.calib_cache"):
            assert CalibCache(tmp_path).get_profile(["cfg"]) == {}

    def test_unwritable_dir_never_raises(self, tmp_path, caplog):
        blocker = tmp_path / "blocked"
        blocker.write_text("a file where the cache dir should be")
        cache = CalibCache(blocker)  # mkdir will fail with NotADirectoryError
        with caplog.at_level("WARNING", logger="repro_torch.core.calib_cache"):
            cache.update(["cfg"], {("model", "allreduce", None): 1.0})
        assert cache.get_profile(["cfg"]) == {}


class TestCacheLocation:
    def test_env_override_wins(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CALIB_CACHE_DIR", str(tmp_path / "envdir"))
        assert default_cache_dir() == tmp_path / "envdir"

    def test_xdg_fallback(self, monkeypatch, tmp_path):
        monkeypatch.delenv("CALIB_CACHE_DIR", raising=False)
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        assert default_cache_dir() == tmp_path / "xdg" / "ubmesh-repro" / "calib"

    def test_update_merges_entries(self, tmp_path):
        cache = CalibCache(tmp_path)
        cache.update(["cfg"], {("model", "allreduce", None): 100.0})
        cache.update(["cfg"], {("model", "all_gather", 8): 50.0})
        prof = cache.get_profile(["cfg"])
        assert prof == {
            ("model", "allreduce", None): 100.0,
            ("model", "all_gather", 8): 50.0,
        }


class TestPrune:
    """Store-count cap: geometry sweeps write one file per
    candidate topology, so the directory is pruned LRU-by-mtime."""

    def _fill(self, cache, n):
        for i in range(n):
            cache.update([f"cfg-{i}"], {("model", "allreduce", None): float(i)})
            # mtime-ordered: make each store strictly newer than the last
            os_path = cache.path_for([f"cfg-{i}"])
            os.utime(os_path, (1_000_000 + i, 1_000_000 + i))

    def test_prune_keeps_newest(self, tmp_path):
        cache = CalibCache(tmp_path)
        self._fill(cache, 6)
        removed = cache.prune(keep=2)
        assert len(removed) == 4
        left = sorted(tmp_path.glob("calib-*.json"))
        assert len(left) == 2
        # the survivors are the two most recently written configs
        assert cache.get_profile(["cfg-5"]) != {}
        assert cache.get_profile(["cfg-4"]) != {}
        assert cache.get_profile(["cfg-0"]) == {}

    def test_prune_disabled_by_nonpositive_keep(self, tmp_path):
        cache = CalibCache(tmp_path)
        self._fill(cache, 4)
        assert cache.prune(keep=0) == []
        assert len(list(tmp_path.glob("calib-*.json"))) == 4

    def test_env_override_controls_cap(self, tmp_path, monkeypatch):
        monkeypatch.setenv(cc.MAX_STORES_ENV_VAR, "3")
        assert cc.max_stores() == 3
        cache = CalibCache(tmp_path)
        # update() prunes automatically after each write
        self._fill(cache, 5)
        assert len(list(tmp_path.glob("calib-*.json"))) <= 3

    def test_unparsable_env_falls_back_to_default(self, monkeypatch, caplog):
        monkeypatch.setenv(cc.MAX_STORES_ENV_VAR, "lots")
        with caplog.at_level("WARNING", logger="repro_torch.core.calib_cache"):
            assert cc.max_stores() == cc.DEFAULT_MAX_STORES

    def test_default_cap_is_256(self, monkeypatch):
        monkeypatch.delenv(cc.MAX_STORES_ENV_VAR, raising=False)
        assert cc.max_stores() == 256
