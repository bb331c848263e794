"""The port's copy of ``core/calib_cache.py`` held against the reference's by
``==``: the same configuration lands in the same file name, the same
entries are read back, and a netsim-backed ``plan`` writes the same store
files, name and content, in each package's own directory.  Since the two
packages share the store's key and layout, one store serves both: a test
below reads the reference's store from the port and re-measures nothing,
and another shows that the port measures when its directory is its own."""

import json
import os
import pathlib

import pytest

from _torch_netsim_parity import both, calibrated, fresh_calibration, measured, pkgs, plain, plan_fields

CONFIGS = [["topo", "detour", 16e6], {"a": [1, 2], "b": None}, ("t", 3, 1e-6, ["x"]), "plain"]


def _store(directory):
    """Each store file's name and its JSON, read back."""
    return {p.name: json.loads(p.read_text()) for p in sorted(directory.glob("calib-*.json"))}


def test_keys_paths_and_versions(tmp_path):
    def run(cc):
        cache = cc.CalibCache(tmp_path / "store")
        return ([cache.path_for(c).name for c in CONFIGS], [cache._config_blob(c) for c in CONFIGS],
                cc._versions(), cc._entry_key("model", "allreduce", 8), cc._entry_key("pod", "p2p", None),
                cc.max_stores(), cc.SCHEMA_VERSION, cc.ENV_VAR, cc.DEFAULT_MAX_STORES)
    both("core.calib_cache", run)


def test_default_directory(monkeypatch, tmp_path):
    def run(cc):
        out = [str(cc.default_cache_dir())]
        monkeypatch.delenv("CALIB_CACHE_DIR")
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        out.append(str(cc.default_cache_dir()))
        monkeypatch.setenv("CALIB_CACHE_MAX_STORES", "7")
        out.append(cc.max_stores())
        monkeypatch.setenv("CALIB_CACHE_MAX_STORES", "seven")
        out.append(cc.max_stores())
        monkeypatch.setenv("CALIB_CACHE_DIR", str(tmp_path / "calib-cache"))
        monkeypatch.delenv("CALIB_CACHE_MAX_STORES")
        return out
    both("core.calib_cache", run)


def test_update_get_prune(tmp_path):
    """Entries merged, read back, the written files' contents, and pruning
    to a cap: each package in a directory of its own."""
    def run(cc):
        d = tmp_path / cc.__name__.split(".")[0]
        cache = cc.CalibCache(d)
        cache.update(CONFIGS[0], {("model", "allreduce", 8): 150.25, ("data", "all_to_all", None): 31.0})
        cache.update(CONFIGS[0], {("model", "allreduce", 8): 151.5, ("pod", "p2p", 2): 12})
        cache.update(CONFIGS[1], {})
        for i, c in enumerate(CONFIGS[1:]):
            cache.update(c, {("model", "allreduce", i): float(i)})
            os.utime(cache.path_for(c), (1e9 + i, 1e9 + i))
        got = [cache.get_profile(c) for c in CONFIGS] + [cache.get_profile(["absent"])]
        files = _store(d)
        removed = [p.name for p in cache.prune(keep=2)]
        return got, files, removed, sorted(_store(d)), cache.prune(keep=0)
    both("core.calib_cache", run)


def test_unreadable_store_is_ignored(tmp_path):
    def run(cc):
        d = tmp_path / cc.__name__.split(".")[0]
        cache = cc.CalibCache(d)
        cache.update(CONFIGS[0], {("model", "allreduce", 8): 150.0})
        path = cache.path_for(CONFIGS[0])
        path.write_text("{not json")
        bad = cache.get_profile(CONFIGS[0])
        path.write_text(json.dumps({"schema": -1, "entries": {}}))
        skew = cc.CalibCache(d).get_profile(CONFIGS[0])
        return bad, skew
    both("core.calib_cache", run)


@pytest.mark.parametrize("which", [0, 1], ids=["dense-70B", "moe-600B"])
def test_plan_writes_the_same_store(which, tmp_path, monkeypatch):
    """A cold netsim-backed ``plan`` on each side: the same report, and the
    same store files (names and entries, bit for bit through JSON) in each
    side's own directory; then a warm plan from that store, all disk hits."""
    def run(cm, pm, planner, topo, traffic):
        w = traffic.backend_comparison_workloads()[which]
        comm = cm.build_comm_model(multi_pod=False, routing=cm.Routing.DETOUR)
        perf = pm.NetsimPerfModel(comm, topo=topo.ub_mesh_pod(), size_bytes=16e6)
        cold = plan_fields(planner.plan(w, 256, perf))
        store = _store(pathlib.Path(os.environ["CALIB_CACHE_DIR"]))
        return cold, store
    (cold, store), stats = calibrated("core.cost_model core.perf_model core.planner core.topology core.traffic",
                                      run, tmp_path, monkeypatch)
    assert measured(stats) and store
    assert cold["calibration"]["disk_hits"] == 0
    assert sorted((tmp_path / "repro").glob("calib-*.json")) != []
    assert _store(tmp_path / "repro") == _store(tmp_path / "repro_torch")


def test_port_reads_the_reference_store(tmp_path, monkeypatch):
    """The store is the same on both sides, so the port's plan over the
    reference's store re-measures nothing and ranks the same."""
    sides = list(zip(*(pkgs(m) for m in ("core.cost_model", "core.perf_model", "core.planner",
                                         "core.topology", "core.traffic"))))
    monkeypatch.setenv("CALIB_CACHE_DIR", str(tmp_path / "shared"))
    reports = []
    for root, (cm, pm, planner, topo, traffic) in zip(("repro", "repro_torch"), sides):
        fresh_calibration(root)
        comm = cm.build_comm_model(multi_pod=False, routing=cm.Routing.DETOUR)
        perf = pm.NetsimPerfModel(comm, topo=topo.ub_mesh_pod(), size_bytes=16e6)
        reports.append(planner.plan(traffic.backend_comparison_workloads()[0], 256, perf))
    cold, warm = reports
    assert cold.calibration["measure_s"] > 0 and cold.calibration["disk_hits"] == 0
    assert warm.calibration["measure_s"] == 0.0
    assert warm.calibration["disk_hits"] == warm.calibration["misses"] > 0
    assert plain(warm.results) == plain(cold.results)
