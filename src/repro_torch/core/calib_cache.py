"""The port's own copy of ``repro/core/calib_cache.py``, held to the original by
``tests/test_torch_netsim_parity.py`` and against it by
``tests/test_torch_calib_cache_parity.py``; only its
imports of the package, and the package's name where its docstring
gives it, differ.

Persistent on-disk store for netsim calibration measurements.

``core.perf_model.NetsimPerfModel`` memoizes measured per-(axis, shape,
group-width) bandwidths in a process-wide dict, which makes the *second*
``plan()`` of a process nearly free — but every new process re-pays the
full netsim measurement bill.  That is fatal for the sweeps the ROADMAP
wants next (topology co-design, Monte-Carlo availability campaigns):
100 outer candidates x ~30 keys x ~45 ms is minutes of pure re-measurement
of numbers that are a deterministic function of the configuration.

This module persists those measurements as small versioned JSON files:

* **Location** — ``$CALIB_CACHE_DIR`` if set, else
  ``~/.cache/ubmesh-repro/calib``; callers may also pass an explicit
  directory.  One file per *store key*.
* **Store key** — a content hash of everything that determines a
  measurement besides the (axis, shape, width) request itself: the
  topology geometry and capacities (``perf_model``'s topology key, plus
  the coarse/mixed tags for SuperPod pricing), routing strategy, payload
  size, latency, rx cap — and the code versions that define measurement
  semantics (``netsim.solver.SOLVER_VERSION``,
  ``netsim.api.CALIBRATION_SCHEMA_VERSION``, this module's
  ``SCHEMA_VERSION``).  Any change lands in a different file, so stale
  profiles are never served; they are just orphaned.
* **Robustness** — a truncated, corrupt or version-skewed file is ignored
  with one ``log.warning`` and the entries are re-measured; writes go
  through a temp file + ``os.replace`` so readers never see a partial
  file.  The cache never raises into the planner.

The JSON payload::

    {"schema": 1, "solver": 1, "netsim": 1,
     "config": [...],                  # the un-hashed key, for humans
     "entries": {"model|allreduce|None": 141.84, ...}}

Latency-mode profiles (``NetsimPerfModel.latency_profile``) ride the same
format: their config carries a ``("latency-mode", size_bytes)`` tag so
they land in a separate store file, and each ``LatencyStats`` field is one
entry under a ``shape@field`` name — e.g.
``"model|allreduce@p99_s|8": 2.1e-06`` — which the 3-part ``axis|shape|
width`` key split parses unchanged.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
from pathlib import Path

log = logging.getLogger(__name__)

# version of THIS file format (layout of the JSON document); bump on
# layout changes.  Measurement-semantics versions ride alongside it in
# the store key (see module docstring).
SCHEMA_VERSION = 1

ENV_VAR = "CALIB_CACHE_DIR"
_DEFAULT_SUBDIR = ("ubmesh-repro", "calib")

# geometry sweeps create one store file per candidate topology; cap the
# directory at this many stores (least-recently-written evicted first)
MAX_STORES_ENV_VAR = "CALIB_CACHE_MAX_STORES"
DEFAULT_MAX_STORES = 256


def max_stores() -> int:
    """Store-count cap: ``$CALIB_CACHE_MAX_STORES`` if set, else 256.
    ``0`` (or a negative / unparsable value <= 0) disables pruning."""
    env = os.environ.get(MAX_STORES_ENV_VAR)
    if env:
        try:
            return int(env)
        except ValueError:
            log.warning(
                "ignoring unparsable %s=%r", MAX_STORES_ENV_VAR, env
            )
    return DEFAULT_MAX_STORES


def default_cache_dir() -> Path:
    """``$CALIB_CACHE_DIR`` if set (and non-empty), else
    ``$XDG_CACHE_HOME``/``~/.cache`` + ``ubmesh-repro/calib``."""
    env = os.environ.get(ENV_VAR)
    if env:
        return Path(env)
    xdg = os.environ.get("XDG_CACHE_HOME")
    base = Path(xdg) if xdg else Path.home() / ".cache"
    return base.joinpath(*_DEFAULT_SUBDIR)


def _versions() -> tuple[int, int, int]:
    # deferred: core must not hard-require netsim at import time
    from ..netsim.api import CALIBRATION_SCHEMA_VERSION
    from ..netsim.solver import SOLVER_VERSION

    return SCHEMA_VERSION, SOLVER_VERSION, CALIBRATION_SCHEMA_VERSION


def _entry_key(axis: str, shape: str, width: int | None) -> str:
    return f"{axis}|{shape}|{width}"


class CalibCache:
    """One directory of per-configuration JSON calibration files.

    ``get_profile(config)`` returns the stored ``(axis, shape, width) ->
    GB/s`` mapping for a configuration (empty on miss/corruption);
    ``update(config, entries)`` merges newly measured entries back in.
    ``config`` is any JSON-serializable structure that pins the
    measurement context (see module docstring); its canonical JSON string
    is hashed into the file name.
    """

    def __init__(self, directory: "str | os.PathLike | None" = None) -> None:
        self.dir = Path(directory) if directory is not None else default_cache_dir()
        self._warned: set[str] = set()

    # -- key / path ------------------------------------------------------
    def _config_blob(self, config) -> str:
        schema, solver, netsim = _versions()
        doc = {"schema": schema, "solver": solver, "netsim": netsim,
               "config": config}
        return json.dumps(doc, sort_keys=True, default=repr)

    def path_for(self, config) -> Path:
        digest = hashlib.sha256(
            self._config_blob(config).encode()
        ).hexdigest()[:16]
        return self.dir / f"calib-{digest}.json"

    # -- read ------------------------------------------------------------
    def get_profile(self, config) -> dict[tuple[str, str, int | None], float]:
        """All stored entries for ``config`` (empty dict on miss)."""
        path = self.path_for(config)
        try:
            with open(path) as f:
                doc = json.load(f)
            schema, solver, netsim = _versions()
            if (doc.get("schema"), doc.get("solver"), doc.get("netsim")) != (
                schema, solver, netsim,
            ):
                # hash collisions aside, this means the file predates a
                # version bump of the hashing itself — treat as stale
                raise ValueError("version skew")
            entries = doc["entries"]
            out: dict[tuple[str, str, int | None], float] = {}
            for k, v in entries.items():
                axis, shape, w = k.split("|")
                out[(axis, shape, None if w == "None" else int(w))] = float(v)
            return out
        except FileNotFoundError:
            return {}
        except (OSError, ValueError, KeyError, AttributeError) as e:
            if str(path) not in self._warned:
                self._warned.add(str(path))
                log.warning(
                    "calibration cache %s unreadable (%s: %s) — ignoring "
                    "and re-measuring", path, type(e).__name__, e,
                )
            return {}

    # -- write -----------------------------------------------------------
    def update(
        self,
        config,
        entries: dict[tuple[str, str, int | None], float],
    ) -> None:
        """Merge ``entries`` into the configuration's file (best-effort:
        IO errors are logged, never raised)."""
        if not entries:
            return
        path = self.path_for(config)
        try:
            merged = {
                _entry_key(*k): v
                for k, v in self.get_profile(config).items()
            }
            merged.update({_entry_key(*k): float(v) for k, v in entries.items()})
            schema, solver, netsim = _versions()
            doc = {
                "schema": schema,
                "solver": solver,
                "netsim": netsim,
                "config": json.loads(json.dumps(config, default=repr)),
                "entries": merged,
            }
            self.dir.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=self.dir, prefix=path.name, suffix=".tmp"
            )
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(doc, f, sort_keys=True)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self.prune()
        except OSError as e:
            log.warning(
                "calibration cache %s not writable (%s: %s) — measurement "
                "kept in memory only", path, type(e).__name__, e,
            )

    # -- maintenance -----------------------------------------------------
    def prune(self, keep: int | None = None) -> list[Path]:
        """Evict least-recently-written store files beyond ``keep``.

        A geometry sweep writes one ``calib-*.json`` per candidate topology,
        so an unbounded ``$CALIB_CACHE_DIR`` grows with every sweep.  Keeps
        the ``keep`` most recently modified stores (default:
        ``max_stores()``, i.e. ``$CALIB_CACHE_MAX_STORES`` or 256); a
        ``keep`` <= 0 disables pruning.  Best-effort: IO errors are
        swallowed.  Returns the paths actually removed.
        """
        limit = max_stores() if keep is None else keep
        if limit <= 0:
            return []
        try:
            stores = sorted(
                self.dir.glob("calib-*.json"),
                key=lambda p: p.stat().st_mtime,
                reverse=True,
            )
        except OSError:
            return []
        removed: list[Path] = []
        for path in stores[limit:]:
            try:
                path.unlink()
                removed.append(path)
            except OSError:
                pass
        if removed:
            log.info(
                "calibration cache pruned %d store(s) beyond keep=%d",
                len(removed), limit,
            )
        return removed
