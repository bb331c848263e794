"""The port's own copy of ``repro/netsim/solver.py``, held to the original by
``tests/test_torch_netsim_solver.py``; only its imports of the package differ, and one
comment line that named the change request it came from is reworded.

Max-min fair-share rate solvers for the fluid network (netsim layer 2).

Two interchangeable implementations of progressive-filling ("water-
filling") max-min fairness over a flow's constraint set (wire links plus
the virtual receiver-egress / per-dimension IO links):

* ``ReferenceMaxMinSolver`` — the original pure-Python dict-based
  progressive filling, kept verbatim as the correctness oracle for the
  parity suite (``tests/test_netsim_solver.py``).  O(flows x links) of
  dict churn per recompute; fine for unit-scale scenarios, the bottleneck
  at pod scale and beyond.
* ``VectorizedMaxMinSolver`` — numpy water-filling over a CSR-style
  flow-group x link incidence that is maintained *incrementally* on
  ``flow_added`` / ``flow_removed`` (no per-recompute ``sorted(flows)``
  or dict-of-tuple rebuilds).  Flows with identical constraint multisets
  are aggregated into one *group* with a multiplicity — max-min gives
  identical flows identical rates, so one group row prices all of them
  (the "Rail-only"-style symmetric-traffic aggregation).  Each round of
  the filling loop freezes every link at the current minimum fair share
  simultaneously, so symmetric collectives resolve in O(1) rounds of
  O(nnz) numpy work.

Both solvers freeze links within a *relative* tolerance of the round's
best share (``level = best * (1 + 1e-9)``).  The previous absolute
``+ 1e-9`` epsilon over-froze links whose fair share is itself ~1e-9
bytes/s (tiny capacities / huge flow counts) — pinned by a regression
test in the parity suite.

The round-level freezing is exact: removing an at-``best`` consumer from
a link whose share was *above* the level can only raise that link's
share, so no link can drop to the level mid-round — snapshot semantics
and sequential semantics coincide, which is what makes the vectorized
solver bit-compatible (to fp accumulation order) with the reference.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Hashable

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from .flows import Flow, FluidNetwork

# relative freeze tolerance: links whose fair share is within this factor
# of the round's minimum freeze together (they are equal to fp noise)
LEVEL_RTOL = 1e-9

# bump whenever an allocator change can alter solved rates (and therefore
# measured calibration bandwidths) — part of the persistent calibration
# cache key (core/calib_cache.py), so stale on-disk profiles are dropped
# instead of silently served
SOLVER_VERSION = 1


class ReferenceMaxMinSolver:
    """Pure-Python progressive filling (the first implementation).

    Stateless between solves: every ``solve`` walks ``net.flows`` and
    rebuilds the per-link residual/count/membership dicts.  Kept as the
    oracle the vectorized solver must match to 1e-6.
    """

    name = "reference"

    def __init__(self, net: "FluidNetwork") -> None:
        self.net = net
        # fid -> bottleneck constraint from the latest solve (telemetry);
        # None while no telemetry recorder is attached
        self.last_attribution: dict[int, Hashable] | None = None

    # incremental notifications are no-ops for the stateless reference
    def flow_added(self, flow: "Flow") -> None:
        pass

    def flow_removed(self, flow: "Flow") -> None:
        pass

    def capacity_changed(self) -> None:
        pass

    def solve(self) -> list["Flow"]:
        """Set ``f.rate`` for every active flow; return the flowing ones."""
        net = self.net
        rec = net.telemetry is not None
        attr: dict[int, Hashable] | None = {} if rec else None
        active = [net.flows[k] for k in sorted(net.flows)]
        for f in active:
            f.rate = 0.0
        residual: dict[Hashable, float] = {}
        count: dict[Hashable, int] = {}
        flows_on: dict[Hashable, list["Flow"]] = {}
        for f in active:
            for l in f.constraints:
                if l not in residual:
                    residual[l] = net.constraint_capacity(l)
                    count[l] = 0
                    flows_on[l] = []
                count[l] += 1
                flows_on[l].append(f)
        frozen: set[int] = set()
        n_left = len(active)
        while n_left > 0:
            best = math.inf
            for l, c in count.items():
                if c > 0:
                    share = residual[l] / c
                    if share < best:
                        best = share
            if not math.isfinite(best):
                break
            level = best * (1 + LEVEL_RTOL)
            if rec:
                # round-start freeze level set: these are the constraints
                # that pin every flow frozen this round (round snapshot ==
                # sequential, see module docstring), so the canonical
                # attribution — min key among a flow's at-level
                # constraints — is solver-independent
                level_set = {
                    l
                    for l, c in count.items()
                    if c > 0 and residual[l] / c <= level
                }
            for l in list(count):
                if count[l] <= 0 or residual[l] / count[l] > level:
                    continue
                for f in flows_on[l]:
                    if f.fid in frozen:
                        continue
                    f.rate = best
                    frozen.add(f.fid)
                    n_left -= 1
                    if rec:
                        cands = level_set.intersection(f.constraints)
                        attr[f.fid] = min(cands) if cands else l
                    for fl in f.constraints:
                        residual[fl] = max(0.0, residual[fl] - best)
                        count[fl] -= 1
        self.last_attribution = attr
        return [f for f in active if f.rate > 0.0]


class VectorizedMaxMinSolver:
    """Numpy water-filling over an incrementally maintained group CSR.

    * ``_col`` interns every constraint key (wire link, virtual rx/io
      port) to a column id; capacities are materialized into one array,
      invalidated by ``capacity_changed`` (link failure / borrow links).
    * Flows with the same constraint *multiset* share a group slot; the
      group's multiplicity counts its members and a join/leave only bumps
      that count.  The CSR (indptr/indices/weights over live groups) is
      rebuilt only when the *set* of live groups changes.
    * ``solve`` runs the filling loop entirely on arrays: per round one
      share computation, one boolean freeze mask, and two ``np.add.at``
      scatter-updates for the frozen groups' consumption.
    """

    name = "vectorized"

    def __init__(self, net: "FluidNetwork") -> None:
        self.net = net
        self._col: dict[Hashable, int] = {}       # constraint key -> column
        self._keys: list[Hashable] = []           # column -> constraint key
        self._cap: np.ndarray = np.empty(0)       # column -> bytes/s
        self._cap_dirty = True
        # group slots (parallel lists; freed slots are recycled)
        self._g_key: list[tuple | None] = []      # slot -> group key
        self._g_cols: list[np.ndarray] = []       # slot -> column ids
        self._g_wts: list[np.ndarray] = []        # slot -> per-column counts
        self._g_mult: list[int] = []              # slot -> member count
        self._groups: dict[tuple, int] = {}       # group key -> slot
        self._free: list[int] = []
        self._slot_of: dict[int, int] = {}        # fid -> slot
        # CSR over live slots (rebuilt when the live-slot set changes)
        self._csr_dirty = True
        self._rows: np.ndarray = np.empty(0, dtype=np.int64)   # live slots
        self._indptr: np.ndarray = np.empty(0, dtype=np.int64)
        self._indices: np.ndarray = np.empty(0, dtype=np.int64)
        self._weights: np.ndarray = np.empty(0)
        self._row_of_nnz: np.ndarray = np.empty(0, dtype=np.int64)
        # fid -> bottleneck constraint from the latest solve (telemetry)
        self.last_attribution: dict[int, Hashable] | None = None

    # -- incremental incidence maintenance ---------------------------------
    def _col_of(self, key: Hashable) -> int:
        c = self._col.get(key)
        if c is None:
            c = len(self._keys)
            self._col[key] = c
            self._keys.append(key)
            self._cap_dirty = True
        return c

    def flow_added(self, flow: "Flow") -> None:
        counts: dict[int, int] = {}
        for l in flow.constraints:
            c = self._col_of(l)
            counts[c] = counts.get(c, 0) + 1
        gkey = tuple(sorted(counts.items()))
        slot = self._groups.get(gkey)
        if slot is None:
            slot = self._free.pop() if self._free else len(self._g_key)
            if slot == len(self._g_key):
                self._g_key.append(None)
                self._g_cols.append(np.empty(0, dtype=np.int64))
                self._g_wts.append(np.empty(0))
                self._g_mult.append(0)
            self._g_key[slot] = gkey
            self._g_cols[slot] = np.fromiter(
                counts.keys(), dtype=np.int64, count=len(counts)
            )
            self._g_wts[slot] = np.fromiter(
                counts.values(), dtype=np.float64, count=len(counts)
            )
            self._g_mult[slot] = 0
            self._groups[gkey] = slot
            self._csr_dirty = True
        self._g_mult[slot] += 1
        self._slot_of[flow.fid] = slot

    def flow_removed(self, flow: "Flow") -> None:
        slot = self._slot_of.pop(flow.fid, None)
        if slot is None:
            return
        self._g_mult[slot] -= 1
        if self._g_mult[slot] <= 0:
            gkey = self._g_key[slot]
            self._g_key[slot] = None
            del self._groups[gkey]
            self._free.append(slot)
            self._csr_dirty = True

    def capacity_changed(self) -> None:
        self._cap_dirty = True

    # -- lazy array materialization ----------------------------------------
    def _build_cap(self) -> None:
        net = self.net
        self._cap = np.fromiter(
            (net.constraint_capacity(k) for k in self._keys),
            dtype=np.float64,
            count=len(self._keys),
        )
        self._cap_dirty = False

    def _build_csr(self) -> None:
        rows = [s for s, k in enumerate(self._g_key) if k is not None]
        self._rows = np.asarray(rows, dtype=np.int64)
        nnz = [len(self._g_cols[s]) for s in rows]
        self._indptr = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(nnz, out=self._indptr[1:])
        if rows:
            self._indices = np.concatenate([self._g_cols[s] for s in rows])
            self._weights = np.concatenate([self._g_wts[s] for s in rows])
        else:
            self._indices = np.empty(0, dtype=np.int64)
            self._weights = np.empty(0)
        self._row_of_nnz = np.repeat(
            np.arange(len(rows), dtype=np.int64),
            np.asarray(nnz, dtype=np.int64) if rows else 0,
        )
        self._csr_dirty = False

    # -- the water-filling loop --------------------------------------------
    def solve(self) -> list["Flow"]:
        net = self.net
        flows = net.flows
        rec = net.telemetry is not None
        if not flows:
            self.last_attribution = {} if rec else None
            return []
        if self._cap_dirty:
            self._build_cap()
        if self._csr_dirty:
            self._build_csr()
        n_g = len(self._rows)
        n_l = len(self._keys)
        mult = np.fromiter(
            (self._g_mult[s] for s in self._rows), dtype=np.float64, count=n_g
        )
        # per-nnz consumption weight: duplicate-link count x group size
        wt = self._weights * mult[self._row_of_nnz]
        count = np.zeros(n_l)
        np.add.at(count, self._indices, wt)
        residual = self._cap[:n_l].copy()
        rate = np.zeros(n_g)
        frozen = np.zeros(n_g, dtype=bool)
        slot_attr: dict[int, Hashable] = {}
        n_left = n_g
        while n_left > 0:
            with np.errstate(divide="ignore", invalid="ignore"):
                share = np.where(count > 0, residual / count, np.inf)
            best = share.min(initial=np.inf)
            if not math.isfinite(best):
                break
            level = best * (1 + LEVEL_RTOL)
            at_level = (count > 0) & (share <= level)
            hit = np.zeros(n_g, dtype=bool)
            hit[self._row_of_nnz[at_level[self._indices]]] = True
            new = hit & ~frozen
            if not new.any():       # numerical guard; cannot happen in exact
                break               # arithmetic (the best link has members)
            rate[new] = best
            frozen |= new
            n_left -= int(new.sum())
            if rec:
                # canonical bottleneck per newly frozen group: min key
                # among the group's constraints sitting at this round's
                # freeze level (matches the reference solver's round-start
                # level set — same arithmetic, same tuple ordering)
                keys = self._keys
                indptr = self._indptr
                indices = self._indices
                for row in np.nonzero(new)[0]:
                    cols = indices[indptr[row]:indptr[row + 1]]
                    cands = cols[at_level[cols]]
                    pick = cands if cands.size else cols
                    slot_attr[int(self._rows[row])] = min(
                        keys[c] for c in pick
                    )
            sel = new[self._row_of_nnz]
            np.add.at(residual, self._indices[sel], -best * wt[sel])
            np.add.at(count, self._indices[sel], -wt[sel])
            np.maximum(residual, 0.0, out=residual)
        # scatter group rates back onto the flow objects (as native floats
        # so downstream timestamps stay plain Python numbers)
        slot_rate = np.zeros(len(self._g_key))
        slot_rate[self._rows] = rate
        rates = slot_rate.tolist()
        slot_of = self._slot_of
        flowing = []
        if rec:
            attr: dict[int, Hashable] = {}
            for f in flows.values():
                slot = slot_of[f.fid]
                r = rates[slot]
                f.rate = r
                if r > 0.0:
                    flowing.append(f)
                key = slot_attr.get(slot)
                if key is not None:
                    attr[f.fid] = key
            self.last_attribution = attr
            return flowing
        for f in flows.values():
            r = rates[slot_of[f.fid]]
            f.rate = r
            if r > 0.0:
                flowing.append(f)
        return flowing


SOLVERS = {
    "reference": ReferenceMaxMinSolver,
    "vectorized": VectorizedMaxMinSolver,
}


def make_solver(name: str, net: "FluidNetwork"):
    try:
        return SOLVERS[name](net)
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; pick one of {sorted(SOLVERS)}"
        ) from None
