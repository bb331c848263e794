"""The port's own copy of ``repro/netsim/telemetry.py``, held to the original by
``tests/test_torch_netsim_properties.py``; only its imports of the package differ.

Opt-in telemetry recorder for the netsim stack (observability layer).

A ``Telemetry`` instance threads through the event engine, the fluid
network, both max-min solvers and the ``Router`` and records what the
end-of-run scalars on ``NetSimResult`` cannot show:

* **per-link utilization timelines** — at every rate-resolve event the
  summed rate of each wire link is sampled into a piecewise-constant
  series (a sample holds until the next one), so the integral of a link's
  timeline equals its byte ledger exactly — the conservation property the
  property suite pins;
* **per-flow lifecycle traces** — launch, rate changes, completion /
  withdrawal, delivered bytes, per-member multiplicity;
* **bottleneck attribution** — for every flow, which constraint (wire
  link, receiver-egress ``rx`` port, per-dim ``io`` port) froze it in the
  water-filling, read directly from the solver's freeze step.  Both
  solvers emit the canonical attribution — the *smallest* constraint key
  (plain tuple order; every key is an int tuple) among the flow's
  constraints that sat at the round's freeze level when the flow froze —
  so the vectorized and reference solvers produce identical telemetry,
  with aggregate / symmetric groups expanded by their multiplicity in the
  throttle accounting;
* **router counters** — transfers, multi-path launches, borrow-path
  usage, congestion re-splits, failure-notification reroutes, with
  timestamped instants for failures and reroutes.

Exporters: :meth:`Telemetry.to_perfetto` writes a Chrome/Perfetto trace
JSON (counter tracks for the hot links, one span lane per collective
ring, async spans per routed transfer, instants for reroutes/failures —
load it at https://ui.perfetto.dev), and :meth:`Telemetry.summary`
returns a structured dict (per-dim utilization percentiles, top-k hot
links, per-constraint-class throttle seconds, stranded-byte audit).

The recorder is strictly opt-in: every hook in the hot paths is guarded
by a single ``is not None`` check, so a disabled run (``telemetry=None``,
the default everywhere) pays nothing — pinned by the
``netsim_telemetry_overhead`` scale benchmark.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Hashable

from .flows import IO_RX, IO_TX, RX_PORT, DirectedLink

if TYPE_CHECKING:  # pragma: no cover
    from .flows import Flow, FluidNetwork

# collective ring-step tags end in "s<step>" ("ar-dim0/r3s7"); stripping
# the step suffix yields the ring lane the steps run sequentially on
_STEP_SUFFIX = re.compile(r"s\d+$")


def constraint_class(key: Hashable) -> str:
    """``"link"`` (wire), ``"rx"`` (receiver egress) or ``"io"`` (per-dim
    IO port) for any constraint key the solvers emit."""
    k0 = key[0]
    if k0 == RX_PORT:
        return "rx"
    if k0 == IO_TX or k0 == IO_RX:
        return "io"
    return "link"


def constraint_name(key: Hashable) -> str:
    """Human-readable label for a constraint key."""
    k0 = key[0]
    if k0 == RX_PORT:
        return f"rx:{key[1]}"
    if k0 == IO_TX:
        return f"io_tx:d{key[1]}:n{key[2]}"
    if k0 == IO_RX:
        return f"io_rx:d{key[1]}:n{key[2]}"
    return f"{key[0]}->{key[1]}"


def _weighted_percentile(samples: "list[tuple[float, float]]", q: float) -> float:
    """Percentile of (value, weight) samples, weight-interpolated."""
    if not samples:
        return 0.0
    samples = sorted(samples)
    total = sum(w for _, w in samples)
    if total <= 0:
        return samples[-1][0]
    target = q * total
    acc = 0.0
    for v, w in samples:
        acc += w
        if acc >= target:
            return v
    return samples[-1][0]


@dataclass
class FlowTrace:
    """Lifecycle record of one fluid flow."""

    fid: int
    path: tuple[int, ...]
    size: float                          # bytes per member
    multiplicity: int
    start_s: float
    end_s: float | None = None
    delivered: float = 0.0               # bytes, member-expanded
    withdrawn: bool = False
    task: int | None = None              # DAG task tid, when known
    rates: list[tuple[float, float]] = field(default_factory=list)
    bottlenecks: list[tuple[float, Hashable]] = field(default_factory=list)

    @property
    def bottleneck(self) -> Hashable | None:
        """The constraint that froze this flow at its last rate solve."""
        return self.bottlenecks[-1][1] if self.bottlenecks else None


class Telemetry:
    """Recorder threaded through engine, network, solver and router.

    Create one, hand it to ``FluidNetwork(..., telemetry=tel)`` (or let
    ``NetSim(telemetry=True)`` do it), run, then read ``summary()`` /
    ``to_perfetto(path)``.  One instance records one network's run;
    virtual time restarts per run, so reuse across runs would alias
    timelines.
    """

    def __init__(self) -> None:
        self.net: "FluidNetwork | None" = None
        self.samples = 0                     # rate-resolve events recorded
        self.events_observed = 0             # engine events (observer hook)
        # piecewise-constant per-link rate series: a sample (t, rate)
        # holds until the next sample on that link
        self.link_series: dict[DirectedLink, list[tuple[float, float]]] = {}
        self._last_rate: dict[DirectedLink, float] = {}
        self.flow_traces: dict[int, FlowTrace] = {}
        # constraint key -> flow-seconds throttled (multiplicity-weighted)
        self.bottleneck_s: dict[Hashable, float] = {}
        self._open: dict[int, tuple[Hashable, int, float]] = {}
        self.task_labels: dict[int, str] = {}          # DAG tid -> tag
        self.bytes_withdrawn_unsent = 0.0
        # router-side counters and timestamped instants
        self.router_counters: dict[str, int] = {
            "transfers": 0,
            "subflow_launches": 0,
            "multipath_launches": 0,
            "borrow_path_launches": 0,
            "resplits": 0,
            "reroutes": 0,
            "link_failures": 0,
        }
        self.instants: list[tuple[float, str, dict]] = []
        self.transfer_spans: list[dict] = []   # finished routed transfers

    # -- wiring ------------------------------------------------------------
    def _attach(self, net: "FluidNetwork") -> None:
        if self.net is not None and self.net is not net:
            raise ValueError(
                "a Telemetry instance records one network; create a fresh "
                "one per run"
            )
        self.net = net
        net.engine.observer = self._on_event

    def _on_event(self, t: float) -> None:
        self.events_observed += 1

    @staticmethod
    def _task_of(meta: object) -> int | None:
        """DAG task tid from a flow's meta chain (("task", tid) directly,
        or via a routed Transfer's own meta)."""
        for _ in range(2):
            if (
                isinstance(meta, tuple)
                and len(meta) == 2
                and meta[0] == "task"
            ):
                return meta[1]
            meta = getattr(meta, "meta", None)
        return None

    # -- hooks: flow lifecycle (called by FluidNetwork) --------------------
    def flow_started(self, flow: "Flow") -> None:
        self.flow_traces[flow.fid] = FlowTrace(
            fid=flow.fid,
            path=flow.path,
            size=flow.size,
            multiplicity=flow.multiplicity,
            start_s=flow.start_s,
            task=self._task_of(flow.meta),
        )

    def flow_completed(self, flow: "Flow") -> None:
        now = self.net.engine.now
        tr = self.flow_traces.get(flow.fid)
        if tr is None:                      # degenerate flow: never started
            self.flow_started(flow)
            tr = self.flow_traces[flow.fid]
        tr.end_s = now
        tr.delivered = flow.total_bytes
        self._close_attr(flow.fid, now)

    def flow_withdrawn(self, flow: "Flow") -> None:
        now = self.net.engine.now
        tr = self.flow_traces.get(flow.fid)
        if tr is None:
            return
        tr.end_s = now
        tr.withdrawn = True
        unsent = max(0.0, flow.remaining) * flow.multiplicity
        tr.delivered = flow.total_bytes - unsent
        self.bytes_withdrawn_unsent += unsent
        self._close_attr(flow.fid, now)

    def _close_attr(self, fid: int, now: float) -> None:
        open_ = self._open.pop(fid, None)
        if open_ is not None:
            key, mult, since = open_
            if now > since:
                self.bottleneck_s[key] = (
                    self.bottleneck_s.get(key, 0.0) + (now - since) * mult
                )

    # -- hook: rate resolve (called by FluidNetwork._maxmin_rates) ---------
    def record_solve(
        self,
        now: float,
        flows: "dict[int, Flow]",
        attribution: "dict[int, Hashable] | None",
        flowing: "list[Flow]",
    ) -> None:
        """One water-filling resolution: sample link rates, refresh the
        per-flow bottleneck attribution, extend rate histories."""
        self.samples += 1
        # per-link rate sampling (changed links only; vanished links -> 0)
        used: dict[DirectedLink, float] = {}
        for f in flowing:
            r = f.rate
            for l in f.links:
                used[l] = used.get(l, 0.0) + r
        last = self._last_rate
        series = self.link_series
        for l, r in used.items():
            if last.get(l) != r:
                series.setdefault(l, []).append((now, r))
                last[l] = r
        for l, r in list(last.items()):
            if r != 0.0 and l not in used:
                series[l].append((now, 0.0))
                last[l] = 0.0
        # bottleneck attribution intervals (multiplicity-weighted)
        bs = self.bottleneck_s
        for key, mult, since in self._open.values():
            if now > since:
                bs[key] = bs.get(key, 0.0) + (now - since) * mult
        if attribution:
            self._open = {
                fid: (key, flows[fid].multiplicity, now)
                for fid, key in attribution.items()
                if fid in flows
            }
        else:
            self._open = {}
        # per-flow histories (on change only)
        traces = self.flow_traces
        for f in flows.values():
            tr = traces.get(f.fid)
            if tr is None:
                continue
            if not tr.rates or tr.rates[-1][1] != f.rate:
                tr.rates.append((now, f.rate))
            if attribution:
                key = attribution.get(f.fid)
                if key is not None and (
                    not tr.bottlenecks or tr.bottlenecks[-1][1] != key
                ):
                    tr.bottlenecks.append((now, key))

    # -- hooks: router (called by Router) ----------------------------------
    def record_launch(self, paths: list, switch_node: int | None) -> None:
        c = self.router_counters
        c["subflow_launches"] += len(paths)
        if len(paths) > 1:
            c["multipath_launches"] += 1
        if switch_node is not None and any(switch_node in p for p in paths):
            c["borrow_path_launches"] += 1

    def record_instant(self, name: str, args: dict) -> None:
        self.instants.append((self.net.engine.now, name, args))
        if name in self.router_counters:
            self.router_counters[name] += 1

    def record_transfer_done(self, t) -> None:
        self.transfer_spans.append(
            {
                "tid": t.tid,
                "src": t.src,
                "dst": t.dst,
                "size": t.size,
                "start_s": t.start_s,
                "end_s": t.end_s,
                "resplits": t.resplits,
                "task": self._task_of(t.meta),
            }
        )

    # -- derived views -----------------------------------------------------
    def _cap(self, link: DirectedLink) -> float:
        return self.net.capacity.get(link, 0.0) if self.net else 0.0

    def _segments(self, link: DirectedLink):
        """(t0, t1, rate) segments of a link's piecewise-constant series,
        closed at the engine's current time."""
        series = self.link_series.get(link)
        if not series:
            return
        end = self.net.engine.now
        for (t, r), (t_next, _) in zip(series, series[1:]):
            yield t, t_next, r
        t, r = series[-1]
        yield t, max(t, end), r

    def link_bytes(self, link: DirectedLink) -> float:
        """Integral of the link's rate timeline — must equal the fluid
        network's byte ledger for that link (conservation)."""
        return sum((t1 - t0) * r for t0, t1, r in self._segments(link))

    def peak_utilization(self, link: DirectedLink) -> float:
        """Highest utilization the link *held* (zero-duration transients
        between same-timestamp re-solves are skipped)."""
        cap = self._cap(link)
        if cap <= 0:
            return 0.0
        peak = 0.0
        for t0, t1, r in self._segments(link):
            if t1 > t0 and r > peak:
                peak = r
        return peak / cap

    def mean_utilization(self, link: DirectedLink) -> float:
        cap = self._cap(link)
        dur = self.net.engine.now if self.net else 0.0
        if cap <= 0 or dur <= 0:
            return 0.0
        return self.link_bytes(link) / (cap * dur)

    def flow_bottlenecks(self) -> dict[int, Hashable]:
        """fid -> the constraint that froze the flow at its last solve."""
        return {
            fid: tr.bottleneck
            for fid, tr in self.flow_traces.items()
            if tr.bottleneck is not None
        }

    # -- exporter: structured summary --------------------------------------
    def summary(self, *, top: int = 8) -> dict:
        """Structured run digest.  Schema (see README "Observability"):

        ``duration_s``, ``events``, ``solver_samples``;
        ``links``: ``per_dim`` {dim name: {p50, p99, max}} (time-weighted
        utilization over every link segment of the dim), ``top`` hot links
        [{link, dim, peak_util, mean_util, bytes}];
        ``bottlenecks``: ``by_class`` {link/rx/io: throttled flow-seconds,
        multiplicity-weighted}, ``top`` [[constraint, seconds], ...];
        ``flows``: launched/completed/withdrawn counts + the byte audit
        (requested == delivered + withdrawn_unsent + stranded; stranded
        must be ~0 on a drained run);
        ``router``: the counter dict + instants count.
        """
        net = self.net
        dur = net.engine.now if net else 0.0
        dim_names: dict[int, str] = (
            {i: d.name for i, d in enumerate(net.topo.dims)} if net else {}
        )

        per_dim_samples: dict[str, list[tuple[float, float]]] = {}
        link_rows = []
        for link in self.link_series:
            cap = self._cap(link)
            d = net._link_dim.get(link) if net else None
            dname = dim_names.get(d, "extra")
            if cap > 0:
                bucket = per_dim_samples.setdefault(dname, [])
                for t0, t1, r in self._segments(link):
                    if t1 > t0:
                        bucket.append((r / cap, t1 - t0))
            link_rows.append(
                {
                    "link": list(link),
                    "dim": dname,
                    "peak_util": round(self.peak_utilization(link), 6),
                    "mean_util": round(self.mean_utilization(link), 6),
                    "bytes": self.link_bytes(link),
                }
            )
        link_rows.sort(key=lambda r: -r["peak_util"])
        per_dim = {
            dname: {
                "p50": round(_weighted_percentile(samples, 0.50), 6),
                "p99": round(_weighted_percentile(samples, 0.99), 6),
                "max": round(max(v for v, _ in samples), 6),
            }
            for dname, samples in sorted(per_dim_samples.items())
        }

        by_class: dict[str, float] = {}
        for key, s in self.bottleneck_s.items():
            c = constraint_class(key)
            by_class[c] = by_class.get(c, 0.0) + s
        top_bn = sorted(
            self.bottleneck_s.items(), key=lambda kv: -kv[1]
        )[:top]

        requested = sum(
            tr.size * tr.multiplicity for tr in self.flow_traces.values()
        )
        delivered = sum(tr.delivered for tr in self.flow_traces.values())
        completed = sum(
            1
            for tr in self.flow_traces.values()
            if tr.end_s is not None and not tr.withdrawn
        )
        withdrawn = sum(1 for tr in self.flow_traces.values() if tr.withdrawn)
        stranded = requested - delivered - self.bytes_withdrawn_unsent

        return {
            "duration_s": dur,
            "events": net.engine.events_fired if net else 0,
            "solver_samples": self.samples,
            "links": {"per_dim": per_dim, "top": link_rows[:top]},
            "bottlenecks": {
                "by_class": {k: round(v, 9) for k, v in sorted(by_class.items())},
                "top": [
                    [constraint_name(k), round(s, 9)] for k, s in top_bn
                ],
            },
            "flows": {
                "launched": len(self.flow_traces),
                "completed": completed,
                "withdrawn": withdrawn,
                "bytes_requested": requested,
                "bytes_delivered": delivered,
                "bytes_withdrawn_unsent": self.bytes_withdrawn_unsent,
                "stranded_bytes": stranded,
            },
            "router": {
                **self.router_counters,
                "instants": len(self.instants),
                "transfers_done": len(self.transfer_spans),
            },
        }

    # -- exporter: Chrome/Perfetto trace JSON ------------------------------
    def to_perfetto(self, path: str | None = None, *, top_links: int = 16) -> dict:
        """Write a Chrome trace-event JSON loadable at ui.perfetto.dev.

        * pid 1 — one counter track per hot link (utilization 0..1);
        * pid 2 — one span lane per collective ring (ring steps are
          sequential by construction), spans labeled with the task tag;
        * pid 3 — async spans per routed transfer plus instant events for
          link failures and reroutes.

        Timestamps are virtual seconds scaled to microseconds.  Returns
        the trace dict; also writes it to ``path`` when given.
        """
        us = 1e6
        ev: list[dict] = [
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "links (utilization)"}},
            {"ph": "M", "pid": 2, "tid": 0, "name": "process_name",
             "args": {"name": "collective tasks"}},
            {"ph": "M", "pid": 3, "tid": 0, "name": "process_name",
             "args": {"name": "router transfers"}},
        ]
        # counter tracks for the hottest links (by peak utilization)
        hot = sorted(
            self.link_series,
            key=lambda l: -self.peak_utilization(l),
        )[:top_links]
        end = self.net.engine.now if self.net else 0.0
        for link in hot:
            cap = self._cap(link)
            d = self.net._link_dim.get(link) if self.net else None
            dname = (
                self.net.topo.dims[d].name
                if self.net is not None and d is not None
                else "extra"
            )
            name = f"link {link[0]}->{link[1]} [{dname}]"
            for t, r in self.link_series[link]:
                ev.append(
                    {"name": name, "ph": "C", "ts": t * us, "pid": 1,
                     "tid": 0, "args": {"util": r / cap if cap else 0.0}}
                )
            ev.append(
                {"name": name, "ph": "C", "ts": end * us, "pid": 1,
                 "tid": 0, "args": {"util": 0.0}}
            )
        # collective ring-step spans, one lane per ring
        lanes: dict[str, int] = {}
        for tr in self.flow_traces.values():
            if tr.task is None or tr.end_s is None:
                continue
            label = self.task_labels.get(tr.task, f"task{tr.task}")
            lane = _STEP_SUFFIX.sub("", label) or label
            tid = lanes.setdefault(lane, len(lanes) + 1)
            ev.append(
                {"name": label, "ph": "X", "ts": tr.start_s * us,
                 "dur": max(0.0, (tr.end_s - tr.start_s)) * us,
                 "pid": 2, "tid": tid,
                 "args": {"bytes": tr.size * tr.multiplicity,
                          "multiplicity": tr.multiplicity,
                          "withdrawn": tr.withdrawn}}
            )
        for lane, tid in lanes.items():
            ev.append(
                {"ph": "M", "pid": 2, "tid": tid, "name": "thread_name",
                 "args": {"name": lane}}
            )
        # routed transfers as async spans (overlap-safe), id = transfer id
        for span in self.transfer_spans:
            name = f"xfer {span['src']}->{span['dst']}"
            common = {"cat": "transfer", "name": name, "pid": 3, "tid": 0,
                      "id": span["tid"]}
            ev.append({**common, "ph": "b", "ts": span["start_s"] * us,
                       "args": {"bytes": span["size"],
                                "resplits": span["resplits"]}})
            ev.append({**common, "ph": "e", "ts": span["end_s"] * us})
        # instants: failures, reroutes
        for t, name, args in self.instants:
            ev.append(
                {"name": name, "ph": "i", "ts": t * us, "pid": 3, "tid": 0,
                 "s": "g", "args": args}
            )
        trace = {"traceEvents": ev, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as fh:
                json.dump(trace, fh)
        return trace


def perfetto_doc(
    counters: "dict[str, list[tuple[float, float]]]" = {},
    spans: "list[dict]" = [],
    instants: "list[tuple[float, str, dict]]" = [],
    *,
    time_scale: float = 1e6,
    path: str | None = None,
) -> dict:
    """Assemble a Chrome trace-event JSON from plain timeline data.

    The generic sibling of :meth:`Telemetry.to_perfetto` for producers
    that are not a FluidNetwork — e.g. the availability campaign's
    week-scale failure/goodput timelines.  ``counters`` maps track name
    to ``(t, value)`` samples (ph "C"); ``spans`` are dicts with
    ``name``/``start``/``end`` plus optional ``lane`` and ``args``
    (ph "X", one tid per lane); ``instants`` are ``(t, name, args)``
    (ph "i").  Times are scaled by ``time_scale`` into trace-event
    microseconds (1e6 = input in seconds; use 3600e6 for hours)."""
    ev: list[dict] = [
        {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
         "args": {"name": "counters"}},
        {"ph": "M", "pid": 2, "tid": 0, "name": "process_name",
         "args": {"name": "spans"}},
    ]
    for name, series in counters.items():
        for t, v in series:
            ev.append(
                {"name": name, "ph": "C", "ts": t * time_scale, "pid": 1,
                 "tid": 0, "args": {"value": v}}
            )
    lanes: dict[str, int] = {}
    for span in spans:
        lane = span.get("lane", span["name"])
        tid = lanes.setdefault(lane, len(lanes) + 1)
        ev.append(
            {"name": span["name"], "ph": "X",
             "ts": span["start"] * time_scale,
             "dur": max(0.0, span["end"] - span["start"]) * time_scale,
             "pid": 2, "tid": tid, "args": span.get("args", {})}
        )
    for lane, tid in lanes.items():
        ev.append(
            {"ph": "M", "pid": 2, "tid": tid, "name": "thread_name",
             "args": {"name": lane}}
        )
    for t, name, args in instants:
        ev.append(
            {"name": name, "ph": "i", "ts": t * time_scale, "pid": 2,
             "tid": 0, "s": "g", "args": args}
        )
    trace = {"traceEvents": ev, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as fh:
            json.dump(trace, fh)
    return trace
