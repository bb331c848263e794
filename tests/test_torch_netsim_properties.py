"""The reference's ``tests/test_netsim_properties.py`` restated against the
port's ``repro_torch.netsim``, every case.

Property-based invariant suite for the netsim fluid solvers.

Randomized meshes and flow sets (plain multi-hop flows + aggregate
ring-step flows) must satisfy, under EVERY cap configuration (no caps,
receiver-egress ``rx_gbs``, per-dim ``dim_io_gbs``, both) and under BOTH
solvers (vectorized numpy water-filling and the pure-Python reference):

(a) **capacity** — the summed rate on every constraint (wire link,
    virtual rx port, per-dim IO port) never exceeds its capacity;
(b) **max-min fairness** — every flow has a bottleneck: a saturated
    constraint on its path where no other flow runs faster, i.e. no flow
    can be sped up without slowing a flow that is no faster;
(c) **solver parity** — vectorized and reference allocations agree to
    1e-6 relative on every flow;
(d) **conservation** — running to completion delivers exactly the
    requested bytes per flow, and the per-link byte ledger equals
    sum(size x links crossed) including aggregate multiplicity;
(e) **aggregate equivalence** — a symmetric ring step executed as one
    weighted aggregate flow completes exactly when its member-by-member
    expansion does;
(f) **telemetry parity** — with a ``Telemetry`` recorder attached, the
    vectorized and reference solvers emit identical bottleneck
    attributions (final constraint per flow AND the full dedup'd history),
    and every link's recorded utilization timeline integrates to exactly
    the fluid network's byte ledger for that link.

Two drivers share the same checkers: a seeded corpus that always runs
(``TestSeededInvariants``) and hypothesis-driven exploration
(``TestHypothesisInvariants``) via the ``tests/_hypothesis_compat.py``
shim — with hypothesis installed (the dev extra) the fixed ``ci``
profile from ``tests/conftest.py`` applies (derandomized, no deadline).
"""

import random

import pytest

from _hypothesis_compat import given, settings, st  # hypothesis or skip-shim

from repro_torch.core.topology import (
    ACTIVE_ELECTRICAL,
    DimSpec,
    NDFullMesh,
    PASSIVE_ELECTRICAL,
)
from repro_torch.netsim import FluidNetwork, Telemetry
from repro_torch.netsim.collectives import clique_nodes

CAP_MODES = ("none", "rx", "io", "rx+io")
SEEDS = range(3)
SOLVERS = ("vectorized", "reference")

_REL = 1e-6          # solver freeze tolerance (LEVEL_RTOL) plus fp headroom
_ABS = 1.0           # bytes/s absolute slack on ~1e9-scale capacities


# ---------------------------------------------------------------------------
# randomized scenario generation (shared by the seeded and hypothesis drivers)
# ---------------------------------------------------------------------------


def _random_topo(rng: random.Random) -> NDFullMesh:
    ndim = rng.randint(1, 3)
    dims = tuple(
        DimSpec(
            f"D{i}",
            rng.randint(2, 4),
            PASSIVE_ELECTRICAL if i < 2 else ACTIVE_ELECTRICAL,
            rng.choice((1, 2, 4)),
        )
        for i in range(ndim)
    )
    return NDFullMesh(dims=dims)


def _random_path(topo: NDFullMesh, rng: random.Random) -> tuple[int, ...]:
    """A loop-free dimension-hopping walk of 1-3 direct-link hops."""
    node = rng.randrange(topo.num_nodes)
    path = [node]
    for _ in range(rng.randint(1, 3)):
        c = list(topo.coords(path[-1]))
        d = rng.randrange(topo.ndim)
        c[d] = rng.choice([v for v in range(topo.shape[d]) if v != c[d]])
        nxt = topo.node_id(c)
        if nxt not in path:
            path.append(nxt)
    return tuple(path)


def _scenario(seed: int, caps: str):
    """(topo, rx, dim_io, path flows, aggregate flows) for one case."""
    rng = random.Random(seed * 7919 + len(caps))
    topo = _random_topo(rng)
    rx = None
    dim_io = None
    if "rx" in caps:
        rx = max(d.gbs_total for d in topo.dims) * rng.uniform(0.3, 1.0)
    if "io" in caps:
        d = topo.ndim - 1
        dim_io = {d: topo.dims[d].gbs_per_peer * rng.uniform(0.5, 2.0)}
    paths = []
    for _ in range(rng.randint(3, 10)):
        p = _random_path(topo, rng)
        if len(p) >= 2:
            paths.append((p, rng.uniform(1e6, 1e8)))
    aggs = []
    for _ in range(rng.randint(0, 2)):
        dim = rng.randrange(topo.ndim)
        nodes = clique_nodes(topo, dim)
        if len(nodes) >= 2:
            pairs = tuple(
                (nodes[i], nodes[(i + 1) % len(nodes)])
                for i in range(len(nodes))
            )
            aggs.append((pairs, rng.uniform(1e6, 1e8)))
    return topo, rx, dim_io, paths, aggs


def _build(topo, rx, dim_io, paths, aggs, solver):
    net = FluidNetwork(topo, rx_gbs=rx, dim_io_gbs=dim_io, solver=solver)
    flows = [net.add_flow(p, s) for p, s in paths]
    flows += [net.add_aggregate_flow(pairs, s) for pairs, s in aggs]
    net._recompute()
    return net, flows


# ---------------------------------------------------------------------------
# the invariant checkers
# ---------------------------------------------------------------------------


def _loads(net):
    """Summed rate per constraint key (multiset-aware: a key occurring k
    times in a flow's constraint tuple is consumed k times)."""
    load: dict = {}
    users: dict = {}
    for f in net.flows.values():
        for c in f.constraints:
            load[c] = load.get(c, 0.0) + f.rate
            users.setdefault(c, []).append(f)
    return load, users


def check_capacity(net) -> None:
    load, _ = _loads(net)
    for c, l in load.items():
        cap = net.constraint_capacity(c)
        assert l <= cap * (1 + _REL) + _ABS, (
            f"constraint {c} overloaded: {l} > {cap}"
        )


def check_maxmin(net) -> None:
    load, users = _loads(net)
    for f in net.flows.values():
        assert f.rate > 0.0, f"flow {f.fid} starved with live capacity"
        bottleneck = None
        for c in set(f.constraints):
            cap = net.constraint_capacity(c)
            if load[c] < cap * (1 - _REL) - _ABS:
                continue                      # not saturated
            fastest = max(g.rate for g in users[c])
            if f.rate >= fastest * (1 - _REL):
                bottleneck = c
                break
        assert bottleneck is not None, (
            f"flow {f.fid} (rate {f.rate}) could be increased without "
            f"hurting a slower flow — not max-min fair"
        )


def check_parity(net_a, net_b) -> None:
    assert set(net_a.flows) == set(net_b.flows)
    for fid, fa in net_a.flows.items():
        fb = net_b.flows[fid]
        scale = max(fa.rate, fb.rate, 1.0)
        assert abs(fa.rate - fb.rate) / scale <= 1e-6, (
            f"flow {fid}: vectorized {fa.rate} vs reference {fb.rate}"
        )


def check_conservation(net, flows) -> None:
    net.run()
    assert not net.flows, "flows left hanging after run()"
    expected = sum(f.total_bytes for f in flows)
    assert net.bytes_delivered == pytest.approx(expected, rel=1e-6)
    for f in flows:
        assert f.remaining <= 1e-5
        assert f.end_s is not None
    ledger = sum(net.link_bytes.values())
    wire = sum(f.size * len(f.links) for f in flows)
    assert ledger == pytest.approx(wire, rel=1e-6)


def _check_telemetry_parity(seed: int, caps: str) -> None:
    """Both solvers, recorded end-to-end: identical attributions and
    byte-conserving link timelines."""
    topo, rx, dim_io, paths, aggs = _scenario(seed, caps)
    if not paths and not aggs:
        pytest.skip("degenerate scenario")
    tels: dict[str, Telemetry] = {}
    nets: dict[str, FluidNetwork] = {}
    for solver in SOLVERS:
        tel = Telemetry()
        net = FluidNetwork(
            topo, rx_gbs=rx, dim_io_gbs=dim_io, solver=solver, telemetry=tel
        )
        for p, s in paths:
            net.add_flow(p, s)
        for pairs, s in aggs:
            net.add_aggregate_flow(pairs, s)
        net.run()
        tels[solver], nets[solver] = tel, net
    tv, tr = tels["vectorized"], tels["reference"]
    # identical final attribution per flow (exact key equality: both
    # solvers apply the same canonical min-key-at-freeze-level rule)
    assert tv.flow_bottlenecks() == tr.flow_bottlenecks()
    # ... and the full attribution history (dedup'd key sequence)
    for fid, trace_v in tv.flow_traces.items():
        hist_v = [k for _, k in trace_v.bottlenecks]
        hist_r = [k for _, k in tr.flow_traces[fid].bottlenecks]
        assert hist_v == hist_r, f"flow {fid}: {hist_v} != {hist_r}"
    # timeline integral == byte ledger, per link, per solver
    for solver in SOLVERS:
        net, tel = nets[solver], tels[solver]
        assert set(tel.link_series) <= set(net.link_bytes)
        for link, b in net.link_bytes.items():
            assert tel.link_bytes(link) == pytest.approx(b, rel=1e-6), (
                f"{solver} link {link}: timeline != ledger"
            )


def _run_invariant(seed: int, caps: str, solver: str, which: str) -> None:
    topo, rx, dim_io, paths, aggs = _scenario(seed, caps)
    if not paths and not aggs:
        pytest.skip("degenerate scenario")
    if which == "parity":
        net_v, _ = _build(topo, rx, dim_io, paths, aggs, "vectorized")
        net_r, _ = _build(topo, rx, dim_io, paths, aggs, "reference")
        check_parity(net_v, net_r)
        return
    net, flows = _build(topo, rx, dim_io, paths, aggs, solver)
    if which == "capacity":
        check_capacity(net)
    elif which == "maxmin":
        check_maxmin(net)
    elif which == "conservation":
        check_conservation(net, flows)
    else:  # pragma: no cover
        raise AssertionError(which)


def _check_aggregate_equivalence(seed: int, caps: str, solver: str) -> None:
    """One symmetric ring step: aggregate vs expanded completion parity."""
    rng = random.Random(seed * 104729 + 17)
    topo = _random_topo(rng)
    dim = rng.randrange(topo.ndim)
    nodes = clique_nodes(topo, dim)
    if len(nodes) < 2:
        pytest.skip("degenerate clique")
    pairs = tuple(
        (nodes[i], nodes[(i + 1) % len(nodes)]) for i in range(len(nodes))
    )
    size = rng.uniform(1e6, 1e8)
    rx = None
    dim_io = None
    if "rx" in caps:
        rx = max(d.gbs_total for d in topo.dims) * rng.uniform(0.3, 1.0)
    if "io" in caps:
        dim_io = {dim: topo.dims[dim].gbs_per_peer * rng.uniform(0.5, 2.0)}
    agg = FluidNetwork(topo, rx_gbs=rx, dim_io_gbs=dim_io, solver=solver)
    agg.add_aggregate_flow(pairs, size)
    agg.run()
    exp = FluidNetwork(topo, rx_gbs=rx, dim_io_gbs=dim_io, solver=solver)
    for u, v in pairs:
        exp.add_flow((u, v), size)
    exp.run()
    assert agg.engine.now == pytest.approx(exp.engine.now, rel=1e-9)
    assert agg.bytes_delivered == pytest.approx(
        exp.bytes_delivered, rel=1e-9
    )


# ---------------------------------------------------------------------------
# seeded corpus — always runs (no hypothesis required)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("caps", CAP_MODES)
@pytest.mark.parametrize("seed", SEEDS)
class TestSeededInvariants:
    def test_capacity_respected(self, seed, caps):
        for solver in SOLVERS:
            _run_invariant(seed, caps, solver, "capacity")

    def test_maxmin_bottleneck(self, seed, caps):
        for solver in SOLVERS:
            _run_invariant(seed, caps, solver, "maxmin")

    def test_solver_parity(self, seed, caps):
        _run_invariant(seed, caps, None, "parity")

    def test_conservation(self, seed, caps):
        for solver in SOLVERS:
            _run_invariant(seed, caps, solver, "conservation")

    def test_aggregate_equivalence(self, seed, caps):
        for solver in SOLVERS:
            _check_aggregate_equivalence(seed, caps, solver)

    def test_telemetry_parity(self, seed, caps):
        _check_telemetry_parity(seed, caps)


# ---------------------------------------------------------------------------
# hypothesis exploration — same checkers, generated seeds/cap modes
# ---------------------------------------------------------------------------


class TestHypothesisInvariants:
    @given(seed=st.integers(0, 10**6), caps=st.sampled_from(CAP_MODES))
    @settings(max_examples=20)
    def test_capacity_respected(self, seed, caps):
        for solver in SOLVERS:
            _run_invariant(seed, caps, solver, "capacity")

    @given(seed=st.integers(0, 10**6), caps=st.sampled_from(CAP_MODES))
    @settings(max_examples=20)
    def test_maxmin_bottleneck(self, seed, caps):
        for solver in SOLVERS:
            _run_invariant(seed, caps, solver, "maxmin")

    @given(seed=st.integers(0, 10**6), caps=st.sampled_from(CAP_MODES))
    @settings(max_examples=20)
    def test_solver_parity(self, seed, caps):
        _run_invariant(seed, caps, None, "parity")

    @given(seed=st.integers(0, 10**6), caps=st.sampled_from(CAP_MODES))
    @settings(max_examples=10)
    def test_conservation(self, seed, caps):
        for solver in SOLVERS:
            _run_invariant(seed, caps, solver, "conservation")

    @given(seed=st.integers(0, 10**6), caps=st.sampled_from(CAP_MODES))
    @settings(max_examples=10)
    def test_aggregate_equivalence(self, seed, caps):
        for solver in SOLVERS:
            _check_aggregate_equivalence(seed, caps, solver)

    @given(seed=st.integers(0, 10**6), caps=st.sampled_from(CAP_MODES))
    @settings(max_examples=10)
    def test_telemetry_parity(self, seed, caps):
        _check_telemetry_parity(seed, caps)
