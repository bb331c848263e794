"""The port's own copy of ``repro/core/apr.py``, held to the original by
``tests/test_torch_topology.py``; only its imports of the package differ.

All-Path Routing (APR) — paper §4.

APR exposes *all* useful paths between two endpoints of the nD-FullMesh
instead of only the shortest one, enabling Detour (non-shortest paths) and
Borrow (switch-assisted paths) strategies.  Three mechanisms make it cheap:

* **Source Routing** (§4.1.1): the sender encodes per-hop forwarding
  instructions into a compact 8-byte header (Fig. 11).
* **Structured Addressing & Linear Table Lookup** (§4.1.2): addresses are the
  coordinate tuple; each segment (pod / row / rack / board / npu) is a linear
  offset, so next-hop lookup is O(1) array indexing, no LPM/TCAM.
* **Topology-aware deadlock-free Flow Control (TFC)** (§4.1.3): a 2-VL
  scheme; we build the Channel Dependency Graph of the planned paths and
  verify acyclicity.

On a real TPU the ICI router is fixed-function; in this framework APR is the
*path planner* that drives the Multi-Ring collective planner, the borrow/
detour simulator strategies, and fast fault recovery (direct notification,
§4.2).  Everything here is exact and unit-tested.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Sequence

import numpy as np

from .topology import NDFullMesh

Path = tuple[int, ...]  # sequence of node ids, path[0]=src, path[-1]=dst


# ---------------------------------------------------------------------------
# Path enumeration (shortest + detours)
# ---------------------------------------------------------------------------


def shortest_paths(topo: NDFullMesh, src: int, dst: int) -> list[Path]:
    """All shortest paths src->dst.

    In an nD-FullMesh the shortest path fixes each differing coordinate with
    exactly one hop; every ORDER of fixing them is a distinct shortest path,
    so with k differing dims there are k! shortest paths.
    """
    cs, cd = topo.coords(src), topo.coords(dst)
    diff = [i for i, (a, b) in enumerate(zip(cs, cd)) if a != b]
    paths: list[Path] = []
    for order in itertools.permutations(diff):
        cur = list(cs)
        path = [src]
        for d in order:
            cur[d] = cd[d]
            path.append(topo.node_id(cur))
        paths.append(tuple(path))
    return paths or [(src,)] if src == dst else paths


def detour_paths(
    topo: NDFullMesh, src: int, dst: int, *, max_extra_hops: int = 1
) -> list[Path]:
    """Non-shortest APR paths: replace a direct intra-dim hop by a 2-hop
    relay through a third member of the same clique (the Fig. 10-(b) "all
    path" detours).  ``max_extra_hops`` bounds how many hops are relayed.
    """
    out: list[Path] = []
    for base in shortest_paths(topo, src, dst):
        hop_dims = [topo.are_adjacent(u, v) for u, v in zip(base, base[1:])]
        n = len(base) - 1
        for relay_positions in itertools.combinations(range(n), min(max_extra_hops, n)):
            for pos in relay_positions:
                u, v = base[pos], base[pos + 1]
                dim = hop_dims[pos]
                cu = topo.coords(u)
                for w in topo.neighbors(u, dim):
                    if w == v:
                        continue
                    # relay u -> w -> v stays inside the clique of `dim`
                    cand = base[: pos + 1] + (w,) + base[pos + 1 :]
                    if len(set(cand)) == len(cand):
                        out.append(cand)
    return out


def all_paths(
    topo: NDFullMesh, src: int, dst: int, *, max_extra_hops: int = 1
) -> list[Path]:
    """APR path set: all shortest paths + single-relay detours."""
    if src == dst:
        return [(src,)]
    sp = shortest_paths(topo, src, dst)
    dp = detour_paths(topo, src, dst, max_extra_hops=max_extra_hops)
    seen: set[Path] = set()
    out: list[Path] = []
    for p in sp + dp:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


def path_diversity(topo: NDFullMesh, src: int, dst: int) -> int:
    """Number of link-disjoint shortest+detour paths (for resilience eval)."""
    paths = all_paths(topo, src, dst)
    used: set[tuple[int, int]] = set()
    count = 0
    for p in sorted(paths, key=len):
        edges = {tuple(sorted(e)) for e in zip(p, p[1:])}
        if edges & used:
            continue
        used |= edges
        count += 1
    return count


# ---------------------------------------------------------------------------
# Source-routing header (paper Fig. 11)
# ---------------------------------------------------------------------------

_PTR_BITS = 4
_BITMAP_BITS = 12
_N_INSTR = 6
_INSTR_BITS = 8


@dataclass(frozen=True)
class SourceRouteHeader:
    """The 8-byte SR header: 4-bit ptr | 12-bit bitmap | 6 x 8-bit instrs.

    ``bitmap[i] == 1``  => hop i is source-routed; the instruction index is
    the POPCOUNT of bitmap[:i] (instructions are packed in order of the SR
    hops).  ``bitmap[i] == 0`` => hop i uses default (table) forwarding.
    """

    ptr: int
    bitmap: int
    instructions: tuple[int, ...]

    def __post_init__(self):
        if not (0 <= self.ptr < (1 << _PTR_BITS)):
            raise ValueError("ptr out of range")
        if not (0 <= self.bitmap < (1 << _BITMAP_BITS)):
            raise ValueError("bitmap out of range")
        if len(self.instructions) > _N_INSTR:
            raise ValueError("too many SR instructions (max 6)")
        if any(not (0 <= i < (1 << _INSTR_BITS)) for i in self.instructions):
            raise ValueError("instruction out of range")

    # -- wire format -------------------------------------------------------
    def pack(self) -> bytes:
        instrs = list(self.instructions) + [0] * (_N_INSTR - len(self.instructions))
        word = self.ptr | (self.bitmap << _PTR_BITS)
        raw = word.to_bytes(2, "little")
        raw += bytes(instrs)
        assert len(raw) == 8
        return raw

    @classmethod
    def unpack(cls, raw: bytes) -> "SourceRouteHeader":
        if len(raw) != 8:
            raise ValueError("SR header must be 8 bytes")
        word = int.from_bytes(raw[:2], "little")
        ptr = word & ((1 << _PTR_BITS) - 1)
        bitmap = word >> _PTR_BITS
        return cls(ptr=ptr, bitmap=bitmap, instructions=tuple(raw[2:8]))

    # -- semantics ---------------------------------------------------------
    def instruction_for_hop(self, hop: int) -> int | None:
        """Return the SR instruction for hop index ``hop`` or None (table)."""
        if hop >= _BITMAP_BITS or not (self.bitmap >> hop) & 1:
            return None
        idx = bin(self.bitmap & ((1 << hop) - 1)).count("1")
        if idx >= len(self.instructions):
            raise ValueError("bitmap refers past instruction array")
        return self.instructions[idx]

    def advance(self) -> "SourceRouteHeader":
        return SourceRouteHeader(self.ptr + 1, self.bitmap, self.instructions)


def encode_path(topo: NDFullMesh, path: Path) -> SourceRouteHeader:
    """Encode an explicit path into an SR header.

    Each hop instruction packs (dim, target-coordinate) of the next node:
    3 bits of dimension + 5 bits of coordinate — enough for dims of size <=32
    (UB-Mesh-Pod dims are 8/8/4/4).
    """
    hops = list(zip(path, path[1:]))
    if len(hops) > _N_INSTR:
        raise ValueError(f"path longer than {_N_INSTR} SR hops")
    instrs = []
    for u, v in hops:
        dim = topo.are_adjacent(u, v)
        if dim is None:
            raise ValueError(f"hop {u}->{v} is not a direct link")
        coord = topo.coords(v)[dim]
        if dim >= 8 or coord >= 32:
            raise ValueError("dim/coord exceed SR instruction encoding")
        instrs.append((dim << 5) | coord)
    bitmap = (1 << len(hops)) - 1
    instrs += [0] * (_N_INSTR - len(instrs))   # wire format stores all six
    return SourceRouteHeader(ptr=0, bitmap=bitmap, instructions=tuple(instrs))


def walk_header(topo: NDFullMesh, src: int, hdr: SourceRouteHeader) -> Path:
    """Execute an SR header from ``src``; returns the traversed path."""
    node = src
    path = [node]
    hop = hdr.ptr
    while True:
        instr = hdr.instruction_for_hop(hop)
        if instr is None:
            break
        dim, coord = instr >> 5, instr & 0x1F
        c = list(topo.coords(node))
        c[dim] = coord
        node = topo.node_id(c)
        path.append(node)
        hop += 1
    return tuple(path)


# ---------------------------------------------------------------------------
# Structured addressing & linear table lookup (paper §4.1.2)
# ---------------------------------------------------------------------------


class LinearRouteTable:
    """O(1) next-hop lookup exploiting structured addresses.

    For a node ``n`` and destination ``d``: find the FIRST dimension (scanned
    in a configurable order) where coordinates differ and emit the direct
    neighbor fixing it.  The "table" per node is just ``ndim`` dense arrays
    of size ``dims[i]`` (segment -> egress port), exactly the paper's
    linear-offset scheme — no prefix matching.
    """

    def __init__(self, topo: NDFullMesh, dim_order: Sequence[int] | None = None):
        self.topo = topo
        self.dim_order = tuple(dim_order) if dim_order is not None else tuple(
            range(topo.ndim)
        )
        # table[node][dim][coord] = next node id (or -1 for "local")
        shape = topo.shape
        self._tables = [
            np.full((topo.ndim, max(shape)), -1, dtype=np.int64)
            for _ in range(topo.num_nodes)
        ]
        for node in range(topo.num_nodes):
            c = topo.coords(node)
            for dim in range(topo.ndim):
                for coord in range(shape[dim]):
                    if coord == c[dim]:
                        self._tables[node][dim, coord] = node
                    else:
                        cc = list(c)
                        cc[dim] = coord
                        self._tables[node][dim, coord] = topo.node_id(cc)

    def table_entries(self) -> int:
        """Total table entries — LINEAR in sum(dims), not product (vs LPM)."""
        return self.topo.num_nodes * sum(self.topo.shape)

    def next_hop(self, node: int, dst: int) -> int:
        if node == dst:
            return node
        cn, cd = self.topo.coords(node), self.topo.coords(dst)
        for dim in self.dim_order:
            if cn[dim] != cd[dim]:
                return int(self._tables[node][dim, cd[dim]])
        return node

    def route(self, src: int, dst: int, max_hops: int = 16) -> Path:
        path = [src]
        node = src
        while node != dst:
            node = self.next_hop(node, dst)
            path.append(node)
            if len(path) > max_hops:
                raise RuntimeError("routing loop")
        return tuple(path)


# ---------------------------------------------------------------------------
# TFC: topology-aware deadlock-free flow control (paper §4.1.3)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Channel:
    """A virtual channel: directed link (u -> v) on virtual lane vl."""

    u: int
    v: int
    vl: int


def assign_vls(topo: NDFullMesh, path: Path, n_vls: int = 2) -> list[Channel]:
    """Assign virtual lanes to a path under the TFC rules.

    Loop-breaking rules (the paper's two principles, instantiated):

    * **cross-dimensional**: hops are expected in non-decreasing dimension
      order (dimension-ordered base routing).  A hop that moves to a LOWER
      dimension than its predecessor — only possible on detour/non-shortest
      paths — escalates the VL by one.
    * **same-dimensional**: inside a clique (a ring in the CDG sense), a hop
      from a higher node-index to a lower node-index ("dateline crossing")
      escalates the VL.

    With one escalation budget (2 VLs) every APR path of the 4D mesh is
    routable deadlock-free; paths needing more than ``n_vls-1`` escalations
    are rejected (the planner then picks another path).
    """
    channels: list[Channel] = []
    vl = 0
    prev_dim = -1
    for u, v in zip(path, path[1:]):
        dim = topo.are_adjacent(u, v)
        if dim is None:
            raise ValueError(f"hop {u}->{v} not a direct link")
        esc = 0
        if dim < prev_dim:
            esc = 1  # cross-dimensional loop-breaking
        cu, cv = topo.coords(u)[dim], topo.coords(v)[dim]
        if dim == prev_dim and cu > cv:
            esc = 1  # same-dimensional dateline
        vl += esc
        if vl >= n_vls:
            raise DeadlockRisk(
                f"path {path} needs more than {n_vls} VLs under TFC"
            )
        channels.append(Channel(u, v, vl))
        prev_dim = dim
    return channels


class DeadlockRisk(RuntimeError):
    pass


def channel_dependency_graph(
    paths_channels: Iterable[list[Channel]],
) -> dict[Channel, set[Channel]]:
    """CDG: edge c1 -> c2 if some packet holds c1 while requesting c2."""
    cdg: dict[Channel, set[Channel]] = {}
    for chans in paths_channels:
        for c1, c2 in zip(chans, chans[1:]):
            cdg.setdefault(c1, set()).add(c2)
            cdg.setdefault(c2, set())
    return cdg


def is_acyclic(cdg: dict[Channel, set[Channel]]) -> bool:
    """Kahn's algorithm over the CDG."""
    indeg: dict[Channel, int] = {c: 0 for c in cdg}
    for c, outs in cdg.items():
        for o in outs:
            indeg[o] = indeg.get(o, 0) + 1
    stack = [c for c, d in indeg.items() if d == 0]
    seen = 0
    while stack:
        c = stack.pop()
        seen += 1
        for o in cdg.get(c, ()):
            indeg[o] -= 1
            if indeg[o] == 0:
                stack.append(o)
    return seen == len(indeg)


def tfc_admissible(
    topo: NDFullMesh, paths: Iterable[Path], n_vls: int = 2
) -> list[tuple[Path, list[Channel]]]:
    """The TFC-admissible subset of an APR path set with its VL mapping.

    This is the paper's "generates all-path combinations and VL mappings":
    paths whose loop-breaking events exceed the VL budget are excluded from
    the all-path set (the planner simply never schedules them).
    """
    out = []
    for p in paths:
        if len(p) <= 1:
            continue
        try:
            out.append((p, assign_vls(topo, p, n_vls=n_vls)))
        except DeadlockRisk:
            continue
    return out


def verify_deadlock_free(
    topo: NDFullMesh, paths: Iterable[Path], n_vls: int = 2
) -> bool:
    """VL-map the TFC-admissible paths and check the CDG is acyclic."""
    adm = tfc_admissible(topo, paths, n_vls=n_vls)
    return is_acyclic(channel_dependency_graph(ch for _, ch in adm))


# ---------------------------------------------------------------------------
# Fast fault recovery via direct notification (paper §4.2)
# ---------------------------------------------------------------------------


@dataclass
class RoutePlan:
    """Installed paths for a communication pattern + reverse index by link."""

    topo: NDFullMesh
    paths: dict[tuple[int, int], Path] = field(default_factory=dict)
    _by_link: dict[tuple[int, int], set[tuple[int, int]]] = field(
        default_factory=dict
    )

    def install(self, src: int, dst: int, path: Path) -> None:
        self.paths[(src, dst)] = path
        for u, v in zip(path, path[1:]):
            self._by_link.setdefault(tuple(sorted((u, v))), set()).add((src, dst))

    def affected_flows(self, link: tuple[int, int]) -> set[tuple[int, int]]:
        return set(self._by_link.get(tuple(sorted(link)), set()))

    def direct_notify(self, link: tuple[int, int]) -> dict[int, int]:
        """Direct notification: the two link endpoints send ONE message to
        each affected source (paper Fig. 12 right).  Returns
        {source: notification_hops} — hop count of the notification path.
        """
        out: dict[int, int] = {}
        for src, _dst in self.affected_flows(link):
            out[src] = min(
                self.topo.hop_distance(link[0], src),
                self.topo.hop_distance(link[1], src),
            )
        return out

    def hop_by_hop_notify(self, link: tuple[int, int]) -> dict[int, int]:
        """Baseline: failure floods hop-by-hop through the whole component —
        convergence latency for a source is its BFS depth from the failure,
        but every node in the network participates (control-plane load =
        num_nodes), which is what direct notification eliminates.
        """
        out: dict[int, int] = {}
        for src, _dst in self.affected_flows(link):
            out[src] = max(
                self.topo.hop_distance(link[0], src),
                self.topo.hop_distance(link[1], src),
            ) + 2  # flood propagates via neighbors, not beeline
        return out

    def reroute(self, link: tuple[int, int]) -> dict[tuple[int, int], Path]:
        """Recompute paths for affected flows avoiding the failed link."""
        bad = tuple(sorted(link))
        fixed: dict[tuple[int, int], Path] = {}
        for src, dst in self.affected_flows(link):
            for cand in all_paths(self.topo, src, dst):
                edges = {tuple(sorted(e)) for e in zip(cand, cand[1:])}
                if bad not in edges:
                    fixed[(src, dst)] = cand
                    self.install(src, dst, cand)
                    break
            else:
                raise RuntimeError(f"no APR path avoids {link} for {src}->{dst}")
        return fixed
