"""Topology-aware collectives — port of ``repro/parallel/collectives.py``
(``hierarchical_allreduce``, ``flat_allreduce``, ``multipath_split``,
``hierarchical_all_to_all``): the paper's §5.1 schedules, written out.

Each function takes a ``DeviceMesh`` and axis names, as the reference takes
a ``Mesh``, and returns a function of the rank's own local tensor (the
reference's ``shard_map(in_specs=P())`` hands every device the same ``x``; a
rank here may hold any).  Every rank of the mesh builds the function
together (a collective over several axes makes a process group for them).

**Every reduction is ``ops.ccu_reduce``** (the CCU kernel on the card, its
plain version on the CPU) over the peers' rows stacked in rank order: the
transport only moves bytes, into a ``(P, n)`` buffer, and the sum is taken
in one fixed order in fp32.  So two ranks that reduce the same rows hold the
same bits, and a result does not depend on how the transport scheduled its
messages.

* ``hierarchical_allreduce``: reduce-scatter over the FAST axis (an exchange
  of chunks, then one ``ccu_reduce`` of the ``(n_fast, N / n_fast)`` rows:
  each fast rank owns a chunk), all-reduce of the owned chunk over each SLOW
  axis (a gather, then one ``ccu_reduce`` of ``(n_slow, N / n_fast)``), then
  an all-gather over the fast axis.  The reference's ``psum_scatter -> psum
  -> all_gather`` with the sum in a fixed order; wire bytes on the slow links
  drop by the fast-axis size (the Multi-Ring tiering of Fig. 13).  ``x`` is
  flattened and its last chunk padded with zeros where ``N`` does not divide.
* ``flat_allreduce``: the baseline, one gather over all its axes and one
  ``ccu_reduce``.
* ``multipath_split``: Fig. 14-(a), half of ``x`` gathered over each of two
  axes, both gathers in flight at once (``async_op``).
* ``hierarchical_all_to_all``: Fig. 14-(b/c), an exchange within the local
  clique first, then one across cliques.

The sums come out in fp32 whatever the peers' type (``ccu_reduce`` widens
each element and rounds each sum once to fp32).  The reference's ``psum`` of
bf16 returns bf16; here a caller that wants its type back rounds once, after
the whole sum (``train_step`` does, to the gradient's type), where the
reference's framework may round after each stage.

Transport (``Transport``): ``torch.distributed`` on the group of the named
axes.  With NCCL (one GPU a rank) CUDA tensors go as they are.  gloo, the
only backend that takes several ranks on one GPU (NCCL refuses them as
duplicate GPUs), aborts the process on a CUDA tensor in torch 2.11
(``gloo::IoException ... writev: Bad address`` at its first gather), so
``Transport`` stages a gloo group's CUDA tensors through host memory: a copy
to the host, the collective there, a copy back.  The sums still run on the
card, in ``ccu_reduce``.

Each returned function counts in ``fn.wire_bytes`` (axis -> bytes) the
operand bytes of every collective it issues, under each axis the collective's
group spans: the port's counterpart of what the reference's test reads from
the compiled HLO (the operand size of each all-reduce).  A caller may hand
one ``wire`` dict to several functions, as the train step does, to count a
whole step.  Inside ``with recording() as records:`` (the dry-run's
``lower_bundle``) every transport also lists each collective it issues as
``(kind, result bytes, group size, axes)``, the HLO kinds of
``repro/launch/hlo_stats.py`` (``all-gather``, ``all-to-all``,
``reduce-scatter`` for an exchange whose rows are then summed,
``collective-permute`` for a send), which
``repro_torch.launch.hlo_stats.collective_stats`` prices with the
reference's ring conventions; outside one nothing is kept, so a long run
holds no more than the counters.  ``operand_bytes_by_axis(records)`` gives
back the operand bytes by axis from the records alone.

An axis group (``AxisGroup``; ``ModelAxis`` is the "model" axis's, the
sequence-parallel scheme of the sharding rules in training and prefill and
the tensor-parallel one in decode and in the SSM family; the MoE experts'
FSDP gathers take the "data" axis's; ``Transport`` and ``AxisGroup`` also
take a ``block``, the run of consecutive ranks of the axes whose group a
rank joins): ``gather`` is an all-gather along one tensor dim whose
backward is a reduce-scatter (an exchange of chunks, then one
``ccu_reduce`` of the ``(P, chunk)`` rows), so the gradient a rank gets for
its shard is summed over every rank's use of the gathered tensor;
``reduce_scatter`` is the reverse pair; ``all_reduce`` a sum whose backward
is a sum; ``sum`` the all-reduce of a small tensor without autograd (a
gather of the rows, then one ``ccu_reduce``).  The GSPMD partitioner
inserts the same pairs for the reference.

A fake process group (``torch.testing._internal.distributed.fake_pg``, the
dry-run's ``launch/mesh.fake_mesh``) takes every call and moves nothing; its
tensors are on the ``meta`` device, so nothing is staged either, and every
collective is recorded as on a real group.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..kernels import ops
from ..models.param import tree_map


def axis_group(mesh, axes: tuple[str, ...], block: int | None = None):
    """The process group of this rank's peers along ``axes`` (the ranks that
    share its coordinates on every other mesh axis), ranks ascending: the
    first axis in the mesh's order is the major one.  With ``block`` only
    the peers of this rank's run of ``block`` consecutive ones.  A group of
    several axes, or of a block, is made here, by every rank of the mesh
    together."""
    names = tuple(mesh.mesh_dim_names)
    if len(axes) == 1 and block is None:
        return mesh.get_group(axes[0])
    dims = sorted(names.index(a) for a in axes)
    rest = [i for i in range(len(names)) if i not in dims]
    ranks = mesh.mesh.permute(*rest, *dims).reshape(-1, block or math.prod(mesh.size(i) for i in dims))
    group, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return group


_RECORDING: list[list] = []      # the lists of the open ``recording`` blocks


@contextmanager
def recording():
    """Inside the block, every collective a transport issues is appended to
    the list it yields as ``(kind, result bytes, group size, axes)``."""
    records: list = []
    _RECORDING.append(records)
    try:
        yield records
    finally:
        _RECORDING.remove(records)


def operand_bytes_by_axis(records) -> dict[str, int]:
    """The operand bytes of ``records`` under each axis their groups span,
    as ``fn.wire_bytes`` counts them: an all-gather's operand is its result
    over the group size, a reduce-scatter's its result times the group
    size, an all-to-all's and a send's its result."""
    out: dict[str, int] = {}
    for kind, nbytes, n, axes in records:
        operand = nbytes // n if kind == "all-gather" else nbytes * n if kind == "reduce-scatter" else nbytes
        for a in axes:
            out[a] = out.get(a, 0) + operand
    return out


class Transport:
    """Moves bytes among the peers of one group of mesh axes; never sums.
    gloo groups stage CUDA tensors through host memory (module docstring)."""

    def __init__(self, mesh, axes: tuple[str, ...], wire_bytes: dict[str, int], block: int | None = None):
        self.axes = tuple(axes)
        self.group = axis_group(mesh, self.axes, block)
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.ranks = dist.get_process_group_ranks(self.group)
        self.staged = dist.get_backend(self.group) == "gloo"
        self.wire_bytes = wire_bytes
        for a in self.axes:
            wire_bytes.setdefault(a, 0)

    def _out(self, x: torch.Tensor, kind: str, result_bytes: int) -> torch.Tensor:
        """The tensor the backend sees for ``x``, counted on the wire and,
        inside ``recording``, recorded as one collective of ``kind``."""
        nbytes = x.numel() * x.element_size()
        for a in self.axes:
            self.wire_bytes[a] += nbytes
        for records in _RECORDING:
            records.append((kind, result_bytes, self.size, self.axes))
        x = x.contiguous()
        return x.cpu() if self.staged and x.is_cuda else x

    def _buffer(self, shape, like: torch.Tensor) -> torch.Tensor:
        device = "cpu" if self.staged else like.device
        return torch.empty(shape, dtype=like.dtype, device=device)

    def all_gather(self, x: torch.Tensor, *, async_op: bool = False):
        """``(P, *x.shape)``, row p from group rank p.  With ``async_op`` the
        gather is issued and a function returned that waits for it."""
        src = self._out(x, "all-gather", self.size * x.numel() * x.element_size())
        out = self._buffer((self.size, *x.shape), x)
        work = dist.all_gather(list(out.unbind(0)), src, group=self.group, async_op=async_op)

        def finish() -> torch.Tensor:
            if work is not None:
                work.wait()
            return out.to(x.device)

        return finish if async_op else finish()

    def all_to_all(self, x: torch.Tensor, *, kind: str = "all-to-all") -> torch.Tensor:
        """``x (P, ...)``: row p goes to group rank p; row p of the result
        came from group rank p.  ``kind="reduce-scatter"`` records an
        exchange whose rows the caller sums: its result is one row."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all over {self.axes} needs {self.size} rows, got {tuple(x.shape)}")
        nbytes = x.numel() * x.element_size()
        src = self._out(x, kind, nbytes // self.size if kind == "reduce-scatter" else nbytes)
        out = self._buffer(x.shape, x)
        dist.all_to_all_single(out, src, group=self.group)
        return out.to(x.device)

    def isend(self, x: torch.Tensor, peer: int):
        """Send ``x`` to group rank ``peer``; returns a function that waits
        for the send (and keeps its buffer alive until then)."""
        src = self._out(x, "collective-permute", x.numel() * x.element_size())
        work = dist.isend(src, dst=self.ranks[peer], group=self.group)

        def finish() -> torch.Tensor:
            work.wait()
            return src

        return finish

    def irecv(self, like: torch.Tensor, peer: int):
        """Receive a tensor shaped as ``like`` from group rank ``peer``;
        returns a function that waits and gives it on ``like``'s device."""
        out = self._buffer(like.shape, like)
        work = dist.irecv(out, src=self.ranks[peer], group=self.group)

        def finish() -> torch.Tensor:
            work.wait()
            return out.to(like.device)

        return finish


def hierarchical_allreduce(mesh, fast_axis: str, slow_axes: tuple[str, ...], *,
                           reduce: Callable = ops.ccu_reduce, wire: dict | None = None):
    """Returns fn(x) -> the sum of every rank's x over (fast, *slow), fp32,
    as RS(fast) -> AR(slow) -> AG(fast), every sum one ``reduce``
    (``ops.ccu_reduce``; its plain version on the plain path)."""
    wire = {} if wire is None else wire
    fast = Transport(mesh, (fast_axis,), wire)
    slows = [Transport(mesh, (ax,), wire) for ax in slow_axes]

    def fn(x: torch.Tensor) -> torch.Tensor:
        n = fast.size
        flat = x.reshape(-1)
        N = flat.numel()
        c = -(-N // n)
        if c * n != N:
            flat = torch.cat([flat, flat.new_zeros(c * n - N)])
        # reduce-scatter over the fast axis: each fast rank owns chunk `rank`
        part = reduce(fast.all_to_all(flat.view(n, c), kind="reduce-scatter"))
        # all-reduce the owned chunk over the slow (long-range) axes
        for t in slows:
            part = reduce(t.all_gather(part))
        # gather the fast axis back
        return fast.all_gather(part).view(-1)[:N].view(x.shape)

    fn.wire_bytes = wire
    return fn


def flat_allreduce(mesh, axes: tuple[str, ...]):
    """Baseline: one gather over all ``axes`` and one ``ccu_reduce`` (for
    wire-byte comparison)."""
    wire: dict[str, int] = {}
    t = Transport(mesh, tuple(axes), wire)

    def fn(x: torch.Tensor) -> torch.Tensor:
        return ops.ccu_reduce(t.all_gather(x.reshape(-1))).view(x.shape)

    fn.wire_bytes = wire
    return fn


def multipath_split(mesh, axis_a: str, axis_b: str):
    """Fig. 14-(a): move a tensor across the mesh via TWO axes at once.

    Splits x in half along dim 0; half 1 rides an all-gather over axis_a,
    half 2 over axis_b, both in flight together.  Returns (a, b), each the
    gathered halves concatenated along dim 0."""
    wire: dict[str, int] = {}
    ta = Transport(mesh, (axis_a,), wire)
    tb = Transport(mesh, (axis_b,), wire)

    def fn(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h = x.shape[0] // 2
        wait_a = ta.all_gather(x[:h], async_op=True)
        wait_b = tb.all_gather(x[h:], async_op=True)
        a, b = wait_a(), wait_b()
        return a.reshape(-1, *x.shape[1:]), b.reshape(-1, *x.shape[1:])

    fn.wire_bytes = wire
    return fn


def hierarchical_all_to_all(mesh, intra_axis: str, inter_axis: str):
    """Two-stage A2A: exchange within the local clique first, then one
    exchange across cliques (the Fig. 14-(b/c) hierarchy).

    x: (n_intra * n_inter, chunk, ...) — destination-major layout, viewed as
    (n_inter, n_intra, ...).  Stage 1 sends ``x[:, j]`` to intra peer j and
    puts what peer j sent at ``[:, j]``; stage 2 sends ``[k]`` to inter peer
    k and puts what peer k sent at ``[k]``: the reference's two
    ``all_to_all(..., tiled=False)`` over split = concat axes 1, then 0."""
    wire: dict[str, int] = {}
    ti = Transport(mesh, (intra_axis,), wire)
    te = Transport(mesh, (inter_axis,), wire)

    def fn(x: torch.Tensor) -> torch.Tensor:
        rest = x.shape[1:]
        y = x.reshape(te.size, ti.size, *rest)
        y = ti.all_to_all(y.transpose(0, 1)).transpose(0, 1)
        y = te.all_to_all(y)
        return y.reshape(te.size * ti.size, *rest)

    fn.wire_bytes = wire
    return fn


# ---------------------------------------------------------------------------
# an axis group: gathers whose backward is a reduce-scatter, and the reverse
# ---------------------------------------------------------------------------


def _reduce_scatter(t: Transport, reduce: Callable, g: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of every rank's ``g``:
    chunk p of each rank's ``g`` sent to rank p, the ``(P, chunk)`` rows
    received summed by one ``reduce`` in rank order, rounded once to
    ``g``'s type."""
    P = t.size
    chunks = g.unflatten(dim, (P, g.shape[dim] // P)).movedim(dim, 0).contiguous()
    rows = t.all_to_all(chunks, kind="reduce-scatter")
    return reduce(rows.reshape(P, -1)).view(chunks.shape[1:]).to(g.dtype)


def _all_gather(t: Transport, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    return t.all_gather(x).movedim(0, dim).flatten(dim, dim + 1)


def _all_reduce(group: "AxisGroup", x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x``, in ``x``'s type: a reduce-scatter (each
    rank's chunk summed by one ``reduce`` in rank order, rounded once to
    ``x``'s type; the last chunk padded with zeros where the size does not
    divide) and an all-gather of the chunks, as ``hierarchical_allreduce``
    sums over its fast axis.  Every rank holds the same bits."""
    t = group.transport
    n = x.numel()
    c = -(-n // t.size)
    flat = x.reshape(-1)
    if c * t.size != n:
        flat = torch.cat([flat, flat.new_zeros(c * t.size - n)])
    part = group.reduce(t.all_to_all(flat.view(t.size, c), kind="reduce-scatter")).to(x.dtype)
    return t.all_gather(part).view(-1)[:n].view(x.shape)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` (forward), reduce-scatter of the gradient
    along ``dim`` (backward)."""

    @staticmethod
    def forward(ctx, x, group: "AxisGroup", dim: int):
        ctx.group, ctx.dim = group, dim
        with record_function(f"{group.name}.gather"):
            return _all_gather(group.transport, x, dim)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        with record_function(f"{group.name}.reduce_scatter"):
            return _reduce_scatter(group.transport, group.reduce, g, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along ``dim`` (forward), all-gather of the gradient
    along ``dim`` (backward)."""

    @staticmethod
    def forward(ctx, x, group: "AxisGroup", dim: int):
        ctx.group, ctx.dim = group, dim
        with record_function(f"{group.name}.reduce_scatter"):
            return _reduce_scatter(group.transport, group.reduce, x, dim)

    @staticmethod
    def backward(ctx, g):
        with record_function(f"{ctx.group.name}.gather"):
            return _all_gather(ctx.group.transport, g.contiguous(), ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    """The sum over the ranks (forward); the sum of the gradients over the
    ranks (backward): every rank's output is the same sum, so each input's
    gradient is the sum of every output's."""

    @staticmethod
    def forward(ctx, x, group: "AxisGroup"):
        ctx.group = group
        with record_function(f"{group.name}.sum"):
            return _all_reduce(group, x)

    @staticmethod
    def backward(ctx, g):
        with record_function(f"{ctx.group.name}.sum"):
            return _all_reduce(ctx.group, g.contiguous()), None


class AxisGroup:
    """One rank's view of a set of mesh axes (one process group over them):
    ``gather`` (an all-gather along a dim whose backward is a
    reduce-scatter), ``reduce_scatter`` (the reverse pair), ``all_reduce``
    (a sum whose backward is a sum), all three autograd-aware; ``sum`` and
    ``max`` (no autograd, every rank the same bits), ``last`` (the last
    rank's tensor, on every rank), ``rows`` (every rank's tensor, stacked in
    rank order), the rank's position ``rank`` of ``size``, and
    ``gather_dim``, the dim of a tensor that the rules cut over these axes
    (None where none is).  Every sum is one ``reduce`` (``ops.ccu_reduce``,
    its plain version on the plain path) over the ranks' rows in rank
    order.  ``gather_tree`` gathers each leaf of a tree that the rules cut
    over these axes whole: the model axis's gathers of the sp-sharded
    weights, and the FSDP gathers of the MoE experts over "data"
    (``moe_fsdp``).  ``within(k)`` is the group of this rank's run of ``k``
    consecutive ranks of the same axes (a process group of each run, made
    by every rank together the first time it is asked for), counted in the
    same ``wire``: whisper's decode sums a head's partial scores over the
    ranks that hold its columns."""

    def __init__(self, mesh, rules, axes: tuple[str, ...], *, reduce: Callable = ops.ccu_reduce,
                 wire: dict | None = None, block: int | None = None):
        self.axes = tuple(axes)
        self.name = "+".join(self.axes)
        self.rules = rules
        self.reduce = reduce
        self.wire = {} if wire is None else wire
        self.transport = Transport(mesh, self.axes, self.wire, block)
        self.rank, self.size = self.transport.rank, self.transport.size
        self._mesh, self._blocks = mesh, {}

    def within(self, block: int) -> "AxisGroup":
        """The group of this rank's run of ``block`` consecutive ranks of
        these axes (the ranks that hold one whisper head's columns in
        decode), counted in the same ``wire``; made once, the first time
        every rank asks for it."""
        if block == self.size:
            return self
        if block not in self._blocks:
            self._blocks[block] = AxisGroup(self._mesh, self.rules, self.axes, reduce=self.reduce, wire=self.wire,
                                            block=block)
        return self._blocks[block]

    def gather_dim(self, logical: tuple) -> int | None:
        """The tensor dim that the rules put on these axes, or None."""
        for d, entry in enumerate(self.rules.pspec(logical)):
            names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
            if names == self.axes:
                return d
            if set(names) & set(self.axes):
                raise ValueError(f"dim {d} of {logical} is cut over {names}, not over {self.axes}")
        return None

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole of ``x`` along ``dim``, cut in rank order; the gradient
        a rank gets back is the sum of every rank's for its own chunk."""
        return _Gather.apply(x, self, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's chunk along ``dim`` of the sum of every rank's ``x``,
        in ``x``'s type; the gradient is gathered back whole."""
        return _ReduceScatter.apply(x, self, dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``, in ``x``'s type; the gradient of
        each rank's input is the sum of every rank's output gradient."""
        return _AllReduce.apply(x, self)

    def gather_tree(self, tree, spec_tree):
        """Each leaf cut over these axes (by its spec's logical axes)
        gathered whole; the others as they are."""

        def one(x, spec):
            d = self.gather_dim(spec.logical)
            return x if d is None else self.gather(x, d)

        return tree_map(one, tree, spec_tree)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x`` (no autograd), fp32: the rows
        gathered and summed by one ``reduce`` in rank order."""
        with record_function(f"{self.name}.sum"):
            return self.reduce(self.transport.all_gather(x.reshape(-1))).view(x.shape)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of every rank's ``x`` (exact in any order)."""
        return self.transport.all_gather(x).amax(0)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """``(P, *x.shape)``: every rank's ``x`` (no autograd), row p from
        rank p."""
        return self.transport.all_gather(x)

    def last(self, x: torch.Tensor) -> torch.Tensor:
        """The last rank's ``x`` (no autograd), on every rank."""
        return self.transport.all_gather(x)[-1]


class ModelAxis(AxisGroup):
    """The "model" mesh axis: the sequence-parallel domain of training and
    prefill (activations cut along the sequence, the sp-sharded weights
    gathered before use) and the tensor-parallel domain of decode (the
    weights used as cut, the partial sums summed)."""

    axis = "model"

    def __init__(self, mesh, rules, **kw):
        super().__init__(mesh, rules, (self.axis,), **kw)
