"""Spans and counters for ``torch.profiler``: the model's layers in the
forward, the remat's recompute and the backward, and the MoE layer's slots.

Tracing is on exactly while a profiler records
(``torch._C._autograd._profiler_enabled``); there is no flag of its own.
With no profiler a span is its function's call after one check, and a
count does nothing.

``call(name, fn, *args)`` runs ``fn(*args)`` inside a ``record_function``
range ``name``.  In the first forward under grad mode it also passes the
positional tensors that need a gradient through an identity marker, and
the outputs that need one through another (views, no tensor saved).  In
the backward the outputs' marker opens the range ``name + ".bwd"`` and
the inputs' marker closes it, so the range holds the layer's backward on
autograd's thread, where its kernels are launched.  A span whose inputs
need no gradient has no ``.bwd`` range.  A span entered while a backward
runs (the remat's recompute, ``models/remat.py``) is ``name +
".recompute"`` and has no markers: the first forward's carry the
backward.  ``mark(name)`` is a plain range (the host loop's
``train.data``; a kernel's backward, ``<kernel>.bwd``).

``count(name, value)`` adds ``value`` (an int, or a tensor's sum, kept on
the device) to an in-memory total, in the first forward only and only while tracing;
``counts()`` reads the totals with one synchronise, ``reset_counts()``
clears them, as ``kernels.launch_counts()`` does the launches.

The names are the work's (``model.attention``, ``model.moe.route``), so
a later kernel keeps them; README's "Tracing" lists every one.
``innermost`` gives each kernel of a trace its innermost range, as
``launch/profile_train.py`` reads them.
"""

from __future__ import annotations

import contextlib
import re

import torch
from torch.profiler import record_function

tracing = torch._C._autograd._profiler_enabled
_NAME = re.compile(r"[a-z][a-z0-9_]*(\.[a-z0-9_]+)+")


def is_span(name: str) -> bool:
    """Whether a trace's range ``name`` is one of the program's marks or
    spans (dotted lower-case words: ``train.grad``, ``model.rope.bwd``);
    no kernel's, operator's or runtime call's name is."""
    return _NAME.fullmatch(name) is not None


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


class _Range:
    """The ``.bwd`` range that a span's two markers open and close."""

    def __init__(self, name: str):
        self.name, self.handle = name, None


class _Open(torch.autograd.Function):
    """Identity on a span's outputs; its backward opens the range."""

    @staticmethod
    def forward(ctx, rng, *ts):
        ctx.set_materialize_grads(False)
        ctx.rng = rng
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.rng.handle is None:
            ctx.rng.handle = torch.ops.profiler._record_function_enter_new(ctx.rng.name, None)
        return (None, *grads)


class _Close(torch.autograd.Function):
    """Identity on a span's inputs; its backward closes the range."""

    @staticmethod
    def forward(ctx, rng, *ts):
        ctx.set_materialize_grads(False)
        ctx.rng = rng
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.rng.handle is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(ctx.rng.handle)
            ctx.rng.handle = None
        return (None, *grads)


def _needs_grad(t) -> bool:
    return isinstance(t, torch.Tensor) and t.requires_grad


def _through(fn, rng: _Range, items: list) -> list:
    """``items`` with those that need a gradient passed through ``fn``."""
    at = [i for i, t in enumerate(items) if _needs_grad(t)]
    items = list(items)
    for i, t in zip(at, fn.apply(rng, *(items[i] for i in at)) if at else ()):
        items[i] = t
    return items


def call(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` inside the span ``name`` (module docstring)."""
    if not tracing():
        return fn(*args, **kwargs)
    if _in_backward():
        with record_function(name + ".recompute"):
            return fn(*args, **kwargs)
    with record_function(name):
        if not torch.is_grad_enabled() or not any(map(_needs_grad, args)):
            return fn(*args, **kwargs)
        rng = _Range(name + ".bwd")
        out = fn(*_through(_Close, rng, args), **kwargs)
        if isinstance(out, tuple):
            return tuple(_through(_Open, rng, list(out)))
        return _through(_Open, rng, [out])[0]


def mark(name: str):
    """A ``record_function`` range while tracing, else nothing."""
    return record_function(name) if tracing() else contextlib.nullcontext()


_totals: dict = {}


def count(name: str, value) -> None:
    """Add ``value`` to the total ``name`` (module docstring)."""
    if not tracing() or _in_backward():
        return
    if isinstance(value, torch.Tensor):       # a mask: its elements that are set
        value = value.detach().sum()
    _totals[name] = _totals.get(name, 0) + value


def counts() -> dict[str, int]:
    """Every total, read with one synchronise."""
    names = sorted(_totals)
    on_device = [n for n in names if isinstance(_totals[n], torch.Tensor)]
    read = dict(zip(on_device, torch.stack([_totals[n].to(torch.int64) for n in on_device]).tolist())
                if on_device else [])
    return {n: int(read.get(n, _totals[n])) for n in names}


def reset_counts() -> None:
    _totals.clear()


def innermost(kernels: list, ranges: list) -> list:
    """For each ``(name, start, end)`` of ``kernels``, the name of the
    shortest of ``ranges`` (``(name, start, end)``, one clock with the
    kernels) that holds the kernel's start, or None: the kernel's innermost
    span, whether the trace puts a kernel in its innermost range only or in
    every enclosing one."""
    ranges = sorted(ranges, key=lambda r: r[1])
    out, open_, j = [None] * len(kernels), [], 0
    for i in sorted(range(len(kernels)), key=lambda i: kernels[i][1]):
        t = kernels[i][1]
        while j < len(ranges) and ranges[j][1] <= t:
            open_.append(ranges[j])
            j += 1
        open_ = [r for r in open_ if r[2] >= t]
        if open_:
            out[i] = min(open_, key=lambda r: r[2] - r[1])[0]
    return out
