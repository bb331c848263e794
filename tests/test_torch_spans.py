"""The port's spans and counters (``repro_torch/spans.py``): every span of
the transformer family in its forward, ``.recompute`` and ``.bwd`` forms
under a profiler, each range closed and nested, the loss and gradients
bit-equal with and without a profiler, nothing added without one, and the
MoE layer's counters equal to the routing's over the same steps, each step
counted once.  On the CPU the kernels' wrappers call their plain versions;
here they are routed through ``PlainGradient`` as on the card, so that the
kernels' ``.bwd`` spans show."""

import argparse
import collections
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import load
from repro_torch.kernels import ops
from repro_torch.kernels._autograd import PlainGradient
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.moe_dispatch import moe_dispatch_plain
from repro_torch.launch import train, profile_train
from repro_torch.models import moe
from repro_torch.models.layers import Runtime
from repro_torch.models.param import tree_init, tree_leaves, tree_map

B, S = 2, 32
LAYER_SPANS = {"granite-8b": ("model.norm", "model.attention", "model.rope", "model.mlp"),
               "mixtral-8x22b": ("model.norm", "model.attention", "model.rope", "model.moe", "model.moe.route")}
WHOLE_SPANS = ("model.embed", "model.unembed", "model.loss")      # outside the remat: no recompute
KERNEL_BWD = {"granite-8b": ("flash_attention.bwd",), "mixtral-8x22b": ("flash_attention.bwd", "moe_dispatch.bwd")}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.reset_counts()
    yield
    torch.set_num_threads(n)
    spans.reset_counts()


@pytest.fixture
def as_on_card(monkeypatch):
    """Flash attention and the MoE dispatch through ``PlainGradient``, as
    the wrappers run them on the card, their plain versions in the
    kernels' place."""
    def flash(q, k, v, **kw):
        kw.pop("return_lse", None)
        return PlainGradient.apply("flash_attention", lambda *t: flash_attention_plain(*t, **kw),
                                   lambda *t: flash_attention_plain(*t, **kw), q, k, v)

    monkeypatch.setattr(ops, "flash_attention", flash)
    monkeypatch.setattr(ops, "moe_dispatch",
                        lambda disp, x: PlainGradient.apply("moe_dispatch", moe_dispatch_plain, moe_dispatch_plain,
                                                            disp, x))


def _args(arch, steps):
    return argparse.Namespace(arch=arch, smoke=True, n_layers=None, auto_parallel=False, lr=1e-3, steps=steps,
                              batch=B, seq=S, compression="none", ckpt_dir=None, ckpt_every=10**9,
                              log_every=10**9, seed=0, device="cpu")


def _ranges(prof) -> list:
    """The program's ranges on the host: ``(name, thread, start, end)``."""
    return [(e.name(), e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if spans.is_span(e.name())]


@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x22b"])
def test_every_span_in_each_form_closed_and_nested(arch, as_on_card):
    """One step of ``train.run`` under a profiler (remat "nothing") holds
    every span in the forward, the recompute and the backward; every
    ``.bwd`` range opened is closed (as many as the spans that made one),
    and on each thread the ranges nest."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train.run(_args(arch, 1))
    assert load(arch, smoke=True).cfg.remat_policy == "nothing"
    ranges = _ranges(prof)
    seen = collections.Counter(r[0] for r in ranges)
    want = {f"{n}{form}" for n in LAYER_SPANS[arch] for form in ("", ".recompute", ".bwd")}
    want |= {f"{n}{form}" for n in WHOLE_SPANS for form in ("", ".bwd")}
    want |= {*KERNEL_BWD[arch], "train.data", "train.grad", "train.compress", "train.adamw"}
    assert want <= set(seen), want - set(seen)
    for name in (*LAYER_SPANS[arch], *WHOLE_SPANS):
        assert seen[name + ".bwd"] == seen[name], name
        if name in LAYER_SPANS[arch]:       # the final norm lies outside the remat
            assert seen[name + ".recompute"] == seen[name] - (name == "model.norm"), name
    by_thread = collections.defaultdict(list)
    for name, thread, s, e in ranges:
        by_thread[thread].append((s, -e, name))
    for rs in by_thread.values():
        stack = []
        for s, neg_e, name in sorted(rs):
            while stack and stack[-1][0] <= s:
                stack.pop()
            assert not stack or -neg_e <= stack[-1][0], f"{name} overlaps {stack[-1][1]}"
            stack.append((-neg_e, name))
    # nothing opens inside the compression or AdamW
    for name, thread, s, e in ranges:
        if name in ("train.compress", "train.adamw"):
            assert not [r for r in ranges if r[1] == thread and s < r[2] < e], name


def _graph_of(arch, traced: bool):
    """The smoke model's loss, its gradients, the names of its graph's
    nodes, and what was counted, with or without a profiler."""
    h = load(arch, smoke=True)
    params = tree_init(h.param_specs(), torch.Generator().manual_seed(5), torch.bfloat16, "cpu")
    params = tree_map(lambda t: t.requires_grad_(), params)
    toks = torch.randint(0, h.cfg.vocab_size, (B, S + 1), generator=torch.Generator().manual_seed(6))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
        loss = h.loss(Runtime(rules=None))(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
    seen, todo, names = set(), [loss.grad_fn], collections.Counter()
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names[type(f).__name__] += 1
        todo.extend(g for g, _ in f.next_functions)
    return loss, grads, names, spans.counts()


@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x22b"])
def test_tracing_changes_no_bit_and_adds_nothing_off(arch, as_on_card):
    """The loss and every gradient bit-equal with and without a profiler;
    without one the loss's graph holds no marker node and nothing is
    counted."""
    loss0, grads0, off, counted0 = _graph_of(arch, False)
    loss1, grads1, on, counted1 = _graph_of(arch, True)
    assert torch.equal(loss0, loss1)
    assert len(grads0) == len(grads1)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(grads0, grads1))
    assert not [n for n in off if n.startswith(("_Open", "_Close"))]
    assert on["_OpenBackward"] and on["_CloseBackward"]
    assert counted0 == {}
    assert bool(counted1) == (arch == "mixtral-8x22b")


def test_moe_counts_each_step_once(monkeypatch):
    """``moe.kept`` and ``moe.assigned`` over two traced steps of the smoke
    mixtral equal the counts recomputed from ``route``'s ``keep`` over the
    same steps; the remat's recompute routes again and is not counted."""
    seen = []
    route = moe.route

    def spy(x, router, cfg, *a, **kw):
        r = route(x, router, cfg, *a, **kw)
        seen.append((int(r.keep.sum()), torch._C._current_graph_task_id() != -1, r.keep.numel()))
        return r

    monkeypatch.setattr(moe, "route", spy)
    steps = 2
    with profile(activities=[ProfilerActivity.CPU]):
        train.run(_args("mixtral-8x22b", steps))
    c = spans.counts()
    cfg = load("mixtral-8x22b", smoke=True).cfg
    first = [s for s in seen if not s[1]]
    again = [s for s in seen if s[1]]
    assert len(first) == len(again) == steps * cfg.n_layers
    assert c["moe.kept"] == sum(s[0] for s in first) == sum(s[0] for s in again)
    assert c["moe.assigned"] == sum(s[2] for s in first) == steps * cfg.n_layers * B * S * cfg.moe.topk
    assert c["moe.slots"] == steps * cfg.n_layers * cfg.moe.n_experts * B * cfg.moe.capacity(S)
    assert 0 < c["moe.kept"] <= min(c["moe.assigned"], c["moe.slots"])


class _Event:
    """A device-side event of ``prof.events()`` as ``profile_train`` reads it."""

    def __init__(self, name, start, end):
        self.name, self.device_type = name, torch.autograd.DeviceType.CUDA
        self.time_range = torch.autograd.profiler_util.Interval(start, end)


@pytest.mark.parametrize("outer_holds_inner", [False, True])
def test_kernels_go_to_their_innermost_span(outer_holds_inner):
    """``spans.innermost`` and ``profile_train._by_part``: a kernel belongs to
    the shortest range that holds its start, whether the trace spans an
    outer range over its inner ranges' kernels or over its own alone."""
    k = [("gemm", 10, 20), ("rope_k", 32, 36), ("gemm", 40, 50), ("elementwise", 60, 62), ("adam", 90, 95),
         ("stack", 70, 80)]
    # a range over every kernel launched inside it, or over those launched directly in it
    ranges = [("model.attention", 10, 50), ("model.rope", 30, 38) if outer_holds_inner else ("model.rope", 32, 36),
              ("model.attention.bwd", 58, 64), ("train.adamw", 88, 96),
              ("train.grad", 0, 85) if outer_holds_inner else ("train.grad", 70, 80)]
    got = spans.innermost(k, ranges)
    assert got == ["model.attention", "model.rope", "model.attention", "model.attention.bwd", "train.adamw",
                   "train.grad"]
    assert spans.innermost([("x", 100, 101)], ranges) == [None]
    parts, by_span = profile_train._by_part([_Event(*r) for r in ranges] + [_Event(*x) for x in k])
    assert parts == pytest.approx({"train.grad": 0.036, "train.compress": 0.0, "train.adamw": 0.005})
    assert by_span == pytest.approx({"model.attention": 0.02, "model.rope": 0.004, "model.attention.bwd": 0.002,
                                     "train.adamw": 0.005, "train.grad": 0.01})
