"""Mixture-of-Experts layer, GShard-style einsum dispatch — port of
``repro/models/moe.py`` (``MoEConfig``, ``moe_specs``, ``moe_apply``).

Token-choice top-k routing with per-sequence expert capacity and dropped
overflow tokens.  The port computes what the reference computes, step by
step; ``route`` is the reference's routing half, split out so that tests can
compare routing decisions on their own.

With ``Runtime.use_kernels`` set, the dispatch einsum (tokens into their
experts' capacity slots) is one launch of the hand-written ``moe_dispatch``
kernel for the whole layer; without it, it is the reference's einsum.  The
expert products and the combine einsum are plain matrix products, which the
reference too computes outside any kernel: ``torch.matmul`` batched over the
experts, and one ``torch.einsum``.

Sharding strategies (``expert_parallel``, ``expert_tp``) name the expert
weights' logical axes.  On a mesh the layer follows the reference's default
layout (``reshard_tokens=False``), whose dispatch and combine GSPMD lowers
as full sums, not all-to-alls; every sum is ``ccu_reduce`` in rank order
(``parallel.collectives.AxisGroup``):

* ``rt.fsdp`` (a "data" axis of more than one rank): each expert weight is
  gathered over it before use (the rules' ``moe_fsdp``: dbrx's F dim,
  mixtral's d_model dim), the gather's backward a reduce-scatter;
* ``rt.model`` in training and prefill (the rank holds a shard of each
  sequence): the capacity is the whole sequence's, a token's slot counts
  every earlier rank's tokens (``route(..., seq=)``), and each rank
  dispatches its own tokens into the whole ``(E, B, C, D)`` buffer.
  ``expert_parallel`` reduce-scatters the buffer over the experts, runs
  its ``E / m`` experts and all-gathers their outputs; ``expert_tp`` sums
  the buffer, runs every expert on its F shard and sums the outputs.  Each
  rank then combines its own tokens;
* ``rt.model`` in decode (``rt.tp``: every model rank holds the same
  tokens): each rank routes the whole batch, runs its experts or its F
  shard, and the partial outputs are summed over the axis;
* ``rt.tokens`` (training on a mesh): the auxiliary loss's means are over
  every rank's tokens, as the reference's are over the whole batch.

An expert share (``MoEConfig.held``, the chip's share under expert
parallelism, on one card): the layer holds the experts ``[first, first +
count)`` of ``n_experts``.  It routes over all of them with the router at
its full width, takes the capacity of the whole layer, and dispatches,
runs and combines only the held experts' slots: its output is their part
of the layer's, and no tensor over the absent experts' slots is made.  The
auxiliary loss is the whole layer's, the same on every share.  No code
stands in for the exchange with the cards that hold the other experts.  A
share runs without the mesh's axes.

A shared expert (``MoEConfig.shared_d_ff``) is a SwiGLU beside the routed
experts, on every token, added to their output inside the span
``model.moe.shared``; it too runs without the mesh's axes.

The routing, from the router's product to the dispatch and combine
tensors, runs inside the span ``model.moe.route`` (``spans.py``).  While a
profiler records, the first forward counts the layer's (token, choice)
assignments to the experts it holds (``moe.assigned``, B·S·K with every
expert held), those kept within the capacity (``moe.kept``) and the slots
the expert products run over (``moe.slots``, E·B·C of this rank, E the
experts held).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import spans
from ..kernels import ops
from .layers import Runtime, swiglu, swiglu_specs
from .param import ParamSpec


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    topk: int
    d_ff: int
    strategy: str = "expert_parallel"   # expert_parallel | expert_tp
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    reshard_tokens: bool = False   # the reference's collective layout knob
    dispatch_dtype: str = "f32"    # f32 | bf16: expert inputs / outputs rounded to bf16
    held: tuple[int, int] | None = None   # (first, count): the experts this layer holds; None: all
    shared_d_ff: int = 0           # a shared expert's width (SwiGLU on every token); 0: none

    def capacity(self, seq_len: int) -> int:
        """Slots per expert and sequence: max(1, int(S * K * cf / E)),
        E every expert of the layer, held or not."""
        return max(1, int(seq_len * self.topk * self.capacity_factor / self.n_experts))

    @property
    def n_held(self) -> int:
        return self.n_experts if self.held is None else self.held[1]


def moe_specs(d_model: int, cfg: MoEConfig) -> dict:
    """The router over every expert, the held experts' weights, and the
    shared expert's where there is one."""
    E, F_ = cfg.n_held, cfg.d_ff
    if cfg.strategy == "expert_parallel":
        logical = ("experts", None, "moe_fsdp")
        logical_out = ("experts", "moe_fsdp", None)
    else:
        logical = (None, "moe_fsdp", "ff")
        logical_out = (None, "ff", "moe_fsdp")
    specs = {
        "router": ParamSpec((d_model, cfg.n_experts), (None, None), init="scaled"),
        "w_gate": ParamSpec((E, d_model, F_), logical, init="scaled"),
        "w_up": ParamSpec((E, d_model, F_), logical, init="scaled"),
        "w_down": ParamSpec((E, F_, d_model), logical_out, init="scaled"),
    }
    if cfg.shared_d_ff:
        specs["shared"] = swiglu_specs(d_model, cfg.shared_d_ff)
    return specs


class Routing(NamedTuple):
    probs: torch.Tensor        # (B, S, E) float32 router probabilities
    gate_idx: torch.Tensor     # (B, S, K) chosen experts, best first
    gate_vals: torch.Tensor    # (B, S, K) float32, normalised, 0 where dropped
    onehot: torch.Tensor       # (B, S, K, E) float32
    pos: torch.Tensor          # (B, S, K) float32 slot in the chosen expert
    keep: torch.Tensor         # (B, S, K) bool: pos < C


def route(
    x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
    gate_idx: torch.Tensor | None = None, *, capacity: int | None = None, seq=None,
) -> Routing:
    """Top-k routing and GShard capacity positions, as the reference's
    ``moe_apply`` computes them before its dispatch einsum.

    ``gate_idx`` (B, S, K), when given, takes the place of the top-k choices,
    so that one run can be held to another's routing decisions (two paths
    whose bf16 arithmetic differs route a near-tie apart; ``chip_smoke.py``
    compares them so).

    ``seq`` (the model axis, an ``AxisGroup``), where ``x`` holds this
    rank's shard of each sequence: the slots are those of the whole
    sequence, the k-th choices of every rank's tokens after the earlier
    choices of all of them, and within a choice the earlier ranks' tokens
    first.  Each rank's counts ``(B, K, E)`` are gathered and the offset
    of its tokens is an exclusive prefix over the ranks.  ``capacity``
    (default: that of ``x``'s sequences) is then the whole sequence's."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.topk
    C = cfg.capacity(S) if capacity is None else capacity
    probs = torch.softmax((x @ router).float(), dim=-1)
    if gate_idx is None:
        # jax.lax.top_k puts the lower index first among equal values; a
        # stable descending sort does the same (torch.topk promises no order)
        gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :K]
    gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # position of each routed token in its expert's buffer, the k-th choices
    # of all earlier tokens first; overflow beyond C is dropped
    onehot = F.one_hot(gate_idx, E).float()                      # (B, S, K, E)
    flat = onehot.transpose(1, 2).reshape(B, K * S, E)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat
    pos = pos_in_expert.reshape(B, K, S, E).transpose(1, 2)      # (B, S, K, E)
    if seq is not None:
        counts = onehot.sum(dim=1)                               # (B, K, E): this rank's tokens
        every = seq.rows(counts)                                 # (P, B, K, E)
        total = every.sum(dim=0)
        # every rank's earlier choices, less this rank's (counted above), and
        # the earlier ranks' tokens of the same choice
        offset = (torch.cumsum(total - counts, dim=1) - (total - counts)) + every[:seq.rank].sum(dim=0)
        pos = pos + offset[:, None]
    pos = torch.sum(pos * onehot, dim=-1)                        # (B, S, K)
    keep = pos < C
    # normalised before the drop mask, as the reference does
    gate_vals = gate_vals * keep.float()
    return Routing(probs, gate_idx, gate_vals, onehot, pos, keep)


def dispatch_tensors(
    r: Routing, C: int, dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dispatch and combine tensors (B, S, E, C) of a routing, in the
    activations' type as in the reference: ``disp`` is one-hot over the kept
    (token, choice) pairs; ``comb`` takes the one-hot without ``keep``, and
    the gate values, already zeroed where dropped."""
    pos_onehot = (r.pos[..., None] == torch.arange(C, device=r.pos.device)).to(dtype)
    onehot = r.onehot.to(dtype)
    disp = torch.einsum("bske,bskc->bsec", onehot * r.keep[..., None].to(dtype), pos_onehot)
    comb = torch.einsum("bske,bskc,bsk->bsec", onehot, pos_onehot, r.gate_vals.to(dtype))
    return disp, comb


EXPERTS = ("w_gate", "w_up", "w_down")


def _routed(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig, C: int, seq):
    """``route`` and its dispatch and combine tensors: what ``moe_apply``
    reads of them, ``(probs, onehot, keep, disp, comb)``.  With an expert
    share, ``keep`` is the kept choices of the held experts and the
    dispatch and combine tensors are over the held experts' slots alone;
    ``probs`` and ``onehot`` stay over every expert, for the auxiliary
    loss."""
    r = route(x, router, cfg, capacity=C, seq=seq)
    if cfg.held is None:
        return (r.probs, r.onehot, r.keep, *dispatch_tensors(r, C, x.dtype))
    lo, n = cfg.held
    mine = r._replace(onehot=r.onehot[..., lo:lo + n], keep=r.keep & (r.gate_idx >= lo) & (r.gate_idx < lo + n))
    return (r.probs, r.onehot, mine.keep, *dispatch_tensors(mine, C, x.dtype))


def moe_apply(
    rt: Runtime, p: dict, x: torch.Tensor, cfg: MoEConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, router aux loss).  x: (B, S, D), this rank's tokens
    (module docstring for the mesh's axes)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.topk
    if (cfg.held is not None or cfg.shared_d_ff) and any(a is not None for a in (rt.model, rt.fsdp, rt.tokens)):
        raise ValueError("an expert share and a shared expert run on one card, without the mesh's axes")
    seq = rt.model if rt.model is not None and not rt.tp else None    # the tokens cut along the sequence
    # the dim of the expert weights that the model axis cuts: 0 the experts
    # (expert_parallel), 2 their F (expert_tp), None neither (every rank
    # holds every expert whole)
    specs = moe_specs(D, cfg)
    cut = None if rt.model is None else rt.model.gather_dim(specs["w_gate"].logical)
    C = cfg.capacity(S * (seq.size if seq is not None else 1))

    if cfg.reshard_tokens:
        x = rt.shard(x, "batch", None, "moe_d_act")
    if rt.fsdp is not None:
        p = {**p, **rt.fsdp.gather_tree({k: p[k] for k in EXPERTS}, specs)}

    probs, onehot, keep, disp, comb = spans.call("model.moe.route", _routed, x, p["router"], cfg, C, seq)
    spans.count("moe.assigned", B * S * K if cfg.held is None else
                (onehot[..., cfg.held[0]:cfg.held[0] + cfg.held[1]].sum(-1) > 0))
    spans.count("moe.kept", keep)
    spans.count("moe.slots", cfg.n_held * B * C)

    if rt.use_kernels:
        expert_in = ops.moe_dispatch(disp, x)                    # (E, B, C, D)
    else:
        expert_in = torch.einsum("bsec,bsd->ebcd", disp, x)
    mine = slice(None)           # the experts this rank runs
    if seq is not None:          # every model rank's tokens: their sum, or this rank's experts of it
        expert_in = seq.reduce_scatter(expert_in, 0) if cut == 0 else seq.all_reduce(expert_in)
    elif cut == 0:               # decode: every rank holds the same buffer
        n = E // rt.model.size
        mine = slice(rt.model.rank * n, (rt.model.rank + 1) * n)
        expert_in = expert_in[mine]
    expert_in = rt.shard(expert_in, "experts_act", "batch", None, None)
    bf16 = cfg.dispatch_dtype == "bf16"
    if bf16:
        # rounded to bf16, then promoted with the weights' type as the
        # reference's einsum promotes its operands
        wt = torch.promote_types(torch.bfloat16, p["w_gate"].dtype)
        expert_in = expert_in.to(torch.bfloat16).to(wt)

    # the expert products: one batched matmul a weight over (E, B*C, .)
    En = expert_in.shape[0]
    ein = expert_in.reshape(En, B * C, D)
    g = torch.matmul(ein, p["w_gate"])
    u = torch.matmul(ein, p["w_up"])
    h = F.silu(g) * u
    h = rt.shard(h.reshape(En, B, C, -1), "experts_act", "batch", None, "moe_ff_act")
    eo = torch.matmul(h.reshape(En, B * C, -1), p["w_down"]).reshape(En, B, C, -1)
    if seq is not None and cut is not None:      # every expert's whole output on every rank
        eo = seq.gather(eo, 0) if cut == 0 else seq.all_reduce(eo)
    eo = rt.shard(eo, "experts_act", "batch", None, None)
    comb = comb[:, :, mine]
    if bf16:
        eo = eo.to(torch.bfloat16)
        y = torch.einsum("bsec,ebcd->bsd", comb.float(), eo.float()).to(torch.bfloat16)
    else:
        y = torch.einsum("bsec,ebcd->bsd", comb, eo)
    if rt.tp and cut is not None:    # decode: this rank's experts or F shard, a partial sum over the axis
        y = rt.model.sum(y)
    y = rt.shard(y, "batch", "sp", None)
    if cfg.shared_d_ff:
        y = y.to(x.dtype) + spans.call("model.moe.shared", swiglu, rt, p["shared"], x)

    # load-balancing auxiliary loss (Switch/GShard form)
    routed = onehot[..., 0, :] if K == 1 else torch.sum(onehot, dim=2)
    me = torch.mean(routed, dim=(0, 1)) / K
    ce = torch.mean(probs, dim=(0, 1))
    if rt.tokens is not None:    # the means over every rank's tokens (equal shares)
        me, ce = rt.tokens.all_reduce(torch.stack([me, ce]) / rt.tokens.size).unbind(0)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    return y.to(x.dtype), aux
