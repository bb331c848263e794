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

Sharding strategies (``expert_parallel``, ``expert_tp``) only name the expert
weights' logical axes; on one device ``rt.shard`` is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import Runtime
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

    def capacity(self, seq_len: int) -> int:
        """Slots per expert and sequence: max(1, int(S * K * cf / E))."""
        return max(1, int(seq_len * self.topk * self.capacity_factor / self.n_experts))


def moe_specs(d_model: int, cfg: MoEConfig) -> dict:
    E, F_ = cfg.n_experts, cfg.d_ff
    if cfg.strategy == "expert_parallel":
        logical = ("experts", None, "moe_fsdp")
        logical_out = ("experts", "moe_fsdp", None)
    else:
        logical = (None, "moe_fsdp", "ff")
        logical_out = (None, "ff", "moe_fsdp")
    return {
        "router": ParamSpec((d_model, E), (None, None), init="scaled"),
        "w_gate": ParamSpec((E, d_model, F_), logical, init="scaled"),
        "w_up": ParamSpec((E, d_model, F_), logical, init="scaled"),
        "w_down": ParamSpec((E, F_, d_model), logical_out, init="scaled"),
    }


class Routing(NamedTuple):
    probs: torch.Tensor        # (B, S, E) float32 router probabilities
    gate_idx: torch.Tensor     # (B, S, K) chosen experts, best first
    gate_vals: torch.Tensor    # (B, S, K) float32, normalised, 0 where dropped
    onehot: torch.Tensor       # (B, S, K, E) float32
    pos: torch.Tensor          # (B, S, K) float32 slot in the chosen expert
    keep: torch.Tensor         # (B, S, K) bool: pos < C


def route(
    x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
    gate_idx: torch.Tensor | None = None,
) -> Routing:
    """Top-k routing and GShard capacity positions, as the reference's
    ``moe_apply`` computes them before its dispatch einsum.

    ``gate_idx`` (B, S, K), when given, takes the place of the top-k choices,
    so that one run can be held to another's routing decisions (two paths
    whose bf16 arithmetic differs route a near-tie apart; ``chip_smoke.py``
    compares them so)."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.topk
    C = cfg.capacity(S)
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


def moe_apply(
    rt: Runtime, p: dict, x: torch.Tensor, cfg: MoEConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, router aux loss).  x: (B, S, D)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.topk
    C = cfg.capacity(S)

    if cfg.reshard_tokens:
        x = rt.shard(x, "batch", None, "moe_d_act")

    r = route(x, p["router"], cfg)
    disp, comb = dispatch_tensors(r, C, x.dtype)

    if rt.use_kernels:
        expert_in = ops.moe_dispatch(disp, x)                    # (E, B, C, D)
    else:
        expert_in = torch.einsum("bsec,bsd->ebcd", disp, x)
    expert_in = rt.shard(expert_in, "experts_act", "batch", None, None)
    bf16 = cfg.dispatch_dtype == "bf16"
    if bf16:
        # rounded to bf16, then promoted with the weights' type as the
        # reference's einsum promotes its operands
        wt = torch.promote_types(torch.bfloat16, p["w_gate"].dtype)
        expert_in = expert_in.to(torch.bfloat16).to(wt)

    # the expert products: one batched matmul a weight over (E, B*C, .)
    ein = expert_in.reshape(E, B * C, D)
    g = torch.matmul(ein, p["w_gate"])
    u = torch.matmul(ein, p["w_up"])
    h = F.silu(g) * u
    h = rt.shard(h.reshape(E, B, C, -1), "experts_act", "batch", None, "moe_ff_act")
    eo = torch.matmul(h.reshape(E, B * C, -1), p["w_down"]).reshape(E, B, C, -1)
    eo = rt.shard(eo, "experts_act", "batch", None, None)
    if bf16:
        eo = eo.to(torch.bfloat16)
        y = torch.einsum("bsec,ebcd->bsd", comb.float(), eo.float()).to(torch.bfloat16)
    else:
        y = torch.einsum("bsec,ebcd->bsd", comb, eo)
    y = rt.shard(y, "batch", "sp", None)

    # load-balancing auxiliary loss (Switch/GShard form)
    routed = r.onehot[..., 0, :] if K == 1 else torch.sum(r.onehot, dim=2)
    me = torch.mean(routed, dim=(0, 1)) / K
    ce = torch.mean(r.probs, dim=(0, 1))
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    return y.to(x.dtype), aux
