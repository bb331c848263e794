"""Granite 4.0-H (``granitemoehybrid``): a decoder whose layers are Mamba2
or attention mixers, each followed by sparse experts beside a shared
expert.  New in the port (the JAX package has no such model); the layer
equations are those of ``transformers``' ``GraniteMoeHybrid``::

    x0 = embed[ids] * embedding_multiplier
    per layer:  h = x + r * mixer(rmsnorm(x))        mixer: Mamba2 | attention
                x = h + r * (moe(u) + shared(u)),  u = rmsnorm(h)
    logits = rmsnorm(x_L) @ embed^T / logits_scaling

``r`` is ``residual_multiplier``.  The mixer of layer i is
``layer_types[i]``:

- ``"mamba"``: ``mamba2.mamba2_apply`` with the gate applied before the
  norm (``Mamba2Config.norm_before_gate`` False, mamba_ssm's
  ``norm_before_gate=False``) and the scan through the ``ssd_scan`` kernel
  on the kernel path;
- ``"attention"``: grouped-query attention with no positional encoding
  (``rope_theta`` None) at the softmax scale ``attention_multiplier``,
  through the flash kernels' ``sm_scale`` on the kernel path.

The MoE layer is ``moe.moe_apply`` with its shared expert
(``MoEConfig.shared_d_ff``) and, where the configuration holds a share of
the experts, that share (``MoEConfig.held``).  The token table is tied:
the logits are the final hidden states against its rows.  Every RMSNorm
takes ``rms_norm_eps``.

The parameters: ``embed.tok`` (the table), ``final_norm``, and three
stacks, the Mamba2 layers' (``mamba_blocks``: ``norm``, ``mamba``), the
attention layers' (``attn_blocks``: ``norm``, ``attn``) in their order in
``layer_types``, and every layer's feed-forward part (``ffn_blocks``:
``norm``, ``moe``).  Each layer runs under the configuration's
``remat_policy`` (``remat.remat``).  The spans are the decoder's
(``model.embed``, ``model.norm``, ``model.attention``, ``model.moe``,
``model.unembed``, ``model.loss``) and ``model.mamba`` around a whole Mamba2
mixer; the MoE layer's own are ``model.moe.route`` and
``model.moe.shared``.

Training only: ``forward`` and ``loss_fn`` over whole sequences, on one
device (no mesh axis).  Serving it (a prefill that keeps each Mamba2
layer's state and each attention layer's cache, and decode) is not
ported: ``api.GraniteHybridHarness`` raises there.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .. import spans
from . import layers as L
from .mamba2 import Mamba2Config, mamba2_apply, mamba2_specs
from .moe import MoEConfig, moe_apply, moe_specs
from .param import ParamSpec, cast_floats, round_up, stack_specs
from .remat import remat, unbind_layers

MIXERS = ("mamba", "attention")
STACKS = ("mamba_blocks", "attn_blocks")      # each mixer's stacked parameters


@dataclass(frozen=True)
class GraniteHybridConfig:
    name: str
    layer_types: tuple[str, ...]     # each layer's mixer: "mamba" | "attention"
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    mamba: Mamba2Config
    moe: MoEConfig
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float | None = None   # the softmax scale; None: 1/sqrt(head_dim)
    logits_scaling: float = 1.0
    rms_norm_eps: float = 1e-5
    remat_policy: str = "nothing"    # nothing | dots | none (remat.remat)
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if not set(self.layer_types) <= set(MIXERS):
            raise ValueError(f"layer_types {self.layer_types}: each one of {MIXERS}")

    @property
    def n_layers(self) -> int:
        return len(self.layer_types)

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab_size, 256)

    @property
    def attn(self) -> L.AttnConfig:
        return L.AttnConfig(d_model=self.d_model, n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
                            head_dim=self.head_dim, causal=True, rope_theta=None,
                            softmax_scale=self.attention_multiplier)


def lm_specs(cfg: GraniteHybridConfig) -> dict:
    specs = {
        "embed": {"tok": ParamSpec((cfg.vocab_padded, cfg.d_model), (None, "table_embed"))},
        "final_norm": L.rmsnorm_spec(cfg.d_model),
        "ffn_blocks": stack_specs({"norm": L.rmsnorm_spec(cfg.d_model), "moe": moe_specs(cfg.d_model, cfg.moe)},
                                  cfg.n_layers),
    }
    mixers = {"mamba": ("mamba", mamba2_specs(cfg.mamba)), "attention": ("attn", L.attn_specs(cfg.attn))}
    for m, stack in zip(MIXERS, STACKS):
        if m in cfg.layer_types:
            key, mixer = mixers[m]
            specs[stack] = stack_specs({"norm": L.rmsnorm_spec(cfg.d_model), key: mixer}, cfg.layer_types.count(m))
    return specs


def _norm(cfg: GraniteHybridConfig, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return spans.call("model.norm", L.rmsnorm, w, x, cfg.rms_norm_eps)


def _mamba(rt: L.Runtime, cfg: GraniteHybridConfig, p: dict, u: torch.Tensor) -> torch.Tensor:
    return mamba2_apply(rt, p, u, cfg.mamba, keep=False)[0]


def _layer(rt: L.Runtime, cfg: GraniteHybridConfig, mixer: str, positions: torch.Tensor, x: torch.Tensor,
           mp: dict, fp: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer: its mixer's ``mp`` (``norm`` and ``mamba`` or ``attn``) and
    its feed-forward part's ``fp`` (``norm``, ``moe``).  Returns the layer's
    output and its MoE auxiliary loss."""
    u = _norm(cfg, mp["norm"], x)
    if mixer == "mamba":
        y = spans.call("model.mamba", _mamba, rt, cfg, mp["mamba"], u)
    else:
        y, _ = spans.call("model.attention", L.attention, rt, mp["attn"], u, cfg.attn, positions)
    h = x + y * cfg.residual_multiplier
    m, aux = spans.call("model.moe", moe_apply, rt, fp["moe"], _norm(cfg, fp["norm"], h), cfg.moe)
    return h + m * cfg.residual_multiplier, aux


def forward(rt: L.Runtime, cfg: GraniteHybridConfig, params: dict, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training/scoring forward over whole sequences (B, S).  Returns the
    logits (B, S, vocab_padded) and the sum of the MoE layers' auxiliary
    losses."""
    if rt.model is not None or rt.fsdp is not None or rt.tokens is not None:
        raise ValueError("granitemoehybrid runs on one device: no mesh axis")
    params = cast_floats(params, cfg.dtype)
    tok = params["embed"]["tok"]
    x = spans.call("model.embed", lambda t: L.embed(rt, {"tok": t}, tokens), tok)
    x = (x * cfg.embedding_multiplier).to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    # each mixer's layers in their order, as views of its stack
    stacks = {m: iter(unbind_layers(params[key], cfg.layer_types.count(m)) if key in params else ())
              for m, key in zip(MIXERS, STACKS)}
    body = {m: remat(cfg.remat_policy, functools.partial(_layer, rt, cfg, m, positions)) for m in MIXERS}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for mixer, fp in zip(cfg.layer_types, unbind_layers(params["ffn_blocks"], cfg.n_layers)):
        x, a = body[mixer](x, next(stacks[mixer]), fp)
        aux = aux + a
    x = _norm(cfg, params["final_norm"], x)
    logits = spans.call("model.unembed", lambda h, t: (h @ t.t()) / cfg.logits_scaling, x, tok)
    return logits, aux


def loss_fn(rt: L.Runtime, cfg: GraniteHybridConfig, params: dict, batch: dict) -> torch.Tensor:
    """The mean cross-entropy over the real vocabulary plus the MoE layers'
    auxiliary losses."""
    logits, aux = forward(rt, cfg, params, batch["tokens"])
    return spans.call("model.loss", L.cross_entropy, logits, batch["labels"], cfg.vocab_size) + aux
