"""Unified decoder-only LM — port of ``repro/models/transformer.py``.

One config class parameterizes GQA/MQA attention (RoPE, optional sliding
window, optional qkv bias), RMSNorm/LayerNorm, SwiGLU/GELU MLP or an MoE
layer (``models/moe.py``), an optional bidirectional prefix (paligemma's
SigLIP stub embeddings) and a gemma-style sqrt(d) embedding scale.

Ported: ``LMConfig``, ``block_specs``, ``lm_specs``, ``_block``,
``forward``, ``loss_fn``, ``cache_specs``, ``prefill`` and ``decode_step``.
Where the reference scans over the stacked layer dim, the port loops in Python
over views of the stacked leaves: no per-layer copy.  The KV cache is written
in place (``layers.attention``), so ``prefill`` and ``decode_step`` return the
cache they were given.  ``_block`` returns an MoE layer's router aux loss
beside the cache, and ``forward`` the sum of them beside the logits, as the
reference's do; ``loss_fn`` adds that sum to the cross-entropy.
``forward``, ``loss_fn`` and ``prefill`` take ``prefix_embeds (B, P, D)``:
put before the scaled token embeddings (the prefix itself is not scaled),
every key among them visible to every query (``cfg.attn(prefix=P)``), and
``forward``'s logits cut to the tokens' ``[:, P:]``.  ``decode_step`` takes
no prefix: its causal mask already shows every prefix key.

Each block runs under the config's ``remat_policy`` (``remat.remat``): under
``"nothing"`` and ``"dots"`` a layer's attention runs twice a training step,
once in the forward and once in the recompute.

On the "model" axis (``rt.model``, the dense family's train step and
prefill, ``train/train_step.py``) a rank holds the positions ``[r·S/m,
(r+1)·S/m)`` of each sequence and its model shard of each weight the rules
shard on the axis.  ``forward``, ``loss_fn`` and ``prefill`` offset the
positions by ``rt.seq_offset``; each block's sharded weights are gathered
whole at the top of ``_block`` (inside the remat body, so the recompute
gathers them again; the reference's GSPMD gathers of sp-sharded weights),
the token table in ``_embed`` and ``unembed`` before the logits.
``loss_fn`` divides the local mean by the axis's size, so that the ranks'
losses sum to the mean over the sequences' tokens; ``prefill`` returns the
last model rank's last-token logits on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from . import layers as L
from .moe import MoEConfig, moe_apply, moe_specs
from .param import cast_floats, param_count, round_up, stack_specs
from .remat import remat, unbind_layers


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    norm: str = "rms"              # rms | ln
    act: str = "swiglu"            # swiglu | gelu
    window: int | None = None      # sliding-window attention
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    moe: MoEConfig | None = None
    prefix_len: int = 0            # VLM/audio stub prefix (train/prefill)
    embed_scale: bool = False      # gemma: x *= sqrt(d_model)
    remat_policy: str = "nothing"  # nothing | dots | none: recompute in the backward (remat.remat)
    attn_impl: str = "reference"   # kept for field parity; see Runtime.use_kernels
    unroll: bool = False           # kept for field parity; the port always loops
    dtype: torch.dtype = torch.bfloat16

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab_size, 256)

    def attn(self, prefix: int = 0) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            causal=True,
            window=self.window,
            rope_theta=self.rope_theta,
            qkv_bias=self.qkv_bias,
            prefix_len=prefix,
            impl=self.attn_impl,
        )

    @property
    def param_count(self) -> int:
        return param_count(lm_specs(self))


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def _norm_specs(cfg: LMConfig) -> Any:
    return (
        L.rmsnorm_spec(cfg.d_model) if cfg.norm == "rms" else L.layernorm_specs(cfg.d_model)
    )


def _apply_norm(cfg: LMConfig, p: Any, x: torch.Tensor) -> torch.Tensor:
    return L.rmsnorm(p, x) if cfg.norm == "rms" else L.layernorm(p, x)


def block_specs(cfg: LMConfig) -> dict:
    specs = {
        "ln1": _norm_specs(cfg),
        "attn": L.attn_specs(cfg.attn()),
        "ln2": _norm_specs(cfg),
    }
    if cfg.moe is not None:
        specs["moe"] = moe_specs(cfg.d_model, cfg.moe)
    elif cfg.act == "swiglu":
        specs["mlp"] = L.swiglu_specs(cfg.d_model, cfg.d_ff)
    else:
        specs["mlp"] = L.gelu_mlp_specs(cfg.d_model, cfg.d_ff)
    return specs


def lm_specs(cfg: LMConfig) -> dict:
    return {
        "embed": L.embed_specs(cfg.vocab_padded, cfg.d_model),
        "blocks": stack_specs(block_specs(cfg), cfg.n_layers),
        "final_norm": _norm_specs(cfg),
    }


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _whole(rt: L.Runtime, p: dict, specs_of, cfg: LMConfig) -> dict:
    """``p`` with each leaf that the rules shard on the model axis gathered
    whole, by the specs ``specs_of(cfg)`` (only the keys of ``p`` are read)."""
    return p if rt.model is None else rt.model.gather_tree(p, specs_of(cfg))


def _block(
    rt: L.Runtime,
    cfg: LMConfig,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_pos: int | None = None,
    prefix: int = 0,
):
    p = _whole(rt, p, block_specs, cfg)
    h = _apply_norm(cfg, p["ln1"], x)
    a, new_cache = L.attention(
        rt, p["attn"], h, cfg.attn(prefix), positions, cache, cache_pos
    )
    x = x + a
    h = _apply_norm(cfg, p["ln2"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe is not None:
        m, aux = moe_apply(rt, p["moe"], h, cfg.moe)
    elif cfg.act == "swiglu":
        m = L.swiglu(rt, p["mlp"], h)
    else:
        m = L.gelu_mlp(rt, p["mlp"], h)
    x = x + m
    return rt.shard(x, "batch", "sp", None), new_cache, aux


def _embed(rt: L.Runtime, cfg: LMConfig, params: dict, tokens: torch.Tensor,
           prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    x = L.embed(rt, _whole(rt, {"tok": params["embed"]["tok"]}, _embed_specs, cfg), tokens)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x.to(cfg.dtype)


def _embed_specs(cfg: LMConfig) -> dict:
    return L.embed_specs(cfg.vocab_padded, cfg.d_model)


def _unembed(rt: L.Runtime, cfg: LMConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    return L.unembed(rt, _whole(rt, {"unembed": params["embed"]["unembed"]}, _embed_specs, cfg), x)


def forward(
    rt: L.Runtime,
    cfg: LMConfig,
    params: dict,
    tokens: torch.Tensor,                    # (B, S)
    prefix_embeds: torch.Tensor | None = None,   # (B, P, D) modality stub
) -> tuple[torch.Tensor, torch.Tensor]:
    """Training/scoring forward over a whole sequence.  Returns (logits,
    aux_loss), the aux loss the sum of the MoE layers' (0 for dense ones);
    the logits are the tokens', not the prefix's."""
    params = cast_floats(params, cfg.dtype)
    x = _embed(rt, cfg, params, tokens, prefix_embeds)
    prefix = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    positions = rt.seq_offset(x.shape[1]) + torch.arange(x.shape[1], device=x.device)

    def body(h, lp):
        h, _, a = _block(rt, cfg, lp, h, positions, prefix=prefix)
        return h, a

    block = remat(cfg.remat_policy, body)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unbind_layers(params["blocks"], cfg.n_layers):
        x, a = block(x, lp)
        aux = aux + a
    x = _apply_norm(cfg, params["final_norm"], x)
    logits = _unembed(rt, cfg, params, x)
    return (logits[:, prefix:] if prefix else logits), aux


def loss_fn(rt: L.Runtime, cfg: LMConfig, params: dict, batch: dict) -> torch.Tensor:
    logits, aux = forward(rt, cfg, params, batch["tokens"], batch.get("prefix_embeds"))
    ce = L.cross_entropy(logits, batch["labels"], cfg.vocab_size)
    if rt.model is not None:            # this rank's share of the mean over the whole sequences
        ce = ce / rt.model.size
    return ce + aux


# ---------------------------------------------------------------------------
# serving: prefill + decode with a stacked KV cache
# ---------------------------------------------------------------------------


def cache_specs(cfg: LMConfig, batch: int, max_len: int) -> dict:
    return L.init_kv_cache(cfg.attn(), batch, max_len, cfg.n_layers, cfg.dtype)


def _serve(rt, cfg, params, tokens, cache, pos: int, prefix_embeds=None) -> tuple[torch.Tensor, dict]:
    """Run tokens (B, S), after the prefix if one is given, at positions
    pos, pos + 1, ... through the stack, writing their keys and values into
    the cache; returns the hidden states after the final norm, and the
    parameters in the compute type."""
    params = cast_floats(params, cfg.dtype)
    x = _embed(rt, cfg, params, tokens, prefix_embeds)
    prefix = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    positions = pos + rt.seq_offset(x.shape[1]) + torch.arange(x.shape[1], device=x.device)
    for i, lp in enumerate(unbind_layers(params["blocks"], cfg.n_layers)):
        x, _, _ = _block(
            rt, cfg, lp, x, positions,
            cache=(cache["k"][i], cache["v"][i]), cache_pos=pos, prefix=prefix,
        )
    return _apply_norm(cfg, params["final_norm"], x), params


def prefill(
    rt: L.Runtime,
    cfg: LMConfig,
    params: dict,
    tokens: torch.Tensor,       # (B, S)
    cache: dict,                # {"k","v"}: (L, B, Smax, K, Dh), written in place
    prefix_embeds: torch.Tensor | None = None,   # (B, P, D): cache positions [0, P)
) -> tuple[torch.Tensor, dict]:
    """Populate the cache positions [0, P + S); return last-token logits."""
    x, params = _serve(rt, cfg, params, tokens, cache, 0, prefix_embeds)
    logits = _unembed(rt, cfg, params, x[:, -1:])
    return (logits if rt.model is None else rt.model.last(logits)), cache


def decode_step(
    rt: L.Runtime,
    cfg: LMConfig,
    params: dict,
    tokens: torch.Tensor,       # (B, 1) the newest token ids
    cache: dict,
    pos: int,                   # current write position
) -> tuple[torch.Tensor, dict]:
    """One autoregressive step against a populated cache."""
    x, params = _serve(rt, cfg, params, tokens, cache, int(pos))
    return _unembed(rt, cfg, params, x), cache
