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
once in the forward and once in the recompute.  The embedding, every norm,
the attention (its rope inside it), the MLP or MoE layer, the unembedding
and the loss run inside the spans of ``spans.py`` (``model.embed``,
``model.norm``, ``model.attention``, ``model.rope``, ``model.mlp``,
``model.moe``, ``model.unembed``, ``model.loss``), which a profiler reads.

On the "model" axis (``rt.model``; ``train/train_step.py``) a rank holds
its model shard of each weight the rules shard on the axis.  In training
and prefill it holds the positions ``[r·T/m, (r+1)·T/m)`` of each sequence
of T positions (the rules' ``sp``): ``forward``, ``loss_fn`` and
``prefill`` offset the positions by ``rt.seq_offset``; each block's sharded
weights but the MoE experts are gathered whole at the top of ``_block``
(inside the remat body, so the recompute gathers them again; the
reference's GSPMD gathers of sp-sharded weights), the token table in
``_embed`` and ``unembed`` before the logits; the MoE layer keeps its
experts cut (``models/moe.py``).  A VLM's prefix embeddings go before the
tokens and the rank takes its positions of the whole (``_concat_shard``):
the tokens, labels and prefix rows are gathered over the axis and cut
again, as the reference concatenates before its sequence shard.
``loss_fn`` weighs the local mean by the rank's share of the tokens, so
that the ranks' losses sum to the mean over the sequences' tokens (and the
MoE auxiliary loss, the same on every model rank, by ``1/m``); ``prefill``
returns the last model rank's last-token logits on every rank.
``decode_step`` runs the axis tensor-parallel (``rt.tp``,
``models/layers.py``): no weight is gathered, the partial sums are summed
and the logits gathered, so every rank returns the same logits.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch

from .. import spans
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


def _norm(cfg: LMConfig, p: Any, x: torch.Tensor) -> torch.Tensor:
    return L.rmsnorm(p, x) if cfg.norm == "rms" else L.layernorm(p, x)


def _apply_norm(cfg: LMConfig, p: Any, x: torch.Tensor) -> torch.Tensor:
    return spans.call("model.norm", _norm, cfg, p, x)


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
    whole, by the specs ``specs_of(cfg)`` (only the keys of ``p`` are read);
    in decode (``rt.tp``) and for the MoE experts, ``p`` as it is."""
    cut = {k: v for k, v in p.items() if k != "moe"}
    return {**L.whole(rt, cut, specs_of(cfg)), **({"moe": p["moe"]} if "moe" in p else {})}


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
    a, new_cache = spans.call(
        "model.attention", L.attention, rt, p["attn"], h, cfg.attn(prefix), positions, cache, cache_pos
    )
    x = x + a
    h = _apply_norm(cfg, p["ln2"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe is not None:
        m, aux = spans.call("model.moe", moe_apply, rt, p["moe"], h, cfg.moe)
    else:
        m = spans.call("model.mlp", L.swiglu if cfg.act == "swiglu" else L.gelu_mlp, rt, p["mlp"], h)
    x = x + m
    return rt.shard(x, "batch", "sp", None), new_cache, aux


def _sequence_parallel(rt: L.Runtime) -> bool:
    return rt.model is not None and not rt.tp


def _concat_shard(rt: L.Runtime, P: int, *pieces: torch.Tensor) -> list[torch.Tensor]:
    """On the model axis, the rank's shards of a VLM's prefix ``pieces[0]``
    (B, P/m, D) and of the token-like ``pieces[1:]`` (B, S/m) become its
    positions ``[r·T/m, (r+1)·T/m)`` of their concatenation (T = P + S):
    each piece gathered over the axis and cut again.  Returns the prefix's
    rows and each token piece's columns that fall there (either may be
    empty)."""
    m = rt.model.size
    T = P + pieces[1].shape[1] * m
    lo, hi = rt.model.rank * T // m, (rt.model.rank + 1) * T // m
    whole = [rt.model.gather(t, 1) for t in pieces]
    return [whole[0][:, lo:min(hi, P)]] + [t[:, max(lo, P) - P:max(hi, P) - P] for t in whole[1:]]


def _embed(rt: L.Runtime, cfg: LMConfig, params: dict, tokens: torch.Tensor,
           prefix_embeds: torch.Tensor | None = None) -> tuple[torch.Tensor, int, int]:
    """The embedded sequence of this rank, the whole prefix's length and
    the number of prefix rows among the rank's positions."""
    P = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    if P and _sequence_parallel(rt):
        P *= rt.model.size
        prefix_embeds, tokens = _concat_shard(rt, P, prefix_embeds, tokens)
    x = spans.call("model.embed", lambda tok: L.embed(rt, _whole(rt, {"tok": tok}, _embed_specs, cfg), tokens),
                   params["embed"]["tok"])
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x.to(cfg.dtype), P, 0 if prefix_embeds is None else prefix_embeds.shape[1]


def _embed_specs(cfg: LMConfig) -> dict:
    return L.embed_specs(cfg.vocab_padded, cfg.d_model)


def _unembed(rt: L.Runtime, cfg: LMConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    return spans.call("model.unembed", L.unembed, rt,
                      _whole(rt, {"unembed": params["embed"]["unembed"]}, _embed_specs, cfg), x)


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
    x, prefix, here = _embed(rt, cfg, params, tokens, prefix_embeds)
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
    return (logits[:, here:] if here else logits), aux


def loss_fn(rt: L.Runtime, cfg: LMConfig, params: dict, batch: dict) -> torch.Tensor:
    logits, aux = forward(rt, cfg, params, batch["tokens"], batch.get("prefix_embeds"))
    labels = batch["labels"]
    if not _sequence_parallel(rt):
        return spans.call("model.loss", L.cross_entropy, logits, labels, cfg.vocab_size) + aux
    # this rank's share of the mean over the whole sequences' tokens, and of
    # the auxiliary loss (the same on every model rank)
    n_all = labels.shape[1] * rt.model.size
    if "prefix_embeds" in batch:
        prefix = batch["prefix_embeds"]
        labels = _concat_shard(rt, prefix.shape[1] * rt.model.size, prefix, labels)[1]
    share = labels.shape[1] / n_all
    ce = spans.call("model.loss", L.cross_entropy, logits, labels, cfg.vocab_size) * share if share \
        else logits.sum() * 0.0
    return ce + aux / rt.model.size


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
    x, prefix, _ = _embed(rt, cfg, params, tokens, prefix_embeds)
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
    pos: int,                   # current write position (an int, or a tensor read once)
) -> tuple[torch.Tensor, dict]:
    """One autoregressive step against a populated cache; on the model axis
    tensor-parallel (``rt.tp``), every rank returning the same logits."""
    if rt.model is not None:
        rt = dataclasses.replace(rt, tp=True)
    x, params = _serve(rt, cfg, params, tokens, cache, int(pos))
    return _unembed(rt, cfg, params, x), cache
