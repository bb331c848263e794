"""Shared layers — port of ``repro/models/layers.py``.

All layers are plain functions ``(rt, params, x, ...) -> y`` on tensors and
nested dicts of tensors with the reference's keys and shapes (weights stay
``(in, out)``).  ``rt`` is a :class:`Runtime`.  Each rank runs eagerly on
its own tensors, so there is no sharding constraint to hand a compiler:
``rules`` stays None and ``shard`` is the identity.  ``rt.model``, where
the mesh's "model" axis has more than one rank, is that axis
(``parallel.collectives.ModelAxis``): the tokens a layer sees are then the
rank's positions ``[r·S/m, (r+1)·S/m)`` of each sequence (the rules' ``sp``
placement), and ``attention`` gathers the keys and values of the whole
sequence over the axis before it attends (``rt.seq_offset``, the query
rows' first position, is the causal mask's and the kernel's ``q_start``).
The weights arrive whole: the transformer gathers them
(``models/transformer.py``).  ``embed``, ``unembed`` and
``cross_entropy`` are per-token and run on the local tokens as they are.
With a cache (prefill) each rank writes the slice of the gathered keys and
values that falls in its block of the cache (the rules' ``cache_seq``:
positions ``[r·L/m, (r+1)·L/m)`` of a cache of length L), so a prompt
shorter than the cache fills the first blocks.

In decode on the model axis (``rt.tp``, set by each family's
``decode_step``, and by the SSM family everywhere: the rules never cut its
sequence) the axis is tensor-parallel, as the rules' layout makes it with
``sp`` off:
every rank holds the whole batch's token and its shard of each weight.
``attention`` projects the rank's columns of q, k and v, gathers them (a
few KB), writes the new key and value into the block that owns the
position, attends every query head over the rank's own block of the cache
(``_attend_block``: flash decode returning each row's log-sum-exp, or none
where the block has no visible key) and combines the ranks' partial
outputs as the flash kernel combines its key splits (``_combine``):
reduce-scattered over the head dim, each chunk scaled by ``exp(lse_r -
lse)`` in fp32 where it is summed, the sums in ``ccu_reduce`` in rank
order, so each rank holds its heads' rows for the row-parallel output
projection; the projection's and the MLP's down
projection's partial sums are summed over the axis in ``ccu_reduce``.
``embed`` looks up the rank's columns of the table and gathers them,
``unembed`` computes the rank's vocabulary shard and gathers the logits.
The encoder-decoder's cross-attention is ``_cross_attention_tp``.  No
weight is gathered: the traffic is activations only.  ``rmsnorm`` with a
``group`` normalises a dim the axis cuts (RWKV-6's ``ln_out`` and Mamba2's
``out_norm`` on a rank's heads), ``whole`` gathers a block's cut weights
in training and prefill.

Ported: ``Runtime``, ``rmsnorm``, ``layernorm``, ``rope``, ``AttnConfig``,
``attn_specs``, ``_mask_bias``, ``sdpa``, ``attention`` (with
``kv_override``, the encoder-decoder's cross-attention), ``init_kv_cache``,
``swiglu``, ``gelu_mlp``, their ``*_specs``, ``embed_specs``, ``embed``,
``unembed``, ``cross_entropy``.  The reference's ``blocked_sdpa`` (its eager
twin under ``AttnConfig.impl == "blocked"``, which only its TPU hill-climb
benchmark sets) is not ported: ``impl`` is kept for field parity and ignored,
the kernel path's attention being the flash kernel.  Beside
them, ``_silu`` and ``_sigmoid``: the reference's framework's SiLU and
sigmoid as they round in bfloat16, for the Mamba2 and RWKV-6 blocks.

One thing differs from the reference on purpose: ``Runtime.use_kernels`` is
honoured (the reference never reads it).  When it is set, ``attention`` goes
through the hand-written flash-attention kernel, in prefill and in every
decode step, an MoE layer's dispatch (``models/moe.py``) through the
hand-written moe-dispatch kernel, and a Mamba2 layer's chunked scan in
prefill (``models/mamba2.py``) through the hand-written ssd-scan kernel and an
RWKV-6 layer's in prefill (``models/rwkv6.py``) through the hand-written
rwkv6-scan kernel; when it is not, they go through ``sdpa`` + ``_mask_bias``,
the dispatch einsum and the ``ssd_chunked`` and ``rwkv6_chunked`` twins exactly
as the reference does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from .. import spans
from ..kernels import ops
from .param import ParamSpec


@dataclass(frozen=True)
class Runtime:
    """Context threaded through every layer."""

    rules: Any = None            # sharding constraints: not ported (each rank's tensors are local)
    use_kernels: bool = True     # attention, MoE dispatch, SSD and RWKV-6 scans through the hand-written kernels
    model: Any = None            # the "model" axis (parallel.collectives.ModelAxis) where it has > 1 rank
    fsdp: Any = None             # the axes the rules cut the MoE experts over (moe_fsdp), where > 1 rank
    tokens: Any = None           # every rank holding other tokens of the batch (training: the MoE aux means)
    tp: bool = False             # decode on the model axis: weights used as cut, partial sums summed

    def shard(self, x: torch.Tensor, *logical: str | None) -> torch.Tensor:
        if self.rules is not None:
            raise NotImplementedError("sharding constraints are not ported: each rank's tensors are its "
                                      "local blocks (Runtime.model carries the sequence-parallel axis)")
        return x

    def seq_offset(self, s_local: int) -> int:
        """The first global position of this rank's ``s_local`` tokens of
        each sequence: 0 without a model axis, and in decode (``tp``)."""
        return 0 if self.model is None or self.tp else self.model.rank * s_local


# ---------------------------------------------------------------------------
# Activations as the reference's framework rounds them
# ---------------------------------------------------------------------------


def _silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU as the reference's framework computes it, x · 1/(1 + exp(−x)),
    each operation rounded to x's type.  ``F.silu`` rounds once and, in
    bfloat16, lies one ulp away in about 40 % of the elements; the scans
    carry such differences from layer to layer."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Sigmoid as the reference's framework computes it, 1/(1 + exp(−x)),
    each operation rounded to x's type.  ``torch.sigmoid`` rounds once and,
    in bfloat16, lies one ulp away in about a third of the elements."""
    return torch.reciprocal(1 + torch.exp(-x))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(dim: int) -> ParamSpec:
    return ParamSpec((dim,), (None,), init="ones")


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6, group=None) -> torch.Tensor:
    """With ``group`` (an ``AxisGroup``) ``x`` holds this rank's block of
    the normed dim, the ranks' blocks in rank order: the mean of squares
    is over the whole dim, each rank's sum of squares summed over the
    group (``all_reduce``, whose backward is a sum), and ``w`` is the
    rank's block of the weight."""
    dt = x.dtype
    x32 = x.float()
    if group is None:
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    else:
        var = group.all_reduce(torch.sum(x32 * x32, dim=-1, keepdim=True)) / (x.shape[-1] * group.size)
    # the weight multiplies AFTER the cast back to the working type
    return (x32 * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def layernorm_specs(dim: int) -> dict:
    return {
        "scale": ParamSpec((dim,), (None,), init="ones"),
        "bias": ParamSpec((dim,), (None,), init="zeros"),
    }


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y.to(dt) * p["scale"].to(dt)) + p["bias"].to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (S,) or (B, S).  Rotates the two HALVES of
    the head dim against each other, not interleaved pairs."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]                       # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    dt = x.dtype
    return torch.cat(
        [(x1 * cos - x2 * sin).to(dt), (x2 * cos + x1 * sin).to(dt)], dim=-1
    )


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    window: int | None = None      # sliding-window size (None = full)
    rope_theta: float | None = 10000.0
    qkv_bias: bool = False
    prefix_len: int = 0            # bidirectional prefix (VLM / audio stubs)
    impl: str = "reference"        # kept for field parity; see Runtime.use_kernels
    softmax_scale: float | None = None   # multiplies the scores; None: 1/sqrt(head_dim)


def attn_specs(cfg: AttnConfig) -> dict:
    """Flattened projections ``(d_model, heads * head_dim)``."""
    D, N, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((D, N * Dh), ("embed_in", "qkv"), init="scaled"),
        "wk": ParamSpec((D, K * Dh), ("embed_in", "kv"), init="scaled"),
        "wv": ParamSpec((D, K * Dh), ("embed_in", "kv"), init="scaled"),
        "wo": ParamSpec((N * Dh, D), ("qkv", "embed_in"), init="scaled"),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((N * Dh,), ("qkv",), init="zeros")
        specs["bk"] = ParamSpec((K * Dh,), ("kv",), init="zeros")
        specs["bv"] = ParamSpec((K * Dh,), ("kv",), init="zeros")
        specs["bo"] = ParamSpec((D,), (None,), init="zeros")
    return specs


def _mask_bias(
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    causal: bool,
    window: int | None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Additive attention bias (0 / -1e9), shape (Sq, Sk), float32.

    ``prefix_len`` makes the first N key positions visible to everyone.
    """
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok = ok & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        ok = ok & ((q_pos[:, None] - k_pos[None, :]) < window)
    if prefix_len > 0:
        ok = ok | (k_pos[None, :] < prefix_len)
    bias = torch.zeros(ok.shape, dtype=torch.float32, device=q_pos.device)
    return bias.masked_fill(~ok, -1e9)


def sdpa(
    q: torch.Tensor,      # (B, Sq, K, G, Dh)  q heads grouped by kv head
    k: torch.Tensor,      # (B, Sk, K, Dh)
    v: torch.Tensor,      # (B, Sk, K, Dh)
    bias: torch.Tensor | None,   # (Sq, Sk)
    return_lse: bool = False,
    scale: float | None = None,
):
    """Reference grouped-query attention, with the reference's arithmetic:
    probabilities are cast to v's type before the second product.  The
    scores are multiplied by ``scale`` (None: 1/sqrt(head_dim)).  With
    ``return_lse`` also each row's log-sum-exp of its biased scores,
    ``(B, Sq, K, G)`` fp32 (a model rank's decode over its block of the
    cache)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    if bias is not None:
        scores = scores + bias[None, None, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    if not return_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1).permute(0, 3, 1, 2)


def attention(
    rt: Runtime,
    p: dict,
    x: torch.Tensor,                 # (B, S, D)
    cfg: AttnConfig,
    positions: torch.Tensor,         # (S,) global positions of the q tokens
    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,  # (B,Smax,K,Dh) x2
    cache_pos: int | None = None,    # write offset into the cache
    kv_override: torch.Tensor | None = None,   # (B, T, D) encoder states: cross-attention
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """Full attention layer.  Returns (out, cache).

    With ``kv_override`` the keys and values are projected from it (no
    rope) and every query sees every one of them: the kernel path calls
    flash attention with ``causal=False``, no prefix, ``q_start=0``, the
    plain path ``sdpa`` with no bias.

    The cache is written IN PLACE at ``cache_pos`` (the reference, whose
    arrays are immutable, builds a new one with ``dynamic_update_slice``); the
    tensors returned are the ones passed in.

    On the kernel path the q tokens are the contiguous positions
    ``cache_pos .. cache_pos + S - 1`` (``0 .. S - 1`` without a cache), which
    is what ``positions`` holds in every caller; the kernel takes that start
    as an integer and attends over the keys ``[0, cache_pos + S)`` of the
    cache.  The reference attends over the whole cache with the causal mask
    hiding the rest, which is the same: those probabilities are exactly 0.

    On the model axis (``rt.model``) the rank's ``S`` query rows are the
    positions ``rt.seq_offset(S) + 0 .. S - 1`` (``positions``); their keys
    and values are gathered over the axis along the sequence, and the rows
    attend to all of them: the kernel with ``q_start`` at the offset, the
    plain path with the mask of ``positions`` against ``0 .. Sk - 1``.
    With a cache (prefill; its sequence is the rules' ``cache_seq``,
    sharded on the axis) each rank writes the gathered keys and values of
    the positions its block holds.  In decode on the axis (``rt.tp``) the
    layer is ``_attention_tp``.
    """
    B, S, D = x.shape
    N, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = N // K
    if rt.tp:
        if kv_override is not None:
            return _cross_attention_tp(rt, p, x, cfg, kv_override), kv_cache
        return _attention_tp(rt, p, x, cfg, int(cache_pos), kv_cache), kv_cache

    kv_src = kv_override if kv_override is not None else x
    q = x @ p["wq"]
    k = kv_src @ p["wk"]
    v = kv_src @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, N, Dh)
    k = k.reshape(B, kv_src.shape[1], K, Dh)
    v = v.reshape(B, kv_src.shape[1], K, Dh)
    q = rt.shard(q, "batch", "sp", None, None)

    if cfg.rope_theta is not None and kv_override is None:
        q = spans.call("model.rope", rope, q, positions, cfg.rope_theta)
        k = spans.call("model.rope", rope, k, positions, cfg.rope_theta)

    q_start = 0
    new_cache = None
    gathered = rt.model is not None and kv_override is None
    if gathered:
        k, v = rt.model.gather(k, 1), rt.model.gather(v, 1)
        q_start = rt.seq_offset(S)
        if kv_cache is not None:
            if cache_pos is None or int(cache_pos) != 0:
                raise ValueError("on the model axis a prefill writes the cache from position 0")
            # this rank's block of the cache: the gathered positions that fall in it
            Lb = kv_cache[0].shape[1]
            lo = rt.model.rank * Lb
            hi = min(lo + Lb, k.shape[1])
            if hi > lo:
                kv_cache[0][:, :hi - lo] = k[:, lo:hi].to(kv_cache[0].dtype)
                kv_cache[1][:, :hi - lo] = v[:, lo:hi].to(kv_cache[1].dtype)
            new_cache = kv_cache
    elif kv_cache is not None:
        ck, cv = kv_cache
        if cache_pos is not None:
            q_start = int(cache_pos)
            ck[:, q_start:q_start + k.shape[1]] = k.to(ck.dtype)
            cv[:, q_start:q_start + v.shape[1]] = v.to(cv.dtype)
        k, v = ck, cv
        new_cache = (ck, cv)

    if rt.use_kernels:
        if kv_override is not None:
            mask = dict(causal=False, window=None, prefix_len=0, q_start=0)
        else:
            if kv_cache is not None and not gathered:
                k, v = k[:, :q_start + S], v[:, :q_start + S]
            mask = dict(causal=cfg.causal, window=cfg.window, prefix_len=cfg.prefix_len, q_start=q_start)
        out = ops.flash_attention_bsnd(q, k.to(q.dtype), v.to(q.dtype), sm_scale=cfg.softmax_scale, **mask)
    else:
        bias = None
        if kv_override is None:
            k_pos = (
                torch.arange(k.shape[1], device=x.device) if kv_cache is not None or gathered
                else positions
            )
            bias = _mask_bias(positions, k_pos, cfg.causal, cfg.window, cfg.prefix_len)
        out = sdpa(q.reshape(B, S, K, G, Dh), k, v, bias, scale=cfg.softmax_scale)
    out = out.reshape(B, S, N * Dh)
    y = out @ p["wo"]
    if "bo" in p:
        y = y + p["bo"]
    return rt.shard(y, "batch", "sp", None), new_cache


def _attention_tp(rt: Runtime, p: dict, x: torch.Tensor, cfg: AttnConfig, pos: int,
                  kv_cache: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """One decode step's attention on the model axis (module docstring):
    ``x (B, 1, D)`` the same on every model rank, ``p`` the rank's shards
    (``wq``/``wk``/``wv`` columns, ``wo`` rows), ``kv_cache`` the rank's
    block of positions ``[r·Lb, (r+1)·Lb)``; returns the layer's output
    ``(B, 1, D)``, the same bits on every rank."""
    B, S, D = x.shape
    N, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    model = rt.model
    parts = [x @ p["wq"], x @ p["wk"], x @ p["wv"]]
    if "bq" in p:
        parts = [parts[0] + p["bq"], parts[1] + p["bk"], parts[2] + p["bv"]]
    widths = [t.shape[-1] for t in parts]
    # the rank's columns of q, k and v gathered in one all-gather: (P, B, 1, n) -> (B, 1, P * n) each
    rows = model.rows(torch.cat(parts, dim=-1))
    q, k, v = (c.movedim(0, -2).flatten(-2) for c in rows.split(widths, dim=-1))
    q, k, v = q.reshape(B, S, N, Dh), k.reshape(B, S, K, Dh), v.reshape(B, S, K, Dh)
    if cfg.rope_theta is not None:
        at = torch.full((S,), pos, device=x.device)
        q, k = (spans.call("model.rope", rope, t, at, cfg.rope_theta) for t in (q, k))
    ck, cv = kv_cache
    Lb = ck.shape[1]
    lo = model.rank * Lb
    if lo <= pos < lo + Lb:                    # this rank's block owns the new position
        ck[:, pos - lo] = k[:, 0].to(ck.dtype)
        cv[:, pos - lo] = v[:, 0].to(cv.dtype)
    o, lse = _attend_block(rt, q, ck, cv, cfg, pos, lo)
    mine = _combine(model, o, lse)                                  # (B, 1, N * Dh / P): this rank's heads' rows
    y = model.sum(mine @ p["wo"]).to(x.dtype)
    if "bo" in p:
        y = y + p["bo"]
    return y


def _cross_attention_tp(rt: Runtime, p: dict, x: torch.Tensor, cfg: AttnConfig,
                        enc: torch.Tensor) -> torch.Tensor:
    """One decode step's cross-attention on the model axis: ``x (B, 1, D)``
    the same on every model rank, ``enc (B, T, D)`` the encoder's output,
    whole on every rank (the cache holds it so), ``p`` the rank's shards.
    Each rank projects its columns of q, and of k and v over every frame.
    Where the rank's columns are whole heads (``K % m == 0``) it attends
    with them as one process does (flash with no mask, or ``sdpa``); where a
    head's columns lie on ``m / N`` consecutive ranks (whisper-base's 8
    heads on 16), each rank's partial scores ``(B, 1, T)`` fp32 over its
    columns are summed over that run of ranks (``AxisGroup.within``: one
    ``ccu_reduce``), and the softmax's probabilities multiply the rank's
    value columns.  Either way the rank holds its columns of the heads'
    output, the rows of ``wo`` it holds: the row-parallel partial sums are
    summed over the axis.  No weight is gathered."""
    B, S, D = x.shape
    N, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    model, T = rt.model, enc.shape[1]
    q, k, v = x @ p["wq"], enc @ p["wk"], enc @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if K % model.size == 0:                         # whole heads on every rank
        n, kh = N // model.size, K // model.size
        q, k, v = q.reshape(B, S, n, Dh), k.reshape(B, T, kh, Dh), v.reshape(B, T, kh, Dh)
        if rt.use_kernels:
            o = ops.flash_attention_bsnd(q, k, v, causal=False, window=None, prefix_len=0, q_start=0)
        else:
            o = sdpa(q.reshape(B, S, kh, n // kh, Dh), k, v, None)
        o = o.reshape(B, S, n * Dh)
    else:
        if N != K or model.size % N:
            raise ValueError(f"cross-attention of {N} query and {K} key heads on {model.size} model ranks: a "
                             f"head's columns must lie on a run of whole ranks")
        scores = torch.einsum("bqc,btc->bqt", q.float(), k.float()) / math.sqrt(Dh)
        scores = model.within(model.size // N).sum(scores)
        o = torch.einsum("bqt,btc->bqc", torch.softmax(scores, dim=-1).to(v.dtype), v)
    y = model.sum(o @ p["wo"]).to(x.dtype)
    if "bo" in p:
        y = y + p["bo"]
    return y


def _attend_block(rt: Runtime, q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, cfg: AttnConfig,
                  pos: int, lo: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Every query head of ``q (B, 1, N, Dh)`` at position ``pos`` over the
    keys of a block ``ck``/``cv (B, Lb, K, Dh)`` whose key ``j`` is the
    global position ``lo + j``: the output ``(B, 1, N, Dh)`` and each row's
    log-sum-exp ``(B, 1, N)`` fp32.  The mask is the global one moved by
    ``lo`` (the query at ``pos - lo``, the prefix's end at ``prefix_len -
    lo``), and only the keys up to the last visible one are read.  A block
    with no visible key (all its positions after the query, or before its
    window) launches nothing and gives zeros with log-sum-exp -inf: weight 0
    in ``_combine``."""
    B, S, N, Dh = q.shape
    Lb = ck.shape[1]
    q_local = pos - lo
    hi = min(Lb, q_local + 1) if cfg.causal else Lb          # keys after the query are hidden
    first = max(0, q_local - cfg.window + 1) if cfg.window is not None else 0
    prefix = max(0, min(Lb, cfg.prefix_len - lo))             # the bidirectional prefix's keys in the block
    if first >= hi and prefix == 0:
        return q.new_zeros(q.shape), torch.full((B, S, N), -math.inf, dtype=torch.float32, device=q.device)
    n = max(hi, prefix)
    k, v = ck[:, :n].to(q.dtype), cv[:, :n].to(q.dtype)
    if rt.use_kernels:
        return ops.flash_attention_bsnd(q, k, v, causal=cfg.causal, window=cfg.window, prefix_len=prefix,
                                        q_start=q_local, sm_scale=cfg.softmax_scale, return_lse=True)
    K = k.shape[2]
    bias = _mask_bias(torch.full((S,), q_local, device=q.device), torch.arange(n, device=q.device), cfg.causal,
                      cfg.window, prefix)
    o, lse = sdpa(q.reshape(B, S, K, N // K, Dh), k, v, bias, return_lse=True, scale=cfg.softmax_scale)
    return o.reshape(q.shape), lse.reshape(B, S, N)


def _combine(model, o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The ranks' partial outputs ``o (B, 1, N, Dh)`` with their
    log-sum-exps ``lse (B, 1, N)`` combined as the flash kernel combines its
    splits, in fp32: ``lse`` gathered from every rank; each rank's output
    sent as it is (its chunk of heads to the rank holding those rows of
    ``wo``: an exchange of a reduce-scatter), then on the receiving rank
    each chunk scaled by ``exp(lse_r - logsumexp_r lse_r)`` in fp32 and the
    chunks summed by one ``reduce`` (``ccu_reduce``) in rank order.  The
    same bits as scaling on the sender and reduce-scattering fp32 rows; the
    wire carries ``o``'s type.  Returns this rank's chunk ``(B, 1, N * Dh /
    P)``, rounded once to ``o``'s type: the rows of ``wo`` it holds."""
    P, (B, S, N, Dh) = model.size, o.shape
    lses = model.rows(lse)                                                      # (P, B, 1, N)
    weight = torch.exp(lses - torch.logsumexp(lses, dim=0))[..., None].expand(P, B, S, N, Dh)
    # chunk p of the flattened heads goes to rank p; row r of ``got`` is rank r's chunk of ours
    chunks = o.flatten(-2).unflatten(-1, (P, -1)).movedim(-2, 0)                # (P, B, 1, N * Dh / P)
    got = model.transport.all_to_all(chunks.contiguous(), kind="reduce-scatter")
    mine = weight.flatten(-2).unflatten(-1, (P, -1))[..., model.rank, :]         # (P, B, 1, N * Dh / P)
    scaled = got.float() * mine
    return model.reduce(scaled.reshape(P, -1)).view(B, S, -1).to(o.dtype)


def whole(rt: Runtime, p: dict, specs: dict) -> dict:
    """``p`` with each leaf that the rules cut over the model axis (by its
    spec in ``specs``, a tree of ``p``'s keys) gathered whole: in training
    and prefill, where the rank holds its positions of each sequence (the
    reference's GSPMD gathers of sp-sharded weights).  In decode
    (``rt.tp``) and without a model axis, ``p`` as it is."""
    if rt.model is None or rt.tp:
        return p
    return rt.model.gather_tree(p, {k: specs[k] for k in p})


def init_kv_cache(
    cfg: AttnConfig, batch: int, max_len: int, n_layers: int, dtype=torch.bfloat16
) -> dict:
    """Stacked (L, B, S, K, Dh) cache specs for the layer stack."""
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    logical = ("layers", "batch", "cache_seq", None, None)
    return {
        "k": ParamSpec(shape, logical, init="zeros", dtype=dtype),
        "v": ParamSpec(shape, logical, init="zeros", dtype=dtype),
    }


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_specs(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed_in", "ff"), init="scaled"),
        "w_up": ParamSpec((d_model, d_ff), ("embed_in", "ff"), init="scaled"),
        "w_down": ParamSpec((d_ff, d_model), ("ff", "embed_in"), init="scaled"),
    }


def swiglu(rt: Runtime, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    h = rt.shard(h, "batch", "sp", "ff_act")
    y = h @ p["w_down"]
    if rt.tp:                           # the rank's ff columns: a partial sum over the model axis
        y = rt.model.sum(y).to(x.dtype)
    return rt.shard(y, "batch", "sp", None)


def gelu_mlp_specs(d_model: int, d_ff: int, bias: bool = True) -> dict:
    s = {
        "w_in": ParamSpec((d_model, d_ff), ("embed_in", "ff"), init="scaled"),
        "w_out": ParamSpec((d_ff, d_model), ("ff", "embed_in"), init="scaled"),
    }
    if bias:
        s["b_in"] = ParamSpec((d_ff,), ("ff",), init="zeros")
        s["b_out"] = ParamSpec((d_model,), (None,), init="zeros")
    return s


def gelu_mlp(rt: Runtime, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_in"]
    if "b_in" in p:
        h = h + p["b_in"]
    h = F.gelu(h, approximate="tanh")       # the reference's gelu is the tanh form
    h = rt.shard(h, "batch", "sp", "ff_act")
    y = h @ p["w_out"]
    if rt.tp:                           # the rank's ff columns: a partial sum over the model axis
        y = rt.model.sum(y).to(x.dtype)
    if "b_out" in p:
        y = y + p["b_out"]
    return rt.shard(y, "batch", "sp", None)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_specs(vocab_padded: int, d_model: int) -> dict:
    """Untied lookup table and unembedding."""
    return {
        "tok": ParamSpec((vocab_padded, d_model), (None, "table_embed")),
        "unembed": ParamSpec(
            (d_model, vocab_padded), (None, "vocab"), init="scaled"
        ),
    }


def embed(rt: Runtime, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = p["tok"][tokens]
    if rt.tp:                           # the rank's columns of the table, gathered
        x = rt.model.gather(x, x.ndim - 1)
    return rt.shard(x, "batch", "sp", None)


def unembed(rt: Runtime, p: dict, x: torch.Tensor) -> torch.Tensor:
    logits = x @ p["unembed"]
    if rt.tp:                           # the rank's vocabulary shard, gathered
        logits = rt.model.gather(logits, logits.ndim - 1)
    return rt.shard(logits, "batch", "sp", "vocab")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_real: int) -> torch.Tensor:
    """Mean NLL over the logits in fp32, the padded vocab tail masked with
    -1e9.  The gold logit is gathered, where the reference sums a one-hot
    product: the same value, since every other term of that sum is zero."""
    lg = logits.float()
    V = lg.shape[-1]
    if vocab_real < V:
        mask = torch.arange(V, device=lg.device) < vocab_real
        lg = torch.where(mask, lg, torch.full_like(lg, -1e9))
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)
