"""Mamba2 (SSD) block — port of ``repro/models/mamba2.py``.

Per chunk of Q tokens the chunked SSD form computes an intra-chunk causal
"linear attention with decay" and carries a state from chunk to chunk.
``ssd_chunked`` is the reference's plain twin of the scan, with its bf16
roundings of ``att`` and of the carried state; ``mamba2_apply`` runs it when
``rt.use_kernels`` is off and the hand-written ``ssd_scan`` kernel
(``kernels/ssd_scan.py``) when it is on.  The single-token recurrence of
decode is plain PyTorch on both paths, as in the reference.

Ported: ``Mamba2Config``, ``mamba2_specs``, ``_causal_conv``,
``ssd_chunked``, ``mamba2_apply``, ``mamba2_state_specs``.  One difference
on purpose: ``mamba2_apply`` without a state returns the state the sequence
leaves (the final scan state and the conv tail), which the reference
computes and drops; serving's prefill hands it to decode.  Added here:
``Mamba2Config.norm_before_gate`` and ``norm_eps``, the gated norm's order
and eps (the reference's order and 1e-6 by default; granite-4.0-h gates
before the norm, at 1e-5).

On the model axis (``rt.model``) a rank runs its heads ``[r·H/m,
(r+1)·H/m)`` (the rules' ``ssm_heads``) and takes their columns of the
fused ``in_proj`` (``_sequence_parallel_columns`` in training and prefill:
x gathered along the sequence, ``in_proj`` whole; in decode the token's
product with the rank's block gathered), ``A_log``/``dt_bias``/``D`` and
``out_norm`` are sliced to them, ``out_norm``'s mean of squares is summed
over the axis, and ``out_proj``'s partial output is reduce-scattered back
to the rank's positions (training, prefill) or summed (decode).  The
state's ``h`` is the rank's block of heads, its conv tail whole and the
same bits on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import Runtime, _silu, rmsnorm, rmsnorm_spec
from .param import ParamSpec


@dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_inner: int             # typically 2 * d_model
    d_state: int = 64        # N
    head_dim: int = 64       # P
    d_conv: int = 4
    chunk: int = 128
    unroll: bool = False     # kept for field parity; the port always loops
    # the gated norm's order: True rmsnorm(y) * silu(z) (the reference's,
    # Zamba2's); False rmsnorm(y * silu(z)) (mamba_ssm's norm_before_gate=False,
    # granite-4.0-h's)
    norm_before_gate: bool = True
    norm_eps: float = 1e-6   # out_norm's eps

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba2_specs(cfg: Mamba2Config) -> dict:
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    return {
        # order: [z | x | B | C | dt]
        "in_proj": ParamSpec(
            (D, 2 * DI + 2 * N + H), ("embed_in", "ssm_proj"), init="scaled"
        ),
        "conv_w": ParamSpec((cfg.d_conv, DI + 2 * N), (None, None), init="scaled"),
        "conv_b": ParamSpec((DI + 2 * N,), (None,), init="zeros"),
        "dt_bias": ParamSpec((H,), (None,), init="zeros"),
        "A_log": ParamSpec((H,), (None,), init="zeros"),
        "D": ParamSpec((H,), (None,), init="ones"),
        "out_norm": rmsnorm_spec(DI),
        "out_proj": ParamSpec((DI, D), ("ssm_inner", "embed_in"), init="scaled"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal conv over (B, S, C) as the reference's sum of K
    shifted products; returns (y, new_state).  A state of another type is
    promoted with x, as the reference's concatenation promotes."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else None
    return y + b, new_state


def ssd_chunked(
    xh: torch.Tensor,       # (B, S, H, P)   dt-weighted inputs
    log_l: torch.Tensor,    # (B, S, H)      log decay per token (dt * A, <= 0)
    Bm: torch.Tensor,       # (B, S, N)
    Cm: torch.Tensor,       # (B, S, N)
    chunk: int,
    h0: torch.Tensor | None = None,   # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, the reference's arithmetic (``att`` and the carried
    state cast to the inputs' type before their products; the reference's
    ``unroll``, a choice between a Python loop and ``lax.scan``, has no
    counterpart: the port always loops).  Returns (y (B,S,H,P), h_final)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    n_chunks = S // Q
    assert S % Q == 0, "sequence must be divisible by the chunk size"

    xh_c = xh.reshape(B, n_chunks, Q, H, P)
    ll_c = log_l.reshape(B, n_chunks, Q, H)
    B_c = Bm.reshape(B, n_chunks, Q, N)
    C_c = Cm.reshape(B, n_chunks, Q, N)

    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device) if h0 is None else h0
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    ys = []
    for c in range(n_chunks):
        xq, lq, bq, cq = xh_c[:, c], ll_c[:, c], B_c[:, c], C_c[:, c]
        cum = torch.cumsum(lq, dim=1)                              # (B,Q,H)
        # intra-chunk: att[i,j] = (C_i . B_j) * exp(cum_i - cum_j) for i>=j
        scores = torch.einsum("bin,bjn->bij", cq, bq)              # (B,Q,Q)
        decay = cum[:, :, None, :] - cum[:, None, :, :]            # (B,Q,Q,H)
        att = scores[..., None] * torch.exp(
            torch.where(causal[None, :, :, None], decay, -torch.inf)
        )                                                          # (B,Q,Q,H)
        y_intra = torch.einsum("bijh,bjhp->bihp", att.to(xq.dtype), xq)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum(
            "bin,bhpn->bihp", cq, h.to(cq.dtype)
        ) * torch.exp(cum)[..., None].to(cq.dtype)
        # state update: h' = h * exp(sum l) + sum_j exp(cum_Q - cum_j) x_j B_j^T
        tail = torch.exp(cum[:, -1:, :] - cum)                     # (B,Q,H)
        dh = torch.einsum("bjhp,bjn,bjh->bhpn", xq.float(), bq.float(), tail)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + dh
        ys.append((y_intra + y_inter).to(xq.dtype))
    return torch.stack(ys, dim=1).reshape(B, S, H, P), h


def mamba2_apply(
    rt: Runtime,
    p: dict,
    x: torch.Tensor,            # (B, S, D)
    cfg: Mamba2Config,
    state: dict | None = None,  # decode: {"h": (B,H,P,N), "conv": (B,K-1,C)}
    keep: bool = True,
) -> tuple[torch.Tensor, dict]:
    """Returns (out, state after the sequence): without ``state`` the
    chunked scan over the whole sequence from a zero state, with one the
    token-by-token recurrence from it.  ``keep`` False where the caller
    drops the state (training): on the model axis its conv tail is then
    not computed (``None``)."""
    DI, N, P = cfg.d_inner, cfg.d_state, cfg.head_dim
    model = rt.model
    heads = chans = slice(None)
    if model is not None:       # this rank's heads and their channels of d_inner
        m, r = model.size, model.rank
        heads = slice(r * cfg.n_heads // m, (r + 1) * cfg.n_heads // m)
        chans = slice(r * DI // m, (r + 1) * DI // m)
    if model is None or rt.tp:
        zxbcdt = x @ p["in_proj"]
        if model is not None:
            # decode: the token's product with the rank's block of in_proj
            # gathered (a few KB; no weight is), every rank the whole row
            zxbcdt = model.rows(zxbcdt).movedim(0, -2).flatten(-2)
        z, xc, Bm, Cm, dt = torch.split(zxbcdt, [DI, DI, N, N, cfg.n_heads], dim=-1)
        conv_in = torch.cat([xc, Bm, Cm], dim=-1)
        conv_out, conv_state = _causal_conv(
            conv_in, p["conv_w"], p["conv_b"], None if state is None else state["conv"]
        )
        conv_out = _silu(conv_out)
        xc, Bm, Cm = torch.split(conv_out, [DI, N, N], dim=-1)
        z, xc, dt = z[..., chans], xc[..., chans], dt[..., heads]
    else:
        x, z, xc, Bm, Cm, dt, conv_state = _sequence_parallel_columns(model, p, x, cfg, heads, chans, keep)
    B, S, D = x.shape
    H = cfg.n_heads if model is None else cfg.n_heads // model.size

    a = -torch.exp(p["A_log"][heads].float())                    # (H,)
    dt = F.softplus(dt.float() + p["dt_bias"][heads])             # (B,S,H)
    log_l = dt * a                                                # (B,S,H) <=0
    xh = xc.reshape(B, S, H, P)
    xh = rt.shard(xh, "batch", None, "ssm_heads", None)
    xdt = xh * dt[..., None].to(xh.dtype)

    if state is None:
        if rt.use_kernels:
            y, h_final = ops.ssd_scan(xdt, log_l, Bm, Cm, chunk=cfg.chunk)
        else:
            y, h_final = ssd_chunked(xdt, log_l, Bm, Cm, cfg.chunk)
    else:
        # single-token recurrence (S small, typically 1)
        h = state["h"]
        ys = []
        for t in range(S):
            lam = torch.exp(log_l[:, t])                          # (B,H)
            dh = torch.einsum("bhp,bn->bhpn", xdt[:, t].float(), Bm[:, t].float())
            h = h * lam[:, :, None, None] + dh
            ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].float(), h))
        y = torch.stack(ys, dim=1).to(x.dtype)
        h_final = h
    new_state = {"h": h_final, "conv": conv_state}

    y = y + xh * p["D"][heads][None, None, :, None].to(xh.dtype)
    y = y.reshape(B, S, H * P)
    if cfg.norm_before_gate:
        y = rmsnorm(p["out_norm"][chans], y, cfg.norm_eps, group=model) * _silu(z)
    else:
        y = rmsnorm(p["out_norm"][chans], y * _silu(z), cfg.norm_eps, group=model)
    out = y @ p["out_proj"]
    if model is not None:               # out_proj's rows of this rank's heads: a partial sum
        # back to the rank's positions in training and prefill; whole in decode
        out = model.all_reduce(out) if rt.tp else model.reduce_scatter(out, 1)
    return rt.shard(out, "batch", None, None), new_state


def _sequence_parallel_columns(model, p: dict, x: torch.Tensor, cfg: Mamba2Config, heads: slice, chans: slice,
                                tail: bool):
    """A Mamba2 layer's inputs in training and prefill on the model axis,
    where the rank holds its positions: x gathered along the sequence (the
    scan needs all of it) and ``in_proj`` gathered whole, as the sp-sharded
    weights are (each gather's backward a reduce-scatter): its columns
    ``[z | x | B | C | dt]`` are cut into m equal blocks that do not line
    up with the heads.  The rank's heads' ``z``, ``x`` and ``dt`` columns
    and ``B``/``C`` whole are picked from it, the conv runs on the rank's
    channels and ``B``/``C``, and (with ``tail``) the conv tail the state
    keeps is every channel's, from the last ``K - 1`` positions' product
    with the conv's columns: the same bits on every rank.  Returns (the
    gathered x, z, x, B, C, dt, the conv tail or None)."""
    DI, N, K = cfg.d_inner, cfg.d_state, cfg.d_conv
    x = model.gather(x, 1)
    w = model.gather(p["in_proj"], 1)
    x_cols = slice(DI + chans.start, DI + chans.stop)
    bc = slice(2 * DI, 2 * DI + 2 * N)
    dt_cols = slice(2 * DI + 2 * N + heads.start, 2 * DI + 2 * N + heads.stop)
    z, xc, Bm, Cm, dt = torch.split(x @ torch.cat([w[:, chans], w[:, x_cols], w[:, bc], w[:, dt_cols]], dim=1),
                                    [DI // model.size, DI // model.size, N, N, heads.stop - heads.start], dim=-1)
    conv_w = torch.cat([p["conv_w"][:, chans], p["conv_w"][:, DI:]], dim=1)
    conv_b = torch.cat([p["conv_b"][chans], p["conv_b"][DI:]])
    conv_out, _ = _causal_conv(torch.cat([xc, Bm, Cm], dim=-1), conv_w, conv_b)
    xc, Bm, Cm = torch.split(_silu(conv_out), [DI // model.size, N, N], dim=-1)
    if not tail:
        return x, z, xc, Bm, Cm, dt, None
    last = x[:, -(K - 1):] @ w[:, DI:2 * DI + 2 * N]                  # pre-conv, as one process's conv keeps it
    pad = last.new_zeros((last.shape[0], K - 1, last.shape[2]))
    return x, z, xc, Bm, Cm, dt, torch.cat([pad, last], dim=1)[:, -(K - 1):]


def mamba2_state_specs(cfg: Mamba2Config, batch: int, n_layers: int) -> dict:
    H, P, N = cfg.n_heads, cfg.head_dim, cfg.d_state
    C = cfg.d_inner + 2 * N
    return {
        "h": ParamSpec(
            (n_layers, batch, H, P, N),
            ("layers", "batch", "ssm_heads", None, None),
            init="zeros",
            dtype=torch.float32,
        ),
        "conv": ParamSpec(
            (n_layers, batch, cfg.d_conv - 1, C),
            ("layers", "batch", None, None),
            init="zeros",
            dtype=torch.bfloat16,
        ),
    }
