"""RWKV-6 "Finch" time-mix and channel-mix — port of ``repro/models/rwkv6.py``.

Per head (dim N) a state S in R^{N x N}; per token t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
with the data-dependent decay w_t = exp(-exp(w0 + lora(x_t))) in (0, 1) and
the per-channel bonus u.  ``rwkv6_chunked`` is the reference's plain twin of
the chunked scan; ``timemix_apply`` runs it when ``rt.use_kernels`` is off and
the hand-written ``rwkv6_scan`` kernel (``kernels/rwkv6_scan.py``) when it is
on.  The token recurrence of decode is plain PyTorch on both paths, as in the
reference.

Ported: ``RWKV6Config``, ``timemix_specs``, ``channelmix_specs``,
``_token_shift``, ``_lerp``, ``rwkv6_chunked``, ``timemix_apply``,
``channelmix_apply``, ``rwkv6_state_specs``.  Two things follow the
reference's framework where PyTorch's own calls round otherwise: the gates
use ``layers._silu`` and ``layers._sigmoid``, and the decay's low-rank
product goes in the reference's order, ``(x @ a) @ b``, each product rounded
to the compute type.  One difference on purpose: without a state both
``timemix_apply`` and ``channelmix_apply`` return the state the sequence
leaves (the scan's final state and the token shift's last input), which the
reference computes and drops; serving's prefill hands it to decode.

On the model axis (``rt.tp``: ``rwkv_lm`` runs the family tensor-parallel
everywhere) a rank holds heads ``[r·H/m, (r+1)·H/m)``: the time mix's
``wr``/``wk``/``wv``/``wg`` and ``w_lora_b`` give its columns, ``w0``,
``bonus_u`` and ``ln_out``'s weight are sliced to its channels (``mu`` and
``w_lora_a`` act on the whole input), the scan runs on its heads (its
state ``s`` the rank's block), ``ln_out``'s mean of squares is summed over
the axis and ``wo``'s partial output summed (``all_reduce``); the channel
mix reduce-scatters its partial ``vv`` over D, multiplies the rank's
block of ``rr`` and gathers the product (one reduce-scatter and one gather
of a (B, S, D) tensor, where summing ``vv`` whole and gathering ``rr``
would take an all-reduce of it besides).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import ops
from .layers import Runtime, _sigmoid, _silu, rmsnorm, rmsnorm_spec
from .param import ParamSpec


@dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    head_dim: int = 64
    d_ff: int = 7168
    decay_lora: int = 64
    chunk: int = 128
    unroll: bool = False   # kept for field parity; the port always loops

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


def timemix_specs(cfg: RWKV6Config) -> dict:
    D, L = cfg.d_model, cfg.decay_lora
    return {
        "mu": ParamSpec((5, D), (None, None), init="zeros"),  # r,k,v,g,w shifts
        "wr": ParamSpec((D, D), ("embed_in", "rkv"), init="scaled"),
        "wk": ParamSpec((D, D), ("embed_in", "rkv"), init="scaled"),
        "wv": ParamSpec((D, D), ("embed_in", "rkv"), init="scaled"),
        "wg": ParamSpec((D, D), ("embed_in", "rkv"), init="scaled"),
        "w0": ParamSpec((D,), (None,), init="zeros"),
        "w_lora_a": ParamSpec((D, L), ("embed_in", None), init="scaled"),
        "w_lora_b": ParamSpec((L, D), (None, "rkv"), init="scaled"),
        "bonus_u": ParamSpec((D,), (None,), init="zeros"),
        "ln_out": rmsnorm_spec(D),
        "wo": ParamSpec((D, D), ("rkv", "embed_in"), init="scaled"),
    }


def channelmix_specs(cfg: RWKV6Config) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "mu": ParamSpec((2, D), (None, None), init="zeros"),   # k, r shifts
        "wk": ParamSpec((D, F), ("embed_in", "ff"), init="scaled"),
        "wv": ParamSpec((F, D), ("ff", "embed_in"), init="scaled"),
        "wr": ParamSpec((D, D), ("embed_in", "rkv"), init="scaled"),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} stream; ``last`` carries the final token across steps.  A
    ``last`` of another type is promoted with x, as the reference's
    concatenation promotes."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _lerp(x, xprev, mu):
    return x + (xprev - x) * mu[None, None, :]


def rwkv6_chunked(
    r: torch.Tensor,   # (B, S, H, N)
    k: torch.Tensor,   # (B, S, H, N)
    v: torch.Tensor,   # (B, S, H, N)
    w: torch.Tensor,   # (B, S, H, N)  per-channel decay in (0,1)  (float32)
    u: torch.Tensor,   # (H, N) bonus
    chunk: int,
    s0: torch.Tensor | None = None,    # (B, H, N, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked linear-attention scan, the reference's arithmetic (fp32
    inside, y rounded once to r's type; the reference's ``unroll``, a choice
    between a Python loop and ``lax.scan``, has no counterpart: the port
    always loops).  Returns (y, final_state)."""
    B, S, H, N = r.shape
    Q = min(chunk, S)
    n_chunks = S // Q
    assert S % Q == 0, "sequence must be divisible by the chunk size"

    logw = torch.log(torch.clamp(w, 1e-6, 1.0))           # (B,S,H,N) <= 0
    rc, kc, vc, lc = (t.reshape(B, n_chunks, Q, H, N) for t in (r, k, v, logw))
    s = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device) if s0 is None else s0

    T = min(16, Q)                                         # pairwise sub-tile
    n_tiles = Q // T
    lower = torch.tril(torch.ones((T, T), dtype=torch.bool, device=r.device), diagonal=-1)
    ys = []
    for c in range(n_chunks):
        rq, kq, vq, lq = rc[:, c], kc[:, c], vc[:, c], lc[:, c]   # (B,Q,H,N)
        rq32, kq32, vq32 = rq.float(), kq.float(), vq.float()
        cum = torch.cumsum(lq, dim=1)                      # (B,Q,H,N) <= 0
        # inter-chunk: y_i += (r_i * prod_{t<i} w_t) S ; cum - lq <= 0 safe
        y_inter = torch.einsum("bihn,bhnm->bihm", rq32 * torch.exp(cum - lq), s)
        # intra-chunk, DIRECT pairwise form: cum_i - lq_i - cum_j <= 0 for
        # j < i, so every exp is bounded; tiled over (T x T) sub-blocks
        tiles = []
        for ti in range(n_tiles):
            i0 = ti * T
            ci = (cum - lq)[:, i0:i0 + T]                  # decay BEFORE i
            ri = rq32[:, i0:i0 + T]
            acc = torch.zeros((B, T, H, N), dtype=torch.float32, device=r.device)
            for tj in range(ti + 1):
                j0 = tj * T
                cj = cum[:, j0:j0 + T]
                d = ci[:, :, None] - cj[:, None, :]        # (B,T,T,H,N)
                if ti == tj:
                    d = torch.where(lower[None, :, :, None, None], d, -torch.inf)
                att = torch.einsum("bihn,bjhn,bijhn->bhij", ri, kq32[:, j0:j0 + T], torch.exp(d))
                acc = acc + torch.einsum("bhij,bjhn->bihn", att, vq32[:, j0:j0 + T])
            tiles.append(acc)
        y_intra = torch.cat(tiles, dim=1)
        bonus = torch.einsum("bihn,hn,bihn->bih", rq32, u.float(), kq32)
        y_bonus = bonus[..., None] * vq32
        # state update: S' = diag(prod w) S + sum_j (prod_{t>j} w_t) k_j v_j^T
        tail = torch.exp(cum[:, -1:] - cum)                # <= 1 safe
        s = s * torch.exp(cum[:, -1])[..., None] + torch.einsum(
            "bjhn,bjhm->bhnm", kq32 * tail, vq32)
        ys.append((y_inter + y_intra + y_bonus).to(rq.dtype))
    return torch.stack(ys, dim=1).reshape(B, S, H, N), s


def timemix_apply(
    rt: Runtime,
    p: dict,
    x: torch.Tensor,            # (B, S, D), the layer-normed input
    cfg: RWKV6Config,
    state: dict | None = None,  # decode: {"s": (B,H,N,N) fp32, "shift": (B,1,D)}
) -> tuple[torch.Tensor, dict]:
    """Returns (out, state after the sequence): without ``state`` the
    chunked scan over the whole sequence from a zero state, with one the
    token-by-token recurrence from it."""
    B, S, D = x.shape
    N = cfg.head_dim
    model = rt.model if rt.tp else None
    # on the model axis this rank's channels: heads [r·H/m, (r+1)·H/m)
    mine = slice(None) if model is None else slice(model.rank * D // model.size, (model.rank + 1) * D // model.size)
    H = cfg.n_heads if model is None else cfg.n_heads // model.size
    xprev = _token_shift(x, None if state is None else state["shift"])
    mu = p["mu"]
    r = _lerp(x, xprev, mu[0]) @ p["wr"]
    k = _lerp(x, xprev, mu[1]) @ p["wk"]
    v = _lerp(x, xprev, mu[2]) @ p["wv"]
    g = _lerp(x, xprev, mu[3]) @ p["wg"]
    xw = _lerp(x, xprev, mu[4])
    # the reference's order of the three-operand einsum, each product rounded
    wlog = p["w0"][mine][None, None] + (xw @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(wlog.float()))                   # (0,1) decay

    r4, k4, v4, w4 = (t.reshape(B, S, H, N) for t in (r, k, v, w))
    r4 = rt.shard(r4, "batch", None, "ssm_heads", None)
    u = p["bonus_u"][mine].reshape(H, N)

    if state is None:
        if rt.use_kernels:
            y, s_final = ops.rwkv6_scan(r4, k4, v4, w4, u, chunk=cfg.chunk)
        else:
            y, s_final = rwkv6_chunked(r4, k4, v4, w4, u, cfg.chunk)
    else:
        s = state["s"]
        ys = []
        for t in range(S):
            rt_, kt, vt, wt = r4[:, t].float(), k4[:, t].float(), v4[:, t].float(), w4[:, t]
            kv = torch.einsum("bhn,bhm->bhnm", kt, vt)
            ys.append(torch.einsum("bhn,bhnm->bhm", rt_, s + u[None, :, :, None] * kv))
            s = s * wt[..., None] + kv
        y = torch.stack(ys, dim=1).to(x.dtype)
        s_final = s
    new_state = {"s": s_final, "shift": x[:, -1:]}

    y = y.reshape(B, S, H * N)
    y = rmsnorm(p["ln_out"][mine], y, group=model) * _silu(g)
    out = y @ p["wo"]
    if model is not None:               # wo's rows of this rank's heads: a partial sum
        out = model.all_reduce(out)
    return rt.shard(out, "batch", None, None), new_state


def channelmix_apply(
    rt: Runtime,
    p: dict,
    x: torch.Tensor,            # (B, S, D), the layer-normed input
    state: dict | None = None,  # decode: {"shift": (B,1,D)}
) -> tuple[torch.Tensor, dict]:
    """Returns (out, {"shift": the last input}), with or without a state."""
    xprev = _token_shift(x, None if state is None else state["shift"])
    k = _lerp(x, xprev, p["mu"][0]) @ p["wk"]
    k = torch.square(torch.relu(k))
    k = rt.shard(k, "batch", None, "ff_act")
    vv = k @ p["wv"]
    rr = _sigmoid(_lerp(x, xprev, p["mu"][1]) @ p["wr"])
    if rt.tp:
        # vv is a partial sum over the rank's ff units, rr the rank's block of
        # D: vv reduce-scattered over D, the product gathered
        return rt.model.gather(rr * rt.model.reduce_scatter(vv, vv.ndim - 1), vv.ndim - 1), {"shift": x[:, -1:]}
    out = rr * vv
    return rt.shard(out, "batch", None, None), {"shift": x[:, -1:]}


def rwkv6_state_specs(cfg: RWKV6Config, batch: int, n_layers: int) -> dict:
    H, N, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    return {
        "tm_s": ParamSpec(
            (n_layers, batch, H, N, N),
            ("layers", "batch", "ssm_heads", None, None),
            init="zeros",
            dtype=torch.float32,
        ),
        "tm_shift": ParamSpec(
            (n_layers, batch, 1, D), ("layers", "batch", None, None),
            init="zeros", dtype=torch.bfloat16,
        ),
        "cm_shift": ParamSpec(
            (n_layers, batch, 1, D), ("layers", "batch", None, None),
            init="zeros", dtype=torch.bfloat16,
        ),
    }
