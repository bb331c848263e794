"""Plain PyTorch oracles in the kernels' layouts — port of
``repro/kernels/ref.py`` (``attention_ref``, ``ssd_scan_ref``,
``rwkv6_scan_ref``, ``moe_gather_matmul_ref``, ``ccu_reduce_ref``).

Each oracle shares nothing with the kernel modules, neither code nor method,
so a kernel and its plain version can both be held against it, and works in
float64.  ``attention_ref``: where the kernel modules build a boolean mask
and fill with a large negative constant, it walks the query rows one by one,
works out each row's visible keys as index ranges, and takes the softmax over
those keys alone.  ``ssd_scan_ref``: where the kernel modules work chunk by
chunk with cumulative decays, it runs the state recurrence one token at a
time.  ``rwkv6_scan_ref``: where the kernel modules sum log decays per chunk
and take pairwise exponentials, it multiplies the state by each token's
decay in turn.  ``moe_dispatch_ref``: where the kernel modules contract the token axis
in one product, it adds the tokens' contributions one token at a time.
``ccu_reduce_ref``: where the kernel modules add the peers in fp32 one by one,
it sums them in float64 and rounds once."""

from __future__ import annotations

import math

import torch


def attention_ref(
    q: torch.Tensor,            # (B, K, G, Sq, D)
    k: torch.Tensor,            # (B, K, Sk, D)
    v: torch.Tensor,            # (B, K, Sk, D)
    *,
    causal: bool = True,
    window: int | None = None,
    prefix_len: int = 0,
    q_start: int = 0,
    sm_scale: float | None = None,
) -> torch.Tensor:
    Sq, D = q.shape[3], q.shape[4]
    Sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    # contiguous keys and values: a row's einsum then reads a view of them,
    # where a strided layout would have it copy (and autograd keep) all of
    # them for every row
    q64, k64, v64 = q.double(), k.double().contiguous(), v.double().contiguous()
    rows = []
    for i in range(Sq):
        pos = q_start + i
        hi = min(pos + 1, Sk) if causal else Sk             # keys [lo, hi) ...
        lo = max(pos - window + 1, 0) if window is not None else 0
        n_prefix = min(prefix_len, Sk)                      # ... and the prefix
        start = max(lo, n_prefix)
        if n_prefix == 0 or start == n_prefix:
            # one run of keys: a view, so that autograd keeps no copy a row
            first = 0 if n_prefix else lo
            last = max(hi, start)
            kr, vr = k64[:, :, first:last], v64[:, :, first:last]
        else:
            keys = list(range(n_prefix)) + list(range(start, hi))
            idx = torch.tensor(keys, dtype=torch.long, device=q.device)
            kr, vr = k64[:, :, idx], v64[:, :, idx]
        s = torch.einsum("bkgd,bksd->bkgs", q64[:, :, :, i], kr) * scale
        p = torch.softmax(s, dim=-1)
        rows.append(torch.einsum("bkgs,bksd->bkgd", p, vr))
    return torch.stack(rows, dim=3).to(q.dtype)


def ssd_scan_ref(
    xh: torch.Tensor,           # (B, S, H, P)
    log_l: torch.Tensor,        # (B, S, H)
    Bm: torch.Tensor,           # (B, S, N)
    Cm: torch.Tensor,           # (B, S, N)
    h0: torch.Tensor | None = None,   # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-level SSD recurrence ``h <- h * exp(l_t) + x_t B_t^T``,
    ``y_t = h C_t``, any S: y (B,S,H,P) in xh's type, the final state
    (B,H,P,N) in float32."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    x64, l64, b64, c64 = xh.double(), log_l.double(), Bm.double(), Cm.double()
    h = (torch.zeros((B, H, P, N), dtype=torch.float64, device=xh.device) if h0 is None
         else h0.double())
    ys = []
    for t in range(S):
        h = h * torch.exp(l64[:, t])[:, :, None, None] + x64[:, t, :, :, None] * b64[:, t, None, None, :]
        ys.append((h * c64[:, t, None, None, :]).sum(-1))
    return torch.stack(ys, dim=1).to(xh.dtype), h.float()


def rwkv6_scan_ref(
    r: torch.Tensor,            # (B, S, H, N)
    k: torch.Tensor,            # (B, S, H, N)
    v: torch.Tensor,            # (B, S, H, N)
    w: torch.Tensor,            # (B, S, H, N) decay in (0, 1)
    u: torch.Tensor,            # (H, N) bonus
    s0: torch.Tensor | None = None,   # (B, H, N, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-level RWKV-6 recurrence ``y_t = r_t (S + diag(u) k_t v_t^T)``,
    ``S <- diag(w_t) S + k_t v_t^T``, any S: y (B,S,H,N) in r's type, the
    final state (B,H,N,N) in float32."""
    B, S, H, N = r.shape
    r64, k64, v64, w64 = r.double(), k.double(), v.double(), w.double()
    u64 = u.double()
    s = (torch.zeros((B, H, N, N), dtype=torch.float64, device=r.device) if s0 is None
         else s0.double())
    ys = []
    for t in range(S):
        kv = k64[:, t, :, :, None] * v64[:, t, :, None, :]              # (B,H,N,N)
        ys.append((r64[:, t, :, :, None] * (s + u64[None, :, :, None] * kv)).sum(-2))
        s = s * w64[:, t, :, :, None] + kv
    return torch.stack(ys, dim=1).to(r.dtype), s.float()


def moe_dispatch_ref(
    disp: torch.Tensor,         # (T, E, C) or (B, T, E, C)
    x: torch.Tensor,            # (T, D) or (B, T, D)
) -> torch.Tensor:
    """Expert inputs ``out[e, c, :] = sum_t disp[t, e, c] * x[t, :]``:
    (E, C, D), or (E, B, C, D) for the batched form, in x's type."""
    batched = disp.ndim == 4
    d64 = (disp if batched else disp[None]).double()
    x64 = (x if batched else x[None]).double()
    B, T, E, C = d64.shape
    out = torch.zeros((E, B, C, x64.shape[-1]), dtype=torch.float64, device=x.device)
    for t in range(T):
        # token t's row of x, weighted into every (expert, slot) of every row
        out += d64[:, t].permute(1, 0, 2)[..., None] * x64[None, :, t, None, :]
    return (out if batched else out[:, 0]).to(x.dtype)


def moe_gather_matmul_ref(
    disp: torch.Tensor,         # (T, E, C)
    x: torch.Tensor,            # (T, D)
    w: torch.Tensor,            # (E, D, F)
) -> torch.Tensor:
    """Dispatch, then each expert's product with its weight: (E, C, F) in
    x's type.  The expert inputs stay float64 (unrounded) in between."""
    ein = moe_dispatch_ref(disp.double(), x.double())            # (E, C, D)
    out = torch.stack([ein[e] @ w[e].double() for e in range(w.shape[0])])
    return out.to(x.dtype)


def ccu_reduce_ref(
    bufs: torch.Tensor,                  # (P, N)
    scales: torch.Tensor | None = None,  # (P,)
) -> torch.Tensor:
    """The peers' sum ``sum_p bufs[p] * scales[p]`` in float64, rounded once to
    fp32: (N,)."""
    b64 = bufs.double()
    if scales is not None:
        b64 = b64 * scales.double()[:, None]
    return b64.sum(0).float()
