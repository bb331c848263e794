"""Plain PyTorch oracles in the kernels' layouts — port of
``repro/kernels/ref.py`` (``attention_ref``; the other oracles come with their
kernels).

The oracle shares nothing with the kernel modules, neither code nor method, so
a kernel and its plain version can both be held against it: where they build a
boolean mask and fill with a large negative constant, it walks the query rows
one by one, works out each row's visible keys as index ranges, and takes the
softmax over those keys alone, in float64."""

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
    q64, k64, v64 = q.double(), k.double(), v.double()
    rows = []
    for i in range(Sq):
        pos = q_start + i
        hi = min(pos + 1, Sk) if causal else Sk             # keys [lo, hi) ...
        lo = max(pos - window + 1, 0) if window is not None else 0
        keys = list(range(min(prefix_len, Sk)))             # ... and the prefix
        keys += range(max(lo, len(keys)), hi)
        idx = torch.tensor(keys, dtype=torch.long, device=q.device)
        s = torch.einsum("bkgd,bksd->bkgs", q64[:, :, :, i], k64[:, :, idx]) * scale
        p = torch.softmax(s, dim=-1)
        rows.append(torch.einsum("bkgs,bksd->bkgd", p, v64[:, :, idx]))
    return torch.stack(rows, dim=3).to(q.dtype)
