"""Public wrappers for the kernels — port of ``repro/kernels/ops.py`` (the two
flash-attention adapters, ``ssd_scan``, ``rwkv6_scan``, ``moe_dispatch`` and
``ccu_reduce``).

Each validates shapes and adapts the model layers' layout to the kernel's.
Where the reference transposes (and so copies) q, k and v, the port hands the
kernel strided views: the kernel takes element strides, so the model's
``(B, S, heads, Dh)`` tensors and a slice of the KV cache are read in place.
``ssd_scan`` reads the model's ``Bm``/``Cm`` slices of the conv output in
place the same way, and takes any S and an initial state; so does
``rwkv6_scan``, which reads the model's ``(B,S,D) -> (B,S,H,N)`` views of r,
k, v and w in place.  ``moe_dispatch``
takes the reference's ``(T, E, C)`` form and the model's batched
``(B, T, E, C)`` one, so an MoE layer's dispatch is one launch.
``ccu_reduce`` takes any N (the reference's ``block_n`` tiling has no
counterpart) and a view of its peers' rows with a row stride.
"""

from __future__ import annotations

import torch

from .ccu_reduce import ccu_reduce  # noqa: F401  (checks shapes, types and devices itself)
from .flash_attention import flash_attention
from .moe_dispatch import moe_dispatch  # noqa: F401  (checks both forms itself)
from .rwkv6_scan import rwkv6_scan  # noqa: F401  (checks shapes, types and devices itself)
from .ssd_scan import ssd_scan  # noqa: F401  (checks shapes, types and devices itself)


def flash_attention_bkgsd(
    q, k, v, *, causal=True, window=None, prefix_len=0, q_start=0
) -> torch.Tensor:
    """q (B,K,G,Sq,D), k/v (B,K,Sk,D) -> (B,K,G,Sq,D)."""
    return flash_attention(
        q, k, v, causal=causal, window=window, prefix_len=prefix_len, q_start=q_start
    )


def flash_attention_bsnd(
    q, k, v, *, causal=True, window=None, prefix_len=0, q_start=0, sm_scale=None, return_lse=False
):
    """Model-layer layout: q (B,Sq,N,Dh), k/v (B,Sk,K,Dh) GQA -> (B,Sq,N,Dh).
    Query head n belongs to kv head n // (N // K).  ``sm_scale`` multiplies
    the scores (None: 1/sqrt(Dh)).  With ``return_lse`` also each row's
    log-sum-exp, (B,Sq,N) fp32."""
    if q.ndim != 4 or k.ndim != 4 or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"expected q (B,Sq,N,Dh), k/v (B,Sk,K,Dh) with K dividing N; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}"
        )
    B, Sq, N, D = q.shape
    K = k.shape[2]
    qk = q.unflatten(2, (K, N // K)).permute(0, 2, 3, 1, 4)     # (B,K,G,Sq,D) view
    o = flash_attention(
        qk, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
        causal=causal, window=window, prefix_len=prefix_len, q_start=q_start, sm_scale=sm_scale,
        return_lse=return_lse,
    )
    if return_lse:
        o, lse = o
        return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, N, D), lse.permute(0, 3, 1, 2).reshape(B, Sq, N)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, N, D)

