"""Flash attention (GQA) — port of ``repro/kernels/flash_attention.py``
(``_attn_kernel`` / ``flash_attention``, a Pallas kernel for the TPU, which is
forward-only).

``flash_attention`` is the wrapper: on CUDA tensors it launches the CUDA C++
kernel of ``csrc/flash_attention.cu`` (built at first use, see ``_build.py``)
or raises; on CPU tensors, and only there, it computes the same function with
``flash_attention_plain``.  There is no fallback from the kernel to the plain
version.  ``flash_attention.launches`` counts kernel launches.

Layout as in the reference: q ``(B, K, G, Sq, D)``, k/v ``(B, K, Sk, D)`` with
the G query heads of a kv head grouped.  Unlike the reference the tensors may
be strided views (innermost stride 1), Sq and Sk need not be multiples of a
tile, and ``q_start`` gives the global position of query row 0, so the same
function serves prefill (``q_start=0``) and a decode step over the cache
(``Sq=1, q_start=pos``).  Every query row must see at least one key.

Gradients: where autograd records (grad mode on and an input that requires
grad), bf16 at head_dim 64 or 128 over more than ``DECODE_ROWS`` folded
rows (every bf16 training path but paligemma-3b's head_dim 256) runs inside
``FlashGradient``: the forward kernel also
writes each row's log-sum-exp and its output before the rounding to bf16,
and the backward is the hand-written kernels of
``csrc/flash_attention_bwd.cu`` (``_launch_bwd``; their arithmetic in plain
PyTorch: ``flash_attention_bwd_plain``), counted by
``flash_attention.bwd_launches``.  Other types and widths, and
decode-sized calls, run inside ``_autograd.PlainGradient``, whose backward
is the gradient of ``flash_attention_plain``, recomputed from the saved q, k
and v.  The choice is made from the dtype and the shape
(``kernel_gradient``).  The
reference has no backward kernel (no ``custom_vjp``).

On the card the function is bound by bytes (q, k, v read once, o written
once).  ``_launch`` hands the call to one of three kernels of the CUDA source,
whose notes say what each design does about that and what is left for later:

- folded rows ``G * Sq <= 16`` (a decode step), either type: the keys split
  across ``decode_splits`` blocks a kv head, whose fp32 partials (in a workspace
  that ``_launch`` allocates) a second kernel combines in a fixed order;
- bf16 otherwise (prefill, training): wgmma on the tensor cores over a
  three-stage cp.async K/V ring, the next tile's scores overlapping this
  tile's softmax; where ``Sk > FLUSH_KEYS`` (a model rank's rows down a long
  sequence) ``_launch`` allocates a workspace into which the kernel flushes
  its fp32 accumulator every ``FLUSH_KEYS`` keys (the tensor cores' fp32
  sums round against the accumulator's size);
- float32 otherwise (smoke sizes and tests): the first design, fp32 FMA.

A call counts one launch, also where a decode step runs two kernels.

``return_lse=True`` (a decode call, ``G * Sq <= 16``, no autograd) also
returns each row's log-sum-exp of its scaled scores, ``(B, K, G, Sq)`` fp32,
written by the combine kernel (``flash_attention_plain`` computes the same):
a model rank that attends over its block of the cache returns it with its
output, and the ranks' outputs are combined by it as the kernel combines its
own splits (``models/layers.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import spans
from . import _build
from ._autograd import PlainGradient

NEG_INF = -1e30          # the kernel's finite mask fill (reference: NEG_INF)
HEAD_DIMS = (32, 64, 128, 256)
BWD_HEAD_DIMS = (64, 128)   # head dims of the backward kernels (bf16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_ROWS = 16         # folded rows G * Sq up to which the decode kernels run
KEY_TILE = 64            # keys in a kernel's tile
FLUSH_KEYS = 32 * KEY_TILE   # keys after which the tensor-core kernel flushes O to an fp32 copy
MAX_SPLITS = 128         # key splits the decode combine kernel takes


def decode_splits(bk: int, Sk: int, n_sm: int) -> int:
    """Key splits of a decode call over ``bk = B * K`` kv heads: enough
    blocks (``bk`` a split) for about two on each of ``n_sm`` SMs, each
    split a whole number of 64-key tiles, no more splits than tiles or
    ``MAX_SPLITS``."""
    tiles = -(-Sk // KEY_TILE)
    want = min(tiles, MAX_SPLITS, max(1, -(-2 * n_sm // bk)))
    per = -(-tiles // want)
    return -(-tiles // per)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def visible(
    Sq: int, Sk: int, *, causal: bool, window: int | None, prefix_len: int,
    q_start: int, device=None,
) -> torch.Tensor:
    """Boolean (Sq, Sk): which key each query row may attend to."""
    q_pos = q_start + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (q_pos >= k_pos)
    if window is not None:
        ok = ok & ((q_pos - k_pos) < window)
    if prefix_len > 0:
        ok = ok | (k_pos < prefix_len)
    return ok


def flash_attention_plain(
    q: torch.Tensor,            # (B, K, G, Sq, D)
    k: torch.Tensor,            # (B, K, Sk, D)
    v: torch.Tensor,            # (B, K, Sk, D)
    *,
    causal: bool = True,
    window: int | None = None,
    prefix_len: int = 0,
    q_start: int = 0,
    sm_scale: float | None = None,
    return_lse: bool = False,
):
    """Plain PyTorch version of the kernel's function, with the kernel's
    arithmetic: inputs widened to fp32, fp32 scores and probabilities, the
    finite -1e30 fill, output cast to the input type.  (float64 inputs stay
    float64, for checking the gradient by finite differences.)  With
    ``return_lse``, also each row's log-sum-exp of the filled scores, fp32
    ``(B, K, G, Sq)``."""
    Sq, D = q.shape[3], q.shape[4]
    Sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    wide = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bkgqd,bksd->bkgqs", q.to(wide), k.to(wide)) * scale
    ok = visible(
        Sq, Sk, causal=causal, window=window, prefix_len=prefix_len,
        q_start=q_start, device=q.device,
    )
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(wide)).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1).to(wide)) if return_lse else o


def flash_attention_bwd_plain(
    q: torch.Tensor,            # (B, K, G, Sq, D)
    k: torch.Tensor,            # (B, K, Sk, D)
    v: torch.Tensor,            # (B, K, Sk, D)
    o: torch.Tensor,            # (B, K, G, Sq, D), the forward's output (the kernels': before rounding)
    lse: torch.Tensor,          # (B, K, G, Sq), the forward's log-sum-exp
    do: torch.Tensor,           # (B, K, G, Sq, D), the output's gradient
    *,
    causal: bool = True,
    window: int | None = None,
    prefix_len: int = 0,
    q_start: int = 0,
    sm_scale: float | None = None,
):
    """Plain PyTorch version of the backward kernels' function, with their
    algorithm in fp32 (float64 stays float64): the probabilities recomputed
    from the saved log-sum-exp, ``P = exp(S * scale - lse)`` (masked keys
    0), ``delta = rowsum(dO * O)``, ``dS = P * (dO V^T - delta)``; returns
    ``(dq, dk, dv)`` in the inputs' types, dk and dv summed over the G
    query heads of their kv head."""
    Sq, D = q.shape[3], q.shape[4]
    Sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    wide = torch.promote_types(q.dtype, torch.float32)
    qw, kw, vw, ow, dow = (t.to(wide) for t in (q, k, v, o, do))
    s = torch.einsum("bkgqd,bksd->bkgqs", qw, kw) * scale
    ok = visible(
        Sq, Sk, causal=causal, window=window, prefix_len=prefix_len,
        q_start=q_start, device=q.device,
    )
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.to(wide)[..., None])
    delta = (dow * ow).sum(-1)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dow, vw)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kw) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qw) * scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dow)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, window, prefix_len, q_start):
    if q.ndim != 5 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q (B,K,G,Sq,D), k/v (B,K,Sk,D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, K, G, Sq, D = q.shape
    if k.shape[0] != B or k.shape[1] != K or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not agree")
    if min(B, K, G, Sq, k.shape[2]) < 1:
        raise ValueError(f"empty dimension: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v of different types: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported {HEAD_DIMS}")
    if (window is not None and window < 1) or prefix_len < 0 or q_start < 0:
        raise ValueError(f"bad window={window}, prefix_len={prefix_len}, q_start={q_start}")


def _aligned(t: torch.Tensor) -> bool:
    """The kernels load rows 16 bytes at a time: innermost stride 1, every
    row and every stride 16-byte aligned."""
    per16 = 16 // t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(s % per16 == 0 for s in t.stride()[:-1])


def _launch(q, k, v, *, causal, window, prefix_len, q_start, sm_scale, return_lse=False, for_backward=False):
    """The forward kernels: o; with ``return_lse`` (o, lse); with
    ``for_backward`` (o, lse, o before its rounding, fp32), which only the
    tensor-core kernel writes (bf16, G * Sq > 16)."""
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 4 + [ci] * 7 + [ctypes.POINTER(ctypes.c_longlong)] \
            + [ci] * 4 + [ctypes.c_float, vp, ci, vp, vp, vp]
        fn.restype = ci
        lib.flash_attention_error_string.argtypes = [ci]
        lib.flash_attention_error_string.restype = ctypes.c_char_p

    o = torch.empty_like(q)     # keeps q's strides where q is a dense view
    strides = [*q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *o.stride()[:4]]
    for t in (q, k, v, o):
        if not _aligned(t):
            raise ValueError(
                "flash_attention needs innermost stride 1 and 16-byte aligned rows; "
                f"got shape {tuple(t.shape)}, strides {t.stride()}"
            )
    B, K, G, Sq, D = q.shape
    Sk = k.shape[2]
    splits, part, lse, o32 = 0, None, None, None
    if return_lse or for_backward:
        lse = torch.empty((B, K, G, Sq), dtype=torch.float32, device=q.device)
    if for_backward:
        o32 = torch.empty((B, K, G, Sq, D), dtype=torch.float32, device=q.device)
    if G * Sq <= DECODE_ROWS:
        splits = decode_splits(B * K, Sk, _sm_count(q.device.index))
        part = torch.empty(B * K * splits * G * Sq * (D + 2), dtype=torch.float32, device=q.device)
    elif q.dtype == torch.bfloat16 and Sk > FLUSH_KEYS:
        # the tensor-core kernel's fp32 copies of O, flushed every FLUSH_KEYS keys
        part = torch.empty(-(-G * Sq // 64) * B * K * 64 * max(D, 64), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, K, G, Sq, Sk, D, _DTYPES[q.dtype],
            (ctypes.c_longlong * 14)(*strides),
            int(causal), -1 if window is None else int(window), int(prefix_len),
            int(q_start), float(sm_scale),
            None if part is None else part.data_ptr(), splits,
            None if lse is None else lse.data_ptr(),
            None if o32 is None else o32.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} (cudaError {err})")
    flash_attention.launches += 1
    if for_backward:
        return o, lse, o32
    return (o, lse) if return_lse else o


def _launch_bwd(q, k, v, o, lse, do, *, causal, window, prefix_len, q_start, sm_scale):
    """The backward kernels of ``csrc/flash_attention_bwd.cu``: (dq, dk, dv)
    in bf16, from the forward's inputs, its output ``o`` before its rounding
    (fp32) and log-sum-exp.  ``do`` is copied where its rows do
    not meet the kernels' alignment."""
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 10 + [ci] * 6 + [ctypes.POINTER(ctypes.c_longlong)] + [ci] * 4 \
            + [ctypes.c_float, vp]
        fn.restype = ci
        lib.flash_attention_bwd_error_string.argtypes = [ci]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p

    if not _aligned(do):
        do = do.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for t in (q, k, v, o, dq, dk, dv):
        if not _aligned(t):
            raise ValueError("flash_attention's backward needs innermost stride 1 and 16-byte aligned rows; "
                             f"got shape {tuple(t.shape)}, strides {t.stride()}")
    B, K, G, Sq, D = q.shape
    Sk = k.shape[2]
    # each row's delta and lse in log2 units, in rows padded to whole 64-row tiles
    work = torch.empty(2 * B * K * G * -(-Sq // KEY_TILE) * KEY_TILE, dtype=torch.float32, device=q.device)
    strides = [*q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *o.stride()[:4], *do.stride()[:4],
               *dq.stride()[:4], *dk.stride()[:3], *dv.stride()[:3]]
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.contiguous().data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(),
            B, K, G, Sq, Sk, D, (ctypes.c_longlong * 28)(*strides),
            int(causal), -1 if window is None else int(window), int(prefix_len), int(q_start), float(sm_scale),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention backward launch failed: {msg} (cudaError {err})")
    flash_attention.bwd_launches += 1
    return dq, dk, dv


class FlashGradient(torch.autograd.Function):
    """``FlashGradient.apply(fwd, bwd, q, k, v)``: flash attention under
    autograd with a backward of its own.  ``fwd(q, k, v)`` returns the
    output, each row's log-sum-exp and the output before its rounding (on
    the card the forward kernel, ``for_backward``); the backward, inside the
    span ``flash_attention.bwd``, returns ``bwd(q, k, v, o, lse, do)`` with
    that unrounded o (on the card ``_launch_bwd``; the tests hand it
    ``flash_attention_bwd_plain``), so nothing of size Sq x Sk is kept or
    made."""

    @staticmethod
    def forward(ctx, fwd, bwd, q, k, v):
        o, lse, o_exact = fwd(q, k, v)
        ctx.bwd = bwd
        ctx.save_for_backward(q, k, v, o_exact, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        with spans.mark("flash_attention.bwd"):
            dq, dk, dv = ctx.bwd(*ctx.saved_tensors, do)
        return None, None, dq, dk, dv


def kernel_gradient(q: torch.Tensor) -> bool:
    """Whether flash attention under autograd takes the backward kernels
    (``FlashGradient``): bf16 at head_dim 64 or 128, over more than
    ``DECODE_ROWS`` folded rows (G * Sq), where the forward is the
    tensor-core kernel that writes the unrounded output the backward
    reads.  Other types, widths and decode-sized calls take the plain
    version's gradient (``PlainGradient``)."""
    _, _, G, Sq, D = q.shape
    return q.dtype == torch.bfloat16 and D in BWD_HEAD_DIMS and G * Sq > DECODE_ROWS


def _with_grad(q, k, v, kw, launch=_launch, launch_bwd=_launch_bwd):
    """Flash attention under autograd, its backward chosen by
    ``kernel_gradient``; ``launch`` and ``launch_bwd`` (the kernels) are the
    forward and backward calls, which the tests replace with the plain
    versions on CPU tensors."""
    if kernel_gradient(q):
        return FlashGradient.apply(lambda *t: launch(*t, for_backward=True, **kw),
                                   lambda *t: launch_bwd(*t, **kw), q, k, v)
    return PlainGradient.apply("flash_attention", lambda *t: launch(*t, **kw),
                               lambda *t: flash_attention_plain(*t, **kw), q, k, v)


def flash_attention(
    q: torch.Tensor,            # (B, K, G, Sq, D)
    k: torch.Tensor,            # (B, K, Sk, D)
    v: torch.Tensor,            # (B, K, Sk, D)
    *,
    causal: bool = True,
    window: int | None = None,
    prefix_len: int = 0,
    q_start: int = 0,
    sm_scale: float | None = None,
    return_lse: bool = False,
):
    """Attention output ``(B, K, G, Sq, D)`` in q's type; with
    ``return_lse`` (a decode call: ``G * Sq <= 16``, no autograd) the pair
    (output, log-sum-exp ``(B, K, G, Sq)`` fp32)."""
    _check(q, k, v, window, prefix_len, q_start)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    kw = dict(causal=causal, window=window, prefix_len=prefix_len, q_start=q_start, sm_scale=scale)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if return_lse and (q.shape[2] * q.shape[3] > DECODE_ROWS or grad):
        raise ValueError(f"the log-sum-exp is a decode call's (G * Sq <= {DECODE_ROWS}, no autograd); "
                         f"got q {tuple(q.shape)}, autograd {grad}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, return_lse=return_lse, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    if return_lse:
        return _launch(q, k, v, return_lse=True, **kw)
    if grad:
        return _with_grad(q, k, v, kw)
    return _launch(q, k, v, **kw)


flash_attention.launches = 0
flash_attention.bwd_launches = 0
