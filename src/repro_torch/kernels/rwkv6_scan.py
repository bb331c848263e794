"""RWKV-6 chunked linear-attention scan — port of ``repro/kernels/rwkv6_scan.py``
(``_rwkv_kernel`` / ``rwkv6_scan``, a Pallas kernel for the TPU).

``rwkv6_scan`` is the wrapper: on CUDA tensors it launches the CUDA C++ kernel
of ``csrc/rwkv6_scan.cu`` (built at first use, see ``_build.py``) or raises:
for bf16 inputs, what the model serves, the tensor-core design with decays
factored at 16-row tile edges (``tc::``), for fp32 the first design's FMA
kernel (``fma::``); the C entry point picks by the type alone.  On CPU
tensors, and only there, it computes the same function with
``rwkv6_scan_plain``.  There is no fallback from the kernel to the plain
version.  ``rwkv6_scan.launches`` counts kernel launches.  Under autograd (a
CUDA input that requires grad, grad mode on) the launch goes through
``_autograd.PlainGradient``: the kernel's output, and in the backward the
gradient of ``rwkv6_scan_plain`` recomputed at the saved inputs, for y, the
final state or both; no backward kernel yet.

The function is the reference's: per head a state ``S (N, N)`` and, token by
token, ``y_t = r_t (S + diag(u) k_t v_t^T)``, ``S <- diag(w_t) S + k_t v_t^T``,
computed chunk by chunk of ``Q = min(chunk, S)`` rows in float32 inside:
``r, k, v (B,S,H,N)`` and the decay ``w (B,S,H,N)`` in (0, 1) with the bonus
``u (H,N)`` give ``y (B,S,H,N)`` in r's type and the final state
``(B,H,N,N)`` in float32.  Two additions, both with a precedent in the
reference (``rwkv6_chunked`` and ``rwkv6_scan_ref`` take an initial state):
an initial state ``s0``, and any S, the last chunk partial.  A partial chunk
is the same as one padded with ``r = k = v = 0`` and ``w = 1`` rows, which
add nothing to the state and do not decay it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._autograd import PlainGradient

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128          # rows of a chunk the kernel holds in shared memory
MAX_WIDTH = 64           # head_dim N
TILE = 16                # rows of the intra-chunk pairwise tiles (the kernel's too)


def rwkv6_scan_plain(
    r: torch.Tensor,            # (B, S, H, N)
    k: torch.Tensor,            # (B, S, H, N)
    v: torch.Tensor,            # (B, S, H, N)
    w: torch.Tensor,            # (B, S, H, N) decay in (0, 1)
    u: torch.Tensor,            # (H, N) bonus
    *,
    chunk: int = 128,
    s0: torch.Tensor | None = None,   # (B, H, N, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's function, with the Pallas
    kernel's arithmetic: inputs widened to fp32, ``logw = log(clip(w, 1e-6,
    1))``, per chunk the cumulative log decay, the inter-chunk term
    ``(r·exp(cum−l))·S``, the bonus ``Σ_n r·u·k · v``, the intra-chunk term in
    16×16 tiles with the direct pairwise decay ``exp((cum_i − l_i) − cum_j)``
    (the strictly-lower mask applied before the exponential, so no exponent
    is positive), then the state update.  A partial last chunk is a shorter
    one, its last tile a shorter tile."""
    B, S, H, N = r.shape
    Q = min(chunk, S)
    r32, k32, v32, u32 = r.float(), k.float(), v.float(), u.float()
    logw = torch.log(torch.clamp(w.float(), 1e-6, 1.0))
    s = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device) if s0 is None
         else s0.float())
    ys = []
    for c0 in range(0, S, Q):
        rq, kq, vq, lq = (t[:, c0:c0 + Q] for t in (r32, k32, v32, logw))
        q = rq.shape[1]
        cum = torch.cumsum(lq, dim=1)                                  # (B,q,H,N) <= 0
        dec = cum - lq                                                 # decay before row i
        y = torch.einsum("bihn,bhnm->bihm", rq * torch.exp(dec), s)
        y = y + (rq * u32 * kq).sum(-1, keepdim=True) * vq
        for i0 in range(0, q, TILE):
            i1 = min(i0 + TILE, q)
            ri, di = rq[:, i0:i1], dec[:, i0:i1]
            acc = torch.zeros_like(vq[:, i0:i1])
            for j0 in range(0, i0 + 1, TILE):
                j1 = min(j0 + TILE, q)
                d = di[:, :, None] - cum[:, None, j0:j1]               # (B,ti,tj,H,N)
                if j0 == i0:
                    lower = torch.tril(torch.ones((i1 - i0, j1 - j0), dtype=torch.bool,
                                                  device=r.device), diagonal=-1)
                    d = torch.where(lower[None, :, :, None, None], d, -torch.inf)
                att = (ri[:, :, None] * kq[:, None, j0:j1] * torch.exp(d)).sum(-1)   # (B,ti,tj,H)
                acc = acc + torch.einsum("bijh,bjhn->bihn", att, vq[:, j0:j1])
            y[:, i0:i1] += acc
        tail = torch.exp(cum[:, -1:] - cum)                            # (B,q,H,N) <= 1
        s = s * torch.exp(cum[:, -1])[..., None] + torch.einsum("bjhn,bjhm->bhnm", kq * tail, vq)
        ys.append(y)
    return torch.cat(ys, dim=1).to(r.dtype), s


def _check(r, k, v, w, u, chunk, s0) -> None:
    if r.ndim != 4 or u.ndim != 2:
        raise ValueError(f"expected r, k, v, w (B,S,H,N) and u (H,N); got {tuple(r.shape)}, "
                         f"{tuple(u.shape)}")
    B, S, H, N = r.shape
    if any(tuple(t.shape) != (B, S, H, N) for t in (k, v, w)) or tuple(u.shape) != (H, N):
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"w {tuple(w.shape)} and u {tuple(u.shape)} do not agree")
    if min(B, S, H, N) < 1:
        raise ValueError(f"empty dimension: r {tuple(r.shape)}")
    if s0 is not None and tuple(s0.shape) != (B, H, N, N):
        raise ValueError(f"s0 of shape {tuple(s0.shape)}, expected {(B, H, N, N)}")
    tensors = (r, k, v, w, u) + (() if s0 is None else (s0,))
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in tensors]}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPES:
        raise ValueError(f"r, k, v must share one type of {list(_DTYPES)}; got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("w", w), ("u", u)) + (() if s0 is None else (("s0", s0),)):
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} of type {t.dtype}, expected one of {list(_DTYPES)}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not supported (1..{MAX_CHUNK})")
    if N > MAX_WIDTH or N % 4:
        raise ValueError(f"head_dim {N} must be a multiple of 4, at most {MAX_WIDTH}")


def _launch(r, k, v, w, u, chunk, s0) -> tuple[torch.Tensor, torch.Tensor]:
    lib = _build.load("rwkv6_scan")
    fn = lib.rwkv6_scan_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [ci] * 6 + [ctypes.POINTER(ctypes.c_longlong), vp]
        fn.restype = ci
        lib.rwkv6_scan_error_string.argtypes = [ci]
        lib.rwkv6_scan_error_string.restype = ctypes.c_char_p

    w = w.float()                         # exact for bfloat16; no copy for float32
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"rwkv6_scan needs {name} with innermost stride 1; got strides {t.stride()}")
    u = u.float().contiguous()
    if s0 is not None:
        s0 = s0.float().contiguous()
    B, S, H, N = r.shape
    y = torch.empty((B, S, H, N), dtype=r.dtype, device=r.device)
    s = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    strides = [st for t in (r, k, v, w) for st in t.stride()[:3]]
    with torch.cuda.device(r.device):
        err = fn(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            0 if s0 is None else s0.data_ptr(), y.data_ptr(), s.data_ptr(),
            B, S, H, N, min(chunk, S), _DTYPES[r.dtype],
            (ctypes.c_longlong * 12)(*strides),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = lib.rwkv6_scan_error_string(err).decode()
        raise RuntimeError(f"rwkv6_scan kernel launch failed: {msg} (cudaError {err})")
    rwkv6_scan.launches += 1
    return y, s


def rwkv6_scan(
    r: torch.Tensor,            # (B, S, H, N)
    k: torch.Tensor,            # (B, S, H, N)
    v: torch.Tensor,            # (B, S, H, N)
    w: torch.Tensor,            # (B, S, H, N) decay in (0, 1)
    u: torch.Tensor,            # (H, N) bonus
    *,
    chunk: int = 128,
    s0: torch.Tensor | None = None,   # (B, H, N, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y (B,S,H,N) in r's type, final state (B,H,N,N) float32)``."""
    _check(r, k, v, w, u, chunk, s0)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, chunk=chunk, s0=s0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cuda or cpu tensors, not {r.device}")
    inputs = (r, k, v, w, u, s0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return PlainGradient.apply(
            "rwkv6_scan", lambda *t: _launch(*t[:5], chunk, t[5]),
            lambda *t: rwkv6_scan_plain(*t[:5], chunk=chunk, s0=t[5]), *inputs)
    return _launch(r, k, v, w, u, chunk, s0)


rwkv6_scan.launches = 0
