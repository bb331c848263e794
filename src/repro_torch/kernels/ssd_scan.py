"""Mamba2 chunked SSD scan — port of ``repro/kernels/ssd_scan.py``
(``_ssd_kernel`` / ``ssd_scan``, a Pallas kernel for the TPU).

``ssd_scan`` is the wrapper: on CUDA tensors it launches the CUDA C++ kernel
of ``csrc/ssd_scan.cu`` (built at first use, see ``_build.py``) or raises:
for bf16 inputs, what the model serves, the tensor-core design (``tc::``,
state size N up to 128), for fp32 the first design's FMA kernel (``fma::``,
N up to 64).  On CPU tensors, and
only there, it computes the same function with
``ssd_scan_plain``.  There is no fallback from the kernel to the plain
version.  ``ssd_scan.launches`` counts kernel launches.  Under autograd (a
CUDA input that requires grad, grad mode on) the launch goes through
``_autograd.PlainGradient``: the kernel's output, and in the backward the
gradient of the plain version recomputed at the saved inputs, for y, the
final state or both; no backward kernel yet.  The backward recomputes
``ssd_scan_chunked``, the plain version with its chunks batched (the same
function to fp32 rounding, with far fewer launches).

The function is the reference's: ``xh (B,S,H,P)``, ``log_l (B,S,H) <= 0``,
``Bm, Cm (B,S,N)`` give ``y (B,S,H,P)`` in xh's type and the final state
``h (B,H,P,N)`` in float32, chunk by chunk of ``Q = min(chunk, S)`` rows, in
float32 inside.  Two additions, both with a precedent in the reference's
model code (``ssd_chunked``, ``ssd_scan_ref``): an initial state ``h0``, and
any S, the last chunk partial.  A partial chunk is the same as one padded
with ``x = 0``, ``B = 0`` and ``log_l = 0`` rows, which add nothing to the
state and do not decay it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._autograd import PlainGradient

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128          # rows of a chunk the kernel holds in shared memory
MAX_HEAD_DIM = 64        # head_dim P
# state size N: the tensor-core design (bf16) holds up to 128 columns of C, B
# and the state, the FMA design (fp32) up to 64
MAX_STATE = {torch.float32: 64, torch.bfloat16: 128}


def ssd_scan_plain(
    xh: torch.Tensor,           # (B, S, H, P)
    log_l: torch.Tensor,        # (B, S, H)
    Bm: torch.Tensor,           # (B, S, N)
    Cm: torch.Tensor,           # (B, S, N)
    *,
    chunk: int = 128,
    h0: torch.Tensor | None = None,   # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's function, with the Pallas
    kernel's arithmetic: inputs widened to fp32, per chunk the cumulative log
    decay, the decay masked before its exponential, ``y_intra + y_inter``,
    then the state update.  A partial last chunk is a shorter one."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    x, ll, bm, cm = xh.float(), log_l.float(), Bm.float(), Cm.float()
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device) if h0 is None
         else h0.float())
    ys = []
    for s0 in range(0, S, Q):
        xq, lq, bq, cq = x[:, s0:s0 + Q], ll[:, s0:s0 + Q], bm[:, s0:s0 + Q], cm[:, s0:s0 + Q]
        q = xq.shape[1]
        cum = torch.cumsum(lq, dim=1)                                  # (B,q,H)
        scores = torch.einsum("bin,bjn->bij", cq, bq)                  # (B,q,q)
        decay = cum[:, :, None, :] - cum[:, None, :, :]                # (B,q,q,H)
        causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
        att = scores[..., None] * torch.exp(
            torch.where(causal[None, :, :, None], decay, -torch.inf))
        y_intra = torch.einsum("bijh,bjhp->bihp", att, xq)
        y_inter = torch.einsum("bin,bhpn->bihp", cq, h) * torch.exp(cum)[..., None]
        ys.append(y_intra + y_inter)
        tail = torch.exp(cum[:, -1:, :] - cum)                          # (B,q,H)
        dh = torch.einsum("bjhp,bjn,bjh->bhpn", xq, bq, tail)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + dh
    return torch.cat(ys, dim=1).to(xh.dtype), h


def ssd_scan_chunked(
    xh: torch.Tensor,           # (B, S, H, P)
    log_l: torch.Tensor,        # (B, S, H)
    Bm: torch.Tensor,           # (B, S, N)
    Cm: torch.Tensor,           # (B, S, N)
    *,
    chunk: int = 128,
    h0: torch.Tensor | None = None,   # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """``ssd_scan_plain``'s function with its whole chunks side by side,
    what the kernel's backward differentiates (``ssd_scan``): each chunk's
    scores, decays, intra-chunk output and state increment in one batched
    pass, the state carried from chunk to chunk in a loop of two elementwise
    operations a chunk, then each chunk's output from the state it starts
    at in one batched pass; a ragged last chunk after them, alike.  Each
    element is computed by the same operations as in ``ssd_scan_plain``,
    the products batched over the chunks, so the two agree to fp32 rounding;
    its launches grow with the chunks only by the state loop's, where the
    plain version's Python loop launches some 25 kernels a chunk (at
    granite-4.0-h's training shape that loop made the step wait on the
    host)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    x, ll, bm, cm = xh.float(), log_l.float(), Bm.float(), Cm.float()
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device) if h0 is None
         else h0.float())
    whole = S // Q * Q
    ys = []
    for lo, hi, q in ((0, whole, Q), (whole, S, S - whole)):
        if hi == lo:
            continue
        c = (hi - lo) // q
        xq = x[:, lo:hi].reshape(B * c, q, H, P)
        lq = ll[:, lo:hi].reshape(B * c, q, H)
        bq, cq = bm[:, lo:hi].reshape(B * c, q, N), cm[:, lo:hi].reshape(B * c, q, N)
        cum = torch.cumsum(lq, dim=1)                                  # (B c, q, H)
        scores = torch.einsum("bin,bjn->bij", cq, bq)
        decay = cum[:, :, None, :] - cum[:, None, :, :]
        causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
        att = scores[..., None] * torch.exp(torch.where(causal[None, :, :, None], decay, -torch.inf))
        y_intra = torch.einsum("bijh,bjhp->bihp", att, xq)
        tail = torch.exp(cum[:, -1:, :] - cum)
        dh = torch.einsum("bjhp,bjn,bjh->bhpn", xq, bq, tail).reshape(B, c, H, P, N)
        last = torch.exp(cum[:, -1, :]).reshape(B, c, H)
        starts = []
        for k in range(c):
            starts.append(h)
            h = h * last[:, k, :, None, None] + dh[:, k]
        h_in = torch.stack(starts, dim=1).reshape(B * c, H, P, N)
        y_inter = torch.einsum("bin,bhpn->bihp", cq, h_in) * torch.exp(cum)[..., None]
        ys.append((y_intra + y_inter).reshape(B, c * q, H, P))
    return torch.cat(ys, dim=1).to(xh.dtype), h


def _check(xh, log_l, Bm, Cm, chunk, h0) -> None:
    if xh.ndim != 4 or log_l.ndim != 3 or Bm.ndim != 3 or Cm.shape != Bm.shape:
        raise ValueError(
            f"expected xh (B,S,H,P), log_l (B,S,H), Bm/Cm (B,S,N); got {tuple(xh.shape)}, "
            f"{tuple(log_l.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    if tuple(log_l.shape) != (B, S, H) or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"xh {tuple(xh.shape)}, log_l {tuple(log_l.shape)} and Bm "
                         f"{tuple(Bm.shape)} do not agree")
    if min(B, S, H, P, N) < 1:
        raise ValueError(f"empty dimension: xh {tuple(xh.shape)}, Bm {tuple(Bm.shape)}")
    if h0 is not None and tuple(h0.shape) != (B, H, P, N):
        raise ValueError(f"h0 of shape {tuple(h0.shape)}, expected {(B, H, P, N)}")
    tensors = (xh, log_l, Bm, Cm) + (() if h0 is None else (h0,))
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in tensors]}")
    if not (xh.dtype == Bm.dtype == Cm.dtype) or xh.dtype not in _DTYPES:
        raise ValueError(f"xh, Bm, Cm must share one type of {list(_DTYPES)}; got "
                         f"{xh.dtype}, {Bm.dtype}, {Cm.dtype}")
    if log_l.dtype not in _DTYPES:
        raise ValueError(f"log_l of type {log_l.dtype}, expected one of {list(_DTYPES)}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not supported (1..{MAX_CHUNK})")
    if P > MAX_HEAD_DIM or N > MAX_STATE[xh.dtype] or P % 4 or N % 4:
        raise ValueError(f"head_dim {P} and state size {N} must be multiples of 4, at most "
                         f"{MAX_HEAD_DIM} and {MAX_STATE[xh.dtype]} in {xh.dtype}")


def _launch(xh, log_l, Bm, Cm, chunk, h0) -> tuple[torch.Tensor, torch.Tensor]:
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [ci] * 7 + [ctypes.POINTER(ctypes.c_longlong)] + [ci] * 2 + [vp]
        fn.restype = ci
        lib.ssd_scan_error_string.argtypes = [ci]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p

    for name, t in (("xh", xh), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan needs {name} with innermost stride 1; got strides {t.stride()}")
    log_l = log_l.float()                 # exact for bfloat16; no copy for float32
    if h0 is not None:
        h0 = h0.float().contiguous()
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    y = torch.empty((B, S, H, P), dtype=xh.dtype, device=xh.device)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    strides = [*xh.stride()[:3], *log_l.stride(), *Bm.stride()[:2], *Cm.stride()[:2]]
    # rows of x, B and C are staged 16 bytes at a time where aligned
    per16 = 16 // xh.element_size()

    def vec(*ts):
        return all(t.data_ptr() % 16 == 0 and all(s % per16 == 0 for s in t.stride()[:-1]) for t in ts)

    with torch.cuda.device(xh.device):
        err = fn(
            xh.data_ptr(), log_l.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            0 if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
            B, S, H, P, N, min(chunk, S), _DTYPES[xh.dtype],
            (ctypes.c_longlong * 10)(*strides), int(vec(xh)), int(vec(Bm, Cm)),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan kernel launch failed: {msg} (cudaError {err})")
    ssd_scan.launches += 1
    return y, h


def ssd_scan(
    xh: torch.Tensor,           # (B, S, H, P)
    log_l: torch.Tensor,        # (B, S, H)
    Bm: torch.Tensor,           # (B, S, N)
    Cm: torch.Tensor,           # (B, S, N)
    *,
    chunk: int = 128,
    h0: torch.Tensor | None = None,   # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y (B,S,H,P) in xh's type, final state (B,H,P,N) float32)``."""
    _check(xh, log_l, Bm, Cm, chunk, h0)
    if xh.device.type == "cpu":
        return ssd_scan_plain(xh, log_l, Bm, Cm, chunk=chunk, h0=h0)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu tensors, not {xh.device}")
    inputs = (xh, log_l, Bm, Cm, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return PlainGradient.apply(
            "ssd_scan", lambda *t: _launch(*t[:4], chunk, t[4]),
            lambda *t: ssd_scan_chunked(*t[:4], chunk=chunk, h0=t[4]), *inputs)
    return _launch(xh, log_l, Bm, Cm, chunk, h0)


ssd_scan.launches = 0
