"""MoE capacity-bucketed dispatch — port of ``repro/kernels/moe_dispatch.py``
(``_dispatch_kernel`` / ``moe_dispatch``, a Pallas kernel for the TPU, and
``moe_gather_matmul``).

``moe_dispatch`` is the wrapper: on CUDA tensors it launches the CUDA C++
kernel of ``csrc/moe_dispatch.cu`` (built at first use, see ``_build.py``) or
raises; on CPU tensors, and only there, it computes the same function with
``moe_dispatch_plain``.  There is no fallback from the kernel to the plain
version.  ``moe_dispatch.launches`` counts kernel launches, one a call (a
decode step, T = 1, launches a kernel of its own, see the CUDA source).
Under autograd (a CUDA input that requires grad, grad mode on) the launch
goes through ``_autograd.PlainGradient``: the kernel's output, and in the
backward the gradient of ``moe_dispatch_plain`` recomputed at the saved
inputs, for x and, only where it requires one, disp (the routing's one-hot
weights do not); no backward kernel yet.

The function is the reference's, ``out[e, c, :] = sum_t disp[t, e, c] *
x[t, :]`` accumulated in fp32, output in x's type, for ``disp (T, E, C)`` and
``x (T, D)``.  The port adds a leading batch dimension: ``disp (B, T, E, C)``
and ``x (B, T, D)`` give ``(E, B, C, D)``, the layout of the model's einsum
``"bsec,bsd->ebcd"``, so one launch serves a whole MoE layer.  Unlike the
reference, which asserts whole token blocks, any T is taken (a decode step
has T = 1).  The kernel skips zero weights: see the note at the top of the
CUDA source for what that keeps and the one thing it changes (a NaN or inf
in x under a zero weight).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._autograd import PlainGradient

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def moe_dispatch_plain(disp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function: one einsum in fp32,
    cast to x's type."""
    eq = "btec,btd->ebcd" if disp.ndim == 4 else "tec,td->ecd"
    return torch.einsum(eq, disp.float(), x.float()).to(x.dtype)


def _check(disp: torch.Tensor, x: torch.Tensor) -> None:
    if not ((disp.ndim, x.ndim) in ((3, 2), (4, 3)) and disp.shape[:-2] == x.shape[:-1]):
        raise ValueError(
            f"expected disp (T,E,C) and x (T,D), or disp (B,T,E,C) and x (B,T,D); got "
            f"{tuple(disp.shape)}, {tuple(x.shape)}"
        )
    if min(*disp.shape, x.shape[-1]) < 1:
        raise ValueError(f"empty dimension: disp {tuple(disp.shape)}, x {tuple(x.shape)}")
    if disp.device != x.device:
        raise ValueError(f"disp and x on different devices: {disp.device}, {x.device}")
    if disp.dtype != x.dtype:
        raise ValueError(f"disp and x of different types: {disp.dtype}, {x.dtype}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"dtype {x.dtype} not supported (float32, bfloat16)")


def _launch(disp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    lib = _build.load("moe_dispatch")
    fn = lib.moe_dispatch_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 3 + [ci] * 6 + [ctypes.POINTER(ctypes.c_longlong), ci, ci, vp]
        fn.restype = ci
        lib.moe_dispatch_error_string.argtypes = [ci]
        lib.moe_dispatch_error_string.restype = ctypes.c_char_p

    if x.stride(-1) != 1:
        raise ValueError(f"moe_dispatch needs x with innermost stride 1; got strides {x.stride()}")
    B, T, E, C = disp.shape
    D = x.shape[-1]
    out = torch.empty((E, B, C, D), dtype=x.dtype, device=x.device)
    strides = [*disp.stride(), *x.stride()[:2], *out.stride()[:3]]
    # rows of x and out are read and written 16 bytes at a time where aligned
    per16 = 16 // x.element_size()
    vec_ok = all(t.data_ptr() % 16 == 0 for t in (x, out)) and all(
        s % per16 == 0 for s in (*x.stride()[:2], *out.stride()[:3]))
    # each token's weights for a tile of 8 slots are read as one 16-byte run
    # (fp32: two) where the slot axis is innermost and aligned
    disp_vec = disp.stride(3) == 1 and disp.data_ptr() % 16 == 0 and all(
        s % per16 == 0 for s in disp.stride()[:3])
    with torch.cuda.device(x.device):
        err = fn(
            disp.data_ptr(), x.data_ptr(), out.data_ptr(),
            B, T, E, C, D, _DTYPES[x.dtype],
            (ctypes.c_longlong * 9)(*strides), int(vec_ok), int(disp_vec),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = lib.moe_dispatch_error_string(err).decode()
        raise RuntimeError(f"moe_dispatch kernel launch failed: {msg} (cudaError {err})")
    moe_dispatch.launches += 1
    return out


def moe_dispatch(disp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Expert inputs: disp (T,E,C), x (T,D) -> (E,C,D); disp (B,T,E,C),
    x (B,T,D) -> (E,B,C,D).  In x's type."""
    _check(disp, x)
    if x.device.type == "cpu":
        return moe_dispatch_plain(disp, x)
    if x.device.type != "cuda":
        raise ValueError(f"moe_dispatch runs on cuda or cpu tensors, not {x.device}")
    if disp.ndim == 3:
        return moe_dispatch(disp[None], x[None])[:, 0]
    if torch.is_grad_enabled() and (disp.requires_grad or x.requires_grad):
        return PlainGradient.apply("moe_dispatch", _launch, moe_dispatch_plain, disp, x)
    return _launch(disp, x)


moe_dispatch.launches = 0


def moe_gather_matmul(
    disp: torch.Tensor,         # (T, E, C)
    x: torch.Tensor,            # (T, D)
    w: torch.Tensor,            # (E, D, F)
) -> torch.Tensor:
    """Dispatch (the kernel), then each expert's product with its weight as
    one batched ``torch.matmul`` in fp32, as the reference computes it outside
    its kernel: (E, C, F) in x's type."""
    ein = moe_dispatch(disp, x)                                    # (E, C, D)
    return torch.matmul(ein.float(), w.float()).to(x.dtype)
