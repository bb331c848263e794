"""CCU in-line reduce — port of ``repro/kernels/ccu_reduce.py`` (``_ccu_kernel``
/ ``ccu_reduce``, a Pallas kernel for the TPU): the paper's §7 Collective
Communication Unit, which reduces its peers' buffers in a fixed order with
one optional dequantisation on the way in (compressed-gradient ingestion).

``ccu_reduce`` is the wrapper: on CUDA tensors it launches the CUDA C++
kernel of ``csrc/ccu_reduce.cu`` (built at first use, see ``_build.py``) or
raises; on CPU tensors, and only there, it computes the same function with
``ccu_reduce_plain``.  There is no fallback from the kernel to the plain
version.  ``ccu_reduce.launches`` counts kernel launches.

The function is the reference's: ``bufs (P, N)`` of fp32, bf16, fp16 or int8
and optional per-peer ``scales (P,)`` give ``(N,)`` fp32, the peers summed in
the order p = 0 .. P-1, each product ``bufs[p] * scales[p]`` and each sum
rounded once to fp32.  The kernel keeps those roundings (no fused
multiply-add), so it is bit-equal to the plain version.  Unlike the
reference, which asserts whole blocks of ``block_n`` elements, any N is
taken, and ``bufs`` may be a view with a row stride.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}


def ccu_reduce_plain(bufs: torch.Tensor, scales: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function: a loop over the peers
    in order, one rounded product and one rounded sum a peer."""
    acc = torch.zeros(bufs.shape[1], dtype=torch.float32, device=bufs.device)
    for p in range(bufs.shape[0]):
        x = bufs[p].float()
        if scales is not None:
            x = x * scales[p].float()
        acc = acc + x
    return acc


def _check(bufs: torch.Tensor, scales: torch.Tensor | None) -> None:
    if bufs.ndim != 2 or min(bufs.shape) < 1:
        raise ValueError(f"expected bufs (P, N) with P, N >= 1; got {tuple(bufs.shape)}")
    if bufs.dtype not in _DTYPES:
        raise ValueError(f"dtype {bufs.dtype} not supported (float32, bfloat16, float16, int8)")
    if scales is not None:
        if scales.shape != (bufs.shape[0],):
            raise ValueError(f"expected scales ({bufs.shape[0]},); got {tuple(scales.shape)}")
        if scales.device != bufs.device:
            raise ValueError(f"bufs and scales on different devices: {bufs.device}, {scales.device}")


def _launch(bufs: torch.Tensor, scales: torch.Tensor | None) -> torch.Tensor:
    lib = _build.load("ccu_reduce")
    fn = lib.ccu_reduce_fwd
    if fn.argtypes is None:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, ci, cll, cll, ci, ci, vp]
        fn.restype = ci
        lib.ccu_reduce_error_string.argtypes = [ci]
        lib.ccu_reduce_error_string.restype = ctypes.c_char_p

    if bufs.stride(1) != 1 and bufs.shape[1] > 1:
        raise ValueError(f"ccu_reduce needs rows with innermost stride 1; got strides {bufs.stride()}")
    P, N = bufs.shape
    if scales is not None:
        scales = scales.to(torch.float32).contiguous()
    out = torch.empty(N, dtype=torch.float32, device=bufs.device)
    stride = bufs.stride(0) if P > 1 else N
    # rows are read 16 bytes at a time where every row starts 16-byte aligned
    vec_ok = bufs.data_ptr() % 16 == 0 and (stride * bufs.element_size()) % 16 == 0
    with torch.cuda.device(bufs.device):
        err = fn(
            bufs.data_ptr(), scales.data_ptr() if scales is not None else None, out.data_ptr(),
            P, N, stride, _DTYPES[bufs.dtype], int(vec_ok),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = lib.ccu_reduce_error_string(err).decode()
        raise RuntimeError(f"ccu_reduce kernel launch failed: {msg} (cudaError {err})")
    ccu_reduce.launches += 1
    return out


def ccu_reduce(bufs: torch.Tensor, scales: torch.Tensor | None = None) -> torch.Tensor:
    """Fixed-order peer reduction: bufs (P, N), scales (P,) or None -> (N,) fp32."""
    _check(bufs, scales)
    if bufs.device.type == "cpu":
        return ccu_reduce_plain(bufs, scales)
    if bufs.device.type != "cuda":
        raise ValueError(f"ccu_reduce runs on cuda or cpu tensors, not {bufs.device}")
    return _launch(bufs, scales)


ccu_reduce.launches = 0
