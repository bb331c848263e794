"""Kernels of the port, written by hand for Hopper (reference:
``repro/kernels/``, Pallas for the TPU): ``flash_attention`` carries every
layer's attention, ``moe_dispatch`` every MoE layer's dispatch, ``ssd_scan``
every Mamba2 layer's chunked scan in prefill, ``rwkv6_scan`` every RWKV-6
layer's chunked scan in prefill, ``ccu_reduce`` every gradient leaf's int8
payload in training (``optim/compression.py``).

Each kernel module holds the CUDA kernel's wrapper, a plain PyTorch version of
the same function, and a launch count on the wrapper.  ``launch_counts`` and
``reset_launch_counts`` read and clear the counts of every kernel, so a run
can show which kernels its path went through; flash attention's backward
kernels count under their own key, ``flash_attention.bwd``
(``flash_attention.bwd_launches``: backward calls served by the kernels).
"""

from __future__ import annotations

from .ccu_reduce import ccu_reduce
from .flash_attention import flash_attention
from .moe_dispatch import moe_dispatch
from .rwkv6_scan import rwkv6_scan
from .ssd_scan import ssd_scan

KERNELS = {"flash_attention": flash_attention, "moe_dispatch": moe_dispatch, "ssd_scan": ssd_scan,
           "rwkv6_scan": rwkv6_scan, "ccu_reduce": ccu_reduce}


def launch_counts() -> dict[str, int]:
    return {**{name: fn.launches for name, fn in KERNELS.items()},
            "flash_attention.bwd": flash_attention.bwd_launches}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    flash_attention.bwd_launches = 0
