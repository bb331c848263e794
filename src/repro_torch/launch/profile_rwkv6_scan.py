"""Where the rwkv6_scan kernel spends its time at rwkv6-1.6b's prefill shape
(r, k, v (4, 512, 32, 64) bf16 views of the (B, S, D) projections, w fp32,
chunk 128), through its C entry point with no wrapper around it::

    PYTHONPATH=src python -m repro_torch.launch.profile_rwkv6_scan
    PYTHONPATH=src python -m repro_torch.launch.profile_rwkv6_scan --phase-clocks
    PYTHONPATH=src python -m repro_torch.launch.profile_rwkv6_scan \\
        --source _archive/parent/src/repro_torch/kernels/csrc/rwkv6_scan.cu

Each source (the package's ``csrc/rwkv6_scan.cu`` and any ``--source``, such
as an unpacked parent commit's, whose C entry point takes the same
arguments) is built by nvcc for sm_90a into ``build/repro_torch/profile/``,
checked once against ``rwkv6_scan_plain`` (y's largest error over its
one-ulp limit, 2^-7 |y| + 5e-5, and the state's largest error), then timed in
turns, ``--rounds`` times: CUDA events over ``--launches`` launches queued
behind a few large matrix products, as ``chip_smoke.py`` times kernels.
``--phase-clocks`` also builds the package's source with
``-DRWKV6_PHASE_CLOCKS`` and reports the mean clocks between the kernel's
phase edges (``PHASE`` in the source), by chunk and, for the second chunk,
by warp.  Prints one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels.rwkv6_scan import rwkv6_scan_plain

B, S, H, N, Q = 4, 512, 32, 64, 128
EDGES = ["wait+barrier", "staging+decays", "decays barrier", "edge decays", "edge barrier", "diagonal",
         "products", "att v+y", "w", "state products", "state barrier", "state update"]


def build(src: Path, defines: list[str]) -> tuple[ctypes.CDLL, dict[str, dict[str, int]]]:
    """The library of ``src`` built with ``defines``, and its kernels'
    registers and spills as ptxas reports them."""
    flags = [*_build.NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = _build.build_dir() / "profile" / f"rwkv6_scan-{digest}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.find_nvcc(), *flags, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    ptxas = {}
    for entry in (proc.stdout + proc.stderr).split("Compiling entry function '")[1:]:
        ptxas[entry.split("'")[0]] = {
            key: int(m.group(1)) if (m := re.search(pattern, entry)) else None
            for key, pattern in (("registers", r"Used (\d+) registers"),
                                 ("spill_store_bytes", r"(\d+) bytes spill stores"))}
    handle = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    handle.rwkv6_scan_fwd.argtypes = [vp] * 8 + [ci] * 6 + [ctypes.POINTER(ctypes.c_longlong), vp]
    handle.rwkv6_scan_fwd.restype = ci
    return handle, ptxas


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], type=Path,
                    help="another rwkv6_scan.cu to time in turns with the package's")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--launches", type=int, default=50)
    ap.add_argument("--phase-clocks", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_rwkv6_scan measures the GPU: no CUDA device")

    gen = torch.Generator(device="cuda").manual_seed(0)
    r, k, v = ((torch.randn((B, S, H * N), generator=gen, device="cuda") * 0.5).bfloat16().view(B, S, H, N)
               for _ in range(3))
    w = torch.sigmoid(torch.randn((B, S, H, N), generator=gen, device="cuda")) * 0.98 + 0.01
    u = (torch.randn((H, N), generator=gen, device="cuda") * 0.3).bfloat16()
    u32 = u.float()
    y = torch.empty((B, S, H, N), dtype=torch.bfloat16, device="cuda")
    s = torch.empty((B, H, N, N), device="cuda")
    strides = (ctypes.c_longlong * 12)(*[st for t in (r, k, v, w) for st in t.stride()[:3]])
    yp, sp = rwkv6_scan_plain(r, k, v, w, u, chunk=Q)

    def call(lib: ctypes.CDLL) -> None:
        err = lib.rwkv6_scan_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u32.data_ptr(), None,
                                 y.data_ptr(), s.data_ptr(), B, S, H, N, Q, 1, strides,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"rwkv6_scan_fwd returned cudaError {err}")

    package = _build.CSRC / "rwkv6_scan.cu"
    sources = {"package": package, **{str(p): p for p in args.source}}
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True, check=True).stdout.strip(),
           "shape": f"r/k/v{(B, S, H, N)} bf16 w fp32 chunk {Q}", "sources": {}}
    libs = {}
    for label, src in sources.items():
        libs[label], ptxas = build(src, [])
        call(libs[label])
        torch.cuda.synchronize()
        limit = 2.0 ** -7 * yp.float().abs() + 5e-5
        out["sources"][label] = {
            "source": str(src), "ptxas": ptxas, "ms": [],
            "err_of_limit": ((y.float() - yp.float()).abs() / limit).max().item(),
            "state_max_abs_err": (s - sp).abs().max().item()}

    blocker = torch.randn(4096, 4096, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(args.rounds):
        for label, lib in libs.items():
            for _ in range(3):
                call(lib)
            torch.cuda.synchronize()
            for _ in range(4):
                blocker @ blocker
            start.record()
            for _ in range(args.launches):
                call(lib)
            end.record()
            torch.cuda.synchronize()
            out["sources"][label]["ms"].append(start.elapsed_time(end) / args.launches)

    if args.phase_clocks:
        lib, _ = build(package, ["RWKV6_PHASE_CLOCKS"])
        lib.rwkv6_scan_phase_clocks.argtypes = [ctypes.c_void_p]
        call(lib)
        torch.cuda.synchronize()
        clocks = torch.zeros(128 * 8 * 4 * 13, dtype=torch.int64)
        if lib.rwkv6_scan_phase_clocks(ctypes.c_void_p(clocks.data_ptr())):
            raise SystemExit("rwkv6_scan_phase_clocks failed")
        c = clocks.view(128, 8, 4, 13).double()
        d = c.diff(dim=-1)                                   # (block, warp, chunk, 12)
        out["phase_clocks"] = {
            "sm_clock": subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                                       capture_output=True, text=True).stdout.strip(),
            "block_clocks_mean": (c[:, 0, 3, 12] - c[:, 0, 0, 0]).mean().item(),
            "by_chunk": [{e: round(d[:, :, ch, i].mean().item()) for i, e in enumerate(EDGES)} for ch in range(4)],
            "chunk1_by_warp": [{e: round(d[:, wp, 1, i].mean().item()) for i, e in enumerate(EDGES)}
                               for wp in range(8)]}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
