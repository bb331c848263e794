#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives the port's main path — granite-8b served at full width and depth
through ``repro_torch.launch.serve.run`` — and holds every hand-written kernel
of that path against its plain PyTorch version on the card.  Phases, one JSON
line each:

1. ``device``   torch version, device name, ``nvidia-smi`` name and power limit
2. ``build``    compiles the kernels from ``src/repro_torch/kernels/csrc`` with nvcc
3. ``kernels``  each kernel vs its plain version over the test shapes and at the
                main path's shapes, with times (CUDA events), the least time
                the card could take (``bound_ms``) and one library call as a
                yardstick (``library_ms``; the port never calls it)
4. ``slice``    granite-8b smoke config: kernel path vs plain path, fp32 and bf16
5. ``serve``    granite-8b, 36 layers, bf16, batch 4, prompt 512, 16 tokens, greedy,
                then the same batch through the plain path, logits and ids compared

Any failure ends the run with a non-zero exit code; without a GPU it exits
before printing any result.  ``--phases`` runs a subset while debugging.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import torch  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_ULP = 2.0 ** -7     # one bf16 ulp of x is at most 2^-7 |x|

# The main path: granite-8b at full width and depth.
SERVE = dict(arch="granite-8b", batch=4, prompt_len=512, gen=16, seed=0)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """Time of one call of ``fn``: (on the device, as called from the host).

    For the device time the calls are queued behind a few large matrix
    products that keep the card busy while the host enqueues, so the CUDA
    events around them see the kernels back to back and none of the host's
    time between launches.  The second number is the host's clock over the
    same calls, launched on an idle card and ended by a synchronise: it is
    what a caller that launches them one after the other pays."""
    for _ in range(warmup):
        fn()
    blocker = torch.randn(4096, 4096, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    for _ in range(4):
        blocker @ blocker
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return device_ms, (time.perf_counter() - t0) * 1e3 / iters


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    info = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
    }
    emit("device", **info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build(["flash_attention"])
    seconds = time.perf_counter() - t0
    # ptxas -v: registers and spills of every instantiation
    log = "".join(p.with_suffix(".log").read_text() for p in libs.values())
    registers = [int(w.split()[0]) for w in log.split("Used")[1:]]
    spills = [int(w.split()[-1]) for w in log.split(" bytes spill stores")[:-1]]
    emit("build", seconds=round(seconds, 2), nvcc=_build.find_nvcc(),
         libraries={n: str(p) for n, p in libs.items()},
         max_registers=max(registers, default=None), spill_store_bytes=sum(spills))


def _rand(gen, shape, dtype, scale):
    return (torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32) * scale).to(dtype)


def _qkv(gen, q_shape, kv_shape, dtype):
    """Inputs that make a wrong kernel show: scores of standard deviation 3,
    so each row's softmax rests on a few keys that depend on q, and values of
    standard deviation 1, so the outputs are of order 1 and not a mean of v
    that any weighting would reproduce."""
    return (_rand(gen, q_shape, dtype, 2.0), _rand(gen, kv_shape, dtype, 1.5),
            _rand(gen, kv_shape, dtype, 1.0))


def _excess(o, r, dtype, ulps: int = 1, of_row: bool = False) -> tuple[float, float]:
    """(max |o - r|, the largest ratio of |o - r| to its limit) of a kernel's
    output against the plain version's, element by element.  float32: 2e-5
    absolute on outputs of order 1 (sums in another order).  bfloat16: both
    round the same fp32 result once, so they differ by at most ``ulps`` bf16
    ulps of that element (2^-7 |r| each), plus 1e-5 for the order of the fp32
    sums beneath.  ``of_row`` takes the ulp of the largest element of the
    output row instead: for a version that rounds the probabilities, whose
    error in an element goes with the row's values and not with the element's."""
    o, r = o.float(), r.float()
    diff = (o - r).abs()
    size = r.abs().amax(dim=-1, keepdim=True) if of_row else r.abs()
    limit = torch.full_like(r, 2e-5) if dtype == torch.float32 else ulps * BF16_ULP * size + 1e-5
    return diff.max().item(), (diff / limit).max().item()


def _flash_cases():
    """(B, K, G, Sq, Sk, D, dtype, mask kwargs) over the reference's test
    shapes, the four mask combinations, ragged lengths, q_start, decode rows
    and every head_dim."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for B, K, G, S, D in [(1, 1, 1, 128, 64), (2, 2, 3, 256, 64), (1, 4, 2, 256, 128), (2, 1, 8, 128, 32)]:
        for dt in (f32, bf16):
            cases.append((B, K, G, S, S, D, dt, dict(causal=True)))
    for kw in [dict(causal=True, window=64), dict(causal=True, prefix_len=48),
               dict(causal=False), dict(causal=True, window=32, prefix_len=16)]:
        for dt in (f32, bf16):
            cases.append((2, 2, 2, 256, 256, 64, dt, kw))
    for D in (32, 64, 128):
        for dt in (f32, bf16):
            # ragged prefill, ragged continuation at q_start, sliding window at q_start
            cases.append((2, 2, 3, 100, 100, D, dt, dict(causal=True)))
            cases.append((1, 2, 4, 77, 203, D, dt, dict(causal=True, q_start=126)))
            cases.append((1, 1, 9, 45, 300, D, dt, dict(causal=True, window=70, q_start=255)))
            cases.append((2, 1, 2, 33, 65, D, dt, dict(causal=False)))
            # one decode token over a cache, with and without a window / prefix
            cases.append((3, 2, 4, 1, 200, D, dt, dict(causal=True, q_start=199)))
            cases.append((2, 1, 9, 1, 131, D, dt, dict(causal=True, window=64, q_start=130)))
            cases.append((2, 2, 1, 1, 97, D, dt, dict(causal=True, window=16, prefix_len=8, q_start=96)))
    return cases


def _flash_bound_ms(q, k, v, mask_kw) -> tuple[float, str]:
    """Least time for this call: bytes (q, k, v read once, o written once)
    over the memory rate, against the operations the visible (query, key)
    pairs need (two products, 2 flops a multiply-add) over the peak rate."""
    from repro_torch.kernels.flash_attention import visible

    B, Sq, N, D = q.shape
    Sk = k.shape[1]
    kw = dict(causal=True, window=None, prefix_len=0, q_start=0) | mask_kw
    pairs = int(visible(Sq, Sk, **kw).sum())
    flops = 4 * D * pairs * B * N
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels() -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.ref import attention_ref

    # fp32 comparisons need full-fp32 products in the plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_of_limit = dict(worst)
    cases = _flash_cases()
    for B, K, G, Sq, Sk, D, dt, kw in cases:
        q, k, v = _qkv(gen, (B, K, G, Sq, D), (B, K, Sk, D), dt)
        o = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        r = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err, of_limit = _excess(o, r, dt)
        # the oracle shares no method with either: float64, row by row
        ref_err, ref_of_limit = _excess(r, attention_ref(q.double(), k.double(), v.double(), **kw), dt)
        if not of_limit <= 1.0 or not ref_of_limit <= 1.0 or not torch.isfinite(o.float()).all():
            raise SystemExit(f"flash_attention disagrees with its plain version: "
                             f"{(B, K, G, Sq, Sk, D, dt, kw)} max_abs_err={err}, {of_limit} of its "
                             f"limit; plain vs the float64 oracle {ref_err}, {ref_of_limit} of its limit")
        worst[dt] = max(worst[dt], err)
        worst_of_limit[dt] = max(worst_of_limit[dt], of_limit)

    # the main path's own shapes, in the model's layout: q from the projections,
    # k/v a slice of one layer's KV cache (B, Smax, K, Dh), read in place
    B, N, K, D = SERVE["batch"], 32, 8, 128
    S, dt = SERVE["prompt_len"], torch.bfloat16
    s_max = S + SERVE["gen"] + 8
    q_prefill, ck, cv = _qkv(gen, (B, S, N, D), (B, s_max, K, D), dt)
    shapes = {
        "prefill": (q_prefill, S, dict(causal=True, q_start=0)),
        "decode": (_rand(gen, (B, 1, N, D), dt, 2.0), S + 8, dict(causal=True, q_start=S + 7)),
    }
    rows = {}
    for name, (q, sk, kw) in shapes.items():
        k, v = ck[:, :sk], cv[:, :sk]

        def plain(fn=flash_attention_plain, cast=lambda t: t):
            qk = cast(q).unflatten(2, (K, N // K)).permute(0, 2, 3, 1, 4)
            o = fn(qk, cast(k).permute(0, 2, 1, 3), cast(v).permute(0, 2, 1, 3), **kw)
            return o.permute(0, 3, 1, 2, 4).reshape(q.shape)

        def library():
            # a row at the cache's last position sees every key: no mask needed
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=(q.shape[1] > 1), enable_gqa=True,
            ).transpose(1, 2)

        o = ops.flash_attention_bsnd(q, k, v, **kw)
        torch.cuda.synchronize()
        r = plain()
        err, of_limit = _excess(o, r, dt)
        # the library call rounds its probabilities to bf16 before P.V: 4 ulps of the row
        lib_err, lib_of_limit = _excess(o, library(), dt, ulps=4, of_row=True)
        ref_err, ref_of_limit = _excess(o, plain(attention_ref, torch.Tensor.double), dt)
        if not max(of_limit, lib_of_limit, ref_of_limit) <= 1.0:
            raise SystemExit(f"flash_attention at the {name} shape: max_abs_err={err} vs plain "
                             f"({of_limit} of its limit), {lib_err} vs the library call "
                             f"({lib_of_limit}), {ref_err} vs the float64 oracle ({ref_of_limit})")
        bound_ms, bound_by = _flash_bound_ms(q, k, v, kw)
        ms, call_ms = time_ms(lambda: ops.flash_attention_bsnd(q, k, v, **kw))
        rows[name] = {
            "shape": f"q{tuple(q.shape)} kv{tuple(k.shape)} {str(dt).split('.')[-1]} {kw}",
            "max_abs_err": err,
            "err_of_limit": of_limit,
            "max_abs_plain": r.float().abs().max().item(),
            "ms": ms,
            "call_ms": call_ms,
            "plain_ms": time_ms(plain)[0],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": time_ms(library)[0],
        }
    return [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:125",
        "launches": None,            # filled in from the serve phase's run
        **rows["prefill"],
        "decode": rows["decode"],
        "test_cases": len(cases),
        "test_max_abs_err": {"float32": worst[torch.float32], "bfloat16": worst[torch.bfloat16]},
        "test_max_err_of_limit": {"float32": worst_of_limit[torch.float32],
                                  "bfloat16": worst_of_limit[torch.bfloat16]},
    }]


def phase_slice() -> None:
    """granite-8b smoke config on the card, same weights: the kernel path
    (use_kernels=True) against the plain path (sdpa + mask bias)."""
    from repro_torch.configs import load
    from repro_torch.launch import serve
    from repro_torch.models.layers import Runtime
    from repro_torch.models.param import tree_init

    torch.backends.cuda.matmul.allow_tf32 = False
    args = serve.build_parser().parse_args(["--prompt-len", "24", "--gen", "5", "--batch", "2"])
    out = {}
    # fp32: only the order of sums differs, 2e-4 absolute.  bf16: the kernel
    # keeps fp32 scores and probabilities where sdpa rounds both to bf16, so
    # each path lies a few bf16 ulps of the largest logit (ulp 0.031 at 4) from
    # the fp32 result: 3e-2 of the largest |logit|, at least 3e-2.
    for dt, tol in ((torch.float32, 2e-4), (torch.bfloat16, 3e-2)):
        h = load("granite-8b", smoke=True).clone(dtype=dt)
        gen = torch.Generator(device="cuda").manual_seed(1)
        params = tree_init(h.param_specs(), gen, dt, "cuda")
        res = {
            uk: serve.run(args, harness=h, params=params, rt=Runtime(use_kernels=uk))
            for uk in (True, False)
        }
        if res[True]["launches"]["flash_attention"] != h.cfg.n_layers * args.gen:
            raise SystemExit(f"slice check: kernel path launched {res[True]['launches']}")
        if res[False]["launches"]["flash_attention"] != 0:
            raise SystemExit("slice check: the plain path launched the kernel")
        same = bool((res[True]["tokens"] == res[False]["tokens"]).all())
        # logits are comparable while both paths were fed the same tokens
        n = args.gen if same else 1
        kern, plain = res[True]["logits"][:, :n], res[False]["logits"][:, :n]
        err, scale = float(abs(kern - plain).max()), float(abs(plain).max())
        bound = tol if dt == torch.float32 else tol * max(1.0, scale)
        if not err <= bound or (dt == torch.float32 and not same):
            raise SystemExit(f"slice check {dt}: max_abs_err={err} (bound {bound}), same ids={same}")
        out[str(dt).split(".")[-1]] = {
            "max_abs_err": err, "bound": bound, "max_abs_logit": scale,
            "same_ids": same, "steps_compared": n}
    emit("slice", config="granite-8b smoke", **out)


def phase_serve() -> dict:
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import load
    from repro_torch.launch import serve
    from repro_torch.models.layers import Runtime
    from repro_torch.models.param import tree_init

    args = serve.build_parser().parse_args([
        "--arch", SERVE["arch"], "--no-smoke", "--batch", str(SERVE["batch"]),
        "--prompt-len", str(SERVE["prompt_len"]), "--gen", str(SERVE["gen"]),
        "--seed", str(SERVE["seed"]),
    ])
    harness = load(args.arch, smoke=False)
    cfg = harness.cfg
    torch.cuda.reset_peak_memory_stats()
    # the weights are drawn once, so that the plain path below serves the same model
    params = tree_init(harness.param_specs(), torch.Generator(device="cuda").manual_seed(SERVE["seed"]),
                       torch.bfloat16, "cuda")
    kernels.reset_launch_counts()
    res = serve.run(args, harness=harness, params=params)
    counts = kernels.launch_counts()
    want = cfg.n_layers * (1 + args.gen - 1)
    if counts["flash_attention"] != want:
        raise SystemExit(f"serve: flash_attention launched {counts} times, expected {want}")
    tok, lg = res["tokens"], res["logits"]
    if tok.shape != (args.batch, args.gen) or tok.min() < 0 or tok.max() >= cfg.vocab_size:
        raise SystemExit(f"serve: bad token ids, shape {tok.shape}")
    if lg.shape != (args.batch, args.gen, cfg.vocab_size) or not np.isfinite(lg).all():
        raise SystemExit(f"serve: logits of shape {lg.shape} not finite")
    peak_memory_gb = torch.cuda.max_memory_allocated() / 1e9

    # The same batch through the plain path (sdpa + mask bias) at full width
    # and depth: a kernel that is wrong only at these sizes shows here as a
    # wrong token.  Both paths are bf16, and sdpa rounds scores and
    # probabilities where the kernel keeps fp32, so logits are held to 3e-2 of
    # the largest |logit| (about 4 bf16 ulps of it), over the steps both paths
    # were fed the same tokens: up to and including the first step at which
    # their ids differ.  At every such step the token the kernel path chose
    # must be, by the plain path's logits, within that limit of the best.
    ref = serve.run(args, harness=harness, params=params, rt=Runtime(use_kernels=False))
    if kernels.launch_counts() != counts:
        raise SystemExit("serve: the plain path launched a kernel")
    differ = np.flatnonzero((tok != ref["tokens"]).any(axis=0))
    n = int(differ[0]) + 1 if differ.size else args.gen
    kern_lg, ref_lg = lg[:, :n], ref["logits"][:, :n]
    scale = float(np.abs(ref_lg).max())
    err, limit = float(np.abs(kern_lg - ref_lg).max()), 3e-2 * max(1.0, scale)
    chosen = np.take_along_axis(ref_lg, tok[:, :n, None].astype(np.int64), axis=2)[..., 0]
    regret = float((ref_lg.max(axis=2) - chosen).max())
    if not err <= limit or not regret <= limit:
        raise SystemExit(f"serve: kernel path vs plain path over {n} steps: logits differ by {err}, "
                         f"chosen tokens fall {regret} short of the best (limit {limit})")
    emit("serve", arch=args.arch, n_layers=cfg.n_layers, d_model=cfg.d_model,
         params=cfg.param_count, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
         prefill_ms=res["prefill_s"] * 1e3, decode_ms_per_token=res["decode_s_per_token"] * 1e3,
         peak_memory_gb=peak_memory_gb, launches=counts, first_row=tok[0].tolist(),
         vs_plain_path={"steps_compared": n, "same_ids": bool(differ.size == 0),
                        "max_abs_err": err, "limit": limit, "max_abs_logit": scale,
                        "chosen_short_of_best": regret,
                        "plain_prefill_ms": ref["prefill_s"] * 1e3,
                        "plain_decode_ms_per_token": ref["decode_s_per_token"] * 1e3})
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="device,build,kernels,slice,serve",
                    help="comma-separated subset, for debugging")
    phases = ap.parse_args().phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here if the package is not beside this script)

    device = phase_device()
    if "build" in phases:
        phase_build()
    kernel_rows = phase_kernels() if "kernels" in phases else []
    if "slice" in phases:
        phase_slice()
    counts = phase_serve() if "serve" in phases else {}
    for row in kernel_rows:
        row["launches"] = counts.get(row["name"], 0)
        if "serve" in phases and row["launches"] < 1:
            raise SystemExit(f"the main path never launched {row['name']}")
    print(device["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    ok = phases == ["device", "build", "kernels", "slice", "serve"]
    print(json.dumps({"ok": ok, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}), flush=True)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
