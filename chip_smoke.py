#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives the port's six serving paths through ``repro_torch.launch.serve.run``
— granite-8b at full width and depth (attention through the flash-attention
kernel), mixtral-8x22b at full width and 8 of its 56 layers (attention, and
every MoE layer's dispatch through the moe-dispatch kernel), zamba2-1.2b at
full width and depth (every Mamba2 layer's prefill scan through the ssd-scan
kernel, the shared attention block through the flash kernel), rwkv6-1.6b
at full width and depth (every layer's prefill scan through the rwkv6-scan
kernel), paligemma-3b at full width and depth with 256 prefix embeddings
(attention at head_dim 256 through the flash kernel, the prefix
bidirectional) and whisper-base (6 + 6 layers) over 1536 frames (the
encoder's and the cross-attention's attention through the flash kernel with
no mask) — and its training paths through ``repro_torch.launch.train.run``:
granite-8b at full width and 8 of its 36 layers with int8-compressed
gradients (attention and its recompute through the flash kernel, every
gradient leaf's int8 payload through the ccu-reduce kernel), rwkv6-1.6b and
zamba2-1.2b at full width and depth with int8 (every layer's scan through
its kernel, in the forward and in the remat's recompute; zamba2's shared
attention through the flash kernel), mixtral-8x22b at full width and 1
of its 56 layers without compression (attention and dispatch through their
kernels, forward and recompute), and paligemma-3b at full width and depth
and whisper-base (6 + 6 layers) with int8, fed their stub inputs (256
prefix embeddings, 1536 frames) drawn each step through
``train.run(..., inputs=...)`` (every attention through the flash kernel,
forward and recompute); the ZeRO-1 data-parallel train step of
granite-8b on four ranks, every gradient sum through the ccu-reduce kernel
at P = 2, on (pod, data, model) = (2, 2, 1) and on the dense family's
sequence-parallel (data, model) = (2, 2); on that mesh served requests of
granite-8b and paligemma-3b (prefill into a longer cache, decode on the
model axis through flash's log-sum-exp output), mixtral-8x22b trained (its
experts' FSDP over "data") and served, and dbrx-132b served, then
rwkv6-1.6b, zamba2-1.2b and whisper-base trained and served on the model
axis (every layer's scan on the rank's heads); and a restart from a
checkpoint.  It holds
every hand-written kernel of those paths against its plain PyTorch version
on the card, the scans and the dispatch also under autograd at their
training shapes.  Phases, one JSON line each:

1. ``device``   torch version, device name, ``nvidia-smi`` name and power limit
2. ``build``    compiles the kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
                one process per source, all at once
3. ``kernels``  each kernel vs its plain version over the test shapes and at the
                main paths' shapes (the scans and the dispatch also under
                autograd at the training shapes, their gradients against the
                plain version's), with times (CUDA events), the least time
                the card could take (``bound_ms``) and one library call as a
                yardstick (``library_ms``; the port never calls it)
4. ``slice``    granite-8b, mixtral-8x22b, zamba2-1.2b, rwkv6-1.6b,
                paligemma-3b and whisper-base smoke configs: kernel path vs
                plain path, fp32 and bf16
5. ``serve``    granite-8b (36 layers), then mixtral-8x22b (8 layers), then
                zamba2-1.2b (38 layers), then rwkv6-1.6b (24 layers), then
                paligemma-3b (18 layers, 256 prefix embeddings), then
                whisper-base (6 + 6 layers, 1536 frames, prompt 64), each
                after the last one's weights are released, bf16, batch 4,
                prompt 512, 16 tokens, greedy; each batch again through the
                plain path, logits and ids compared; each path's kernel
                launches counted from 0.  zamba2's and rwkv6's plain paths
                run their scans through the kernels' plain versions, beside
                the models' twins, are held within how far the model carries
                a one-ulp move of its prompt, and are held layer by layer
6. ``train``    after the serving paths' weights are released: granite-8b
                smoke, fp32 and bf16, kernel path vs plain path (losses,
                first-step gradients, int8 payloads), then 40 steps through
                the kernel path with int8 compression, whose loss must fall by
                more than 0.5; then ``--auto-parallel`` (the planner's
                three lines, then 2 steps through the kernels,
                ``AUTO_PARALLEL``); then granite-8b at full width and 8 layers,
                batch 8, seq 256, int8, a few steps through the kernel path
                (launches counted from 0) and the same steps from the same
                drawn weights through the plain path; then rwkv6-1.6b,
                zamba2-1.2b, mixtral-8x22b, paligemma-3b and whisper-base
                the same way (``TRAIN_FAMILIES``; the last two with their
                drawn prefix embeddings and frames on both paths, held end
                to end and every attention sub-layer on the same input,
                ``_train_layers``)
7. ``dist``     the ZeRO-1 data-parallel train step (``train.train_step``)
                of granite-8b at full width and 2 layers on four ranks of a
                (pod, data, model) = (2, 2, 1) mesh on the one card (spawned
                after the build, gloo staged through host memory), 3 steps:
                every rank's params bit-identical after every step, each
                rank's ZeRO-1 shard equal to ``adamw.apply`` on the same
                gradient, the ranks against one process
                (``launch.train.run``) at global batch 8, the kernels'
                launches a step and rank against the count PERF.md predicts;
                then the same training on the dense family's model axis,
                (data, model) = (2, 2) (4 sequences a data rank, 128
                positions a model rank, each weight and K/V gathered over
                "model", each gradient reduce-scattered there through the
                ccu-reduce kernel), held the same way (the clip norm, a
                sum over the model ranks, held first: the same on every
                rank and within 1e-5 of the whole payload's), and the
                dry-run's trace of that cell (``train_step.lower_bundle`` on
                ``meta`` over a fake process group) against rank 0's
                recorded bytes; then on the same mesh granite-8b's and
                paligemma-3b's requests (batch 4, prompt 512 into a cache
                of 1024, 8 greedy decode steps on the model axis) against
                one process fed the ranks' ids, and the decode step's
                dry-run bytes; then mixtral-8x22b (1 layer, expert_tp) 2
                ZeRO-1 steps held the same way (one process routed by the
                ranks' choices) and its dry-run bytes, then mixtral's and
                dbrx-132b's requests (``DIST_MOE``); then, in one spawn,
                rwkv6-1.6b (2 layers), zamba2-1.2b (7) and whisper-base
                (6 + 6, drawn frames) 2 int8 steps each on the same mesh,
                held leaf by leaf (zamba2 also 2 steps in fp32, held end
                to end; in bf16 layer by layer: bf16 rounding carries past
                3e-2 at its depth), and their requests (zamba2's in bf16
                and in fp32), zamba2's train step's and
                rwkv6's decode step's dry-run bytes (``DIST_FAMILIES``);
                ``ccu_reduce`` timed at the meshes' P = 2 rows and
                decode's (``phase_dist``)
8. ``restart``  granite-3-2b smoke through the kernel path, int8, 10 steps,
                a save, a new run from fresh trees that resumes it for 10
                more, held against 20 straight (``_restart_check``)
9. ``netsim``   the port's network layers (``repro_torch.core``,
                ``repro_torch.netsim``, ``repro_torch.runtime``; numpy on the
                host, no kernel): the golden figures of
                ``tests/test_golden_numbers.py`` within its 2 % band
                (``NETSIM_GOLDEN``), Table 6's availability gap in closed
                form and from the Monte-Carlo campaign
                (``CAMPAIGN_GOLDEN``), the two max-min solvers within 1e-6
                on one scenario, the topology-aware planner's top three for
                granite-8b on 512 chips under the netsim-calibrated backend
                and the decode planner's two choices on one rack (``PLAN``),
                and the phase's wall seconds (``phase_netsim``)

The serve phase also runs rwkv6-1.6b and zamba2-1.2b at full depth in fp32,
kernel path against plain path, forward only (``_fp32_full_depth``).

Any failure ends the run with a non-zero exit code; without a GPU it exits
before printing any result.  ``--phases`` runs a subset while debugging.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import platform
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import torch  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_ULP = 2.0 ** -7     # one bf16 ulp of x is at most 2^-7 |x|
# ex2 on the special-function units: 16 an SM a clock (CUDA C++ programming
# guide, compute capability 9.0), 132 SMs at the 1.98 GHz boost clock.
MUFU_EX2_PER_S = 16 * 132 * 1.98e9

# The main paths: granite-8b, zamba2-1.2b and rwkv6-1.6b at full width and
# depth; mixtral-8x22b at full width and 8 of its 56 layers (56 would take
# 281 GB of bf16 weights).
SERVE = dict(arch="granite-8b", batch=4, prompt_len=512, gen=16, seed=0)
MIXTRAL = dict(SERVE, arch="mixtral-8x22b", n_layers=8)
ZAMBA = dict(SERVE, arch="zamba2-1.2b")
RWKV = dict(SERVE, arch="rwkv6-1.6b")
# paligemma-3b (head_dim 256, one KV head) at full width and depth with its
# 256 prefix embeddings drawn from the seed; whisper-base (6 + 6 layers) with
# its 1536 frames drawn from the seed and a prompt of 64
PALIGEMMA = dict(SERVE, arch="paligemma-3b")
WHISPER = dict(SERVE, arch="whisper-base", prompt_len=64)
# The training path: granite-8b at full width and 8 of its 36 layers (the
# training state is 20 bytes a parameter, 42.95 GB at 8 layers, 162 GB at 36),
# the reference train script's batch, sequence and int8 compression.
TRAIN = dict(arch="granite-8b", n_layers=8, batch=8, seq=256, steps=4, seed=0, compression="int8")
# The other families' training paths, at the same batch, sequence and steps:
# rwkv6-1.6b (1,584,046,080 parameters, 31.7 GB of state at 20 bytes each) and
# zamba2-1.2b (1,170,473,856, 23.4 GB) at full width and depth with int8;
# mixtral-8x22b at full width and 1 of its 56 layers (2.9 B parameters: a
# layer's experts alone are 8 x 3 x 6144 x 16384) without compression, 16
# bytes a parameter, 46.5 GB (int8's 20 would be 58 GB before activations,
# and granite's training peak ran 33 % above its state); paligemma-3b
# (2,432,055,296 parameters, 48.6 GB) at full width and depth with int8 and
# its 256 prefix embeddings drawn a step (512 positions), and whisper-base
# (6 + 6 layers, 97,355,776) with its 1536 frames drawn a step, int8, both
# through ``train.run(..., inputs=train.drawn_inputs(...))``, the inputs
# drawn from ``seed + INPUTS_SEED`` plus the step
TRAIN_FAMILY = dict(batch=8, seq=256, steps=4, seed=0)
TRAIN_FAMILIES = [dict(arch="rwkv6-1.6b", compression="int8"), dict(arch="zamba2-1.2b", compression="int8"),
                  dict(arch="mixtral-8x22b", n_layers=1, compression="none"),
                  dict(arch="paligemma-3b", compression="int8"), dict(arch="whisper-base", compression="int8")]
INPUTS_SEED = 100
# ``--auto-parallel``: the planner's search for the run's workload on 512
# chips of two pods (the reference's), then 2 steps of granite-8b smoke
# through the kernels, the smoke training's batch, sequence and int8
AUTO_PARALLEL = dict(steps=2, batch=8, seq=64, compression="int8")
# checkpoint/restart: as the reference's TestCheckpointRestart, 10 + 10 == 20
RESTART = dict(arch="granite-3-2b", steps=20, cut=10, batch=8, seq=64, seed=0, compression="int8")
# The distribution path: granite-8b at full width and 2 of its 36 layers
# (838,881,280 parameters), the ZeRO-1 data-parallel train step on four
# ranks of a (pod, data, model) = (2, 2, 1) mesh, all on the one card (about
# 11 GB a rank), the reference train script's global batch 8 (2 a rank),
# seq 256, int8, 3 steps; the gradients summed by hierarchical_allreduce
# with fast axis "data" and slow axis "pod"
DIST = dict(arch="granite-8b", n_layers=2, mesh=(2, 2, 1), axes=("pod", "data", "model"), batch=8, seq=256,
            steps=3, seed=0, compression="int8", lr=3e-4)
# The same training on the dense family's model axis: (data, model) = (2, 2),
# 4 sequences a data rank and 128 positions a model rank, each weight sharded
# on "model" gathered before use (the rules' sp); then served requests on the
# same ranks (``_dist_serve``): batch 4 (2 a data rank), a prompt of 512 (256
# positions a model rank) prefilled into a cache of 1024 (512 positions a
# model rank's block: the prompt fills the first), then 8 greedy decode steps
# on the model axis (tensor-parallel); granite-8b, and paligemma-3b at 2 of
# its 18 layers with its 256 drawn prefix embeddings before the prompt (768
# positions, 384 a model rank; a cache of 1280, blocks of 640)
DIST_MODEL = dict(DIST, mesh=(2, 2), axes=("data", "model"),
                  serve=[dict(arch="granite-8b", n_layers=2, batch=4, prompt_len=512, cache=1024, steps=8, seed=0),
                         dict(arch="paligemma-3b", n_layers=2, batch=4, prompt_len=512, cache=1024, steps=8,
                              seed=0)])
# The MoE family on the same mesh: mixtral-8x22b at full width and 1 of its
# 56 layers (expert_tp: each expert's F dim cut over "model", its d_model dim
# over "data" and gathered before use; 2,906,720,256 parameters, about 16 GB
# a rank with ZeRO-1 state), 2 ZeRO-1 steps at global batch 8, seq 256,
# without compression as its one-process training path; then served as
# above with 4 decode steps, and dbrx-132b (expert_parallel: its 16 experts
# cut over "model", their F dim over "data"; 1 of 40 layers, 4,492,216,320
# parameters) served the same way.  dbrx trains on the model axis only in
# the CPU tests: four ranks of its training state (about 23 GB each) do not
# fit the card.
DIST_MOE = dict(arch="mixtral-8x22b", n_layers=1, mesh=(2, 2), axes=("data", "model"), batch=8, seq=256, steps=2,
                seed=0, compression="none", lr=3e-4,
                serve=[dict(arch="mixtral-8x22b", n_layers=1, batch=4, prompt_len=512, cache=1024, steps=4, seed=0),
                       dict(arch="dbrx-132b", n_layers=1, batch=4, prompt_len=512, cache=1024, steps=4, seed=0)])

# The SSM, hybrid and audio families on the same mesh, one spawn, each in
# turn (``_rank_train``): int8 ZeRO-1, global batch 8, seq 256, 2 steps;
# rwkv6-1.6b at 2 of its 24 layers (tensor-parallel over its 32 heads: 16 a
# rank, every rank the whole sequences), zamba2-1.2b at 7 of its 38 layers
# (its shared block once: (7 - 1) // 6), whisper-base at its full 6 + 6
# layers through ``EncDecHarness.loss`` with 1536 drawn frames a sequence
# (768 a model rank); then each one's request as above (whisper: its 1536
# drawn frames and a prompt of 64 into a cache of 128).  zamba2 runs twice,
# in bf16 and in fp32 (the same drawn weights, cast), each trained and
# served: the fp32 run is held end to end; in bf16 its random weights carry
# the ranks' other roundings past the limit at 7 layers
DIST_FAMILIES = dict(
    mesh=(2, 2), axes=("data", "model"), batch=8, seq=256, steps=2, seed=0, compression="int8", lr=3e-4,
    runs=[dict(arch="rwkv6-1.6b", n_layers=2,
               serve=[dict(arch="rwkv6-1.6b", n_layers=2, batch=4, prompt_len=512, cache=1024, steps=8, seed=0)]),
          dict(arch="zamba2-1.2b", n_layers=7,
               serve=[dict(arch="zamba2-1.2b", n_layers=7, batch=4, prompt_len=512, cache=1024, steps=8, seed=0)]),
          dict(arch="zamba2-1.2b", n_layers=7, dtype="float32",
               serve=[dict(arch="zamba2-1.2b", n_layers=7, batch=4, prompt_len=512, cache=1024, steps=8, seed=0,
                           dtype="float32")]),
          dict(arch="whisper-base", n_layers=6,
               serve=[dict(arch="whisper-base", n_layers=6, batch=4, prompt_len=64, cache=128, steps=8, seed=0)])])


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
    libs = _build.build(["flash_attention", "flash_attention_bwd", "moe_dispatch", "ssd_scan", "rwkv6_scan",
                         "ccu_reduce"])
    seconds = time.perf_counter() - t0
    # ptxas -v: registers and spills of every instantiation, by library
    ptxas = {}
    for name, lib in libs.items():
        log = lib.with_suffix(".log").read_text()
        ptxas[name] = {"max_registers": max((int(w.split()[0]) for w in log.split("Used")[1:]), default=None),
                       "spill_store_bytes": sum(int(w.split()[-1])
                                                for w in log.split(" bytes spill stores")[:-1])}
    # and of each kernel by name, for the kernels a PR redesigned
    by_kernel = {}
    for name in ("flash_attention", "flash_attention_bwd", "moe_dispatch", "ssd_scan", "rwkv6_scan"):
        by_kernel[name] = {}
        for entry in libs[name].with_suffix(".log").read_text().split("Compiling entry function '")[1:]:
            by_kernel[name][entry.split("'")[0]] = {
                key: int(m.group(1)) if (m := re.search(pattern, entry)) else None
                for key, pattern in (("registers", r"Used (\d+) registers"),
                                     ("spill_store_bytes", r"(\d+) bytes spill stores"),
                                     ("spill_load_bytes", r"(\d+) bytes spill loads"))}
    emit("build", seconds=round(seconds, 2), nvcc=_build.find_nvcc(),
         libraries={n: str(p) for n, p in libs.items()}, ptxas=ptxas,
         ptxas_flash=by_kernel["flash_attention"], ptxas_flash_bwd=by_kernel["flash_attention_bwd"],
         ptxas_moe_dispatch=by_kernel["moe_dispatch"],
         ptxas_ssd_scan=by_kernel["ssd_scan"], ptxas_rwkv6_scan=by_kernel["rwkv6_scan"])


def _rand(gen, shape, dtype, scale):
    return (torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32) * scale).to(dtype)


def _qkv(gen, q_shape, kv_shape, dtype):
    """Inputs that make a wrong kernel show: scores of standard deviation 3,
    so each row's softmax rests on a few keys that depend on q, and values of
    standard deviation 1, so the outputs are of order 1 and not a mean of v
    that any weighting would reproduce."""
    return (_rand(gen, q_shape, dtype, 2.0), _rand(gen, kv_shape, dtype, 1.5),
            _rand(gen, kv_shape, dtype, 1.0))


def _excess(o, r, dtype, ulps: int = 1, of_row: bool = False,
            f32_limit: float = 2e-5, bf16_abs: float = 1e-5) -> tuple[float, float]:
    """(max |o - r|, the largest ratio of |o - r| to its limit) of a kernel's
    output against the plain version's, element by element.  float32:
    ``f32_limit`` absolute on outputs of order 1 (sums in another order).  bfloat16: both
    round the same fp32 result once, so they differ by at most ``ulps`` bf16
    ulps of that element (2^-7 |r| each), plus ``bf16_abs`` for the order of
    the fp32 sums beneath.  ``of_row`` takes the ulp of the largest element of the
    output row instead: for a version that rounds the probabilities, whose
    error in an element goes with the row's values and not with the element's."""
    o, r = o.float(), r.float()
    diff = (o - r).abs()
    size = r.abs().amax(dim=-1, keepdim=True) if of_row else r.abs()
    limit = torch.full_like(r, f32_limit) if dtype == torch.float32 else ulps * BF16_ULP * size + bf16_abs
    return diff.max().item(), (diff / limit).max().item()


def _bit_equal(o, r) -> tuple[float, float]:
    """(max |o - r|, its ratio to a limit of zero): 0.0 when bit-equal, else inf."""
    err = (o.float() - r.float()).abs().max().item()
    return err, 0.0 if torch.equal(o, r) else math.inf


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
    for D in (32, 64, 128, 256):
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
    for dt in (f32, bf16):
        # head_dim 256: a prefix crossing key tiles (prefill and decode), no
        # mask with Sq != Sk both ways, and a decode whose 256 kv heads leave
        # each split several tiles (fp32's ring has one stage at this width)
        cases.append((2, 1, 8, 100, 100, 256, dt, dict(causal=True, prefix_len=70)))
        cases.append((1, 1, 8, 1, 300, 256, dt, dict(causal=True, prefix_len=100, q_start=299)))
        cases.append((2, 2, 1, 64, 333, 256, dt, dict(causal=False)))
        cases.append((2, 2, 3, 130, 40, 256, dt, dict(causal=False)))
        cases.append((8, 32, 2, 1, 1000, 256, dt, dict(causal=True, q_start=999)))
    return cases


def _flash_bound_ms(q, k, v, mask_kw, out_bytes: int = 0) -> tuple[float, str]:
    """Least time for this call: bytes (q read once, o and ``out_bytes``
    more written once, and each key and value that some row sees read once)
    over the memory rate, against the operations the visible (query, key)
    pairs need (two products, 2 flops a multiply-add) over the peak rate."""
    from repro_torch.kernels.flash_attention import visible

    B, Sq, N, D = q.shape
    Sk = k.shape[1]
    kw = dict(causal=True, window=None, prefix_len=0, q_start=0) | mask_kw
    seen = visible(Sq, Sk, **kw)
    pairs = int(seen.sum())
    flops = 4 * D * pairs * B * N
    keys = int(seen.any(0).sum())
    nbytes = (2 * q.numel() + (k.numel() + v.numel()) * keys // Sk) * q.element_size() + out_bytes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _bsnd(fn, q, k, v, kw, cast=lambda t: t) -> torch.Tensor:
    """``fn`` (a version of flash attention in its own layout) applied to q
    (B, Sq, N, Dh) and k/v (B, Sk, K, Dh), as ``ops.flash_attention_bsnd`` does."""
    K, N = k.shape[2], q.shape[2]
    qk = cast(q).unflatten(2, (K, N // K)).permute(0, 2, 3, 1, 4)
    o = fn(qk, cast(k).permute(0, 2, 1, 3), cast(v).permute(0, 2, 1, 3), **kw)
    return o.permute(0, 3, 1, 2, 4).reshape(q.shape)


def _flash_main_shape(q, k, v, kw, where: str) -> dict:
    """The kernel at one of the main paths' shapes, in the model's layout
    (q (B, Sq, N, Dh), k/v (B, Sk, K, Dh)), bf16: held per element against
    the plain version and the float64 oracle (one ulp) and against the
    library call (four ulps of the row: it rounds its probabilities to bf16
    before P.V), and timed beside them and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ref import attention_ref

    dt = q.dtype

    def plain():
        return _bsnd(flash_attention_plain, q, k, v, kw)

    if kw.get("window") is not None and kw["window"] < k.shape[1]:
        raise SystemExit(f"the library yardstick at the {where} shape has no window mask")
    mask = None
    if kw.get("prefix_len", 0) > 0:
        from repro_torch.kernels.flash_attention import visible
        mask = visible(q.shape[1], k.shape[1], causal=kw.get("causal", True), window=None,
                       prefix_len=kw["prefix_len"], q_start=kw.get("q_start", 0), device=q.device)

    def library():
        # prefill from position 0 is causal from the top left; a row at the
        # cache's last position sees every key, as does every row without a
        # causal mask: no mask needed (a window, as mixtral's 4096, covers
        # every key at these shapes); a bidirectional prefix takes the mask
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            is_causal=mask is None and kw.get("causal", True) and q.shape[1] > 1, enable_gqa=True,
        ).transpose(1, 2)

    o = ops.flash_attention_bsnd(q, k, v, **kw)
    torch.cuda.synchronize()
    r = plain()
    err, of_limit = _excess(o, r, dt)
    lib_err, lib_of_limit = _excess(o, library(), dt, ulps=4, of_row=True)
    ref_err, ref_of_limit = _excess(o, _bsnd(attention_ref, q, k, v, kw, torch.Tensor.double), dt)
    if not max(of_limit, lib_of_limit, ref_of_limit) <= 1.0:
        raise SystemExit(f"flash_attention at the {where} shape: max_abs_err={err} vs plain "
                         f"({of_limit} of its limit), {lib_err} vs the library call "
                         f"({lib_of_limit}), {ref_err} vs the float64 oracle ({ref_of_limit})")
    bound_ms, bound_by = _flash_bound_ms(q, k, v, kw)
    ms, call_ms = time_ms(lambda: ops.flash_attention_bsnd(q, k, v, **kw))
    return {
        "shape": f"q{tuple(q.shape)} kv{tuple(k.shape)} {str(dt).split('.')[-1]} {kw}",
        "max_abs_err": err,
        "err_of_limit": of_limit,
        "oracle_err_of_limit": ref_of_limit,
        "max_abs_plain": r.float().abs().max().item(),
        "ms": ms,
        "call_ms": call_ms,
        "plain_ms": time_ms(plain)[0],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": time_ms(library)[0],
    }


def _flash_gradients(gen, q, k, v, kw) -> dict:
    """The kernel under autograd, as the training step calls it: its output
    must carry a ``grad_fn`` and equal the kernel's output without autograd;
    the gradients of a random projection of it lie within one bf16 ulp of
    each tensor's largest |g| of the float64 oracle's.  Where the backward
    is the plain version's gradient (head_dim 256, ``kernel_gradient``) they
    equal the plain version's bit for bit (fp32 sums rounded once to bf16);
    at head_dim 64 and 128 the backward kernels take them
    (``_flash_bwd_shape`` holds them at the training shapes)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain, kernel_gradient
    from repro_torch.kernels.ref import attention_ref

    w = _rand(gen, q.shape, q.dtype, 1.0)
    runs = {}
    for name, fn in (("kernel", lambda *t: ops.flash_attention_bsnd(*t, **kw)),
                     ("plain", lambda *t: _bsnd(flash_attention_plain, *t, kw)),
                     ("oracle", lambda *t: _bsnd(attention_ref, *t, kw, torch.Tensor.double))):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = fn(*leaves)
        if o.grad_fn is None:
            raise SystemExit(f"flash_attention at the train shape: the {name} output has no grad_fn")
        (o.double() * w.double()).sum().backward()
        runs[name] = (o.detach(), [t.grad for t in leaves])
    (o, g), (_, gp), (_, go) = runs["kernel"], runs["plain"], runs["oracle"]
    same_output = torch.equal(o, ops.flash_attention_bsnd(q, k, v, **kw))
    kernels = kernel_gradient(q.unflatten(2, (k.shape[2], -1)).permute(0, 2, 3, 1, 4))
    bit_equal = all(torch.equal(a, b) for a, b in zip(g, gp))
    of_largest = max(((a.double() - b).abs().max() / (BF16_ULP * b.abs().max())).item()
                     for a, b in zip(g, go))
    if not (same_output and (bit_equal or kernels) and of_largest <= 1.0):
        raise SystemExit(f"flash_attention at the train shape under autograd: output as without "
                         f"autograd {same_output}, gradients bit-equal to plain {bit_equal}, "
                         f"vs the float64 oracle {of_largest} of one ulp of the largest |g|")
    return {"output_equals_no_grad_call": same_output, "backward": "kernels" if kernels else "plain gradient",
            "bit_equal_to_plain": bit_equal, "oracle_err_of_ulp_of_largest": of_largest}


def _flash_bwd_shape(gen, q, k, v, kw, where: str, chunk: int = 512) -> dict:
    """Flash attention's backward kernels at a training shape, in the
    model's layout (q (B, Sq, N, Dh), k/v (B, Sk, K, Dh)), bf16, the
    output's gradient of standard deviation 1.  Under autograd, as the
    training step calls it: one backward launch inside one
    ``flash_attention.bwd`` span; dq, dk and dv within one bf16 ulp of each
    tensor's largest |g| from the float64 oracle's (autograd through
    ``attention_ref``, in blocks of ``chunk`` rows at their own offsets),
    reported beside the plain backward's distance, and within one bf16 ulp
    of the plain backward's largest |g| from it
    (``flash_attention_bwd_plain`` on the same saved output before its
    rounding and log-sum-exp, fp32); two more launches bit-equal to it and
    to each other.
    Times: the backward (its three launches), from the host, the plain
    backward, the library call's backward (``scaled_dot_product_attention``
    with the same mask, its graph kept: a yardstick the port never calls),
    and the bound: twice the forward's operations and bytes
    (``_flash_bound_ms``), as ``work.train_step_flops`` counts a backward."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (_launch, _launch_bwd, flash_attention,
                                                     flash_attention_bwd_plain, visible)
    from repro_torch.kernels.ref import attention_ref

    B, Sq, N, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    full = dict(causal=True, window=None, prefix_len=0, q_start=0) | kw
    go = _rand(gen, q.shape, q.dtype, 1.0)

    def to_bkgsd(t):
        return t.unflatten(2, (K, N // K)).permute(0, 2, 3, 1, 4)

    def from_bkgsd(t):
        return t.permute(0, 3, 1, 2, 4).reshape(B, Sq, N, D)

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = flash_attention.bwd_launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        g = torch.autograd.grad(ops.flash_attention_bsnd(*leaves, **kw), leaves, go)
    spans_seen = sum(e.count for e in prof.key_averages() if e.key == "flash_attention.bwd")
    launches = flash_attention.bwd_launches - before

    inputs = (to_bkgsd(q), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))
    _, lse, o = _launch(*inputs, for_backward=True, sm_scale=D ** -0.5, **full)

    def kernel():
        return _launch_bwd(*inputs, o, lse, to_bkgsd(go), sm_scale=D ** -0.5, **full)

    def plain():
        return flash_attention_bwd_plain(*inputs, o, lse, to_bkgsd(go), **full)

    first, second = kernel(), kernel()
    as_model = (from_bkgsd(first[0]), first[1].permute(0, 2, 1, 3), first[2].permute(0, 2, 1, 3))
    identical = all(torch.equal(a, b) for a, b in zip(first, second)) and \
        all(torch.equal(a, b) for a, b in zip(as_model, g))
    pl = plain()
    pl = (from_bkgsd(pl[0]), pl[1].permute(0, 2, 1, 3), pl[2].permute(0, 2, 1, 3))
    torch.cuda.synchronize()

    oracle = [torch.zeros(t.shape, dtype=torch.float64, device=t.device) for t in (q, k, v)]
    k64, v64 = (t.double().requires_grad_() for t in (k, v))
    for a in range(0, Sq, chunk):
        q64 = q[:, a:a + chunk].double().requires_grad_()
        ro = _bsnd(attention_ref, q64, k64, v64, dict(full, q_start=full["q_start"] + a))
        gq, gk, gv = torch.autograd.grad(ro, (q64, k64, v64), go[:, a:a + chunk].double())
        oracle[0][:, a:a + chunk] = gq
        oracle[1] += gk
        oracle[2] += gv
    del k64, v64

    def of_ulp(x, r):
        return ((x.double() - r).abs().max() / (BF16_ULP * r.abs().max())).item()

    errs = {n: of_ulp(x, r) for n, x, r in zip(("dq", "dk", "dv"), g, oracle)}
    plain_errs = {n: of_ulp(x, r) for n, x, r in zip(("dq", "dk", "dv"), pl, oracle)}
    vs_plain = {n: of_ulp(x, r.double()) for n, x, r in zip(("dq", "dk", "dv"), g, pl)}
    del oracle
    if not (max(errs.values()) <= 1.0 and max(vs_plain.values()) <= 1.0 and identical and launches == 1
            and spans_seen == 1):
        raise SystemExit(f"flash_attention's backward at the {where} shape: vs the float64 oracle {errs} of "
                         f"one ulp of the largest |g| (plain backward {plain_errs}), vs the plain backward "
                         f"{vs_plain}, launches bit-equal {identical}, backward launches {launches} in "
                         f"{spans_seen} spans")

    causal_from_top = full["causal"] and full["q_start"] == 0 and Sq == Sk and full["window"] is None \
        and full["prefix_len"] == 0
    mask = None if causal_from_top or not full["causal"] else visible(
        Sq, Sk, causal=True, window=full["window"], prefix_len=full["prefix_len"], q_start=full["q_start"],
        device=q.device)
    lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask, is_causal=causal_from_top, enable_gqa=True)
    lgo = go.transpose(1, 2)

    def library():
        return torch.autograd.grad(lo, (lq, lk, lv), lgo, retain_graph=True)

    bound_ms, bound_by = _flash_bound_ms(q, k, v, kw)
    ms, call_ms = time_ms(kernel)
    return {
        "shape": f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16 {kw} ({where})",
        "oracle_err_of_ulp_of_largest": errs, "plain_oracle_err_of_ulp_of_largest": plain_errs,
        "plain_err_of_ulp_of_largest": vs_plain, "launches_bit_equal": identical, "bwd_launches": launches, "bwd_spans": spans_seen,
        "ms": ms, "call_ms": call_ms, "plain_ms": time_ms(plain, iters=3, warmup=1)[0],
        "library_ms": time_ms(library, iters=5, warmup=1)[0],
        "bound_ms": 2 * bound_ms, "bound_by": bound_by,
    }


def _flash_bwd_rows() -> dict:
    """The backward kernels at the training shapes (``_flash_bwd_shape``):
    both benchmark cells' (granite-8b and mixtral-8x22b, 2 sequences of
    4,096, causal), the train phase's granite-8b, zamba2-1.2b's shared
    attention (G = 1, head dim 64), whisper-base's encoder and
    cross-attention (no mask, Sq != Sk), and the dist path's
    sequence-parallel rows (128 a model rank against 256 keys, both ranks).
    Drawn from a generator of their own, so that the kernels line's other
    rows draw what they drew before these rows were."""
    from repro_torch.configs import load

    gen = torch.Generator(device="cuda").manual_seed(1)
    Bt, St, T = TRAIN_FAMILY["batch"], TRAIN_FAMILY["seq"], load("whisper-base").cfg.n_frames
    causal, no_mask = dict(causal=True, q_start=0), dict(causal=False, q_start=0)
    rows = {}
    for name, (B, Sq, Sk, N, K, D, kw) in {
            "granite_train_4k": (2, 4096, 4096, 32, 8, 128, causal),
            "mixtral_train_4k": (2, 4096, 4096, 48, 8, 128, causal),
            "granite_train": (TRAIN["batch"], TRAIN["seq"], TRAIN["seq"], 32, 8, 128, causal),
            "zamba2_train": (Bt, St, St, 32, 32, 64, causal),
            "whisper_encoder_train": (Bt, T, T, 8, 8, 64, no_mask),
            "whisper_cross_train": (Bt, St, T, 8, 8, 64, no_mask),
            "dist_train_q0": (4, 128, 256, 32, 8, 128, causal),
            "dist_train_q128": (4, 128, 256, 32, 8, 128, dict(causal=True, q_start=128))}.items():
        q, k, v = _qkv(gen, (B, Sq, N, D), (B, Sk, K, D), torch.bfloat16)
        rows[name] = _flash_bwd_shape(gen, q, k, v, kw, name)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def _under_autograd(name: str, call, plain, inputs: list, grad_of: list, nbytes: int, flops: int,
                    dt, agree, recomputed=None) -> dict:
    """A kernel under autograd at a training step's shape, as the step calls
    it: y carries a ``grad_fn`` and equals the call without autograd, bit
    for bit; its outputs (y and, for a scan, the final state) under autograd
    are held against the plain version's under autograd on the same inputs
    (and a scan's against the float64 oracle) by ``agree(kernel outputs,
    plain outputs) -> {comparison: (max |difference|, its ratio to the
    limit)}``, at the kernel rows' limits; the gradients of a
    random projection of y equal the plain version's, bit for bit (the
    backward recomputes the plain version; ``recomputed``, where given, is
    the form of it the backward recomputes), and are finite.  Times: the
    kernel's forward (``ms``), the plain version's forward (``plain_ms``)
    and the backward (``backward_ms``: the plain version recomputed and
    differentiated, no kernel); ``bound_ms`` is the forward's, from
    ``nbytes`` and ``flops``."""
    with torch.no_grad():
        y0 = call(*inputs)
    y0 = y0[0] if isinstance(y0, tuple) else y0
    go = _rand(torch.Generator(device="cuda").manual_seed(5), y0.shape, y0.dtype, 1.0)
    runs = []
    for fn in (call, plain, recomputed or plain):
        xs = [None if t is None else t.detach().requires_grad_(i in grad_of) for i, t in enumerate(inputs)]
        out = fn(*xs)
        y = out[0] if isinstance(out, tuple) else out
        if y.grad_fn is None:
            raise SystemExit(f"{name} at the training shape: no grad_fn under autograd")
        wanted = [xs[i] for i in grad_of]
        runs.append((out, y, wanted, torch.autograd.grad(y, wanted, go, retain_graph=True)))
    (out, y, wanted, g), (out_plain, _, _, _), (_, _, _, gp) = runs
    same_output = torch.equal(y.detach(), y0)
    with torch.no_grad():
        agreement = {k: {"max_abs_err": e, "err_of_limit": r} for k, (e, r) in agree(out, out_plain).items()}
    bit_equal = all(torch.equal(a, b) for a, b in zip(g, gp))
    finite = all(bool(torch.isfinite(a.float()).all()) for a in g)
    if not (same_output and all(a["err_of_limit"] <= 1.0 for a in agreement.values()) and bit_equal and finite):
        raise SystemExit(f"{name} at the training shape under autograd: output as without autograd "
                         f"{same_output}, outputs {agreement}, gradients bit-equal to plain {bit_equal}, "
                         f"finite {finite}")
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
    ms, call_ms = time_ms(lambda: call(*inputs))
    return {
        "shape": " ".join(f"{tuple(t.shape)}" for t in inputs if t is not None),
        "output_equals_no_grad_call": same_output, "outputs": agreement,
        "gradients_bit_equal_to_plain": bit_equal,
        "gradients_of": len(grad_of),
        "ms": ms, "call_ms": call_ms,
        "plain_ms": time_ms(lambda: plain(*inputs))[0],
        "backward_ms": time_ms(lambda: torch.autograd.grad(y, wanted, go, retain_graph=True), iters=5, warmup=1)[0],
        "bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


def _flash_sp_shape(gen, B: int, Sq: int, Sk: int, q_start: int, where: str, chunk: int = 256) -> dict:
    """The kernel at a sequence-parallel shape of the dense family: a model
    rank's ``Sq`` rows of granite-8b (32 heads on 8 KV heads of 128, bf16)
    at ``q_start`` against the ``Sk`` keys gathered over "model", causal.
    Held per element against the plain version (one ulp; computed in row
    blocks of ``chunk`` at their own offsets, so that its fp32 scores fit),
    the float64 oracle (one ulp, on three blocks of 8 rows where ``Sq`` > 64:
    the first, the middle and the last) and the library call (four ulps of
    the row: ``scaled_dot_product_attention`` with the same offset causal
    mask as a boolean mask, K and V repeated to the 32 heads so that its
    memory-efficient kernel takes them).  Times: kernel, from the host, the
    plain version (all its blocks), the library call, and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain, visible
    from repro_torch.kernels.ref import attention_ref

    N, K, D, dt = 32, 8, 128, torch.bfloat16
    q, k, v = _qkv(gen, (B, Sq, N, D), (B, Sk, K, D), dt)
    kw = dict(causal=True, q_start=q_start)

    def plain():
        return torch.cat([_bsnd(flash_attention_plain, q[:, a:a + chunk], k, v, dict(kw, q_start=q_start + a))
                          for a in range(0, Sq, chunk)], dim=1)

    mask = visible(Sq, Sk, causal=True, window=None, prefix_len=0, q_start=q_start, device=q.device)
    qt, kr, vr = q.transpose(1, 2), k.repeat_interleave(N // K, dim=2).transpose(1, 2), \
        v.repeat_interleave(N // K, dim=2).transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kr, vr, attn_mask=mask).transpose(1, 2)

    o = ops.flash_attention_bsnd(q, k, v, **kw)
    torch.cuda.synchronize()
    r = plain()
    err, of_limit = _excess(o, r, dt)
    lib_err, lib_of_limit = _excess(o, library(), dt, ulps=4, of_row=True)
    blocks = [(0, Sq)] if Sq <= 64 else [(0, 8), (Sq // 2 - 4, Sq // 2 + 4), (Sq - 8, Sq)]
    ref_of_limit = max(_excess(o[:, a:b], _bsnd(attention_ref, q[:, a:b], k, v, dict(kw, q_start=q_start + a),
                                                torch.Tensor.double), dt)[1] for a, b in blocks)
    if not (max(of_limit, lib_of_limit, ref_of_limit) <= 1.0 and torch.isfinite(o.float()).all()):
        raise SystemExit(f"flash_attention at the sequence-parallel {where} shape: max_abs_err={err} vs plain "
                         f"({of_limit} of its limit), {lib_err} vs the library call ({lib_of_limit}), "
                         f"the float64 oracle {ref_of_limit} of its limit")
    bound_ms, bound_by = _flash_bound_ms(q, k, v, kw)
    ms, call_ms = time_ms(lambda: ops.flash_attention_bsnd(q, k, v, **kw))
    return {
        "shape": f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16 {kw}",
        "max_abs_err": err, "err_of_limit": of_limit, "oracle_err_of_limit": ref_of_limit,
        "oracle_rows": blocks, "library_err_of_limit": lib_of_limit,
        "ms": ms, "call_ms": call_ms, "plain_ms": time_ms(plain, iters=5, warmup=1)[0],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": time_ms(library, iters=5, warmup=1)[0],
    }


def _flash_block_shape(gen, B: int, N: int, K: int, D: int, Lb: int, q_local: int, prefix: int,
                       where: str) -> dict:
    """The decode kernels over a model rank's block of the cache, as
    ``layers._attend_block`` calls them on the model axis: every query head
    of one position against the block's keys up to the last visible one
    (``max(min(Lb, q_local + 1), prefix)`` of its ``Lb``), ``q_start`` the
    position less the block's offset, with the log-sum-exp output.  Held:
    the output within one ulp of the plain version's and bit-equal to the
    same call without the log-sum-exp; the log-sum-exp within 1e-5 of
    max(1, |lse|) of the plain version's.  Times: kernel (with the
    log-sum-exp), plain version, the library call (``scaled_dot_product_
    attention`` over the same keys with the same mask: the output only) and
    the bound (``_flash_bound_ms``: q and the keys and values some row sees
    read once, o and the log-sum-exp written)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import visible

    dt = torch.bfloat16
    n = max(min(Lb, q_local + 1), prefix)
    q, k, v = _qkv(gen, (B, 1, N, D), (B, Lb, K, D), dt)
    k, v = k[:, :n], v[:, :n]
    kw = dict(causal=True, window=None, prefix_len=prefix, q_start=q_local)
    o, lse = ops.flash_attention_bsnd(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    same = torch.equal(o, ops.flash_attention_bsnd(q, k, v, **kw))

    def plain():
        from repro_torch.kernels.flash_attention import flash_attention_plain

        qk = q.unflatten(2, (K, N // K)).permute(0, 2, 3, 1, 4)
        ro, rl = flash_attention_plain(qk, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), return_lse=True, **kw)
        return ro.permute(0, 3, 1, 2, 4).reshape(q.shape), rl.permute(0, 3, 1, 2).reshape(B, 1, N)

    ro, rl = plain()
    err, of_limit = _excess(o, ro, dt)
    lse_of_limit = ((lse - rl).abs() / (1e-5 * rl.abs().clamp(min=1.0))).max().item()
    if not (same and of_limit <= 1.0 and lse_of_limit <= 1.0 and torch.isfinite(lse).all()):
        raise SystemExit(f"flash decode over a model rank's block ({where}): output {err} ({of_limit} of its "
                         f"limit), log-sum-exp {lse_of_limit} of its limit, bit-equal without it: {same}")

    mask = visible(1, n, causal=True, window=None, prefix_len=prefix, q_start=q_local, device=q.device)

    def library():
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                              attn_mask=mask, enable_gqa=True).transpose(1, 2)

    bound_ms, bound_by = _flash_bound_ms(q, k, v, kw, out_bytes=lse.numel() * lse.element_size())
    ms, call_ms = time_ms(lambda: ops.flash_attention_bsnd(q, k, v, return_lse=True, **kw))
    return {"shape": f"q{tuple(q.shape)} keys {n} of a block of {Lb}: kv{tuple(k.shape)} bf16 {kw} ({where})",
            "max_abs_err": err, "err_of_limit": of_limit, "lse_err_of_limit": lse_of_limit,
            "lse_limit": "1e-5 of max(1, |lse|)", "bit_equal_without_lse": same,
            "ms": ms, "call_ms": call_ms, "plain_ms": time_ms(plain)[0],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": time_ms(library)[0]}


def _flash_row(gen) -> dict:
    from repro_torch.configs import load
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.ref import attention_ref

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

    # the main paths' own shapes, in the model's layout: q from the projections,
    # k/v a slice of one layer's KV cache (B, Smax, K, Dh), read in place.
    # granite-8b: 32 heads on 8 KV heads of 128, decoding at S + 7;
    # mixtral-8x22b: 48 heads on 8 KV heads of 128 (G = 6: 64 folded rows do
    # not divide by it), window 4096, decoding at S + 7; zamba2-1.2b's shared
    # block: 32 heads of 64, G = 1, decoding at its last step, S + gen - 2
    B, S, dt = SERVE["batch"], SERVE["prompt_len"], torch.bfloat16
    s_max = S + SERVE["gen"] + 8
    rows = {}
    for path, N, K, D, decode_at, window in (("", 32, 8, 128, S + 7, None),
                                             ("mixtral_", 48, 8, 128, S + 7, 4096),
                                             ("zamba2_", 32, 32, 64, S + ZAMBA["gen"] - 2, None)):
        q_prefill, ck, cv = _qkv(gen, (B, S, N, D), (B, s_max, K, D), dt)
        rows[path + "prefill"] = _flash_main_shape(q_prefill, ck[:, :S], cv[:, :S],
                                                   dict(causal=True, window=window, q_start=0), path + "prefill")
        q_decode = _rand(gen, (B, 1, N, D), dt, 2.0)
        rows[path + "decode"] = _flash_main_shape(q_decode, ck[:, :decode_at + 1], cv[:, :decode_at + 1],
                                                  dict(causal=True, window=window, q_start=decode_at),
                                                  path + "decode")
    # paligemma-3b: 8 heads on one KV head of 256 (G = 8), its 256 prefix
    # embeddings before the prompt, every key of the prefix seen by every row;
    # decoding at P + S + gen - 2 (the last step), the prefix behind the causal mask
    P, N, K, D = load("paligemma-3b").prefix_tokens, 8, 1, 256
    s_pali = P + S + PALIGEMMA["gen"] + 8
    q_prefill, ck, cv = _qkv(gen, (B, P + S, N, D), (B, s_pali, K, D), dt)
    rows["paligemma_prefill"] = _flash_main_shape(q_prefill, ck[:, :P + S], cv[:, :P + S],
                                                  dict(causal=True, prefix_len=P, q_start=0), "paligemma prefill")
    at = P + S + PALIGEMMA["gen"] - 2
    rows["paligemma_decode"] = _flash_main_shape(_rand(gen, (B, 1, N, D), dt, 2.0), ck[:, :at + 1], cv[:, :at + 1],
                                                 dict(causal=True, q_start=at), "paligemma decode")
    # whisper-base: 8 heads of 64 (G = 1) over its 1536 frames, no mask: the
    # encoder (every frame sees every frame), the decoder's cross-attention
    # from the prompt's 64 rows and from a decode step's one
    T, S_w, N, D = load("whisper-base").cfg.n_frames, WHISPER["prompt_len"], 8, 64
    q_enc, k_enc, v_enc = _qkv(gen, (B, T, N, D), (B, T, N, D), dt)
    no_mask = dict(causal=False, q_start=0)
    rows["whisper_encoder"] = _flash_main_shape(q_enc, k_enc, v_enc, no_mask, "whisper encoder")
    rows["whisper_cross_prefill"] = _flash_main_shape(_rand(gen, (B, S_w, N, D), dt, 2.0), k_enc, v_enc, no_mask,
                                                      "whisper cross-attention prefill")
    rows["whisper_cross_decode"] = _flash_main_shape(_rand(gen, (B, 1, N, D), dt, 2.0), k_enc, v_enc, no_mask,
                                                     "whisper cross-attention decode")
    # granite-8b's training step: the whole sequence's q, k, v from the
    # projections, every layer's attention under autograd
    N, K, D = 32, 8, 128
    q, k, v = _qkv(gen, (TRAIN["batch"], TRAIN["seq"], N, D), (TRAIN["batch"], TRAIN["seq"], K, D), dt)
    rows["train"] = _flash_main_shape(q, k, v, dict(causal=True, q_start=0), "train")
    rows["train"]["gradients"] = _flash_gradients(gen, q, k, v, dict(causal=True, q_start=0))
    # paligemma-3b's training shape: batch 8, its 256 prefix embeddings and
    # 256 tokens, q (8, 1, 8, 512, 256) folded, under autograd
    N, K, D = 8, 1, 256
    q, k, v = _qkv(gen, (TRAIN["batch"], P + TRAIN["seq"], N, D), (TRAIN["batch"], P + TRAIN["seq"], K, D), dt)
    kw = dict(causal=True, prefix_len=P, q_start=0)
    rows["paligemma_train"] = _flash_main_shape(q, k, v, kw, "paligemma train")
    rows["paligemma_train"]["gradients"] = _flash_gradients(gen, q, k, v, kw)
    # whisper-base's training shapes, batch 8, no mask, under autograd: the
    # encoder's self-attention over its 1536 frames, and the decoder's 256
    # rows' cross-attention over the encoder's output
    Bt, St = TRAIN_FAMILY["batch"], TRAIN_FAMILY["seq"]
    q, k, v = _qkv(gen, (Bt, T, 8, 64), (Bt, T, 8, 64), dt)
    rows["whisper_encoder_train"] = _flash_main_shape(q, k, v, no_mask, "whisper encoder train")
    rows["whisper_encoder_train"]["gradients"] = _flash_gradients(gen, q, k, v, no_mask)
    q = _rand(gen, (Bt, St, 8, 64), dt, 2.0)
    rows["whisper_cross_train"] = _flash_main_shape(q, k, v, no_mask, "whisper cross-attention train")
    rows["whisper_cross_train"]["gradients"] = _flash_gradients(gen, q, k, v, no_mask)
    # the dense family's sequence-parallel shapes: the dist phase's (data,
    # model) = (2, 2) train step (4 sequences a data rank, 128 rows a model
    # rank against 256 keys, both ranks), and a model rank's share of
    # prefill_32k on (16, 16) (2 sequences, 2048 rows against 32768 keys; the
    # first rank and the last)
    sp = {f"train_q{st}": _flash_sp_shape(gen, 4, 128, 256, st, f"train q_start {st}") for st in (0, 128)}
    sp.update({f"prefill_32k_q{st}": _flash_sp_shape(gen, 2, 2048, 32768, st, f"prefill_32k q_start {st}")
               for st in (0, 30720)})
    # decode on the model axis: a rank's block of the cache with the
    # log-sum-exp output, at decode_32k on (16, 16) (8 sequences a rank,
    # blocks of 2048; granite-8b's last block at the cell's last position,
    # paligemma-3b's first block, which holds its prefix, 33023 positions
    # before the query) and at the dist phase's granite-8b request (2
    # sequences a rank, blocks of 512, at decode's first step: the first
    # block, the whole prompt, and the second, its first key only)
    blocks = {"granite_decode_32k": _flash_block_shape(gen, 8, 32, 8, 128, 2048, 2047, 0, "granite-8b decode_32k"),
              "paligemma_decode_32k": _flash_block_shape(gen, 8, 8, 1, 256, 2064, 33023, 256,
                                                         "paligemma-3b decode_32k, block 0"),
              "dist_granite_block0": _flash_block_shape(gen, 2, 32, 8, 128, 512, 512, 0,
                                                        "granite-8b dist request, block 0"),
              "dist_granite": _flash_block_shape(gen, 2, 32, 8, 128, 512, 0, 0, "granite-8b dist request, block 1")}
    # whisper-base's cross-attention on the model axis, the dist request on
    # (data, model) = (2, 2) (2 sequences a rank): prefill, the rank's 32
    # decoder rows with every head (its weights gathered) over all 1536
    # frames (the encoder's output gathered); decode, the rank's 4 whole
    # heads of 8 over every frame
    wh = next(r for r in DIST_FAMILIES["runs"] if r["arch"] == "whisper-base")["serve"][0]
    Bw = wh["batch"] // 2
    _, k_w, v_w = _qkv(gen, (Bw, 1, 8, D), (Bw, T, 8, D), dt)
    cross = {"prefill": _flash_main_shape(_rand(gen, (Bw, wh["prompt_len"] // 2, 8, D), dt, 2.0), k_w, v_w, no_mask,
                                          "whisper cross-attention prefill on the model axis"),
             "decode": _flash_main_shape(_rand(gen, (Bw, 1, 4, D), dt, 2.0), k_w[:, :, :4].contiguous(),
                                         v_w[:, :, :4].contiguous(), no_mask,
                                         "whisper cross-attention decode on the model axis")}
    for row in cross.values():
        row["request_launches"] = None          # filled in from the dist phase's request
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:125",
        "launches": None,            # filled in from the serve and train phases' runs
        **rows["prefill"],
        "decode": rows["decode"],
        "mixtral_prefill": rows["mixtral_prefill"],
        "mixtral_decode": rows["mixtral_decode"],
        "zamba2_prefill": rows["zamba2_prefill"],
        "zamba2_decode": rows["zamba2_decode"],
        "paligemma_prefill": rows["paligemma_prefill"],
        "paligemma_decode": rows["paligemma_decode"],
        "whisper_encoder": rows["whisper_encoder"],
        "whisper_cross_prefill": rows["whisper_cross_prefill"],
        "whisper_cross_decode": rows["whisper_cross_decode"],
        "train": rows["train"],
        "paligemma_train": rows["paligemma_train"],
        "whisper_encoder_train": rows["whisper_encoder_train"],
        "whisper_cross_train": rows["whisper_cross_train"],
        "backward": _flash_bwd_rows(),
        "sequence_parallel": sp,
        "model_axis_decode": blocks,
        "model_axis_whisper_cross": cross,
        "test_cases": len(cases),
        "test_max_abs_err": {"float32": worst[torch.float32], "bfloat16": worst[torch.bfloat16]},
        "test_max_err_of_limit": {"float32": worst_of_limit[torch.float32],
                                  "bfloat16": worst_of_limit[torch.bfloat16]},
    }


def _one_hot_disp(gen, B, T, E, C, dtype) -> torch.Tensor:
    """Random routing as the reference's kernel test draws it: each token to
    one expert, in arrival order, overflow beyond C dropped."""
    idx = torch.randint(0, E, (B, T), generator=gen, device="cuda")
    onehot = torch.nn.functional.one_hot(idx, E)                      # (B, T, E)
    pos = torch.cumsum(onehot, dim=1) - onehot                        # slot in the expert
    slot = (pos * onehot).sum(-1)                                     # (B, T)
    disp = torch.zeros((B, T, E, C), device="cuda", dtype=dtype)
    b, t = torch.nonzero(slot < C, as_tuple=True)
    disp[b, t, idx[b, t], slot[b, t]] = 1
    return disp


def _moe_cases():
    """(B, T, E, C, D, dtype, dense) over the reference's hypothesis shapes
    (E in {2, 4, 8, 16}, C in [16, 64], T = 128, D = 32), ragged T, the
    batched form, and dense weights (the general contract)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for E in (2, 4, 8, 16):
        for C in (16, 40, 64):
            for dt in (f32, bf16):
                cases.append((1, 128, E, C, 32, dt, False))
    for T in (1, 77, 200):
        for dt in (f32, bf16):
            cases.append((1, T, 8, 24, 32, dt, False))
            cases.append((4, T, 8, 20, 128, dt, False))
    for B, T, E, C, D in [(1, 128, 8, 32, 32), (4, 77, 4, 16, 128), (2, 200, 8, 40, 6144), (3, 1, 8, 1, 96)]:
        for dt in (f32, bf16):
            cases.append((B, T, E, C, D, dt, True))
    return cases


def _moe_row(gen) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_dispatch import moe_dispatch_plain
    from repro_torch.kernels.ref import moe_dispatch_ref
    from repro_torch.models import moe

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_of_limit = dict(worst)
    cases = _moe_cases()
    for B, T, E, C, D, dt, dense in cases:
        x = _rand(gen, (B, T, D), dt, 1.0)
        # dense: weights of size 1/sqrt(T), so the outputs are of order 1
        disp = _rand(gen, (B, T, E, C), dt, T ** -0.5) if dense else _one_hot_disp(gen, B, T, E, C, dt)
        args = (disp[0], x[0]) if B == 1 else (disp, x)      # the reference's 3-D form, and batched
        o = ops.moe_dispatch(*args)
        torch.cuda.synchronize()
        r = moe_dispatch_plain(*args)
        torch.cuda.synchronize()
        oracle = moe_dispatch_ref(*args)
        if dense:
            err, of_limit = _excess(o, r, dt)
            _, ref_of_limit = _excess(r, oracle, dt)
            bad = not max(of_limit, ref_of_limit) <= 1.0
        else:
            # one term times 1.0, then zeros: the same bits, oracle included
            err, of_limit = _excess(o, r, dt)
            bad = not (torch.equal(o, r) and torch.equal(r, oracle))
        if bad or not torch.isfinite(o.float()).all():
            raise SystemExit(f"moe_dispatch disagrees with its plain version or the float64 oracle: "
                             f"{(B, T, E, C, D, dt, dense)} max_abs_err={err} ({of_limit} of its limit)")
        worst[dt] = max(worst[dt], err)
        worst_of_limit[dt] = max(worst_of_limit[dt], of_limit)

    # the main path's shapes: the routing of mixtral's MoE layers (8 experts,
    # top-2, capacity factor 1.25) on random activations and router
    cfg = moe.MoEConfig(n_experts=8, topk=2, d_ff=16384, strategy="expert_tp")
    B, D, dt = MIXTRAL["batch"], 6144, torch.bfloat16
    router = _rand(gen, (D, cfg.n_experts), dt, D ** -0.5)
    rows = {}
    for name, S in (("prefill", MIXTRAL["prompt_len"]), ("decode", 1)):
        x = _rand(gen, (B, S, D), dt, 1.0)
        C = cfg.capacity(S)
        disp, _ = moe.dispatch_tensors(moe.route(x, router, cfg), C, dt)
        o = ops.moe_dispatch(disp, x)
        torch.cuda.synchronize()
        r = moe_dispatch_plain(disp, x)

        def library():
            return torch.einsum("bsec,bsd->ebcd", disp, x)

        if not (torch.equal(o, r) and torch.equal(o, library()) and torch.equal(o, moe_dispatch_ref(disp, x))):
            raise SystemExit(f"moe_dispatch at the {name} shape is not bit-equal to its plain "
                             f"version, the library call and the float64 oracle: max_abs_err="
                             f"{(o.float() - r.float()).abs().max().item()}")
        # bytes: disp and x read once, out written once; operations: one
        # multiply-add per nonzero weight and column
        nbytes = (disp.numel() + x.numel() + o.numel()) * x.element_size()
        flops = 2 * int((disp != 0).sum()) * D
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
        ms, call_ms = time_ms(lambda: ops.moe_dispatch(disp, x))
        rows[name] = {
            "shape": f"disp{tuple(disp.shape)} x{tuple(x.shape)} {str(dt).split('.')[-1]}",
            "max_abs_err": (o.float() - r.float()).abs().max().item(),
            "kept_slots": int((disp != 0).sum()), "dropped": int(B * S * cfg.topk - (disp != 0).sum()),
            "ms": ms,
            "call_ms": call_ms,
            "plain_ms": time_ms(lambda: moe_dispatch_plain(disp, x))[0],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(library)[0],
        }
    # a model rank's token share of a sequence with the whole sequence's
    # capacity: the dist phase's mixtral-8x22b request on (2, 2) (2 sequences
    # a data rank, the second model rank's 256 of 512 tokens, C = 160, its
    # slots after the first rank's), routed over the whole sequence
    x = _rand(gen, (2, MIXTRAL["prompt_len"], D), dt, 1.0)
    C = cfg.capacity(MIXTRAL["prompt_len"])
    disp, _ = moe.dispatch_tensors(moe.route(x, router, cfg), C, dt)
    half = MIXTRAL["prompt_len"] // 2
    disp, x = disp[:, half:].contiguous(), x[:, half:].contiguous()
    o = ops.moe_dispatch(disp, x)
    torch.cuda.synchronize()

    def share_library():
        return torch.einsum("bsec,bsd->ebcd", disp, x)

    if not (torch.equal(o, moe_dispatch_plain(disp, x)) and torch.equal(o, share_library())):
        raise SystemExit("moe_dispatch at a model rank's token share is not bit-equal to its plain version "
                         "and the library call")
    nbytes = (disp.numel() + x.numel() + o.numel()) * x.element_size()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * int((disp != 0).sum()) * D / PEAK_FLOPS[dt]
    ms, call_ms = time_ms(lambda: ops.moe_dispatch(disp, x))
    rows["model_axis_share"] = {
        "shape": f"disp{tuple(disp.shape)} x{tuple(x.shape)} bf16 (tokens {half}-{2 * half - 1} of "
                 f"{2 * half}, C = {C} of the whole sequence)",
        "max_abs_err": 0.0, "kept_slots": int((disp != 0).sum()), "ms": ms, "call_ms": call_ms,
        "plain_ms": time_ms(lambda: moe_dispatch_plain(disp, x))[0],
        "bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": time_ms(share_library)[0]}
    # mixtral-8x22b's training step: batch 8, seq 256, x requires grad, disp
    # (the routing's one-hots) does not
    Bt, St = TRAIN_FAMILY["batch"], TRAIN_FAMILY["seq"]
    x = _rand(gen, (Bt, St, D), dt, 1.0)
    disp, _ = moe.dispatch_tensors(moe.route(x, router, cfg), cfg.capacity(St), dt)
    nbytes = (disp.numel() + x.numel() + cfg.n_experts * Bt * cfg.capacity(St) * D) * x.element_size()
    rows["train"] = _under_autograd("moe_dispatch", ops.moe_dispatch, moe_dispatch_plain, [disp, x], [1],
                                    nbytes, 2 * int((disp != 0).sum()) * D, dt,
                                    lambda o, p: {"vs_plain": _bit_equal(o, p)})

    def train_library():
        return torch.einsum("bsec,bsd->ebcd", disp, x)

    if not torch.equal(ops.moe_dispatch(disp, x), train_library()):
        raise SystemExit("moe_dispatch at the training shape is not bit-equal to the library call")
    rows["train"]["library_ms"] = time_ms(train_library)[0]
    return {
        "name": "moe_dispatch",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
        "replaces": "src/repro/kernels/moe_dispatch.py:61",
        "launches": None,            # filled in from the serve and train phases' runs
        **rows["prefill"],
        "decode": rows["decode"],
        "train": rows["train"],
        "model_axis_share": rows["model_axis_share"],
        "test_cases": len(cases),
        "test_max_abs_err": {"float32": worst[torch.float32], "bfloat16": worst[torch.bfloat16]},
        "test_max_err_of_limit": {"float32": worst_of_limit[torch.float32],
                                  "bfloat16": worst_of_limit[torch.bfloat16]},
    }


def _ssd_cases():
    """(B, S, H, P, N, chunk, dtype, kind) over the reference's test shapes,
    the strong-decay case, ragged S, a given initial state and the smoke
    widths; kind "strong": log_l = -13, "h0": with an initial state."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for dt in (f32, bf16):
        for B, S, H, P, N, chunk in [(1, 128, 2, 16, 16, 64), (2, 256, 4, 32, 16, 128),
                                     (1, 256, 1, 64, 64, 32)]:
            cases.append((B, S, H, P, N, chunk, dt, "randn"))
        cases.append((1, 256, 2, 16, 16, 128, dt, "strong"))
        for S in (1, 77, 200):
            cases.append((2, S, 3, 32, 16, 128, dt, "randn"))
            cases.append((1, S, 2, 64, 64, 64, dt, "h0"))
        cases.append((2, 256, 4, 32, 16, 128, dt, "h0"))
        cases.append((2, 256, 4, 64, 16, 128, dt, "randn"))     # zamba2 smoke: P 64, N 16, H 4
    return cases


def _ssd_inputs(gen, B, S, H, P, N, dt, kind):
    """As the reference's test draws them: x, B, C of scale 0.5 and
    log_l = -softplus(randn) in fp32 (-13 for "strong")."""
    xh, Bm, Cm = (_rand(gen, s, dt, 0.5) for s in [(B, S, H, P), (B, S, N), (B, S, N)])
    if kind == "strong":
        log_l = torch.full((B, S, H), -13.0, device="cuda")
    else:
        log_l = -torch.nn.functional.softplus(_rand(gen, (B, S, H), torch.float32, 1.0))
    h0 = _rand(gen, (B, H, P, N), torch.float32, 0.5) if kind == "h0" else None
    return xh, log_l, Bm, Cm, h0


def _ssd_row(gen) -> dict:
    """The kernel against ``ssd_scan_plain``: y and h in fp32 within 5e-5
    (the reference test's tolerance), y in bf16 within one ulp of the element
    (both are fp32 inside and round once), h of bf16 runs within 5e-5; the
    plain version held to the float64 oracle ``ssd_scan_ref`` alike."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_chunked, ssd_scan_plain

    def excess(y, h, yr, hr, dt, bf16_abs=1e-5):
        ey, ry = _excess(y, yr, dt, f32_limit=5e-5, bf16_abs=bf16_abs)
        eh, rh = _excess(h, hr, torch.float32, f32_limit=5e-5)
        return max(ey, eh), max(ry, rh)

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_of_limit = dict(worst)
    cases = _ssd_cases()
    for B, S, H, P, N, chunk, dt, kind in cases:
        xh, log_l, Bm, Cm, h0 = _ssd_inputs(gen, B, S, H, P, N, dt, kind)
        y, h = ops.ssd_scan(xh, log_l, Bm, Cm, chunk=chunk, h0=h0)
        torch.cuda.synchronize()
        yp, hp = ssd_scan_plain(xh, log_l, Bm, Cm, chunk=chunk, h0=h0)
        err, of_limit = excess(y, h, yp, hp, dt)
        ref_err, ref_of_limit = excess(yp, hp, *ssd_scan_ref(xh, log_l, Bm, Cm, h0=h0), dt)
        finite = bool(torch.isfinite(y.float()).all() and torch.isfinite(h).all())
        if not max(of_limit, ref_of_limit) <= 1.0 or not finite:
            raise SystemExit(f"ssd_scan disagrees with its plain version: {(B, S, H, P, N, chunk, dt, kind)} "
                             f"max_abs_err={err}, {of_limit} of its limit, finite {finite}; plain vs "
                             f"the float64 oracle {ref_err}, {ref_of_limit} of its limit")
        worst[dt] = max(worst[dt], err)
        worst_of_limit[dt] = max(worst_of_limit[dt], of_limit)

    # the main path's shape, in the model's layout: xh the dt-weighted heads,
    # Bm and Cm slices of the (B, S, d_inner + 2N) conv output, read in place
    B, S, H, P, N, dt = ZAMBA["batch"], ZAMBA["prompt_len"], 64, 64, 64, torch.bfloat16
    xh = _rand(gen, (B, S, H, P), dt, 0.5)
    conv = _rand(gen, (B, S, H * P + 2 * N), dt, 0.5)
    Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    log_l = -torch.nn.functional.softplus(_rand(gen, (B, S, H), torch.float32, 1.0))
    y, h = ops.ssd_scan(xh, log_l, Bm, Cm, chunk=128)
    torch.cuda.synchronize()
    yp, hp = ssd_scan_plain(xh, log_l, Bm, Cm, chunk=128)
    err, of_limit = excess(y, h, yp, hp, dt)
    ref_err, ref_of_limit = excess(y, h, *ssd_scan_ref(xh, log_l, Bm, Cm), dt)
    if not max(of_limit, ref_of_limit) <= 1.0:
        raise SystemExit(f"ssd_scan at the main path's shape: max_abs_err={err} vs plain ({of_limit} "
                         f"of its limit), {ref_err} vs the float64 oracle ({ref_of_limit})")
    nbytes, flops, pairs = _ssd_work(xh, log_l, Bm, Cm, y, h, 128)
    # the first design's fp32 FMA (C B^T again in every head's block) on the
    # CUDA cores, the floor the tensor-core design is held below
    first_design_flops = flops + 2 * B * (H - 1) * pairs * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
    ms, call_ms = time_ms(lambda: ops.ssd_scan(xh, log_l, Bm, Cm, chunk=128))
    # zamba2-1.2b's training step: batch 8, seq 256, every input requires grad.
    # The kernel is held to the float64 oracle at the limits above; against
    # the plain version the bf16 limit's absolute term is the fp32 limit
    # (5e-5, as rwkv6_scan's row has it): at this shape the plain version
    # itself lies 1.35 of the 1e-5 limit from the oracle, at an element near
    # zero that carries its fp32 sums' error
    Bt, St = TRAIN_FAMILY["batch"], TRAIN_FAMILY["seq"]
    conv_t = _rand(gen, (Bt, St, H * P + 2 * N), dt, 0.5)
    inputs = [_rand(gen, (Bt, St, H, P), dt, 0.5),
              -torch.nn.functional.softplus(_rand(gen, (Bt, St, H), torch.float32, 1.0)),
              conv_t[..., H * P:H * P + N], conv_t[..., H * P + N:]]
    with torch.no_grad():
        y_t, h_t = ops.ssd_scan(*inputs, chunk=128)
    train_row = _under_autograd("ssd_scan", lambda *t: ops.ssd_scan(*t, chunk=128),
                                lambda *t: ssd_scan_plain(*t, chunk=128), inputs, [0, 1, 2, 3],
                                *_ssd_work(*inputs, y_t, h_t, 128)[:2], dt,
                                lambda o, p: {"vs_oracle": excess(*o, *ssd_scan_ref(*inputs), dt),
                                              "vs_plain": excess(*o, *p, dt, bf16_abs=5e-5)},
                                recomputed=lambda *t: ssd_scan_chunked(*t, chunk=128))
    return {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:81",
        "launches": None,            # filled in from the serve and train phases' runs
        "shape": f"xh{tuple(xh.shape)} log_l{tuple(log_l.shape)} B/C{tuple(Bm.shape)} chunk 128 bf16",
        "max_abs_err": err,
        "err_of_limit": of_limit,
        "max_abs_plain": yp.float().abs().max().item(),
        "ms": ms,
        "call_ms": call_ms,
        "plain_ms": time_ms(lambda: ssd_scan_plain(xh, log_l, Bm, Cm, chunk=128))[0],
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes,
        "flops": flops,
        "first_design_fma_floor_ms": first_design_flops / PEAK_FLOPS[torch.float32] * 1e3,
        "library_ms": None,
        "library_note": "no single PyTorch call computes a chunked scan with a carried state",
        "train": train_row,
        "model_axis_shares": _ssd_shares(gen, excess),
        "granite_hybrid_train": _ssd_granite_row(excess),
        "test_cases": len(cases),
        "test_max_abs_err": {"float32": worst[torch.float32], "bfloat16": worst[torch.bfloat16]},
        "test_max_err_of_limit": {"float32": worst_of_limit[torch.float32],
                                  "bfloat16": worst_of_limit[torch.bfloat16]},
    }


def _ssd_work(xh, log_l, Bm, Cm, y, h, chunk) -> tuple[int, int, int]:
    """(bytes, operations, causal pairs) of one scan: x, log_l, B, C read
    once, y and h written once; the causal pairs' scores once a batch row,
    att x, C h^T and the state update."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (xh, log_l, Bm, Cm, y, h))
    pairs = sum(q * (q + 1) // 2 for q in [min(chunk, S - s0) for s0 in range(0, S, chunk)])
    flops = 2 * B * pairs * N + 2 * B * H * pairs * P + 4 * B * S * H * P * N
    return nbytes, flops, pairs


def _ssd_granite_row(excess) -> dict:
    """``ssd_scan`` at granite-4.0-h-small's training shape, state size 128:
    xh (2, 4096, 128, 64), B/C (2, 4096, 128) slices of the conv output,
    chunk 128, bf16 (the tensor-core design's one-head-a-block instance).
    Held against the float64 oracle at the rows' limits (one bf16 ulp plus
    1e-5) and against the plain version with the training row's absolute
    term, 5e-5: at this shape the plain version's fp32 sums over 128
    columns of N lie up to 1.3 of the 1e-5 term from the oracle at elements
    near zero.  Timed beside the plain version; its own generator, so the
    other rows keep their draws."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_plain

    dt, (B, S, H, P, N) = torch.bfloat16, (2, 4096, 128, 64, 128)
    gen = torch.Generator(device="cuda").manual_seed(32)
    conv = _rand(gen, (B, S, H * P + 2 * N), dt, 0.5)
    xh = _rand(gen, (B, S, H, P), dt, 0.5)
    log_l = -torch.nn.functional.softplus(_rand(gen, (B, S, H), torch.float32, 1.0))
    Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    row = _share_row("ssd_scan", lambda: ops.ssd_scan(xh, log_l, Bm, Cm, chunk=128),
                     lambda: ssd_scan_plain(xh, log_l, Bm, Cm, chunk=128), [list(xh.shape), list(Bm.shape)],
                     lambda y, h: _ssd_work(xh, log_l, Bm, Cm, y, h, 128), dt,
                     lambda *a: excess(*a, dt, bf16_abs=5e-5), H * B, f"granite-4.0-h-small train_4k: xh{tuple(xh.shape)} "
                     f"B/C{tuple(Bm.shape)}")
    y, h = ops.ssd_scan(xh, log_l, Bm, Cm, chunk=128)
    err, of_limit = excess(y, h, *ssd_scan_ref(xh, log_l, Bm, Cm), dt)
    if not of_limit <= 1.0:
        raise SystemExit(f"ssd_scan at granite-4.0-h-small's shape: max_abs_err={err} vs the float64 oracle, "
                         f"{of_limit} of its limit")
    plain_err, plain_of_limit = excess(*ssd_scan_plain(xh, log_l, Bm, Cm, chunk=128),
                                       *ssd_scan_ref(xh, log_l, Bm, Cm), dt)
    row.update(vs_oracle={"max_abs_err": err, "err_of_limit": of_limit},
               plain_vs_oracle={"max_abs_err": plain_err, "err_of_limit": plain_of_limit})
    return row


def _share_row(name: str, call, plain, outputs, work, dt, excess, grid: int, where: str) -> dict:
    """A scan at a model rank's share of the heads: held against its plain
    version (``excess``, the row's limits), timed beside it (the plain
    version's scan loops in Python: 3 calls where the sequence is long) and
    the bound; ``grid`` the kernel's blocks, against the card's 132 SMs."""
    o = call()
    torch.cuda.synchronize()
    p = plain()
    err, of_limit = excess(*o, *p)
    if not of_limit <= 1.0:
        raise SystemExit(f"{name} at {where}: max_abs_err={err} vs plain, {of_limit} of its limit")
    nbytes, flops = work(*o)[:2]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
    ms, call_ms = time_ms(call, iters=10, warmup=2)
    long = outputs[0][1] > 4096
    return {"where": where, "shape": outputs, "max_abs_err": err, "err_of_limit": of_limit, "ms": ms,
            "call_ms": call_ms, "plain_ms": time_ms(plain, iters=3 if long else 10, warmup=1)[0],
            "bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "grid_blocks": grid, "sms": 132, "library_ms": None}


def _rwkv_shares(gen, excess) -> dict:
    """``rwkv6_scan`` at a model rank's heads: the dist request's share on
    (data, model) = (2, 2) (2 sequences of 512, 16 of 32 heads) and a rank's
    share of prefill_32k on (16, 16) (2 sequences of 32768, 2 heads); r/k/v
    as the column-parallel products give them, ``bonus_u`` sliced to the
    rank's channels.  The grid is (heads, batch): 4 blocks at the
    production share."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain

    dt, N, out = torch.bfloat16, 64, {}
    for key, (B, S, H) in {"dist_2x2": (2, 512, 16), "prefill_32k_16x16": (2, 32768, 2)}.items():
        r, k, v = (_rand(gen, (B, S, H * N), dt, 0.5).view(B, S, H, N) for _ in range(3))
        w = torch.sigmoid(_rand(gen, (B, S, H, N), torch.float32, 1.0)) * 0.98 + 0.01
        u = _rand(gen, (32 * N,), dt, 0.3)[:H * N].view(H, N)
        out[key] = _share_row("rwkv6_scan", lambda: ops.rwkv6_scan(r, k, v, w, u, chunk=128),
                              lambda: rwkv6_scan_plain(r, k, v, w, u, chunk=128), [list(r.shape)],
                              lambda y, st: _rwkv_work(r, k, v, w, u, y, st, 128), dt,
                              lambda *a: excess(*a, dt, 5e-5), H * B,
                              f"{key}: r/k/v{tuple(r.shape)}")
        del r, k, v, w
    out["dist_2x2"]["launches"] = None          # filled in from the dist phase's request
    return out


def _ssd_shares(gen, excess) -> dict:
    """``ssd_scan`` at a model rank's heads: the dist request's share on
    (data, model) = (2, 2) (2 sequences of 512, 32 of 64 heads) and a rank's
    share of prefill_32k on (16, 16) (2 sequences of 32768, 4 heads); B and
    C whole (N = 64), slices of the rank's conv output (its d_inner
    channels and the 2N of B and C) as the split leaves them.  The grid is
    (heads / 2, batch): 4 blocks at the production share.
    At one fixed draw of the prefill_32k share the plain version itself
    strays past the row's limit from the float64 oracle ``ssd_scan_ref``:
    there the kernel is held against the oracle, and its distance from the
    plain version is reported beside the plain version's from the oracle."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_plain

    dt, P, N, out = torch.bfloat16, 64, 64, {}
    shares = {"dist_2x2": (2, 512, 32), "prefill_32k_16x16": (2, 32768, 4)}

    def draw(g, B, S, H):
        conv = _rand(g, (B, S, H * P + 2 * N), dt, 0.5)
        xh = _rand(g, (B, S, H, P), dt, 0.5)
        log_l = -torch.nn.functional.softplus(_rand(g, (B, S, H), torch.float32, 1.0))
        return xh, log_l, conv[..., H * P:H * P + N], conv[..., H * P + N:]

    for key, (B, S, H) in shares.items():
        xh, log_l, Bm, Cm = draw(gen, B, S, H)
        out[key] = _share_row("ssd_scan", lambda: ops.ssd_scan(xh, log_l, Bm, Cm, chunk=128),
                              lambda: ssd_scan_plain(xh, log_l, Bm, Cm, chunk=128), [list(xh.shape), list(Bm.shape)],
                              lambda y, h: _ssd_work(xh, log_l, Bm, Cm, y, h, 128), dt,
                              lambda *a: excess(*a, dt), -(-H // 2) * B,
                              f"{key}: xh{tuple(xh.shape)} B/C{tuple(Bm.shape)}")
        del xh, log_l, Bm, Cm
    out["dist_2x2"]["launches"] = None          # filled in from the dist phase's request

    # The fixed draw: this loop's draws from a CUDA generator of seed 0 at
    # philox offset 6016 (on an H100 with PyTorch 2.11).  At y[0, 13667, 1, 6]
    # the oracle reads 6.343e-4, the kernel 6.332e-4 (the nearest bf16) and
    # the plain version 6.180e-4 (fp32 6.193e-4, its cumulative log decays in
    # fp32): the plain version lies 1.18 of the limit from the oracle there,
    # the kernel 1.029 from the plain version and at most half a bf16 ulp
    # (plus 1e-5) from the oracle anywhere.
    fixed = torch.Generator(device="cuda").manual_seed(0)
    fixed.set_offset(6016)
    draw(fixed, *shares["dist_2x2"])
    xh, log_l, Bm, Cm = draw(fixed, *shares["prefill_32k_16x16"])
    y, h = ops.ssd_scan(xh, log_l, Bm, Cm, chunk=128)
    yp, hp = ssd_scan_plain(xh, log_l, Bm, Cm, chunk=128)
    yo, ho = ssd_scan_ref(xh, log_l, Bm, Cm)
    (err, of_limit), vs_plain, plain_vs_oracle = (excess(*a, dt) for a in ((y, h, yo, ho), (y, h, yp, hp),
                                                                          (yp, hp, yo, ho)))
    if not of_limit <= 1.0:
        raise SystemExit(f"ssd_scan at the fixed draw of prefill_32k_16x16: max_abs_err={err} vs the float64 "
                         f"oracle, {of_limit} of its limit")
    out["prefill_32k_16x16_fixed_draw"] = {
        "draw": "seed 0, philox offset 6016", "max_abs_err": err, "err_of_limit": of_limit,
        "vs_plain": {"max_abs_err": vs_plain[0], "err_of_limit": vs_plain[1]},
        "plain_vs_oracle": {"max_abs_err": plain_vs_oracle[0], "err_of_limit": plain_vs_oracle[1]}}
    return out


def _rwkv_cases():
    """(B, S, H, N, chunk, dtype, kind) over the reference's test shapes, the
    extreme-decay case, ragged S, a given initial state and the smoke widths
    (head_dim 32, chunk 16); kind "extreme": w = 1e-6, "s0": with an initial
    state."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for dt in (f32, bf16):
        for B, S, H, N, chunk in [(1, 64, 1, 16, 32), (2, 128, 2, 32, 32), (1, 256, 4, 64, 128)]:
            cases.append((B, S, H, N, chunk, dt, "randn"))
        cases.append((1, 128, 1, 16, 64, dt, "extreme"))
        cases.append((1, 128, 1, 16, 128, dt, "extreme"))       # one chunk: cum reaches -1768
        for S in (1, 77, 200):
            cases.append((2, S, 3, 32, 128, dt, "randn"))
            cases.append((1, S, 2, 64, 64, dt, "s0"))
        cases.append((2, 256, 4, 32, 128, dt, "s0"))
        cases.append((2, 256, 4, 32, 16, dt, "randn"))          # rwkv6 smoke: N 32, chunk 16
        # the tensor-core design's edges: partial 16-row tiles, chunks of
        # fewer than 16 rows, N 16 to 64 (12: rows that are no 16-byte
        # multiple), a chunk that is no multiple of 16, the extreme decay
        # over whole chunks, r, k, v as views of one wider tensor
        for B, S, H, N, chunk, kind in [(2, 200, 3, 64, 128, "s0"), (1, 77, 2, 48, 64, "randn"),
                                        (2, 9, 2, 32, 128, "randn"), (1, 140, 2, 16, 128, "s0"),
                                        (2, 150, 2, 48, 64, "s0"), (1, 100, 2, 16, 100, "randn"),
                                        (1, 50, 2, 12, 32, "randn"), (2, 256, 2, 64, 128, "extreme"),
                                        (2, 300, 4, 64, 128, "view"), (2, 130, 3, 32, 128, "unaligned")]:
            cases.append((B, S, H, N, chunk, dt, kind))
    return cases


def _rwkv_inputs(gen, B, S, H, N, dt, kind):
    """As the reference's test draws them: r, k, v of scale 0.5, w =
    0.98 sigmoid(randn) + 0.01 in fp32 (1e-6 for "extreme"), u of scale 0.3;
    r, k, v slices of one (B, S, H, 3N) tensor for "view", of (B, S, H, 3N +
    4) from its fifth element for "unaligned" (rows no 16-byte run)."""
    if kind in ("view", "unaligned"):
        off = 4 if kind == "unaligned" else 0
        wide = _rand(gen, (B, S, H, 3 * N + off), dt, 0.5)
        r, k, v = (wide[..., off + i * N:off + (i + 1) * N] for i in range(3))
    else:
        r, k, v = (_rand(gen, (B, S, H, N), dt, 0.5) for _ in range(3))
    if kind == "extreme":
        w = torch.full((B, S, H, N), 1e-6, device="cuda")
    else:
        w = torch.sigmoid(_rand(gen, (B, S, H, N), torch.float32, 1.0)) * 0.98 + 0.01
    u = _rand(gen, (H, N), dt, 0.3)
    s0 = _rand(gen, (B, H, N, N), torch.float32, 0.5) if kind == "s0" else None
    return r, k, v, w, u, s0


def _rwkv_row(gen) -> dict:
    """The kernel against ``rwkv6_scan_plain`` and the float64 oracle
    ``rwkv6_scan_ref``, each element: y and the state in fp32 within 5e-5
    (the reference test's tolerance), y in bf16 within one ulp of the
    element (both are fp32 inside and round once), the state of bf16 runs
    within 5e-5; the plain version held to the oracle alike.  The bf16 limit's
    absolute term is the fp32 limit (5e-5), not 1e-5: the outputs reach 16 at
    head_dim 64, where the fp32 sums beneath differ by up to 5e-5, and an
    element near zero carries that whole difference.  The extreme decay
    (w = 1e-6) is held at 5e-4, the reference test's tolerance for it: the
    plain version keeps the reference's fp32 (cum_i - l_i) - cum_j, whose
    rounding at |cum| ~ 1768 moves the weight-one terms by ~1e-4."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rwkv6_scan_ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain

    def excess(y, s, yr, sr, dt, f32_limit):
        ey, ry = _excess(y, yr, dt, f32_limit=f32_limit, bf16_abs=f32_limit)
        es, rs = _excess(s, sr, torch.float32, f32_limit=f32_limit)
        return max(ey, es), max(ry, rs)

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_of_limit = dict(worst)
    cases = _rwkv_cases()
    for B, S, H, N, chunk, dt, kind in cases:
        r, k, v, w, u, s0 = _rwkv_inputs(gen, B, S, H, N, dt, kind)
        y, s = ops.rwkv6_scan(r, k, v, w, u, chunk=chunk, s0=s0)
        torch.cuda.synchronize()
        yp, sp = rwkv6_scan_plain(r, k, v, w, u, chunk=chunk, s0=s0)
        yo, so = rwkv6_scan_ref(r, k, v, w, u, s0=s0)
        lim = 5e-4 if kind == "extreme" else 5e-5
        err, of_limit = excess(y, s, yp, sp, dt, lim)
        oracle_err, oracle_of_limit = excess(y, s, yo, so, dt, lim)
        plain_err, plain_of_limit = excess(yp, sp, yo, so, dt, lim)
        finite = bool(torch.isfinite(y.float()).all() and torch.isfinite(s).all())
        if not max(of_limit, oracle_of_limit, plain_of_limit) <= 1.0 or not finite:
            raise SystemExit(f"rwkv6_scan disagrees: {(B, S, H, N, chunk, dt, kind)} vs plain "
                             f"max_abs_err={err} ({of_limit} of its limit), vs the float64 oracle "
                             f"{oracle_err} ({oracle_of_limit}), plain vs the oracle {plain_err} "
                             f"({plain_of_limit}), finite {finite}")
        worst[dt] = max(worst[dt], err)
        worst_of_limit[dt] = max(worst_of_limit[dt], of_limit, oracle_of_limit)

    # the main path's shape, in the model's layout: r, k, v views (B, S, H, N)
    # of the (B, S, D) projections, w fp32, u (H, N) in the model's type
    B, S, H, N, Q, dt = RWKV["batch"], RWKV["prompt_len"], 32, 64, 128, torch.bfloat16
    r, k, v = (_rand(gen, (B, S, H * N), dt, 0.5).view(B, S, H, N) for _ in range(3))
    w = torch.sigmoid(_rand(gen, (B, S, H, N), torch.float32, 1.0)) * 0.98 + 0.01
    u = _rand(gen, (H, N), dt, 0.3)
    y, s = ops.rwkv6_scan(r, k, v, w, u, chunk=Q)
    torch.cuda.synchronize()
    yp, sp = rwkv6_scan_plain(r, k, v, w, u, chunk=Q)
    err, of_limit = excess(y, s, yp, sp, dt, 5e-5)
    oracle_err, oracle_of_limit = excess(y, s, *rwkv6_scan_ref(r, k, v, w, u), dt, 5e-5)
    if not max(of_limit, oracle_of_limit) <= 1.0:
        raise SystemExit(f"rwkv6_scan at the main path's shape: max_abs_err={err} vs plain ({of_limit} "
                         f"of its limit), {oracle_err} vs the float64 oracle ({oracle_of_limit})")
    y2, s2 = ops.rwkv6_scan(r, k, v, w, u, chunk=Q)
    torch.cuda.synchronize()
    if not (torch.equal(y, y2) and torch.equal(s, s2)):
        raise SystemExit("rwkv6_scan at the main path's shape: two launches on the same inputs differ")
    # bytes: r, k, v, w, u read once, y and the state written once.  Operations
    # of the chunked form: per (i, j < i) pair and channel a decay-weighted
    # r k (3 flops) and att v (2), per row r' S and the state update (4 N^2)
    # and the bonus (4 N); its four products alone (scores, att v, r' S, the
    # state update: 4 N a pair, 4 N^2 a row) on the CUDA cores' fp32 FMA are
    # the floor of a design without tensor cores.  Exponentials of the
    # tensor-core design, a chunk and head: 120 pairs a channel on each
    # diagonal tile, the row scales of r (16 rows a tile) and of k (all 128
    # staged rows), 45 decays between tile edges a channel; the first
    # design's: one a pair and channel, two a row and channel, one a channel.
    nbytes, flops = _rwkv_work(r, k, v, w, u, y, s, Q)
    chunks = [min(Q, S - c0) for c0 in range(0, S, Q)]
    pairs = sum(q * (q - 1) // 2 for q in chunks)
    product_flops = B * H * (4 * N * pairs + 4 * N * N * S)
    tiles = [-(-q // 16) for q in chunks]
    exps = B * H * N * sum(nt * (120 + 16) + 128 + 45 for nt in tiles)
    first_design_exps = B * H * (N * pairs + 2 * S * N + N * len(chunks))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
    ms, call_ms = time_ms(lambda: ops.rwkv6_scan(r, k, v, w, u, chunk=Q))
    # the first design, which fp32 inputs still run, on the same data in fp32
    r32, k32, v32, u32 = (t.float() for t in (r, k, v, u))
    fma_fp32_ms = time_ms(lambda: ops.rwkv6_scan(r32, k32, v32, w, u32, chunk=Q))[0]
    # rwkv6-1.6b's training step: batch 8, seq 256, every input requires grad
    Bt, St = TRAIN_FAMILY["batch"], TRAIN_FAMILY["seq"]
    inputs = [_rand(gen, (Bt, St, H * N), dt, 0.5).view(Bt, St, H, N) for _ in range(3)]
    inputs += [torch.sigmoid(_rand(gen, (Bt, St, H, N), torch.float32, 1.0)) * 0.98 + 0.01, u]
    with torch.no_grad():
        y_t, s_t = ops.rwkv6_scan(*inputs, chunk=Q)
    train_row = _under_autograd("rwkv6_scan", lambda *t: ops.rwkv6_scan(*t, chunk=Q),
                                lambda *t: rwkv6_scan_plain(*t, chunk=Q), inputs, [0, 1, 2, 3, 4],
                                *_rwkv_work(*inputs, y_t, s_t, Q), dt,
                                lambda o, p: {"vs_oracle": excess(*o, *rwkv6_scan_ref(*inputs), dt, 5e-5),
                                              "vs_plain": excess(*o, *p, dt, 5e-5)})
    return {
        "name": "rwkv6_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:110",
        "launches": None,            # filled in from the serve and train phases' runs
        "shape": f"r/k/v{tuple(r.shape)} bf16 w fp32 u{tuple(u.shape)} chunk {Q}",
        "max_abs_err": err,
        "err_of_limit": of_limit,
        "oracle_err_of_limit": oracle_of_limit,
        "max_abs_plain": yp.float().abs().max().item(),
        "ms": ms,
        "call_ms": call_ms,
        "plain_ms": time_ms(lambda: rwkv6_scan_plain(r, k, v, w, u, chunk=Q))[0],
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes,
        "flops": flops,
        "ops_ms_fp32_cores": flops / PEAK_FLOPS[torch.float32] * 1e3,
        "products_fp32_fma_floor_ms": product_flops / PEAK_FLOPS[torch.float32] * 1e3,
        "exponentials": exps,
        "exp_ms_at_mufu_rate": exps / MUFU_EX2_PER_S * 1e3,
        "first_design_exponentials": first_design_exps,
        "first_design_exp_floor_ms": first_design_exps / MUFU_EX2_PER_S * 1e3,
        # the first design (fp32 inputs' kernel) on fp32 copies of the same inputs
        "first_design_ms": fma_fp32_ms,
        "deterministic": True,
        "library_ms": None,
        "library_note": "no single PyTorch call computes a chunked scan with a carried state",
        "train": train_row,
        "model_axis_shares": _rwkv_shares(gen, excess),
        "test_cases": len(cases),
        "test_max_abs_err": {"float32": worst[torch.float32], "bfloat16": worst[torch.bfloat16]},
        "test_max_err_of_limit": {"float32": worst_of_limit[torch.float32],
                                  "bfloat16": worst_of_limit[torch.bfloat16]},
    }


def _rwkv_work(r, k, v, w, u, y, s, Q) -> tuple[int, int]:
    """(bytes, operations) of one scan: r, k, v, w, u read once, y and the
    state written once; per (i, j < i) pair and channel a decay-weighted r k
    (3 flops) and att v (2), per row r' S and the state update (4 N^2) and
    the bonus (4 N)."""
    B, S, H, N = r.shape
    nbytes = sum(t.numel() * t.element_size() for t in (r, k, v, w, u, y, s))
    pairs = sum(q * (q - 1) // 2 for q in [min(Q, S - c0) for c0 in range(0, S, Q)])
    return nbytes, B * H * (5 * N * pairs + S * (4 * N * N + 4 * N))


def _leaf_sizes(harness) -> dict[str, int]:
    """Elements of each of a model's gradient leaves, in the order the port
    flattens its trees."""
    flat = {}

    def walk(tree, prefix):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], f"{prefix}{k}.")
            else:
                flat[prefix + k] = math.prod(tree[k].shape)

    walk(harness.param_specs(), "")
    return flat


def _ccu_cases():
    """(P, N, dtype, scaled, layout) over the reference test's shapes, int8
    with per-peer scales, ragged N, bf16, fp16 and fp32 peers, and views of
    a larger buffer (every other row; a column slice, rows not 16-byte
    aligned)."""
    f32, bf16, f16, i8 = torch.float32, torch.bfloat16, torch.float16, torch.int8
    cases = [(P, N, f32, False, "dense") for P, N in ((2, 512), (8, 2048), (16, 1024))]
    cases += [(4, 1024, i8, True, "dense")]
    for dt in (f32, bf16, f16, i8):
        for N in (1, 77, 1027, 4099):
            cases.append((3, N, dt, dt == i8, "dense"))
        cases.append((5, 4096, dt, True, "rows"))
        cases.append((5, 3001, dt, False, "cols"))
    return cases


def _ccu_row(gen) -> dict:
    """The kernel against ``ccu_reduce_plain``, bit for bit, on every case
    and at the main path's shapes (P = 1 and N of each of granite-8b's 12
    gradient leaves at 8 layers, int8 with its scale, as ``compress_grads``
    calls it), two runs bit-equal, and the reference test's shapes within its
    1e-5 of the float64 oracle.  Times: the 12 leaves of one training step
    summed (one launch each); bound: their bytes, P N elem + 4 N; library:
    ``torch.mul(bufs[0], scales)``, which at P = 1 computes the same values
    bit for bit (checked)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ccu_reduce import ccu_reduce_plain
    from repro_torch.kernels.ref import ccu_reduce_ref

    def draw(shape, dt):
        if dt == torch.int8:
            return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        return _rand(gen, shape, dt, 3.0)

    cases = _ccu_cases()
    for P, N, dt, scaled, layout in cases:
        shape = (2 * P, N) if layout == "rows" else (P, N + 13) if layout == "cols" else (P, N)
        bufs = draw(shape, dt)
        bufs = bufs[::2] if layout == "rows" else bufs[:, 5:5 + N] if layout == "cols" else bufs
        scales = torch.rand(P, generator=gen, device="cuda") * 1.5 + 0.5 if scaled else None
        o, o2 = ops.ccu_reduce(bufs, scales), ops.ccu_reduce(bufs, scales)
        torch.cuda.synchronize()
        r = ccu_reduce_plain(bufs, scales)
        oracle_err = (o - ccu_reduce_ref(bufs, scales)).abs().max().item()
        exact = torch.equal(o, r) and torch.equal(o, o2)
        if not exact or (dt == torch.float32 and not scaled and not oracle_err <= 1e-5):
            raise SystemExit(f"ccu_reduce disagrees: {(P, N, dt, scaled, layout)} bit-equal to plain and "
                             f"to itself {exact}, max |o - plain| {(o - r).abs().max().item()}, "
                             f"vs the float64 oracle {oracle_err}")

    from repro_torch.configs import load

    leaves = _leaf_sizes(load("granite-8b").clone(n_layers=TRAIN["n_layers"]))
    per_leaf, totals = {}, {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    nbytes_step = 0
    for name, N in leaves.items():
        q = draw((1, N), torch.int8)
        scale = torch.rand(1, generator=gen, device="cuda") * 1e-3
        o = ops.ccu_reduce(q, scale)
        torch.cuda.synchronize()
        if not (torch.equal(o, ccu_reduce_plain(q, scale)) and torch.equal(o, ops.ccu_reduce(q, scale))
                and torch.equal(o, torch.mul(q[0], scale))):
            raise SystemExit(f"ccu_reduce at the main path's leaf {name} (N = {N}) is not bit-equal "
                             f"to plain and to the library call")
        nbytes = q.numel() + 4 * N + 4
        ms, call_ms = time_ms(lambda: ops.ccu_reduce(q, scale))
        row = {"N": N, "ms": ms, "call_ms": call_ms,
               "plain_ms": time_ms(lambda: ccu_reduce_plain(q, scale))[0],
               "library_ms": time_ms(lambda: torch.mul(q[0], scale))[0],
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        per_leaf[name] = row
        for k in totals:
            totals[k] += row[k]
        nbytes_step += nbytes
        del q, o
        torch.cuda.empty_cache()
    largest = max(per_leaf, key=lambda k: per_leaf[k]["N"])
    return {
        "name": "ccu_reduce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ccu_reduce.cu",
        "replaces": "src/repro/kernels/ccu_reduce.py:64",
        "launches": None,            # filled in from the train phase's run
        "shape": f"one training step of granite-8b at {TRAIN['n_layers']} layers: {len(leaves)} launches, "
                 f"P = 1 int8 + scale, N = each gradient leaf",
        "max_abs_err": 0.0,          # bit-equal, checked above
        **totals,
        "bound_by": "bytes",
        "bytes": nbytes_step,
        "library_call": "torch.mul(bufs[0], scales): at P = 1 one elementwise call is the same function, "
                        "bit for bit",
        "largest_leaf": {"name": largest, **per_leaf[largest]},
        "per_leaf": per_leaf,
        "test_cases": len(cases),
        "test_bit_equal": True,
    }


def phase_kernels() -> list[dict]:
    # fp32 comparisons need full-fp32 products in the plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    return [_flash_row(gen), _moe_row(gen), _ssd_row(gen), _rwkv_row(gen), _ccu_row(gen)]


def _bwd(harness, calls: int) -> dict[str, int]:
    """Flash's backward launches: ``calls`` (the attention calls under
    autograd) where the config trains through the backward kernels (bf16 at
    head_dim 64 or 128), else none (the plain version's gradient)."""
    from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS

    cfg = harness.cfg
    return {"flash_attention.bwd": calls if cfg.dtype == torch.bfloat16 and cfg.head_dim in BWD_HEAD_DIMS else 0}


def _expected_launches(harness, gen: int) -> dict[str, int]:
    """A transformer's attention goes through the flash kernel and an MoE
    layer's dispatch through the dispatch kernel in every layer, once in
    prefill and once in each of the gen - 1 decode steps.  A hybrid's
    Mamba2 layers go through the SSD scan kernel in prefill only (decode is
    the plain recurrence) and its shared attention block through the flash
    kernel at each of its calls, in prefill and every decode step.  An
    RWKV-6 model's layers go through the RWKV-6 scan kernel in prefill only
    and launch nothing else.  An encoder-decoder's attention goes through the
    flash kernel three times a layer in prefill (the encoder's, the
    decoder's self- and cross-attention) and twice a decoder layer in each
    decode step."""
    cfg = harness.cfg
    if harness.family == "audio":
        return {"flash_attention": 3 * cfg.n_layers + 2 * cfg.n_layers * (gen - 1), "moe_dispatch": 0,
                "ssd_scan": 0, "rwkv6_scan": 0, "ccu_reduce": 0, "flash_attention.bwd": 0}
    if harness.family == "ssm":
        return {"flash_attention": 0, "moe_dispatch": 0, "ssd_scan": 0, "rwkv6_scan": cfg.n_layers,
                "ccu_reduce": 0, "flash_attention.bwd": 0}
    if harness.family == "hybrid":
        return {"flash_attention": cfg.n_shared_calls * gen, "moe_dispatch": 0,
                "ssd_scan": cfg.n_layers, "rwkv6_scan": 0, "ccu_reduce": 0, "flash_attention.bwd": 0}
    per_layer = cfg.n_layers * gen
    return {"flash_attention": per_layer,
            "moe_dispatch": per_layer if harness.family == "moe" else 0,
            "ssd_scan": 0, "rwkv6_scan": 0, "ccu_reduce": 0, "flash_attention.bwd": 0}


@contextlib.contextmanager
def _routing(replay: list | None = None):
    """Watches the routing of the port's MoE layers over one served batch.
    Yields a list with one entry a layer call: (its own top-k choices, its
    router logits).  With ``replay`` (such a list from another run), each
    call routes by the recorded choices instead of its own."""
    from repro_torch.models import moe

    route, calls = moe.route, []

    def watched(x, router, cfg, gate_idx=None, **kw):
        own = route(x, router, cfg, **kw)
        with torch.no_grad():
            calls.append((own.gate_idx, (x @ router).float()))
        return own if replay is None else route(x, router, cfg, gate_idx=replay[len(calls) - 1][0], **kw)

    moe.route = watched
    try:
        yield calls
    finally:
        moe.route = route


@contextlib.contextmanager
def _scan_without_roundings():
    """The plain path's prefill scans through the scan kernels' own plain
    versions: Mamba2's through ``ssd_scan_plain`` (float32 inside, y rounded
    once) in place of the model's twin ``ssd_chunked``, which rounds ``att``
    and the carried state to the inputs' type before their products; and
    RWKV-6's through ``rwkv6_scan_plain`` in place of the twin
    ``rwkv6_chunked`` (both float32 inside, y rounded once: the same
    arithmetic in another order of sums)."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.models import mamba2, rwkv6

    twins = mamba2.ssd_chunked, rwkv6.rwkv6_chunked
    mamba2.ssd_chunked = lambda xh, log_l, Bm, Cm, chunk, h0=None: ssd_scan_plain(
        xh, log_l, Bm, Cm, chunk=chunk, h0=h0)
    rwkv6.rwkv6_chunked = lambda r, k, v, w, u, chunk, s0=None: rwkv6_scan_plain(
        r, k, v, w, u, chunk=chunk, s0=s0)
    try:
        yield
    finally:
        mamba2.ssd_chunked, rwkv6.rwkv6_chunked = twins


def _moved(x: torch.Tensor, seed: int) -> torch.Tensor:
    """x with 1 % of its elements, drawn from ``seed``, moved up by one ulp
    of x's type: a difference of the size one rounding apart makes."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    chosen = torch.rand(x.shape, generator=gen, device=x.device) < 0.01
    # the move added as a constant (one ulp, so x + it is exactly the next
    # value up), so that a training step differentiates through it
    xd = x.detach()
    ulp = torch.nextafter(xd, torch.full_like(xd, float("inf"))) - xd
    return x + torch.where(chosen, ulp, torch.zeros_like(ulp))


@contextlib.contextmanager
def _moved_prompt(seed: int):
    """The served prompt's embedding (the first call of ``layers.embed``, the
    prefill's) moved by ``_moved``; the decode steps' embeddings as they are."""
    from repro_torch.models import layers

    embed, calls = layers.embed, []

    def moved(rt, p, tokens):
        calls.append(None)
        x = embed(rt, p, tokens)
        return _moved(x, seed) if len(calls) == 1 else x

    layers.embed = moved
    try:
        yield
    finally:
        layers.embed = embed


def _kernel_vs_plain(args, harness, params, dt, where: str, inputs=None) -> tuple[dict, dict[str, int], dict]:
    """One batch through the kernel path (use_kernels=True), every launch
    count set to 0 just before and read just after, then the same batch and
    weights through the plain path (sdpa + mask bias, the dispatch einsum,
    the ``ssd_chunked`` twin), which must launch nothing.

    Logits are comparable over the steps both paths were fed the same ids:
    up to and including the first step at which their greedy ids differ.
    float32: 2e-4 absolute (only the order of sums differs), and the ids must
    agree.  bfloat16: the flash kernel keeps fp32 scores and probabilities
    where sdpa rounds both to bf16, so each path lies a few bf16 ulps of the
    largest logit (ulp 0.031 at 4) from the fp32 result: 3e-2 of the largest
    |logit|, at least 3e-2; at every compared step the token the kernel path
    chose must be, by the plain path's logits, within that limit of the best.

    Routing, like a greedy id, is a discrete choice that a near-tie and a
    rounding apart can flip, and one token routed to another expert moves
    its output by O(1).  So the plain path is routed by the kernel path's
    choices, as it is fed ids, and holds its router logits under that
    routing to the same limits; how many choices of its own would have
    differed is reported beside them.

    A hybrid's twin rounds the scan's ``att`` and carried state to bf16
    where the kernel does not, in every Mamba2 layer: its agreement is
    reported (``twin``), and the plain path held is the one with its scan
    through the kernel's plain version (``_scan_without_roundings``); so is
    an RWKV-6 model's, whose twin sums in another order.  A randomly drawn
    zamba2 at full depth carries a one-ulp difference in its first layer to
    O(1) in its logits (``_free_running`` shows where), so for both recurrent
    families the limit is the larger of the above and ``witness``: how far
    that plain path moves when 1 % of its embedded prompt is moved by one ulp
    (``_moved_prompt``).  Their layers are held one by one, on the same
    inputs, at granite's limit (``_layers_vs_plain``, ``_rwkv_layers``)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.models.layers import Runtime

    cfg = harness.cfg
    kernels.reset_launch_counts()
    with _routing() as kern_calls:
        res = serve.run(args, harness=harness, params=params, inputs=inputs)
    counts = kernels.launch_counts()
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if counts != _expected_launches(harness, args.gen):
        raise SystemExit(f"{where}: the kernel path launched {counts}, expected "
                         f"{_expected_launches(harness, args.gen)}")

    def plain_run() -> tuple[dict, list]:
        kernels.reset_launch_counts()
        with _routing(replay=kern_calls) as plain_calls:
            ref = serve.run(args, harness=harness, params=params, rt=Runtime(use_kernels=False), inputs=inputs)
        if any(kernels.launch_counts().values()):
            raise SystemExit(f"{where}: the plain path launched {kernels.launch_counts()}")
        return ref, plain_calls

    def limit(values) -> float:
        return 2e-4 if dt == torch.float32 else 3e-2 * max(1.0, values)

    def agreement(run, ref) -> dict:
        tok = run["tokens"]
        differ = np.flatnonzero((tok != ref["tokens"]).any(axis=0))
        n = int(differ[0]) + 1 if differ.size else args.gen
        run_lg, ref_lg = run["logits"][:, :n], ref["logits"][:, :n]
        scale = float(np.abs(ref_lg).max())
        chosen = np.take_along_axis(ref_lg, tok[:, :n, None].astype(np.int64), axis=2)[..., 0]
        return {"steps_compared": n, "same_ids": bool(differ.size == 0),
                "max_abs_err": float(np.abs(run_lg - ref_lg).max()), "limit": limit(scale),
                "max_abs_logit": scale, "chosen_short_of_best": float((ref_lg.max(axis=2) - chosen).max())}

    ref, plain_calls = plain_run()
    out = agreement(res, ref)
    if harness.family in ("hybrid", "ssm"):
        twin = out
        with _scan_without_roundings():
            ref, plain_calls = plain_run()
            with _moved_prompt(args.seed):
                moved, _ = plain_run()
        out = agreement(res, ref)
        witness = agreement(moved, ref)
        if harness.family == "hybrid":
            free = _free_running(args, harness, params)
            layers = _layers_vs_plain(args, harness, params, res["tokens"][:, 0], where)
        else:
            free, layers = _rwkv_layers(args, harness, params, where)
        out = {**out, "limit": max(out["limit"], witness["max_abs_err"]), "granite_limit": out["limit"],
               "witness": witness, "twin": twin, "free_running": free, "layers": layers}
    # the MoE layer calls of the compared steps: prefill's, then each decode step's
    n = out["steps_compared"]
    calls = list(zip(kern_calls, plain_calls))[:n * cfg.n_layers] if harness.family == "moe" else []
    if calls:
        r_err = max(float((k[1] - p[1]).abs().max()) for k, p in calls)
        r_scale = max(float(p[1].abs().max()) for _, p in calls)
        flips = sum(int((k[0] != p[0]).any(-1).sum()) for k, p in calls)
        out["router"] = {"calls": len(calls), "max_abs_err": r_err, "limit": limit(r_scale),
                         "max_abs_logit": r_scale, "own_choices_differ": flips,
                         "decisions": sum(int(k[0][..., 0].numel()) for k, _ in calls)}
        if not r_err <= limit(r_scale):
            raise SystemExit(f"{where}: router logits under the same routing differ by {r_err} "
                             f"(limit {limit(r_scale)})")
    if (not out["max_abs_err"] <= out["limit"] or not out["chosen_short_of_best"] <= out["limit"]
            or (dt == torch.float32 and not out["same_ids"])):
        raise SystemExit(f"{where}: kernel path vs plain path: {out}")
    return res, counts, {**out, "plain_prefill_ms": ref["prefill_s"] * 1e3,
                         "plain_decode_ms_per_token": ref["decode_s_per_token"] * 1e3}


def _layers_vs_plain(args, harness, params, next_ids, where: str) -> dict:
    """A hybrid's prefill and its first decode step layer by layer, at the
    served batch's prompts, weights and first generated ids: every Mamba2
    layer and every shared call is given the SAME input on both paths (the
    plain path's hidden state entering it).  Held to 3e-2 of the largest
    |value| of the plain path's: each Mamba2 layer's output and final scan
    state in prefill (the scan kernel against the model's twin), and each
    shared call's attention output on its own (the flash kernel against
    sdpa), in prefill and in the decode step over the KV cache that prefill
    wrote.  The decode step's Mamba2 layers are the recurrence, the same
    code on both paths."""
    import numpy as np

    from repro_torch.models import hybrid
    from repro_torch.models import layers as L
    from repro_torch.models.layers import Runtime
    from repro_torch.models.mamba2 import mamba2_apply
    from repro_torch.models.param import cast_floats, tree_map

    cfg = harness.cfg
    p = cast_floats(params, cfg.dtype)
    sp, device = p["shared"], p["embed"]["tok"].device
    kern, plain = Runtime(use_kernels=True), Runtime(use_kernels=False)
    B, S = args.batch, args.prompt_len
    prompts = np.random.default_rng(args.seed).integers(0, cfg.vocab_size, size=(B, S), dtype=np.int32)

    def of_limit(o, r):
        return ((o.float() - r.float()).abs().max() / (3e-2 * r.float().abs().max())).item()

    worst = {"mamba_y": 0.0, "mamba_h": 0.0, "attention_prefill": 0.0, "attention_decode": 0.0}

    def shared_call(x, positions, cache, pos, key):
        h = L.rmsnorm(sp["ln1"], x)
        a_kern, _ = L.attention(kern, sp["attn"], h, cfg.attn, positions, cache, pos)
        a_plain, _ = L.attention(plain, sp["attn"], h, cfg.attn, positions, cache, pos)
        worst[key] = max(worst[key], of_limit(a_kern, a_plain))
        return hybrid._shared_block(plain, cfg, sp, x, positions, cache, pos)[0]

    def layers(x, positions, step: bool):
        for i in range(cfg.n_layers):
            lp = tree_map(lambda t: t[i], p["mamba_blocks"])
            h_in = L.rmsnorm(lp["norm"], x)
            if step:
                y, _ = mamba2_apply(plain, lp["mamba"], h_in, cfg.mamba, state=states[i])
            else:
                yk, sk = mamba2_apply(kern, lp["mamba"], h_in, cfg.mamba)
                y, state = mamba2_apply(plain, lp["mamba"], h_in, cfg.mamba)
                worst["mamba_y"] = max(worst["mamba_y"], of_limit(yk, y))
                worst["mamba_h"] = max(worst["mamba_h"], of_limit(sk["h"], state["h"]))
                states.append(state)
            x = (x + y).to(cfg.dtype)
            if (i + 1) % cfg.share_every == 0 and i + 1 < cfg.n_layers:
                c = (i + 1) // cfg.share_every - 1
                x = shared_call(x, positions, caches[c], 0 if not step else S,
                                "attention_decode" if step else "attention_prefill")

    states = []
    caches = [tuple(torch.zeros((B, S + 8, cfg.n_kv_heads, cfg.head_dim), dtype=cfg.dtype, device=device)
                    for _ in range(2)) for _ in range(cfg.n_shared_calls)]
    with torch.no_grad():
        tokens = torch.from_numpy(prompts).to(device)
        layers(L.embed(plain, p["embed"], tokens).to(cfg.dtype), torch.arange(S, device=device), step=False)
        tokens = torch.as_tensor(next_ids, device=device).view(B, 1)
        layers(L.embed(plain, p["embed"], tokens).to(cfg.dtype), torch.arange(S, S + 1, device=device), step=True)
    if not max(worst.values()) <= 1.0:
        raise SystemExit(f"{where}: a layer's kernel path vs plain path on the same input exceeds "
                         f"3e-2 of the largest value: {worst} of it")
    return {"max_err_of_limit": worst, "layers": cfg.n_layers, "shared_calls": cfg.n_shared_calls}


def _free_running(args, harness, params) -> dict:
    """Where a hybrid's paths part over its prefill: hidden states run free
    through the layers, each on its own, and compared with the plain path's
    (its scan through ``ssd_scan_plain``, ``_scan_without_roundings``) after
    every layer, and the last token's logits at the end.  Trajectories:
    ``kernel``, the kernel path; ``scan_kernel``, the scan kernel with the
    plain attention; ``moved``, the plain path itself with its embedded
    prompt moved by ``_moved``: how far the model carries a difference of
    one rounding."""
    import numpy as np

    from repro_torch.models import hybrid
    from repro_torch.models import layers as L
    from repro_torch.models.layers import Runtime
    from repro_torch.models.mamba2 import mamba2_apply
    from repro_torch.models.param import cast_floats, tree_map

    cfg = harness.cfg
    p = cast_floats(params, cfg.dtype)
    device = p["embed"]["tok"].device
    kern, plain = Runtime(use_kernels=True), Runtime(use_kernels=False)
    B, S = args.batch, args.prompt_len
    prompts = np.random.default_rng(args.seed).integers(0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    # (scan runtime, attention runtime) of each trajectory; None: the plain scan
    paths = {"plain": (None, plain), "kernel": (kern, kern), "scan_kernel": (kern, plain),
             "moved": (None, plain)}
    positions = torch.arange(S, device=device)
    with torch.no_grad():
        x0 = L.embed(plain, p["embed"], torch.from_numpy(prompts).to(device)).to(cfg.dtype)
        x = {name: x0 for name in paths}
        x["moved"] = _moved(x0, args.seed)
        after = {name: [] for name in paths if name != "plain"}
        for i in range(cfg.n_layers):
            lp = tree_map(lambda t: t[i], p["mamba_blocks"])
            for name, (scan_rt, _) in paths.items():
                h_in = L.rmsnorm(lp["norm"], x[name])
                with (_scan_without_roundings() if scan_rt is None else contextlib.nullcontext()):
                    y, _ = mamba2_apply(scan_rt or plain, lp["mamba"], h_in, cfg.mamba)
                x[name] = (x[name] + y).to(cfg.dtype)
            if (i + 1) % cfg.share_every == 0 and i + 1 < cfg.n_layers:
                for name, (_, attn_rt) in paths.items():
                    x[name], _ = hybrid._shared_block(attn_rt, cfg, p["shared"], x[name], positions)
            for name in after:
                after[name].append((x[name].float() - x["plain"].float()).abs().max().item())
        logits = {name: L.unembed(plain, p["embed"], L.rmsnorm(p["final_norm"], h[:, -1:])).float()
                  for name, h in x.items()}
    return {"hidden_max_abs_diff_after_each_layer": after,
            "last_logits_max_abs_diff": {name: (logits[name] - logits["plain"]).abs().max().item()
                                         for name in after},
            "max_abs_logit": logits["plain"].abs().max().item()}


def _rwkv_layers(args, harness, params, where: str) -> tuple[dict, dict]:
    """An RWKV-6 model's prefill layer by layer, at the served batch's prompts
    and weights, against the plain path with its scan through
    ``rwkv6_scan_plain`` (``_scan_without_roundings``).  Returns (free
    running, layers).  Layers: each block is given the SAME input on both
    paths (the plain path's hidden state entering it); what it adds to the
    residual stream and its final scan state are held to 3e-2 of the largest
    |value| of the plain path's.  Free running, where the paths part: hidden
    states run through the layers on their own — ``kernel``, the kernel
    path; ``moved``, the plain path with its embedded prompt moved by
    ``_moved`` — and are compared with the plain path's after every layer,
    and the last token's logits at the end.  Decode launches no kernel: its
    recurrence is the same code on both paths."""
    import numpy as np

    from repro_torch.models import layers as L
    from repro_torch.models import rwkv_lm
    from repro_torch.models.layers import Runtime
    from repro_torch.models.param import cast_floats, tree_map

    cfg = harness.cfg
    p = cast_floats(params, cfg.dtype)
    device = p["embed"]["tok"].device
    kern, plain = Runtime(use_kernels=True), Runtime(use_kernels=False)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len), dtype=np.int32)
    worst = {"block_increment": 0.0, "tm_s": 0.0}
    with torch.no_grad(), _scan_without_roundings():
        e = L.embed(plain, p["embed"], torch.from_numpy(prompts).to(device))
        x = {name: L.layernorm(p["ln_in"], t).to(cfg.dtype)
             for name, t in (("plain", e), ("kernel", e), ("moved", _moved(e, args.seed)))}
        after = {"kernel": [], "moved": []}
        for i in range(cfg.n_layers):
            lp = tree_map(lambda t: t[i], p["blocks"])
            x_in = x["plain"]
            out_plain, st_plain = rwkv_lm._block(plain, cfg, lp, x_in)
            out_kern, st_kern = rwkv_lm._block(kern, cfg, lp, x_in)
            scale = (out_plain.float() - x_in.float()).abs().max()
            worst["block_increment"] = max(worst["block_increment"], (
                (out_kern.float() - out_plain.float()).abs().max() / (3e-2 * scale)).item())
            worst["tm_s"] = max(worst["tm_s"], (
                (st_kern["tm_s"] - st_plain["tm_s"]).abs().max() / (3e-2 * st_plain["tm_s"].abs().max())).item())
            x["plain"] = out_plain
            x["kernel"] = rwkv_lm._block(kern, cfg, lp, x["kernel"])[0]
            x["moved"] = rwkv_lm._block(plain, cfg, lp, x["moved"])[0]
            for name in after:
                after[name].append((x[name].float() - x["plain"].float()).abs().max().item())
        logits = {name: L.unembed(plain, p["embed"], L.layernorm(p["final_norm"], h[:, -1:])).float()
                  for name, h in x.items()}
    if not max(worst.values()) <= 1.0:
        raise SystemExit(f"{where}: a layer's kernel path vs plain path on the same input exceeds "
                         f"3e-2 of the largest value: {worst} of it")
    free = {"hidden_max_abs_diff_after_each_layer": after,
            "last_logits_max_abs_diff": {name: (logits[name] - logits["plain"]).abs().max().item()
                                         for name in after},
            "max_abs_logit": logits["plain"].abs().max().item()}
    return free, {"max_err_of_limit": worst, "layers": cfg.n_layers}


def _draw_time_mix(harness, params, seed: int) -> None:
    """An RWKV-6 model's leaves that the reference initialises to zeros —
    the token-shift mixes ``mu`` of both blocks, the decay's bias ``w0`` and
    the bonus ``bonus_u`` — drawn non-zero in place: mu ~ U(0, 1),
    w0 ~ randn - 1, u ~ 0.3 randn.  With zeros the token shift, the bonus and
    the decay's bias do nothing, and a wrong one would not show."""
    if harness.family != "ssm":
        return
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(leaf, uniform: bool, scale: float = 1.0, shift: float = 0.0) -> None:
        x = (torch.rand if uniform else torch.randn)(leaf.shape, generator=gen, device="cuda")
        leaf.copy_((x * scale + shift).to(leaf.dtype))

    tm, cm = params["blocks"]["tm"], params["blocks"]["cm"]
    draw(tm["mu"], True)
    draw(cm["mu"], True)
    draw(tm["w0"], False, shift=-1.0)
    draw(tm["bonus_u"], False, scale=0.3)


def phase_slice() -> None:
    """The smoke configs on the card, same weights: the kernel path against
    the plain path in fp32 and bf16.  mixtral's prompt is longer than its
    smoke window of 64, so the sliding window bites; zamba2's is two chunks
    of 128 and rwkv6's four of 16, so the scans carry their states across
    chunk boundaries (and the plain twins' whole-chunk assertions hold).
    rwkv6's zero-initialised mixes, decay bias and bonus are drawn
    (``_draw_time_mix``).  paligemma's smoke config is served with its 8
    prefix embeddings and whisper's with its 24 frames, drawn
    (``serve.stub_inputs``)."""
    from repro_torch.configs import load
    from repro_torch.launch import serve
    from repro_torch.models.param import tree_init

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, argv in (("granite-8b", ["--prompt-len", "24", "--gen", "5", "--batch", "2"]),
                       ("mixtral-8x22b", ["--prompt-len", "80", "--gen", "5", "--batch", "2"]),
                       ("zamba2-1.2b", ["--prompt-len", "256", "--gen", "5", "--batch", "2"]),
                       ("rwkv6-1.6b", ["--prompt-len", "64", "--gen", "5", "--batch", "2"]),
                       ("paligemma-3b", ["--prompt-len", "24", "--gen", "5", "--batch", "2"]),
                       ("whisper-base", ["--prompt-len", "24", "--gen", "5", "--batch", "2"])):
        args = serve.build_parser().parse_args(["--arch", arch, *argv])
        out = {}
        for dt in (torch.float32, torch.bfloat16):
            h = load(arch, smoke=True).clone(dtype=dt)
            params = tree_init(h.param_specs(), torch.Generator(device="cuda").manual_seed(1), dt, "cuda")
            _draw_time_mix(h, params, 2)
            name = str(dt).split(".")[-1]
            # the smoke configs' own stub sizes: paligemma's 8 patches, whisper's 24 frames
            inputs = {k: t.to(dt) for k, t in serve.stub_inputs(h, args.batch, 3, "cuda").items()}
            _, _, out[name] = _kernel_vs_plain(args, h, params, dt, f"slice check {arch} {name}", inputs=inputs)
        emit("slice", config=f"{arch} smoke", batch=args.batch, prompt_len=args.prompt_len,
             gen=args.gen, window=getattr(h.cfg, "window", None), **out)


def _serve_path(spec: dict) -> dict[str, int]:
    """One main path: a batch served at full width through the kernel path,
    then through the plain path, same weights.  A kernel that is wrong only
    at these sizes shows here as a wrong token.  Returns the kernel path's
    launch counts."""
    import numpy as np

    from repro_torch.configs import load
    from repro_torch.launch import serve
    from repro_torch.models.param import param_count, tree_init

    args = serve.build_parser().parse_args([
        "--arch", spec["arch"], "--no-smoke", "--batch", str(spec["batch"]),
        "--prompt-len", str(spec["prompt_len"]), "--gen", str(spec["gen"]),
        "--seed", str(spec["seed"]),
    ])
    harness = load(args.arch, smoke=False)
    if "n_layers" in spec:
        harness = harness.clone(n_layers=spec["n_layers"])
    cfg = harness.cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the weights are drawn once, so that the plain path serves the same model
    params = tree_init(harness.param_specs(), torch.Generator(device="cuda").manual_seed(spec["seed"]),
                       torch.bfloat16, "cuda")
    _draw_time_mix(harness, params, spec["seed"] + 1)
    inputs = serve.stub_inputs(harness, args.batch, spec["seed"] + 2, "cuda")
    res, counts, vs_plain = _kernel_vs_plain(args, harness, params, torch.bfloat16, f"serve {args.arch}",
                                             inputs=inputs)
    tok, lg = res["tokens"], res["logits"]
    if tok.shape != (args.batch, args.gen) or tok.min() < 0 or tok.max() >= cfg.vocab_size:
        raise SystemExit(f"serve {args.arch}: bad token ids, shape {tok.shape}")
    if lg.shape != (args.batch, args.gen, cfg.vocab_size) or not np.isfinite(lg).all():
        raise SystemExit(f"serve {args.arch}: logits of shape {lg.shape} not finite")
    emit("serve", arch=args.arch, n_layers=cfg.n_layers, d_model=cfg.d_model,
         params=param_count(harness.param_specs()), batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
         prefill_ms=res["prefill_s"] * 1e3, decode_ms_per_token=res["decode_s_per_token"] * 1e3,
         peak_memory_gb=res["peak_memory_gb"], launches=counts, first_row=tok[0].tolist(),
         inputs={k: list(t.shape) for k, t in inputs.items()}, vs_plain_path=vs_plain)
    return counts


def _train_expected_launches(harness, steps: int, n_leaves: int, compression: str) -> dict[str, int]:
    """Under the ``"nothing"`` remat (every config's; the recurrent families'
    references checkpoint their blocks whatever it says) every layer's
    attention, dispatch or scan runs twice a step, in the forward and in the
    backward's recompute; a hybrid's shared attention block is not
    rematerialised and runs once a call; an encoder-decoder's layer count is
    a stack's, an encoder layer attends once and a decoder layer twice (its
    self- and cross-attention), so 3 attentions a layer, twice.  In int8
    every gradient leaf's payload is reduced once a step.  Each attention
    call under autograd (the recompute's; the hybrid's every call) has one
    backward (``_bwd``)."""
    cfg = harness.cfg
    twice = 2 * cfg.n_layers * steps
    counts = {"flash_attention": 0, "moe_dispatch": 0, "ssd_scan": 0, "rwkv6_scan": 0,
              "ccu_reduce": n_leaves * steps if compression == "int8" else 0}
    if harness.family == "ssm":
        counts["rwkv6_scan"] = twice
    elif harness.family == "hybrid":
        counts["ssd_scan"] = twice
        counts["flash_attention"] = cfg.n_shared_calls * steps
    elif harness.family == "audio":
        counts["flash_attention"] = 3 * twice
    else:
        counts["flash_attention"] = twice
        if harness.family == "moe":
            counts["moe_dispatch"] = twice
    under_grad = counts["flash_attention"] if harness.family == "hybrid" else counts["flash_attention"] // 2
    return {**counts, **_bwd(harness, under_grad)}


def _train_kernel_vs_plain(args, harness, dt, where: str, params=None,
                           inputs=None) -> tuple[dict, dict[str, int], dict]:
    """``args.steps`` steps through the kernel path, every launch count set to
    0 just before and read just after, then the same steps from the same
    weights through the plain path (``use_kernels=False``: sdpa + mask bias
    for attention, the dispatch einsum, the scans' twins, ``ccu_reduce_plain``
    for the compression's reduce; it launches no kernel).  The weights are
    drawn anew from ``args.seed`` for each run unless ``params`` is given
    (then a copy on the card serves each run: ``params`` may be kept on the
    host), so that one training state is held at a time.  ``inputs`` (the
    VLM's prefix, the audio family's frames: ``train.run``'s) gives both
    paths the same drawn inputs.  The first step's gradients (before
    compression) and int8 values
    are kept on the host and compared leaf by leaf.  float32: losses within
    1e-4, gradients within 2e-5.  bfloat16: losses within 3e-2, each leaf's
    gradients within 3e-2 of its largest |g| (bf16 gradients are sums of
    rounded products, and the kernel path keeps its attention probabilities
    in fp32 where sdpa rounds them); a key bias's, whose exact value is zero
    (it adds one constant to a query's every score), of its projection's
    weights'.  The share of int8 values that differ is
    reported, not held: a rounding apart may move a value across a
    quantisation step.

    As in serving (``_kernel_vs_plain``): an MoE model's plain path is routed
    by the kernel path's choices, call by call (forward and recompute alike),
    and how many of its own would have differed is reported; a recurrent
    family's plain path runs its scans through the kernels' plain versions
    (``_scan_without_roundings``).  At full depth a randomly drawn recurrent
    model carries a difference of one rounding to far beyond these limits,
    so for them the full-depth comparison is reported and not held: beside
    it ``witness``, how far that plain path's losses and first-step
    gradients move when 1 % of the first step's embeddings are moved by one
    ulp (``_moved_prompt``), and ``meets_granite_limit``.  What holds them is
    ``_train_layers``: every layer on the same input on both paths, its
    output and its gradients at 3e-2 of their largest value; it needs
    ``params``.  The VLM and the audio family are held both ways: end to end
    at those limits where they meet them, and every attention sub-layer by
    ``_train_layers``; where the full depth breaks the end-to-end limit, the
    witness is run and reported beside it, as for the recurrent ones."""
    from repro_torch import kernels
    from repro_torch.launch import train
    from repro_torch.models.layers import Runtime
    from repro_torch.models.param import tree_leaves, tree_map

    names = list(_leaf_sizes(harness))
    recurrent = harness.family in ("ssm", "hybrid")
    by_layers = recurrent or harness.family in ("vlm", "audio")

    def keeper(into: dict):
        def keep(step, loss, grads, payload, wire):
            if step == 0:
                into["grads"] = [g.to("cpu") for g in tree_leaves(grads)]
                into["q"] = [q.to("cpu") for q, _ in wire]
        return keep

    def weights():
        return None if params is None else tree_map(lambda t: t.to("cuda", copy=True), params)

    def run(rt=None, into=None):
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        res = train.run(args, harness=harness, params=weights(), rt=rt, observe=keeper(into), inputs=inputs)
        return res, kernels.launch_counts()

    def witnessed() -> tuple[dict, dict]:
        kept = {}
        with contextlib.ExitStack() as stack:
            if recurrent:
                stack.enter_context(_scan_without_roundings())
            stack.enter_context(_moved_prompt(args.seed))
            moved, _ = run(Runtime(use_kernels=False), kept)
        return moved, kept

    kern, plain_kept = {}, {}
    with _routing() as kern_calls:
        res, counts = run(into=kern)
    expected = _train_expected_launches(harness, args.steps, len(kern["grads"]), args.compression)
    if counts != expected:
        raise SystemExit(f"{where}: the kernel path launched {counts}, expected {expected}")
    with contextlib.ExitStack() as stack:
        if recurrent:
            stack.enter_context(_scan_without_roundings())
        plain_calls = stack.enter_context(_routing(replay=kern_calls if harness.family == "moe" else None))
        ref, plain_counts = run(Runtime(use_kernels=False), plain_kept)

    def leaf_errs(a: list, b: list) -> list[float]:
        return [(x.float() - y.float()).abs().max().item() for x, y in zip(a, b)]

    errs = leaf_errs(kern["grads"], plain_kept["grads"])
    scales = [g.float().abs().max().item() for g in plain_kept["grads"]]
    for i, name in enumerate(names):
        if name.endswith("attn.bk"):
            scales[i] = scales[names.index(name[:-2] + "wk")]
    limits = [2e-5 if dt == torch.float32 else 3e-2 * sc for sc in scales]
    loss_err = max(abs(a - b) for a, b in zip(res["losses"], ref["losses"]))
    loss_limit = 1e-4 if dt == torch.float32 else 3e-2
    out = {"loss_max_abs_err": loss_err, "loss_limit": loss_limit, "granite_loss_limit": loss_limit}
    of_limit = [e / max(lim, 1e-30) for e, lim in zip(errs, limits)]
    worst = max(range(len(names)), key=lambda i: of_limit[i])
    out.update({"grad_worst_of_limit": of_limit[worst], "grad_worst_leaf": names[worst],
                "grad_max_abs_err": max(errs)})
    out["meets_granite_limit"] = loss_err <= loss_limit and of_limit[worst] <= 1.0
    if recurrent or (by_layers and not out["meets_granite_limit"]):
        moved, moved_kept = witnessed()
        witness = leaf_errs(moved_kept["grads"], plain_kept["grads"])
        out["witness"] = {"loss_max_abs_err": max(abs(a - b) for a, b in zip(moved["losses"], ref["losses"])),
                          "grad_worst_of_granite_limit": max(w / max(3e-2 * sc, 1e-30)
                                                             for w, sc in zip(witness, scales))}
    if kern["q"]:
        differ = sum(int((q != qk).sum()) for q, qk in zip(plain_kept["q"], kern["q"]))
        values = sum(q.numel() for q in kern["q"])
        out.update({"int8_differ": differ, "int8_values": values, "int8_differ_share": differ / values})
    if harness.family == "moe":
        out["routing"] = {"calls": len(kern_calls),
                          "own_choices_differ": sum(int((k[0] != p[0]).any(-1).sum())
                                                    for k, p in zip(kern_calls, plain_calls)),
                          "decisions": sum(int(k[0][..., 0].numel()) for k in kern_calls)}
    out.update({"plain_losses": ref["losses"], "plain_grad_norms": ref["grad_norms"],
                "plain_step_ms": ref["step_ms"], "plain_peak_memory_gb": ref["peak_memory_gb"],
                "plain_launches": plain_counts})
    if any(plain_counts.values()) or not all(map(math.isfinite, res["losses"] + ref["losses"])):
        raise SystemExit(f"{where}: plain path launched {plain_counts} or a loss is not finite: {out}")
    if by_layers:
        out["layers"] = _train_layers(args, harness, params, where, inputs)
    elif not out["meets_granite_limit"]:
        raise SystemExit(f"{where}: kernel path vs plain path: {out}")
    return res, counts, out


def _train_layers(args, harness, params, where: str, inputs=None) -> dict:
    """A model's first training step layer by layer, at the first training
    batch (and ``inputs(0)``, the VLM's prefix or the audio family's
    frames) and the initial weights.  Every sub-layer that runs a kernel —
    an RWKV-6 block's time mix (its layer norm, projections and scan), a
    hybrid's Mamba2 layer (norm and mixer) and each shared call's attention
    (norm and attention), a VLM block's attention over the prefix and the
    tokens (norm and attention, the prefix bidirectional), an encoder
    layer's self-attention, a decoder layer's causal self-attention and its
    cross-attention (norm and attention, the keys and values projected from
    the encoder's output, which is differentiated as one of its weights) —
    is given the SAME input on both paths
    (the plain path's hidden state entering it) under autograd, with the
    scans of the plain path through the kernels' plain versions
    (``_scan_without_roundings``), and a random projection of what it adds
    to the residual stream is differentiated with respect to its input and
    every one of its weights.  Held to 3e-2 of the plain path's largest
    |value|: that increment, and each of those gradients (a key bias's,
    whose exact value is zero, of its projection's weights').  The scans'
    and flash's backward is their plain version on both paths, so a
    gradient differs only where the kernel's forward values enter it (the
    products after it): a kernel that computed a wrong output would move
    the increment and the weights' gradients alike.  The hidden state then
    goes on through the whole layer on the plain path.  ``params`` may be
    kept on the host."""
    from repro_torch.data.pipeline import DataConfig, Pipeline, SyntheticSource
    from repro_torch.models import encdec, hybrid, rwkv_lm, transformer
    from repro_torch.models import layers as L
    from repro_torch.models.layers import Runtime
    from repro_torch.models.mamba2 import mamba2_apply
    from repro_torch.models.param import cast_floats, tree_leaves, tree_map
    from repro_torch.models.rwkv6 import timemix_apply

    cfg = harness.cfg
    p = cast_floats(tree_map(lambda t: t.to("cuda"), params), cfg.dtype)
    device = p["embed"]["tok"].device
    kern, plain = Runtime(use_kernels=True), Runtime(use_kernels=False)
    data_cfg = DataConfig(global_batch=args.batch, seq_len=args.seq, vocab_size=cfg.vocab_size, seed=0)
    pipeline = Pipeline(SyntheticSource(data_cfg), data_cfg, start_step=0)
    try:
        tokens = torch.from_numpy(next(pipeline)["tokens"]).to(device)
    finally:
        pipeline.close()
    extra = inputs(0) if inputs is not None else {}
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    positions = torch.arange(args.seq, device=device)
    worst: dict[str, float] = {"increment": 0.0, "input_grad": 0.0, "weight_grad": 0.0}
    worst_at = {}
    units = [0]

    def of_limit(a, b, scale=None) -> float:
        d = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item() if scale is None else scale
        return 0.0 if d == 0 else d / (3e-2 * scale)

    def named(tree, prefix=""):
        return [kv for k in sorted(tree) for kv in (named(tree[k], f"{prefix}{k}.") if isinstance(tree[k], dict)
                                                    else [(prefix + k, tree[k])])]

    def unit(fn, x, tree, label) -> None:
        """fn(rt, h, tree) -> what the sub-layer adds, on both paths."""
        x_in = x.detach().requires_grad_()
        weights = tree_map(lambda t: t.detach().requires_grad_(), tree)
        leaf_names = [n for n, _ in named(weights)]
        leaves = tree_leaves(weights)
        runs = []
        for rt in (kern, plain):
            with torch.enable_grad():
                y = fn(rt, x_in, weights)
                go = _rand(gen, y.shape, y.dtype, 1.0) if not runs else runs[0][2]
                runs.append((y.detach(), torch.autograd.grad(y, [x_in] + leaves, go), go))
        (yk, gk, _), (yp, gp, _) = runs
        scale = {n: b.float().abs().max().item() for n, b in zip(leaf_names, gp[1:])}
        for n in leaf_names:
            if n.endswith("bk"):
                scale[n] = scale[n[:-2] + "wk"]
        weight = max(of_limit(a, b, scale[n]) for n, a, b in zip(leaf_names, gk[1:], gp[1:]))
        for key, r in (("increment", of_limit(yk, yp)), ("input_grad", of_limit(gk[0], gp[0])),
                       ("weight_grad", weight)):
            if r > worst[key]:
                worst[key], worst_at[key] = r, label
        units[0] += 1

    with _scan_without_roundings(), torch.no_grad():
        if harness.family == "ssm":
            x = L.layernorm(p["ln_in"], L.embed(plain, p["embed"], tokens)).to(cfg.dtype)
            for i in range(cfg.n_layers):
                lp = tree_map(lambda t: t[i], p["blocks"])
                unit(lambda rt, h, w: timemix_apply(rt, w["tm"], L.layernorm(w["ln1"], h), cfg.inner)[0], x,
                     {"tm": lp["tm"], "ln1": lp["ln1"]}, f"block {i}")
                x = rwkv_lm._block(plain, cfg, lp, x)[0]
        elif harness.family == "hybrid":
            x = L.embed(plain, p["embed"], tokens).to(cfg.dtype)
            sp = p["shared"]
            for i in range(cfg.n_layers):
                lp = tree_map(lambda t: t[i], p["mamba_blocks"])
                unit(lambda rt, h, w: mamba2_apply(rt, w["mamba"], L.rmsnorm(w["norm"], h), cfg.mamba)[0],
                     x, lp, f"mamba {i}")
                x = (x + mamba2_apply(plain, lp["mamba"], L.rmsnorm(lp["norm"], x), cfg.mamba)[0]).to(cfg.dtype)
                if (i + 1) % cfg.share_every == 0 and i + 1 < cfg.n_layers:
                    unit(lambda rt, h, w: L.attention(rt, w["attn"], L.rmsnorm(w["ln1"], h), cfg.attn,
                                                      positions)[0],
                         x, {"attn": sp["attn"], "ln1": sp["ln1"]}, f"shared attention after {i}")
                    x = hybrid._shared_block(plain, cfg, sp, x, positions)[0]
        elif harness.family == "audio":
            frames = extra["frames"]
            x = frames.to(cfg.dtype) + encdec.sinusoid(frames.shape[1], cfg.d_model, device).to(cfg.dtype)
            at = torch.arange(frames.shape[1], device=device)
            for i in range(cfg.n_layers):
                lp = tree_map(lambda t: t[i], p["enc_blocks"])
                unit(lambda rt, h, w: L.attention(rt, w["attn"], L.layernorm(w["ln1"], h), cfg.attn(False),
                                                  at)[0],
                     x, {"attn": lp["attn"], "ln1": lp["ln1"]}, f"encoder {i}")
                x = x + L.attention(plain, lp["attn"], L.layernorm(lp["ln1"], x), cfg.attn(False), at)[0]
                x = x + L.gelu_mlp(plain, lp["mlp"], L.layernorm(lp["ln2"], x))
            enc_out = L.layernorm(p["enc_norm"], x)
            y = encdec._embed(plain, cfg, p, tokens)
            for i in range(cfg.n_layers):
                lp = tree_map(lambda t: t[i], p["dec_blocks"])
                unit(lambda rt, h, w: L.attention(rt, w["self_attn"], L.layernorm(w["ln1"], h), cfg.attn(True),
                                                  positions)[0],
                     y, {"self_attn": lp["self_attn"], "ln1": lp["ln1"]}, f"decoder {i} self-attention")
                h = y + L.attention(plain, lp["self_attn"], L.layernorm(lp["ln1"], y), cfg.attn(True), positions)[0]
                unit(lambda rt, h, w: L.attention(rt, w["cross_attn"], L.layernorm(w["ln_x"], h), cfg.attn(False),
                                                  positions, kv_override=w["enc_out"])[0],
                     h, {"cross_attn": lp["cross_attn"], "ln_x": lp["ln_x"], "enc_out": enc_out},
                     f"decoder {i} cross-attention")
                y = encdec._dec_block(plain, cfg, lp, y, enc_out, positions)[0]
        else:
            x, prefix, _ = transformer._embed(plain, cfg, p, tokens, extra.get("prefix_embeds"))
            at = torch.arange(x.shape[1], device=device)
            for i in range(cfg.n_layers):
                lp = tree_map(lambda t: t[i], p["blocks"])
                unit(lambda rt, h, w: L.attention(rt, w["attn"], transformer._apply_norm(cfg, w["ln1"], h),
                                                  cfg.attn(prefix), at)[0],
                     x, {"attn": lp["attn"], "ln1": lp["ln1"]}, f"block {i}")
                x = transformer._block(plain, cfg, lp, x, at, prefix=prefix)[0]
    if not max(worst.values()) <= 1.0:
        raise SystemExit(f"{where}: a layer's kernel path vs plain path on the same input under autograd "
                         f"exceeds 3e-2 of the largest value: {worst} of it, at {worst_at}")
    return {"max_err_of_limit": worst, "at": worst_at, "layers": cfg.n_layers, "sub_layers": units[0]}


def _restart_check() -> dict:
    """Checkpoint/restart on the card: granite-3-2b smoke through the kernel
    path, int8, ``RESTART["cut"]`` steps, a save, a new run from fresh trees
    that restores it and trains to ``RESTART["steps"]``; against the same
    steps straight from the same weights.  Every weight within 1e-2 (the
    reference's ``TestCheckpointRestart``), and every leaf of the two runs'
    final saves but the residual (AdamW's ``m``, ``v``, ``master``, the
    weights; ``step`` exactly) within 1e-2 of its largest |value|; not bit
    for bit, since the embedding's backward adds with atomics on the card
    (the CPU tests hold it bit for bit).  The saves go to a temporary
    directory, removed afterwards."""
    import tempfile

    import numpy as np

    from repro_torch.configs import load
    from repro_torch.launch import train
    from repro_torch.models.param import tree_init, tree_leaves

    harness = load(RESTART["arch"], smoke=True)
    names = list(_leaf_sizes(harness))

    def weights(seed=RESTART["seed"]):
        return tree_init(harness.param_specs(), torch.Generator(device="cuda").manual_seed(seed),
                         torch.bfloat16, "cuda")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        def args(ckpt_dir):
            return train.build_parser().parse_args([
                "--arch", RESTART["arch"], "--steps", str(RESTART["steps"]), "--batch", str(RESTART["batch"]),
                "--seq", str(RESTART["seq"]), "--lr", "1e-3", "--compression", RESTART["compression"],
                "--ckpt-every", str(RESTART["cut"]), "--ckpt-dir", os.path.join(tmp, ckpt_dir)])

        def save_at(ckpt_dir, step) -> dict:
            src = os.path.join(tmp, ckpt_dir, f"step_{step:08d}")
            with open(os.path.join(src, "meta.json")) as f:
                keys = json.load(f)["keys"]
            return {k: np.load(os.path.join(src, k.replace("/", "__") + ".npy")) for k in keys}

        straight = weights()
        a = train.run(args("straight"), params=straight)
        first = train.run(args("cut"), params=weights(), stop_at=RESTART["cut"])
        resumed = weights(RESTART["seed"] + 1)          # fresh trees: the restore overwrites them
        c = train.run(args("cut"), params=resumed)
        end_a, end_c = save_at("straight", RESTART["steps"]), save_at("cut", RESTART["steps"])
    # the two runs' whole state at the end, key by key, as a share of the
    # key's largest |value|: a restore that lost the moments, the master
    # weights or the step would show here; the residual is reported (a
    # rounding apart can move an int8 value across a step)
    if sorted(end_a) != sorted(end_c):
        raise SystemExit(f"restart on the card: the final saves hold other keys: {sorted(end_a)} {sorted(end_c)}")
    end_share = {k: float(np.abs(end_a[k].astype(np.float64) - end_c[k]).max()
                          / max(float(np.abs(end_a[k]).max()), 1e-30)) for k in end_a}
    held = {k: v for k, v in end_share.items() if not k.startswith("residual/")}
    diffs = {n: (x.float() - y.float()).abs().max().item()
             for n, x, y in zip(names, tree_leaves(straight), tree_leaves(resumed))}
    out = {"config": f"{RESTART['arch']} smoke", "steps": RESTART["steps"], "cut_after": RESTART["cut"],
           "compression": RESTART["compression"], "resumed_from": c["resumed_from"],
           "start_step": c["start_step"], "residual_restored": c["residual_restored"],
           "max_abs_diff_by_leaf": diffs, "limit": 1e-2,
           "loss_max_abs_diff_after_restart": max(abs(x - y) for x, y in zip(a["losses"][RESTART["cut"]:],
                                                                          c["losses"])),
           "first_losses_equal": a["losses"][:RESTART["cut"]] == first["losses"],
           "final_save_worst_share_of_largest": max(held.values()), "final_save_worst_key": max(held, key=held.get),
           "final_save_share_limit": 1e-2,
           "final_residual_worst_share_of_largest": max((v for k, v in end_share.items()
                                                         if k.startswith("residual/")), default=None),
           "final_step_saved": int(end_c["opt/step"])}
    if not (c["start_step"] == RESTART["cut"] and len(c["losses"]) == RESTART["steps"] - RESTART["cut"]
            and c["residual_restored"] and max(diffs.values()) <= 1e-2 and max(held.values()) <= 1e-2
            and int(end_c["opt/step"]) == RESTART["steps"]):
        raise SystemExit(f"restart on the card: {out}")
    return out


def _auto_parallel_train() -> dict[str, int]:
    """``launch.train.run`` with ``--auto-parallel`` on granite-8b smoke
    (``AUTO_PARALLEL``), through the kernels: the planner's three lines
    logged before the steps (each a spec of the 512 chips, ranked by
    iteration time), then the steps, every launch count set to 0 just
    before and read just after.  Returns the counts."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import load
    from repro_torch.launch import train

    spec = AUTO_PARALLEL
    args = train.build_parser().parse_args(
        ["--auto-parallel", "--steps", str(spec["steps"]), "--batch", str(spec["batch"]), "--seq", str(spec["seq"]),
         "--lr", "1e-3", "--compression", spec["compression"], "--log-every", "1"])
    lines = []
    kernels.reset_launch_counts()
    res = train.run(args, log=lines.append)
    counts = kernels.launch_counts()
    planned = [line for line in lines if line.startswith("[planner]")]
    plans = res["plans"]
    expected = _train_expected_launches(load("granite-8b", smoke=True), args.steps, 12, args.compression)
    times = [r.iteration_s for r in plans]
    if (len(planned) != 3 or planned != [train.planner_line(r) for r in plans] or lines[:3] != planned
            or any(r.spec.chips != 512 for r in plans) or times != sorted(times)
            or not np.isfinite(res["losses"]).all() or counts != expected):
        raise SystemExit(f"train --auto-parallel: planner lines {planned}, losses {res['losses']}, "
                         f"launches {counts} (expected {expected})")
    emit("train", config="granite-8b smoke, --auto-parallel, bf16 weights, int8", planner=planned,
         n_enumerated=plans.n_enumerated, planner_wall_s=plans.wall_s, batch=args.batch, seq=args.seq,
         steps=args.steps, losses=res["losses"], step_ms=res["step_ms"], launches=counts)
    return counts


def _train_family(spec: dict) -> dict[str, dict[str, int]]:
    """One of ``TRAIN_FAMILIES`` (merged into ``TRAIN_FAMILY``) at full width:
    kernel path against plain path (``_train_kernel_vs_plain``), the weights
    drawn on the card and kept on the host for the layer-by-layer check, a
    VLM's or audio model's stub inputs drawn each step
    (``train.drawn_inputs``); one ``train`` line.  Returns the kernel path's
    launch counts by path."""
    from repro_torch.configs import load
    from repro_torch.launch import train
    from repro_torch.models.param import tree_init, tree_map

    harness = load(spec["arch"])
    argv = ["--arch", spec["arch"], "--no-smoke", "--steps", str(spec["steps"]), "--batch", str(spec["batch"]),
            "--seq", str(spec["seq"]), "--compression", spec["compression"], "--seed", str(spec["seed"]),
            "--log-every", "1"]
    if "n_layers" in spec:
        harness = harness.clone(n_layers=spec["n_layers"])
        argv += ["--n-layers", str(spec["n_layers"])]
    params, inputs = None, None
    if harness.family != "moe":     # kept on the host for the layer-by-layer check
        params = tree_init(harness.param_specs(), torch.Generator(device="cuda").manual_seed(spec["seed"]),
                           torch.bfloat16, "cuda")
        # the reference's zero mixes, decay bias and bonus, drawn
        _draw_time_mix(harness, params, spec["seed"] + 1)
        params = tree_map(lambda t: t.cpu(), params)
    if harness.family in ("vlm", "audio"):
        inputs = train.drawn_inputs(harness, spec["batch"], spec["seed"] + INPUTS_SEED, "cuda")
    args = train.build_parser().parse_args(argv)
    res, counts, vs_plain = _train_kernel_vs_plain(args, harness, torch.bfloat16, f"train {spec['arch']}",
                                                   params=params, inputs=inputs)
    drawn = {k: list(t.shape) for k, t in inputs(0).items()} if inputs is not None else {}
    emit("train", arch=spec["arch"], n_layers=harness.cfg.n_layers, d_model=harness.cfg.d_model,
         params=res["params"], batch=args.batch, seq=args.seq, compression=args.compression,
         inputs=drawn, steps=args.steps, losses=res["losses"], grad_norms=res["grad_norms"], lrs=res["lrs"],
         step_ms=res["step_ms"], tokens_per_s_after_the_first_step=res["tokens_per_s"],
         peak_memory_gb=res["peak_memory_gb"], launches=counts, vs_plain_path=vs_plain)
    return {f"{spec['arch']} train ({harness.cfg.n_layers} layers)": counts}


def phase_train() -> dict[str, dict[str, int]]:
    """granite-8b training: the smoke config's kernel and plain paths in fp32
    and bf16 and its loss falling over 40 steps, then the main path at full
    width and 8 layers; then the other families' training paths
    (``TRAIN_FAMILIES``), each after the last one's state is released.
    Returns each training path's launch counts."""
    import numpy as np

    from repro_torch.configs import load
    from repro_torch import kernels
    from repro_torch.launch import train
    from repro_torch.models.param import tree_init

    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = ["--steps", "3", "--batch", "4", "--seq", "64", "--lr", "1e-3", "--compression", "int8"]
    for dt in (torch.float32, torch.bfloat16):
        h = load("granite-8b", smoke=True).clone(dtype=dt)
        params = tree_init(h.param_specs(), torch.Generator(device="cuda").manual_seed(1), dt, "cuda")
        res, counts, vs_plain = _train_kernel_vs_plain(
            train.build_parser().parse_args(smoke), h, dt, f"train smoke {dt}", params=params)
        emit("train", config="granite-8b smoke", dtype=str(dt).split(".")[-1], losses=res["losses"],
             grad_norms=res["grad_norms"], launches=counts, vs_plain_path=vs_plain)

    args = train.build_parser().parse_args(
        ["--steps", "40", "--batch", "8", "--seq", "64", "--lr", "1e-3", "--compression", "int8"])
    kernels.reset_launch_counts()
    res = train.run(args)
    losses, counts = res["losses"], kernels.launch_counts()
    expected = _train_expected_launches(load("granite-8b", smoke=True), args.steps, 12, args.compression)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0] - 0.5) or counts != expected:
        raise SystemExit(f"train smoke: 40 steps lowered the loss from {losses[0]} to {losses[-1]} "
                         f"(needs more than 0.5), launches {counts} (expected {expected})")
    emit("train", config="granite-8b smoke, 40 steps, bf16 weights, int8", first_loss=losses[0],
         last_loss=losses[-1], launches=counts)
    by_path = {"granite-8b smoke train --auto-parallel": _auto_parallel_train()}

    args = train.build_parser().parse_args([
        "--no-smoke", "--n-layers", str(TRAIN["n_layers"]), "--steps", str(TRAIN["steps"]),
        "--batch", str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]), "--compression", TRAIN["compression"],
        "--seed", str(TRAIN["seed"]), "--log-every", "1"])
    harness = load("granite-8b").clone(n_layers=TRAIN["n_layers"])
    res, counts, vs_plain = _train_kernel_vs_plain(args, harness, torch.bfloat16, "train granite-8b")
    emit("train", arch="granite-8b", n_layers=TRAIN["n_layers"], d_model=harness.cfg.d_model,
         params=res["params"], batch=args.batch, seq=args.seq, compression=args.compression,
         steps=args.steps, losses=res["losses"], grad_norms=res["grad_norms"], lrs=res["lrs"],
         step_ms=res["step_ms"], tokens_per_s_after_the_first_step=res["tokens_per_s"],
         peak_memory_gb=res["peak_memory_gb"], launches=counts, vs_plain_path=vs_plain)
    by_path[f"granite-8b train ({TRAIN['n_layers']} layers)"] = counts
    del res

    for spec in TRAIN_FAMILIES:
        by_path.update(_train_family({**TRAIN_FAMILY, **spec}))
    return by_path


def _digest(t: torch.Tensor) -> list[int]:
    """Two sums of t's bits read as int16 (the plain sum, and the sum
    weighted by position mod 251, + 1) in int64, which they cannot
    overflow: equal for equal bits whatever device or order of sums
    computes them, and moved by any one changed bit."""
    bits = t.detach().contiguous().view(-1).view(torch.int16)
    s1 = torch.zeros((), dtype=torch.int64, device=t.device)
    s2 = torch.zeros((), dtype=torch.int64, device=t.device)
    chunk = 1 << 24
    for i in range(0, bits.numel(), chunk):
        x = bits[i:i + chunk].to(torch.int64)
        s1 += x.sum()
        s2 += (x * (torch.arange(i, i + x.numel(), device=t.device) % 251 + 1)).sum()
    return [int(s1), int(s2)]


def _dist_opt_cfg(spec: dict = DIST):
    from repro_torch.optim import adamw

    # as launch.train.run builds it, so that the ranks and one process agree
    return adamw.OptConfig(lr=spec["lr"], warmup_steps=10, decay_steps=spec["steps"])


def _dist_expected_launches(harness, n_leaves: int, spec: dict) -> dict[str, int]:
    """A step of one rank: each gradient leaf's reduce-scatter over the fast
    axis and its all-reduce over each slow axis are one ``ccu_reduce`` each,
    and in int8 its payload one more (P = 1); each layer's attention runs in
    the forward and in the remat's recompute.  On a model axis of more than
    one rank, besides: each gathered tensor's reduce-scatter over "model"
    (a layer's 7 weights, its K and V; the token table and the unembedding),
    and two sums over "model" (the losses with the replicated leaves'
    gradients, then each leaf's sum of squares)."""
    sizes = dict(zip(spec["axes"], spec["mesh"]))
    slow = sum(1 for a in ("pod",) if sizes.get(a, 1) > 1)
    model = 0 if sizes.get("model", 1) == 1 else 9 * harness.cfg.n_layers + 2 + 2
    return {"flash_attention": 2 * harness.cfg.n_layers, "moe_dispatch": 0, "ssd_scan": 0, "rwkv6_scan": 0,
            "ccu_reduce": model + n_leaves * (1 + slow + (spec["compression"] == "int8")),
            **_bwd(harness, harness.cfg.n_layers)}


def _local(tree, pspecs, mesh):
    """This rank's block of each leaf of ``tree`` under ``pspecs``."""
    from repro_torch.models.param import tree_map
    from repro_torch.parallel.sharding import shard_slices

    return tree_map(lambda t, ps: t[shard_slices(ps, tuple(t.shape), mesh)].contiguous(), tree, pspecs)


def _blocks_of(pspecs, specs, mesh) -> list:
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.parallel.sharding import shard_slices

    return [[[sl.start, sl.stop] for sl in blk]
            for blk in tree_leaves(tree_map(lambda ps, s: shard_slices(ps, s.shape, mesh), pspecs, specs))]


def _dist_rank(rank: int, world: int, tmp: str, spec: dict) -> None:
    """One rank of the dist phase (a spawned process): ``_rank_train`` of
    ``spec``, or of each of ``spec["runs"]`` in turn on the one mesh (the
    SSM, hybrid and audio families, ``DIST_FAMILIES``), its results under
    ``"runs"`` by ``_serve_key`` (arch and type) and its files tagged so.  Anything it
    raises ends the process with an error, which
    ``torch.multiprocessing.spawn`` raises in the parent."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=10))
    try:
        mesh = make_mesh(spec["mesh"], spec["axes"])
        if "runs" in spec:
            out = {"runs": {}}
            for run in spec["runs"]:
                out["runs"][_serve_key(run)] = _rank_train(rank, tmp, {**spec, **run}, mesh, f"{_serve_key(run)}_")
                torch.cuda.empty_cache()
        else:
            out = _rank_train(rank, tmp, spec, mesh, "")
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _batch(harness, spec: dict, batch: dict) -> dict:
    """A training step's whole batch on the card: the pipeline's tokens and
    labels, and for the encoder-decoder frames drawn from the seed and the
    step (as ``EncDecHarness.loss`` takes them: the training loop feeds none,
    ROADMAP C5)."""
    out = {k: torch.from_numpy(batch[k]).to("cuda") for k in ("tokens", "labels")}
    if harness.family == "audio":
        gen = torch.Generator(device="cuda").manual_seed(spec["seed"] + 100 + int(batch["step"]))
        out["frames"] = torch.randn((spec["batch"], harness.cfg.n_frames, harness.cfg.d_model), generator=gen,
                                    device="cuda").to(torch.bfloat16)
    return out


def _layer_inputs(spec: dict, harness) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer check's input and output gradient, (B, S, D) bf16 drawn on
    the card from the seed, B a data rank's share of the batch (every data
    rank takes the same)."""
    gen = torch.Generator(device="cuda").manual_seed(spec["seed"] + 5)
    shape = (spec["batch"] // 2, spec["seq"], harness.cfg.d_model)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))


def _hybrid_units(harness, params) -> list:
    """(label, fn(rt, h, weights, positions) -> the increment, weights, their
    specs) of zamba2's first Mamba2 layer (norm and mixer) and of its shared
    block."""
    from repro_torch.models import hybrid
    from repro_torch.models import layers as L
    from repro_torch.models.mamba2 import mamba2_apply, mamba2_specs
    from repro_torch.models.param import tree_map

    cfg = harness.cfg
    return [("mamba 0", lambda rt, h, w, pos: mamba2_apply(rt, w["mamba"], L.rmsnorm(w["norm"], h), cfg.mamba)[0],
             tree_map(lambda t: t[0], params["mamba_blocks"]),
             {"norm": L.rmsnorm_spec(cfg.d_model), "mamba": mamba2_specs(cfg.mamba)}),
            ("shared block", lambda rt, h, w, pos: hybrid._shared_block(rt, cfg, w, h, pos)[0] - h,
             params["shared"], hybrid._shared_specs(cfg))]


def _rank_layers(rank: int, tmp: str, spec: dict, mesh, harness, params, tag: str) -> None:
    """zamba2's layer check on the model axis, on the initial weights: each
    of ``_hybrid_units`` on the rank's positions of ``_layer_inputs``' x
    under autograd, differentiated along the rank's positions of the drawn
    output gradient with respect to its input and every weight (the rank's
    block where the rules cut it, its part of the sum where they do not).
    The first data rank's model ranks save them."""
    from repro_torch.models.layers import Runtime
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.parallel.collectives import ModelAxis
    from repro_torch.parallel.sharding import make_rules

    model = ModelAxis(mesh, make_rules())
    rt = Runtime(model=model)
    x, go = _layer_inputs(spec, harness)
    n = spec["seq"] // model.size
    rows = slice(model.rank * n, (model.rank + 1) * n)
    positions = torch.arange(rows.start, rows.stop, device="cuda")
    out = {}
    for label, fn, tree, _ in _hybrid_units(harness, params):
        xl = x[:, rows].clone().requires_grad_()
        w = tree_map(lambda t: t.detach().requires_grad_(), tree)
        with torch.enable_grad():
            y = fn(rt, xl, w, positions)
            grads = torch.autograd.grad(y, [xl] + tree_leaves(w), go[:, rows])
        out[label] = [y.detach().cpu()] + [g.cpu() for g in grads]
    if dict(zip(spec["axes"], mesh.get_coordinate()))["data"] == 0:
        torch.save(out, f"{tmp}/{tag}layers_r{rank}.pt")


def _check_rank_layers(spec: dict, ranks: list[dict], tmp: str, tag: str) -> dict:
    """zamba2's layers on the model axis against one process on the same
    input, weights and output gradient (``_rank_layers``): each rank's
    increment and input gradient on its positions, each weight's gradient
    (a cut leaf's block from its rank, a replicated leaf's the sum of the
    model ranks' parts) within 3e-2 of the one process's largest |value|,
    as the train phase holds the recurrent families' layers
    (``_train_layers``)."""
    from repro_torch.configs import load
    from repro_torch.models.layers import Runtime
    from repro_torch.models.param import tree_init, tree_leaves, tree_map, tree_pspecs
    from repro_torch.parallel.sharding import local_slices, make_rules

    harness = load(spec["arch"]).clone(n_layers=spec["n_layers"])
    params = tree_init(harness.param_specs(), torch.Generator(device="cuda").manual_seed(spec["seed"]),
                       torch.bfloat16, "cuda")
    x, go = _layer_inputs(spec, harness)
    sizes = dict(zip(spec["axes"], spec["mesh"]))
    mine = [(r, res["coord"]) for r, res in enumerate(ranks) if res["coord"]["data"] == 0]
    got = {r: torch.load(f"{tmp}/{tag}layers_r{r}.pt") for r, _ in mine}
    n = spec["seq"] // sizes["model"]
    worst, at = {"increment": 0.0, "input_grad": 0.0, "weight_grad": 0.0}, {}

    def note(key, err, want, label):
        r = err / (3e-2 * want.float().abs().max().item())
        if r > worst[key]:
            worst[key], at[key] = r, label

    for label, fn, tree, specs in _hybrid_units(harness, params):
        xi = x.clone().requires_grad_()
        w = tree_map(lambda t: t.detach().requires_grad_(), tree)
        with torch.enable_grad():
            y = fn(Runtime(), xi, w, torch.arange(spec["seq"], device="cuda"))
            want = [y.detach()] + list(torch.autograd.grad(y, [xi] + tree_leaves(w), go))
        for r, coord in mine:
            rows = slice(coord["model"] * n, (coord["model"] + 1) * n)
            for key, i in (("increment", 0), ("input_grad", 1)):
                note(key, (got[r][label][i].cuda().float() - want[i][:, rows].float()).abs().max().item(),
                     want[i], label)
        for j, (leaf, ps) in enumerate(zip(want[2:], tree_leaves(tree_pspecs(specs, make_rules())))):
            if any("model" in ((e,) if isinstance(e, str) else tuple(e or ())) for e in ps):
                for r, coord in mine:
                    blk = local_slices(ps, tuple(leaf.shape), sizes, coord)
                    note("weight_grad", (got[r][label][2 + j].cuda().float() - leaf[blk].float()).abs().max().item(),
                         leaf, f"{label} leaf {j}")
            else:
                total = sum(got[r][label][2 + j].cuda().float() for r, _ in mine)
                note("weight_grad", (total - leaf.float()).abs().max().item(), leaf, f"{label} leaf {j}")
    del params
    out = {"max_err_of_limit": worst, "at": at, "limit": "3e-2 of the one process's largest |value|",
           "units": ["mamba 0", "shared block"]}
    if not max(worst.values()) <= 1.0:
        raise SystemExit(f"dist {spec['arch']}: a layer on the model axis vs one process on the same input "
                         f"exceeds 3e-2 of the largest value: {out}")
    return out


def _rank_train(rank: int, tmp: str, spec: dict, mesh, tag: str) -> dict:
    """``spec["steps"]`` ZeRO-1 steps of ``spec["arch"]`` on ``spec``'s
    mesh (an MoE model's experts' FSDP dim gathered over "data"; an RWKV-6
    model's time-mix leaves drawn, ``_draw_time_mix``; in ``spec["dtype"]``
    where given, the drawn bf16 weights cast to it), then
    ``spec["serve"]``'s requests, if any (``_dist_serve``).  Saved (files
    tagged ``tag``): every step's params' digests, the first step's ZeRO-1
    shards' digests, its routing of each MoE layer's forward, and its
    synchronised payload by block (and the gradient, where the payload is
    not it, as int8 compression makes it), each block once over the ranks:
    the first data-parallel index's ranks save every leaf, the others the
    leaves cut over a data-parallel axis.  Returns what the checks read."""
    from repro_torch import kernels
    from repro_torch.data.pipeline import DataConfig, Pipeline, SyntheticSource
    from repro_torch.models.api import ShapeCell
    from repro_torch.models.param import tree_leaves, tree_map, tree_pspecs
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.parallel.sharding import make_rules, tree_zero1_pspecs
    from repro_torch.train.train_step import build_train_step

    multi_pod = "pod" in spec["axes"]
    harness = _serve_harness(spec)
    rules = make_rules(multi_pod=multi_pod, moe_strategy=harness.moe_strategy)
    specs = harness.param_specs()
    cell = ShapeCell("dist", "train", spec["seq"], spec["batch"])
    bundle = build_train_step(harness, cell, mesh, multi_pod=multi_pod, opt_cfg=_dist_opt_cfg(spec),
                              compression=CompressionConfig(mode=spec["compression"]), rules=rules)
    param_ps, input_ps = tree_pspecs(specs, rules), tree_pspecs(harness.train_input_specs(cell), rules)
    coord = dict(zip(spec["axes"], mesh.get_coordinate()))
    dp_axes = {a for a in ("pod", "data") if a in coord}
    first_dp = all(coord[a] == 0 for a in dp_axes)
    # the leaves whose block this rank saves: each block once over the ranks
    dp_cut = [any(dp_axes & set((e,) if isinstance(e, str) else tuple(e or ())) for e in ps)
              for ps in tree_leaves(param_ps)]
    saves = [first_dp or cut for cut in dp_cut]
    params = _local_init(specs, param_ps, mesh, spec["seed"])
    _draw_time_mix(harness, params, spec["seed"] + 3)             # whole leaves on every rank
    params = tree_map(lambda t: t.to(harness.cfg.dtype), params)
    if harness.family == "hybrid" and harness.cfg.dtype == torch.bfloat16:
        _rank_layers(rank, tmp, spec, mesh, harness, params, tag)
    opt = bundle.init_opt_state(params)
    data_cfg = DataConfig(global_batch=spec["batch"], seq_len=spec["seq"], vocab_size=harness.cfg.vocab_size,
                          seed=0)
    pipeline = Pipeline(SyntheticSource(data_cfg), data_cfg)
    torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "grad_norms": [], "step_ms": [], "launches": [], "params_digest": [],
           "wire_by_step": [], "coord": coord}
    residual, observe_s = None, 0.0

    def keep(grads, payload):         # the first step's synchronised payload (and gradient), by block
        nonlocal observe_s
        t = time.perf_counter()
        g, p = tree_leaves(grads), tree_leaves(payload)
        out["payload_is_gradient"] = all(torch.equal(a.to(b.dtype), b) for a, b in zip(g, p))
        for what, leaves in (("payload", p),) + ((("grads", g),) if not out["payload_is_gradient"] else ()):
            torch.save([x.cpu() if k else None for x, k in zip(leaves, saves)], f"{tmp}/{tag}{what}0_r{rank}.pt")
        observe_s = time.perf_counter() - t

    try:
        for step in range(spec["steps"]):
            local = _local(_batch(harness, spec, next(pipeline)), input_ps, mesh)
            wire0 = dict(bundle.fn.wire_bytes)
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # the last step under the profiler (CPU activity: the host's time in
            # each part of the step, which the transport's waits are in)
            with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
                  if step == spec["steps"] - 1 else contextlib.nullcontext()) as prof, _routing() as calls:
                params, opt, metrics, residual = bundle.fn(params, opt, local, residual,
                                                           keep if step == 0 else None)
                torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0 - observe_s) * 1e3)
            observe_s = 0.0
            if prof is not None:
                out["last_step_parts_ms"] = {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
                                             if e.key.startswith(("train.", "model.", "data.", "pod.",
                                                                  "data+model."))}
            out["launches"].append(kernels.launch_counts())
            out["losses"].append(float(metrics["loss"]))
            out["grad_norms"].append(float(metrics["grad_norm"]))
            out["params_digest"].append([_digest(p) for p in tree_leaves(params)])
            out["wire_by_step"].append({a: n - wire0.get(a, 0) for a, n in bundle.fn.wire_bytes.items()})
            if step == 0:
                out["shard_digest"] = {k: [_digest(t) for t in tree_leaves(opt[k])] for k in ("master", "m", "v")}
                if calls:             # the forward's calls (the recompute's follow, last layer first)
                    torch.save([c[0].cpu() for c in calls[:harness.cfg.n_layers]], f"{tmp}/{tag}routing0_r{rank}.pt")
    finally:
        pipeline.close()
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["wire_bytes_per_step"] = {a: n // spec["steps"] for a, n in bundle.fn.wire_bytes.items()}
    out["param_blocks"] = _blocks_of(param_ps, specs, mesh)
    out["blocks"] = _blocks_of(tree_zero1_pspecs(specs, rules, 32 if multi_pod else 16), specs, mesh)
    out["input_block"] = _blocks_of(input_ps, harness.train_input_specs(cell), mesh)[
        sorted(harness.train_input_specs(cell)).index("tokens")]
    out["n_synced"] = sum(not c for c in dp_cut)
    del params, opt, residual, bundle
    out["serve"] = {_serve_key(s): _dist_serve(rank, tmp, s, mesh) for s in spec.get("serve", [])}
    return out


def _serve_key(spec: dict) -> str:
    """A served request's name: its arch, and its type where it is not bf16."""
    return spec["arch"] + ("" if spec.get("dtype", "bfloat16") == "bfloat16" else f"_{spec['dtype']}")


def _serve_harness(spec: dict):
    """A run's or a served request's harness (its depth and, where given,
    its type)."""
    from repro_torch.configs import load

    harness = load(spec["arch"]).clone(n_layers=spec["n_layers"])
    return harness.clone(dtype=torch.float32) if spec.get("dtype") == "float32" else harness


def _serve_inputs(harness, spec: dict) -> dict:
    """A served request's prompt (batch, prompt_len) and, for a VLM, its
    prefix embeddings, drawn on the card from the seed."""
    from repro_torch.launch.serve import stub_inputs

    gen = torch.Generator(device="cuda").manual_seed(spec["seed"] + 1)
    tokens = torch.randint(0, harness.cfg.vocab_size, (spec["batch"], spec["prompt_len"]), generator=gen,
                           device="cuda", dtype=torch.int32)
    return {"tokens": tokens, **stub_inputs(harness, spec["batch"], spec["seed"] + 2, "cuda")}


def _local_init(specs, pspecs, mesh, seed: int):
    """This rank's block of each leaf of the weights ``tree_init`` draws
    from ``seed`` (bf16), drawn leaf by leaf in its order, so that no more
    than one whole leaf is held at a time."""
    from repro_torch.models.param import _init_leaf, tree_map
    from repro_torch.parallel.sharding import shard_slices

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tree_map(lambda s, ps: _init_leaf(s, gen, torch.bfloat16, "cuda")[shard_slices(ps, s.shape, mesh)]
                    .contiguous(), specs, pspecs)


def _serve_cells(harness, spec: dict):
    from repro_torch.models.api import ShapeCell

    return (ShapeCell("prefill", "prefill", spec["prompt_len"], spec["batch"]),
            ShapeCell("decode", "decode", spec["cache"], spec["batch"]))


def _serve_expected_launches(harness) -> tuple[dict[str, int], dict[str, int]]:
    """A rank's launches in prefill and in each decode step on the model
    axis (both blocks of the cache hold a visible key at every step of
    these requests).  Prefill: flash once a layer (against the keys gathered
    over "model"), an MoE layer's dispatch once; its sums: ``expert_tp``
    sums the buffer and the expert outputs over "model" (2 ``ccu_reduce``),
    ``expert_parallel`` reduce-scatters the buffer (1); the FSDP and model
    gathers sum nothing.  Decode: flash once a layer over the rank's block,
    the dispatch once a layer; 3 ``ccu_reduce`` a layer: the attention's
    combine (a reduce-scatter), the output projection's and the MLP's (or
    the MoE layer's) partial sums.

    The SSM, hybrid and audio families (every count a rank's):
    rwkv6-1.6b prefills with ``rwkv6_scan`` once a layer on the rank's
    heads, and a layer's 3 ``ccu_reduce`` in prefill and in each decode
    step: ``ln_out``'s sums of squares and ``wo``'s partial output summed
    (``all_reduce``: one reduce-scatter each), the channel mix's ``vv``
    reduce-scattered; decode is the plain recurrence (no scan).  zamba2-1.2b
    prefills with ``ssd_scan`` once a Mamba2 layer and flash once a shared
    call, 2 ``ccu_reduce`` a Mamba2 layer (``out_norm``'s sums of squares,
    ``out_proj``'s output reduce-scattered to the rank's positions); a
    decode step: flash once a shared call, 2 ``ccu_reduce`` a Mamba2 layer
    (the two sums) and 3 a shared call (as a dense layer).  whisper-base
    prefills with flash 3 times a layer (encoder, self- and
    cross-attention), summing nothing (its model-axis traffic there is
    gathers); a decode step: flash twice a layer (self-attention over the
    rank's block, cross-attention over the rank's whole heads and every
    frame: 8 heads on 2 ranks), 4 ``ccu_reduce`` a layer (the combine, the
    self- and cross-attention's ``wo`` sums, the MLP's)."""
    n = harness.cfg.n_layers
    none = {"flash_attention": 0, "moe_dispatch": 0, "ssd_scan": 0, "rwkv6_scan": 0, "flash_attention.bwd": 0}
    if harness.family == "ssm":
        return {**none, "rwkv6_scan": n, "ccu_reduce": 3 * n}, {**none, "ccu_reduce": 3 * n}
    if harness.family == "hybrid":
        c = harness.cfg.n_shared_calls
        return ({**none, "ssd_scan": n, "flash_attention": c, "ccu_reduce": 2 * n},
                {**none, "flash_attention": c, "ccu_reduce": 2 * n + 3 * c})
    if harness.family == "audio":
        return {**none, "flash_attention": 3 * n, "ccu_reduce": 0}, {**none, "flash_attention": 2 * n,
                                                                      "ccu_reduce": 4 * n}
    moe = harness.family == "moe"
    sums = 0 if not moe else (2 if harness.moe_strategy == "expert_tp" else 1)
    base = {"flash_attention": n, "moe_dispatch": n if moe else 0, "ssd_scan": 0, "rwkv6_scan": 0,
            "flash_attention.bwd": 0}
    return {**base, "ccu_reduce": sums * n}, {**base, "ccu_reduce": 3 * n}


def _dist_serve(rank: int, tmp: str, spec: dict, mesh) -> dict:
    """A served request on the model axis (a rank of the dist phase): the
    drawn prompt's rows of this rank's data-parallel share prefilled into
    its block of a cache of ``spec["cache"]`` positions (the rules'
    ``cache_seq``; a VLM's prefix first), then ``spec["steps"]`` greedy
    decode steps, the decode cell's rules (``sp`` off: tensor-parallel).
    Saves the logits, ids, the MoE layers' choices and the final cache
    block; returns the launches, times and operand bytes of each step."""
    from repro_torch import kernels
    from repro_torch.models.param import tree_init, tree_leaves, tree_map, tree_pspecs
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.train_step import build_serve_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    harness = _serve_harness(spec)
    pre, dec = _serve_cells(harness, spec)
    rules = make_rules(moe_strategy=harness.moe_strategy)
    specs = harness.param_specs()
    params = _local_init(specs, tree_pspecs(specs, rules), mesh, spec["seed"])
    _draw_time_mix(harness, params, spec["seed"] + 3)             # whole leaves on every rank
    params = tree_map(lambda t: t.to(harness.cfg.dtype), params)
    state = harness.serve_state_specs(dec)
    state_ps = tree_pspecs(state, rules)
    cache = _local(tree_init(state, None, None, "cuda"), state_ps, mesh)
    inputs = _local(_serve_inputs(harness, spec), tree_pspecs(harness.serve_input_specs(pre), rules), mesh)
    prefill = build_serve_step(harness, pre, mesh, rules=rules)
    step = build_serve_step(harness, dec, mesh, rules=make_rules(sp=False, moe_strategy=harness.moe_strategy))
    P, S = getattr(harness, "prefix_tokens", 0), spec["prompt_len"]
    out = {"launches": [], "ms": [], "wire": []}
    kept = {"logits": [], "ids": []}
    with torch.no_grad(), _routing() as calls:
        for i in range(spec["steps"] + 1):
            fn = prefill.fn if i == 0 else step.fn
            wire0 = dict(fn.wire_bytes)
            args = inputs if i == 0 else {"tokens": kept["ids"][-1].cuda(), "pos": torch.tensor(P + S + i - 1)}
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = fn(params, cache, args)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["launches"].append(kernels.launch_counts())
            out["wire"].append({a: n - wire0.get(a, 0) for a, n in fn.wire_bytes.items()})
            kept["logits"].append(logits.cpu())
            kept["ids"].append(logits.argmax(-1).to(torch.int32).cpu())
    kept["cache"] = [c.cpu() for c in tree_leaves(cache)]
    kept["routing"] = [c[0].cpu() for c in calls]
    torch.save(kept, f"{tmp}/serve_{_serve_key(spec)}_r{rank}.pt")
    out.update(cache_blocks=_blocks_of(state_ps, state, mesh), coord=dict(zip(mesh.mesh_dim_names,
                                                                               mesh.get_coordinate())),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def _check_serve(spec: dict, ranks: list[dict], tmp: str) -> dict:
    """A served request on the model axis against one process's on the
    same weights and prompt (``harness.prefill`` and ``decode``), the one
    process fed the ranks' ids at every step and routed by their MoE
    choices (a bf16 near-tie may route or choose apart: one token to
    another expert moves its output by O(1)).  Held: each rank's logits (its
    share's rows) at every step within 3e-2 of the largest |logit| (at
    least 3e-2), as the serve phase holds its paths; at every step the ids
    the ranks chose equal to the one process's best, but at a near-tie:
    a row whose one-process margin of its best over the ranks' id is no
    more than the error measured on those two logits (|the ranks' logit -
    the one process's| of each, summed: the most by which two logits that
    far apart can change places), each listed with its step, row and margin
    (``near_ties``), the chosen id also within the logit limit of the best;
    each rank's final cache block within 3e-2 of the
    largest |value| of the one process's matching slice; every rank's
    launches in prefill and in each decode step as
    ``_serve_expected_launches`` works them out."""
    from repro_torch.models.layers import Runtime
    from repro_torch.models.param import tree_init, tree_leaves, tree_map

    harness = _serve_harness(spec)
    pre, dec = _serve_cells(harness, spec)
    n, steps = harness.cfg.n_layers, spec["steps"]
    got = [torch.load(f"{tmp}/serve_{_serve_key(spec)}_r{r}.pt") for r in range(len(ranks))]
    mine = [r["serve"][_serve_key(spec)] for r in ranks]
    B, T = spec["batch"], getattr(harness, "prefix_tokens", 0) + spec["prompt_len"]
    n_data = len({m["coord"]["data"] for m in mine})
    rows = [slice(m["coord"]["data"] * B // n_data, (m["coord"]["data"] + 1) * B // n_data) for m in mine]
    by_model = {}
    for g, m, rw in zip(got, mine, rows):
        by_model.setdefault(m["coord"]["model"], []).append((g, rw))
    # the ranks' ids and MoE choices, whole: prefill's along the sequence by
    # model rank, decode's from any model rank (they hold the same)
    ids = [torch.zeros((B, 1), dtype=torch.int32) for _ in range(steps)]
    for g, rw in by_model[0]:
        for i in range(steps):
            ids[i][rw] = g["ids"][i]
    replay = []
    for call in range(len(got[0]["routing"])):
        K = got[0]["routing"][call].shape[-1]
        whole = torch.zeros((B, T if call < n else 1, K), dtype=torch.int64)
        for mrank, members in by_model.items():
            for g, rw in members:
                c = g["routing"][call]
                at = slice(mrank * c.shape[1], (mrank + 1) * c.shape[1]) if call < n else slice(0, 1)
                whole[rw, at] = c
        replay.append((whole.cuda(), None))
    params = tree_init(harness.param_specs(), torch.Generator(device="cuda").manual_seed(spec["seed"]),
                       torch.bfloat16, "cuda")
    _draw_time_mix(harness, params, spec["seed"] + 3)
    params = tree_map(lambda t: t.to(harness.cfg.dtype), params)
    cache = tree_init(harness.serve_state_specs(dec), None, None, "cuda")
    inputs = _serve_inputs(harness, spec)
    P, S = getattr(harness, "prefix_tokens", 0), spec["prompt_len"]
    one = []
    with torch.no_grad(), _routing(replay=replay or None):
        t0 = time.perf_counter()
        logits, cache = harness.prefill(Runtime())(params, cache, **inputs)
        one.append(logits.float().cpu())
        for i in range(steps):
            logits, cache = harness.decode(Runtime())(params, cache, ids[i].cuda(), P + S + i)
            one.append(logits.float().cpu())
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
    cache = [c.cpu() for c in tree_leaves(cache)]
    logit_witness = cache_witness = None
    if harness.family in RECURRENT and harness.cfg.dtype == torch.bfloat16:
        # as the serve phase holds these families: each limit the larger of
        # 3e-2 of the largest and how far the one process moves when 1 % of
        # the prompt's embedding moves by one ulp (``_moved_prompt``), or
        # when it runs the plain path, fed the same ids
        logit_witness = [0.0] * (steps + 1)
        cache_witness = [0.0] * len(cache)
        for rt, moved_prompt in ((Runtime(), _moved_prompt(spec["seed"])),
                                 (Runtime(use_kernels=False), contextlib.nullcontext())):
            other = tree_init(harness.serve_state_specs(dec), None, None, "cuda")
            with torch.no_grad(), moved_prompt:
                logits, other = harness.prefill(rt)(params, other, **inputs)
                seen = [logits.float().cpu()]
                for i in range(steps):
                    logits, other = harness.decode(rt)(params, other, ids[i].cuda(), P + S + i)
                    seen.append(logits.float().cpu())
            logit_witness = [max(w, (a - b).abs().max().item()) for w, a, b in zip(logit_witness, seen, one)]
            cache_witness = [max(w, (a.float().cpu() - b.float()).abs().max().item())
                             for w, a, b in zip(cache_witness, tree_leaves(other), cache)]
            del other
    del params
    torch.cuda.empty_cache()
    logit_err = logit_of_limit = short = cache_of_limit = 0.0
    near_ties = []
    for i, ref in enumerate(one):
        limit = 3e-2 * max(1.0, ref.abs().max().item())
        if logit_witness is not None:
            limit = max(limit, logit_witness[i])
        for g, rw in zip(got, rows):
            err = (g["logits"][i].float() - ref[rw]).abs().max().item()
            logit_err, logit_of_limit = max(logit_err, err), max(logit_of_limit, err / limit)
        if i < steps:
            chosen = torch.gather(ref, -1, ids[i][..., None].long())[..., 0]
            short = max(short, (ref.max(-1).values - chosen).max().item() / limit)
            best = ref.argmax(-1)
            for b in torch.nonzero(best[:, 0] != ids[i][:, 0].long()).flatten().tolist():
                two = [int(best[b, 0]), int(ids[i][b, 0])]
                held = [g["logits"][i][b - rw.start, 0].float() for g, rw in zip(got, rows) if rw.start <= b < rw.stop]
                err = max((x[two] - ref[b, 0, two]).abs().sum().item() for x in held)
                margin = (ref[b, 0, two[0]] - ref[b, 0, two[1]]).item()
                near_ties.append({"step": i, "row": b, "best": two[0], "chosen": two[1], "margin": margin,
                                  "error_on_the_two": err, "row_max_error": max((x - ref[b, 0]).abs().max().item()
                                                                                for x in held),
                                  "margin_of_limit": margin / limit})
    ids_ok = all(t["margin"] <= t["error_on_the_two"] for t in near_ties)
    for g, m in zip(got, mine):
        for j, (c, want, b) in enumerate(zip(g["cache"], cache, m["cache_blocks"])):
            want = want[tuple(slice(x, y) for x, y in b)].float()
            lim = 3e-2 * max(want.abs().max().item(), 1e-30)
            if cache_witness is not None:
                lim = max(lim, cache_witness[j])
            cache_of_limit = max(cache_of_limit, (c.float() - want).abs().max().item() / lim)
    want_pre, want_dec = _serve_expected_launches(harness)
    launches_ok = all(m["launches"][0] == want_pre and all(c == want_dec for c in m["launches"][1:]) for m in mine)
    out = {"arch": spec["arch"], "n_layers": n, "batch": B, "prompt_len": spec["prompt_len"], "prefix": P,
           "cache": spec["cache"] + P, "decode_steps": steps, "mesh": {"data": 2, "model": 2},
           "prefill_ms_by_rank": [m["ms"][0] for m in mine],
           "decode_ms_per_token_by_rank": [sum(m["ms"][1:]) / steps for m in mine],
           "single_process_s": single_s, "peak_memory_gb_by_rank": [m["peak_memory_gb"] for m in mine],
           "prefill_wire_bytes_rank0": mine[0]["wire"][0], "decode_wire_bytes_per_step_rank0": mine[0]["wire"][-1],
           "logits_max_abs_err": logit_err, "logits_of_limit": logit_of_limit, "chosen_short_of_best_of_limit": short,
           "same_ids": not near_ties, "near_ties": near_ties, "ids_equal_but_near_ties": ids_ok,
           "cache_worst_of_limit": cache_of_limit,
           "limit": "3e-2 of the largest |logit| (at least 3e-2) / of the largest |cache value|" + (
               "" if logit_witness is None else ", or the witness where larger (the one process with 1 % of "
                                                "its prompt's embedding one ulp up, or through the plain path)"),
           "logit_witness_by_step": logit_witness, "cache_witness_by_leaf": cache_witness,
           "routing_replayed_calls": len(replay), "launches_prefill_rank0": mine[0]["launches"][0],
           "launches_decode_step_rank0": mine[0]["launches"][-1], "expected_prefill": want_pre,
           "expected_decode_step": want_dec, "launches_as_expected": launches_ok}
    # a hybrid model in bf16 carries the ranks' other roundings in every
    # layer past its witness at depth (PERF.md §6): its request is held end
    # to end in fp32, as C7 holds its paths, and in bf16 for its ids and
    # launches, the logits and caches reported
    held = harness.family != "hybrid" or harness.cfg.dtype == torch.float32
    out["dtype"], out["logits_and_caches_held"] = str(harness.cfg.dtype).split(".")[-1], held
    if not (short <= 1.0 and ids_ok and launches_ok and (not held or (logit_of_limit <= 1.0
                                                                       and cache_of_limit <= 1.0))):
        raise SystemExit(f"dist serve of {_serve_key(spec)} on the model axis: a check failed: {out}")
    return out


def _moe_train_expected_launches(harness, n_synced: int) -> dict[str, int]:
    """A step of one rank of an ``expert_tp`` MoE model on (data, model) =
    (2, 2), worked out from the code: every layer's attention and dispatch
    run in the forward and the remat's recompute (2 each); a layer's
    ``ccu_reduce``: the backward's reduce-scatters of its 4 attention
    weights and of K and V over "model" and of its 3 experts over "data"
    (9), and 3 sums (forward, recompute, backward) each of the dispatch
    buffer, the expert outputs and the auxiliary loss's means (9); the
    token table's and the unembedding's reduce-scatters (2), the sum of the
    losses and replicated gradients over "model" (1), each leaf not cut
    over "data" reduce-scattered over it (``n_synced``), each leaf's sum of
    squares over "model" and over "data" (2)."""
    n = harness.cfg.n_layers
    return {"flash_attention": 2 * n, "moe_dispatch": 2 * n, "ssd_scan": 0, "rwkv6_scan": 0,
            "ccu_reduce": 18 * n + 2 + 1 + n_synced + 2, **_bwd(harness, n)}


def _check_moe_train(spec: dict, ranks: list[dict], tmp: str) -> dict:
    """The MoE mesh's training held by ``_check_train_leafwise``, its
    launches as ``_moe_train_expected_launches`` works them out, its
    payload the gradient (no compression)."""
    from repro_torch.configs import load

    harness = load(spec["arch"]).clone(n_layers=spec["n_layers"])
    out = _check_train_leafwise(spec, ranks, tmp, _moe_train_expected_launches(harness, ranks[0]["n_synced"]))
    out["strategy"] = harness.moe_strategy
    if not out["payload_is_gradient"]:
        raise SystemExit(f"dist MoE training: the payload is not the gradient: {out}")
    return out


def _family_train_expected_launches(harness, n_leaves: int) -> dict[str, int]:
    """A train step of one rank of the SSM, hybrid or audio family on
    (data, model) = (2, 2), int8, worked out from the code.  Every family:
    the sum of the losses and replicated gradients over "model" and each
    leaf's sum of squares there (2), each leaf reduce-scattered over
    "data" and its int8 payload (2 a leaf).  rwkv6-1.6b (its blocks
    recomputed): a layer's scan twice and 9 ``ccu_reduce`` (forward and
    recompute 3 each: ``ln_out``'s sums of squares, ``wo``'s sum, the
    channel mix's reduce-scatter; backward 3: the two sums' backward sums
    and the product's gather's reduce-scatter), the embedding's and the
    logits' gathers' reduce-scatters (2).  zamba2-1.2b: a Mamba2 layer's
    scan twice and 6 (forward 2: the sums of squares, the output's
    reduce-scatter; recompute 1: it stops before the reduce-scatter, whose
    backward keeps nothing; backward 3: the reduce-scatters of the x and
    ``in_proj`` gathers, the sums of squares' backward sum), a shared call's
    flash once (not recomputed) and 9 reduce-scatters (its 7 gathered
    weights, K and V), the token table's and the unembedding's (2).
    whisper-base (encoder and decoder blocks recomputed): an encoder layer's
    flash twice and 12 reduce-scatters (its 10 gathered weights and biases,
    K and V), a decoder layer's flash 4 times (self- and cross-attention)
    and 19 (17 gathered leaves, the self-attention's K and V), the encoder
    output's gather's (1), the token table's and the unembedding's (2)."""
    n = harness.cfg.n_layers
    none = {"flash_attention": 0, "moe_dispatch": 0, "ssd_scan": 0, "rwkv6_scan": 0, "flash_attention.bwd": 0}
    base = 2 + 2 * n_leaves
    if harness.family == "ssm":
        return {**none, "rwkv6_scan": 2 * n, "ccu_reduce": 9 * n + 2 + base}
    if harness.family == "hybrid":
        c = harness.cfg.n_shared_calls
        return {**none, "ssd_scan": 2 * n, "flash_attention": c, "ccu_reduce": 6 * n + 9 * c + 2 + base,
                **_bwd(harness, c)}
    return {**none, "flash_attention": 6 * n, "ccu_reduce": 31 * n + 3 + base, **_bwd(harness, 3 * n)}


def _check_train_leafwise(spec: dict, ranks: list[dict], tmp: str, expected: dict, tag: str = "") -> dict:
    """A model-axis mesh's training held leaf by leaf (``phase_dist``):
    every block of every leaf bit-identical on the ranks that hold it,
    after every step (the data ranks share the leaves not cut over "data");
    the clip norm the same on every rank and within 1e-5 of the whole
    payload's; each rank's ZeRO-1 shard of master / m / v after the first
    step, and its params, bit-equal to ``step_scalars`` (with the ranks'
    norm) + ``update_leaf`` on the whole leaf, leaf by leaf; the first
    step's loss and synchronised gradients within 3e-2 (of each leaf's
    largest |g|; a key bias's, whose exact value is zero, of its
    projection's weights') of one process's (``value_and_grad`` of the loss
    on the same first batch, an MoE model routed by the ranks' choices); the
    launches of every step and rank ``expected``.  ``tag`` names the
    ranks' files of this run.  A recurrent family's bf16 gradients are
    reported beside two witnesses of the one process's own rounding; the
    hybrid family's in bf16 are not held at whole depth but layer by layer
    (``_check_rank_layers``), as the train phase holds it: a random zamba2
    in bf16 carries the ranks' other roundings in every layer past the
    3e-2 at 7 layers (PERF.md §6); its fp32 run is held whole."""
    from repro_torch.data.pipeline import DataConfig, Pipeline, SyntheticSource
    from repro_torch.models.layers import Runtime
    from repro_torch.models.param import tree_init, tree_leaves, tree_map, value_and_grad
    from repro_torch.optim import adamw

    harness = _serve_harness(spec)
    names = list(_leaf_sizes(harness))
    n = harness.cfg.n_layers
    # 1. every block the same on the ranks that hold it
    identical = True
    for step in range(spec["steps"]):
        seen = {}
        for r in ranks:
            for i, (blk, d) in enumerate(zip(r["param_blocks"], r["params_digest"][step])):
                key = (i, str(blk))
                identical = identical and seen.setdefault(key, d) == d
    launches_ok = all(c == expected for r in ranks for c in r["launches"])
    like = _assemble(harness, ranks, tmp, "payload", tag)
    cfg = _dist_opt_cfg(spec)
    whole = float(torch.sqrt(sum(torch.sum(torch.square(g.cuda().float())) for g in like)))
    norm = {"ranks": ranks[0]["grad_norms"][0], "whole_payload": whole,
            "same_on_every_rank": all(r["grad_norms"] == ranks[0]["grad_norms"] for r in ranks),
            "rel_err": abs(ranks[0]["grad_norms"][0] - whole) / whole, "limit": 1e-5}
    if not (norm["same_on_every_rank"] and norm["rel_err"] <= norm["limit"]):
        raise SystemExit(f"dist {spec['arch']}: the clip norm failed: {norm}")
    # 2. the shards and params leaf by leaf, from the same drawn weights
    params = tree_init(harness.param_specs(), torch.Generator(device="cuda").manual_seed(spec["seed"]),
                       torch.bfloat16, "cuda")
    _draw_time_mix(harness, params, spec["seed"] + 3)
    params = tree_map(lambda t: t.to(harness.cfg.dtype), params)
    k = adamw.step_scalars(cfg, None, {"step": torch.zeros((), dtype=torch.int32, device="cuda")},
                           torch.tensor(norm["ranks"], dtype=torch.float32, device="cuda"))
    mismatch = []
    for i, (p, g) in enumerate(zip(tree_leaves(params), like)):
        master = p.to(torch.float32, copy=True)           # updated in place below
        m, v = torch.zeros_like(master), torch.zeros_like(master)
        adamw.update_leaf(cfg, k, g.cuda().to(cfg.grad_dtype), m, v, master)
        for r, res in enumerate(ranks):
            zb = tuple(slice(a, b) for a, b in res["blocks"][i])
            for key, full in (("master", master), ("m", m), ("v", v)):
                if _digest(full[zb]) != res["shard_digest"][key][i]:
                    mismatch.append((r, key, names[i]))
            pb = tuple(slice(a, b) for a, b in res["param_blocks"][i])
            if _digest(master.to(p.dtype)[pb]) != res["params_digest"][0][i]:
                mismatch.append((r, "params", names[i]))
        del master, m, v
    del like
    torch.cuda.empty_cache()
    # 3. one process on the first batch (an MoE model routed by the ranks' choices)
    data_cfg = DataConfig(global_batch=spec["batch"], seq_len=spec["seq"], vocab_size=harness.cfg.vocab_size, seed=0)
    pipeline = Pipeline(SyntheticSource(data_cfg), data_cfg)
    try:
        batch = _batch(harness, spec, next(pipeline))
    finally:
        pipeline.close()
    forward = []
    if os.path.exists(f"{tmp}/{tag}routing0_r0.pt"):
        for layer in range(n):
            whole_idx = None
            for r, res in enumerate(ranks):
                c = torch.load(f"{tmp}/{tag}routing0_r{r}.pt")[layer]
                if whole_idx is None:
                    whole_idx = torch.zeros((spec["batch"], spec["seq"], c.shape[-1]), dtype=c.dtype)
                whole_idx[tuple(slice(a, b) for a, b in res["input_block"])] = c
            forward.append((whole_idx.cuda(), None))
    t0 = time.perf_counter()
    with _routing(replay=(forward + forward[::-1]) or None):
        loss, grads = value_and_grad(harness.loss(Runtime()))(params, batch)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    grads = tree_leaves(grads)
    limits = [3e-2 * g.float().abs().max().item() for g in grads]
    for i, name in enumerate(names):
        if name.endswith("attn.bk"):
            # a key bias adds one constant to a query's every score: its exact
            # gradient is zero, so both sides are rounding noise; held against
            # the same projection's weights' gradient instead
            limits[i] = limits[names.index(name[:-2] + "wk")]
    witness = None
    if harness.family in RECURRENT and harness.cfg.dtype == torch.bfloat16:
        # reported, in units of each leaf's limit: how far a recurrent
        # model's one process moves its own gradient when 1 % of its
        # embedded batch moves by one ulp (``_moved_prompt``), or when its
        # layers run the plain path (other roundings in every layer, as the
        # ranks' partial sums have)
        with _moved_prompt(spec["seed"]):
            _, moved = value_and_grad(harness.loss(Runtime()))(params, batch)
        _, plain = value_and_grad(harness.loss(Runtime(use_kernels=False)))(params, batch)
        witness = {what: [(a.float() - b.float()).abs().max().item() / lim
                          for a, b, lim in zip(tree_leaves(t), grads, limits)]
                   for what, t in (("one_ulp", moved), ("plain_path", plain))}
        del moved, plain
    del params
    synced = _assemble(harness, ranks, tmp, "grads", tag)
    # a rank's loss is its data share's, summed over the model ranks: the same on each of them
    shares = {r["coord"]["data"]: r["losses"][0] for r in ranks}
    mean_loss = sum(shares.values()) / len(shares)
    of_limit = [(a.cuda().float() - b.float()).abs().max().item() / lim for a, b, lim in zip(synced, grads, limits)]
    worst = max(range(len(names)), key=lambda i: of_limit[i])
    del grads, synced
    torch.cuda.empty_cache()
    out = {"arch": spec["arch"], "n_layers": n, "params": sum(_leaf_sizes(harness).values()),
           "mesh": dict(zip(spec["axes"], spec["mesh"])), "ranks": len(ranks), "global_batch": spec["batch"],
           "seq": spec["seq"], "steps": spec["steps"], "compression": spec["compression"],
           "transport": "gloo (torch.distributed), one process group a mesh axis; each CUDA tensor staged "
                        "through host memory; every sum in ccu_reduce on the card",
           "step_ms_by_rank": [r["step_ms"] for r in ranks],
           "last_step_parts_ms_by_rank": [r["last_step_parts_ms"] for r in ranks],
           "peak_memory_gb_by_rank": [r["peak_memory_gb"] for r in ranks],
           "wire_bytes_per_step_rank0": ranks[0]["wire_by_step"][-1],
           "losses_by_rank": [r["losses"] for r in ranks], "first_step_mean_loss": mean_loss,
           "single_process_loss": float(loss), "single_process_s": single_s,
           "loss_max_abs_err": abs(mean_loss - float(loss)), "loss_limit": 3e-2,
           "grad_worst_of_limit": of_limit[worst], "grad_worst_leaf": names[worst],
           "grad_limit": "3e-2 of the leaf's largest |g|", "grad_of_limit_by_leaf": dict(zip(names, of_limit)),
           "grad_witness_of_limit_by_leaf": None if witness is None else {
               what: dict(zip(names, w)) for what, w in witness.items()}, "clip_norm": norm,
           "payload_is_gradient": all(r["payload_is_gradient"] for r in ranks),
           "blocks_bit_identical_every_step": identical, "shards_and_params_equal_update_leaf": not mismatch,
           "mismatches": mismatch[:10], "launches_per_step_and_rank": ranks[0]["launches"][0],
           "expected_launches": expected, "launches_as_expected": launches_ok}
    held = harness.family != "hybrid" or harness.cfg.dtype != torch.bfloat16
    out["dtype"], out["whole_depth_gradients_held"] = str(harness.cfg.dtype).split(".")[-1], held
    if not held:
        out["layers"] = _check_rank_layers(spec, ranks, tmp, tag)
    if not (identical and not mismatch and launches_ok and out["loss_max_abs_err"] <= 3e-2
            and (of_limit[worst] <= 1.0 or not held) and math.isfinite(mean_loss)):
        raise SystemExit(f"dist training of {spec['arch']}: a check failed: {out}")
    return out


def _ccu_dist_rows(rows: dict[str, tuple[int, int]], dtypes: tuple, what: str) -> dict:
    """``ccu_reduce`` at the dist phase's P = 2 rows: for each of ``rows``
    (name -> (N, launches a step and rank)) and each of ``dtypes`` (``what``
    says which collectives sum them), bit-equal to the plain version; times
    summed over the launches of a step and rank.  Bound: bytes, 2 rows read
    and the fp32 sums written; library: ``bufs.float().sum(0)``, the same
    sum (two rows in one order)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ccu_reduce import ccu_reduce_plain

    gen = torch.Generator(device="cuda").manual_seed(DIST["seed"] + 7)
    totals = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    by_kind, largest = {}, None
    for name, (N, count) in rows.items():
        for dt in dtypes:
            bufs = _rand(gen, (2, N), dt, 1e-3)
            o = ops.ccu_reduce(bufs)
            torch.cuda.synchronize()
            if not (torch.equal(o, ccu_reduce_plain(bufs)) and torch.equal(o, ops.ccu_reduce(bufs))):
                raise SystemExit(f"ccu_reduce at the dist rows of {name} ({dt}) is not bit-equal to plain")
            ms, call_ms = time_ms(lambda: ops.ccu_reduce(bufs))
            row = {"N": N, "ms": ms, "call_ms": call_ms, "plain_ms": time_ms(lambda: ccu_reduce_plain(bufs))[0],
                   "library_ms": time_ms(lambda: bufs.float().sum(0))[0],
                   "bound_ms": (bufs.numel() * bufs.element_size() + 4 * N) / HBM_BYTES_PER_S * 1e3}
            kind = str(dt).split(".")[-1]
            for k in totals:
                totals[k] += count * row[k]
                by_kind.setdefault(kind, dict.fromkeys(totals, 0.0))[k] += count * row[k]
            if dt == torch.bfloat16 and (largest is None or N > largest["N"]):
                largest = {"rows": name, **row}
            del bufs, o
    return {"shape": what, "launches": sum(c for _, c in rows.values()) * len(dtypes), **totals,
            "by_kind": by_kind, "largest_bf16_row": largest, "bit_equal_to_plain": True,
            "library_call": "bufs.float().sum(0)"}


def _model_axis_rows(harness, spec: dict) -> dict[str, tuple[int, int]]:
    """The model axis's reduce-scatters in one step of ``spec``: (N, launches)
    with N half of each gathered tensor (a layer's 7 weights, its K and V of
    the rank's sequences, once a layer; the token table, the unembedding)."""
    cfg, L = harness.cfg, harness.cfg.n_layers
    sizes = _leaf_sizes(harness)
    rows = {f"{k} (a layer)": (n // L // 2, L) for k, n in sizes.items()
            if k.startswith("blocks.attn.w") or k.startswith("blocks.mlp.")}
    rows.update({k: (n // 2, 1) for k, n in sizes.items() if k.startswith("embed.")})
    dp = math.prod(n for a, n in zip(spec["axes"], spec["mesh"]) if a != "model")
    kv = spec["batch"] // dp * spec["seq"] * cfg.n_kv_heads * cfg.head_dim
    rows["k (a layer)"] = rows["v (a layer)"] = (kv // 2, L)
    return rows


def _spawn(spec: dict) -> tuple[list[dict], float, str]:
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    world = math.prod(spec["mesh"])
    # the ranks allocate in expandable segments: four training states share the card
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t0 = time.perf_counter()
    mp.spawn(_dist_rank, args=(world, tmp, spec), nprocs=world, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(f"{tmp}/rank{r}.json") as f:
            ranks.append(json.load(f))
    return ranks, spawn_s, tmp


def _assemble(harness, ranks: list[dict], tmp: str, what: str, tag: str = "") -> list[torch.Tensor]:
    """The first step's ``what`` (grads or payload) whole, from each block's
    one saver (``_rank_train``; its files tagged ``tag``); the payload
    where it is the gradient."""
    from repro_torch.models.param import tree_leaves

    if what == "grads" and ranks[0]["payload_is_gradient"]:
        what = "payload"
    full = [torch.zeros(s.shape, dtype=torch.bfloat16) for s in tree_leaves(harness.param_specs())]
    for r, res in enumerate(ranks):
        for f, g, blk in zip(full, torch.load(f"{tmp}/{tag}{what}0_r{r}.pt"), res["param_blocks"]):
            if g is not None:
                f[tuple(slice(a, b) for a, b in blk)] = g
    return full


def _check_mesh(spec: dict, ranks: list[dict], tmp: str, harness, single: dict, names: list) -> dict:
    """One mesh's ranks held (``phase_dist``); returns what ``emit`` prints."""
    from repro_torch.models.param import tree_init, tree_leaves
    from repro_torch.optim import adamw

    world = len(ranks)
    # 1. the same params on every rank of a model coordinate after every step
    by_model = {}
    for r in ranks:
        by_model.setdefault(r["coord"].get("model", 0), []).append(r["params_digest"])
    identical = all(d == group[0] for group in by_model.values() for d in group)
    # 4. launches
    expected = _dist_expected_launches(harness, len(names), spec)
    launches_ok = all(c == expected for r in ranks for c in r["launches"])
    # 2. each shard against adamw.apply on the same payload, from the same weights
    payload = _assemble(harness, ranks, tmp, "payload")
    params = tree_init(harness.param_specs(), torch.Generator(device="cuda").manual_seed(spec["seed"]),
                       torch.bfloat16, "cuda")
    state = adamw.init_opt_state(params)
    cfg = _dist_opt_cfg()
    grads = _tree_like(params, [g.cuda().to(cfg.grad_dtype) for g in payload])
    del payload
    norm = None
    if dict(zip(spec["axes"], spec["mesh"])).get("model", 1) == 1:
        adamw.apply(cfg, params, grads, state)           # the norm from the whole payload, as PR 21
    else:
        # a rank holds only its model shard, so its clip norm is a sum over the model
        # ranks: held first, the same bits on every rank at every step and within 1e-5
        # of the whole payload's norm; then the shards are held given that norm
        whole = float(adamw.global_norm(grads))
        same = all(r["grad_norms"] == ranks[0]["grad_norms"] for r in ranks)
        norm = {"ranks": ranks[0]["grad_norms"][0], "whole_payload": whole, "same_on_every_rank": same,
                "rel_err": abs(ranks[0]["grad_norms"][0] - whole) / whole, "limit": 1e-5}
        if not (same and norm["rel_err"] <= norm["limit"]):
            raise SystemExit(f"dist {dict(zip(spec['axes'], spec['mesh']))}: the clip norm failed: {norm}")
        k = adamw.step_scalars(cfg, grads, state, torch.tensor(norm["ranks"], dtype=torch.float32, device="cuda"))
        flat = zip(tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]),
                   tree_leaves(state["master"]), tree_leaves(params))
        for g, m, v, master, p in flat:
            adamw.update_leaf(cfg, k, g, m, v, master)
            p.copy_(master)
        state["step"] = k["step"]
    del grads
    shard_mismatch = []
    for r, res in enumerate(ranks):
        for k in ("master", "m", "v"):
            for i, (full, blk) in enumerate(zip(tree_leaves(state[k]), res["blocks"])):
                if _digest(full[tuple(slice(a, b) for a, b in blk)]) != res["shard_digest"][k][i]:
                    shard_mismatch.append((r, k, names[i]))
    params_as_apply = all(
        [_digest(p[tuple(slice(a, b) for a, b in blk)]) for p, blk in zip(tree_leaves(params), res["param_blocks"])]
        == res["params_digest"][0] for res in ranks)
    del params, state
    torch.cuda.empty_cache()
    # 3. against one process at the same global batch, from the same weights
    synced = _assemble(harness, ranks, tmp, "grads")
    shares = {}
    for r in ranks:
        shares[tuple(v for a, v in r["coord"].items() if a != "model")] = r["losses"]
    mean_losses = [sum(x[s] for x in shares.values()) / len(shares) for s in range(spec["steps"])]
    loss_err = max(abs(a - b) for a, b in zip(mean_losses, single["losses"]))
    of_limit = [(a.float() - b.float()).abs().max().item() / (3e-2 * b.float().abs().max().item())
                for a, b in zip(synced, single["first_grads"])]
    worst = max(range(len(names)), key=lambda i: of_limit[i])
    del synced
    out = {"arch": spec["arch"], "n_layers": spec["n_layers"], "params": single["params"],
           "mesh": dict(zip(spec["axes"], spec["mesh"])), "ranks": world, "global_batch": spec["batch"],
           "seq": spec["seq"], "steps": spec["steps"], "compression": spec["compression"],
           "transport": "gloo (torch.distributed), one process group a mesh axis; each CUDA tensor staged "
                        "through host memory; every sum in ccu_reduce on the card",
           "note": "four ranks share one card: the times measure the port's overhead and the kernels, "
                   "not data-parallel scaling",
           "step_ms_by_rank": [r["step_ms"] for r in ranks],
           "last_step_parts_ms_by_rank": [r["last_step_parts_ms"] for r in ranks],
           "peak_memory_gb_by_rank": [r["peak_memory_gb"] for r in ranks],
           "wire_bytes_per_step_rank0": ranks[0]["wire_bytes_per_step"],
           "losses_by_rank": [r["losses"] for r in ranks], "mean_losses": mean_losses,
           "single_process": {"losses": single["losses"], "step_ms": single["step_ms"],
                              "peak_memory_gb": single["peak_memory_gb"]},
           "loss_max_abs_err": loss_err, "loss_limit": 3e-2,
           "grad_worst_of_limit": of_limit[worst], "grad_worst_leaf": names[worst],
           "grad_limit": "3e-2 of the leaf's largest |g|", "clip_norm": norm,
           "params_bit_identical_every_step": identical, "params_equal_adamw_apply": params_as_apply,
           "shards_equal_adamw_apply": not shard_mismatch, "shard_mismatches": shard_mismatch[:10],
           "launches_per_step_and_rank": ranks[0]["launches"][0], "expected_launches": expected,
           "launches_as_expected": launches_ok}
    if not (identical and params_as_apply and not shard_mismatch and launches_ok and loss_err <= 3e-2
            and of_limit[worst] <= 1.0 and all(math.isfinite(x) for x in mean_losses)):
        raise SystemExit(f"dist {out['mesh']}: a check failed: {out}")
    return out


def _check_dryrun(what: str, spec: dict, build, measured: dict, peak_gb: float | None) -> dict:
    """``train_step.lower_bundle`` of the bundle ``build(mesh)`` makes over
    a fake process group of ``spec``'s mesh, on the meta device (the
    dry-run's trace, the plain path): its operand bytes by axis equal to
    ``measured``, what rank 0's transports recorded in a warm step of the
    same cell; where ``peak_gb`` is given (a train step), its argument
    bytes (this rank's blocks) at or below rank 0's measured peak."""
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.train.train_step import lower_bundle

    t0 = time.perf_counter()
    with fake_mesh(spec["mesh"], spec["axes"]) as mesh:
        low = lower_bundle(build(mesh), mesh)
    peak = None if peak_gb is None else peak_gb * 1e9
    out = {"step": what, "mesh": dict(zip(spec["axes"], spec["mesh"])), "seconds": time.perf_counter() - t0,
           "operand_bytes_by_axis": low["operand_bytes_by_axis"], "rank0_warm_step_bytes_by_axis": measured,
           "equal": low["operand_bytes_by_axis"] == measured, "collectives": len(low["records"]),
           "c10d_ops": low["c10d_ops"], "memory": low["memory"], "rank0_peak_bytes": peak,
           "argument_bytes_at_or_below_peak": peak is None or low["memory"]["argument_bytes"] <= peak,
           "flops": low["flops"], "hbm_bytes_upper_bound": low["hbm_bytes"]}
    if not (out["equal"] and out["argument_bytes_at_or_below_peak"] and low["c10d_ops"] == len(low["records"])):
        raise SystemExit(f"dist dry-run of {what} against the run: {out}")
    return out


def _train_bundle(spec: dict):
    """The bundle of ``spec``'s train cell on a mesh, the plain path."""
    from repro_torch.configs import load
    from repro_torch.models.api import ShapeCell
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.train_step import build_train_step

    harness = load(spec["arch"]).clone(n_layers=spec["n_layers"])
    multi_pod = "pod" in spec["axes"]
    return lambda mesh: build_train_step(
        harness, ShapeCell("dist", "train", spec["seq"], spec["batch"]), mesh, multi_pod=multi_pod,
        opt_cfg=_dist_opt_cfg(spec), compression=CompressionConfig(mode=spec["compression"]),
        rules=make_rules(multi_pod=multi_pod, moe_strategy=harness.moe_strategy), use_kernels=False)


def _decode_bundle(spec: dict):
    """The bundle of a served request's decode cell on a mesh, the plain
    path."""
    from repro_torch.configs import load
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.train_step import build_serve_step

    harness = load(spec["arch"]).clone(n_layers=spec["n_layers"])
    _, dec = _serve_cells(harness, spec)
    return lambda mesh: build_serve_step(harness, dec, mesh, use_kernels=False,
                                         rules=make_rules(sp=False, moe_strategy=harness.moe_strategy))


RECURRENT = ("ssm", "hybrid")      # families whose bf16 requests are held within a one-ulp witness


def phase_dist() -> tuple[dict[str, dict[str, int]], dict, dict]:
    """The ZeRO-1 train step on four ranks of one card, on three meshes and
    four spawns (``DIST``: (pod, data, model) = (2, 2, 1); ``DIST_MODEL``: (data, model)
    = (2, 2), the dense family's sequence-parallel model axis, then served
    requests on it; ``DIST_MOE``: the same mesh, the MoE family, its
    experts' FSDP over "data", then its requests; ``DIST_FAMILIES``: the
    same mesh, the SSM, hybrid and audio families, one spawn, each trained
    and served, held by ``_check_train_leafwise`` and ``_check_serve``),
    the ranks spawned once the kernels are built (``_dist_rank``), then held
    here (``_check_mesh``, ``_check_moe_train``): the params of every rank
    bit-identical where they hold the same block, after every step; each
    rank's ZeRO-1 shard of master / m / v after the first step equal to
    ``adamw.apply`` (or ``update_leaf``, leaf by leaf) of the whole trees on
    the first step's synchronised payload (gathered from the ranks' blocks)
    with the ranks' norm, bit for bit (digests); the losses and the first
    step's synchronised gradient within 3e-2 (of each leaf's largest |g|)
    of one process's at the same global batch, from the same drawn weights
    (an MoE model routed by the ranks' choices); the launches of every step
    and rank as worked out from the code.  Then each served request against
    one process's (``_check_serve``), the dry-run's traces of granite-8b's
    train and decode steps and of mixtral-8x22b's train step against rank
    0's recorded bytes (``_check_dryrun``), and ``ccu_reduce`` at the P = 2
    rows of the meshes and of decode's sums (``_ccu_dist_rows``).  The four
    ranks share the card, so their times measure the port's overhead and
    the kernels, not data-parallel scaling.  Returns each path's summed
    launches, the ccu rows and each request's launches over the ranks, in
    its prefill and in its decode steps (``_share_launches``)."""
    import shutil

    from repro_torch.configs import load
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.models.param import tree_leaves

    _build.build(["flash_attention", "flash_attention_bwd", "moe_dispatch", "ssd_scan", "rwkv6_scan",
                  "ccu_reduce"])   # built once, here
    harness = load(DIST["arch"]).clone(n_layers=DIST["n_layers"])
    names = list(_leaf_sizes(harness))
    torch.cuda.empty_cache()
    specs = {"dist": DIST, "dist_model": DIST_MODEL, "dist_moe": DIST_MOE, "dist_families": DIST_FAMILIES}
    runs = {key: _spawn(spec) for key, spec in specs.items()}
    by_path, ccu, served = {}, {}, {}

    def serve_checks(spec: dict, ranks: list[dict], tmp: str) -> None:
        for s in spec["serve"]:
            res = _check_serve(s, ranks, tmp)
            emit("dist_serve", **res)
            mine = [r["serve"][_serve_key(s)] for r in ranks]
            pre = {k: sum(m["launches"][0][k] for m in mine) for k in res["expected_prefill"]}
            dec = {k: sum(c[k] for m in mine for c in m["launches"][1:]) for k in res["expected_prefill"]}
            served[_serve_key(s)] = {"prefill": pre, "decode": dec}
            by_path[f"{_serve_key(s)} served on the model axis (4 ranks, {s['n_layers']} layers, prefill + "
                    f"{s['steps']} decode steps)"] = {k: pre[k] + dec[k] for k in pre}
            torch.cuda.empty_cache()

    # one process, global batch 8, from the same weights
    args = train.build_parser().parse_args([
        "--no-smoke", "--n-layers", str(DIST["n_layers"]), "--steps", str(DIST["steps"]),
        "--batch", str(DIST["batch"]), "--seq", str(DIST["seq"]), "--compression", DIST["compression"],
        "--seed", str(DIST["seed"]), "--lr", str(DIST["lr"])])
    first = {}

    def keep(step, loss, grads, payload, wire):
        if step == 0:
            first["grads"] = [g.cpu() for g in tree_leaves(grads)]

    single = train.run(args, harness=harness, observe=keep)
    single["first_grads"] = first.pop("grads")
    torch.cuda.empty_cache()
    for key, spec in (("dist", DIST), ("dist_model", DIST_MODEL)):
        ranks, spawn_s, tmp = runs[key]
        out = _check_mesh(spec, ranks, tmp, harness, single, names)
        if key == "dist_model":
            out["dryrun"] = _check_dryrun("train", spec, _train_bundle(spec), ranks[0]["wire_by_step"][-1],
                                          ranks[0]["peak_memory_gb"])
            granite = spec["serve"][0]
            out["dryrun_decode"] = _check_dryrun("decode", spec, _decode_bundle(granite),
                                                 ranks[0]["serve"][granite["arch"]]["wire"][-1], None)
            serve_checks(spec, ranks, tmp)
        shutil.rmtree(tmp, ignore_errors=True)
        out["spawn_to_exit_s"] = spawn_s
        emit(key, **out)
        by_path[f"{spec['arch']} {key} {out['mesh']} ({len(ranks)} ranks, {spec['n_layers']} layers)"] = {
            k: sum(c[k] for r in ranks for c in r["launches"]) for k in out["expected_launches"]}
    del single
    torch.cuda.empty_cache()
    ranks, spawn_s, tmp = runs["dist_moe"]
    out = _check_moe_train(DIST_MOE, ranks, tmp)
    out["dryrun"] = _check_dryrun("train", DIST_MOE, _train_bundle(DIST_MOE), ranks[0]["wire_by_step"][-1],
                                  ranks[0]["peak_memory_gb"])
    out["spawn_to_exit_s"] = spawn_s
    emit("dist_moe", **out)
    by_path[f"{DIST_MOE['arch']} dist_moe {out['mesh']} ({len(ranks)} ranks, {DIST_MOE['n_layers']} layer)"] = {
        k: sum(c[k] for r in ranks for c in r["launches"]) for k in out["expected_launches"]}
    serve_checks(DIST_MOE, ranks, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    ranks, spawn_s, tmp = runs["dist_families"]
    for run in DIST_FAMILIES["runs"]:
        spec, key = {**DIST_FAMILIES, **run}, _serve_key(run)
        mine = [r["runs"][key] for r in ranks]
        fam = _serve_harness(run)
        out = _check_train_leafwise(spec, mine, tmp,
                                    _family_train_expected_launches(fam, len(_leaf_sizes(fam))), f"{key}_")
        if key == "zamba2-1.2b":
            out["dryrun"] = _check_dryrun("train", spec, _train_bundle(spec), mine[0]["wire_by_step"][-1],
                                          mine[0]["peak_memory_gb"])
        if key == "rwkv6-1.6b":
            out["dryrun_decode"] = _check_dryrun("decode", spec, _decode_bundle(spec["serve"][0]),
                                                 mine[0]["serve"][key]["wire"][-1], None)
        out["spawn_to_exit_s_all_runs"] = spawn_s
        emit("dist_family", **out)
        by_path[f"{key} dist_family {out['mesh']} ({len(ranks)} ranks, {run['n_layers']} layers)"] = {
            k: sum(c[k] for r in mine for c in r["launches"]) for k in out["expected_launches"]}
        serve_checks(spec, mine, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    ccu["p2_data"] = _ccu_dist_rows({k: (n // 2, 1) for k, n in _leaf_sizes(harness).items()},
                                    (torch.bfloat16, torch.float32),
                                    "P = 2 rows of N / 2 for each of the 12 leaves on the (2, 2, 1) mesh: bf16 "
                                    "(reduce-scatter over data) and fp32 (all-reduce over pod); 24 launches a "
                                    "step and rank")
    ccu["p2_model"] = _ccu_dist_rows(_model_axis_rows(harness, DIST_MODEL), (torch.bfloat16,),
                                     "P = 2 bf16 rows of half of each tensor gathered over model on the (2, 2) "
                                     "mesh, the backward's reduce-scatters (a layer's 7 weights, K and V, once a "
                                     "layer; the token table and the unembedding): 20 launches a step and rank")
    ccu["p2_decode"] = _decode_ccu_rows(DIST_MODEL["serve"][0])
    return by_path, ccu, served


def _share_launches(rows: list[dict], served: dict) -> None:
    """The kernels line's model-axis rows' launches, as counted in the dist
    phase's requests over their 4 ranks: each scan's at the (2, 2) share in
    its family's bf16 request's prefill (the only launches of that shape;
    decode runs the recurrence), flash's in whisper's request, prefill and
    decode (``request_launches``: the encoder's, self- and cross-attention's
    together, as the counts are by kernel, not by call site)."""
    for row in rows:
        if row["name"] in ("rwkv6_scan", "ssd_scan"):
            arch = "rwkv6-1.6b" if row["name"] == "rwkv6_scan" else "zamba2-1.2b"
            row["model_axis_shares"]["dist_2x2"]["launches"] = served[arch]["prefill"][row["name"]]
        if row["name"] == "flash_attention":
            for part, sub in row["model_axis_whisper_cross"].items():
                sub["request_launches"] = served["whisper-base"][part]["flash_attention"]


def _decode_ccu_rows(spec: dict) -> dict:
    """``ccu_reduce`` at the P = 2 rows of a decode step on the model axis
    (granite-8b on (2, 2), 2 sequences a rank): each layer's combine of the
    ranks' partial outputs, a reduce-scatter whose received rows of B·N·Dh/2
    are scaled in fp32 before the sum (fp32 rows), and its two partial sums
    (the output projection's and the MLP's), bf16 rows of B·D."""
    from repro_torch.configs import load

    cfg = load(spec["arch"]).cfg
    B, L = spec["batch"] // 2, spec["n_layers"]
    combine = _ccu_dist_rows({"combine (a layer)": (B * cfg.n_heads * cfg.head_dim // 2, L)}, (torch.float32,),
                             "fp32 rows of the partial outputs reduce-scattered over model, each scaled by its "
                             "rank's weight where it is summed")
    sums = _ccu_dist_rows({"wo partial sum (a layer)": (B * cfg.d_model, L), "mlp partial sum (a layer)":
                           (B * cfg.d_model, L)}, (torch.bfloat16,), "bf16 rows of the row-parallel partial sums")
    keys = ("launches", "ms", "call_ms", "plain_ms", "library_ms", "bound_ms")
    return {"shape": f"a decode step of {spec['arch']} ({L} layers, batch {spec['batch']}) on (data, model) = "
                     f"(2, 2): 3 launches a layer and rank", **{k: combine[k] + sums[k] for k in keys},
            "combine": combine, "partial_sums": sums}


def _tree_like(tree, leaves: list):
    """``leaves`` (in the order ``tree_leaves`` gives) in ``tree``'s shape."""
    from repro_torch.models.param import tree_leaves, tree_map

    by_id = {id(t): x for t, x in zip(tree_leaves(tree), leaves)}
    return tree_map(lambda t: by_id[id(t)], tree)


def phase_serve() -> dict[str, dict[str, int]]:
    """granite-8b, then mixtral-8x22b, then zamba2-1.2b, then rwkv6-1.6b,
    then paligemma-3b, then whisper-base; each path's weights are released
    when it returns; then rwkv6-1.6b and zamba2-1.2b in fp32
    (``_fp32_full_depth``).  Returns each path's launch counts."""
    out = {spec["arch"]: _serve_path(spec) for spec in (SERVE, MIXTRAL, ZAMBA, RWKV, PALIGEMMA, WHISPER)}
    for spec in (RWKV, ZAMBA):
        out[f"{spec['arch']} fp32 forward"] = _fp32_full_depth(spec)
    return out


def _fp32_full_depth(spec: dict) -> dict[str, int]:
    """ROADMAP C7: a recurrent model at full depth in fp32, the kernel path
    (its scans through their fp32 kernels) against the plain path (the
    kernels' plain versions), forward only, over a drawn prompt, on the same
    drawn weights: all logits within 3e-2 of the largest |logit|.  In bf16
    the two paths part by 4-17x that at full depth, as a one-ulp move of the
    prompt does (PERF.md); fp32 rounds 2^16 times finer.  Returns the kernel
    path's launches."""
    from repro_torch import kernels
    from repro_torch.configs import load
    from repro_torch.models import hybrid, rwkv_lm
    from repro_torch.models.layers import Runtime
    from repro_torch.models.param import tree_init

    torch.backends.cuda.matmul.allow_tf32 = False
    harness = load(spec["arch"]).clone(dtype=torch.float32)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(spec["seed"])
    params = tree_init(harness.param_specs(), gen, torch.float32, "cuda")
    _draw_time_mix(harness, params, spec["seed"] + 1)
    tokens = torch.randint(0, harness.cfg.vocab_size, (spec["batch"], spec["prompt_len"]), generator=gen,
                           device="cuda", dtype=torch.int32)
    forward = rwkv_lm.forward if harness.family == "ssm" else hybrid.forward
    with torch.no_grad():
        kernels.reset_launch_counts()
        kern = forward(Runtime(), harness.cfg, params, tokens)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        with _scan_without_roundings():
            plain = forward(Runtime(use_kernels=False), harness.cfg, params, tokens)
        plain_counts = kernels.launch_counts()
    largest = plain.abs().max().item()
    err = (kern - plain).abs().max().item()
    n = harness.cfg.n_layers
    expected = {"flash_attention": harness.cfg.n_shared_calls if harness.family == "hybrid" else 0,
                "moe_dispatch": 0, "ssd_scan": n if harness.family == "hybrid" else 0,
                "rwkv6_scan": n if harness.family == "ssm" else 0, "ccu_reduce": 0, "flash_attention.bwd": 0}
    out = {"arch": spec["arch"], "dtype": "float32", "n_layers": n, "batch": spec["batch"],
           "prompt_len": spec["prompt_len"], "logits_max_abs_err": err, "largest_logit": largest,
           "of_limit": err / (3e-2 * largest), "limit": "3e-2 of the largest |logit|", "launches": counts}
    emit("serve_fp32", **out)
    if counts != expected or plain_counts != counts or not math.isfinite(err) or err > 3e-2 * largest:
        raise SystemExit(f"fp32 {spec['arch']} at full depth: kernel path vs plain path {out}, "
                         f"launches expected {expected}, plain path added {plain_counts}")
    del params, kern, plain
    return counts


# The network layers' golden figures (``tests/test_golden_numbers.py``'s pins,
# restated: this script imports no test), each held within that file's 2 %
# band: the model-axis multi-ring AllReduce on the DETOUR-routed 1024-chip pod
# at 512 MB and 64 MB, its All-to-All at 64 MB, the rack-coarsened 4-pod
# SuperPod's "pod" axis at 64 MB, and the 8 x 4 plane's hierarchical fallback
# (GB/s a chip).  Table 6's availability in the closed form (MTBF / (MTBF +
# MTTR) of the paper's AFRs at its 75-minute MTTR) against the paper's
# analytic figures, and its gap within 0.02 of the paper's "about 7.2 %" and
# of the Monte-Carlo campaign's 0.0722 (the golden file's bars).
NETSIM_GOLDEN = dict(model_allreduce_512mb_gbs=163.1, model_allreduce_64mb_gbs=141.8,
                     model_a2a_64mb_gbs=46.8, coarse_pod_64mb_gbs=24.8, rect_8x4_fallback_gbs=89.9,
                     ub_availability=0.98747, clos_availability=0.91718)
NETSIM_REL = 0.02
TABLE6_GAP, CAMPAIGN_GAP, GAP_BAND = 0.072, 0.0722, 0.02
SOLVER_REL = 1e-6
# The Monte-Carlo campaign's Table 6 (``tests/test_golden_numbers.py``'s
# ``TestGoldenAvailability`` pins, restated, within its 2 % band): the 8K-NPU
# UB-Mesh and Clos over 16 seeds of 4 weeks at the 75-minute MTTR, sampling
# only, and their gap
CAMPAIGN_GOLDEN = dict(ub_availability=0.98704, clos_availability=0.91481, availability_gap=0.0722)
# The planner on the card's host: granite-8b's workload (full config, train_4k's
# sequence) on 512 chips of two pods under the netsim-calibrated backend,
# BORROW routing, measured on the 1024-chip pod with no store; the decode
# planner on one rack (64 chips) at 30 requests/s against a 12 ms p99 SLO,
# where bandwidth pricing picks the widest TP and the SLO a narrower one
PLAN = dict(seq=4096, decode_chips=64, qps=30.0, slo_s=0.012)


def _host_cpu() -> str:
    """The host's CPU as ``lscpu`` gives it: vendor, model name, family and
    model number (a virtual machine may report its model name as
    "unknown"), and the core count."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except OSError:
        out = ""
    fields = dict(line.split(":", 1) for line in out.splitlines() if ":" in line)
    desc = ", ".join(f"{k} {fields[k].strip()}" for k in ("Vendor ID", "Model name", "CPU family", "Model")
                     if k in fields)
    return f"{desc or platform.machine()}, {os.cpu_count()} cores"


def _solvers_agree() -> dict:
    """The reference and vectorized max-min solvers on one scenario: 40
    seeded flows of 1-3 hops on the 64-chip rack under an rx cap, each
    flow's first rate and the drained run's end time."""
    from repro_torch.core.topology import ub_mesh_rack
    from repro_torch.netsim import FluidNetwork

    topo = ub_mesh_rack()
    gen = torch.Generator().manual_seed(0)
    walks = []
    for _ in range(40):
        node = int(torch.randint(topo.num_nodes, (1,), generator=gen))
        path = [node]
        for _ in range(1 + int(torch.randint(3, (1,), generator=gen))):
            c = list(topo.coords(path[-1]))
            d = int(torch.randint(topo.ndim, (1,), generator=gen))
            c[d] = (c[d] + 1 + int(torch.randint(topo.shape[d] - 1, (1,), generator=gen))) % topo.shape[d]
            if topo.node_id(c) not in path:
                path.append(topo.node_id(c))
        if len(path) > 1:
            walks.append((tuple(path), 1e6 + 1e9 * float(torch.rand(1, generator=gen))))
    rates, ends = {}, {}
    for solver in ("reference", "vectorized"):
        net = FluidNetwork(topo, rx_gbs=30.0, solver=solver)
        for path, size in walks:
            net.add_flow(path, size)
        net._recompute()
        rates[solver] = {fid: f.rate for fid, f in net.flows.items()}
        ends[solver] = net.run()
    ref, vec = rates["reference"], rates["vectorized"]
    if ref.keys() != vec.keys():
        raise SystemExit("netsim: the two solvers hold different flows")
    worst = max(abs(ref[k] - vec[k]) / max(abs(ref[k]), abs(vec[k]), 1e-30) for k in ref)
    end_rel = abs(ends["reference"] - ends["vectorized"]) / ends["reference"]
    return dict(flows=len(ref), max_rate_rel=worst, end_rel=end_rel, end_s=ends["vectorized"])


def _planner_on_the_host() -> dict:
    """``PLAN``: the planner's search of ``--auto-parallel`` for granite-8b
    (``launch.train.workload_spec``) over the netsim-calibrated backend
    (measured here, no store) and
    ``launch.serve.plan_decode`` through ``rack_perf_model``; each one's
    choices, calibration counts and wall seconds, and what misses the
    planners' own claims: three specs of the 512 chips ranked by iteration
    time, measured; the decode planner's bandwidth choice at the widest TP
    and its SLO choice narrower and meeting the SLO."""
    import argparse

    from repro_torch.configs import load
    from repro_torch.core.cost_model import Routing, build_comm_model
    from repro_torch.core.perf_model import NetsimPerfModel
    from repro_torch.core.planner import plan
    from repro_torch.core.topology import ub_mesh_pod
    from repro_torch.launch import serve, train

    granite = load("granite-8b")
    args = argparse.Namespace(arch="granite-8b", seq=PLAN["seq"], batch=8)
    perf = NetsimPerfModel(build_comm_model(multi_pod=True, routing=Routing.BORROW), topo=ub_mesh_pod(),
                           cache_dir=None)
    t = time.perf_counter()
    report = plan(train.workload_spec(granite, args), 512, perf, top_k=3)
    plan_s = time.perf_counter() - t
    t = time.perf_counter()
    decode = serve.plan_decode(train.workload_spec(granite, args), PLAN["decode_chips"],
                               serve.rack_perf_model(cache_dir=None), qps=PLAN["qps"], slo_s=PLAN["slo_s"])
    decode_s = time.perf_counter() - t
    times = [r.iteration_s for r in report]
    misses = []
    if (len(report) != 3 or any(r.spec.chips != 512 for r in report) or times != sorted(times)
            or report.calibration["misses"] < 1 or report.calibration["measure_s"] <= 0):
        misses.append(f"planner {[train.planner_line(r) for r in report]} {report.calibration}")
    bw, slo = decode["bandwidth_choice"], decode["slo_choice"]
    if not (bw["tp"] == max(c["tp"] for c in decode["candidates"]) and slo["meets_slo"] and slo["tp"] < bw["tp"]):
        misses.append(f"plan_decode bandwidth choice {bw}, SLO choice {slo}")
    return dict(lines=[train.planner_line(r) for r in report], top3=[str(r.spec) for r in report],
                iteration_s=times, n_enumerated=report.n_enumerated, n_prefiltered=report.n_prefiltered,
                calibration={k: report.calibration[k] for k in ("hits", "misses", "disk_hits", "measure_s")},
                plan_s=plan_s, decode=dict(bandwidth_choice=bw, slo_choice=slo, diverged=decode["diverged"],
                                           candidates=len(decode["candidates"]), qps=PLAN["qps"],
                                           slo_s=PLAN["slo_s"], chips=PLAN["decode_chips"]),
                decode_s=decode_s, misses=misses)


def phase_netsim() -> None:
    """The port's network layers (``repro_torch.core``, ``repro_torch.netsim``,
    ``repro_torch.runtime``: numpy on the host) reproduce the golden
    figures, the two solvers agree within 1e-6 on one scenario, the
    Monte-Carlo campaign gives Table 6 (``CAMPAIGN_GOLDEN``) beside its
    closed form, and the planners run (``_planner_on_the_host``)."""
    from repro_torch.core import availability as av
    from repro_torch.core.cost_model import Routing, build_comm_model
    from repro_torch.core.topology import PASSIVE_ELECTRICAL, DimSpec, NDFullMesh, SuperPod, ub_mesh_pod
    from repro_torch.netsim import NetSim
    from repro_torch.netsim.coarsen import coarse_calibrated_profile, coarsen_superpod
    from repro_torch.runtime.campaign import head_to_head

    t0 = time.perf_counter()
    got, secs = {}, {}

    def timed(name, fn):
        t = time.perf_counter()
        got[name] = fn()
        secs[name] = time.perf_counter() - t

    pod = NetSim(ub_mesh_pod(), routing=Routing.DETOUR)
    comm = build_comm_model(multi_pod=False, routing=Routing.DETOUR)
    timed("model_allreduce_512mb_gbs", lambda: pod.calibrated_axis_gbs(512e6, comm=comm)["model"])
    timed("model_64mb", lambda: pod.calibrated_profile(64e6, comm=comm, axes=("model",),
                                                       shapes=("allreduce", "all_to_all")))
    prof = got.pop("model_64mb")
    got["model_allreduce_64mb_gbs"] = prof.get("model", "allreduce")
    got["model_a2a_64mb_gbs"] = prof.get("model", "all_to_all")
    timed("coarse_pod_64mb_gbs", lambda: coarse_calibrated_profile(
        coarsen_superpod(SuperPod(pod=ub_mesh_pod(), n_pods=4)), 64e6, axis_sizes={"pod": 4},
        axes=("pod",), shapes=("allreduce",)).get("pod", "allreduce"))
    rect = NDFullMesh(dims=(DimSpec("X", 8, PASSIVE_ELECTRICAL, 4), DimSpec("Y", 4, PASSIVE_ELECTRICAL, 4)))
    timed("rect_8x4_fallback_gbs", lambda: NetSim(rect, routing=Routing.DETOUR).calibrated_axis_gbs(
        64e6, axis_sizes={"model": 32})["model"])
    got["ub_availability"] = av.PAPER_UB_MESH.availability(av.PAPER_MTTR_HOURS)
    got["clos_availability"] = av.PAPER_CLOS.availability(av.PAPER_MTTR_HOURS)
    gap = got["ub_availability"] - got["clos_availability"]
    pod_analytic = build_comm_model(multi_pod=True, routing=Routing.DETOUR).axes["pod"].gbs_per_chip
    timed("solvers", _solvers_agree)
    timed("planner", _planner_on_the_host)
    planner = got.pop("planner")
    timed("campaign", lambda: head_to_head(chips=8192, seeds=tuple(range(16)), netsim_reprice=False))
    h2h = got.pop("campaign")
    campaign = dict(ub_availability=h2h["ub"].availability, clos_availability=h2h["clos"].availability,
                    availability_gap=h2h["availability_gap"], analytic_gap=h2h["analytic_gap"],
                    events=[h2h["ub"].summary()["events"], h2h["clos"].summary()["events"]])

    misses = [f"{k} {got[k]} vs {v}" for k, v in NETSIM_GOLDEN.items() if abs(got[k] - v) > NETSIM_REL * v]
    if not 2.5 <= got["model_allreduce_64mb_gbs"] / got["model_a2a_64mb_gbs"] <= 3.5:
        misses.append("AllReduce / All-to-All at 64 MB outside 2.5-3.5")
    if abs(got["coarse_pod_64mb_gbs"] - pod_analytic) > NETSIM_REL * pod_analytic:
        misses.append(f"coarse pod axis {got['coarse_pod_64mb_gbs']} vs analytic {pod_analytic}")
    if abs(gap - TABLE6_GAP) > GAP_BAND or abs(gap - CAMPAIGN_GAP) > GAP_BAND:
        misses.append(f"Table-6 gap {gap}")
    solvers = got.pop("solvers")
    if solvers["max_rate_rel"] > SOLVER_REL or solvers["end_rel"] > SOLVER_REL:
        misses.append(f"solvers {solvers}")
    misses += [f"campaign {k} {campaign[k]} vs {v}" for k, v in CAMPAIGN_GOLDEN.items()
               if abs(campaign[k] - v) > NETSIM_REL * v]
    misses += planner.pop("misses")
    wall = time.perf_counter() - t0
    emit("netsim", **got, availability_gap=gap, pod_analytic_gbs=pod_analytic, solvers=solvers,
         golden=NETSIM_GOLDEN, rel=NETSIM_REL, campaign=campaign, campaign_golden=CAMPAIGN_GOLDEN,
         planner=planner, seconds=secs, wall_s=wall, host_cpu=_host_cpu(), ok=not misses)
    if misses:
        raise SystemExit("netsim: " + "; ".join(misses))


PHASES = ["device", "build", "kernels", "slice", "serve", "train", "dist", "restart", "netsim"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES), help="comma-separated subset, for debugging")
    args = ap.parse_args()
    phases = args.phases.split(",")
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
    by_path = phase_serve() if "serve" in phases else {}
    if "train" in phases:
        by_path.update(phase_train())
    if "dist" in phases:
        paths, ccu, served = phase_dist()
        by_path.update(paths)
        _share_launches(kernel_rows, served)
        for row in kernel_rows:
            if row["name"] == "ccu_reduce":
                row["dist_rows"], row["model_axis_rows"] = ccu["p2_data"], ccu["p2_model"]
                row["model_axis_decode_rows"] = ccu["p2_decode"]
    if "restart" in phases:
        emit("restart", **_restart_check())
    if "netsim" in phases:
        phase_netsim()
    for row in kernel_rows:
        row["launches_by_path"] = {path: c[row["name"]] for path, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if {"serve", "train"} <= set(phases) and row["launches"] < 1:
            raise SystemExit(f"the main paths never launched {row['name']}")
    print(device["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    ok = phases == PHASES
    print(json.dumps({"ok": ok, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}), flush=True)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
