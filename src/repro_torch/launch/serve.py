"""Batched serving: prefill + decode (KV cache, the recurrent state of rwkv6,
recurrent state and the shared block's cache for zamba2, or the decoder's
cache and the encoder's output for whisper) over the model harness — port of
``main`` in ``repro/launch/serve.py``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --batch 4 --prompt-len 32 --gen 16        # --no-smoke for full

As the reference's ``main`` does, the audio family (whisper-base) is prefilled
with zero frames ``(batch, n_frames, d_model)`` and paligemma with no prefix;
``run(..., inputs=...)`` gives either drawn frames or a prefix instead.

Same flags as the reference plus ``--device`` (default ``cuda``).  With
``--device cuda`` and no card it raises; it never carries on on the CPU.
``run(args)`` is the whole loop and returns its results; ``main`` prints them.

The module also holds the reference's **decode-serving simulator**, as the
reference's module does, numpy on the host over the port's copies of
``core/`` and ``netsim/``: ``decode_comm_bytes``, ``decode_step_s`` (one
continuous-batching decode step on a UB-Mesh rack, priced by bandwidth or
by the message-level latency profile), ``simulate_decode_serving``
(Poisson arrivals through a continuous-batching server), ``plan_decode``
(the bandwidth-optimal sharding and the one that meets a p99 token-latency
SLO) and ``rack_perf_model``; their lines are the reference's
(``tests/test_torch_serve_sim_parity.py`` holds their outputs equal).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import load
from ..kernels import launch_counts
from ..models.api import ShapeCell
from ..models.layers import Runtime
from ..models.param import tree_init


# effective HBM streaming bandwidth during decode (GB/s per chip): decode
# is weight-streaming-bound, so the per-step compute floor is
# local_param_bytes / (DECODE_HBM_GBS * 1e9)
DECODE_HBM_GBS = 1600.0

# payload the latency profile is calibrated at: one decode step's
# per-layer TP AllReduce moves O(batch x hidden) activation bytes — tens
# of KB, squarely in the latency-dominated regime
DECODE_MSG_BYTES = 64e3


# ---------------------------------------------------------------------------
# Decode step pricing
# ---------------------------------------------------------------------------


def decode_comm_bytes(w, batch: int) -> float:
    """Per-layer TP AllReduce payload of one decode step: the batch's
    activation row (batch x hidden, bf16)."""
    return float(batch) * w.hidden * w.bytes_per_elem


def decode_step_s(
    w,
    p,
    perf,
    *,
    batch: int = 8,
    pricing: str = "bandwidth",
    msg_bytes: float = DECODE_MSG_BYTES,
) -> float:
    """One continuous-batching decode step (seconds) for workload ``w``
    sharded as ``p`` — HBM weight streaming plus per-layer TP collectives.

    ``pricing`` selects the communication backend:

    * ``"bandwidth"`` — ``perf.comm_model(p)``'s closed-form AllReduce
      cost at the decode payload.  The analytic latency term rides the
      CommModel's pinned axis width, so it is (nearly) spec-invariant.
    * ``"latency"`` — the measured message-level profile
      (``perf.latency_profile(p)``): each collective costs its measured
      makespan ``total_s`` at the calibrated decode payload, which scales
      with the spec's REAL group width.  Requires a backend exposing
      ``latency_profile`` (``core.perf_model.NetsimPerfModel``).
    """
    shard = max(1, p.tp * p.sp * p.pp)
    params_bytes = w.params_total * w.bytes_per_elem
    t_hbm = (params_bytes / shard) / (DECODE_HBM_GBS * 1e9)

    group_w = p.tp * p.sp
    if group_w <= 1:
        return t_hbm
    n_coll = 2 * w.n_layers          # attention out-proj + MLP down-proj
    if pricing == "latency":
        if not hasattr(perf, "latency_profile"):
            raise TypeError(
                f"pricing='latency' needs a latency-calibrated backend "
                f"(got {type(perf).__name__})"
            )
        prof = perf.latency_profile(p, size_bytes=msg_bytes)
        st = prof.get("model", "allreduce")
        if st is None:
            raise ValueError("latency profile has no model-axis allreduce")
        t_coll = st.total_s
    elif pricing == "bandwidth":
        comm = perf.comm_model(p)
        t_coll = comm.allreduce("model", decode_comm_bytes(w, batch))
    else:
        raise ValueError(f"unknown pricing {pricing!r}")
    return t_hbm + n_coll * t_coll


# ---------------------------------------------------------------------------
# Continuous-batching serving simulator
# ---------------------------------------------------------------------------


def simulate_decode_serving(
    step_s: float,
    *,
    qps: float,
    slots: int,
    gen_tokens: int = 64,
    duration_s: float = 20.0,
    seed: int = 0,
    slo_s: float | None = None,
) -> dict:
    """Poisson request arrivals through a continuous-batching decode
    server: ``slots`` concurrent sequences (batch x DP replicas), one
    token per occupied slot per ``step_s``.

    Token latency is the inter-token gap for steady-state tokens and
    (admission wait + one step) for a request's first token — so queueing
    under load shows up where it hurts, in the p99.  Deterministic for a
    given ``seed``.  Returns p50/p99/mean token latency, aggregate
    tokens/s, slot utilization and (when ``slo_s`` is given) SLO
    attainment.
    """
    if step_s <= 0 or qps <= 0 or slots <= 0:
        raise ValueError("step_s, qps and slots must be positive")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, size=max(16, int(qps * duration_s * 2)))
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < duration_s]

    lat: list[float] = []            # first-token latencies (wait + 1 step)
    queue: list[float] = []          # arrival times, FIFO
    active: list[int] = []           # remaining tokens per occupied slot
    nxt = 0                          # next arrival index
    t = 0.0
    busy_slot_steps = 0
    total_steps = 0
    while nxt < len(arrivals) or queue or active:
        if not queue and not active:
            # idle: jump to the next arrival's step boundary
            t = max(t, float(arrivals[nxt]))
        while nxt < len(arrivals) and arrivals[nxt] <= t:
            queue.append(float(arrivals[nxt]))
            nxt += 1
        t_end = t + step_s
        # admit waiting requests into free slots; their first token lands
        # at the end of this step and carries the admission wait
        while queue and len(active) < slots:
            arr = queue.pop(0)
            active.append(gen_tokens)
            lat.append(t_end - arr)
        busy_slot_steps += len(active)
        total_steps += 1
        active = [r - 1 for r in active if r > 1]
        t = t_end
        if total_steps > 10_000_000:
            raise RuntimeError("serving simulation runaway")

    # steady-state tokens: each admitted request emits gen_tokens total,
    # the first is in ``lat`` already, the rest cost exactly step_s each
    n_requests = len(lat)
    n_steady_tokens = n_requests * (gen_tokens - 1)
    samples = np.concatenate([
        np.asarray(lat, dtype=float),
        np.full(n_steady_tokens, step_s, dtype=float),
    ]) if n_steady_tokens else np.asarray(lat, dtype=float)
    total_tokens = len(samples)
    out = {
        "step_s": step_s,
        "qps": qps,
        "slots": slots,
        "requests": n_requests,
        "tokens": int(total_tokens),
        "makespan_s": t,
        "tokens_per_s": float(total_tokens / t) if t else 0.0,
        "utilization": (
            busy_slot_steps / (total_steps * slots) if total_steps else 0.0
        ),
        "p50_s": float(np.percentile(samples, 50)) if total_tokens else 0.0,
        "p99_s": float(np.percentile(samples, 99)) if total_tokens else 0.0,
        "mean_s": float(samples.mean()) if total_tokens else 0.0,
    }
    if slo_s is not None:
        out["slo_s"] = slo_s
        out["attainment"] = (
            float((samples <= slo_s).mean()) if total_tokens else 1.0
        )
    return out


# ---------------------------------------------------------------------------
# SLO-driven decode planning
# ---------------------------------------------------------------------------


def plan_decode(
    w,
    chips: int,
    perf,
    *,
    qps: float,
    slo_s: float,
    batch: int = 8,
    gen_tokens: int = 64,
    duration_s: float = 20.0,
    seed: int = 0,
    max_tp: int = 64,
    msg_bytes: float = DECODE_MSG_BYTES,
) -> dict:
    """Search decode shardings of ``chips`` for workload ``w`` against a
    p99 token-latency SLO at a target request rate.

    Every candidate from ``enumerate_decode_specs`` is priced twice —
    ``pricing="bandwidth"`` (the classic throughput objective) and
    ``pricing="latency"`` (the measured message-level profile) — and the
    latency-priced step time drives a serving simulation at ``qps``.

    Returns ``{"candidates": [...], "bandwidth_choice": spec-dict,
    "slo_choice": spec-dict, "diverged": bool}``: ``bandwidth_choice``
    minimizes the bandwidth-priced step time; ``slo_choice`` maximizes
    simulated throughput among specs whose simulated p99 meets ``slo_s``
    (falling back to the lowest-p99 spec when none do).
    """
    from ..core.planner import enumerate_decode_specs

    specs = enumerate_decode_specs(w, chips, max_tp=max_tp)
    if not specs:
        raise ValueError(
            f"no feasible decode sharding of {chips} chips for {w.name}"
        )
    candidates = []
    for p in specs:
        step_bw = decode_step_s(
            w, p, perf, batch=batch, pricing="bandwidth", msg_bytes=msg_bytes
        )
        step_lat = decode_step_s(
            w, p, perf, batch=batch, pricing="latency", msg_bytes=msg_bytes
        )
        serving = simulate_decode_serving(
            step_lat,
            qps=qps,
            slots=batch * p.dp,
            gen_tokens=gen_tokens,
            duration_s=duration_s,
            seed=seed,
            slo_s=slo_s,
        )
        candidates.append({
            "tp": p.tp,
            "dp": p.dp,
            "step_bandwidth_s": step_bw,
            "step_latency_s": step_lat,
            "p50_s": serving["p50_s"],
            "p99_s": serving["p99_s"],
            "tokens_per_s": serving["tokens_per_s"],
            "attainment": serving["attainment"],
            "meets_slo": serving["p99_s"] <= slo_s,
        })

    bw_choice = min(candidates, key=lambda c: c["step_bandwidth_s"])
    meeting = [c for c in candidates if c["meets_slo"]]
    if meeting:
        slo_choice = max(meeting, key=lambda c: c["tokens_per_s"])
    else:
        slo_choice = min(candidates, key=lambda c: c["p99_s"])
    return {
        "workload": w.name,
        "chips": chips,
        "qps": qps,
        "slo_s": slo_s,
        "batch": batch,
        "candidates": candidates,
        "bandwidth_choice": bw_choice,
        "slo_choice": slo_choice,
        "diverged": (bw_choice["tp"], bw_choice["dp"])
        != (slo_choice["tp"], slo_choice["dp"]),
    }


def rack_perf_model(cache_dir: "str | None" = "auto"):
    """The serving-default latency-calibrated backend: the production
    CommModel measured on one UB-Mesh rack (the 8x8 plane decode TP
    groups live in)."""
    from ..core.cost_model import build_comm_model
    from ..core.perf_model import NetsimPerfModel
    from ..core.topology import ub_mesh_rack

    return NetsimPerfModel(
        base=build_comm_model(),
        topo=ub_mesh_rack(),
        cache_dir=cache_dir,
    )


# ---------------------------------------------------------------------------
# Real-model serving driver
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument(
        "--smoke", action=argparse.BooleanOptionalAction, default=True,
        help="shrunken config (default; --no-smoke for the full arch)",
    )
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def stub_inputs(harness, batch: int, seed: int, device) -> dict:
    """The stub frontends' outputs drawn from ``seed`` (standard normal,
    bf16), for ``run(..., inputs=...)``: paligemma's ``prefix_tokens`` patch
    embeddings or whisper's ``n_frames`` frame embeddings; none for the
    other families."""
    key, n = {"vlm": ("prefix_embeds", getattr(harness, "prefix_tokens", 0)),
              "audio": ("frames", getattr(harness.cfg, "n_frames", 0))}.get(harness.family, (None, 0))
    if key is None:
        return {}
    gen = torch.Generator(device=device).manual_seed(seed)
    return {key: torch.randn((batch, n, harness.cfg.d_model), generator=gen, device=device).to(torch.bfloat16)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace, *, harness=None, params=None, rt=None, inputs=None) -> dict:
    """Serve one batch: make weights and the KV cache, prefill the prompts,
    decode ``args.gen - 1`` further tokens.

    ``harness`` and ``params`` replace the loaded config and the drawn weights
    (the parity tests carry the reference's weights across that way); ``rt``
    replaces the default runtime.  The prompts are drawn with numpy from
    ``args.seed`` exactly as the reference draws them.  ``inputs`` gives the
    stub frontend's output in place of the reference's: ``{"frames": (batch,
    n_frames, d_model)}`` for the audio family (else zeros), or
    ``{"prefix_embeds": (batch, P, d_model)}`` for a transformer (else no
    prefix; with one the decode positions start at ``P + prompt_len``).

    Returns the generated ids ``(batch, gen)``, the logits each was chosen
    from ``(batch, gen, vocab)`` float32, the prefill and per-token decode
    wall times (after a device synchronise) and the kernels' launch counts
    over the run.
    """
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda asked for, but torch.cuda.is_available() is False; "
            "pass --device cpu to run the plain versions on the CPU"
        )
    harness = harness if harness is not None else load(args.arch, smoke=args.smoke)
    cfg = harness.cfg
    rt = rt if rt is not None else Runtime(rules=None)
    # independent streams for params, serve state and sampling, as the
    # reference splits its key three ways
    seeds = np.random.SeedSequence(args.seed).generate_state(3)
    params_gen, state_gen, sample_gen = (
        torch.Generator(device=device).manual_seed(int(s)) for s in seeds
    )
    if params is None:
        params = tree_init(harness.param_specs(), params_gen, torch.bfloat16, device)

    max_len = args.prompt_len + args.gen + 8
    cell = ShapeCell("serve", "decode", max_len, args.batch)
    state = tree_init(harness.serve_state_specs(cell), state_gen, device=device)

    prefill = harness.prefill(rt)
    decode = harness.decode(rt)

    rng = np.random.default_rng(args.seed)
    vocab = cfg.vocab_size
    prompts = torch.from_numpy(
        rng.integers(0, vocab, size=(args.batch, args.prompt_len), dtype=np.int32)
    ).to(device)
    inputs = dict(inputs or {})
    allowed = {"audio": {"frames"}, "ssm": set(), "hybrid": set()}.get(harness.family, {"prefix_embeds"})
    if not set(inputs) <= allowed:
        raise ValueError(f"{args.arch} ({harness.family}) takes inputs {sorted(allowed)}, got {sorted(inputs)}")
    if harness.family == "audio":
        frames = inputs.get("frames")
        if frames is None:
            frames = torch.zeros((args.batch, cfg.n_frames, cfg.d_model), dtype=torch.bfloat16, device=device)
        extra = (frames,)
    else:
        extra = ()
    prefix = inputs.get("prefix_embeds")
    offset = 0 if prefix is None else prefix.shape[1]

    def sample(logits):
        lg = logits[:, -1, :vocab].float()
        if args.temperature <= 0:
            return lg, torch.argmax(lg, dim=-1).to(torch.int32)
        probs = torch.softmax(lg / args.temperature, dim=-1)
        return lg, torch.multinomial(probs, 1, generator=sample_gen)[:, 0].to(torch.int32)

    launches0 = launch_counts()
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        if prefix is None:
            logits, state = prefill(params, state, *extra, prompts)
        else:
            logits, state = prefill(params, state, prompts, prefix)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        lg, tok = sample(logits)
        out_logits, out_tokens = [lg], [tok]
        t1 = time.perf_counter()
        for i in range(args.gen - 1):
            logits, state = decode(params, state, tok[:, None], offset + args.prompt_len + i)
            lg, tok = sample(logits)
            out_logits.append(lg)
            out_tokens.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t1

    gen = torch.stack(out_tokens, dim=1).cpu().numpy()
    if gen.shape != (args.batch, args.gen) or gen.min() < 0 or gen.max() >= vocab:
        raise RuntimeError(f"generated ids out of range or of shape {gen.shape}")
    return {
        "device": str(device),
        "tokens": gen,
        "logits": torch.stack(out_logits, dim=1).cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s_per_token": t_decode / max(args.gen - 1, 1),
        "launches": {k: n - launches0[k] for k, n in launch_counts().items()},
    }


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    res = run(args)
    print(f"[serve] arch={args.arch} device={res['device']} batch={args.batch} "
          f"prefill={res['prefill_s']*1e3:.0f}ms "
          f"decode={res['decode_s_per_token']*1e3:.1f}ms/tok "
          f"kernel launches={res['launches']}")
    print(f"[serve] generated token ids (first row): {res['tokens'][0][:16].tolist()}")


if __name__ == "__main__":
    main()
