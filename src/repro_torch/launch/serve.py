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
The decode-serving simulator that shares the reference's module
(``decode_step_s``, ``simulate_decode_serving``, ``plan_decode``,
``rack_perf_model``) needs ``core/perf_model.py`` and ``core/planner.py``,
which are not ported yet (ROADMAP A12c); the port's ``core/`` and
``netsim/`` copies it also uses are in place.
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
