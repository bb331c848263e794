"""Shared parts of ``tests/test_torch_model_axis_{rwkv,hybrid,audio}.py``:
the SSM, hybrid and audio families (rwkv6-1.6b, zamba2-1.2b, whisper-base
smoke configs in fp32) trained and served on gloo ranks with a "model" axis,
held against the reference on one device as
``tests/test_torch_model_axis_moe.py`` holds its family.

The weights are the port's ``tree_init`` draws with the leaves the
reference initialises to constants drawn too, so that a leaf sliced to the
wrong heads or channels shows: rwkv6's ``mu``, ``w0`` and ``bonus_u``
(``_torch_parity.draw_time_mix``) and its LayerNorms; zamba2's ``A_log``,
``dt_bias``, ``D``, ``conv_b``, ``out_norm`` and RMS norms; whisper's biases
and LayerNorms (``test_torch_encdec.draw_affine``).

The reference's ``prefill`` of the two recurrent families returns the state
it was given (ROADMAP C1), so their request is held against the
reference's ``decode_step`` fed the prompt token by token: its logits at
the last prompt token against the port's prefill, then greedy steps.
Whisper's request is the reference's ``prefill`` then ``decode_step``.
Tolerances: loss 2e-5, gradients 2e-5 of each leaf's largest |g|, ZeRO-1
shards 1e-6, logits 2e-4; the recurrent states 1e-4 of the largest
|value| (chunked scan against recurrence, as ``tests/test_torch_rwkv_lm.py``
holds them), whisper's cache 2e-5."""

from __future__ import annotations

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_dist
import _torch_model_axis_ranks as ranks
import repro.models.param as ref_param
from repro.models.api import ShapeCell as RefCell
from repro_torch.models.param import from_reference, tree_leaves
from repro_torch.optim import adamw
from test_torch_encdec import draw_affine
from test_torch_model_axis import RRT, _assemble, _dp_index, _ref, _tree_like, weights

from _torch_parity import draw_time_mix

B = 4
MESHES = {"1x2": ((1, 2), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}
RECURRENT = ("rwkv6-1.6b", "zamba2-1.2b")


def drawn_weights(i: int, arch: str):
    """``weights(i, arch)`` with the constant-initialised leaves drawn."""
    w = weights(i, arch)
    rng = np.random.default_rng(100 + i)
    if arch == "rwkv6-1.6b":
        draw_time_mix(w["blocks"]["tm"], w["blocks"]["cm"], rng)
        draw_affine(w, rng)
        w["blocks"]["tm"]["ln_out"] = (1.0 + 0.1 * rng.standard_normal(w["blocks"]["tm"]["ln_out"].shape)
                                       ).astype(np.float32)
    elif arch == "zamba2-1.2b":
        m = w["mamba_blocks"]["mamba"]
        for name, (loc, scale) in {"A_log": (0.0, 0.5), "dt_bias": (0.0, 0.5), "D": (1.0, 0.3),
                                   "conv_b": (0.0, 0.1), "out_norm": (1.0, 0.1)}.items():
            m[name] = (loc + scale * rng.standard_normal(m[name].shape)).astype(np.float32)
        for tree, key in ((w["mamba_blocks"], "norm"), (w["shared"], "ln1"), (w["shared"], "ln2"),
                          (w, "final_norm")):
            tree[key] = (1.0 + 0.1 * rng.standard_normal(tree[key].shape)).astype(np.float32)
    else:
        draw_affine(w, rng)
    return w


def make_cases(arch: str, i: int, S: int, prompt_len: int, cache: int, steps: int):
    """(train case, serve case) of ``arch``: weights, a batch of B sequences
    of S, a request of B prompts of ``prompt_len`` into ``cache`` positions
    and ``steps`` greedy steps; whisper's with drawn frames."""
    h = _ref(arch)
    w = drawn_weights(i, arch)
    rng = np.random.default_rng(500 + i)
    tok = rng.integers(0, h.cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    prompt = rng.integers(0, h.cfg.vocab_size, (B, prompt_len)).astype(np.int32)
    serve = dict(arch=arch, weights=w, prompt=prompt, prefix=None, cache=cache, steps=steps, window=None)
    if arch == "whisper-base":
        batch["frames"] = rng.standard_normal((B, h.cfg.n_frames, h.cfg.d_model)).astype(np.float32)
        serve["frames"] = rng.standard_normal((B, h.cfg.n_frames, h.cfg.d_model)).astype(np.float32)
    return (w, batch), serve


def recurrent_request(case) -> dict:
    """The reference's ``decode_step`` fed the prompt token by token from
    the zero state (its logits at the last prompt token stand for
    prefill's), then greedy steps: logits, ids and the final state."""
    rh = _ref(case["arch"])
    B_, S = case["prompt"].shape
    w = jax.tree.map(jnp.asarray, case["weights"])
    state = ref_param.tree_init(rh.serve_state_specs(RefCell("d", "decode", case["cache"], B_)),
                                jax.random.PRNGKey(0), dtype=jnp.float32)
    decode = jax.jit(rh.decode(RRT))
    for t in range(S):
        logits, state = decode(w, state, jnp.asarray(case["prompt"][:, t:t + 1]), jnp.asarray(t, jnp.int32))
    out = {"logits": [np.asarray(logits)], "ids": []}
    for i in range(case["steps"]):
        ids = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out["ids"].append(np.asarray(ids))
        logits, state = decode(w, state, ids, jnp.asarray(S + i, jnp.int32))
        out["logits"].append(np.asarray(logits))
    out["cache"] = [np.asarray(c) for c in jax.tree.leaves(state)]
    return out


def encdec_request(case) -> dict:
    """The reference's ``prefill`` of the frames and the prompt into a
    cache of ``case["cache"]`` positions, then its greedy decode steps."""
    rh = _ref(case["arch"])
    B_, S = case["prompt"].shape
    w = jax.tree.map(jnp.asarray, case["weights"])
    cache = ref_param.tree_init(rh.serve_state_specs(RefCell("d", "decode", case["cache"], B_)),
                                jax.random.PRNGKey(0), dtype=jnp.float32)
    logits, cache = rh.prefill(RRT)(w, cache, jnp.asarray(case["frames"]), jnp.asarray(case["prompt"]))
    out = {"logits": [np.asarray(logits)], "ids": []}
    for i in range(case["steps"]):
        ids = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out["ids"].append(np.asarray(ids))
        logits, cache = rh.decode(RRT)(w, cache, ids, jnp.asarray(S + i, jnp.int32))
        out["logits"].append(np.asarray(logits))
    out["cache"] = [np.asarray(c) for c in jax.tree.leaves(cache)]
    return out


def reference(arch: str, train_case, serve_case) -> dict:
    w, batch = train_case
    loss, grads = jax.value_and_grad(_ref(arch).loss(RRT))(jax.tree.map(jnp.asarray, w),
                                                           {k: jnp.asarray(v) for k, v in batch.items()})
    request = recurrent_request(serve_case) if arch in RECURRENT else encdec_request(serve_case)
    return {"loss": float(loss), "grads": [np.asarray(g) for g in jax.tree.leaves(grads)], "request": request}


def leaf_names(tree, prefix: str = "") -> list[str]:
    """Dotted names of a tree's leaves, in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def spawn(tmp_path_factory, tag: str, meshes: dict, train: dict, serve: dict) -> dict:
    """``ranks.train_and_serve`` of the cases on each mesh, spawned once."""
    out = {}
    for name, (shape, axes) in meshes.items():
        tmp = tmp_path_factory.mktemp(f"{tag}{name}")
        for part, tree in (("train", train), ("serve", serve)):
            with open(tmp / f"{part}.pkl", "wb") as f:
                pickle.dump(tree, f)
        out[name] = _torch_dist.spawn(ranks.train_and_serve, int(np.prod(shape)), tmp, shape, axes,
                                      str(tmp / "train.pkl"), str(tmp / "serve.pkl"))
    return out


def check_loss_and_gradients(res: list, ref: dict, arch: str, mesh_shape: tuple) -> None:
    """The gradients gathered from the ranks' blocks against
    ``jax.value_and_grad`` at 2e-5 of each leaf's largest |g|; each DP
    share's loss (the sum of its model ranks' parts) the same on each of
    its ranks, their mean the reference's at 2e-5: not m times it."""
    res = [r["train"] for r in res]
    grads = _assemble(res, arch, "grads", "param_blocks", ref["grads"])
    names = leaf_names(_ref(arch).param_specs())
    for name, g, want in zip(names, grads, ref["grads"]):
        scale = np.abs(want).max()
        if name.endswith("attn.bk"):
            # a key bias adds one constant to a query's every score: its exact
            # gradient is zero, so both sides are rounding noise; held against
            # the same projection's weights' gradient instead
            scale = np.abs(ref["grads"][names.index(name[:-2] + "wk")]).max()
        assert np.abs(g - want).max() <= 2e-5 * scale, name
    shares = {}
    for r in res:
        dp, _ = _dp_index(r[arch]["coord"], mesh_shape)
        shares.setdefault(dp, set()).add(r[arch]["losses"][0])
    assert all(len(v) == 1 for v in shares.values())
    assert abs(np.mean([v.pop() for v in shares.values()]) - ref["loss"]) <= 2e-5


def check_shards(res: list, w, arch: str) -> None:
    """Each rank's ZeRO-1 shard after the first int8 step against
    ``adamw.apply`` of the whole trees on the gathered payload at 1e-6, its
    params on its block; the clip norm the ranks reckon the whole
    payload's, the same on every rank."""
    res = [r["train"] for r in res]
    payload = _assemble(res, arch, "payload", "param_blocks", tree_leaves(w))
    whole = float(adamw.global_norm({str(i): torch.from_numpy(g) for i, g in enumerate(payload)}))
    norms = {r[arch]["gnorm"] for r in res}
    assert len(norms) == 1 and abs(norms.pop() - whole) <= 1e-6 * whole
    params = from_reference(w, torch.float32, "cpu")
    state = adamw.init_opt_state(params)
    adamw.apply(ranks.opt_cfg(), params, _tree_like(params, payload), state)
    for r in res:
        run = r[arch]
        for key in ("master", "m", "v"):
            for blk, full, shard in zip(run["zero_blocks"], tree_leaves(state[key]), tree_leaves(run["shards"][key])):
                want = full[tuple(slice(a, b) for a, b in blk)].numpy()
                assert shard.shape == want.shape
                assert np.abs(shard - want).max() <= 1e-6, key
        for blk, p, q in zip(run["param_blocks"], tree_leaves(params), tree_leaves(run["params"][0])):
            assert np.abs(p[tuple(slice(a, b) for a, b in blk)].numpy() - q).max() <= 1e-6


def check_params_identical(res: list, arch: str) -> None:
    """The ranks of one model coordinate hold the same bits after every
    step; the mean loss fell over the two steps."""
    res = [r["train"] for r in res]
    by_block = {}
    for r in res:
        for step, tree in enumerate(r[arch]["params"]):
            for leaf, (blk, x) in enumerate(zip(r[arch]["param_blocks"], tree_leaves(tree))):
                key = (step, leaf, tuple(blk))
                assert key not in by_block or np.array_equal(by_block[key], x)
                by_block[key] = x
    assert np.mean([r[arch]["losses"][-1] for r in res]) < np.mean([r[arch]["losses"][0] for r in res])


def check_request(res: list, ref: dict, arch: str, mesh_shape: tuple) -> None:
    """Every rank's ids equal the reference's rows of its data share, its
    logits at every step within 2e-4, its block of every state leaf within
    1e-4 (the recurrent families) or 2e-5 (whisper's cache) of the largest
    |value| of the matching slice."""
    tol = 1e-4 if arch in RECURRENT else 2e-5
    for r in res:
        run = r["serve"][arch]
        dp, n = _dp_index(run["coord"], mesh_shape)
        rows = slice(dp * B // n, (dp + 1) * B // n)
        for got, want in zip(run["ids"], ref["ids"]):
            assert np.array_equal(got, want[rows])
        for got, want in zip(run["logits"], ref["logits"]):
            assert np.abs(got - want[rows]).max() <= 2e-4
        leaves = tree_leaves(run["cache"])
        assert len(leaves) == len(ref["cache"])
        for blk, got, want in zip(run["cache_blocks"], leaves, ref["cache"]):
            want = want[tuple(slice(a, b) for a, b in blk)]
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def replicated_state_bit_equal(res: list, arch: str, names: tuple) -> None:
    """The state leaves ``names`` (indices into ``tree_leaves`` of the
    state), which the rules replicate on "model", hold the same bits on
    every model rank of a data share."""
    by_dp = {}
    for r in res:
        run = r["serve"][arch]
        by_dp.setdefault(run["coord"]["data"], []).append(tree_leaves(run["cache"]))
    for group in by_dp.values():
        assert len(group) > 1
        for other in group[1:]:
            for i in names:
                assert np.array_equal(group[0][i], other[i])
