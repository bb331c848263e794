"""The VLM family on the "model" axis (``models/transformer.py``'s
``_concat_shard``, ``train/train_step.py``) on gloo ranks on the CPU,
against the reference on one device: paligemma-3b's fp32 smoke config (a
prefix of 8 drawn embeddings, MQA with one KV head of 32, GELU, the gemma
embedding scale) on (data, model) = (1, 2) and (2, 2).

The prefix goes before the tokens and each rank takes its positions of the
whole, as the reference concatenates before its sequence shard: with 24
tokens, rank 0 of 2 holds the prefix and the first 8 tokens, rank 1 the
other 16.  The bidirectional prefix is flash's ``prefix_len`` at each rank's
``q_start``.  Held: two int8 ZeRO-1 steps as ``tests/test_torch_model_axis.py``
holds the dense family (loss and gradients against ``jax.value_and_grad``
at 2e-5 of each leaf's largest |g|, the shards against ``adamw.apply``, the
clip norm); a served request (the prefix and 24 tokens into a cache of 64,
then 4 greedy steps, the decode tensor-parallel) as
``tests/test_torch_model_axis_decode.py`` holds it."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist
import _torch_model_axis_ranks as ranks
from test_torch_model_axis import RRT, _ref, weights
from test_torch_model_axis_decode import check_request, reference_request
from test_torch_model_axis_moe import (
    test_loss_and_gradients_match_reference as _loss_and_gradients,
    test_shards_and_norm_match_adamw_apply as _shards_and_norm,
)

from _torch_parity import one_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "paligemma-3b"
MESHES = {"1x2": ((1, 2), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}
B, S, P = 4, 24, 8


@pytest.fixture(scope="module")
def cases():
    w = weights(20, ARCH)
    rng = np.random.default_rng(500)
    tok = rng.integers(0, _ref(ARCH).cfg.vocab_size, (B, S + 1)).astype(np.int32)
    prefix = rng.standard_normal((B, P, _ref(ARCH).cfg.d_model)).astype(np.float32)
    train = {ARCH: (w, {"tokens": tok[:, :-1], "labels": tok[:, 1:], "prefix_embeds": prefix})}
    serve = {ARCH: dict(arch=ARCH, weights=w, prompt=tok[:, :-1], prefix=prefix, cache=64, steps=4, window=None)}
    return train, serve


@pytest.fixture(scope="module")
def reference(cases):
    train, serve = cases
    w, batch = train[ARCH]
    loss, grads = jax.value_and_grad(_ref(ARCH).loss(RRT))(jax.tree.map(jnp.asarray, w),
                                                           {k: jnp.asarray(v) for k, v in batch.items()})
    return {ARCH: {"loss": float(loss), "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
                   "request": reference_request(serve[ARCH])}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cases):
    out = {}
    for name, (shape, axes) in MESHES.items():
        tmp = tmp_path_factory.mktemp(f"vlm{name}")
        for part, tree in zip(("train", "serve"), cases):
            with open(tmp / f"{part}.pkl", "wb") as f:
                pickle.dump(tree, f)
        out[name] = _torch_dist.spawn(ranks.train_and_serve, int(np.prod(shape)), tmp, shape, axes,
                                      str(tmp / "train.pkl"), str(tmp / "serve.pkl"))
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_loss_and_gradients_match_reference(runs, reference, mesh):
    _loss_and_gradients(runs, reference, mesh, ARCH)


@pytest.mark.parametrize("mesh", MESHES)
def test_shards_and_norm_match_adamw_apply(runs, cases, mesh):
    _shards_and_norm(runs, cases, mesh, ARCH)


@pytest.mark.parametrize("mesh", MESHES)
def test_request_matches_reference(runs, reference, mesh):
    """the prefix and the prompt prefilled into a longer cache, then greedy
    decode: the reference's ids, logits and cache"""
    check_request([r["serve"] for r in runs[mesh]], reference[ARCH]["request"], ARCH, MESHES[mesh][0])


def test_ranks_hold_their_positions_of_the_whole():
    """the concatenation's cut: (8 + 24) / 2 = 16 positions a rank, rank 0's
    the prefix and tokens 0-7, rank 1's tokens 8-23"""
    import torch

    from repro_torch.models import transformer

    class Axis:                     # two ranks, one process: gather = the whole, as every rank sees it
        size = 2

        def __init__(self, rank):
            self.rank = rank

        def gather(self, t, dim):
            return torch.cat([t, t + 100], dim=dim)

    prefix = torch.arange(4.0).reshape(1, 4, 1)          # a rank's 4 of the 8 prefix rows
    tokens = torch.arange(12).reshape(1, 12)             # a rank's 12 of the 24 tokens
    got = [transformer._concat_shard(transformer.L.Runtime(model=Axis(r)), P, prefix, tokens) for r in (0, 1)]
    assert got[0][0].flatten().tolist() == [0, 1, 2, 3, 100, 101, 102, 103]
    assert got[0][1].flatten().tolist() == list(range(8))
    assert got[1][0].shape[1] == 0
    assert got[1][1].flatten().tolist() == [8, 9, 10, 11] + [100 + i for i in range(12)]
