"""The MoE family on a mesh (``models/moe.py``, ``train/train_step.py``) on
gloo ranks on the CPU, against the reference on one device: fp32 smoke
configs of dbrx-132b (``expert_parallel``: 4 experts cut over "model", their
F dim over "data") and mixtral-8x22b (``expert_tp``: each expert's F dim cut
over "model", its d_model dim over "data"; its window of 64), on (data,
model) = (2, 1), (1, 2) and (2, 2), with the rules' ``moe_fsdp`` and
strategy as ``rules_for_cell`` gives them.

Each rank gathers its experts' FSDP dim over "data" before use (the
gather's backward a reduce-scatter, so such a leaf's gradient skips the
data-parallel all-reduce).  On the model axis in training and prefill the
rank routes its shard of each sequence with the whole sequence's capacity
and slots, dispatches into the whole buffer, and ``expert_parallel``
reduce-scatters it over the experts (its outputs all-gathered back) where
``expert_tp`` sums it (and its outputs); decode runs the axis
tensor-parallel.  The auxiliary loss's means are over every rank's tokens.

Held, as ``tests/test_torch_model_axis.py`` holds the dense family: the
loss and the gradients gathered from the ranks' blocks against
``jax.value_and_grad`` at 2e-5 of each leaf's largest |g|; each rank's
ZeRO-1 shard after the first int8 step against ``adamw.apply`` at 1e-6 and
its params on its block; the clip norm against the whole payload's; the
params identical across the data ranks.  A served request (a prompt of 32
into a cache of 64, then 4 greedy steps) as
``tests/test_torch_model_axis_decode.py`` holds it.  The capacity slots of
a rank's tokens against the reference's over the whole sequence, with a
router that overflows its experts.  And the fault this family's step had
on two data ranks: its experts' hidden units were halved and no collective
ran, so the (2, 1) prefill's logits were wrong."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_model_axis_ranks as ranks
from repro_torch.models.param import from_reference, tree_leaves
from repro_torch.optim import adamw
from test_torch_model_axis import RRT, _assemble, _dp_index, _ref, _tree_like, weights
from test_torch_model_axis_decode import check_request, reference_request

from _torch_parity import one_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ("dbrx-132b", "mixtral-8x22b")
MESHES = {"2x1": ((2, 1), ("data", "model")), "1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
B, S = 4, 32
CELLS = [(mesh, arch) for mesh in MESHES for arch in ARCHS]


@pytest.fixture(scope="module")
def cases():
    train, serve = {}, {}
    for i, arch in enumerate(ARCHS):
        w = weights(10 + i, arch)
        tok = np.random.default_rng(400 + i).integers(0, _ref(arch).cfg.vocab_size, (B, S + 1)).astype(np.int32)
        train[arch] = (w, {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
        serve[arch] = dict(arch=arch, weights=w, prompt=tok[:, :-1], prefix=None, cache=2 * S, steps=4, window=None)
    return train, serve


@pytest.fixture(scope="module")
def reference(cases):
    train, serve = cases
    out = {}
    for arch, (w, batch) in train.items():
        loss, grads = jax.value_and_grad(_ref(arch).loss(RRT))(jax.tree.map(jnp.asarray, w),
                                                               {k: jnp.asarray(v) for k, v in batch.items()})
        out[arch] = {"loss": float(loss), "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
                     "request": reference_request(serve[arch])}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cases):
    out = {}
    for name, (shape, axes) in MESHES.items():
        tmp = tmp_path_factory.mktemp(f"moe{name}")
        for part, tree in zip(("train", "serve"), cases):
            with open(tmp / f"{part}.pkl", "wb") as f:
                pickle.dump(tree, f)
        out[name] = _torch_dist.spawn(ranks.train_and_serve, int(np.prod(shape)), tmp, shape, axes,
                                      str(tmp / "train.pkl"), str(tmp / "serve.pkl"))
    return out


def _train(res):
    return [r["train"] for r in res]


@pytest.mark.parametrize("mesh, arch", CELLS)
def test_loss_and_gradients_match_reference(runs, reference, mesh, arch):
    ref = reference[arch]
    res = _train(runs[mesh])
    grads = _assemble(res, arch, "grads", "param_blocks", ref["grads"])
    for g, want in zip(grads, ref["grads"]):
        assert np.abs(g - want).max() <= 2e-5 * np.abs(want).max()
    shares = {}
    for r in res:
        dp, _ = _dp_index(r[arch]["coord"], MESHES[mesh][0])
        shares.setdefault(dp, set()).add(r[arch]["losses"][0])
    assert all(len(v) == 1 for v in shares.values())
    assert abs(np.mean([v.pop() for v in shares.values()]) - ref["loss"]) <= 2e-5


@pytest.mark.parametrize("mesh, arch", CELLS)
def test_shards_and_norm_match_adamw_apply(runs, cases, mesh, arch):
    """each rank's master / m / v after the first step equal, on its ZeRO-1
    block within its FSDP and model shard, ``adamw.apply`` of the whole
    trees with the gathered payload, its params apply's on its block, and
    the clip norm the ranks reckon from their blocks the whole payload's"""
    res = _train(runs[mesh])
    w = cases[0][arch][0]
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


@pytest.mark.parametrize("mesh", MESHES)
def test_params_identical_across_data_ranks(runs, mesh):
    """the ranks of one (model coordinate) hold the same bits of every
    leaf they share after every step; the loss fell over the two steps"""
    for arch in ARCHS:
        res = _train(runs[mesh])
        by_block = {}
        for r in res:
            for step, tree in enumerate(r[arch]["params"]):
                for leaf, (blk, x) in enumerate(zip(r[arch]["param_blocks"], tree_leaves(tree))):
                    key = (step, leaf, tuple(blk))
                    assert key not in by_block or np.array_equal(by_block[key], x)
                    by_block[key] = x
        assert np.mean([r[arch]["losses"][-1] for r in res]) < np.mean([r[arch]["losses"][0] for r in res])


@pytest.mark.parametrize("mesh, arch", CELLS)
def test_request_matches_reference(runs, reference, mesh, arch):
    """prefill, then greedy decode: the reference's ids, logits and cache"""
    check_request([r["serve"] for r in runs[mesh]], reference[arch]["request"], arch, MESHES[mesh][0])


def test_dbrx_prefill_on_two_data_ranks(runs, reference):
    """the fault this family's serving had: on (data, model) = (2, 1) the
    rules cut dbrx's experts' F dim over "data" and nothing gathered it, so
    each rank ran its experts on half their hidden units with no collective
    and returned wrong logits; the FSDP gather restores the reference's"""
    want = reference["dbrx-132b"]["request"]["logits"][0]
    for r in runs["2x1"]:
        run = r["serve"]["dbrx-132b"]
        dp, n = _dp_index(run["coord"], (2, 1))
        assert np.abs(run["logits"][0] - want[dp * B // n:(dp + 1) * B // n]).max() <= 2e-4
        assert run["wire"]["data"] > 0


SLOTS = {"top2": dict(n_experts=4, topk=2, d_ff=8), "top1": dict(n_experts=4, topk=1, d_ff=8)}


def ref_slots(x, router, fields):
    """The reference's slots over the whole sequence (``repro/models/moe.py``
    :73-88, line for line; ``moe_apply`` does not return them)."""
    E, K = fields["n_experts"], fields["topk"]
    B_, S_, _ = x.shape
    C = max(1, int(S_ * K * 1.25 / E))
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, router).astype(jnp.float32), axis=-1)
    _, gate_idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    flat = onehot.transpose(0, 2, 1, 3).reshape(B_, K * S_, E)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(B_, K, S_, E)
    pos = jnp.sum(pos.transpose(0, 2, 1, 3) * onehot, axis=-1)
    return np.asarray(gate_idx), np.asarray(pos), np.asarray(pos < C)


@pytest.fixture(scope="module")
def slot_runs(tmp_path_factory):
    rng = np.random.default_rng(9)
    common = rng.standard_normal(16).astype(np.float32)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32) + common
    router = rng.standard_normal((16, 4)).astype(np.float32)
    router[:, 0] += common / 4                       # expert 0 takes most tokens: its slots overflow
    cases = {name: (x, router, fields) for name, fields in SLOTS.items()}
    out = {}
    for name, shape in (("1x2", (1, 2)), ("2x2", (2, 2))):
        tmp = tmp_path_factory.mktemp(f"slots{name}")
        with open(tmp / "cases.pkl", "wb") as f:
            pickle.dump(cases, f)
        out[name] = _torch_dist.spawn(ranks.slots, int(np.prod(shape)), tmp, shape, ("data", "model"),
                                      str(tmp / "cases.pkl"))
    return cases, out


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("topk", SLOTS)
def test_capacity_slots_over_the_whole_sequence(slot_runs, mesh, topk):
    """a rank's tokens take the slots the reference gives them over the
    whole sequence (k-major: every token's first choice before any second
    choice; earlier ranks' tokens first), and the whole sequence's capacity
    drops the same ones"""
    cases, out = slot_runs
    x, router, fields = cases[topk]
    gate_idx, pos, keep = ref_slots(jnp.asarray(x), jnp.asarray(router), fields)
    assert not keep.all()                             # the router overflows expert 0
    for r in out[mesh]:
        got = r[topk]
        rows = tuple(slice(a, b) for a, b in got["rows"])
        assert np.array_equal(got["gate_idx"], gate_idx[rows])
        assert np.array_equal(got["pos"], pos[rows])
        assert np.array_equal(got["keep"], keep[rows])
