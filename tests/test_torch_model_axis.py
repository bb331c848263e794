"""The dense family's train step and prefill on a mesh with a "model" axis
(``train/train_step.py``, ``parallel/collectives.ModelAxis``,
``models/transformer.py``) on gloo ranks on the CPU, against the reference on
one device: fp32 smoke configs of granite-8b, starcoder2-7b (sliding window
below the sequence, qkv biases, LayerNorm and GELU) and phi4-mini-3.8b (one
KV head), on (data, model) = (1, 2) (two steps) and (2, 2), and granite-8b
on (pod, data, model) = (2, 2, 2) (one step each); int8 compression.

Each rank holds its data-parallel share of the batch, the positions
``[r·S/m, (r+1)·S/m)`` of each sequence and its model shard of each weight.
Held: the loss and the gradients gathered from the ranks' blocks against
``jax.value_and_grad`` of the reference's loss at 2e-5 of each leaf's
largest |g| (the port's fp32 gradient tolerance); each rank's ZeRO-1 shard
and params after the first step against ``adamw.apply`` of the whole trees
on the gathered payload at 1e-6, and the clip norm the ranks reckon from
their shards against the whole payload's at 1e-6; the int8 payload bit-equal to
``compress_grads`` of the whole synchronised gradient in one process (each
leaf's scale is the whole leaf's); the params bit-identical across the data
ranks.  Prefill and the attention layer on the model axis:
``tests/test_torch_model_axis_prefill.py``."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_model_axis_ranks as ranks
import repro.configs as ref_configs
from repro.models.layers import Runtime as RefRuntime
from repro_torch.configs import load
from repro_torch.models.param import from_reference, tree_init, tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.optim.compression import CompressionConfig, compress_grads

from _torch_parity import one_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

RRT = RefRuntime(rules=None)
ARCHS = ("granite-8b", "starcoder2-7b", "phi4-mini-3.8b")
MESHES = {"1x2": ((1, 2), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
B, S = 4, 128            # starcoder2's smoke window is 64: half a sequence
# the archs each mesh runs, and their steps
RUNS = {"1x2": (ARCHS, 2), "2x2": (ARCHS, 1), "2x2x2": (ARCHS[:1], 1)}
CELLS = [(mesh, arch) for mesh, (archs, _) in RUNS.items() for arch in archs]


def _ref(arch):
    return ref_configs.load(arch, smoke=True).clone(dtype=jnp.float32)


def weights(i: int, arch: str):
    """fp32 weights of ``arch``'s smoke config drawn from seed 11 + i by the
    port's ``tree_init`` (the reference's initialisers), as numpy."""
    specs = load(arch, smoke=True).param_specs()
    return tree_map(lambda t: t.numpy(), tree_init(specs, torch.Generator().manual_seed(11 + i), torch.float32, "cpu"))


@pytest.fixture(scope="module")
def cases():
    out = {}
    for i, arch in enumerate(ARCHS):
        tok = np.random.default_rng(i).integers(0, _ref(arch).cfg.vocab_size, (B, S + 1)).astype(np.int32)
        out[arch] = (weights(i, arch), {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    return out


@pytest.fixture(scope="module")
def reference(cases):
    out = {}
    for arch, (w, batch) in cases.items():
        loss, grads = jax.value_and_grad(_ref(arch).loss(RRT))(jax.tree.map(jnp.asarray, w),
                                                               {k: jnp.asarray(v) for k, v in batch.items()})
        out[arch] = {"loss": float(loss), "grads": [np.asarray(g) for g in jax.tree.leaves(grads)]}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cases):
    """Each mesh's ranks, spawned once for the module."""
    out = {}
    for name, (shape, axes) in MESHES.items():
        archs, steps = RUNS[name]
        tmp = tmp_path_factory.mktemp(f"ranks{name}")
        with open(tmp / "cases.pkl", "wb") as f:
            pickle.dump({a: cases[a] for a in archs}, f)
        out[name] = _torch_dist.spawn(ranks.train, int(np.prod(shape)), tmp, shape, axes, str(tmp / "cases.pkl"),
                                      steps)
    return out


def _assemble(res, arch, key, blocks, like) -> list[np.ndarray]:
    """Each leaf whole from the ranks' blocks (ranks that hold the same block
    must hold the same bits); every element covered."""
    full = [np.full(a.shape, np.nan, np.float32) for a in like]
    for r in res:
        for f, g, blk in zip(full, tree_leaves(r[arch][key]), r[arch][blocks]):
            at = tuple(slice(a, b) for a, b in blk)
            assert np.isnan(f[at]).all() or np.array_equal(f[at], g)
            f[at] = g
    assert not any(np.isnan(f).any() for f in full)
    return full


def _dp_index(coord: dict, shape: tuple) -> tuple[int, int]:
    """(this rank's data-parallel index, the DP size)."""
    data = shape[-2]
    return coord.get("pod", 0) * data + coord["data"], int(np.prod(shape[:-1]))


@pytest.mark.parametrize("mesh, arch", CELLS)
def test_loss_and_gradients_match_reference(runs, reference, mesh, arch):
    ref = reference[arch]
    res = runs[mesh]
    grads = _assemble(res, arch, "grads", "param_blocks", ref["grads"])
    for g, want in zip(grads, ref["grads"]):
        assert np.abs(g - want).max() <= 2e-5 * np.abs(want).max()
    # each DP share's loss is the sum of its model ranks' parts, on each of them
    shares = {}
    for r in res:
        dp, _ = _dp_index(r[arch]["coord"], MESHES[mesh][0])
        shares.setdefault(dp, set()).add(r[arch]["losses"][0])
    assert all(len(v) == 1 for v in shares.values())
    mean = np.mean([v.pop() for v in shares.values()])
    assert abs(mean - ref["loss"]) <= 2e-5


@pytest.mark.parametrize("mesh, arch", CELLS)
def test_shards_match_adamw_apply(runs, cases, mesh, arch):
    """each rank's master / m / v after the first step equal, on its ZeRO-1
    block, ``adamw.apply`` of the whole trees with the gathered payload, and
    its params apply's on its model shard"""
    res = runs[mesh]
    weights = cases[arch][0]
    like = tree_leaves(weights)
    payload = _assemble(res, arch, "payload", "param_blocks", like)
    params = from_reference(weights, torch.float32, "cpu")
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


@pytest.mark.parametrize("mesh, arch", CELLS)
def test_clip_norm_equals_whole_payload(runs, cases, mesh, arch):
    """the clip norm a rank reckons from its model shard (each leaf's sum of
    squares summed over the model ranks, a replicated leaf counted once) is
    the same on every rank and within 1e-6 of ``adamw.global_norm`` of the
    whole payload"""
    res = runs[mesh]
    payload = _assemble(res, arch, "payload", "param_blocks", tree_leaves(cases[arch][0]))
    whole = float(adamw.global_norm({str(i): torch.from_numpy(g) for i, g in enumerate(payload)}))
    norms = {r[arch]["gnorm"] for r in res}
    assert len(norms) == 1
    assert abs(norms.pop() - whole) <= 1e-6 * whole


@pytest.mark.parametrize("mesh, arch", CELLS)
def test_int8_payload_equals_one_process(runs, cases, mesh, arch):
    """compress_grads of the whole synchronised gradient in one process
    gives the ranks' payload blocks bit for bit"""
    res = runs[mesh]
    like = tree_leaves(cases[arch][0])
    synced = _assemble(res, arch, "grads", "param_blocks", like)
    payload = _assemble(res, arch, "payload", "param_blocks", like)
    deq, _ = compress_grads(CompressionConfig(mode="int8"), {str(i): torch.from_numpy(g) for i, g in enumerate(synced)})
    for i, want in enumerate(payload):
        assert np.array_equal(deq[str(i)].to(ranks.opt_cfg().grad_dtype).float().numpy(), want)


@pytest.mark.parametrize("mesh", MESHES)
def test_params_identical_across_data_ranks(runs, mesh):
    """the ranks of one model coordinate hold the same bits after every
    step, and the mean loss fell where there were two"""
    archs, steps = RUNS[mesh]
    for arch in archs:
        by_model = {}
        for r in runs[mesh]:
            by_model.setdefault(r[arch]["coord"]["model"], []).append(r[arch]["params"])
        for group in by_model.values():
            for other in group[1:]:
                for a, b in zip(group[0], other):           # step by step
                    for x, y in zip(tree_leaves(a), tree_leaves(b)):
                        assert np.array_equal(x, y)
        losses = [r[arch]["losses"] for r in runs[mesh]]
        assert steps == 1 or np.mean([x[-1] for x in losses]) < np.mean([x[0] for x in losses])


def _tree_like(tree, leaves: list):
    by_id = {id(t): torch.from_numpy(x) for t, x in zip(tree_leaves(tree), leaves)}
    return tree_map(lambda t: by_id[id(t)], tree)
