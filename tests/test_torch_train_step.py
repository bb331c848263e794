"""The port's ZeRO-1 train step (``repro_torch.train.train_step``) on 2 and 4
gloo ranks on the CPU: granite-8b smoke in fp32, uncompressed and int8.

Each data-parallel step is held against one process: the synchronised
gradient against the gradient of the whole batch at 2e-5 of each leaf's
largest |g| (the port's fp32 gradient tolerance), each rank's updated
ZeRO-1 shard against ``adamw.apply`` on the same synchronised (compressed)
gradient at 1e-6.  A whole step is not held at 1e-6 against a
single-process step: AdamW moves an element whose gradient is near zero by
about lr, so a last-bit difference in the gradient shows there.  Also
``build_serve_step``'s ``fn`` against the harness, and the bundle's
``abstract_args`` against ``tree_abstract``."""

import numpy as np
import pytest
import torch

import _torch_dist
from repro_torch.configs import load
from repro_torch.data.pipeline import DataConfig, Pipeline, SyntheticSource
from repro_torch.models.layers import Runtime
from repro_torch.models.param import from_reference, tree_abstract, tree_init, tree_leaves, value_and_grad
from repro_torch.optim import adamw
from repro_torch.optim.compression import CompressionConfig, compress_grads

from _torch_parity import one_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

SEED, STEPS = 0, 2
MESHES = {2: ((2, 1), ("data", "model")), 4: ((2, 2, 1), ("pod", "data", "model"))}
OPT = adamw.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=STEPS)      # as the ranks build it


def _harness():
    return load("granite-8b", smoke=True).clone(dtype=torch.float32)


def _params():
    return tree_init(_harness().param_specs(), torch.Generator().manual_seed(SEED), torch.float32, "cpu")


@pytest.fixture(scope="module")
def batch():
    cfg = DataConfig(global_batch=8, seq_len=16, vocab_size=_harness().cfg.vocab_size, seed=0)
    pipe = Pipeline(SyntheticSource(cfg), cfg)
    b = next(pipe)
    pipe.close()
    return {k: np.asarray(b[k]) for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, batch):
    """Each mesh's ranks, spawned once for the module."""
    out = {}
    for world, (shape, axes) in MESHES.items():
        out[world] = _torch_dist.spawn(_torch_dist.train_step, world, tmp_path_factory.mktemp(f"ranks{world}"),
                                       shape, axes, batch, STEPS, SEED)
    return out


@pytest.fixture(scope="module")
def single(batch):
    """The gradient and loss of the whole batch in one process."""
    loss, grads = value_and_grad(_harness().loss(Runtime()))(_params(), {k: torch.from_numpy(v)
                                                                         for k, v in batch.items()})
    return float(loss), [g.numpy() for g in tree_leaves(grads)]


@pytest.mark.parametrize("mode", ["none", "int8"])
@pytest.mark.parametrize("world", [2, 4])
def test_synced_gradient_matches_single_process(runs, single, world, mode):
    loss, grads = single
    for r, res in enumerate(runs[world]):
        got = tree_leaves(res[mode]["grads"])
        for g, want in zip(got, grads):
            err = np.abs(g - want).max()
            assert err <= 2e-5 * np.abs(want).max(), (r, err)
    # the loss of the whole batch is the mean of the ranks' losses (equal shares)
    mean = np.mean([res[mode]["losses"][0] for res in runs[world]])
    assert abs(mean - loss) <= 2e-5


@pytest.mark.parametrize("mode", ["none", "int8"])
@pytest.mark.parametrize("world", [2, 4])
def test_shard_update_matches_adamw_apply(runs, world, mode):
    """each rank's master / m / v after the first step equal, on its block,
    ``adamw.apply`` of the whole trees with that rank's synchronised payload;
    the params it holds after the step equal apply's; and in int8 the
    payload is ``compress_grads`` of the whole synchronised gradient"""
    for r, res in enumerate(runs[world]):
        run = res[mode]
        params = _params()
        state = adamw.init_opt_state(params)
        payload = from_reference(run["payload"], None, "cpu")
        adamw.apply(OPT, params, payload, state)
        for key in ("master", "m", "v"):
            for blk, full, shard in zip(run["blocks"], tree_leaves(state[key]), tree_leaves(run["shards"][key])):
                want = full[tuple(slice(a, b) for a, b in blk)].numpy()
                assert shard.shape == want.shape
                assert np.abs(shard - want).max() <= 1e-6, (r, key)
        for p, q in zip(tree_leaves(params), tree_leaves(run["params_1"])):
            assert np.abs(p.numpy() - q).max() <= 1e-6
        if mode == "int8":
            synced = from_reference(run["grads"], None, "cpu")
            deq, _ = compress_grads(CompressionConfig(mode="int8"), synced)
            for a, b in zip(tree_leaves(deq), tree_leaves(payload)):
                assert torch.equal(a.to(OPT.grad_dtype).float(), b)


@pytest.mark.parametrize("mode", ["none", "int8"])
@pytest.mark.parametrize("world", [2, 4])
def test_ranks_hold_identical_params(runs, world, mode):
    """the updated params are gathered from the shards: every rank holds the
    same bits after every step, and the loss fell"""
    first = runs[world][0][mode]
    for res in runs[world][1:]:
        for key in ("params_1", "params_end"):
            for a, b in zip(tree_leaves(first[key]), tree_leaves(res[mode][key])):
                assert np.array_equal(a, b)
    assert np.mean([res[mode]["losses"][-1] for res in runs[world]]) < first["losses"][0]


@pytest.mark.parametrize("world", [2, 4])
def test_zero1_blocks_partition_each_leaf(runs, world):
    """over the ranks, each leaf's blocks are disjoint and cover it (a leaf
    no DP axis cuts is whole on every rank); some leaves are cut"""
    specs = tree_leaves(_harness().param_specs())
    cut = 0
    for i, s in enumerate(specs):
        blocks = {res["none"]["blocks"][i] for res in runs[world]}
        count = np.zeros(s.shape, np.int64)
        for blk in blocks:
            count[tuple(slice(a, b) for a, b in blk)] += 1
        assert (count == 1).all()
        cut += len(blocks) > 1
    assert cut >= len(specs) // 2


def test_serve_step_matches_harness(runs):
    serve = runs[2][0]["serve"]
    assert serve["prefill"] == 0.0 and serve["decode"] == 0.0
    assert serve["shapes"] == ((2, 1, _harness().cfg.vocab_size),) * 2


def test_abstract_args_match_tree_abstract(runs):
    """the bundle's abstract args: meta tensors of the global shapes, params
    in bf16, the optimizer state's and the inputs' own types"""
    from repro_torch.models.api import ShapeCell

    h = _harness()
    specs = h.param_specs()
    want = [tree_abstract(specs, dtype=torch.bfloat16), tree_abstract(adamw.opt_state_specs(specs)),
            tree_abstract(h.train_input_specs(ShapeCell("smoke", "train", 16, 8)))]
    got = runs[2][0]["abstract"]
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g == [(tuple(t.shape), str(t.dtype), "meta") for t in tree_leaves(w)]
    # the masters' placements: the ZeRO-1 specs on the (data, model) mesh
    assert "Shard" in "".join(runs[2][0]["in_shardings"])


def test_step_needs_a_data_parallel_mesh():
    """a mesh without a "data" axis, or with an axis other than "pod",
    "data" and "model" of more than one rank, is refused (every family runs
    on a "model" axis of more than one rank: ``tests/test_torch_model_axis*.py``)"""
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models.api import ShapeCell
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.train_step import build_train_step

    cell = ShapeCell("s", "train", 16, 2)
    for shape, axes in (((2,), ("model",)), ((2, 2), ("data", "stage"))):
        with fake_mesh(shape, axes) as mesh:
            with pytest.raises(ValueError, match="needs a 'data' axis"):
                build_train_step(load("rwkv6-1.6b", smoke=True), cell, mesh, rules=make_rules())
