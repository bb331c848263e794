"""The port's ``CheckpointManager.restore(..., shardings=)``, the elastic
re-shard path, against the reference's restore onto ``NamedSharding``s.

One save of a granite-8b smoke training state (bf16 params, the fp32
ZeRO-1 master and moments, the step), as a (data, model) = (2, 2) run
writes it (unsharded), is restored onto (1, 2), (4, 1) and (2, 2) on gloo
ranks: each rank's blocks, under the params' pspecs and the optimizer
state's ZeRO-1 pspecs, must be bit-equal to the block the reference's
``restore(..., shardings=NamedSharding(...))`` of the same save places on
the device at the same mesh coordinate (read from ``addressable_shards``;
the reference runs in a subprocess with eight host devices).  The same
ranks also restore through ``runtime.elastic.rescale`` with the port's own
manager.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_dist import reshard_restore, spawn
from _torch_parity import one_thread  # noqa: F401  (the fixture)
from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.configs import load
from repro_torch.models.param import tree_map, tree_pspecs
from repro_torch.parallel.sharding import make_rules, tree_zero1_pspecs

pytestmark = pytest.mark.usefixtures("one_thread")

STEP = 12
MESHES = [(1, 2), (4, 1), (2, 2)]

REFERENCE = textwrap.dedent(
    """
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.checkpoint.manager import CheckpointManager

    directory, step, specs, pspecs, meshes, out_path = pickle.load(open(sys.argv[1], "rb"))
    like = {k: jax.ShapeDtypeStruct(s, getattr(jax.numpy, t)) for k, (s, t) in specs.items()}
    out = {}
    for shape in meshes:
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
        sh = {k: NamedSharding(mesh, P(*ps)) for k, ps in pspecs.items()}
        state = CheckpointManager(directory).restore(step, like, shardings=sh)
        for coord in np.ndindex(*shape):
            dev = mesh.devices[coord]
            got = {}
            for k, a in state.items():
                (shard,) = [s for s in a.addressable_shards if s.device == dev]
                b = np.asarray(shard.data)
                got[k] = (str(a.dtype), b.astype(np.float32) if a.dtype == jax.numpy.bfloat16 else b)
            out[(shape, coord)] = got
    pickle.dump(out, open(out_path, "wb"))
    """
)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The save, its leaves' shapes and types, their pspecs, and each mesh
    coordinate's blocks as the reference restores them."""
    tmp = tmp_path_factory.mktemp("reshard")
    harness = load("granite-8b", smoke=True).clone(dtype=torch.bfloat16)
    specs = harness.param_specs()
    rules = make_rules()
    zero = tree_zero1_pspecs(specs, rules, 16)
    rng = np.random.default_rng(0)

    def draw(dtype):
        return lambda s: torch.from_numpy(rng.standard_normal(s.shape, dtype=np.float32)).to(dtype)

    state = {"params": tree_map(draw(torch.bfloat16), specs),
             "opt": {"master": tree_map(draw(torch.float32), specs),
                     "m": tree_map(draw(torch.float32), specs),
                     "v": tree_map(lambda s: draw(torch.float32)(s).abs(), specs),
                     "step": torch.tensor(STEP, dtype=torch.int32)}}
    pspecs = flatten({"params": tree_pspecs(specs, rules),
                      "opt": {"master": zero, "m": zero, "v": zero, "step": ()}})
    CheckpointManager(str(tmp / "ckpt")).save(STEP, state, blocking=True)
    flat = {k: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for k, t in flatten(state).items()}
    args = tmp / "args.pkl"
    with open(args, "wb") as f:
        pickle.dump((str(tmp / "ckpt"), STEP, flat, pspecs, MESHES, str(tmp / "ref.pkl")), f)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run([sys.executable, "-c", REFERENCE, str(args)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return tmp, flat, pspecs, ref


def test_save_holds_every_leaf_whole(saved):
    """The reference placed every coordinate of every mesh; a leaf its
    pspec leaves replicated comes back whole at each, and the pspecs cut
    over both "data" and "model"."""
    _, flat, pspecs, ref = saved
    assert set(ref) == {(s, c) for s in MESHES for c in np.ndindex(*s)}
    assert any("data" in str(ps) for ps in pspecs.values())
    assert any("model" in str(ps) for ps in pspecs.values())
    for (shape, coord), got in ref.items():
        assert set(got) == set(flat)
        for k, (dtype, block) in got.items():
            if pspecs[k] == () or all(p is None for p in pspecs[k]):
                assert block.shape == flat[k][0]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_restore_reshards_as_the_reference(saved, shape, tmp_path):
    tmp, flat, pspecs, ref = saved
    world = int(np.prod(shape))
    out = spawn(reshard_restore, world, tmp_path, shape, str(tmp / "ckpt"), STEP, flat, pspecs)
    assert {o["new_dp"] for o in out} == {shape[0]}
    cut = 0
    for rank, o in enumerate(out):
        coord = np.unravel_index(rank, shape)
        want = ref[(shape, tuple(int(c) for c in coord))]
        for how in ("restore", "rescale"):
            got = o[how]
            assert set(got) == set(want)
            for k, (dtype, device, block) in got.items():
                ref_dtype, ref_block = want[k]
                assert dtype.removeprefix("torch.") == ref_dtype == flat[k][1], k
                assert device == "cpu"
                assert block.dtype == ref_block.dtype and block.shape == ref_block.shape, k
                assert block.tobytes() == ref_block.tobytes(), (shape, rank, k)
                cut += block.shape != flat[k][0]
    assert cut > 0          # some leaf is cut on every mesh with more than one rank
