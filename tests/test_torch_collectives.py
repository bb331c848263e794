"""The port's collectives (``repro_torch.parallel.collectives``) against the
reference's, rank by rank: 8 gloo ranks on a (pod, data, model) = (2, 2, 2)
mesh and 2 ranks on a (2,) mesh, on the CPU.

The reference runs in one JAX subprocess with 8 host devices, as
``tests/test_hier_collectives.py`` runs it, on the same numpy inputs: each
function on an input every device holds (the reference's own case) and on
one that differs by device (a ``P()`` array built from per-device buffers,
which ``shard_map(in_specs=P())`` hands each device as it is).  Each
device's output is read from its own shard.  The sums are fp32 and held at
1e-6 relative; the gathers and the all-to-all move values and are held
exactly.  The subprocess also gives ``NamedSharding.devices_indices_map`` of
the smoke model's leaves, held against the blocks DTensor cuts under the
port's ``tree_shardings`` and against ``local_slices``."""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import _torch_dist
from repro_torch.configs import load
from repro_torch.models.param import tree_leaves, tree_pspecs
from repro_torch.parallel.sharding import make_rules, tree_zero1_pspecs

from _torch_parity import one_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

MESH3 = ((2, 2, 2), ("pod", "data", "model"))
MESH1 = ((2,), ("data",))

REFERENCE = textwrap.dedent(
    """
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.parallel.collectives import (
        flat_allreduce, hierarchical_allreduce, hierarchical_all_to_all, multipath_split,
    )

    with open(sys.argv[1], "rb") as f:
        inputs = pickle.load(f)
    out = {}

    def run(mesh, fn, per_rank):
        # rank of each device: its row-major position in the mesh, as the
        # port's init_device_mesh numbers its ranks
        rank = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
        devs = list(mesh.devices.reshape(-1))
        x = jax.make_array_from_single_device_arrays(
            per_rank[0].shape, NamedSharding(mesh, P()),
            [jax.device_put(per_rank[rank[d]], d) for d in devs])
        with mesh:
            y = jax.jit(fn)(x)
        ys = y if isinstance(y, tuple) else (y,)
        res = [[None] * len(ys) for _ in devs]
        for k, t in enumerate(ys):
            for s in t.addressable_shards:
                res[rank[s.device]][k] = np.asarray(s.data)
        return [r if isinstance(y, tuple) else r[0] for r in res]

    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    for case in ("equal", "differ"):
        xs = inputs["mesh3"][case]
        out[f"hier_{case}"] = run(mesh, hierarchical_allreduce(mesh, "model", ("data", "pod")), xs)
        out[f"flat_{case}"] = run(mesh, flat_allreduce(mesh, ("model", "data", "pod")), xs)
        out[f"multipath_{case}"] = run(mesh, multipath_split(mesh, "data", "model"), xs)
        out[f"a2a_{case}"] = run(mesh, hierarchical_all_to_all(mesh, "model", "data"),
                                 inputs["mesh3"]["a2a_" + case])
    rank = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
    shards = {}
    for name, (pspec, shape) in inputs["mesh3"]["specs"].items():
        idx = NamedSharding(mesh, P(*pspec)).devices_indices_map(shape)
        shards[name] = {rank[d]: tuple((s.start or 0, shape[i] if s.stop is None else s.stop)
                                       for i, s in enumerate(sl)) for d, sl in idx.items()}
    out["shards"] = shards

    mesh1 = Mesh(np.array(jax.devices()[:2]), ("data",))
    for case in ("equal", "differ"):
        xs = inputs["mesh1"][case]
        out[f"mesh1_hier_{case}"] = run(mesh1, hierarchical_allreduce(mesh1, "data", ()), xs)
        out[f"mesh1_flat_{case}"] = run(mesh1, flat_allreduce(mesh1, ("data",)), xs)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    print("REFERENCE_OK")
    """
)


def _specs() -> dict:
    """(pspec, shape) of every leaf of the granite smoke model's params and
    ZeRO-1 state under the multi-pod rules (names: path in leaf order)."""
    h = load("granite-8b", smoke=True)
    specs = h.param_specs()
    rules = make_rules(multi_pod=True)
    out = {}
    for kind, tree in (("param", tree_pspecs(specs, rules)), ("zero1", tree_zero1_pspecs(specs, rules, 32))):
        for i, (ps, s) in enumerate(zip(tree_leaves(tree), tree_leaves(specs))):
            out[f"{kind}{i}"] = (ps, s.shape)
    return out


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    z = np.arange(4 * 8, dtype=np.float32).reshape(4, 8)
    mesh3 = {"equal": [x] * 8, "differ": list(rng.standard_normal((8, 8, 16)).astype(np.float32)),
             "a2a_equal": [z] * 8, "a2a_differ": list(rng.standard_normal((8, 4, 8)).astype(np.float32)),
             "specs": _specs()}
    # "odd" (port only: the reference's reduce-scatter needs dim 0 to divide):
    # 15 elements, so the fast axis's last chunk is padded
    mesh1 = {"equal": [x[:6]] * 2, "differ": list(rng.standard_normal((2, 6, 16)).astype(np.float32)),
             "odd": list(rng.standard_normal((2, 5, 3)).astype(np.float32))}
    return {"mesh3": mesh3, "mesh1": mesh1}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def reference(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("reference")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    r = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(tmp / "in.pkl"), str(tmp / "out.pkl")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stdout + r.stderr
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(tmp_path_factory, inputs):
    return {
        "mesh3": _torch_dist.spawn(_torch_dist.collectives, 8, tmp_path_factory.mktemp("ranks8"),
                                   *MESH3, inputs["mesh3"]),
        "mesh1": _torch_dist.spawn(_torch_dist.collectives, 2, tmp_path_factory.mktemp("ranks2"),
                                   *MESH1, inputs["mesh1"]),
    }


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("case", ["equal", "differ"])
@pytest.mark.parametrize("fn", ["hier", "flat"])
def test_allreduce_matches_reference(port, reference, inputs, fn, case):
    """each rank's sum equals the reference device's, and the sum over the
    ranks' inputs in float64; every rank of the port holds the same bits"""
    want64 = np.sum(np.asarray(inputs["mesh3"][case], np.float64), axis=0)
    for r, res in enumerate(port["mesh3"]):
        got = res[f"{fn}_{case}"]
        assert got.dtype == np.float32 and got.shape == want64.shape
        _close(got, reference[f"{fn}_{case}"][r])
        _close(got, want64)
        assert np.array_equal(got, port["mesh3"][0][f"{fn}_{case}"])


@pytest.mark.parametrize("case", ["equal", "differ"])
@pytest.mark.parametrize("fn", ["hier", "flat"])
def test_allreduce_on_two_ranks(port, reference, inputs, fn, case):
    """a (2,) mesh, no slow axis; and a tensor whose 15 elements the fast
    axis cannot split evenly (a padded chunk), against the float64 sum"""
    odd = np.sum(np.asarray(inputs["mesh1"]["odd"], np.float64), axis=0)
    for r, res in enumerate(port["mesh1"]):
        _close(res[f"{fn}_{case}"], reference[f"mesh1_{fn}_{case}"][r])
        _close(res[f"{fn}_odd"], odd)


@pytest.mark.parametrize("case", ["equal", "differ"])
def test_multipath_split_matches_reference(port, reference, case):
    for r, res in enumerate(port["mesh3"]):
        a, b = res[f"multipath_{case}"]
        ra, rb = reference[f"multipath_{case}"][r]
        assert np.array_equal(a, ra) and np.array_equal(b, rb)


@pytest.mark.parametrize("case", ["equal", "differ"])
def test_hierarchical_all_to_all_matches_reference(port, reference, inputs, case):
    """the permutation, rank by rank (the reference's own test checks only
    that the shape is kept); no value lost or made"""
    outs = [res[f"a2a_{case}"] for res in port["mesh3"]]
    for r, got in enumerate(outs):
        assert np.array_equal(got, reference[f"a2a_{case}"][r])
    sent = np.sort(np.concatenate([x.reshape(-1) for x in inputs["mesh3"]["a2a_" + case]]))
    assert np.array_equal(np.sort(np.concatenate([o.reshape(-1) for o in outs])), sent)


def test_slow_axes_carry_less(port):
    """the operand bytes on each slow axis of the hierarchical all-reduce are
    at most the flat all-reduce's over n_fast (the reference test's
    ``ar_h <= ar_f / 2 + 1``, read from the HLO there); the sum comes out in
    fp32 for a bf16 input"""
    n_fast = 2
    for res in port["mesh3"]:
        hier, flat = res["wire"]["hier"], res["wire"]["flat"]
        for ax in ("data", "pod"):
            assert 0 < hier[ax] <= flat[ax] / n_fast
        assert res["dtype"] == "torch.float32"


def test_local_shards_match_named_sharding(port, reference, inputs):
    """every leaf of the smoke model's params and ZeRO-1 state: the block
    each rank holds under ``tree_shardings`` (DTensor) and under
    ``local_slices`` equals the reference device's
    ``devices_indices_map``"""
    for r, res in enumerate(port["mesh3"]):
        for name, blocks in res["shards"].items():
            want = reference["shards"][name][r]
            assert blocks["dtensor"] == want, (name, r)
            assert blocks["local_slices"] == want, (name, r)
    assert any(len({reference["shards"][n][r] for r in range(8)}) == 8 for n in inputs["mesh3"]["specs"])
