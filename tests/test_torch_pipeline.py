"""The port's GPipe pipeline (``repro_torch.parallel.pipeline``) on 4 stage
ranks (gloo, CPU), held against the sequential layer stack as the
reference's own test intends (``tests/test_pipeline.py``: L = 8, D = 16,
MB = 4, NMB = 6), within 1e-5 in fp32: the stack run by JAX (the
reference's ``scan`` of ``tanh(h @ w)``) and by torch in one process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from repro_torch.parallel.pipeline import stage_split

from _torch_parity import one_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

L, D, MB, NMB, STAGES = 8, 16, 4, 6, 4


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((L, D, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((NMB, MB, D)).astype(np.float32)
    return ws, x


@pytest.fixture(scope="module")
def outputs(tmp_path_factory, inputs):
    return _torch_dist.spawn(_torch_dist.pipeline, STAGES, tmp_path_factory.mktemp("stages"), *inputs)


def _jax_sequential(ws, x):
    def ref(xm):
        def body(h, w):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, xm, ws)
        return h
    return np.asarray(jax.vmap(ref)(jnp.asarray(x)))


def test_last_stage_matches_sequential(outputs, inputs):
    ws, x = inputs
    y = outputs[-1]
    assert y.shape == x.shape
    assert np.abs(y - _jax_sequential(ws, x)).max() < 1e-5
    h = torch.from_numpy(x)
    for w in torch.from_numpy(ws):
        h = torch.tanh(h @ w)
    assert np.abs(y - h.numpy()).max() < 1e-5


def test_other_stages_collect_nothing(outputs):
    for y in outputs[:-1]:
        assert not y.any()


def test_stage_split():
    ws = torch.arange(L * 3 * 2, dtype=torch.float32).reshape(L, 3, 2)
    tree = stage_split({"w": ws, "b": {"c": ws[:, 0]}}, STAGES)
    assert tree["w"].shape == (STAGES, L // STAGES, 3, 2) and tree["b"]["c"].shape == (STAGES, L // STAGES, 2)
    assert torch.equal(tree["w"][1], ws[2:4])
    with pytest.raises(AssertionError):
        stage_split(ws[:7], STAGES)
