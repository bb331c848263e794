"""Shared helpers of the ``test_torch_*`` files: carry data between the JAX
reference (``repro``) and the PyTorch port (``repro_torch``) as numpy arrays.

Both packages run on the CPU here.  Inputs and weights are made once (numpy,
or the reference's ``tree_init``), exported as float32 numpy arrays (exact for
bfloat16, which numpy lacks) and handed to both sides.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.models.param import from_reference

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_np(tree):
    """A JAX (or torch) tree as float32 / integer numpy arrays."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
        if jnp.issubdtype(x.dtype, jnp.floating):
            return np.asarray(x, np.float32)
        return np.asarray(x)
    return jax.tree.map(conv, tree)


def carry(tree, dtype=None):
    """Reference tree -> port tree on the CPU, float leaves cast to ``dtype``."""
    return from_reference(to_np(tree), dtype, "cpu")


def rand(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def both(a, dtype: str):
    """One numpy array as (jax array, torch tensor) of the named float type."""
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def max_err(port, ref) -> float:
    p, r = to_np(port), to_np(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    return float(np.max(np.abs(p - r))) if p.size else 0.0


BF16_ULP = 2.0 ** -7     # one bf16 ulp of l is at most 2^-7 |l|


def routing_margin_ulps(logits, k: int) -> float:
    """Smallest gap between neighbouring choices among the top k + 1 router
    logits of any token (the order of the top k, and the k-th against the
    next), in bf16 ulps of the larger of the two.  Below a few ulps, two
    frameworks that round the bf16 logits apart may route the token apart."""
    top = -np.sort(-np.asarray(to_np(logits), np.float64), axis=-1)[..., :k + 1]
    gaps = (top[..., :-1] - top[..., 1:]) / (BF16_ULP * np.abs(top[..., :-1]))
    return float(gaps.min())


@contextlib.contextmanager
def routing_margins():
    """Collects ``routing_margin_ulps`` of every routing the port's MoE
    layers do inside the block (a list, one entry a layer call)."""
    from repro_torch.models import moe

    seen, route = [], moe.route

    def recording(x, router, cfg):
        seen.append(routing_margin_ulps((x @ router).float(), cfg.topk))
        return route(x, router, cfg)

    moe.route = recording
    try:
        yield seen
    finally:
        moe.route = route
