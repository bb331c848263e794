"""Shared helpers of the ``test_torch_*`` files: carry data between the JAX
reference (``repro``) and the PyTorch port (``repro_torch``) as numpy arrays.

Both packages run on the CPU here.  Inputs and weights are made once (numpy,
or the reference's ``tree_init``), exported as float32 numpy arrays (exact for
bfloat16, which numpy lacks) and handed to both sides.
"""

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
