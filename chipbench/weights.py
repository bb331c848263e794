"""The weights, made by the benchmark from ``--seed`` on the device and
handed to both sides: the program gets them as its parameter tree, the
reference draws them again after the window.

The layout is the configuration family's (``models/<family>.py``,
``leaf_specs``): a nested dict with the program's key names
(``launch/train.run`` and ``launch/serve.run`` take ``params=`` in that
form).  Every leaf is drawn by its own generator on the device, in one call
and in bfloat16, the type it is trained and served in, so that one leaf
can be drawn again without the others:

- ``scaled``: standard normal times the spec's std (1/sqrt(fan in));
- ``normal``: standard normal times the spec's std;
- ``ones``: norm scales.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import registry

VOCAB_ROUND = 256      # the table's rows are the vocabulary rounded up to this


def vocab_padded(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // VOCAB_ROUND) * VOCAB_ROUND


def leaf_specs(cfg: dict) -> list[tuple[tuple[str, ...], tuple[int, ...], str, float]]:
    """``(path, shape, init, std)`` of every leaf, in sorted path order."""
    return registry.family(cfg).leaf_specs(cfg)


def _leaf_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([seed, 1000 + index]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def draw_leaf(cfg: dict, seed: int, index: int, device) -> torch.Tensor:
    _, shape, init, std = leaf_specs(cfg)[index]
    if init == "ones":
        return torch.ones(shape, dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, index))
    return torch.randn(shape, generator=gen, dtype=torch.bfloat16, device=device).mul_(std)


SAMPLE = 1 << 20        # elements a leaf that the check compares one by one


def sample_index(cfg: dict, seed: int, index: int, device) -> torch.Tensor:
    """The positions of leaf ``index``'s elements that the check compares:
    all of a small leaf, else ``SAMPLE`` drawn from the seed on the device."""
    numel = math.prod(leaf_specs(cfg)[index][1])
    if numel <= SAMPLE:
        return torch.arange(numel, device=device)
    gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, 5000 + index))
    return torch.randint(numel, (SAMPLE,), generator=gen, device=device)


def sample(cfg: dict, seed: int, index: int, t: torch.Tensor) -> torch.Tensor:
    """Leaf ``index``'s sampled elements of ``t`` in fp32 on the host."""
    return t.reshape(-1)[sample_index(cfg, seed, index, t.device)].float().cpu()


def samples(cfg: dict, seed: int, tree: dict) -> list:
    """Each leaf's sampled elements in fp32 on the host."""
    return [sample(cfg, seed, i, t) for i, (_, t) in enumerate(flatten(tree))]


def nest(paths: list[tuple[str, ...]], leaves: list) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def flatten(tree: dict, prefix: tuple[str, ...] = ()) -> list[tuple[tuple[str, ...], object]]:
    """``(path, leaf)`` in sorted path order."""
    out = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.extend(flatten(tree[key], prefix + (key,)))
        else:
            out.append((prefix + (key,), tree[key]))
    return out


def draw(cfg: dict, seed: int, device) -> dict:
    specs = leaf_specs(cfg)
    return nest([s[0] for s in specs], [draw_leaf(cfg, seed, i, device) for i in range(len(specs))])
