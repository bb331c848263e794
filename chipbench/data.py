"""The inputs both sides get, made by the benchmark and read again by the
reference.  Frozen numpy copies of the program's own draws, so that the
reference regenerates the tokens the timed path trained on or served:

- ``train_batch`` is ``SyntheticSource.batch_at`` of
  ``repro_torch/data/pipeline.py`` (pattern ``arith``, one host), cut into
  tokens and labels as ``Pipeline`` cuts it; ``launch/train.run`` draws its
  data there at data seed 0 (it takes no data from its caller);
- ``prompts`` is ``launch/serve.run``'s prompt draw,
  ``np.random.default_rng(seed).integers(0, vocab, (B, L), int32)``.

``batch_seeds`` and ``prefill_schedule`` are the general generator of the
traffic: everything they make follows from the mix's parameters and
``--seed``.
"""

from __future__ import annotations

import numpy as np

TRAIN_DATA_SEED = 0      # launch/train.run's DataConfig(seed=0)


def train_batch(step: int, batch: int, seq: int, vocab: int, seed: int = TRAIN_DATA_SEED) -> dict:
    rng = np.random.default_rng((seed, 0, step))
    start = rng.integers(0, vocab, size=(batch, 1))
    stride = rng.integers(1, 4, size=(batch, 1))
    t = np.arange(seq + 1)[None, :]
    raw = ((start + stride * t) % vocab).astype(np.int32)
    return {"tokens": raw[:, :-1], "labels": raw[:, 1:]}


def prompts(seed: int, batch: int, length: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=(batch, length), dtype=np.int32)


def batch_seeds(seed: int, n: int, stream: int) -> list[int]:
    """``n`` seeds for the program's per-batch draws, from ``--seed`` and a
    stream number (warm-up and window draw apart)."""
    state = np.random.SeedSequence([seed, stream]).generate_state(n, np.uint64)
    return [int(s >> np.uint64(1)) for s in state]


def prefill_schedule(seed: int, lengths: list[int], n_batches: int) -> list[int]:
    """Prompt lengths of ``n_batches`` batches: whole rounds of ``lengths``,
    each round in an order drawn from ``--seed``, so that every seed does the
    same work in a different order."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    out: list[int] = []
    while len(out) < n_batches:
        out.extend(int(lengths[i]) for i in rng.permutation(len(lengths)))
    return out[:n_batches]
