"""Training data pipeline: sharded token streams with prefetch — the port's
own copy of ``repro/data/pipeline.py`` (``DataConfig``, ``SyntheticSource``,
``MemmapSource``, ``Pipeline``), numpy only, so that the port imports nothing
of the reference; ``tests/test_torch_train.py`` holds it to the original.

Production framing: every host process owns the slice of the global batch
that lives on its addressable devices (``process_index``-keyed sharding).
Sources:

* ``SyntheticSource`` — deterministic PRNG token stream (CI / smoke / bench);
  reproducible per (seed, host, step) so restarts re-produce the stream.
* ``MemmapSource``   — flat uint16/uint32 token file (np.memmap), the usual
  packed-corpus format.

``Pipeline`` adds: document packing into (tokens, labels) next-token pairs,
background prefetch (double buffering), straggler mitigation via a bounded
queue timeout + skip-ahead (a slow shard never stalls the job more than
``straggler_timeout_s``), and checkpointable iterator state.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    prefetch: int = 2
    straggler_timeout_s: float = 30.0
    pattern: str = "arith"      # arith (learnable) | uniform (stress)


class SyntheticSource:
    """Deterministic token stream — same (seed, host, step) => same batch.

    ``arith`` emits arithmetic token runs (next token = prev + stride mod V):
    a predictable language the smoke models can actually learn, so e2e
    training tests can assert loss decreases.
    """

    def __init__(self, cfg: DataConfig, host_index: int = 0, host_count: int = 1):
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        assert cfg.global_batch % host_count == 0
        self.local_batch = cfg.global_batch // host_count

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, self.host_index, step))
        B, S, V = self.local_batch, self.cfg.seq_len + 1, self.cfg.vocab_size
        if self.cfg.pattern == "uniform":
            return rng.integers(0, V, size=(B, S), dtype=np.int32)
        start = rng.integers(0, V, size=(B, 1))
        stride = rng.integers(1, 4, size=(B, 1))
        t = np.arange(S)[None, :]
        return ((start + stride * t) % V).astype(np.int32)


class MemmapSource:
    """Packed-token corpus file; hosts stride through disjoint offsets."""

    def __init__(
        self,
        path: str,
        cfg: DataConfig,
        host_index: int = 0,
        host_count: int = 1,
        dtype=np.uint16,
    ):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        self.stride = self.local_batch * (cfg.seq_len + 1)

    def batch_at(self, step: int) -> np.ndarray:
        n = len(self.tokens)
        base = (step * self.host_count + self.host_index) * self.stride
        idx = (base + np.arange(self.stride)) % (n - 1)
        flat = np.asarray(self.tokens[idx], dtype=np.int32)
        return flat.reshape(self.local_batch, self.cfg.seq_len + 1)


class Pipeline:
    """Prefetching iterator of {"tokens","labels"} next-token batches."""

    def __init__(self, source, cfg: DataConfig, start_step: int = 0):
        self.source = source
        self.cfg = cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            raw = self.source.batch_at(step)
            batch = {
                "tokens": raw[:, :-1],
                "labels": raw[:, 1:],
                "step": step,
            }
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        # straggler mitigation: if the producer stalls (slow storage shard),
        # synthesize the batch inline rather than stalling the whole step
        try:
            batch = self._q.get(timeout=self.cfg.straggler_timeout_s)
        except queue.Empty:
            raw = self.source.batch_at(self.step)
            batch = {"tokens": raw[:, :-1], "labels": raw[:, 1:], "step": self.step}
        self.step = batch["step"] + 1
        return batch

    def state(self) -> dict:
        """Checkpointable position."""
        return {"step": self.step}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
