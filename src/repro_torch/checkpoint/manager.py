"""Checkpointing with an async save — port of ``repro/checkpoint/manager.py``
(``CheckpointManager``: ``save``, ``wait``, ``steps``, ``latest_step``,
``restore``).

The on-disk layout is the reference's, so that a checkpoint written by
either package restores in the other::

    <dir>/step_<08d>/
        meta.json          step, sorted flat keys, shapes, dtypes; written
                           last, through meta.json.tmp and a rename
        <flat_key>.npy     one file a leaf, "/" in the key turned into "__"

A flat key is the nested dict's keys joined by "/" in sorted order, which is
the path ``jax.tree_util.tree_flatten_with_path`` gives the same dict (for
example ``params/blocks/attn/wq``, ``opt/step``).  npy has no bfloat16, so a
bfloat16 leaf is stored widened to float32 and narrowed back on restore to
the type of the target tree's leaf; every other type is stored as it is.

``save`` takes a host copy of every leaf before it returns (the training loop
updates its tensors in place) and writes the files on a background thread.
An error on that thread is raised by the next ``wait`` (or ``save``).  A
directory without ``meta.json`` is a save that did not finish and is not
listed.  ``keep`` saves are kept, the oldest removed first.

``restore(..., shardings=)`` re-shards a save onto another mesh, the
elastic-restart path (``runtime/elastic.rescale``): ``shardings`` is a tree
shaped like the target whose leaves are ``parallel.sharding.Placement``s
(a mesh and a pspec tuple, the port's form of the reference's
``NamedSharding``), and each such leaf comes back as the block this rank
holds under it, on the mesh's device, as the reference's ``jax.device_put``
of the leaf onto its ``NamedSharding`` holds it on the rank's device.
"""

from __future__ import annotations

import json
import pathlib
import threading
from typing import Any

import numpy as np
import torch

from ..parallel.sharding import shard_slices


def flatten(tree, prefix: str = "") -> dict[str, Any]:
    """``{"a/b": leaf}`` for a nested dict, keys in sorted order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat = {}
    for k in sorted(tree):
        flat.update(flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflatten_like(tree_like, flat: dict[str, Any], prefix: str = ""):
    if not isinstance(tree_like, dict):
        return flat[prefix]
    return {k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix else str(k))
            for k, v in tree_like.items()}


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy on the host that later in-place updates of ``t`` do not reach."""
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dtype, copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()
        host = {k: _to_host(v) for k, v in flatten(tree).items()}

        def write():
            try:
                out = self.dir / f"step_{step:08d}"
                out.mkdir(parents=True, exist_ok=True)
                for k, v in host.items():
                    np.save(out / (k.replace("/", "__") + ".npy"), v)
                meta = {
                    "step": step,
                    "keys": sorted(host),
                    "shapes": {k: list(v.shape) for k, v in host.items()},
                    "dtypes": {k: str(v.dtype) for k, v in host.items()},
                }
                # the commit marker: a crash mid-write never leaves a
                # truncated meta.json that makes a partial save look committed
                tmp = out / "meta.json.tmp"
                tmp.write_text(json.dumps(meta))
                tmp.replace(out / "meta.json")
                self._gc()
            except Exception as e:          # handed to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def _gc(self) -> None:
        for s in self.steps()[: -self.keep]:
            d = self.dir / f"step_{s:08d}"
            for f in d.iterdir():
                f.unlink()
            d.rmdir()

    # -- restore -------------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted(int(d.name.split("_")[1]) for d in self.dir.glob("step_*")
                      if (d / "meta.json").exists())

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, tree_like: Any, device=None, shardings: Any = None) -> Any:
        """A tree like ``tree_like`` read from the save at ``step``.  Its
        leaves are tensors or anything else with a ``shape`` and a ``dtype``
        (a ``ParamSpec``): each leaf is read in its target's type.  A leaf
        with a ``Placement`` in ``shardings`` (a tree like ``tree_like``)
        comes back as this rank's block under it, onto ``device`` or else
        the placement mesh's device; any other leaf whole, onto ``device``
        or else its target tensor's.  Only the target's keys are read: a
        missing one raises ``KeyError``, a shape other than the target's
        ``ValueError``."""
        src = self.dir / f"step_{step:08d}"
        meta = json.loads((src / "meta.json").read_text())
        flat_like = flatten(tree_like)
        missing = set(flat_like) - set(meta["keys"])
        if missing:
            raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
        flat_sh = flatten(shardings) if shardings is not None else {}
        loaded = {}
        for k, like in flat_like.items():
            arr = np.load(src / (k.replace("/", "__") + ".npy"))
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"checkpoint leaf {k} of shape {arr.shape}, expected {tuple(like.shape)}")
            place = flat_sh.get(k)
            if place is None:
                where = device if device is not None else like.device
            else:
                arr = np.array(arr[shard_slices(place.pspec, arr.shape, place.mesh)])
                where = device if device is not None else place.mesh.device_type
            loaded[k] = torch.from_numpy(arr).to(where, like.dtype)
        return _unflatten_like(tree_like, loaded)
