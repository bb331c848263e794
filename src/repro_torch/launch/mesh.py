"""Meshes — port of ``repro/launch/mesh.py`` (``make_production_mesh``,
``make_smoke_mesh``) and of the ``jax.make_mesh`` they call (``make_mesh``).

Each builds a ``DeviceMesh`` through ``init_device_mesh``, with the
reference's axis names and shapes.  They are functions, so that importing
this module touches no device and no process group.  The caller first
initialises the default process group of ``prod(shape)`` ranks
(``torch.distributed.init_process_group`` with its address, world size and
rank: nothing on the machine announces a cluster); global rank r sits at the
row-major coordinate of r in ``shape``.  The device type is ``"cuda"``
unless the caller asks for ``"cpu"``.  Axes map onto the UB-Mesh hierarchy:
"model" = intra-rack 2D-FullMesh (high-bandwidth TP/SP domain), "data" =
inter-rack 2D-FullMesh, "pod" = HRS Clos tier.

``fake_mesh`` builds a mesh of any size in one process, for the dry-run
(``launch/dryrun.py``, ``train_step.lower_bundle``): the default process
group is PyTorch's fake one (``dist.init_process_group("fake",
world_size=prod(shape), store=FakeStore())``) with this process as rank 0,
so every collective is taken and nothing moves.  The reference builds its
production meshes from 512 host devices (``XLA_FLAGS``) for the same purpose.
"""

from __future__ import annotations

import contextlib
import math


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], *, device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def production_shape(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The production mesh's shape and axis names."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    return make_mesh(*production_shape(multi_pod), device_type=device_type)


def make_smoke_mesh(data: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """Tiny mesh for tests (needs ``data * model`` ranks)."""
    return make_mesh((data, model), ("data", "model"), device_type=device_type)


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...]):
    """A mesh of ``prod(shape)`` ranks over a fake process group, this
    process as rank 0; the group is destroyed on exit.  Raises if a default
    process group exists already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh needs a process without a default process group")
    dist.init_process_group("fake", rank=0, world_size=math.prod(shape), store=FakeStore())
    try:
        yield make_mesh(shape, axis_names, device_type="cpu")
    finally:
        dist.destroy_process_group()

