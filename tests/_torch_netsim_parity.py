"""Shared helpers of the cross-package tests of the network layers: the port's
copies of ``core/`` and ``netsim/`` held against the reference's by ``==``.

Each side's objects are built from its own package (their caches, enums and
weakref-keyed structures are per package), so a test never hands an object
of one package to the other; ``plain`` turns either side's result into the
same tree of built-in values, which is then compared exactly.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import math

import numpy as np


def pkgs(module: str):
    """``(reference, port)`` copies of ``module`` (a path under the package,
    e.g. ``"core.topology"``)."""
    return (importlib.import_module(f"repro.{module}"),
            importlib.import_module(f"repro_torch.{module}"))


def plain(x):
    """``x`` as built-in values: dataclasses and named tuples by their class
    name and fields, enums by their value, arrays by dtype, shape and
    values, NaN as the string ``"nan"`` (so that ``==`` holds it equal).
    Anything else that is not a built-in value raises, so that a
    comparison never passes on two opaque objects."""
    if isinstance(x, enum.Enum):
        return ("enum", type(x).__name__, x.value)
    if isinstance(x, bool) or x is None or isinstance(x, (int, str, bytes)):
        return x
    if isinstance(x, float):
        return "nan" if math.isnan(x) else x
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, plain(x.tolist()))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, plain(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__, tuple(plain(v) for v in x))
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return frozenset(plain(v) for v in x)
    raise TypeError(f"no plain form for {type(x).__name__}")


def outcome(fn, *args, **kwargs):
    """``plain`` of what ``fn`` returns, or the type name, message and
    arguments of what it raises."""
    try:
        return ("ok", plain(fn(*args, **kwargs)))
    except Exception as e:          # noqa: BLE001 - compared, not handled
        return ("raised", type(e).__name__, str(e), plain(e.args))


def both(modules: str, fn):
    """``plain(fn(*modules))`` with each package's copies of ``modules`` (a
    space-separated list of paths under the package): the two equal, or the
    test fails; returns the value."""
    sides = zip(*(pkgs(m) for m in modules.split()))
    ref, port = (outcome(fn, *mods) for mods in sides)
    assert ref[0] == "ok", ref
    assert ref == port
    return ref[1]
