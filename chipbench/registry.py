"""Finds a piece of the benchmark by name: ``module(folder, name)`` loads
``chipbench/<folder>/<name>.py``.  The folders:

- ``kinds/<kind>.py``: how a traffic mix of that ``kind`` drives the
  program, and how its output is checked (``window``, ``trace_context``,
  ``check``, ``control``, ``FAULTS``);
- ``models/<family>.py``: a configuration family's weight layout
  (``leaf_specs``) and its plain reference (``Reference``);
- ``programs/<family>.py``: the program's model of that family built from a
  configuration file (``harness``);
- ``end_to_end/<metric>.py``, ``metrics/<metric>.py``: each metric's reader
  (``read``).

A later cell adds a file here and an entry in ``BENCHMARK.json``; no file
that is already there changes.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def module(folder: str, name: str, root: Path = HERE):
    path = root / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"chipbench: no {folder}/{name}.py for {name!r}")
    key = f"chipbench.{folder}.{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules and getattr(sys.modules[key], "__file__", None) == str(path):
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def family(cfg: dict):
    """The configuration's family in ``models/`` (reference side)."""
    return module("models", cfg["family"])


def kind(mix: dict):
    return module("kinds", mix["kind"])
