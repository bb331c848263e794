"""PyTorch/CUDA port of the ``repro`` package.

Same sub-package names as the reference so a reader finds the counterpart
of a module (``repro_torch/models/layers.py`` ports
``repro/models/layers.py``).  The port imports ``torch`` and numpy only;
it never imports ``jax`` or anything of ``repro``.
"""
