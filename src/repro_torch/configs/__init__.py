"""Architecture registry — port of ``repro/configs/__init__.py``.

``load(arch_id, smoke=False)`` returns the Harness; ``ARCH_IDS`` lists all
ten assigned architectures, in the reference's order.  ``PORT_ONLY`` lists
the architectures the port has and the reference has not
(granite-4.0-h-small); ``load`` takes them too.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "granite_8b",
    "phi4_mini_3_8b",
    "granite_3_2b",
    "starcoder2_7b",
    "zamba2_1_2b",
    "rwkv6_1_6b",
    "mixtral_8x22b",
    "dbrx_132b",
    "whisper_base",
    "paligemma_3b",
]

PORT_ONLY = ["granite_4_0_h_small"]

# pool ids use dashes
CANONICAL = {a.replace("_", "-"): a for a in ARCH_IDS}


def load(arch_id: str, smoke: bool = False):
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS + PORT_ONLY:
        raise ValueError(f"unknown arch {arch_id!r}; known: {sorted(CANONICAL)} and {PORT_ONLY}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.get_harness(smoke=smoke)
