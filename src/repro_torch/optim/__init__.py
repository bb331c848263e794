"""Optimizer and gradient compression — port of ``repro/optim/``:
``adamw`` (AdamW with fp32 masters and moments) and ``compression``
(bf16 / int8 gradient payloads with error feedback, the int8 payload
reduced through the ``ccu_reduce`` kernel)."""
