"""whisper-base [audio]: 6L d_model=512 8H d_ff=2048 vocab=51865 — enc-dec,
conv frontend STUB (precomputed frame embeddings; 1500 frames padded to 1536
for even sharding) [arXiv:2212.04356; unverified].

Port of ``repro/configs/whisper_base.py``: the same numbers."""

from repro_torch.models.api import EncDecHarness
from repro_torch.models.encdec import EncDecConfig


def get_harness(smoke: bool = False) -> EncDecHarness:
    if smoke:
        cfg = EncDecConfig(
            name="whisper-smoke", n_layers=2, d_model=64, n_heads=2,
            n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=384, n_frames=24,
        )
    else:
        cfg = EncDecConfig(
            name="whisper-base", n_layers=6, d_model=512, n_heads=8,
            n_kv_heads=8, head_dim=64, d_ff=2048, vocab_size=51865,
            n_frames=1536,
        )
    return EncDecHarness("whisper-base", cfg)
