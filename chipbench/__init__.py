"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``) on one
NVIDIA H100: ``run.py`` runs one cell of ``BENCHMARK.json``."""
