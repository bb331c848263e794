"""Builds and loads the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into a shared library of its own, at first use, from the
sources in the repository and nothing else; ``ctypes`` loads it.  Libraries go
to ``build/repro_torch/`` at the root of the checkout, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
reused.  ``build`` starts one ``nvcc`` per
source, all together.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels are compiled at first use and need the CUDA toolkit"
    )


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, build_dir() / f"{name}-{digest[:16]}.so"


def build(names: list[str]) -> dict[str, Path]:
    """Compile the named sources that are not built yet, in parallel.
    Returns the library path of each; the compiler's log (registers, shared
    memory, spills of every kernel) is kept beside it as ``<library>.log``."""
    out, running = {}, []
    for name in names:
        src, lib = _target(name)
        out[name] = lib
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, lib, tmp, cmd, proc))
    failures = []
    for name, lib, tmp, cmd, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\nexit code {proc.returncode}\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)    # atomic: a concurrent process sees all or nothing
    if failures:
        raise RuntimeError("building a CUDA kernel failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]
