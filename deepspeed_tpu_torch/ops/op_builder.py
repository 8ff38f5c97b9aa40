"""Builds the port's CUDA kernels from the sources in the checkout.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface; it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Libraries land in ``build/torch_kernels/`` at the checkout root, named by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an unchanged source is built once.
A failed build raises with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNEL_SOURCES = ("paged_attention", "flash_attention", "fused_adamw",
                  "block_sparse_attention", "fused_lion", "quantize",
                  "fp6_linear", "ring_attention", "ring_attention_int8",
                  "gather_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    sources = [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in sources)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` (``None`` if its library is already built);
    returns ``(process, temporary output path)``."""
    out = library_path(name)
    if out.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), tmp


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> None:
    """Build every listed kernel source, one nvcc each, all started at
    once; raise with nvcc's output if any fails."""
    with _LOCK:
        started = {n: _start(n) for n in names}
        errors = []
        for name, job in started.items():
            if job is None:
                continue
            proc, tmp = job
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"nvcc failed building {name}.cu (exit "
                              f"{proc.returncode}):\n{stdout}{stderr}")
                continue
            out = library_path(name)
            # ptxas -v report (registers, shared memory, spills)
            out.with_suffix(".log").write_text(stdout + stderr)
            os.replace(tmp, out)  # atomic: a reader never sees half a file
        if errors:
            raise RuntimeError("\n".join(errors))


def build_log(name: str) -> str:
    """ptxas's report for the built library (empty if none was kept)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(library_path(name)))
        return _LOADED[name]
