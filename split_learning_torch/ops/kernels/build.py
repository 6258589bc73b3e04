"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  The build happens at first use, from the
sources in the checkout, into ``build/torch_kernels/`` at the repository
root; the library's file name carries a hash of the source and the
flags, so an edited kernel is rebuilt and a current one is reused.

Nothing here runs when the module is imported: hosts without ``nvcc``
(the CPU test hosts) import it freely and never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
#: seconds spent compiling each source in this process (0.0 when the
#: library was already built)
BUILD_SECONDS: dict[str, float] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or ``nvcc``
    on ``PATH``; raises when none exists."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH); the "
                           "CUDA kernels are built from csrc/ at first use")
    return found


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/{name}.cu`` unless its hashed library exists.
    The compiler's resource report (``-Xptxas -v``) is kept beside the
    library as ``{lib}.log``."""
    out = library_path(name)
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/{name}.cu``, built on first use."""
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(build(name)))
        return _LOADED[name]
