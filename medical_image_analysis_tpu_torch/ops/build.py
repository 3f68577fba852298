"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` file has a plain C interface. It is compiled for
``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` under the repository
root at its first use in a process, and loaded with :mod:`ctypes`. The
hash covers the source and the compiler flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, tuple[ctypes.CDLL, str]] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built on a machine with the CUDA toolkit"
        )
    return found


def load_library(name: str) -> tuple[ctypes.CDLL, str]:
    """Return ``(library, build_log)`` for ``csrc/<name>.cu``.

    ``build_log`` is nvcc's output (ptxas register and shared-memory
    counts) when this call compiled the library, else "cached".
    """
    with _lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        log = "cached"
        if not out.exists():
            # Build beside the target and rename, so that processes
            # building at once never load a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                    capture_output=True, text=True, timeout=600,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {src} ({proc.returncode}):\n"
                        f"{proc.stdout}\n{proc.stderr}"
                    )
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            log = proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(out))
        _loaded[name] = (lib, log)
        return lib, log
