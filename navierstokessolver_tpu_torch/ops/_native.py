"""Build and load the port's CUDA sources (nvcc -> shared library -> ctypes).

Each source ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` at its first use in a process, into
``navierstokessolver_tpu_torch/_build/lib<name>_<hash>.so``, where the hash
covers the source and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is. A failed build raises with nvcc's stderr;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> (seconds spent building, 0.0 when a cached library was loaded,
#          nvcc's stderr: ptxas register and spill report)
BUILD_INFO: dict[str, tuple[float, str]] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and $PATH): the CUDA kernels cannot be built"
        )
    return found


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{digest}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stderr}"
            )
        os.replace(tmp, so)
        log = proc.stderr
    lib = ctypes.CDLL(str(so))
    BUILD_INFO[name] = (seconds, log)
    _LIBS[name] = lib
    return lib


def bind(lib: ctypes.CDLL, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """``lib.fn`` with its argument types declared and an int return (the
    CUDA error code of the launch)."""
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f
