"""Build and load the port's CUDA sources (nvcc -> shared library -> ctypes),
and the checks and launch helper every kernel wrapper shares.

Each source ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` at its first use in a process, into
``navierstokessolver_tpu_torch/_build/lib<name>_<hash>.so``, where the hash
covers the source, the headers beside it (``csrc/*.cuh``) and the flags, so
an edited source rebuilds and an unchanged one is loaded as it is.
:func:`load_all` starts one nvcc per source, all together. A failed build
raises with nvcc's stderr; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

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


def _so_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    data = src.read_bytes()
    for hdr in sorted(SRC_DIR.glob("*.cuh")):
        data += hdr.read_bytes()
    digest = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def load_all(names: Sequence[str]) -> None:
    """Build every named source that has no library yet, all nvcc runs
    started together, then load each. Fills :data:`BUILD_INFO` (the
    seconds are each build's own wall time)."""
    jobs = []   # (name, library, temp output, nvcc process or None, start)
    try:
        for name in names:
            if name in _LIBS:
                continue
            so = _so_path(name)
            if so.exists():
                jobs.append((name, so, None, None, 0.0))
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(SRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            jobs.append((name, so, tmp, proc, time.perf_counter()))
        for name, so, tmp, proc, t0 in jobs:
            seconds, log = 0.0, ""
            if proc is not None:
                _, log = proc.communicate()
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"nvcc failed to build {name}.cu (exit "
                        f"{proc.returncode}):\n{log}"
                    )
                os.replace(tmp, so)
            _LIBS[name] = ctypes.CDLL(str(so))
            BUILD_INFO[name] = (seconds, log)
    finally:
        for _, _, tmp, proc, _ in jobs:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        load_all([name])
    return _LIBS[name]


def bind(lib: ctypes.CDLL, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """``lib.fn`` with its argument types declared and an int return (the
    CUDA error code of the launch)."""
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def call(lib: str, fn: str, argtypes: list, *args) -> int:
    """The int that host function ``fn`` of ``csrc/<lib>.cu`` returns."""
    return bind(load(lib), fn, argtypes)(*args)


# -- what every wrapper shares -------------------------------------------------

F, I, P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p


def check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` and ``dtype``
    on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def cuda_or_raise(device: torch.device, wrapper: str) -> None:
    if device.type != "cuda":
        raise ValueError(
            f"{wrapper}: tensors on {device}; the kernel runs on CUDA "
            "devices and the plain version on the CPU"
        )


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def f32(x: float) -> float:
    """``x`` rounded to float32, as the JAX kernels see a Python scalar."""
    return float(np.float32(x))


_BOUND: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def launch(lib: str, fn: str, argtypes: list, device: torch.device,
           *args) -> None:
    """Call ``fn`` of ``csrc/<lib>.cu`` with ``device`` current and
    PyTorch's current stream on it as the last argument; raise if the
    launch failed. Each function is bound once (a wrapper passes the same
    ``argtypes`` on every call)."""
    f = _BOUND.get((lib, fn))
    if f is None:
        f = _BOUND[(lib, fn)] = bind(load(lib), fn, argtypes)
    with torch.cuda.device(device):
        err = f(*args, ctypes.c_void_p(
            torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed, CUDA error {err}")
