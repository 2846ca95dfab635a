"""The port's native (C++) snapshot codec: the binary VTK writer.

``csrc/snapshot_codec.cpp`` is compiled with ``g++`` at its first use in a
process, into ``navierstokessolver_tpu_torch/_build/
libsnapshot_codec_<hash>.so`` (the hash covers the source and the flags,
as ``ops/_native.py`` names the CUDA builds), and loaded with ctypes. A
failed build raises with the compiler's message; nothing falls back to the
ASCII writer (``io.write_vtk_ascii`` is the codec's plain version, which
callers choose by name).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "csrc" / "snapshot_codec.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _so_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsnapshot_codec_{digest[:16]}.so"


def _build(so: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on $PATH: the snapshot codec "
                           f"({SRC.name}) cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)


def get_lib() -> ctypes.CDLL:
    """The codec library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = _so_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.write_vtk_binary.restype = ctypes.c_int
            lib.write_vtk_binary.argtypes = [
                ctypes.c_char_p,                      # path
                ctypes.POINTER(ctypes.c_int),         # dims[3]
                ctypes.POINTER(ctypes.c_double),      # spacing[3]
                ctypes.c_int,                         # n_vec
                ctypes.POINTER(ctypes.c_void_p),      # vec ptrs
                ctypes.c_int,                         # n_scalars
                ctypes.c_char_p,                      # scalar names
                ctypes.POINTER(ctypes.c_void_p),      # scalar ptrs
                ctypes.c_char_p,                      # title
            ]
            _lib = lib
        return _lib


def write_vtk_binary(path: str, dims: Sequence[int],
                     spacing: Sequence[float],
                     vec_comps: Sequence[np.ndarray],
                     scalars: Mapping[str, np.ndarray], title: str) -> None:
    """Write a binary legacy VTK file; raise if the codec reports an error.

    ``vec_comps``: the velocity components, C-order float32 arrays of
    shape ``dims`` (2 or 3 of them); ``scalars``: name -> such an array."""
    lib = get_lib()
    dims3 = (ctypes.c_int * 3)(*(list(dims) + [1] * (3 - len(dims))))
    sp3 = (ctypes.c_double * 3)(*(list(spacing)
                                  + [1.0] * (3 - len(spacing))))
    vecs = [np.ascontiguousarray(v, dtype=np.float32) for v in vec_comps]
    vec_ptrs = (ctypes.c_void_p * max(1, len(vecs)))(
        *[v.ctypes.data_as(ctypes.c_void_p) for v in vecs] or [None])
    scal = {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in scalars.items()}
    names = "\n".join(scal).encode()
    scal_ptrs = (ctypes.c_void_p * max(1, len(scal)))(
        *[v.ctypes.data_as(ctypes.c_void_p) for v in scal.values()] or [None])
    rc = lib.write_vtk_binary(path.encode(), dims3, sp3, len(vecs), vec_ptrs,
                              len(scal), names, scal_ptrs, title.encode())
    if rc != 0:
        raise OSError(f"write_vtk_binary({path!r}) failed with code {rc}")
