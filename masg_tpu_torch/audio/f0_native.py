"""ctypes binding of the native C++ DIO + StoneMask (port of
masg_tpu/audio/f0_native.py).

`native/f0.cpp` (a copy of masg_tpu's) is compiled with g++ at first use into
`build/masg_tpu_torch/libmasgf0-<hash>.so` under the repository root, never
into the source tree and never at import; the hash covers the source and the
flags. A failed build raises: the port does not fall back to the numpy DIO.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "f0.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "masg_tpu_torch"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def _lib_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmasgf0-{key}.so"


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _lib_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build beside the target and rename: a reader sees a whole file or none
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            r = subprocess.run(["g++", *FLAGS, str(SRC), "-o", tmp], capture_output=True,
                               text=True)
            if r.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"building the native F0 extension failed:\n{r.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name in ("dio_stonemask", "dio_only"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                           ctypes.c_double, ctypes.POINTER(ctypes.c_double), ctypes.c_int]
        _lib = lib
        return lib


def _run(name: str, x: np.ndarray, fs: int, frame_period_ms: float) -> np.ndarray:
    fn = getattr(_load(), name)
    x = np.ascontiguousarray(x, dtype=np.float64)
    n_frames = int(len(x) / fs * 1000.0 / frame_period_ms) + 1
    out = np.zeros(n_frames, np.float64)
    written = fn(x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(x), fs,
                 frame_period_ms, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                 n_frames)
    if written < 0:
        raise RuntimeError(f"native {name} failed")
    return out[:written]


def dio_stonemask_native(x: np.ndarray, fs: int,
                         frame_period_ms: float = 256 / 22050 * 1000) -> np.ndarray:
    """DIO + two StoneMask passes through the C++ extension."""
    return _run("dio_stonemask", x, fs, frame_period_ms)


def dio_native(x: np.ndarray, fs: int, frame_period_ms: float = 256 / 22050 * 1000) -> np.ndarray:
    """DIO alone through the C++ extension."""
    return _run("dio_only", x, fs, frame_period_ms)
