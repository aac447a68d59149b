"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, `build/masg_tpu_torch/lib<name>-<hash>.so`
under the repository root, and loaded with `ctypes`. The hash covers the
source and the flags, so an edited source builds anew. Builds start at
first use (or all at once, in parallel, through `build()`), never at import.

There is no fallback: without `nvcc` or a card, `load` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "masg_tpu_torch"
KERNELS = ("flash_fwd", "flash_bwd", "fused_mrf")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
PTXAS_LOG: Dict[str, str] = {}  # name -> `-Xptxas -v` report of the last build


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else $CUDA_HOME/bin/nvcc."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels cannot "
        "be built here; CPU tensors take the plain PyTorch path instead")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names: Iterable[str] = KERNELS) -> List[Path]:
    """Compile every named kernel that is not built yet, all `nvcc`s at once.

    Returns the library paths; raises RuntimeError with the compiler's output
    if any build fails.
    """
    names = list(names)
    for n in names:
        if n not in KERNELS:
            raise ValueError(f"unknown kernel {n!r}; known: {KERNELS}")
    paths = [_lib_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if not p.exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n, p in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs.append((n, p, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for n, p, tmp, proc in procs:
        out, _ = proc.communicate()
        PTXAS_LOG[n] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, p)  # atomic: a concurrent build sees a whole file or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        (path,) = build([name])
        lib = ctypes.CDLL(str(path))
        _declare(name, lib)
        _LIBS[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "flash_fwd":
        fns = [(lib.masg_flash_fwd,
                # q, k, v, lens, o, lse, bh, heads, t, dh, dtype, stream
                [p, p, p, p, p, p, i, i, i, i, i, p])]
    elif name == "flash_bwd":
        fns = [(lib.masg_flash_bwd_dq,
                # q, k, v, do, lse, delta, lens, dq, bh, heads, t, dh, dtype, stream
                [p, p, p, p, p, p, p, p, i, i, i, i, i, p]),
               (lib.masg_flash_bwd_dkv,
                # q, k, v, do, lse, delta, lens, dk, dv, bh, heads, t, dh, dtype, stream
                [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p])]
    else:
        fns = [(lib.masg_fused_mrf,
                # x, out, w, b, t, c, dtype, n_res, n_dil, ks, dils, stream
                [p, p, p, i, i, i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(i), p])]
    for fn, argtypes in fns:
        fn.argtypes = argtypes
        fn.restype = i


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a nonzero cudaError_t."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {code}")
