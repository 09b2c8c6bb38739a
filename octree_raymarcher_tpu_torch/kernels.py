"""Build and bind the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, on first CUDA use, under
``build/torch_kernels/`` beside the package.  One ``nvcc -c`` per source
runs in parallel, then one link.  The library is loaded with ``ctypes``:
tensors go in as ``data_ptr()`` pointers, the launch goes on PyTorch's current
stream, and each C entry returns ``cudaGetLastError()``, which the wrapper
turns into an exception.  Importing this module builds nothing.

Flags: ``-O3 -fmad=false`` and no fast math, so each kernel rounds every
``a + b*c`` twice, as the eager PyTorch plain versions do; the kernels then
agree with their plain versions bit for bit wherever no libm call is
involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

# C signature of every entry point: (argtypes), all return int (a cudaError_t).
_WORLD = [_P] * 7 + [_F, _I, _I, _I, _I, _I64, _I64]   # csrc/march_step.cuh world_args
SIGNATURES = {
    "ort_march": _WORLD + [_P] * 5 + [_I64, _I, _I, _I, _I, _I] + [_P] * 7 + [_P],
    "ort_march_depth": _WORLD + [_P, _P, _I64, _I, _I, _P, _P] + [_P],
    "ort_shade": [_P] * 9 + [_P, _I, _I, _P, _F] + [_P, _I, _P, _P, _P]
                 + [_P, _I, _I, _P, _P, _I, _I, _F, _I64] + [_P] * 4 + [_P] + [_P],
    "ort_shade_bwd": [_P] * 9 + [_P, _I, _I, _P, _F] + [_P, _I, _P, _P, _P]
                     + [_P, _I, _I, _P, _I, _I, _F, _I64] + [_P] * 11 + [_P],
    "ort_ray_prep": [_P] * 8 + [_F, _F, _F, _I64] + [_P] * 3 + [_P],
    "ort_shadow_resolve": [_P] * 5 + [_I64, _P] + [_P],
    "ort_map_project": [_P] * 6 + [_I, _I, _P, _F, _I64, _P] + [_P],
    "ort_segments": _WORLD + [_P, _P, _I64] + [_I] * 9 + [_P] * 4 + [_P],
    "ort_composite_fwd": [_P] * 6 + [_I, _F, _I64, _I, _I64, _I] + [_P] * 4 + [_P],
    "ort_composite_bwd": [_P] * 6 + [_I, _F, _I64, _I, _I64, _I, _I64] + [_P] * 8 + [_P],
    "ort_patch": [_P] * 8 + [_I, _I] + [_P],
}

_lock = threading.Lock()
_lib = None


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libort_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu (one nvcc per source, all at once) and link them
    into one shared library; returns its path.  Cached by content."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tool = nvcc()
    objs, procs = [], []
    for src in cu:
        obj = so.with_name(f"{so.stem}.{src.stem}.o")
        log = obj.with_suffix(".log").open("w")
        procs.append((src, log, subprocess.Popen(
            [tool, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=log, stderr=subprocess.STDOUT)))
        objs.append(obj)
    failed = []
    for src, log, proc in procs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log()}")
    tmp = so.with_suffix(".tmp.so")
    link = subprocess.run([tool, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, so)
    return so


def build_log() -> str:
    """The compiler's output (ptxas register and spill report) of the
    current build."""
    so = library_path()
    logs = sorted(so.parent.glob(f"{so.stem}.*.log"))
    return "".join(f"== {p.name}\n{p.read_text()}" for p in logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the CUDA kernels need a CUDA device")
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ort_error_string.argtypes = [ctypes.c_int]
            lib.ort_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def ptr(t) -> int | None:
    """A tensor's device pointer for ctypes (None for an absent input)."""
    return None if t is None else t.data_ptr()


def c_floats(values):
    """Host floats as a ctypes float array: a pointer argument whose values
    the C entry copies into the kernel's parameters."""
    vals = [float(v) for v in values]
    return (ctypes.c_float * len(vals))(*vals)


class Kernel:
    """One C entry point of the library, with a count of its launches."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0

    def __call__(self, *args) -> None:
        lib = library()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, self.symbol)(*args, stream)
        if err != 0:
            msg = lib.ort_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


__all__ = ["Kernel", "c_floats", "build", "build_log", "library", "library_path", "nvcc", "ptr"]
