"""ctypes bridge to the native runtime: the C++ free list and scalar marcher.

PyTorch counterpart of octree_raymarcher_tpu/utils/native.py.  The library
is built here from the repository's C++ sources, ``native/src/freelist.cpp``
and ``native/src/marcher.cpp``, with g++ and native/Makefile's flags, on
first use, into ``build/torch_native/`` beside the package (named by a hash
of the sources and flags, written to a temporary file and moved into place,
so concurrent first users agree).  Nothing under ``native/`` is written, and
a library built there is not loaded.

* :class:`NativeFreeList`: the C++ twin of world/alloc.py ``FreeList``.
* :func:`native_march`: the C++ scalar marcher (OpenMP across rays) over a
  world's pools copied to the host: a CPU oracle of the march, not a card
  path.

When g++ is missing or the build fails, :func:`load` returns None and
:func:`available` is False; callers fall back to the Python versions.
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

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent.parent
SOURCES = [REPO / "native" / "src" / "freelist.cpp", REPO / "native" / "src" / "marcher.cpp"]
BUILD_DIR = REPO / "build" / "torch_native"
# native/Makefile: CXXFLAGS and LDFLAGS
CXXFLAGS = ["-O3", "-march=native", "-std=c++20", "-fPIC", "-Wall", "-Wextra", "-Werror",
            "-fopenmp"]
LDFLAGS = ["-shared", "-fopenmp"]

_lock = threading.Lock()
_LIB = None
_TRIED = False


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"liboctnative_{h.hexdigest()[:16]}.so"


def build() -> Path | None:
    """Compile the sources with g++ (cached by content); None when g++ is
    missing or the compile fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXXFLAGS, *map(str, SOURCES), *LDFLAGS, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        return None
    os.replace(tmp, so)
    return so


def load():
    """The loaded library (built on first use), or None."""
    global _LIB, _TRIED
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.fl_create.restype = vp
        lib.fl_create.argtypes = [i64]
        lib.fl_destroy.argtypes = [vp]
        lib.fl_take.restype = i64
        lib.fl_take.argtypes = [vp, i64]
        lib.fl_give.argtypes = [vp, i64, i64]
        lib.fl_extend.argtypes = [vp, i64]
        for name in ("fl_capacity", "fl_free_total", "fl_num_spans"):
            getattr(lib, name).restype = i64
            getattr(lib, name).argtypes = [vp]
        lib.fl_spans.restype = i64
        lib.fl_spans.argtypes = [vp, ctypes.POINTER(i64), ctypes.POINTER(i64), i64]
        lib.march_rays.restype = ctypes.c_int
        lib.march_rays.argtypes = (
            [vp] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            + [vp, vp, i64, ctypes.c_int] + [vp] * 6)
        _LIB = lib
        return _LIB


def available() -> bool:
    return load() is not None


class NativeFreeList:
    """The interface of world/alloc.py FreeList, backed by C++."""

    def __init__(self, capacity: int):
        lib = load()
        if lib is None:
            raise RuntimeError("the native library did not build (g++ and native/src needed)")
        self._lib = lib
        self._h = lib.fl_create(capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fl_destroy(self._h)
            self._h = None

    def take(self, size: int):
        off = self._lib.fl_take(self._h, size)
        return None if off < 0 else off

    def give(self, offset: int, size: int) -> None:
        self._lib.fl_give(self._h, offset, size)

    def extend(self, new_capacity: int) -> None:
        self._lib.fl_extend(self._h, new_capacity)

    @property
    def capacity(self) -> int:
        return self._lib.fl_capacity(self._h)

    @property
    def free(self) -> int:
        return self._lib.fl_free_total(self._h)

    @property
    def spans(self):
        n = self._lib.fl_num_spans(self._h)
        off = (ctypes.c_int64 * n)()
        sz = (ctypes.c_int64 * n)()
        m = self._lib.fl_spans(self._h, off, sz, n)
        return [[off[i], sz[i]] for i in range(m)]

    def check(self) -> None:
        """Sorted, non-overlapping and never adjacent spans (give coalesces)."""
        for a, b in zip(self.spans, self.spans[1:]):
            assert a[0] + a[1] < b[0], (a, b)


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype=dtype)


def _host_u32(x) -> np.ndarray:
    """A pool's 32-bit words as host uint32, bits unchanged (a TorchWorld
    holds them as int32, a PackedWorld as uint32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.ascontiguousarray(x)
    if x.dtype not in (np.int32, np.uint32):
        raise ValueError(f"a pool must hold 32-bit words, not {x.dtype}")
    return x.view(np.uint32)


def native_march(world, origins, dirs, max_steps: int = 640) -> dict:
    """March rays with the C++ scalar marcher over ``world``'s pools (a
    TorchWorld on any device, or a PackedWorld), copied to the host.
    Returns the MarchResult fields hit, t, material, cell_bmin, cell_size
    and steps as CPU tensors."""
    lib = load()
    if lib is None:
        raise RuntimeError("the native library did not build (g++ and native/src needed)")
    tree = _host_u32(world.tree)
    twig = _host_u32(world.twig)
    cbm = _host(world.chunk_bmin, np.float32)
    ctree = _host(world.chunk_tree, np.int32)
    ctwig = _host(world.chunk_twig, np.int32)
    ccm = _host(world.chunkcoordmin, np.float32)
    o = _host(origins, np.float32)
    d = _host(dirs, np.float32)
    if o.ndim != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"native_march takes origins and dirs f32[N, 3], got {o.shape}, "
                         f"{d.shape}")
    n = o.shape[0]
    w, h, dd = world.dims
    out = {"hit": np.zeros(n, np.uint8), "t": np.zeros(n, np.float32),
           "material": np.zeros(n, np.int32), "cell_bmin": np.zeros((n, 3), np.float32),
           "cell_size": np.zeros(n, np.float32), "steps": np.zeros(n, np.int32)}
    err = lib.march_rays(
        tree.ctypes.data, twig.ctypes.data, cbm.ctypes.data, ctree.ctypes.data,
        ctwig.ctypes.data, ccm.ctypes.data, float(world.chunksize), w, h, dd, world.depth,
        o.ctypes.data, d.ctypes.data, n, max_steps,
        *(out[k].ctypes.data for k in ("hit", "t", "material", "cell_bmin", "cell_size",
                                       "steps")))
    if err != 0:
        raise RuntimeError(f"native march_rays returned {err}")
    out["hit"] = out["hit"].astype(bool)
    return {k: torch.from_numpy(v) for k, v in out.items()}


__all__ = ["load", "available", "build", "library_path", "NativeFreeList", "native_march"]
