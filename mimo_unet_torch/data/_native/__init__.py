"""ctypes bindings for the native batch-assembly kernels (``gather.cc``).

Counterpart of ``mimo_unet_tpu/data/_native/__init__.py``, copied: the
host batch-slicing memcpy is the host-fed pipeline's hot path, and numpy
does it on one thread.  ``gather.cc`` compiles with g++ at first use into
``mimo_unet_torch/_build/native-<hash>/`` (git-ignored; the hash is of the
source and the command, so an edited source rebuilds), with an atomic
rename so that processes building at once do not collide.

Which path served each gather is counted (``counts``): a gather the
library did is ``(name, "native")``; one it declined, so that the caller
indexed with numpy, is ``(name, "numpy")``.  The library declines on a
host with one core (numpy is at parity there), on an array that is not
C-contiguous, and where it could not be built; the last also warns once,
with the compiler's message (``build_error``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "gather.cc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
_CMD = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None
_tried = False
build_error: Optional[str] = None

DEFAULT_THREADS = min(os.cpu_count() or 1, 16)

# (function name, "native" | "numpy") -> gathers served that way
counts: "collections.Counter[tuple]" = collections.Counter()


def reset_counts() -> None:
    with _lock:
        counts.clear()


def _count(name: str, path: str) -> None:
    with _lock:
        counts[(name, path)] += 1


def library_path() -> Path:
    """Where this source and command build to."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_CMD).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"native-{digest}" / "libmimo_gather.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(_CMD + ["-o", tmp, str(_SRC)], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """The loaded native library, or None if it cannot be built or loaded
    (``build_error`` says why; a warning says so once)."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        try:
            if not path.exists():
                _build(path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:  # built elsewhere, against another C library
                _build(path)
                lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None) or repr(e)
            build_error = f"{type(e).__name__}: {detail}"
            warnings.warn(f"native gather unavailable, batches are gathered with "
                          f"numpy: {build_error}", RuntimeWarning, stacklevel=2)
            return None
        lib.mimo_gather_rows.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ]
        lib.mimo_gather_patches.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _i64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _char_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_char_p)


def gather_rows(
    src: np.ndarray, idx: np.ndarray, num_threads: int = DEFAULT_THREADS
) -> Optional[np.ndarray]:
    """dst[i] = src[idx[i]] with a thread pool.  None -> caller falls back
    to numpy (counted as such).

    Only worthwhile with real parallelism: on a single-core host numpy's
    fancy indexing is at parity or better, so it declines there.
    """
    if not src.flags.c_contiguous or num_threads <= 1 or get_lib() is None:
        _count("gather_rows", "numpy")
        return None
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    n = idx.shape[0]
    row_bytes = int(src.dtype.itemsize * np.prod(src.shape[1:], dtype=np.int64))
    dst = np.empty((n,) + src.shape[1:], dtype=src.dtype)
    _lib.mimo_gather_rows(
        _char_ptr(src), _i64_ptr(idx), _char_ptr(dst),
        ctypes.c_int64(n), ctypes.c_int64(row_bytes), ctypes.c_int(num_threads),
    )
    _count("gather_rows", "native")
    return dst


def gather_patches(
    tiles: np.ndarray,
    tile_idx: np.ndarray,
    ys: np.ndarray,
    xs: np.ndarray,
    ph: int,
    pw: int,
    num_threads: int = DEFAULT_THREADS,
) -> Optional[np.ndarray]:
    """dst[i] = tiles[tile_idx[i], ys[i]:ys[i]+ph, xs[i]:xs[i]+pw, :]."""
    if not tiles.flags.c_contiguous or tiles.ndim != 4 or get_lib() is None:
        _count("gather_patches", "numpy")
        return None
    t, th, tw, c = tiles.shape
    tile_idx = np.ascontiguousarray(tile_idx, dtype=np.int64)
    ys = np.ascontiguousarray(ys, dtype=np.int64)
    xs = np.ascontiguousarray(xs, dtype=np.int64)
    n = tile_idx.shape[0]
    dst = np.empty((n, ph, pw, c), dtype=tiles.dtype)
    _lib.mimo_gather_patches(
        _char_ptr(tiles), ctypes.c_int64(th), ctypes.c_int64(tw),
        ctypes.c_int64(c), ctypes.c_int64(tiles.dtype.itemsize),
        _i64_ptr(tile_idx), _i64_ptr(ys), _i64_ptr(xs), ctypes.c_int64(n),
        ctypes.c_int64(ph), ctypes.c_int64(pw), _char_ptr(dst),
        ctypes.c_int(num_threads),
    )
    _count("gather_patches", "native")
    return dst
