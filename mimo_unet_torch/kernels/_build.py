"""Build and load the hand-written CUDA kernels.

``mimo_unet_torch/csrc/*.cu`` compile at first use into one shared library
with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/<hash>/libmimo_unet_kernels.so csrc/*.cu

The build directory (``mimo_unet_torch/_build/``, git-ignored) is keyed by a
hash of the sources and the command, so an edited source rebuilds and an
unchanged one loads the existing library.  Nothing here runs at import: the
CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libmimo_unet_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# element offsets and sizes cross the C boundary as 64-bit ints: a B=128
# flagship in_conv output alone holds 352 M elements
_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    # x1, x2, w1, s1, sh1, w2, s2, sh2, wo, bo, out, hpool,
    # n, h, w, c1, c2, n2, x2_half_h, m, o, oc, groups, group_rows_out,
    # fixed_cin (0 = runtime channel count), stream
    "mimo_fused_double_conv": [_P] * 12 + [_I] * 13 + [_P],
    # x, out, rows, w, c, stream
    "mimo_pool_w": [_P, _P, _I, _I, _I, _P],
    # x, lo, w0, w1, out, rows, w2, c, stream
    "mimo_upsample_w2x": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran, if any


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from mimo_unet_torch/csrc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    global build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]
    # write to a temporary name, then rename: a concurrent loader never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp] + cu
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                           f"\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if this source tree has no build."""
    global _lib
    with _lock:
        if _lib is None:
            path = BUILD_DIR / _digest() / LIB_NAME
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mimo_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mimo_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, device, *args) -> None:
    """Call the library's entry ``name`` with ``args`` and the current
    stream of ``device``, with ``device`` current (the C side launches on
    the calling thread's current device).  Raises if the entry returned a
    CUDA error: cudaGetLastError after the launch, or a configuration it
    refused."""
    import torch

    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(*args, stream)
    if code != 0:
        msg = lib.mimo_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def require_cuda(*tensors, dtype=None) -> None:
    """Validate what a kernel takes: CUDA, one device, contiguous, dtype."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {t.dtype}")
    if dev.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got {dev}")
