"""Build and load the hand-written CUDA kernels.

``mimo_unet_torch/csrc/*.cu`` compile at first use into one shared library
with a plain C interface, loaded with ``ctypes``: one nvcc per source, all
started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <build>/<hash>/<name>.o
    nvcc -shared -o <build>/<hash>/libmimo_unet_kernels.so <build>/<hash>/*.o

ptxas's report (registers, shared memory, spills per kernel) of the build
this process ran is kept in ``build_log``.  The build directory
(``mimo_unet_torch/_build/``, git-ignored) is keyed by a
hash of the sources and the command, so an edited source rebuilds and an
unchanged one loads the existing library.  Under a data mesh of several
ranks, ``load_library(mesh)`` lets rank 0 build while the others wait at a
barrier, then they load its build.  Nothing here runs at import: the
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# element offsets and sizes cross the C boundary as 64-bit ints: a B=128
# flagship in_conv output alone holds 352 M elements
_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    # x1, x2, wpk, s1, sh1, s2, sh2, wo, bo, out, hpool, lo_h, fa, fb,
    # n, h, w, c1, c2, n2, x2_half_h, m, o, oc, groups, group_rows_out,
    # th, tw, im2col, cb, nb1, wn1, cb2, nb2, wn2, threads, blocks, stream
    "mimo_fused_double_conv": [_P] * 14 + [_I] * 23 + [_P],
    # x, out, rows, w, c, stream
    "mimo_pool_w": [_P, _P, _I, _I, _I, _P],
    # x, lo, w0, w1, out, rows, w2, c, stream
    "mimo_upsample_w2x": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x1, x2, wpk, sc, sh, lo_h, fa, fb, y, psum, psq,
    # n, h, w, c1, c2, n2, o, groups, prologue, x2_half_h, th, cb, nb, span,
    # im2col, stream
    "mimo_conv3x3_fwd": [_P] * 11 + [_I] * 15 + [_P],
    # g, wpk, frow, fcol, x1, sc, sh, dx1, dx2, pdsc, pdsh,
    # n, h, w, o, c1, c2, n2, groups, prologue, th, cb, span, stream
    "mimo_conv3x3_dx": [_P] * 11 + [_I] * 12 + [_P],
    # x1, x2, g, sc, sh, lo_h, fa, fb, partial,
    # n, h, w, c1, c2, n2, o, groups, prologue, x2_half_h, th, cb, nb, span,
    # im2col, stream
    "mimo_conv3x3_dw": [_P] * 9 + [_I] * 15 + [_P],
    # dy, y, dsum, dsumsq, out, n, hw, o, groups, stream
    "mimo_g_eff": [_P] * 5 + [_I] * 4 + [_P],
    # y, sc, sh, z, n, hw, c, groups, stream
    "mimo_affine_relu": [_P] * 4 + [_I] * 4 + [_P],
    # dz, y, sc, sh, dy, pdsc, pdsh, n, hw, c, groups, stream
    "mimo_affine_relu_bwd": [_P] * 7 + [_I] * 4 + [_P],
    # y, sc, sh, wo, bo, out, n, hw, c, oc, groups, stream
    "mimo_conv1x1_prelu": [_P] * 6 + [_I] * 5 + [_P],
    # g, y, sc, sh, wo, dy, partial, n, hw, c, oc, groups, stream
    "mimo_conv1x1_prelu_bwd": [_P] * 7 + [_I] * 5 + [_P],
    # z, wo, bo, out, n, hw, c, oc, groups, stream
    "mimo_conv1x1": [_P] * 4 + [_I] * 5 + [_P],
    # g, z, wo, dz, partial, n, hw, c, oc, groups, stream
    "mimo_conv1x1_bwd": [_P] * 5 + [_I] * 5 + [_P],
    # partial, out, groups, p, l, stream
    "mimo_reduce_groups": [_P] * 2 + [_I] * 3 + [_P],
    # x, y, n, h, w, c, stream
    "mimo_pool2x2": [_P] * 2 + [_I] * 4 + [_P],
    # g, x, y, g_skip (or null), gx, n, h, w, c, stream
    "mimo_pool2x2_bwd": [_P] * 5 + [_I] * 4 + [_P],
    # x, lo_w, w0, w1, lo_h, fa, fb, y, n, h2, w2, c, stream
    "mimo_upsample2x": [_P] * 8 + [_I] * 4 + [_P],
    # g, wh, ww, dx, n, h2, w2, c, stream
    "mimo_upsample2x_bwd": [_P] * 4 + [_I] * 4 + [_P],
    # g, wh, dx, n, h2, w, c, stream
    "mimo_lerp_h2x_transpose": [_P] * 3 + [_I] * 4 + [_P],
    # g, ww, dx, rows, w2, c, stream
    "mimo_upsample_w2x_bwd": [_P] * 3 + [_I] * 3 + [_P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran, if any
build_log = {}        # source stem -> what nvcc printed (ptxas -v) in that build


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


def _run_all(cmds):
    """Run the commands concurrently; raise with the first failure's
    output once all have ended, else return each one's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (so, se) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}"
                               f"\n{se}{so}")
    return [se + so for so, se in outs]


def _build(out: Path, src_dir: Path = CSRC_DIR) -> None:
    global build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs, cmds = [], []
        srcs = sorted(src_dir.glob("*.cu"))
        for src in srcs:
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            cmds.append([nvcc] + NVCC_FLAGS + ["-c", str(src), "-o", obj])
        build_log.update(zip((s.stem for s in srcs), _run_all(cmds)))
        # link under a temporary name, then rename: a concurrent loader
        # never sees a half-written library
        tmp = os.path.join(tmpdir, LIB_NAME)
        _run_all([[nvcc, "-shared", "-o", tmp] + objs])
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0


def library_path() -> Path:
    """Where this source tree's kernel library is built."""
    return BUILD_DIR / _digest() / LIB_NAME


def bind(path: Path) -> ctypes.CDLL:
    """A built kernel library, loaded with the entries' C signatures."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mimo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mimo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library(mesh=None) -> ctypes.CDLL:
    """The kernel library, built first if this source tree has no build.
    Every rank of ``mesh`` (a data mesh, ``parallel/mesh.py``) must call it
    with the mesh: rank 0 loads (building if need be) while the others
    wait at a barrier, then they load, so a fresh tree builds once, not
    once a rank."""
    global _lib
    if mesh is not None and mesh.size > 1:
        from mimo_unet_torch.parallel.collectives import barrier

        if mesh.rank == 0:
            load_library()
        barrier(mesh)
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            _lib = bind(path)
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
