"""ctypes bindings for the port's native host library (counterpart of the
JAX package's ``data/native.py``).

``csrc/host_preprocess.cpp`` (the port's own copy) is compiled by g++ at
first use into ``build/host_preprocess/`` beside the package (a directory
git ignores), named by a hash of the source and the flags, and exposes:

  * ``read_nifti(path)``          — multithreaded NIfTI decode;
  * ``zoom(vol, size, order)``    — OpenMP half-pixel trilinear (order 1)
    or nearest (order 0) resample;
  * ``clip_zscore(vol, lo, hi)``  — exact percentile clip + z-score;
  * ``host_threads()``            — the library's OpenMP threads.

``read_nifti`` and ``clip_zscore`` return None when the library is absent
or the input is unsupported (a big-endian file, a corrupt header, more
than 1<<30 voxels): the caller then takes the NumPy path, as in JAX.
``zoom`` without the library runs ``zoom_plain``, a torch version of the
same half-pixel resample, so the port's results do not depend on whether
g++ is there. A failed build is logged at WARNING with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "host_preprocess.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "host_preprocess"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
LIBS = ("-lz",)
# the largest legitimate volume is ~14 Mvox; a header-only shape query
# cannot bounds-check the data section, so a lying dim field is capped
MAX_VOXELS = 1 << 30

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the build of this source with these flags lives."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode()
                            + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libhostpre_{digest}.so"


def build() -> Optional[Path]:
    """Compile the library unless this exact build exists; its path, or
    None (logged at WARNING with g++'s output) when the build fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("native host library: g++ did not run (%s); "
                       "using the plain paths", e)
        return None
    if proc.returncode != 0:
        logger.warning("native host library: g++ failed (%d); using the "
                       "plain paths:\n%s", proc.returncode,
                       proc.stderr.strip())
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, target)     # atomic: concurrent builds agree
    return target


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use in the process; None when
    it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # a container's cgroup quota can make libgomp default to one
        # thread while more cores are usable
        os.environ.setdefault("OMP_NUM_THREADS", "8")
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.warning("native host library %s did not load: %s",
                           path, e)
            return None
        lib.nifti_read_f32.restype = ctypes.c_int64
        lib.nifti_read_f32.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]
        zoom_args = ([ctypes.c_void_p] + [ctypes.c_int32] * 3
                     + [ctypes.c_void_p] + [ctypes.c_int32] * 3)
        for fn in (lib.zoom_trilinear_f32, lib.zoom_nearest_f32):
            fn.restype = None
            fn.argtypes = zoom_args
        lib.clip_zscore_f32.restype = ctypes.c_int
        lib.clip_zscore_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
            ctypes.c_float, ctypes.c_float]
        lib.host_threads.restype = ctypes.c_int
        lib.host_threads.argtypes = []
        _lib = lib
        logger.info("native host library loaded (%d threads)",
                    lib.host_threads())
        return _lib


def available() -> bool:
    return get_lib() is not None


def host_threads() -> int:
    """OpenMP threads of the library (0 without it)."""
    lib = get_lib()
    return 0 if lib is None else int(lib.host_threads())


def read_nifti(path: str) -> Optional[np.ndarray]:
    """Decode a little-endian NIfTI-1 of at most 3 dimensions to float32
    (NIfTI axis order, as the NumPy codec gives it); None when the
    library is absent or the file unsupported."""
    lib = get_lib()
    if lib is None:
        return None
    shape = (ctypes.c_int32 * 3)()
    count = lib.nifti_read_f32(str(path).encode(), None, 0, shape)
    if count <= 0 or count > MAX_VOXELS:
        return None
    buf = np.empty(count, np.float32)
    got = lib.nifti_read_f32(str(path).encode(),
                             buf.ctypes.data_as(ctypes.c_void_p), count,
                             shape)
    if got != count:
        return None
    try:
        # x fastest on disk: (x, y, z) in Fortran order is (z, y, x) in C
        return np.ascontiguousarray(
            buf.reshape((shape[2], shape[1], shape[0]))).transpose(2, 1, 0)
    except ValueError:      # a corrupt header must not raise
        return None


def _half_pixel(n_in: int, n_out: int) -> torch.Tensor:
    """The library's source coordinate of each output voxel, in its float32
    arithmetic: (i + 0.5) * (n_in / n_out) - 0.5."""
    scale = torch.tensor(n_in, dtype=torch.float32) / n_out
    return (torch.arange(n_out, dtype=torch.float32) + 0.5) * scale - 0.5


def _linear_axis(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    n_in = x.shape[axis]
    f = _half_pixel(n_in, n_out)
    i0 = torch.floor(f)
    w = f - i0
    i0 = i0.long()
    lo = x.index_select(axis, i0.clamp(0, n_in - 1))
    hi = x.index_select(axis, (i0 + 1).clamp(0, n_in - 1))
    shape = [1] * x.ndim
    shape[axis] = n_out
    w = w.reshape(shape)
    return lo * (1 - w) + hi * w


def _nearest_axis(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    n_in = x.shape[axis]
    scale = torch.tensor(n_in, dtype=torch.float32) / n_out
    idx = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * scale).long()
    return x.index_select(axis, idx.clamp(max=n_in - 1))


def zoom_plain(vol: np.ndarray, size: Tuple[int, int, int],
               order: int = 1) -> np.ndarray:
    """The library's resample in torch on the host: the half-pixel grid,
    edge-clamped, interpolated along the last axis, then the middle, then
    the first, as the C loop nests its lerps."""
    if order not in (0, 1):
        raise ValueError(f"zoom order {order}: only 0 and 1")
    x = torch.from_numpy(np.ascontiguousarray(vol, np.float32))
    step = _linear_axis if order == 1 else _nearest_axis
    for axis in (2, 1, 0):
        x = step(x, axis, int(size[axis]))
    return x.contiguous().numpy()


def zoom(vol: np.ndarray, size: Tuple[int, int, int],
         order: int = 1) -> Optional[np.ndarray]:
    """Resample an (a, b, c) volume to ``size`` in float32: nearest
    (order 0) or half-pixel trilinear (order 1, as ``jax.image.resize``),
    on the library or, without it, ``zoom_plain``. None for another order
    or rank (the caller's spline path)."""
    if np.ndim(vol) != 3 or order not in (0, 1):
        return None
    lib = get_lib()
    if lib is None:
        return zoom_plain(vol, size, order)
    src = np.ascontiguousarray(vol, np.float32)
    out = np.empty(tuple(int(s) for s in size), np.float32)
    # C order (a, b, c): the minor axis c is the library's x
    fn = lib.zoom_trilinear_f32 if order == 1 else lib.zoom_nearest_f32
    fn(src.ctypes.data_as(ctypes.c_void_p),
       src.shape[2], src.shape[1], src.shape[0],
       out.ctypes.data_as(ctypes.c_void_p),
       out.shape[2], out.shape[1], out.shape[0])
    return out


def clip_zscore(vol: np.ndarray, p_lo: float = 1.0, p_hi: float = 99.0,
                eps: float = 1e-8) -> Optional[np.ndarray]:
    """Percentile clip then z-score of a copy of ``vol`` (float32); None
    when the library is absent or reports a failure (the buffer is then
    not normalised)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.array(vol, np.float32, order="C")
    rc = lib.clip_zscore_f32(buf.ctypes.data_as(ctypes.c_void_p),
                             buf.size, p_lo, p_hi, eps)
    if rc != 0:
        logger.warning("native clip_zscore failed (rc=%d); falling back",
                       rc)
        return None
    return buf
