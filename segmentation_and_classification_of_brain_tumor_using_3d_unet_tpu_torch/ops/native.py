"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` call, all
started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``. No
source includes PyTorch's headers, so the build takes seconds, not the
minutes of ``torch.utils.cpp_extension``. The library is built at first
use into ``build/torch_kernels/`` beside the package (a directory git
ignores), named by a hash of the sources, headers and flags so a changed
source or header is rebuilt and an unchanged build is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_K1 = (_P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P,
       _I)
_K2 = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_K7 = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
# C entry points: name -> argument types (every one returns cudaError_t);
# the f32 forms of K1 and K2 take the bf16 forms' arguments (K1's weights
# as bf16 in both; its live D halo planes last, after the stream); K7's f32 form takes scratch for its weights' split
# after w, and that split, the first of its two kernels, has an entry of
# its own for timing
SIGNATURES = {
    "ps2d_conv3d": _K1,
    "ps2d_conv3d_f32": _K1,
    "up_k2s2_into_halo": _K2,
    "up_k2s2_into_halo_f32": _K2,
    "pack_halo": (_P, _I, _P, _I, _I, _I, _I, _I, _P),
    "pool_into_halo": (_P, _I, _P, _I, _I, _I, _I, _I, _P),
    "group_norm": (_P, _I, _P, _I, _I, _P, _P, ctypes.c_float, _P, _P, _I, _I,
                   _I, _I, _I, _P),
    "group_norm_plan": (_I, _I, _I, _I, _I, _I, _P),
    "conv3d_same": _K7,
    "conv3d_same_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "conv3d_same_f32_split_weights": (_P, _P, _I, _I, _P),
    # Q8, the int8 conv (x, x is bf16, the prepared wq and w_scale,
    # act_scale, bias, x's int8 scratch, the split's int32 scratch, y, B,
    # D, H, W, ci, co, stream) and its weights' preparation (w, wq, the f32
    # scratch of w_scale and the maxima, ci, co, stream)
    "conv3d_int8": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                    _I, _P),
    "conv3d_int8_weights": (_P, _P, _P, _I, _I, _P),
}


@dataclass(frozen=True)
class Build:
    path: Path
    seconds: float     # nvcc wall time; 0.0 when an existing build was reused
    log: str           # nvcc's output (-Xptxas -v: registers, smem, spills)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_digest(csrc_dir: Path = CSRC_DIR) -> str:
    """The build's name: a hash of the flags and of every source and
    header (``*.cu``, ``*.cuh``) in ``csrc_dir``, by name and content, so
    an edited header is rebuilt too."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*Path(csrc_dir).glob("*.cu"),
                       *Path(csrc_dir).glob("*.cuh")]):
        digest.update(src.name.encode() + src.read_bytes())
    return digest.hexdigest()[:16]


def build(csrc_dir: Path = CSRC_DIR) -> Build:
    """Compile ``csrc_dir/*.cu`` (the package's sources by default), one
    nvcc process per source, all at once, and link them, unless this
    exact build exists. Raises with nvcc's output if a step fails."""
    sources = sorted(Path(csrc_dir).glob("*.cu"))
    target = BUILD_DIR / f"libps2d_{source_digest(csrc_dir)}.so"
    if target.exists():
        return Build(target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    try:
        if any(p.returncode for p in procs):
            raise RuntimeError(
                "nvcc failed: " + ", ".join(
                    f"{s.name} ({p.returncode})"
                    for s, p in zip(sources, procs) if p.returncode)
                + f"\n{log}")
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{log}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, target)     # atomic: concurrent builders agree
    return Build(target, seconds, log)


class Library:
    """The loaded kernel library: one bound C function per entry point
    it exports (a build of an older source tree, as ``compare_builds``
    loads, lacks the later ones)."""

    def __init__(self, built: Build):
        self.build = built
        self._dll = ctypes.CDLL(str(built.path))
        for name, argtypes in SIGNATURES.items():
            if not hasattr(self._dll, name):
                continue
            fn = getattr(self._dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)
        self._dll.ps2d_error_string.argtypes = (ctypes.c_int,)
        self._dll.ps2d_error_string.restype = ctypes.c_char_p

    def check(self, name: str, code: int) -> None:
        """Raise if a launch returned a CUDA error."""
        if code != 0:
            msg = self._dll.ps2d_error_string(code).decode()
            raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")


_lock = threading.Lock()
_library = None


def library() -> Library:
    """The kernel library, built and loaded at first use in the process."""
    global _library
    with _lock:
        if _library is None:
            _library = Library(build())
        return _library
