"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ONE ``nvcc`` call into one
shared library with a plain C interface, loaded with ``ctypes``. No
source includes PyTorch's headers, so the build takes seconds, not the
minutes of ``torch.utils.cpp_extension``. The library is built at first
use into ``build/torch_kernels/`` beside the package (a directory git
ignores), named by a hash of the sources and flags so a changed source
is rebuilt and an unchanged one is reused.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (every one returns cudaError_t)
SIGNATURES = {
    "ps2d_conv3d": (_P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P,
                    _I, _I, _I, _I, _I, _P),
    "up_k2s2_into_halo": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "pack_halo": (_P, _P, _I, _I, _I, _I, _I, _P),
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


def build() -> Build:
    """Compile ``csrc/*.cu`` with one nvcc call unless this exact build
    exists. Raises with nvcc's output if the compile fails."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    target = BUILD_DIR / f"libps2d_{digest.hexdigest()[:16]}.so"
    if target.exists():
        return Build(target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)     # atomic: concurrent builders agree
    return Build(target, seconds, proc.stdout + proc.stderr)


class Library:
    """The loaded kernel library: one bound C function per entry point."""

    def __init__(self, built: Build):
        self.build = built
        self._dll = ctypes.CDLL(str(built.path))
        for name, argtypes in SIGNATURES.items():
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
