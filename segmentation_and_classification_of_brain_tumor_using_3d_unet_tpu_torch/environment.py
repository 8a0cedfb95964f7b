"""Environment bootstrap: seeding, logging, dependency validation and the
kernels' build (counterpart of the JAX package's ``environment.py``).

Where JAX returns a PRNG key, ``setup_environment`` returns a seeded
``torch.Generator`` for the caller to pass on (NumPy's global seed is
still set for host-side code); where JAX turns on its persistent
compilation cache, ``ensure_compilation_cache`` builds (or reuses) the
port's CUDA kernel library.
"""

from __future__ import annotations

import importlib
import logging
import os
import time
from typing import Dict, Tuple

import torch

logger = logging.getLogger(__name__)

REQUIRED_PACKAGES = ("torch", "numpy", "scipy")
OPTIONAL_PACKAGES = ("einops", "matplotlib", "PIL", "pandas", "sklearn",
                     "wandb")

DEFAULT_DIRS = ("data/raw", "data/processed", "data/synthetic",
                "results/models", "results/reports",
                "results/visualizations", "logs", "checkpoints",
                "uploads")


def setup_logging(log_dir: str = "logs",
                  level: int = logging.INFO) -> str:
    """Log to the console and to ``log_dir/app_<time>.log``; returns the
    file's path."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"app_{time.strftime('%Y%m%d_%H%M%S')}.log")
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        handlers=[logging.StreamHandler(), logging.FileHandler(path)],
        force=True)
    return path


def validate_dependencies(verbose: bool = True
                          ) -> Tuple[bool, Dict[str, bool]]:
    """Import-probe the required and optional packages; (all required
    present, {package: present})."""
    status: Dict[str, bool] = {}
    ok = True
    for pkg in REQUIRED_PACKAGES:
        try:
            importlib.import_module(pkg)
            status[pkg] = True
        except ImportError:
            status[pkg] = False
            ok = False
            if verbose:
                logger.error("missing required package: %s", pkg)
    for pkg in OPTIONAL_PACKAGES:
        try:
            importlib.import_module(pkg)
            status[pkg] = True
        except ImportError:
            status[pkg] = False
            if verbose:
                logger.info("optional package not available: %s", pkg)
    return ok, status


def describe_devices() -> str:
    """``"<count> x cuda:<name>"``, or that there is no CUDA device."""
    if not torch.cuda.is_available():
        return "no accelerator (no CUDA device; the CPU runs the kernels' " \
               "plain versions)"
    return (f"{torch.cuda.device_count()} x cuda:"
            f"{torch.cuda.get_device_name(0)}")


def ensure_compilation_cache() -> str:
    """Build the port's CUDA kernels, or reuse the build of these exact
    sources (``ops/native.py``); returns the build directory. Without a
    CUDA device nothing is built, and a failed build is logged, never
    fatal here (the first kernel launch raises it again)."""
    from .ops import native
    if not torch.cuda.is_available():
        logger.info("no CUDA device: the kernels are not built")
        return str(native.BUILD_DIR)
    try:
        built = native.build()
    except (OSError, RuntimeError) as e:
        logger.warning("kernel build failed: %s", e)
        return str(native.BUILD_DIR)
    logger.info("kernels: %s (%.2f s of nvcc)", built.path.name,
                built.seconds)
    return str(built.path.parent)


def setup_environment(seed: int = 42, log_dir: str = "logs",
                      create_dirs: bool = True
                      ) -> Tuple[torch.Generator, str]:
    """Seed, logging, directories, dependency check and the kernels'
    build; returns (a ``torch.Generator`` seeded with ``seed``, the log
    file's path)."""
    import numpy as np
    np.random.seed(seed)
    log_path = setup_logging(log_dir)
    if create_dirs:
        for d in DEFAULT_DIRS:
            os.makedirs(d, exist_ok=True)
    ok, _ = validate_dependencies()
    if not ok:
        logger.warning("some required dependencies are missing")
    logger.info("devices: %s", describe_devices())
    ensure_compilation_cache()
    return torch.Generator().manual_seed(seed), log_path


def enable_nan_debugging(enable: bool = True) -> None:
    """Numerics sanitizer: autograd's anomaly detection, which raises at
    the backward op that produced a NaN."""
    torch.autograd.set_detect_anomaly(enable)


if __name__ == "__main__":
    _, _path = setup_environment()
    print(f"environment ready; log at {_path}")
