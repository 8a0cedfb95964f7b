"""The port imports no JAX: every module of the port package is
imported in a fresh interpreter, which then must hold neither ``jax``,
``jaxlib``, ``flax``, ``optax``, ``orbax`` nor any module of the JAX
package; the trainer's modules and the headless batch path's are among
those imported."""

import subprocess
import sys
from pathlib import Path

PORT = "segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch"
REF = "segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu"

SCRIPT = f"""
import importlib, pkgutil, sys
import {PORT} as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "{REF}"))
print(len(names), bad)
print(" ".join(names))
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 15, proc.stdout      # every module was reached


# the modules of the trainer's slice, each named as its JAX counterpart
TRAINER_MODULES = ("config", "data.dataset", "data.pipeline",
                   "data.preprocess", "train.checkpoints", "train.trainer",
                   "train.cli", "train.menu", "serve.jobs", "serve.app",
                   "utils.visualization")
# the headless batch path's modules (predict and evaluate CLIs, the native
# host library, the startup entry points), each named as its counterpart
BATCH_MODULES = ("data.native", "data.data_utils", "inference._files",
                 "inference.cli", "inference.evaluate", "utils.profiling",
                 "utils.torch_interop", "environment", "setup_project",
                 "start_app", "__main__")


def test_trainer_modules_import_without_jax():
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    names = set(proc.stdout.splitlines()[1].split())
    for m in TRAINER_MODULES + BATCH_MODULES:
        assert f"{PORT}.{m}" in names, m
        assert (root / REF / (m.replace(".", "/") + ".py")).is_file(), m
