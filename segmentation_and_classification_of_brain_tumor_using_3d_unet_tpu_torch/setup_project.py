"""Project scaffolding and validation CLI (counterpart of the JAX
package's ``setup_project.py``): the directory tree, a .gitignore and the
dependency check (reference ``setup_project.py:170-214``), and the
validation of the tree, the dependencies and the port's modules
(reference ``validate_setup.py:62-80``), as
``python -m ...setup_project [setup|validate]``.
"""

from __future__ import annotations

import importlib
import os
import sys
from typing import List, Tuple

from .environment import DEFAULT_DIRS, validate_dependencies

CORE_MODULES = (
    "config", "losses", "metrics",
    "models.unet3d", "models.classifier",
    "data.nifti", "data.synthetic", "data.dataset", "data.pipeline",
    "train.state", "train.loop", "train.trainer", "train.checkpoints",
    "data.native", "inference.sliding_window", "inference.predictor",
    "inference.cli", "inference.evaluate", "serve.app", "serve.jobs",
    "serve.reports", "utils.visualization", "utils.mesh", "parallel.mesh",
)

GITIGNORE = """__pycache__/
*.pyc
.pytest_cache/
data/
results/
logs/
checkpoints/
runs/
uploads/
build/
"""


def create_directories(root: str = ".") -> List[str]:
    made = []
    for d in DEFAULT_DIRS:
        path = os.path.join(root, d)
        os.makedirs(path, exist_ok=True)
        made.append(path)
    return made


def create_gitignore(root: str = ".") -> str:
    path = os.path.join(root, ".gitignore")
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write(GITIGNORE)
    return path


def validate_modules() -> Tuple[bool, List[str]]:
    """Import-probe every core module of the port (reference
    ``validate_setup.py:49-60``)."""
    pkg = __name__.rsplit(".", 1)[0]
    failures = []
    for mod in CORE_MODULES:
        try:
            importlib.import_module(f"{pkg}.{mod}")
        except Exception as e:
            failures.append(f"{mod}: {e}")
    return not failures, failures


def validate_directories(root: str = ".") -> Tuple[bool, List[str]]:
    missing = [d for d in DEFAULT_DIRS
               if not os.path.isdir(os.path.join(root, d))]
    return not missing, missing


def setup(root: str = ".") -> bool:
    print("creating project directories...")
    for d in create_directories(root):
        print(f"  {d}")
    create_gitignore(root)
    ok, status = validate_dependencies()
    print("dependencies:",
          ", ".join(f"{k}={'ok' if v else 'MISSING'}"
                    for k, v in status.items()))
    return ok


def validate(root: str = ".") -> bool:
    ok = True
    dirs_ok, missing = validate_directories(root)
    if not dirs_ok:
        print(f"missing directories: {missing}")
        ok = False
    deps_ok, _ = validate_dependencies(verbose=False)
    if not deps_ok:
        print("missing required dependencies")
        ok = False
    mods_ok, failures = validate_modules()
    if not mods_ok:
        print("module import failures:")
        for f in failures:
            print(f"  {f}")
        ok = False
    print("validation", "PASSED" if ok else "FAILED")
    return ok


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = argv[0] if argv else "setup"
    if cmd == "validate":
        return 0 if validate() else 1
    ok = setup()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
