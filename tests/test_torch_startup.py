"""The port's startup entry points on the CPU: ``start_app`` (validate,
scaffold, seed synthetic data, no serving) in a temporary working
directory, ``setup_project`` setup / validate, ``environment``
(logging, dependencies, devices, the kernels' build without a card, the
seeded generator, NaN debugging), ``utils/profiling`` (``StepTimer``,
``trace``, ``annotate``), and ``python -m`` of the package, which needs a
card unless told ``--device cpu``."""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import (
    environment, setup_project, start_app)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import (
    native as cuda_native)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.utils import (
    profiling)

PORT = "segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch"
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    """A fresh working directory; the root logger as it was afterwards
    (``setup_logging`` replaces its handlers)."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


def test_start_app_no_serve(workdir, capsys):
    assert start_app.main(["--no-serve", "--seed-data", "1",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "startup validated" in out
    for d in environment.DEFAULT_DIRS:
        assert (workdir / d).is_dir(), d
    assert len(os.listdir(workdir / "data" / "raw")) >= 1
    assert list((workdir / "logs").glob("app_*.log"))
    # a second start finds the data and seeds nothing more
    before = sorted(os.listdir(workdir / "data" / "raw"))
    assert start_app.main(["--no-serve", "--device", "cpu"]) == 0
    assert sorted(os.listdir(workdir / "data" / "raw")) == before


def test_start_app_needs_a_card_unless_told(workdir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        start_app.main(["--no-serve", "--seed-data", "0"])


def test_setup_project(workdir, capsys):
    assert setup_project.main(["validate"]) == 1       # no tree yet
    assert "missing directories" in capsys.readouterr().out
    assert setup_project.main(["setup"]) == 0
    assert (workdir / ".gitignore").read_text() == setup_project.GITIGNORE
    assert setup_project.main(["validate"]) == 0
    assert "validation PASSED" in capsys.readouterr().out
    ok, failures = setup_project.validate_modules()
    assert ok, failures
    for m in setup_project.CORE_MODULES:
        assert (ROOT / PORT / (m.replace(".", "/") + ".py")).is_file(), m


def test_environment_on_the_cpu(workdir):
    ok, status = environment.validate_dependencies(verbose=False)
    assert ok and all(status[p] for p in environment.REQUIRED_PACKAGES)
    assert not {"jax", "jaxlib", "flax"} & set(status)
    if not torch.cuda.is_available():
        assert environment.describe_devices().startswith("no accelerator")
        assert environment.ensure_compilation_cache() == str(
            cuda_native.BUILD_DIR)
    gen, log_path = environment.setup_environment(seed=7, log_dir="lg")
    assert os.path.isfile(log_path) and Path(log_path).parent.name == "lg"
    want = torch.Generator().manual_seed(7)
    assert torch.equal(torch.rand(5, generator=gen),
                       torch.rand(5, generator=want))
    a = np.random.rand(3)
    np.random.seed(7)
    np.testing.assert_array_equal(a, np.random.rand(3))
    environment.enable_nan_debugging(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        environment.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def test_step_timer():
    t = profiling.StepTimer(sync_every=2)
    x = torch.ones(4)
    ticks = [t.tick(x) for _ in range(6)]
    assert [v is None for v in ticks] == [True, False] * 3
    assert all(v >= 0 for v in ticks[1::2])
    s = t.summary()
    assert s["steps"] == 6 and s["steps_per_sec"] > 0
    assert s["min_s"] <= s["median_s"]
    assert profiling.StepTimer().summary() == {"steps": 0}


def test_trace_and_annotate(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("smoke_span"):
            torch.ones(8).add_(1)
    traces = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.load(open(traces[0]))["traceEvents"]
    assert any(e.get("name") == "smoke_span" for e in events)


def test_python_m_needs_a_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", PORT, "--no-serve",
                           "--seed-data", "0"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
