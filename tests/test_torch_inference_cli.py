"""The port's predict CLI (``…_torch/inference/cli.py``) against the JAX
package's:

* ``discover_cases`` equal on the same trees, one case per layout of
  tests/test_inference_cli.py (cohort, case directory, single file,
  loose files, flat multi-case, seg prefix collision, modality order,
  dotted ids, unsupported and missing input);
* one end-to-end run of each CLI on a tiny model (features (8, 16),
  16^3) over a two-case cohort: both adopt the same weights, a JAX
  trainer checkpoint and that checkpoint through
  ``convert_orbax_checkpoint.py``. The masks are equal, the reports'
  measurements equal to 1e-6 relative, the confidences within 1e-5, and
  ``predictions.json`` has the same keys. Both CLIs serve their preset in
  float32 here (the preset's ``compute_dtype``, set in each package's
  ``get_config``): in bf16 the two frameworks' logits differ by a few bf16
  ulp and labels flip where the top-2 margin is that small, which the
  predictor's tests hold under the margin contract
  (tests/test_torch_predictor.py);
* ``--brats_labels``, the input affine carried into the outputs, JAX's
  argument checks for the parallel flags and then a run of each flag in
  one process (its device count in the index; held to JAX's CLI in
  tests/test_torch_parallel_cli.py), and ``--device`` (default cuda)
  raising without a card.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401

import convert_orbax_checkpoint as C
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.inference import (
    cli as J)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train import (
    checkpoints as jck, state as jstate)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu import config as jcfg
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.config import (
    BRATS_MODALITIES)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.data import (
    nifti)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference import (
    cli as T)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, to_flax_variables)

TINY = ["--image_size", "16", "16", "16", "--features", "8", "16",
        "--roi_size", "16", "16", "16"]


def _ball(shape=(24, 24, 24), r=6, c=None):
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    c = np.array(shape) // 2 if c is None else np.asarray(c)
    return ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 <= r * r)


def _write_case(case_dir, with_seg, rng, n_modalities=4, affine=None):
    case_dir.mkdir(parents=True)
    ball = _ball()
    for m in BRATS_MODALITIES[:n_modalities]:
        vol = rng.random((24, 24, 24)).astype(np.float32) + 2.0 * ball
        nifti.save(str(case_dir / f"{case_dir.name}_{m}.nii.gz"), vol,
                   affine=affine)
    if with_seg:     # edema 2, core 1, enhancing stored as 4 (BraTS)
        seg = np.zeros((24, 24, 24), np.uint8)
        seg[ball] = 2
        seg[_ball(r=4)] = 1
        seg[_ball(r=3, c=(12, 12, 15))] = 4
        nifti.save(str(case_dir / f"{case_dir.name}_seg.nii.gz"), seg,
                   affine=affine)


# ------------------------------------------------------------ discovery

def _npy(path, dtype=np.float32):
    np.save(path, np.zeros((8, 8, 8), dtype))


def _cohort_layout(root):
    rng = np.random.default_rng(0)
    _write_case(root / "case_a", True, rng)
    _write_case(root / "case_b", False, rng, n_modalities=2)
    return str(root), BRATS_MODALITIES


def _case_dir_layout(root):
    _write_case(root / "case_a", True, np.random.default_rng(0))
    return str(root / "case_a"), BRATS_MODALITIES


def _single_file_layout(root):
    _npy(root / "vol.npy")
    return str(root / "vol.npy"), BRATS_MODALITIES


def _loose_layout(root):
    for n in ("p1.npy", "p2.npy"):
        _npy(root / n)
    return str(root), BRATS_MODALITIES


def _flat_multicase_layout(root):
    for cid in ("caseA", "caseB"):
        for m in ("t1c", "t2f"):
            _npy(root / f"{cid}_{m}.npy")
    _npy(root / "caseB_seg.npy", np.uint8)
    return str(root), BRATS_MODALITIES


def _prefix_collision_layout(root):
    for cid in ("case_1", "case_10"):
        for m in ("t1c", "t2f"):
            _npy(root / f"{cid}_{m}.npy")
    _npy(root / "case_10_seg.npy", np.uint8)
    return str(root), BRATS_MODALITIES


def _modality_order_layout(root):
    for cid in ("pA", "pB"):
        for m in ("t2w", "t1c"):
            _npy(root / f"{cid}_{m}.npy")
    return str(root), ("t2w", "t1c")


def _one_flat_case_layout(root):
    for m in BRATS_MODALITIES:
        _npy(root / f"only_{m}.npy")
    _npy(root / "only_seg.npy", np.uint8)
    return str(root), BRATS_MODALITIES


def _dotted_layout(root):
    nifti.save(str(root / "sub-01.ses-02.nii"),
               np.zeros((4, 4, 4), np.float32))
    return str(root / "sub-01.ses-02.nii"), BRATS_MODALITIES


def _empty_layout(root):
    (root / "notes.txt").write_text("no volumes")
    return str(root), BRATS_MODALITIES


LAYOUTS = {
    "cohort": _cohort_layout, "case_dir": _case_dir_layout,
    "single_file": _single_file_layout, "loose_files": _loose_layout,
    "flat_multicase": _flat_multicase_layout,
    "seg_prefix_collision": _prefix_collision_layout,
    "modality_order": _modality_order_layout,
    "one_flat_case": _one_flat_case_layout, "dotted_id": _dotted_layout,
    "no_volumes": _empty_layout,
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_discover_cases_equals_jax(tmp_path, layout):
    path, mods = LAYOUTS[layout](tmp_path)
    got = T.discover_cases(path, mods)
    assert got == J.discover_cases(path, mods)
    if layout == "seg_prefix_collision":
        by_id = {c["case_id"]: c for c in got}
        assert by_id["case_1"]["seg"] is None
        assert by_id["case_10"]["seg"].endswith("case_10_seg.npy")


@pytest.mark.parametrize("what", ["unsupported", "missing"])
def test_discover_cases_refuses_as_jax(tmp_path, what):
    p = tmp_path / "notes.txt"
    if what == "unsupported":
        p.write_text("x")
    else:
        p = tmp_path / "nowhere"
    for mod in (J, T):
        with pytest.raises(SystemExit):
            mod.discover_cases(str(p), BRATS_MODALITIES)


# ------------------------------------------------------------ end to end

@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("cohort")
    _write_case(root / "case_a", True, rng)
    _write_case(root / "case_b", False, rng, n_modalities=2,
                affine=np.array([[0.0, -1.0, 0.0, 12.5],
                                 [0.9, 0.0, 0.0, -7.0],
                                 [0.0, 0.0, 2.4, 30.0],
                                 [0.0, 0.0, 0.0, 1.0]]))
    return root


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A JAX trainer checkpoint of a tiny U-Net (features (8, 16)) and the
    same checkpoint converted into the port's format."""
    root = tmp_path_factory.mktemp("ckpt")
    var = to_flax_variables(UNet3D(features=(8, 16), seed=5,
                                   device="cpu").state_dict())
    conf = jcfg.Config()
    state = jstate.TrainState.create(
        apply_fn=JUNet3D(features=(8, 16)).apply,
        params=jax.tree_util.tree_map(jnp.asarray, var["params"]),
        tx=jstate.build_optimizer(conf.optimizer),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           var["batch_stats"]))
    src = jck.save_checkpoint(str(root / "best_jax"), state)
    return src, C.convert(src, str(root / "best_port"))


def _numbers(d, prefix=""):
    """Every number in a report's dict, by path (numbers inside strings
    such as "1234.5 mm³" included)."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_numbers(v, key))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[key] = float(v)
        elif isinstance(v, str):
            head = v.split(" ")[0].rstrip("%")
            try:
                out[key] = float(head)
            except ValueError:
                pass
    return out


@pytest.fixture()
def float32_presets(monkeypatch):
    """Each package's ``get_config`` with ``compute_dtype="float32"``."""
    import dataclasses
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import (
        config as tcfg)
    for mod in (jcfg, tcfg):
        def f32(name="standard", _get=mod.get_config):
            cfg = _get(name)
            return cfg.replace(model=dataclasses.replace(
                cfg.model, compute_dtype="float32"))
        monkeypatch.setattr(mod, "get_config", f32)


def test_end_to_end_equals_jax(cohort, checkpoints, tmp_path,
                               float32_presets):
    src, converted = checkpoints
    common = ["--input", str(cohort), "--mode", "whole_volume", "--report",
              "--save_confidence"] + TINY
    oj, ot = tmp_path / "jax", tmp_path / "port"
    sj = J.predict_main(common + ["--output", str(oj), "--checkpoint", src])
    st = T.predict_main(common + ["--output", str(ot), "--checkpoint",
                                  converted, "--device", "cpu"])
    assert [s["case_id"] for s in st] == ["case_a", "case_b"]
    assert [list(s) for s in st] == [list(s) for s in sj]
    ij = json.load(open(oj / "predictions.json"))
    it = json.load(open(ot / "predictions.json"))
    assert list(it) == list(ij)
    assert (ij["weights"], it["weights"]) == (src, converted)
    for cid in ("case_a", "case_b"):
        for kind in ("seg", "conf"):
            a = nifti.load(str(oj / f"{cid}_{kind}.nii.gz"))
            b = nifti.load(str(ot / f"{cid}_{kind}.nii.gz"))
            assert b.data.dtype == a.data.dtype
            np.testing.assert_allclose(b.affine, a.affine, rtol=0, atol=0)
            if kind == "seg":
                np.testing.assert_array_equal(b.data, a.data)
            else:   # the softmax of f32 logits from two frameworks
                np.testing.assert_allclose(b.data, a.data, rtol=0,
                                           atol=1e-5)
        rj = json.load(open(oj / f"{cid}_report.json"))
        rt = json.load(open(ot / f"{cid}_report.json"))
        assert list(rt) == list(rj)
        assert rt["weights"] == converted
        nj, nt = (_numbers(r["measurements"]) for r in (rj, rt))
        assert nj and set(nt) == set(nj)
        for k in nj:
            assert nt[k] == pytest.approx(nj[k], rel=1e-6, abs=1e-12), k
    assert json.load(open(ot / "case_a_report.json"))[
        "quality_metrics"]["estimated"] is False
    assert json.load(open(ot / "case_b_report.json"))[
        "quality_metrics"]["estimated"] is True


def test_brats_labels_and_affine(cohort, tmp_path):
    common = ["--input", str(cohort), "--mode", "whole_volume",
              "--checkpoint", "none", "--device", "cpu"] + TINY
    a_dir, b_dir = tmp_path / "contig", tmp_path / "brats"
    T.predict_main(common + ["--output", str(a_dir)])
    T.predict_main(common + ["--output", str(b_dir), "--brats_labels"])
    for cid in ("case_a", "case_b"):
        a = nifti.load(str(a_dir / f"{cid}_seg.nii.gz"))
        b = nifti.load(str(b_dir / f"{cid}_seg.nii.gz"))
        assert 4 not in np.unique(a.data) and 3 not in np.unique(b.data)
        np.testing.assert_array_equal(b.data == 4, a.data == 3)
        np.testing.assert_array_equal(b.data[b.data != 4],
                                      a.data[a.data != 3])
        src = nifti.load_affine(
            str(cohort / cid / f"{cid}_{BRATS_MODALITIES[0]}.nii.gz"))
        np.testing.assert_allclose(b.affine, src, atol=1e-5)
    assert not np.allclose(b.affine, np.eye(4))    # case_b's is real


@pytest.mark.parametrize("flags,exc", [
    (["--window_parallel", "--mode", "whole_volume"], SystemExit),
    (["--window_parallel", "--data_parallel"], SystemExit),
    (["--data_parallel", "--mode", "cropped"], SystemExit),
    (["--data_parallel", "--mode", "whole_volume", "--tta"], SystemExit),
    (["--data_parallel", "--mode", "whole_volume"], None),
    (["--window_parallel"], None),
])
def test_parallel_flags(cohort, tmp_path, flags, exc):
    argv = (["--input", str(cohort / "case_a"), "--output",
             str(tmp_path / "x"), "--checkpoint", "none", "--device",
             "cpu"] + TINY + flags)
    if exc is None:         # runs, in one process
        T.predict_main(argv)
        index = json.load(open(tmp_path / "x" / "predictions.json"))
        assert index[flags[0].lstrip("-") + "_devices"] == 1
        return
    with pytest.raises(exc):
        T.predict_main(argv)


def test_device_defaults_to_the_card(cohort, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.predict_main(["--input", str(cohort), "--output",
                        str(tmp_path / "x"), "--checkpoint", "none"] + TINY)
