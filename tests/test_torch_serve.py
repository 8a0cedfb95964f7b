"""The port's web tier against the JAX package's, on the CPU: the
multipart parser and path helpers, the pages, the reports and the
binary metrics, the synthetic volume, the pictures, and ``/upload``
itself — the JAX app and the port's app with the same weights (the
weight bridge), at the small ps2d setting of test_torch_level1.py
(features (32, 64), ``ps2d_eval=True, ps2d_levels=2``), answering the
same multipart ``.nii.gz``.

Tolerances:
  * parser, path helpers, reports on equal inputs, the synthetic volume,
    the meshes and the pictures on equal inputs: exactly equal;
  * the binary metrics within 1e-6 of JAX's;
  * ``/upload``: labels under the margin contract of
    tests/test_ps2d.py:276-326 (none may differ where JAX's top-2 logit
    margin exceeds twice the largest logit drift; >= 0.99 agree) and
    exactly equal outside the crop; the return_mask NIfTI (gunzipped)
    bit-exact in its header and wherever the labels agree (all of it
    when they all agree); the answer's classification, measurements,
    quality numbers and notes exactly what JAX's report functions give
    on the port's own labels, confidence and scan spacing; against
    JAX's answer the same class, its confidence within 2^-6
    (test_torch_predictor.py's classifier bound), and tumour volumes
    apart by at most the voxels whose labels differ. (At random
    weights the margins are small: 0.45% of this scan's labels flip,
    all inside the drift envelope.)
"""

import base64
import dataclasses
import gzip
import http.client
import json
import math
import threading
import urllib.request

import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu import (
    config as jcfg, metrics as jmetrics)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.data import (
    synthetic as jsynthetic)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.inference.predictor import (
    Predictor as JPredictor, preprocess_image as jpreprocess)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.serve import (
    app as japp, reports as jreports)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.utils import (
    mesh as jmesh, visualization as jviz)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import (
    config as tcfg, metrics as tmetrics)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.data import (
    nifti as tnifti, synthetic as tsynthetic)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference import (
    cropping)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference.predictor import (
    Predictor, preprocess_image as tpreprocess)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    BrainTumorClassifier, UNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.serve import (
    app as tapp, reports as treports)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.utils import (
    mesh as tmesh, visualization as tviz)

from _torch_threads import two_torch_threads  # noqa: F401
from test_torch_unet import flax_variables

ROI = (16, 16, 16)


def _configs(tmp_path, **inference):
    """(JAX Config, port Config): the small ps2d setting."""
    model = dict(features=(32, 64), ps2d_eval=True, ps2d_levels=2)
    inf = dict(roi_size=ROI, overlap=0.5, sw_batch_size=4,
               crop_bucket_ladder=(), upload_mode="cropped",
               checkpoint="none", **inference)
    data_dir = str(tmp_path / "dataroot")
    return (jcfg.Config(model=jcfg.ModelConfig(**model),
                        data=jcfg.DataConfig(image_size=ROI),
                        inference=jcfg.InferenceConfig(**inf),
                        data_dir=data_dir),
            tcfg.Config(model=tcfg.ModelConfig(**model),
                        data=tcfg.DataConfig(image_size=ROI),
                        inference=tcfg.InferenceConfig(**inf),
                        data_dir=data_dir))


def _weights():
    seg = flax_variables(UNet3D(features=(32, 64), seed=6, device="cpu"))
    cls = flax_variables(BrainTumorClassifier(seed=7, device="cpu"))
    return seg, {"params": cls["params"]}


@pytest.fixture(scope="module")
def port_app(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_app")
    _, tc = _configs(tmp)
    seg, cls = _weights()
    return tapp.BrainTumorApp(
        tc, upload_dir=str(tmp / "uploads"), device="cpu",
        predictor=Predictor(tc, seg_variables=seg, cls_variables=cls,
                            device="cpu"))


def _scan(seed=3, shape=(20, 22, 36)):
    """A 3D skull-stripped scan: zeros outside an ellipsoid brain, a
    bright blob, raw-MRI-like intensities."""
    rng = np.random.default_rng(seed)
    D, H, W = shape
    zz, yy, xx = np.ogrid[:D, :H, :W]
    brain = (((zz - D / 2) / 7.5) ** 2 + ((yy - H / 2) / 8) ** 2
             + ((xx - W / 2) / 15) ** 2) < 1
    vol = np.zeros(shape, np.float32)
    vol[brain] = rng.gamma(4.0, 100.0, int(brain.sum()))
    blob = (((zz - 10) ** 2 + (yy - 9) ** 2 + (xx - 15) ** 2) < 12) & brain
    vol[blob] += 600.0
    return vol


def _affine():
    aff = np.diag([1.2, 0.9, 1.5, 1.0])
    aff[:3, 3] = (-40.0, 12.0, 3.5)
    return aff


def _multipart(fields, boundary="PORTB"):
    """multipart/form-data body: ``fields`` maps a name to bytes, or to
    (filename, bytes)."""
    body = b""
    for name, val in fields.items():
        fn = ""
        if isinstance(val, tuple):
            fn, val = f'; filename="{val[0]}"', val[1]
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{name}"{fn}\r\n\r\n').encode() + val + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    return body, {"content-type":
                  f"multipart/form-data; boundary={boundary}"}


def _post(app, fields):
    body, headers = _multipart(fields)
    status, ctype, payload = app.route("POST", "/upload", {}, body, headers)
    return status, json.loads(payload)


def _equal(a, b):
    """Recursive equality with NaN equal to NaN."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b and type(a) is type(b)


# ----------------------------------------------------------------------
# parser, path helpers, pages
# ----------------------------------------------------------------------

@pytest.mark.parametrize("payload", [b"BINARY\x00DATA", b"ABC\n\r\n\r\n",
                                     b"\r\n", b""])
def test_parse_multipart_matches_jax(payload):
    """Only the one delimiter CRLF is removed: a gzip payload may end
    in 0x0A / 0x0D bytes."""
    body, headers = _multipart({"demo": b"1",
                                "file": ("scan.nii.gz", payload)},
                               boundary="XBOUND")
    ctype = headers["content-type"]
    got = tapp.parse_multipart(body, ctype)
    assert got == japp.parse_multipart(body, ctype)
    assert got["file"] == {"filename": "scan.nii.gz", "data": payload}
    assert got["demo"] == {"filename": None, "data": b"1"}
    quoted = ctype.replace("boundary=XBOUND", 'boundary="XBOUND"')
    assert tapp.parse_multipart(body, quoted) == got
    with pytest.raises(ValueError):
        tapp.parse_multipart(body, "multipart/form-data")


def test_path_helpers_match_jax(tmp_path):
    root = str(tmp_path)
    for p in (None, "", "a/b", "./x", "a/../b"):
        assert tapp.resolve_under(root, p) == japp.resolve_under(root, p)
    for p in ("../x", "/etc", "a/../../x"):
        for mod in (tapp, japp):
            with pytest.raises(ValueError):
                mod.resolve_under(root, p)
    for name in ("../../etc/passwd", "my scan (1).nii.gz", "", "a\\b.npy",
                 "ok-name_1.nii"):
        assert tapp.secure_filename(name) == japp.secure_filename(name)


def test_pages_health_and_404(port_app):
    for path in ("/", "/metrics", "/documentation"):
        status, ctype, payload = port_app.route("GET", path, {}, b"", {})
        assert status == 200 and ctype == "text/html"
        assert "<html" in payload
    status, _, payload = port_app.route("GET", "/health", {}, b"", {})
    h = json.loads(payload)
    assert status == 200 and h["status"] == "ok" and h["device"] == "cpu"
    assert h["weights"] == "random_init" and h["sessions"] == []
    status, _, payload = port_app.route("GET", "/nope", {}, b"{}", {})
    assert status == 404 and not json.loads(payload)["success"]
    # the training routes (sessions: tests/test_torch_trainer.py)
    status, _, payload = port_app.route("GET", "/training_progress", {},
                                        b"", {})
    assert status == 404 and json.loads(payload)["status"] == "not_found"
    status, _, payload = port_app.route("POST", "/stop_training", {},
                                        b"{}", {})
    assert status == 200 and json.loads(payload)["stopped"] is False
    # the page keeps the JAX page's fetch protocol
    page = port_app.route("GET", "/", {}, b"", {})[2]
    for needle in ("/upload", "/generate_synthetic_data", "return_mask"):
        assert needle in page


def test_entry_points_refuse_what_they_cannot_serve(tmp_path):
    _, tc = _configs(tmp_path)
    if not torch.cuda.is_available():
        # the entry points default to the card and never fall back
        with pytest.raises(RuntimeError):
            tapp.BrainTumorApp(tc, upload_dir=str(tmp_path / "u"))
    # an explicit checkpoint that is not there is refused, never
    # replaced by the seeded weights
    explicit = tc.replace(inference=dataclasses.replace(
        tc.inference, checkpoint=str(tmp_path / "best_model")))
    with pytest.raises(FileNotFoundError):
        tapp.BrainTumorApp(explicit, upload_dir=str(tmp_path / "u"),
                           device="cpu")
    auto = tc.replace(inference=dataclasses.replace(tc.inference,
                                                    checkpoint=""))
    a = tapp.BrainTumorApp(auto, upload_dir=str(tmp_path / "u"),
                           device="cpu")
    assert a.weights_source == "random_init"


# ----------------------------------------------------------------------
# reports, metrics, synthetic data, meshes, pictures
# ----------------------------------------------------------------------

def _report_cases():
    rng = np.random.default_rng(21)
    seg = np.zeros((24, 26, 22), np.uint8)
    seg[6:16, 8:18, 5:14] = 2
    seg[8:13, 10:15, 7:11] = 1
    seg[9:11, 11:13, 8:10] = 3
    gt = np.roll(seg, 2, axis=1)
    vol = rng.normal(size=seg.shape).astype(np.float32)
    conf = rng.uniform(0.3, 1.0, seg.shape).astype(np.float32)
    big = np.zeros((40, 40, 40), np.uint8)
    big[2:38, 2:38, 2:38] = 1                          # > 10 000 mm^3
    return [
        dict(image_data=vol, segmentation=seg),
        dict(image_data=vol, segmentation=seg, confidence_map=conf),
        dict(image_data=vol, segmentation=seg, confidence_map=conf,
             spacing_mm=(1.2, 0.9, 1.5)),
        dict(image_data=vol, segmentation=seg, spacing_mm=(1.2, 0.9, 1.5),
             voxel_volume_mm3=1.5),
        dict(image_data=vol, segmentation=seg, ground_truth=gt,
             spacing_mm=(1.0, 2.0, 1.0)),
        dict(image_data=vol, segmentation=np.zeros_like(seg)),
        dict(image_data=np.zeros(big.shape, np.float32), segmentation=big),
    ]


def test_medical_metrics_and_report_match_jax():
    for kw in _report_cases():
        ref = jreports.calculate_medical_metrics(**kw)
        got = treports.calculate_medical_metrics(**kw)
        assert _equal(got, ref), (got, ref)
        for extra in ({}, {"classifier_confidence": 0.77},
                      {"model_grade": 3, "grade_confidence": 0.91},
                      {"model_grade": 1, "classifier_confidence": 0.6}):
            r = treports.generate_clinical_report(got, filename="x", **extra)
            assert _equal(r, jreports.generate_clinical_report(
                ref, filename="x", **extra))


def test_binary_metrics_match_jax():
    rng = np.random.default_rng(22)
    pred = rng.random((18, 20, 16)).astype(np.float32)
    target = (rng.random((18, 20, 16)) > 0.7).astype(np.float32)
    p, t = torch.from_numpy(pred), torch.from_numpy(target)
    for name in ("dice_coefficient", "iou_score", "sensitivity",
                 "specificity"):
        got = getattr(tmetrics, name)(p, t)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(getattr(jmetrics, name)(pred, target))
                   ) <= 1e-6
    for spacing in ((1.0, 1.0, 1.0), (1.2, 0.8, 2.0)):
        assert tmetrics.hausdorff_distance(p, t, spacing) == \
            jmetrics.hausdorff_distance(pred, target, spacing)
        assert tmetrics.hausdorff_distance_95(p, t, spacing) == \
            jmetrics.hausdorff_distance_95(pred, target, spacing)
    got, ref = (tmetrics.compute_all_metrics(p, t),
                jmetrics.compute_all_metrics(pred, target))
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k
    empty = torch.zeros_like(p)
    assert tmetrics.hausdorff_distance(empty, t) == float("inf")


def test_synthetic_data_matches_jax(tmp_path):
    for seed, shape, tumor in ((0, (16, 16, 16), True),
                               (5, (20, 18, 12), True), (1, (8, 8, 8), False)):
        gv, gs = tsynthetic.synthesize_volume(shape, seed=seed,
                                              with_tumor=tumor)
        rv, rs = jsynthetic.synthesize_volume(shape, seed=seed,
                                              with_tumor=tumor)
        np.testing.assert_array_equal(gv, rv)
        np.testing.assert_array_equal(gs, rs)
        assert gv.dtype == rv.dtype and gs.dtype == rs.dtype
    a = tsynthetic.create_enhanced_synthetic_data(
        2, str(tmp_path / "t"), shape=(12, 12, 10), skull_stripped=True)
    b = jsynthetic.create_enhanced_synthetic_data(
        2, str(tmp_path / "j"), shape=(12, 12, 10), skull_stripped=True)
    files = sorted(p.relative_to(a) for p in
                   __import__("pathlib").Path(a).rglob("*.nii.gz"))
    assert len(files) == 10
    for f in files:
        np.testing.assert_array_equal(tnifti.load(f"{a}/{f}").data,
                                      tnifti.load(f"{b}/{f}").data)
    pa = tsynthetic.create_synthetic_data(2, str(tmp_path / "t1"),
                                          shape=(8, 8, 8))
    pb = jsynthetic.create_synthetic_data(2, str(tmp_path / "j1"),
                                          shape=(8, 8, 8))
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(np.load(x), np.load(y))


def test_meshes_and_pictures_match_jax():
    vol, seg = jsynthetic.synthesize_volume((24, 24, 24), seed=3)
    for cls in (1, 2, 3):
        m = seg == cls
        assert tmesh.isosurface_area(m, (1.0, 1.2, 0.8)) == \
            jmesh.isosurface_area(m, (1.0, 1.2, 0.8))
        for a, b in zip(tmesh.smooth_surface_mesh(m, max_voxels=500),
                        jmesh.smooth_surface_mesh(m, max_voxels=500)):
            np.testing.assert_array_equal(a, b)
    tv, jv = tviz.ModernMedicalVisualizer(), jviz.ModernMedicalVisualizer()
    assert tv.create_segmentation_overlay(vol, seg) == \
        jv.create_segmentation_overlay(vol, seg)
    assert tv.create_volume_analysis_dashboard(vol, seg) == \
        jv.create_volume_analysis_dashboard(vol, seg)
    assert tv.create_3d_tumor_reconstruction(seg) == \
        jv.create_3d_tumor_reconstruction(seg)
    # a 4-modality volume: the port's overlay draws the first modality,
    # JAX's hands the 4-channel slice to imshow, which refuses it
    vol4 = np.stack([vol, vol * 2, vol * 3, vol * 4], axis=-1)
    assert tv.create_segmentation_overlay(vol4, seg) == \
        jv.create_segmentation_overlay(vol, seg)
    with pytest.raises(TypeError):
        jv.create_segmentation_overlay(vol4, seg)


# ----------------------------------------------------------------------
# /upload: the JAX app and the port's app on the same scan and weights
# ----------------------------------------------------------------------

def _mask(answer):
    raw = gzip.decompress(base64.b64decode(answer["mask_nifti_base64"]))
    return raw


def _decode(raw, tmp_path, name):
    p = tmp_path / name
    p.write_bytes(raw)
    return tnifti.load(str(p))


def test_upload_matches_jax(tmp_path):
    jc, tc = _configs(tmp_path)
    seg, cls = _weights()
    jp = JPredictor(jc, seg_variables=seg, cls_variables=cls)
    tp = Predictor(tc, seg_variables=seg, cls_variables=cls, device="cpu")
    ja = japp.BrainTumorApp(jc, upload_dir=str(tmp_path / "ju"),
                            predictor=jp)
    ta = tapp.BrainTumorApp(tc, upload_dir=str(tmp_path / "tu"),
                            predictor=tp, device="cpu")
    vol = _scan()
    scan = str(tmp_path / "scan.nii.gz")
    tnifti.save(scan, vol, affine=_affine())
    fields = {"return_mask": b"1",
              "file": ("scan.nii.gz", open(scan, "rb").read())}
    (js, ref), (ts, got) = _post(ja, fields), _post(ta, fields)
    assert js == ts == 200
    assert ref["success"] and got["success"]
    assert ref["degraded_mode"] is False and got["degraded_mode"] is False
    assert got["mask_grid"] == ref["mask_grid"] == "native"
    assert got["patient_info"]["filename"] == "scan.nii.gz"
    assert got["visualizations"].keys() == ref["visualizations"].keys()

    # labels under the margin contract, on each side's own preprocessing
    jvol, tvol = jpreprocess(scan, None), tpreprocess(scan, None, "cpu")
    rlog = np.asarray(jp._segment_logits(jp._canon(jvol), "cropped")[0])
    glog = tp._segment_logits(tp._canon(tvol), "cropped")[0].numpy()
    top2 = np.sort(rlog, axis=-1)
    margin = top2[..., -1] - top2[..., -2]
    drift = np.abs(glog - rlog).max()
    rraw, graw = _mask(ref), _mask(got)
    rm = _decode(rraw, tmp_path, "r.nii").data
    gm = _decode(graw, tmp_path, "g.nii").data
    assert gm.shape == rm.shape == vol.shape and gm.dtype == np.uint8
    offs, bucket = cropping.plan_crop(tp._canon(tvol), multiple=16,
                                      min_size=16)
    sl = tuple(slice(o, min(o + b, f))
               for o, b, f in zip(offs, bucket, vol.shape))
    inside = np.zeros(vol.shape, bool)
    inside[sl] = True
    np.testing.assert_array_equal(gm[~inside], rm[~inside])
    dis = gm[sl] != rm[sl]
    window = tuple(slice(0, s.stop - s.start) for s in sl)
    assert not (dis & (margin[window] > 2 * drift)).any(), drift
    agree = gm == rm
    assert agree.mean() >= 0.99 and (rm > 0).any()

    # the mask NIfTI: header bit-exact, voxels where the labels agree
    assert graw[:352] == rraw[:352]
    np.testing.assert_array_equal(gm[agree], rm[agree])
    if agree.all():
        assert graw == rraw

    # the report: JAX's report functions on the port's own labels,
    # confidence and scan spacing give the port's answer exactly
    labels, conf = tp.segment_with_confidence(tvol, mode="cropped")
    np.testing.assert_array_equal(labels, gm)
    name, cconf = tp.classify_tumor(tvol, labels)
    aff = tnifti.load_affine(scan)
    r = jreports.generate_clinical_report(
        jreports.calculate_medical_metrics(
            tvol, labels, confidence_map=conf,
            spacing_mm=tnifti.affine_spacing(aff),
            voxel_volume_mm3=tnifti.affine_voxel_volume(aff)),
        classifier_confidence=cconf)
    r["classification"]["model_classification"] = name
    for k in ("classification", "measurements", "quality_metrics",
              "clinical_notes"):
        assert _equal(got[k], r[k]), k
    # against JAX's answer: the same class; volumes apart by at most the
    # voxels whose labels differ
    gc, rc = got["classification"], ref["classification"]
    assert gc["model_classification"] == rc["model_classification"]
    assert abs(gc["confidence"] - rc["confidence"]) <= 2 ** -6
    vox = tnifti.affine_voxel_volume(aff)
    gv, rv = (float(a["measurements"]["tumor_volume"].split()[0])
              for a in (got, ref))
    assert abs(gv - rv) <= (~agree).sum() * vox + 0.05


def test_upload_four_modalities_npy(port_app):
    """A (D, H, W, 4) upload is served whole, pictures included (the
    JAX app answers 500 here: see test_meshes_and_pictures_match_jax)."""
    import io
    vol = np.stack([_scan(seed=s) for s in range(4)], axis=-1)
    buf = io.BytesIO()
    np.save(buf, vol)
    status, j = _post(port_app, {"return_mask": b"1",
                                 "file": ("four.npy", buf.getvalue())})
    assert status == 200 and j["success"] and j["degraded_mode"] is False
    assert j["mask_grid"] == "native"
    assert set(j["visualizations"]) == {"multiplanar", "analysis",
                                        "visualization_3d"}
    assert j["visualizations"]["multiplanar"].startswith("data:image/png")


def test_upload_whole_volume_with_tta(tmp_path):
    """``upload_mode="whole_volume"`` with mirror TTA: the scan is zoomed
    to the model size, so the mask is on the model grid."""
    _, tc = _configs(tmp_path, tta=True)
    tc = tc.replace(inference=dataclasses.replace(
        tc.inference, upload_mode="whole_volume"))
    seg, cls = _weights()
    a = tapp.BrainTumorApp(tc, upload_dir=str(tmp_path / "u"), device="cpu",
                           predictor=Predictor(tc, seg_variables=seg,
                                               cls_variables=cls,
                                               device="cpu"))
    raw = tnifti.encode(_scan(seed=5), affine=_affine())
    status, j = _post(a, {"return_mask": b"1",
                          "file": ("w.nii", raw)})
    assert status == 200 and j["degraded_mode"] is False
    assert j["mask_grid"] == "model"
    assert tnifti.encode(np.zeros(ROI, np.uint8))[:352] == _mask(j)[:352]


def test_demo_and_corrupt_uploads_degrade(port_app, caplog):
    status, j = _post(port_app, {"demo": b"1", "return_mask": b"1"})
    assert status == 200 and j["success"] and j["degraded_mode"] is True
    assert j["mask_grid"] == "model"            # never the scan's grid
    raw = _mask(j)
    assert raw[:352] == tnifti.encode(np.zeros(ROI, np.uint8))[:352]
    with caplog.at_level("WARNING", logger=tapp.logger.name):
        status, j = _post(port_app, {
            "return_mask": b"1",
            "file": ("broken.nii.gz", b"\x1f\x8b" + b"\x00" * 64)})
    assert status == 200 and j["success"] and j["degraded_mode"] is True
    assert j["mask_grid"] == "model"
    warned = [r for r in caplog.records if r.levelname == "WARNING"]
    assert warned and "real inference failed" in warned[0].getMessage()


def test_generate_synthetic_route(port_app, tmp_path):
    body = json.dumps({"num_samples": 1, "shape": [16, 16, 12]}).encode()
    status, _, payload = port_app.route(
        "POST", "/generate_synthetic_data", {}, body,
        {"content-type": "application/json"})
    j = json.loads(payload)
    assert status == 200 and j["success"] and j["num_samples"] == 1
    assert j["save_dir"].startswith(port_app.config.data_dir)
    status, _, payload = port_app.route(
        "POST", "/generate_synthetic_data", {},
        json.dumps({"save_dir": "../../escape"}).encode(), {})
    assert status == 400 and not json.loads(payload)["success"]


def test_warmup_then_one_request_over_a_socket(port_app):
    """warmup_app, then /health and a multipart .nii.gz /upload over a
    real socket, and the 413 refusal before the body is read."""
    tapp.warmup_app(port_app, native_shape=(24, 20, 20))
    assert port_app.warmup_state == "done"
    server = tapp.create_server("127.0.0.1", 0, app=port_app)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=30) as r:
            h = json.loads(r.read())
        assert h["warmup"] == "done" and h["models_loaded"] is True
        raw = tnifti.encode(_scan(seed=4), affine=_affine())
        body, headers = _multipart({"return_mask": b"1",
                                    "file": ("s.nii.gz",
                                             gzip.compress(raw))})
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/upload", body=body, headers={
            "Content-Type": headers["content-type"]})
        resp = conn.getresponse()
        j = json.loads(resp.read())
        conn.close()
        assert resp.status == 200 and j["degraded_mode"] is False
        assert j["mask_grid"] == "native"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.putrequest("POST", "/upload")
        conn.putheader("Content-Length", str(200 * 1024 * 1024))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413
        assert json.loads(resp.read())["error"] == "request body too large"
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
