"""Web serving tier of the port — stdlib HTTP server (counterpart of the
JAX package's ``serve/app.py``).

The same route surface and JSON contracts as the JAX app: the pages,
``/health`` (with the training ``sessions``), ``POST /upload`` (decode ->
preprocess on the device -> segment with confidence -> classify ->
metrics and clinical report -> pictures, optionally the label map as
base64 .nii.gz), ``/generate_synthetic_data`` and the training routes
``/start_training``, ``/training_progress`` and ``/stop_training``
(``serve/jobs.py``). Trained weights are adopted through
``train.checkpoints.adopt_trained_weights``.

An upload that cannot be decoded or analysed falls back to the explicit
synthetic demo analysis (``degraded_mode: true``), as in JAX; the
failure is logged at WARNING with its type and traceback, so a kernel
that fails to build or launch does not pass unseen.

Run: ``python -m segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.serve.app
[--host H] [--port P] [--warmup full|upload|off] [--device cuda|cpu]``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from . import templates
from .jobs import TrainingJobManager
from .reports import calculate_medical_metrics, generate_clinical_report

logger = logging.getLogger(__name__)

# upload cap (the JAX app's, the reference's MAX_CONTENT_LENGTH);
# requests past it are refused before the body is read
MAX_CONTENT_LENGTH = 100 * 1024 * 1024


# ---------------------------------------------------------------------------
# minimal multipart/form-data parser (stdlib only)
# ---------------------------------------------------------------------------

def parse_multipart(body: bytes, content_type: str) -> Dict[str, Dict]:
    """Returns {field: {'filename': str|None, 'data': bytes}}."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("no multipart boundary")
    boundary = m.group(1).encode()
    parts = body.split(b"--" + boundary)
    out: Dict[str, Dict] = {}
    for part in parts:
        # each part is "\r\n<headers>\r\n\r\n<data>\r\n"; the final
        # element is the "--\r\n" terminator. Remove exactly ONE
        # delimiter CRLF on each side: a binary payload may itself end
        # in 0x0A/0x0D.
        if part.startswith(b"--") or not part:
            continue
        part = part.removeprefix(b"\r\n")
        if b"\r\n\r\n" not in part:
            continue
        head, data = part.split(b"\r\n\r\n", 1)
        data = data.removesuffix(b"\r\n")
        headers = head.decode("utf-8", "replace")
        name_m = re.search(r'name="([^"]*)"', headers)
        file_m = re.search(r'filename="([^"]*)"', headers)
        if not name_m:
            continue
        out[name_m.group(1)] = {
            "filename": file_m.group(1) if file_m else None,
            "data": data,
        }
    return out


def resolve_under(root: str, user_path: Optional[str]) -> Optional[str]:
    """Resolve a client-supplied path against *root*, refusing escapes
    (the synthetic-data route takes a directory from unauthenticated
    JSON)."""
    if not user_path:
        return None
    root_abs = os.path.realpath(root)
    cand = os.path.realpath(os.path.join(root_abs, user_path))
    if cand != root_abs and not cand.startswith(root_abs + os.sep):
        raise ValueError(f"path escapes data root: {user_path!r}")
    return cand


def secure_filename(name: str) -> str:
    name = os.path.basename(name.replace("\\", "/"))
    name = re.sub(r"[^A-Za-z0-9._-]", "_", name)
    return name or "upload"


def _device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------

class BrainTumorApp:
    """Holds the predictor and the training sessions on one device; route
    logic lives here so it can be tested without sockets.

    Weights (``InferenceConfig.checkpoint``): "" adopts the newest
    compatible ``best_*`` checkpoint under ``models_dir`` and serves the
    seeded weights when there is none; "none" serves the seeded
    weights; a path adopts that checkpoint. ``weights`` in /health says
    which (the path, or ``random_init``). A path that holds no
    checkpoint raises ``FileNotFoundError`` here, and one that does not
    fit the model raises ``ValueError`` when the predictor is built:
    trained weights asked for are never replaced by random ones."""

    weights_source: str = "random_init"

    def __init__(self, config: Optional[Config] = None,
                 upload_dir: str = "uploads",
                 predictor=None, device="cuda"):
        self.config = config or Config()
        spec = self.config.inference.checkpoint
        if spec not in ("", "none") and not any(
                os.path.isfile(os.path.join(spec, *f)) for f in
                (("state", "state.pt"), ("params.pt",))):
            raise FileNotFoundError(f"checkpoint {spec!r} holds no "
                                    "checkpoint of the port")
        self.device = resolve_device(device)
        self.upload_dir = upload_dir
        os.makedirs(upload_dir, exist_ok=True)
        self._predictor = predictor
        self._predictor_lock = threading.Lock()
        self.warmup_state = "off"
        self.jobs = TrainingJobManager(self.config.models_dir, self.device)

    def _get_predictor(self):
        with self._predictor_lock:
            if self._predictor is None:
                from ..inference.predictor import Predictor
                logger.info("initializing models on %s",
                            _device_label(self.device))
                pred = Predictor(self.config, device=self.device)
                self._load_trained_weights(pred)
                self._predictor = pred
            return self._predictor

    def _load_trained_weights(self, predictor) -> None:
        """Adopt the configured checkpoint, or the newest compatible
        ``best_*`` under ``models_dir`` (web and CLI training feed
        serving)."""
        from ..train.checkpoints import adopt_trained_weights
        spec = self.config.inference.checkpoint
        path = adopt_trained_weights(predictor, spec,
                                     self.config.models_dir, logger)
        if path:
            self.weights_source = path
            logger.info("serving with trained weights from %s", path)
        elif spec not in ("", "none"):
            raise ValueError(f"checkpoint {spec!r} does not fit the "
                             "configured model")

    # ------------------------- routes -------------------------

    def route(self, method: str, path: str, query: Dict,
              body: bytes, headers: Dict) -> Tuple[int, str, str]:
        """Dispatch; returns (status, content_type, payload)."""
        try:
            if method == "GET":
                if path == "/":
                    return 200, "text/html", templates.index_page()
                if path == "/metrics":
                    return 200, "text/html", templates.metrics_page(
                        self.model_info())
                if path == "/documentation":
                    return 200, "text/html", templates.documentation_page()
                if path == "/training_progress":
                    return self._training_progress(query)
                if path == "/health":
                    return self._json({
                        "status": "ok",
                        "device": _device_label(self.device),
                        "models_loaded": self._predictor is not None,
                        "warmup": self.warmup_state,
                        "weights": self.weights_source,
                        "sessions": self.jobs.list_sessions(),
                    })
            if method == "POST":
                if path == "/upload":
                    return self._upload(body, headers)
                if path == "/start_training":
                    return self._start_training(body)
                if path == "/stop_training":
                    return self._stop_training(body)
                if path == "/generate_synthetic_data":
                    return self._generate_synthetic(body)
            return 404, "application/json", json.dumps(
                {"success": False, "error": f"no route {method} {path}"})
        except Exception as e:
            logger.error("route error: %s\n%s", e, traceback.format_exc())
            return 500, "application/json", json.dumps({
                "success": False, "error": str(e),
                "demo_available": True,
                "message": "Server analysis failed, but demo mode is "
                           "available",
            })

    def model_info(self) -> Dict:
        mc = self.config.model
        return {
            "device": _device_label(self.device),
            "architecture": "Attention-gated residual 3D U-Net "
                            "(deep supervision)",
            "features": str(tuple(mc.features)),
            "compute dtype": mc.compute_dtype,
            "inference": f"Gaussian sliding window "
                         f"{self.config.inference.roi_size}, overlap "
                         f"{self.config.inference.overlap}",
        }

    # ------------------------- helpers -------------------------

    @staticmethod
    def _json(obj, status: int = 200) -> Tuple[int, str, str]:
        return status, "application/json", json.dumps(obj)

    def _upload(self, body: bytes, headers: Dict) -> Tuple[int, str, str]:
        ctype = headers.get("content-type", "")
        fields = parse_multipart(body, ctype) if (
            "multipart" in ctype) else {}
        demo = fields.get("demo", {}).get("data", b"0") == b"1"
        return_mask = fields.get("return_mask",
                                 {}).get("data", b"0") == b"1"
        fobj = fields.get("file")
        filename = "synthetic_demo.nii"
        filepath = None
        ts = time.strftime("%Y%m%d_%H%M%S")

        try:
            if fobj and fobj.get("filename"):
                filename = fobj["filename"]
                # a uuid per upload: concurrent uploads of one name in
                # one second must not overwrite each other
                import uuid
                filepath = os.path.join(
                    self.upload_dir,
                    f"{ts}_{uuid.uuid4().hex[:8]}_"
                    f"{secure_filename(filename)}")
                with open(filepath, "wb") as f:
                    f.write(fobj["data"])

            analysis = self._analyze(filepath, demo,
                                     return_mask=return_mask)
            payload = {
                "success": True,
                "patient_info": {
                    "study_id": f"STU_{ts}",
                    "series_id": "SER_001",
                    "scan_date": time.strftime("%Y-%m-%d"),
                    "filename": filename,
                },
                **analysis,
            }
            return self._json(payload)
        finally:
            if filepath and os.path.exists(filepath):
                os.remove(filepath)

    def _analyze(self, filepath: Optional[str], demo: bool,
                 return_mask: bool = False) -> Dict:
        """The upload pipeline: ``_report`` plus the pictures (MPR
        overlay, volume dashboard, 3D reconstruction)."""
        out, vol, seg = self._report(filepath, demo, return_mask)
        from ..utils.visualization import ModernMedicalVisualizer

        t0 = time.perf_counter()
        viz = ModernMedicalVisualizer()
        out["visualizations"] = {
            "multiplanar": viz.create_segmentation_overlay(vol, seg),
            "analysis": viz.create_volume_analysis_dashboard(vol, seg),
            "visualization_3d": viz.create_3d_tumor_reconstruction(seg),
        }
        _log_phase("visualizations", t0)
        return out

    def _report(self, filepath: Optional[str], demo: bool,
                return_mask: bool = False
                ) -> Tuple[Dict, np.ndarray, np.ndarray]:
        """The upload pipeline up to the pictures: decode -> preprocess
        (on the device) -> segment (+confidence) -> classify -> metrics
        and clinical report (-> with ``return_mask``, the label map as
        base64 .nii.gz with the scan's affine). Returns the answer
        without ``visualizations``, and the volume and label map the
        pictures are drawn from. Logs each phase's host milliseconds at
        INFO as ``upload <phase>: <ms> ms``."""
        from ..data.synthetic import synthesize_volume

        t0 = time.perf_counter()
        size = self.config.data.image_size
        mode = self.config.inference.upload_mode
        vol = None
        cls_conf = None
        spacing_mm = None
        vox_mm3 = None
        in_affine = None
        if filepath and not demo:
            try:
                from ..data import nifti
                from ..data.dataset import load_any_volume
                from ..inference.predictor import preprocess_image
                raw = load_any_volume(filepath)
                if mode != "whole_volume":
                    # native resolution: clinical volumes and areas use
                    # the scan's voxel size (affine column norms);
                    # whole_volume resamples the grid, where the header
                    # spacing no longer applies
                    try:
                        in_affine = nifti.load_affine(filepath)
                        spacing_mm = nifti.affine_spacing(in_affine)
                        vox_mm3 = nifti.affine_voxel_volume(in_affine)
                    except ValueError:
                        pass          # not a NIfTI file: no affine
                t0 = _log_phase("decode", t0)
                # cropped / sliding_window segment at native resolution;
                # whole_volume zooms to the model size
                vol = preprocess_image(
                    raw, size if mode == "whole_volume" else None,
                    device=self.device)
                t0 = _log_phase("preprocess", t0)
                predictor = self._get_predictor()
                seg, conf = predictor.segment_with_confidence(
                    vol, mode=mode, tta=self.config.inference.tta)
                t0 = _log_phase("segment", t0)
                cls_name, cls_conf = predictor.classify_tumor(vol, seg)
                grade_pred = predictor.classify_grade(vol)
                t0 = _log_phase("classify", t0)
                quality_conf = conf
                degraded = False
            except Exception as e:
                logger.warning("real inference failed (%s: %s); falling "
                               "back to demo analysis", type(e).__name__,
                               e, exc_info=True)
                vol = None
        if vol is None:   # demo / degraded path: explicit, synthetic
            vol, seg = synthesize_volume(size, seed=0)
            quality_conf = None
            cls_name = None
            grade_pred = None
            degraded = True

        metrics = calculate_medical_metrics(
            vol, seg,
            confidence_map=None if degraded else quality_conf,
            spacing_mm=None if degraded else spacing_mm,
            voxel_volume_mm3=None if degraded else vox_mm3)
        report = generate_clinical_report(
            metrics, filename=filepath or "demo",
            classifier_confidence=cls_conf,
            model_grade=grade_pred[0] if grade_pred else None,
            grade_confidence=grade_pred[1] if grade_pred else None)
        if cls_name is not None:
            report["classification"]["model_classification"] = cls_name
        out = {
            "classification": report["classification"],
            "measurements": report["measurements"],
            "quality_metrics": report["quality_metrics"],
            "clinical_notes": report["clinical_notes"],
            "degraded_mode": degraded,
        }
        t0 = _log_phase("metrics+report", t0)
        if return_mask:
            import base64
            import gzip
            from ..data import nifti
            # the grid is the path's: native-resolution modes paste the
            # mask onto the input grid (its affine applies, when
            # readable); whole_volume resamples to the model grid; a
            # degraded answer is a synthetic model-grid mask and never
            # carries the scan's registration
            native_grid = not degraded and mode != "whole_volume"
            payload = gzip.compress(nifti.encode(
                np.asarray(seg).astype(np.uint8),
                affine=in_affine if native_grid else None))
            out["mask_nifti_base64"] = base64.b64encode(
                payload).decode("ascii")
            out["mask_grid"] = "native" if native_grid else "model"
            _log_phase("mask encode", t0)
        return out, vol, seg

    def _start_training(self, body: bytes) -> Tuple[int, str, str]:
        try:
            cfg = json.loads(body or b"{}")
        except json.JSONDecodeError:
            return self._json({"success": False,
                               "error": "invalid JSON"}, 400)
        try:
            safe_dir = resolve_under(self.config.data_dir,
                                     cfg.get("data_dir"))
        except ValueError as e:
            return self._json({"success": False, "error": str(e)}, 400)
        if safe_dir is not None:
            cfg["data_dir"] = safe_dir
        else:
            cfg.pop("data_dir", None)
        session_id = self.jobs.start_training_session(cfg)
        return self._json({
            "success": True, "session_id": session_id,
            "message": "Training started successfully",
        })

    def _stop_training(self, body: bytes) -> Tuple[int, str, str]:
        try:
            cfg = json.loads(body or b"{}")
        except json.JSONDecodeError:
            cfg = {}
        sid = cfg.get("session_id")
        ok = self.jobs.stop_training_session(sid) if sid else False
        return self._json({
            "success": True,
            "stopped": ok,
            "message": "Training stopped" if ok else
                       "No such session; nothing to stop",
        })

    def _training_progress(self, query: Dict) -> Tuple[int, str, str]:
        sid = (query.get("session_id") or ["demo"])[0]
        progress = self.jobs.get_training_progress(sid)
        if progress is None:
            return self._json({"status": "not_found",
                               "error": f"unknown session {sid}"}, 404)
        return self._json(progress)

    def _generate_synthetic(self, body: bytes) -> Tuple[int, str, str]:
        from ..data.synthetic import create_enhanced_synthetic_data
        try:
            cfg = json.loads(body or b"{}")
        except json.JSONDecodeError:
            cfg = {}
        # unauthenticated JSON on a 0.0.0.0 socket: cap the magnitudes
        n = max(1, min(int(cfg.get("num_samples", 100)), 500))
        try:
            out_dir = resolve_under(self.config.data_dir,
                                    cfg.get("save_dir"))
        except ValueError as e:
            return self._json({"success": False, "error": str(e)}, 400)
        if out_dir is None:
            out_dir = os.path.join(self.config.data_dir,
                                   "synthetic", "BraTS2024")
        shape = tuple(max(8, min(int(s), 256))
                      for s in cfg.get("shape", (96, 96, 64)))[:3]
        create_enhanced_synthetic_data(n, out_dir, shape=shape)
        return self._json({
            "success": True, "num_samples": n, "save_dir": out_dir,
            "message": f"Generated {n} synthetic BraTS samples",
        })


def _log_phase(phase: str, t0: float) -> float:
    """Log the host milliseconds since ``t0`` of one upload phase;
    returns the clock for the next."""
    now = time.perf_counter()
    logger.info("upload %s: %.3f ms", phase, (now - t0) * 1e3)
    return now


# ---------------------------------------------------------------------------
# HTTP plumbing
# ---------------------------------------------------------------------------

def make_handler(app: BrainTumorApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.address_string(), *args)

        def _serve(self, method):
            parsed = urlparse(self.path)
            query = parse_qs(parsed.query)
            length = int(self.headers.get("Content-Length") or 0)
            if length > MAX_CONTENT_LENGTH:
                data = json.dumps({
                    "error": "request body too large",
                    "max_bytes": MAX_CONTENT_LENGTH}).encode()
                self.send_response(413)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(data)
                return
            body = self.rfile.read(length) if length else b""
            headers = {k.lower(): v for k, v in self.headers.items()}
            status, ctype, payload = app.route(
                method, parsed.path, query, body, headers)
            data = payload.encode() if isinstance(payload, str) else payload
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._serve("GET")

        def do_POST(self):
            self._serve("POST")

    return Handler


def create_server(host: str = "0.0.0.0", port: int = 5000,
                  config: Optional[Config] = None,
                  app: Optional[BrainTumorApp] = None,
                  device="cuda") -> ThreadingHTTPServer:
    app = app or BrainTumorApp(config, device=device)
    server = ThreadingHTTPServer((host, port), make_handler(app))
    server.app = app   # type: ignore[attr-defined]
    return server


def warmup_app(app, native_shape=(240, 240, 155)) -> None:
    """Run once what the upload route will run, so the first upload
    does not pay the models' construction and the library's first
    calls. ``main`` runs it in a background thread; its state shows at
    ``/health``."""
    policy = app.config.inference.warmup
    if policy not in ("full", "upload", "off"):
        # a typo'd policy must not silently degrade to a lazier warmup
        app.warmup_state = (f"failed: unknown warmup policy "
                            f"{policy!r} (use full|upload|off)")
        logger.warning("%s", app.warmup_state)
        return
    if policy == "off":
        app.warmup_state = "skipped"
        return
    app.warmup_state = "running"
    try:
        pred = app._get_predictor()
        size = app.config.data.image_size
        zeros = np.zeros(size, np.float32)
        mode = app.config.inference.upload_mode
        if policy == "full" or mode == "whole_volume":
            pred.segment_with_confidence(zeros, mode="whole_volume")
        pred.classify_tumor(zeros)
        if mode != "whole_volume":
            # native-resolution path: a skull-stripped-shaped fixture,
            # so the crop bucket matches a typical BraTS brain
            native = tuple(native_shape)
            vol = np.zeros(native, np.float32)
            c = [s // 2 for s in native]
            # brain fills ~62% / 75% / 85% of each axis (BraTS-typical)
            semi = tuple(max(2.0, f * s) for f, s in
                         zip((0.31, 0.375, 0.43), native))
            zz, yy, xx = np.ogrid[:native[0], :native[1], :native[2]]
            brain = (((zz - c[0]) / semi[0]) ** 2 +
                     ((yy - c[1]) / semi[1]) ** 2 +
                     ((xx - c[2]) / semi[2]) ** 2) < 1.0
            vol[brain] = 0.5
            pred.segment_with_confidence(vol, mode=mode)
        app.warmup_state = "done"
        logger.info("inference warmup complete")
    except Exception as e:
        app.warmup_state = f"failed: {e}"
        logger.warning("warmup failed (serving anyway): %s: %s",
                       type(e).__name__, e, exc_info=True)


def main(host: str = "0.0.0.0", port: int = 5000,
         config: Optional[Config] = None, device="cuda"):
    """Serve until interrupted; the warmup (``InferenceConfig.warmup``)
    runs in a background thread, so the socket answers at once."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    server = create_server(host, port, config=config, device=device)
    threading.Thread(target=warmup_app, args=(server.app,),
                     daemon=True, name="warmup").start()
    print("=" * 60)
    print("Brain Tumor Segmentation System (PyTorch/CUDA)")
    print(f"Serving at http://{host}:{port} on "
          f"{_device_label(server.app.device)}")
    print("=" * 60)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nServer stopped by user")
    finally:
        server.server_close()


if __name__ == "__main__":
    import argparse
    from dataclasses import replace
    _ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    _ap.add_argument("--host", default="0.0.0.0")
    _ap.add_argument("--port", type=int, default=5000)
    _ap.add_argument("--warmup", choices=("full", "upload", "off"),
                     default=None,
                     help="startup policy (InferenceConfig.warmup): full "
                          "= whole-volume and upload-mode requests, "
                          "upload = only what /upload runs, off = none")
    _ap.add_argument("--device", default="cuda",
                     help="torch device to serve on (default cuda)")
    _args = _ap.parse_args()
    _cfg = None
    if _args.warmup is not None:
        _base = Config()
        _cfg = replace(_base, inference=replace(_base.inference,
                                                warmup=_args.warmup))
    main(host=_args.host, port=_args.port, config=_cfg,
         device=_args.device)
