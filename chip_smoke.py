#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device and
the CUDA toolkit. Imports no JAX. Phases, each printing its seconds:

  1. build  — compile the port's kernels (one nvcc per source, all at
     once, then a link) and load them;
  2. kernels — each kernel against its plain PyTorch version at the
     serving path's shapes (batch 4 windows of 128^3), the level-1
     region's call forms included, and K1 at co = 128 (the level-1
     width of HighQualityConfig); K1 also run twice at each form (output
     and statistics bit-identical), with its launch geometry there and
     its kernels' registers, spills and C7513 notes from the build log;
  3. slice  — a full-width Predictor (ps2d_eval=True, ps2d_levels=1,
     random weights from a seed) segments three synthetic 240x240x155
     volumes in "cropped" mode; every kernel of that path must have
     launched, as often as the forward predicts; then one batch of
     windows through the kernel path is held against the port's
     normal path on the card;
  4. server — the server's request at the measured serving setting
     (ps2d_eval=True, ps2d_levels=2; joint grade weights from the
     port's own seeded init): segment_with_confidence("cropped"),
     classify_tumor and classify_grade on three volumes, then one
     mirror-TTA request and one "whole_volume" request, each with its
     launch counts asserted; then the level-2 kernel path against the
     normal path;
  5. app — the web server itself (``serve/app.py``, full width,
     ps2d_levels=2, upload_mode "cropped", seeded weights): started on a
     local port in a thread, warmed up (``/health`` must say so), then
     three 240x240x155x4 .nii.gz uploads (the volumes above, written by
     the port's NIfTI codec) POSTed with return_mask=1 through
     http.client. Each answer must be HTTP 200, not degraded, its mask a
     native-grid 240x240x155 label map equal to the predictor's labels
     on the same preprocessed volume; the clip bounds on the card equal
     the CPU's bit for bit and the z-score is within 1e-5 max|x| of the
     CPU's; the launches per upload are the server phase's. It prints
     each upload's host ms by phase (decode, preprocess, segment,
     classify, metrics+report, mask encode, visualizations) and its
     wall time. Without matplotlib the uploads run the app's
     ``_report`` (everything before the pictures), and it says so;
  6. train — the train step at full width (UNet3D(ps2d_train=True), remat,
     Config() defaults: deep-supervision combined loss, AdamW 1e-4 with
     SGDR) on a batch 2 of 4x128^3: five steps with dropout, the losses
     finite and falling, K1 launched 7 times a step (3 forwards, 4 data
     gradients) and K2-K4 never; K6's forward, data and weight
     gradients against their plain versions at the region's three call
     forms, a cotangent with garbage on the halo; the kernel path's
     loss and gradients against the normal path's; one grad_accum=2
     step against the full batch; one joint step and one eval step;
  7. groupnorm — K5 through its entry point ``fused_group_norm`` at
     the DoubleConv tail's forms (4x128^3x32 GN8 with ReLU, the same
     with the residual, 240x240x160x32 with both, in bf16; one f32
     form), 3 launches a call; each against its plain version, and two
     runs bit-identical;
  8. wtile — K7 through its entry point ``wtile_conv3d`` at
     benchmarks/bench_wtile.py's nine shapes (batch 1, bf16), and its
     VJP at the first shape (forward and data gradient on K7, 11
     launches in all); each shape's launch geometry (blocks, shared
     memory) and the kernels' registers and spills; the kernel against
     its plain version and two runs bit-identical at all nine shapes,
     the VJP against autograd through the plain version;
  9. timings — CUDA-event times of each kernel (and of each of its
     call forms), its plain version and one library call computing the
     same function, beside its bound; K6's and K7's forward, data
     gradient and weight gradient apart, and the train step's time and
     peak memory; the card's clocks, temperature and power before and
     after them.

Phases 10-13, the later slices', run after the timings, so that the
kernels' readings are taken as in the runs before them:

  10. f32 — compute_dtype "float32" on the normal path (the region off):
     one cropped request on the first volume, no kernel launched, the
     TF32 settings as they were; its labels agree with the bf16 serving
     request's wherever the top-2 margin exceeds twice the largest logit
     drift; one window batch (4 x 128^3) of it against float64 on the
     card within 1e-4 max(scale, 1) (the same batch with TF32 let in is
     printed beside it);
  11. trainer — ModernBrainTumorTrainer at full width: a synthetic
     cohort of six 240x240x155x4 .nii.gz cases (4 train, 2 val) written
     to a temporary directory (its seconds printed apart), the port's
     loader (patch mode, 2 x 128^3 train batches, whole-volume 128^3
     validation), two epochs of UNet3D(ps2d_train, ps2d_eval,
     ps2d_levels=2, remat) at Config() defaults: every loss finite, K1 7
     launches per train step and K2-K4 none, each validation forward the
     level-2 forward's K1 7 / K2 2 / K3 2 / K4 1; the best_ checkpoint
     reloaded bit for bit (params, batch_stats, opt_state, step) and
     adopted by a Predictor (ps2d_levels=2) whose labels on a volume
     equal those of one handed the trainer's weights; the first
     validation batch (2 x 128^3) through the evaluated weights' kernel
     path against their normal path under the JAX ps2d bounds; it prints
     the CUDA-event ms and the host enqueue ms per train step, the loader
     wait per step, the validation epochs,
     the checkpoint's save and load ms and size, and the peak memory;
  12. webtrain — the app's training routes over HTTP: a real session on
     the card (2 epochs, 4 synthetic samples, 64^3) polled through
     /training_progress to completed, its best_web_ checkpoint on disk,
     no kernel launched (the web sessions train without the region, as
     JAX's); a second session stopped by /stop_training; /health lists
     both;
  13. f32region — the f32 forms of K1-K4, K6 and K7: each against its
     plain version at the serving shapes (K3, K4 bit-exact; K1's six
     forms, K2's two levels, K6's three forms and K7's nine shapes plus
     its VJP within 1e-5 max|ref|; K1's output and statistics, K2 and K7
     bit-identical over two runs); the server's request on a full-width
     Predictor(compute_dtype="float32", ps2d_eval, ps2d_levels=2) with K1
     14 / K2 4 / K3 4 / K4 2 launches, one window batch of it within
     1e-4 max(scale, 1) of the f32 normal path (TF32 off) given K1's
     weights rounded to bf16, the same function; five f32 train steps at
     ps2d_train (K1 7 launches a step, losses finite), the loss and every
     gradient against that normal path (cosine >= 0.9999); the f32
     request and train step timed beside the normal path's, and the f32
     forms' rows of the kernels line;

Phase 14, after them all:

  14. cli — the headless batch path: the host library (built beside the
     kernels in phase build; g++, OpenMP and zlib.h checked, its threads
     printed), the three volumes as a BraTS-layout cohort (int16 .nii.gz
     at gzip level 1, a uint8 seg with enhancing tumour stored as 4, one
     case at 1x1x1.5 mm), every file's native decode bit-equal to the
     NumPy codec; pass A, ``predict_main`` as users run it (the default
     preset, region off: no launch), each mask and confidence bit-equal
     to ``Predictor.segment_with_confidence``; pass B through the seam
     ``_predict`` at ps2d_eval, ps2d_levels=2 with --report
     --brats_labels --format nii.gz: K1 14 / K2 4 / K3 4 / K4 2 launches
     a case, masks bit-equal to the predictor's labels with 3 -> 4, each
     mask's affine its input's, every report with GT quality metrics;
     then ``evaluate_main`` on pass B's masks, each case equal to
     ``evaluate_case`` on the arrays; each case's host ms by stage and
     each pass's wall per case. The app and trainer phases print which
     reader decoded their files;

It prints the per-kernel JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failure, or a run past
its own time budget, exits non-zero without that last line.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import traceback

import numpy as np

BUDGET_S = 540.0          # the whole run, build included
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
VOLUME_SHAPE = (240, 240, 155)
# K7's entry point at benchmarks/bench_wtile.py's nine (ci, co, D, H, W)
K7_SHAPES = [(32, 32, 240, 240, 160), (64, 32, 240, 240, 160),
             (32, 64, 120, 120, 80), (64, 64, 120, 120, 80),
             (128, 64, 120, 120, 80), (64, 128, 60, 60, 40),
             (128, 128, 60, 60, 40), (256, 256, 30, 30, 20),
             (512, 512, 15, 15, 10)]
PKG = "segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch"
REF = "segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu"


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def make_volume(rng: np.random.Generator) -> np.ndarray:
    """One skull-stripped (240, 240, 155, 4) float32 volume: a brain
    ellipsoid with BraTS-typical extents, a modality-contrasted tumour
    blob, exact zeros outside (the benchmark's ``make_volume``)."""
    D, H, W = VOLUME_SHAPE
    center = np.array([D / 2, H / 2, W / 2]) + rng.uniform(-6, 6, 3)
    semi = np.array([rng.uniform(70, 78), rng.uniform(85, 95),
                     rng.uniform(62, 70)])
    zz, yy, xx = np.ogrid[:D, :H, :W]
    dist = (((zz - center[0]) / semi[0]) ** 2 +
            ((yy - center[1]) / semi[1]) ** 2 +
            ((xx - center[2]) / semi[2]) ** 2)
    brain = dist < 1.0
    vol = np.zeros((*VOLUME_SHAPE, 4), np.float32)
    tissue = rng.normal(0.5, 0.1, (int(brain.sum()), 4)).astype(np.float32)
    tc = center + rng.uniform(-0.3, 0.3, 3) * semi
    tr = rng.uniform(12, 28)
    tumor = (((zz - tc[0]) ** 2 + (yy - tc[1]) ** 2 +
              (xx - tc[2]) ** 2) < tr ** 2) & brain
    vol[brain] = tissue
    vol[tumor] += np.array([0.8, 0.2, 0.6, 0.4], np.float32)
    return vol


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS):
    """Least time for the work: the larger of the bytes over the HBM
    rate and the operations over their peak (bf16 on the tensor cores by
    default; ``f32_peak()`` for the f32 forms)."""
    tb, tf = nbytes / PEAK_HBM_BYTES * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def f32_peak() -> float:
    """The card's f32 FMA peak without tensor cores: 132 SMs x 128 lanes x
    2 FLOPs x the SM clock ``nvidia-smi`` reports as its maximum (1980
    MHz, 66.9 TFLOP/s, on an H100 SXM)."""
    q = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60)
    return 132 * 128 * 2 * float(q.stdout.split()[0]) * 1e6


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def grads_directional(got: dict, ref: dict) -> tuple:
    """Per-leaf cosine >= 0.9 and norm ratio in [0.5, 2] (JAX's rule for
    its kernel path, tests/test_ps2d.py:538-606), leaves of fewer than 8
    values or of norm below 1e-6 skipped; ``head_conv.bias`` feeds a
    BatchNorm on batch statistics, so its gradient is zero in exact
    arithmetic: only its smallness is checked. Returns (leaves checked,
    least cosine, least ratio, largest ratio)."""
    n, cmin, rmin, rmax = 0, 1.0, float("inf"), 0.0
    for k, b in ref.items():
        a = got[k]
        if a is None or b is None:
            check(a is None and b is None, f"gradient of {k} on one side")
            continue
        check(bool(a.isfinite().all()), f"non-finite gradient {k}")
        a, b = a.float().reshape(-1), b.float().reshape(-1)
        if k == "head_conv.bias":
            check(a.norm() <= 1e-2 * got["head_conv.kernel"].float().norm(),
                  "head_conv.bias gradient not ~0")
            continue
        na, nb = a.norm().item(), b.norm().item()
        if a.numel() < 8 or na < 1e-6 or nb < 1e-6:
            continue
        c = (a @ b).item() / (na * nb)
        n, cmin = n + 1, min(cmin, c)
        rmin, rmax = min(rmin, na / nb), max(rmax, na / nb)
        check(c >= 0.9 and 0.5 <= na / nb <= 2.0,
              f"gradient of {k}: cosine {c:.4f}, norm ratio {na / nb:.4f}")
    return n, cmin, rmin, rmax


class Run:
    def __init__(self):
        self.t0 = time.perf_counter()

    def phase(self, name, fn):
        t = time.perf_counter()
        print(f"== phase {name}", flush=True)
        out = fn()
        now = time.perf_counter()
        print(f"== phase {name}: {now - t:.2f} s (total {now - self.t0:.2f} s)",
              flush=True)
        check(now - self.t0 <= BUDGET_S,
              f"past the {BUDGET_S:.0f} s budget after phase {name}")
        return out


def card_state() -> str:
    """The card's SM and memory clocks, temperature, power draw and
    active clock-event reasons, as ``nvidia-smi`` reads them."""
    out = []
    # the reasons' field has two names, the newer drivers' first
    for fields in ("clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,"
                   "power.draw", "clocks_event_reasons.active",
                   "clocks_throttle_reasons.active"):
        q = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        if q.returncode == 0:
            out.append(f"{fields}: {q.stdout.strip()}")
            if "reasons" in fields:
                break
    return "; ".join(out)


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_request(pred, vol, cropping) -> None:
    """Where one server request's time goes: the host steps of
    ``segment_with_confidence("cropped")`` timed one by one, the two
    classifications, then the whole request under ``torch.profiler`` for
    the device's busy share and its top kernels. Opt-in
    (``--profile``)."""
    import torch

    ic = pred.config.inference

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"  {name}: {(time.perf_counter() - t) * 1e3:.2f} ms")
        return out

    v = timed("canon", lambda: pred._canon(vol))
    offs, bucket = timed("plan_crop", lambda: cropping.plan_crop(
        v, multiple=16, min_size=min(ic.roi_size),
        ladder=ic.crop_bucket_ladder))
    crop = timed("extract_crop", lambda: cropping.extract_crop(v, offs,
                                                               bucket))
    logits = timed("sliding window (copy in, forwards, blend)",
                   lambda: pred._sliding_window(crop))
    conf, labels = timed("softmax + max + copy out", lambda: [
        t.cpu().numpy() for t in torch.softmax(logits, -1).max(-1)])
    seg = timed("paste_full (labels, confidence)", lambda: (
        cropping.paste_full(labels.astype(np.int8), offs, v.shape[:3]),
        cropping.paste_full(conf, offs, v.shape[:3], fill=1.0)))[0]
    timed("classify_tumor", lambda: pred.classify_tumor(vol, seg))
    timed("classify_grade", lambda: pred.classify_grade(vol))

    def request():
        seg, _ = pred.segment_with_confidence(vol, mode="cropped")
        pred.classify_tumor(vol, seg)
        pred.classify_grade(vol)

    device_profile(request, "request")


def device_profile(fn, label: str, top: int = 15) -> None:
    """``fn`` once under ``torch.profiler``: its wall time, the device's
    busy time and idle share, the ``top`` kernels by device time and the
    port's own kernels below them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kern) / 1e3
    print(f"  profiled {label}: {wall:.2f} ms wall, device busy "
          f"{busy:.2f} ms, idle share {1 - busy / wall:.4f}")
    ranked = sorted(kern, key=dev_us, reverse=True)
    for e in ranked[:top]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    # the port's own kernels (anonymous namespaces) below the top ones
    for e in ranked[top:]:
        if "(anonymous namespace)::" in e.key:
            print(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
                  f"{e.key[:90]} (below the top {top})")


def main() -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also break one server request and one train "
                         "step down (host steps, device busy share, top "
                         "kernels)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    before = set(sys.modules)
    try:
        from importlib import import_module
        T = import_module(PKG + ".ops.ps2d")
        GN = import_module(PKG + ".ops.groupnorm")
        K7 = import_module(PKG + ".ops.conv3d")
        native = import_module(PKG + ".ops.native")
        cfg = import_module(PKG + ".config")
        train_mod = import_module(PKG + ".train")
        Predictor = import_module(PKG + ".inference.predictor").Predictor
        models = import_module(PKG + ".models")
        cropping = import_module(PKG + ".inference.cropping")
        sw = import_module(PKG + ".inference.sliding_window")
        for m in (".serve.app", ".data.nifti", ".ops.stats",
                  ".train.trainer", ".train.checkpoints", ".data.pipeline",
                  ".serve.jobs", ".data.native", ".inference.cli",
                  ".inference.evaluate"):
            import_module(PKG + m)     # the later phases', in the JAX check
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    pulled = {m.split(".")[0] for m in set(sys.modules) - before}
    check(not pulled & {"jax", "jaxlib", "flax", REF},
          f"the port imported JAX or the JAX package: {sorted(pulled)}")
    import torch.nn.functional as F
    # plain references in full f32 where they compute in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    run = Run()
    report = {}

    # ---------------------------------------------------------------- 1
    def build():
        """The kernels (one nvcc per source) and, beside them in a thread,
        the host library (g++, ``data/native.py``)."""
        import logging
        import threading
        hn = import_module(PKG + ".data.native")
        host = {}

        class Warned(logging.Handler):
            def emit(self, record):
                host.setdefault("log", record.getMessage())

        def build_host():
            handler = Warned(logging.WARNING)
            hn.logger.addHandler(handler)
            t = time.perf_counter()
            try:
                host["ok"] = hn.get_lib() is not None
            finally:
                host["s"] = time.perf_counter() - t
                hn.logger.removeHandler(handler)
        thread = threading.Thread(target=build_host)
        thread.start()
        b = native.build()
        print(f"nvcc: {b.seconds:.2f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print("  " + line.strip())
        native.library()
        thread.join()
        report["host_build_s"] = host["s"]
        report["host_build_log"] = " ".join(
            host.get("log", "no message").split())[:600]
        print(f"g++ (host library): {host['s']:.2f} s, "
              f"{'loaded' if host.get('ok') else 'unavailable'}")
        return b
    built = run.phase("build", build)

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, s=1.0, dtype=bf16):
        return (torch.randn(shape, device=dev, generator=g) * s).to(dtype)

    def ulp(m):
        return 2.0 ** (np.floor(np.log2(m)) - 7)     # 1 bf16 ulp at m

    B, S, C = 4, 128, 32    # one sw batch of 128^3 windows, level-0 width
    S1, C1 = S // 2, 2 * C  # level 1: 64^3 interior, width 64
    # K2's two request forms: level -> (input side, ci, co)
    k2_levels = {"level 0": (S // 2, 2 * C, C), "level 1": (S // 4, 4 * C, C1)}

    def k1_forms(dtype):
        """K1's call forms at the serving shapes, inputs in ``dtype``:
        name -> keyword arguments, the level-0 ones first."""
        def mask(s, c):
            return T.pack_halo_plain(torch.rand(
                (B, s, s, s, c), device=dev, generator=g).to(dtype))

        def r(shape, s=1.0):
            return rnd(shape, s, dtype)

        h0 = [T.pack_halo_plain(r((B, S, S, S, C))) for _ in range(2)]
        h1 = [T.pack_halo_plain(r((B, S1, S1, S1, c)))
              for c in (C, C1, C1)]
        return {
            "enc0.conv2/dec0.conv2 (1 input 32, affine+relu, stats)": dict(
                xs=(h0[0],), w=r((3, 3, 3, C, C), (2 / (27 * C)) ** 0.5),
                in_scale=1 + r((B, C), 0.3), in_shift=r((B, C), 0.3),
                in_relu=True),
            "dec0.conv1 (2 inputs 32+32, mask, stats)": dict(
                xs=(h0[0], h0[1]),
                w=r((3, 3, 3, 2 * C, C), (2 / (27 * C)) ** 0.5),
                in_mul0=mask(S, C)),
            "enc1.conv1 (1 input 32 -> 64, stats)": dict(
                xs=(h1[0],), w=r((3, 3, 3, C, C1), (2 / (27 * C1)) ** 0.5)),
            "enc1.conv2/dec1.conv2 (1 input 64, affine+relu, stats)": dict(
                xs=(h1[1],), w=r((3, 3, 3, C1, C1), (2 / (27 * C1)) ** 0.5),
                in_scale=1 + r((B, C1), 0.3), in_shift=r((B, C1), 0.3),
                in_relu=True),
            "dec1.conv1 (2 inputs 64+64, mask, stats)": dict(
                xs=(h1[1], h1[2]),
                w=r((3, 3, 3, 2 * C1, C1), (2 / (27 * C1)) ** 0.5),
                in_mul0=mask(S1, C1)),
            # any 32-multiple co (two channel tiles of 64): the level-1
            # width of HighQualityConfig, features (64, 128, ...)
            "co=128 (1 input 128 -> 128 at 64^3, affine+relu, stats)": dict(
                xs=(T.pack_halo_plain(r((B, S1, S1, S1, 2 * C1))),),
                w=r((3, 3, 3, 2 * C1, 2 * C1), (2 / (27 * 2 * C1)) ** 0.5),
                in_scale=1 + r((B, 2 * C1), 0.3),
                in_shift=r((B, 2 * C1), 0.3), in_relu=True),
        }

    # ---------------------------------------------------------------- 2
    def kernels():
        x3 = rnd((B, S, S, S, C))
        got, ref = T.pack_halo(x3), T.pack_halo_plain(x3)
        err = (got.float() - ref.float()).abs().max().item()
        print(f"pack_halo (4,128^3,32): max_abs_err {err} (tolerance 0)")
        check(err == 0, "pack_halo differs from its plain version")
        report["pack_halo"] = {"max_abs_err": err}

        x4 = ref          # (4,130^3,32) halo tensor, the level-0 skip
        got, ref = T.pool_into_halo(x4), T.pool_into_halo_plain(x4)
        err = (got.float() - ref.float()).abs().max().item()
        print(f"pool_into_halo (4,130^3,32)->(4,66^3,32): max_abs_err {err}"
              f" (tolerance 0)")
        check(err == 0 and torch.equal(got, ref),
              "pool_into_halo differs from its plain version")
        report["pool_into_halo"] = {"max_abs_err": err}

        k2 = {}
        worst = 0.0
        for lvl, (d2, ci, co) in k2_levels.items():
            x2, w2 = rnd((B, d2, d2, d2, ci)), rnd((2, 2, 2, ci, co), 0.1)
            b2 = rnd((co,), 0.1, torch.float32)
            # NaNs in the allocator's next block of the output's size, so
            # that a halo voxel the kernel leaves unwritten shows
            torch.full((B, *(2 * d2 + 2,) * 3, co), float("nan"),
                       dtype=bf16, device=dev)
            got = T.up_k2s2_into_halo(x2, w2, b2)
            same = torch.equal(got, T.up_k2s2_into_halo(x2, w2, b2))
            ref = T.up_k2s2_into_halo_plain(x2, w2, b2)
            err = (got.float() - ref.float()).abs().max().item()
            m = ref.float().abs().max().item()
            zero = (got.float() * (1 - T.halo_mask(got).float())).abs(
                ).max().item() == 0
            shape = (f"(4,{d2}^3,{ci})->(4,{2 * d2 + 2}^3,{co})")
            print(f"up_k2s2_into_halo {lvl} {shape}: max_abs_err {err} "
                  f"(tolerance {ulp(m)}: 1 bf16 ulp of max|ref| {m}); halo "
                  f"exactly zero: {zero}; two runs bit-identical: {same}; "
                  f"launch {T.up_k2s2_plan(B, d2, d2, d2, ci, co)}")
            check(err <= ulp(m),
                  f"up_k2s2_into_halo {lvl} differs from its plain version")
            check(zero, f"up_k2s2_into_halo {lvl}: the halo is not zero")
            check(same, f"up_k2s2_into_halo {lvl}: two runs differ")
            del got, ref
            worst = max(worst, err)
            k2[lvl] = (x2, w2, b2, shape)
        report["up_k2s2_into_halo"] = {"max_abs_err": worst}

        forms = k1_forms(bf16)
        worst = 0.0
        for name, kw in forms.items():
            y, (s1, s2) = T.conv3d_halo(emit_stats=True, **kw)
            y2, (t1, t2) = T.conv3d_halo(emit_stats=True, **kw)
            yr, (r1, r2) = T.conv3d_halo_plain(emit_stats=True, **kw)
            torch.cuda.synchronize()
            err = (y.float() - yr.float()).abs().max().item()
            tol = 2 ** -7 * yr.float().abs().max().item()
            serr = max(((s - r).abs().max() / r.abs().max()).item()
                       for s, r in ((s1, r1), (s2, r2)))
            # no float atomics: a second run gives the same bits
            same = (torch.equal(y, y2) and torch.equal(s1, t1)
                    and torch.equal(s2, t2))
            xs = kw["xs"]
            geo = T.conv3d_halo_plan(
                xs[0].shape[0], *(n - 2 for n in xs[0].shape[1:4]),
                xs[0].shape[-1], sum(x.shape[-1] for x in xs[1:]),
                kw["w"].shape[-1])
            print(f"conv3d_halo {name}: max_abs_err {err} (tolerance {tol}"
                  f" = 2^-7 max|ref|); stats rel err {serr} (tolerance 1e-3)"
                  f"; two runs bit-identical (y, stats): {same}; launch "
                  f"{geo}")
            check(err <= tol and serr <= 1e-3,
                  f"conv3d_halo {name} differs from its plain version")
            check(same, f"conv3d_halo {name}: two runs differ")
            worst = max(worst, err)
            del y2, yr
        # K1's kernels: registers and spills, and ptxas's notes of
        # serialised wgmmas (C7513), from the build log
        log = built.log.splitlines()
        if not log:
            print("ps2d_conv3d kernels: build reused, no ptxas report")
        for i, line in enumerate(log):
            if "entry function" in line and "ps2d_conv3d" in line:
                info = [x.strip().removeprefix("ptxas info    : ")
                        for x in log[i + 1:i + 4]
                        if "Used" in x or "spill" in x]
                print(f"  {line.split(chr(39))[1]}: {'; '.join(info)}")
            elif "C7513" in line and "ps2d_conv3d" in line:
                print("  " + line.strip())
        report["conv3d_halo"] = {"max_abs_err": worst}
        return forms, (x3,), k2, x4
    forms, k3_in, k2_in, k4_in = run.phase("kernels", kernels)

    counted = (T.conv3d_halo, T.up_k2s2_into_halo, T.pack_halo,
               T.pool_into_halo, GN.fused_group_norm, K7.conv3d_same)

    def launches_of(**nonzero):
        """A launch count for every kernel: ``nonzero``'s, else 0."""
        return {k.__name__: nonzero.get(k.__name__, 0) for k in counted}

    def request_counts(fn):
        """Run ``fn`` with every launch count at 0 just before it; its
        result and the counts just after."""
        torch.cuda.synchronize()
        for k in counted:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k.__name__: k.launches for k in counted}

    def hold_to_normal(model, vol, conf, label):
        """One batch of 4 windows of ``vol``'s crop through ``model``'s
        kernel path against the port's normal path (no kernels), same
        weights, under the JAX ps2d bounds."""
        offs, bucket = cropping.plan_crop(
            vol, multiple=16, min_size=S,
            ladder=conf.inference.crop_bucket_ladder)
        crop = torch.from_numpy(
            cropping.extract_crop(vol, offs, bucket)).to(dev)
        starts = [sw.compute_patch_starts(d, S, 0.5) for d in bucket]
        wins = [(a, b, c) for a in starts[0] for b in starts[1]
                for c in starts[2]][:4]
        x = torch.stack([crop[a:a + S, b:b + S, c:c + S]
                         for a, b, c in wins])
        out = model(x).float()
        normal = models.UNet3D(ps2d_eval=False, seed=0)
        normal.eval()
        ref = normal(x).float()
        del normal
        compare_to_normal(out, ref, label, tuple(x.shape))

    def compare_to_normal(out, ref, label, shape):
        """Kernel-path logits against the normal path's on the same
        input and weights, under the JAX ps2d bounds."""
        d = (out - ref).abs()
        scale = max(ref.abs().max().item(), 1.0)
        top2 = ref.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        dis = out.argmax(-1) != ref.argmax(-1)
        wide = (dis & (margin > 2 * d.max())).sum().item()
        print(f"{label} kernel path vs normal path, {shape}: max "
              f"|d logit| {d.max().item():.5f} (bound {2 ** -5 * scale:.5f}),"
              f" mean {d.mean().item():.6f} (bound {2 ** -9 * scale:.6f}), "
              f"labels agree {1 - dis.float().mean().item():.5f}, flips at "
              f"margin > 2x max drift: {wide}; finite: "
              f"{bool(torch.isfinite(out).all())}")
        check(bool(torch.isfinite(out).all()), "non-finite logits")
        check(d.max().item() <= 2 ** -5 * scale
              and d.mean().item() <= 2 ** -9 * scale and wide == 0,
              f"{label} kernel path drifts from the normal path")

    def check_labels(lab, vol, conf, where):
        offs, bucket = cropping.plan_crop(
            vol, multiple=16, min_size=S,
            ladder=conf.inference.crop_bucket_ladder)
        check(lab.shape == VOLUME_SHAPE and lab.dtype == np.int8
              and lab.min() >= 0 and lab.max() < 4, f"bad label map {where}")
        inside = np.zeros(VOLUME_SHAPE, bool)
        inside[tuple(slice(o, o + b) for o, b in zip(offs, bucket))] = 1
        return inside, bucket, offs

    vols = [make_volume(np.random.default_rng(s)) for s in range(3)]

    # ---------------------------------------------------------------- 3
    def slice_():
        conf = cfg.Config(model=cfg.ModelConfig(ps2d_eval=True,
                                                ps2d_levels=1))
        check(conf.model.features == (32, 64, 128, 256, 512),
              "not the full-width model")
        pred = Predictor(conf, seed=0)
        want = launches_of(conv3d_halo=6, up_k2s2_into_halo=2,
                           pack_halo=4)     # per request: 2 forwards
        for s, vol in enumerate(vols):
            t = time.perf_counter()
            lab, counts = request_counts(
                lambda: pred.segment_tumor(vol, mode="cropped"))
            secs = time.perf_counter() - t
            inside, bucket, offs = check_labels(lab, vol, conf, "(levels 1)")
            check(not lab[~inside].any(), "labels outside the crop")
            hist = np.bincount(lab.reshape(-1).astype(np.int64),
                               minlength=4).tolist()
            print(f"levels=1 segment_tumor, volume seed {s}: bucket {bucket}"
                  f" offsets {offs} labels {hist} in {secs:.3f} s; "
                  f"launches {counts}")
            check(counts == want, f"launches {counts} != {want}")
        hold_to_normal(pred.seg_model, vols[0], conf, "levels=1")
    run.phase("slice", slice_)

    # ---------------------------------------------------------------- 4
    def server():
        conf = cfg.Config(model=cfg.ModelConfig(ps2d_eval=True,
                                                ps2d_levels=2))
        pred = Predictor(conf, seed=0)
        check(pred.seg_model.halo_levels((S, S, S)) == 2,
              "the level-1 region is not eligible at the window shape")
        joint = models.UNet3DWithClassifier(seed=0)
        tree = models.to_flax_variables(joint.state_dict())
        del joint
        pred.load_joint_grade(tree["params"], tree["batch_stats"])
        per_fwd = launches_of(conv3d_halo=7, up_k2s2_into_halo=2,
                              pack_halo=2, pool_into_halo=1)
        want = {k: 2 * v for k, v in per_fwd.items()}   # 8 windows, 2 fwd
        total = dict.fromkeys(want, 0)

        def request(vol):
            """The three calls the server makes per upload."""
            lab, cf = pred.segment_with_confidence(vol, mode="cropped")
            return lab, cf, pred.classify_tumor(vol, lab), \
                pred.classify_grade(vol)

        secs = []
        for s, vol in enumerate(vols):
            t = time.perf_counter()
            (lab, cf, name, grade), counts = request_counts(
                lambda: request(vol))
            secs.append(time.perf_counter() - t)
            inside, bucket, offs = check_labels(lab, vol, conf, "(server)")
            check(cf.shape == VOLUME_SHAPE and cf.dtype == np.float32
                  and np.isfinite(cf).all() and cf.min() >= 0.25 - 1e-6
                  and cf.max() <= 1 + 1e-6, "confidence out of range")
            check(not lab[~inside].any() and (cf[~inside] == 1.0).all(),
                  "outside the crop: not background with confidence 1.0")
            check(name[0] in cfg.CLASS_NAMES + ("No Tumor Detected",)
                  and 0 < name[1] <= 1, f"bad classification {name}")
            check(grade is not None and grade[0] in range(4)
                  and 0 < grade[1] <= 1, f"bad grade {grade}")
            hist = np.bincount(lab.reshape(-1).astype(np.int64),
                               minlength=4).tolist()
            print(f"server request, volume seed {s}: bucket {bucket} labels "
                  f"{hist} mean confidence {cf[inside].mean():.4f}; "
                  f"classify {name}; grade {grade}; {secs[-1]:.3f} s; "
                  f"launches {counts}")
            check(counts == want, f"launches {counts} != {want}")
            total = {k: total[k] + counts[k] for k in total}
        report["requests_s"] = secs
        report["launches"] = total

        t = time.perf_counter()
        (lab, cf), counts = request_counts(lambda: pred.segment_with_confidence(
            vols[0], mode="cropped", tta=True))
        secs = time.perf_counter() - t
        check_labels(lab, vols[0], conf, "(tta)")
        check(np.isfinite(cf).all() and cf.min() >= 0.25 - 1e-6
              and cf.max() <= 1 + 1e-6, "TTA confidence out of range")
        want_tta = {k: 8 * v for k, v in want.items()}
        print(f"TTA request (8 flips, cropped): {secs:.3f} s; launches "
              f"{counts}")
        check(counts == want_tta, f"launches {counts} != {want_tta}")

        t = time.perf_counter()
        (lab, cf), counts = request_counts(lambda: pred.segment_with_confidence(
            vols[0], mode="whole_volume"))
        secs = time.perf_counter() - t
        check_labels(lab, vols[0], conf, "(whole_volume)")
        check(np.isfinite(cf).all() and cf.min() >= 0.25 - 1e-6
              and cf.max() <= 1 + 1e-6, "whole-volume confidence out of range")
        print(f"whole_volume request (resize to 128^3, 1 forward, resize "
              f"back): {secs:.3f} s; launches {counts}")
        check(counts == per_fwd, f"launches {counts} != {per_fwd}")
        hold_to_normal(pred.seg_model, vols[0], conf, "levels=2")
        return pred
    pred = run.phase("server", server)
    if args.profile:
        def profile_phase():
            profile_request(pred, vols[0], cropping)
            # the same request on the normal path (no kernels, same
            # weights), alternated with the kernel path: K N N K K N N K
            plain = Predictor(cfg.Config(), seed=0)
            plain.joint_model = pred.joint_model
            secs = {"kernel": [], "normal": []}
            for side in ("kernel", "normal", "normal", "kernel") * 2:
                p = pred if side == "kernel" else plain
                t = time.perf_counter()
                seg, _ = p.segment_with_confidence(vols[0], "cropped")
                p.classify_tumor(vols[0], seg)
                p.classify_grade(vols[0])
                torch.cuda.synchronize()
                secs[side].append(time.perf_counter() - t)
            for side, v in secs.items():
                print(f"  {side}-path requests: "
                      f"{' '.join(f'{x:.4f}' for x in v)} s, median "
                      f"{np.median(v):.4f} s")
        run.phase("profile", profile_phase)
    del pred

    # ---------------------------------------------------------------- f32
    def f32():
        """compute_dtype float32 on the normal path (the region off): one
        full-width cropped request, its labels held to the bf16 serving
        request's under the margin contract, then one window batch of it
        against float64 on the card (TF32 would show there)."""
        import copy
        conv_mod = import_module(PKG + ".ops.conv")
        p32 = Predictor(cfg.Config(model=cfg.ModelConfig(
            compute_dtype="float32")), seed=0)
        p16 = Predictor(cfg.Config(model=cfg.ModelConfig(
            ps2d_eval=True, ps2d_levels=2)), seed=0)
        check(p32.seg_model.compute_dtype == torch.float32
              and not p32.config.model.ps2d_eval, "not the f32 normal path")
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
        vol = vols[0]
        t = time.perf_counter()
        (lab32, cf32), counts = request_counts(
            lambda: p32.segment_with_confidence(vol, mode="cropped"))
        secs = time.perf_counter() - t
        check(not any(counts.values()), f"f32 request launched {counts}")
        check((torch.backends.cudnn.allow_tf32,
               torch.get_float32_matmul_precision()) == flags,
              "the f32 request left the TF32 settings changed")
        lab16, _ = p16.segment_with_confidence(vol, mode="cropped")
        inside, bucket, offs = check_labels(lab32, vol, p32.config, "(f32)")
        canon = p32._canon(vol)
        l32 = p32._segment_logits(canon, "cropped")[0]
        l16 = p16._segment_logits(canon, "cropped")[0].float()
        check(bool(torch.isfinite(l32).all()), "non-finite f32 logits")
        drift = (l32 - l16).abs().max().item()
        top2 = l32.topk(2, dim=-1).values
        margin = cropping.paste_full((top2[..., 0] - top2[..., 1]).cpu()
                                     .numpy(), offs, VOLUME_SHAPE,
                                     fill=np.inf)
        flips = lab32 != lab16
        wide = int((flips & (margin > 2 * drift)).sum())
        print(f"f32 request (cropped, region off): {secs:.3f} s; launches "
              f"{counts}; vs the bf16 serving request: max |d logit| "
              f"{drift:.5f}, labels agree {1 - flips.mean():.6f}, flips at "
              f"margin > 2x max drift: {wide}")
        check(wide == 0, "f32 labels differ from bf16 beyond the margin")

        # one window batch (4 x 128^3) of the crop against float64
        crop = torch.from_numpy(cropping.extract_crop(canon, offs, bucket)
                                ).to(dev)
        starts = [sw.compute_patch_starts(d, S, 0.5) for d in bucket]
        wins = [(a, b, c) for a in starts[0] for b in starts[1]
                for c in starts[2]][:4]
        x = torch.stack([crop[a:a + S, b:b + S, c:c + S]
                         for a, b, c in wins])
        y32 = p32.seg_model(x)
        m64 = copy.deepcopy(p32.seg_model)
        for m in m64.modules():      # convs and matmuls in float64
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float64
        y64 = m64(x.double())
        scale = max(y64.abs().max().item(), 1.0)
        d64 = (y32 - y64).abs().max().item()
        # the same batch with TF32 let in, to show the bound would see it
        keep = conv_mod.full_f32
        conv_mod.full_f32 = contextlib.nullcontext
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        try:
            dtf = (p32.seg_model(x) - y64).abs().max().item()
        finally:
            conv_mod.full_f32 = keep
            torch.backends.cudnn.allow_tf32 = flags[0]
            torch.set_float32_matmul_precision(flags[1])
        del m64
        print(f"f32 window batch {tuple(x.shape)} vs float64 on the card: "
              f"max |d logit| {d64:.3e} (bound {1e-4 * scale:.3e} = 1e-4 "
              f"max(scale, 1)); with TF32 let in: {dtf:.3e}")
        check(d64 <= 1e-4 * scale, "f32 logits drift from float64 (TF32?)")
        report["f32"] = {"launches": counts, "request_s": secs,
                         "drift_vs_bf16": drift, "drift_vs_f64": d64,
                         "drift_tf32_vs_f64": dtf}
        del p32, p16

    # ---------------------------------------------------------------- 5
    def app():
        """The server itself: three 240x240x155x4 .nii.gz uploads POSTed
        over HTTP to the port's app (full width, ps2d_levels=2), each
        answer held to the predictor, the card's preprocessing to the
        CPU's, and the launches per upload to the server phase's."""
        import base64
        import gzip
        import http.client
        import importlib.util
        import logging
        import re
        import tempfile
        import threading
        A = import_module(PKG + ".serve.app")
        nifti = import_module(PKG + ".data.nifti")
        stats = import_module(PKG + ".ops.stats")
        preprocess_image = import_module(
            PKG + ".inference.predictor").preprocess_image
        conf = cfg.Config(
            model=cfg.ModelConfig(ps2d_eval=True, ps2d_levels=2),
            inference=cfg.InferenceConfig(upload_mode="cropped",
                                          checkpoint="none"))
        check(conf.model.features == (32, 64, 128, 256, 512),
              "not the full-width model")
        per_fwd = launches_of(conv3d_halo=7, up_k2s2_into_halo=2,
                              pack_halo=2, pool_into_halo=1)
        want = {k: 2 * v for k, v in per_fwd.items()}   # 8 windows, 2 fwd
        pictures = importlib.util.find_spec("matplotlib") is not None
        App = A.BrainTumorApp
        if not pictures:
            class App(A.BrainTumorApp):
                """/upload without its pictures: the app's own
                ``_report``, which ``_analyze`` runs before them."""

                def _analyze(self, filepath, demo, return_mask=False):
                    return self._report(filepath, demo, return_mask)[0]
            print("app: matplotlib is not importable here, so /upload runs "
                  "BrainTumorApp._report (decode .. mask encode) without "
                  "the visualisations")

        phases = []

        class Phases(logging.Handler):
            """The app's per-phase log lines; its warnings to stderr."""

            def emit(self, record):
                msg = record.getMessage()
                m = re.fullmatch(r"upload (.+): ([0-9.]+) ms", msg)
                if m:
                    phases.append((m.group(1), float(m.group(2))))
                elif record.levelno >= logging.WARNING:
                    print(self.format(record), file=sys.stderr)
        log = logging.getLogger(A.__name__)
        handler = Phases()
        log.addHandler(handler)
        log.setLevel(logging.INFO)

        def multipart(payload, boundary="chipsmokeB"):
            head = (f"--{boundary}\r\nContent-Disposition: form-data; "
                    'name="return_mask"\r\n\r\n1\r\n'
                    f"--{boundary}\r\nContent-Disposition: form-data; "
                    'name="file"; filename="scan.nii.gz"\r\n\r\n')
            return (head.encode() + payload
                    + f"\r\n--{boundary}--\r\n".encode(),
                    f"multipart/form-data; boundary={boundary}")

        total = dict.fromkeys(want, 0)
        rows = []
        with tempfile.TemporaryDirectory() as upload_dir:
            served = App(conf, upload_dir=upload_dir)
            server = A.create_server("127.0.0.1", 0, app=served)
            port = server.server_address[1]
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            try:
                t = time.perf_counter()
                A.warmup_app(served)
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=120)
                conn.request("GET", "/health")
                health = json.loads(conn.getresponse().read())
                conn.close()
                print(f"app: warmup {time.perf_counter() - t:.2f} s, "
                      f"/health {health}")
                check(health["warmup"] == "done"
                      and health["models_loaded"], f"warmup: {health}")
                pred = served._get_predictor()
                for s, vol in enumerate(vols):
                    payload = gzip.compress(nifti.encode(vol),
                                            compresslevel=1)
                    body, ctype = multipart(payload)
                    phases.clear()
                    conn = http.client.HTTPConnection("127.0.0.1", port,
                                                      timeout=600)

                    def post():
                        conn.request("POST", "/upload", body=body,
                                     headers={"Content-Type": ctype})
                        resp = conn.getresponse()
                        return resp.status, json.loads(resp.read())
                    t = time.perf_counter()
                    (status, ans), counts = request_counts(post)
                    wall = time.perf_counter() - t
                    conn.close()
                    check(status == 200 and ans.get("success"),
                          f"upload {s}: HTTP {status}, {str(ans)[:300]}")
                    check(ans["degraded_mode"] is False,
                          f"upload {s} answered degraded_mode: true")
                    check(counts == want,
                          f"upload {s}: launches {counts} != {want}")
                    check(("visualizations" in ans) == pictures,
                          f"upload {s}: pictures {pictures} but keys "
                          f"{sorted(ans)}")
                    raw = gzip.decompress(base64.b64decode(
                        ans["mask_nifti_base64"]))
                    with tempfile.NamedTemporaryFile(suffix=".nii") as f:
                        f.write(raw)
                        f.flush()
                        mask = nifti.load(f.name).data
                    check(ans["mask_grid"] == "native"
                          and mask.shape == VOLUME_SHAPE,
                          f"upload {s}: mask {mask.shape} on the "
                          f"{ans['mask_grid']} grid")
                    # the answer against the predictor, and the card's
                    # preprocessing against the CPU's, on the same volume
                    pv = preprocess_image(vol, None)
                    lab, _ = pred.segment_with_confidence(pv, mode="cropped")
                    check(np.array_equal(mask, lab.astype(np.uint8)),
                          f"upload {s}: mask differs from the predictor's "
                          f"labels at {int((mask != lab).sum())} voxels")
                    bounds = [stats.percentile_bisect(
                        torch.from_numpy(vol).to(d), (1.0, 99.0)).cpu()
                        .numpy() for d in ("cuda", "cpu")]
                    check(np.array_equal(bounds[0].view(np.int32),
                                         bounds[1].view(np.int32)),
                          f"upload {s}: clip bounds {bounds[0]} on the "
                          f"card, {bounds[1]} on the CPU")
                    pc = preprocess_image(vol, None, device="cpu")
                    zerr = float(np.abs(pv - pc).max())
                    check(zerr <= 1e-5 * float(np.abs(pc).max()),
                          f"upload {s}: z-score card vs CPU {zerr}")
                    total = {k: total[k] + counts[k] for k in total}
                    ph = dict(phases)
                    rows.append({"wall_s": wall, "phases_ms": ph,
                                 "payload_bytes": len(payload)})
                    hist = np.bincount(mask.reshape(-1), minlength=4)
                    print(f"app upload {s}{' (first)' if s == 0 else ''}: "
                          f"{len(payload) / 1e6:.2f} MB .nii.gz, HTTP "
                          f"{status} in {wall * 1e3:.2f} ms wall; "
                          + ", ".join(f"{k} {v:.2f} ms"
                                      for k, v in ph.items())
                          + f"; labels {hist.tolist()}, clip bounds "
                          f"{bounds[0].tolist()} (card == CPU), z-score "
                          f"card vs CPU {zerr:.3g}; "
                          f"{ans['classification']['primary_diagnosis']};"
                          f" launches {counts}")
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=60)
                log.removeHandler(handler)
        steady = rows[1:]
        print("app uploads 2-3, mean host ms by phase: " + ", ".join(
            f"{k} {np.mean([r['phases_ms'][k] for r in steady]):.2f}"
            for k in steady[0]["phases_ms"]) + f"; wall "
            f"{np.mean([r['wall_s'] for r in steady]) * 1e3:.2f} ms "
            f"(first upload {rows[0]['wall_s'] * 1e3:.2f} ms)")
        # which reader decoded the uploads, and both on one payload
        hn = import_module(PKG + ".data.native")
        with tempfile.NamedTemporaryFile(suffix=".nii.gz") as f:
            f.write(gzip.compress(nifti.encode(vols[1]), compresslevel=1))
            f.flush()
            t = time.perf_counter()
            native_vol = hn.read_nifti(f.name)
            native_ms = 1e3 * (time.perf_counter() - t)
            t = time.perf_counter()
            codec_vol = nifti.load_volume(f.name)
            codec_ms = 1e3 * (time.perf_counter() - t)
        check(native_vol is None or np.array_equal(native_vol, codec_vol),
              "the native reader differs from the NumPy codec")
        print("app decode: " + (
            f"the native host library read the uploads; upload 2's payload "
            f"again: native {native_ms:.2f} ms" if native_vol is not None
            else f"the native reader declines a 4-D upload (None in "
                 f"{native_ms:.2f} ms), so the NumPy codec read them") +
            f"; the NumPy codec on upload 2's payload: {codec_ms:.2f} ms")
        report["app"] = {"uploads": rows, "launches": total,
                         "pictures": pictures, "native_decode_ms": native_ms,
                         "codec_decode_ms": codec_ms}
    run.phase("app", app)

    # ---------------------------------------------------------------- 6
    def train():
        conf = cfg.Config()
        mc = conf.model
        check(mc.features == (32, 64, 128, 256, 512) and mc.remat
              and conf.batch_size == 2, "not the full-width train setting")
        TB = conf.batch_size
        gen = torch.Generator(device=dev).manual_seed(1)
        image = torch.randn((TB, S, S, S, 4), device=dev, generator=gen)
        # a label mask the net can fit (tests/test_ps2d.py:617-619)
        mask = (torch.rand((TB, S, S, S), device=dev, generator=gen)
                < 0.2).long() * 2
        batch = {"image": image, "mask": mask}

        def new_model(ps2d=True, rate=mc.dropout_rate):
            return models.UNet3D(features=mc.features, ps2d_train=ps2d,
                                 remat=mc.remat, dropout_rate=rate, seed=0)

        # five steps at Config() defaults, dropout on
        state = train_mod.create_train_state(new_model(), conf,
                                             steps_per_epoch=10)
        step = train_mod.make_train_step(conf)
        # K6 has no kernel of its own: its forwards and data gradients
        # are K1's launches (3 + 4 a step)
        want = launches_of(conv3d_halo=7)
        losses, step_ms, total = [], [], dict.fromkeys(want, 0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()   # the earlier phases' tensors
        torch.cuda.reset_peak_memory_stats()
        for i in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

            def one():
                ev[0].record()
                out = step(state, batch, gen)
                ev[1].record()
                return out

            (_, m), counts = request_counts(one)
            step_ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(m["loss"]))
            print(f"train step {i}: loss {losses[-1]:.5f} dice "
                  f"{float(m['dice']):.4f} grad_norm "
                  f"{float(m['grad_norm']):.4f} lr "
                  f"{train_mod.current_lr(state, conf.optimizer, 10):.3e}; "
                  f"{step_ms[-1]:.1f} ms; launches {counts}")
            check(counts == want, f"launches {counts} != {want}")
            total = {k: total[k] + counts[k] for k in total}
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)), f"non-finite loss {losses}")
        check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
        if args.profile:
            device_profile(lambda: step(state, batch, gen),
                           "train step (a sixth, dropout on)", top=25)
            # the kernel path's step against the normal path's, fresh
            # states from the same seed, alternated K N N K twice
            sides = {"kernel": True, "normal": False}
            states = {k: train_mod.create_train_state(new_model(ps2d=v),
                                                      conf, 10)
                      for k, v in sides.items()}
            secs = {k: [] for k in sides}
            for st in states.values():          # first calls, untimed
                step(st, batch, gen)
            for side in ("kernel", "normal", "normal", "kernel") * 2:
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                torch.cuda.reset_peak_memory_stats()
                e0.record()
                step(states[side], batch, gen)
                e1.record()
                torch.cuda.synchronize()
                secs[side].append((e0.elapsed_time(e1),
                                   torch.cuda.max_memory_allocated()))
            del states
            for side, v in secs.items():
                print(f"  {side}-path train steps: "
                      f"{' '.join(f'{ms:.1f}' for ms, _ in v)} ms, median "
                      f"{np.median([ms for ms, _ in v]):.1f} ms; peak "
                      f"{max(b for _, b in v) / 2 ** 30:.2f} GiB")
        report["train"] = {
            "losses": losses, "step_ms": step_ms,
            "step_ms_median_2_5": float(np.median(step_ms[1:])),
            "peak_bytes": peak, "peak_bytes_above_base": peak - base,
            "launches": total}
        print(f"train: losses {[round(v, 5) for v in losses]}; steady step "
              f"{report['train']['step_ms_median_2_5']:.1f} ms (median of "
              f"steps 2-5); peak memory {peak / 2 ** 30:.2f} GiB, "
              f"{(peak - base) / 2 ** 30:.2f} GiB above the "
              f"{base / 2 ** 30:.2f} GiB the earlier phases hold")

        # eval step on the trained state (the eval forward, normal path)
        t = time.perf_counter()
        ev = train_mod.make_eval_step(conf, with_hausdorff=True)(state,
                                                                 batch)
        hd = ev["hausdorff"].tolist()
        print(f"eval step: loss {float(ev['loss']):.5f} dice "
              f"{float(ev['dice']):.4f} WT/TC/ET "
              f"{[round(float(ev['dice_' + k]), 4) for k in ('WT', 'TC', 'ET')]}"
              f" HD95 {hd} in {time.perf_counter() - t:.2f} s")
        check(np.isfinite(float(ev["loss"])) and 0 <= float(ev["dice"]) <= 1
              and ev["pred_labels"].shape == mask.shape
              and not any(np.isnan(hd)), "bad eval step")
        del state, ev

        # the kernel path's loss and gradients against the normal path's,
        # same parameters and batch, dropout off
        loss_fn = train_mod.make_loss_fn(conf)

        def loss_grads(model):
            out = model.forward_train(image)
            loss = loss_fn(out, mask)
            names, params = zip(*model.named_parameters())
            gs = torch.autograd.grad(loss, params, allow_unused=True)
            return float(loss.detach()), dict(zip(names, gs))

        km = new_model(rate=0.0)
        lk, gk = loss_grads(km)
        nm = new_model(ps2d=False, rate=0.0)
        nm.load_state_dict(km.state_dict())
        ln, gn = loss_grads(nm)
        del km, nm
        n, cmin, rmin, rmax = grads_directional(gk, gn)
        print(f"train kernel path vs normal path: loss {lk:.6f} vs {ln:.6f} "
              f"(rel {abs(lk - ln) / abs(ln):.2e}, bound 1e-2); {n} gradient "
              f"leaves: least cosine {cmin:.4f} (bound 0.9), norm ratio "
              f"{rmin:.4f}-{rmax:.4f} (bound 0.5-2)")
        check(abs(lk - ln) <= 1e-2 * abs(ln), "kernel-path loss drifts")
        del gk, gn

        # grad_accum=2 against the full batch, dropout off
        norms = []
        for accum in (1, 2):
            st = train_mod.create_train_state(new_model(rate=0.0), conf,
                                              steps_per_epoch=10)
            (_, m), counts = request_counts(lambda: train_mod.make_train_step(
                conf.replace(grad_accum=accum))(st, batch, gen))
            norms.append(float(m["grad_norm"]))
            w = {k: v * accum if k.startswith("conv3d_halo") else v
                 for k, v in want.items()}
            check(counts == w, f"grad_accum={accum}: launches {counts}")
            del st
        print(f"grad_accum=2 vs full batch: grad_norm {norms[1]:.6f} vs "
              f"{norms[0]:.6f} (rel {abs(norms[1] - norms[0]) / norms[0]:.2e},"
              f" bound 1e-3)")
        check(abs(norms[1] - norms[0]) <= 1e-3 * norms[0],
              "grad_accum=2 gradient differs from the full batch's")

        # one joint step (the trunk on the normal path, as in JAX)
        joint = models.UNet3DWithClassifier(seed=0, remat=mc.remat)
        js = train_mod.create_train_state(joint, conf, steps_per_epoch=10)
        (_, m), counts = request_counts(
            lambda: train_mod.make_joint_train_step(conf)(js, batch, gen))
        vals = {k: float(v) for k, v in m.items()}
        print(f"joint step: {vals}; launches {counts}")
        check(all(np.isfinite(list(vals.values())))
              and 0 <= vals["grade_acc"] <= 1 and not any(counts.values()),
              "bad joint step")
        del joint, js

        # K6 against its plain version at the region's three call forms,
        # batch 2: a cotangent with garbage on the halo
        def halo(c):
            return T.pack_halo_plain(rnd((TB, S, S, S, c)))

        k6 = {
            "enc0.conv2 (2,130^3,32)->32": ((halo(C),), C),
            "dec0.conv1 2x(2,130^3,32)->32": ((halo(C), halo(C)), C),
            "dec0.conv2 (2,130^3,32)->32": ((halo(C),), C),
        }
        worst, forms6 = 0.0, {}
        for name, (xs, co) in k6.items():
            ci = sum(x.shape[-1] for x in xs)
            w = rnd((3, 3, 3, ci, co), (2 / (27 * co)) ** 0.5)
            dy = T.pack_halo_plain(rnd((TB, S, S, S, co)))
            dy = dy + 100 * rnd(dy.shape) * (1 - T.halo_mask(dy))

            def run(fn):
                xr = [x.clone().requires_grad_() for x in xs]
                wr = w.clone().requires_grad_()
                y = fn(xr, wr)
                g = torch.autograd.grad(y, [wr, *xr], dy)
                return [y.detach(), g[0], *g[1:]]

            got, ref = run(T.conv3d_halo_train), run(T.conv3d_halo_train_plain)
            torch.cuda.synchronize()
            errs = []
            for label, a, b, tol in zip(["y", "dw"] + [f"dx{i}" for i in
                                                       range(len(xs))],
                                        got, ref, [2 ** -7] + [2 ** -5] * 3):
                e = (a.float() - b.float()).abs().max().item()
                m = b.float().abs().max().item()
                errs.append(f"{label} {e:.5f} (tolerance {tol * m:.5f})")
                check(e <= tol * m, f"K6 {name}: {label} differs from the "
                      f"plain version ({e} > {tol} * {m})")
                worst = max(worst, e)
            for dx in got[2:]:
                check((dx.float() * (1 - T.halo_mask(dx).float())).abs()
                      .max().item() == 0, "K6 dx has a non-zero halo")
            print(f"conv3d_halo_train {name}: max_abs_err " + ", ".join(errs))
            forms6[name] = (xs, w, dy)
        report["conv3d_halo_train"] = {"max_abs_err": worst}
        return forms6
    forms6 = run.phase("train", train)

    # ---------------------------------------------------------------- trainer
    def trainer():
        """The trainer at full width: a synthetic 240x240x155x4 cohort on
        disk (4 train + 2 val cases, .nii.gz), patch-mode train batches of
        2 x 128^3 and whole-volume validation at 128^3 through the port's
        loader, two epochs of ModernBrainTumorTrainer on UNet3D(ps2d_train,
        ps2d_eval, ps2d_levels=2, remat), its best_* checkpoint reloaded
        bit for bit and adopted by a Predictor."""
        import os
        import shutil
        import tempfile
        from concurrent.futures import ThreadPoolExecutor
        synth = import_module(PKG + ".data.synthetic")
        pipe = import_module(PKG + ".data.pipeline")
        TR = import_module(PKG + ".train.trainer")
        CK = import_module(PKG + ".train.checkpoints")
        loop = import_module(PKG + ".train.loop")
        tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
        try:
            root = os.path.join(tmp, "cohort")
            t = time.perf_counter()
            # one case a call, six at once (gzip releases the GIL); then
            # two of them to val/
            with ThreadPoolExecutor(6) as pool:
                list(pool.map(lambda i: synth.create_enhanced_synthetic_data(
                    1, root, shape=VOLUME_SHAPE, seed=100 + i,
                    start_index=i, skull_stripped=True), range(6)))
            for i in (4, 5):
                pid = f"BraTS-Synth-{i:04d}"
                os.rename(os.path.join(root, "train", pid),
                          os.path.join(root, "val", pid))
            write_s = time.perf_counter() - t
            nbytes_disk = sum(os.path.getsize(os.path.join(d, f))
                              for d, _, fs in os.walk(root) for f in fs)
            print(f"trainer cohort: 6 cases of {VOLUME_SHAPE}x4 .nii.gz "
                  f"written in {write_s:.2f} s ({nbytes_disk / 1e6:.1f} MB)")
            conf = cfg.Config(results_dir=os.path.join(tmp, "results"),
                              models_dir=os.path.join(tmp, "models"),
                              use_tensorboard=False)
            mc = conf.model
            check(mc.features == (32, 64, 128, 256, 512) and mc.remat
                  and conf.batch_size == 2 and conf.data.image_size ==
                  (S, S, S), "not the full-width train setting")
            train_l, val_l = pipe.create_brats_data_loaders(
                root, batch_size=conf.batch_size, num_workers=4,
                image_size=conf.data.image_size, seed=conf.seed,
                aug_cfg=conf.augment, patch_size=(S, S, S))
            check(len(train_l) == 2 and len(val_l) == 1,
                  f"{len(train_l)} train and {len(val_l)} val batches")
            model = models.UNet3D(features=mc.features, ps2d_train=True,
                                  ps2d_eval=True, ps2d_levels=2,
                                  remat=mc.remat, seed=conf.seed)
            check(model.halo_levels((S, S, S)) == 2, "no level-2 region")

            # the launches of each train step and each validation forward
            steps, vals, saved = [], [], {}

            # each train step's CUDA-event ms; the first validation
            # batch, held against the normal path after the run
            step_events, val_batch = [], []

            def counting(make, sink, events=None, keep=None):
                def factory(*a, **k):
                    fn = make(*a, **k)

                    def step(*args):
                        before = {k.__name__: k.launches for k in counted}
                        if keep is not None and not keep:
                            keep.append(args[1]["image"].clone())
                        if events is not None:
                            ev = [torch.cuda.Event(enable_timing=True)
                                  for _ in range(2)]
                            ev[0].record()
                        out = fn(*args)
                        if events is not None:
                            ev[1].record()
                            events.append(ev)
                        sink.append({k.__name__: k.launches
                                     - before[k.__name__] for k in counted})
                        return out
                    return step
                return factory

            class Trainer(TR.ModernBrainTumorTrainer):
                """Times each save and keeps the state it saved."""

                def save_model(self, epoch=0, path=None):
                    t0 = time.perf_counter()
                    out = super().save_model(epoch, path)
                    saved[out] = (time.perf_counter() - t0,
                                  CK.state_tree(self.state))
                    return out

            TR.make_train_step = counting(loop.make_train_step, steps,
                                          events=step_events)
            TR.make_eval_step = counting(loop.make_eval_step, vals,
                                         keep=val_batch)
            try:
                tr = Trainer(model, config=conf, experiment_name="smoke")
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                hist, counts = request_counts(
                    lambda: tr.train(train_l, val_l, num_epochs=2))
                wall = time.perf_counter() - t
            finally:
                TR.make_train_step = loop.make_train_step
                TR.make_eval_step = loop.make_eval_step
            peak = torch.cuda.max_memory_allocated()
            print(f"trainer: 2 epochs in {wall:.2f} s; history "
                  + "; ".join(f"{k} {[round(v, 5) for v in vs]}"
                              for k, vs in hist.items())
                  + f"; launches {counts}")
            for k in ("train_loss", "val_loss"):
                check(all(np.isfinite(hist[k])), f"non-finite {k}: "
                      f"{hist[k]}")
            want = launches_of(conv3d_halo=7)
            per_fwd = launches_of(conv3d_halo=7, up_k2s2_into_halo=2,
                                  pack_halo=2, pool_into_halo=1)
            check(len(steps) == 4 and all(c == want for c in steps),
                  f"train-step launches {steps} != {want}")
            check(len(vals) == 2 and all(c == per_fwd for c in vals),
                  f"validation-forward launches {vals} != {per_fwd}")
            hn = import_module(PKG + ".data.native")
            print(f"trainer decode: the "
                  f"{'native host library' if hn.available() else 'NumPy codec'}"
                  f" read the cohort; loader wait at epoch 1's first batch "
                  f"{1e3 * tr.timing['loader_wait_s'][0]:.2f} ms")
            step_ms = [1e3 * v for v in tr.timing["step_s"]]
            event_step_ms = [a.elapsed_time(b) for a, b in step_events]
            wait_ms = [1e3 * v for v in tr.timing["loader_wait_s"]]
            val_ms = [1e3 * v for v in tr.timing["val_epoch_s"]]
            print(f"trainer: host enqueue ms per train step "
                  f"{[round(v, 2) for v in step_ms]} (median of steps 2-4 "
                  f"{np.median(step_ms[1:]):.2f}); CUDA-event ms per train "
                  f"step {[round(v, 2) for v in event_step_ms]} (median of "
                  f"steps 2-4 {np.median(event_step_ms[1:]):.2f}); "
                  f"loader wait ms per step {[round(v, 2) for v in wait_ms]}"
                  f"; validation epochs {[round(v, 2) for v in val_ms]} ms; "
                  f"last epoch's host->device copies {train_l.h2d_ms():.3f} "
                  f"ms (train), {val_l.h2d_ms():.3f} ms (val); peak memory "
                  f"{peak / 2 ** 30:.2f} GiB")

            # the first validation batch (2 x 128^3, K1's level-1 forms
            # and K2-K4 at batch 2) through the evaluated weights' kernel
            # path against their normal path; outside the counted run
            ev_model = train_mod.ema_eval_state(tr.state).model
            out = ev_model(val_batch[0]).float()
            ev_model.ps2d_eval = False
            try:
                ref = ev_model(val_batch[0]).float()
            finally:
                ev_model.ps2d_eval = True
            compare_to_normal(out, ref, "trainer validation batch",
                              tuple(val_batch[0].shape))
            del ev_model, out, ref, val_batch[:]

            # the best checkpoint: reloaded bit for bit, then adopted
            best = os.path.join(conf.models_dir, "best_smoke")
            check(best in saved, f"no best_ checkpoint in {sorted(saved)}")
            save_s, tree = saved[best]
            size = os.path.getsize(os.path.join(best, "state", "state.pt"))
            fresh = train_mod.create_train_state(
                models.UNet3D(features=mc.features, seed=99), conf,
                steps_per_epoch=2)
            t = time.perf_counter()
            CK.restore_checkpoint(best, fresh)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
            back = CK.state_tree(fresh)

            def same(a, b):
                if isinstance(a, dict):
                    return set(a) == set(b) and all(same(a[k], b[k])
                                                    for k in a)
                return a.dtype == b.dtype and np.array_equal(a, b)
            for k in ("params", "batch_stats", "opt_state", "step"):
                check(same(back[k], tree[k]), f"checkpoint {k} differs "
                      "after the reload")
            n_params = sum(p.numel() for p in model.parameters())
            print(f"trainer checkpoint {os.path.basename(best)}: "
                  f"{size / 2 ** 20:.2f} MiB ({size / (4 * n_params):.3f}x "
                  f"the f32 parameter bytes, {n_params} parameters); save "
                  f"{save_s * 1e3:.2f} ms, load {load_s * 1e3:.2f} ms; "
                  f"params, batch_stats, opt_state and step bit-identical "
                  f"after the reload")
            del fresh, back
            sconf = cfg.Config(model=cfg.ModelConfig(ps2d_eval=True,
                                                     ps2d_levels=2),
                               models_dir=conf.models_dir)
            adopt = Predictor(sconf, seed=5)
            check(CK.adopt_trained_weights(adopt, "", conf.models_dir)
                  == best, "the predictor did not adopt best_smoke")
            mem = Predictor(sconf, seed=6, seg_variables={
                "params": tree["params"], "batch_stats": tree["batch_stats"]})
            la = adopt.segment_tumor(vols[0], mode="cropped")
            lm = mem.segment_tumor(vols[0], mode="cropped")
            check(np.array_equal(la, lm), "the adopted checkpoint's labels "
                  "differ from the trainer's weights'")
            print(f"trainer: a Predictor (ps2d_levels=2) adopting "
                  f"{os.path.basename(best)} gives labels equal to one "
                  f"handed the trainer's weights on a {VOLUME_SHAPE} volume "
                  f"({np.bincount(la.reshape(-1), minlength=4).tolist()})")
            step_launches = {k: sum(c[k] for c in steps) for k in counts}
            report["trainer"] = {
                "launches": counts, "step_launches": step_launches,
                "history": hist, "step_ms": step_ms,
                "event_step_ms": event_step_ms, "loader_wait_ms": wait_ms,
                "val_epoch_ms": val_ms, "cohort_write_s": write_s,
                "checkpoint_bytes": size, "save_ms": save_s * 1e3,
                "load_ms": load_s * 1e3, "peak_bytes": peak, "wall_s": wall}
            del tr, model, adopt, mem, saved, tree
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    # ---------------------------------------------------------------- webtrain
    def webtrain():
        """The app's training routes over HTTP: a real session on the card
        (2 epochs, 4 synthetic samples, 64^3, the web's compact model)
        polled to completed and its best_web_* checkpoint; a second
        session stopped by /stop_training."""
        import http.client
        import os
        import shutil
        import tempfile
        import threading
        A = import_module(PKG + ".serve.app")
        tmp = tempfile.mkdtemp(prefix="chip_smoke_webtrain_")
        conf = cfg.Config(models_dir=os.path.join(tmp, "models"),
                          data_dir=os.path.join(tmp, "data"),
                          inference=cfg.InferenceConfig(checkpoint="none"))
        served = A.BrainTumorApp(conf, upload_dir=os.path.join(tmp, "u"))
        server = A.create_server("127.0.0.1", 0, app=served)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()

        def call(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conn.request(method, path,
                         body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = resp.status, json.loads(resp.read())
            conn.close()
            check(out[0] == 200, f"{method} {path}: HTTP {out[0]} {out[1]}")
            return out[1]

        def wait(sid, statuses, limit=240):
            end = time.perf_counter() + limit
            while time.perf_counter() < end:
                prog = call("GET", f"/training_progress?session_id={sid}")
                if prog["status"] in statuses:
                    return prog
                time.sleep(0.25)
            raise Failed(f"session {sid} never reached {statuses}: {prog}")

        try:
            def first():
                t = time.perf_counter()
                sid = call("POST", "/start_training", {
                    "epochs": 2, "num_samples": 4,
                    "image_size": [64, 64, 64]})["session_id"]
                return sid, wait(sid, ("completed", "error")), \
                    time.perf_counter() - t
            (sid, prog, secs), counts = request_counts(first)
            print(f"webtrain session {sid}: {prog['status']} in {secs:.2f} s"
                  f"; epoch {prog['current_epoch']}, train loss "
                  f"{prog['train_loss']}, val loss {prog['val_loss']}, "
                  f"dice {prog['dice_score']}; launches {counts}")
            check(prog["status"] == "completed", f"session failed: {prog}")
            # the web sessions train without the ps2d region, as JAX's
            check(not any(counts.values()), f"web training launched {counts}")
            ck = prog.get("checkpoint", "")
            check(os.path.basename(ck) == f"best_web_{sid}" and os.path.isfile(
                os.path.join(ck, "state", "state.pt")),
                f"no best_web_ checkpoint: {ck!r}")
            second = call("POST", "/start_training", {
                "epochs": 1000, "num_samples": 2,
                "image_size": [64, 64, 64]})["session_id"]
            wait(second, ("running", "error"))
            ans = call("POST", "/stop_training", {"session_id": second})
            prog2 = wait(second, ("stopped", "error"))
            check(ans["stopped"] and prog2["status"] == "stopped",
                  f"second session: {ans}, {prog2['status']}")
            health = call("GET", "/health")
            check(health["sessions"] == [sid, second],
                  f"/health sessions {health['sessions']}")
            print(f"webtrain: checkpoint {os.path.basename(ck)}; second "
                  f"session {second} stopped at epoch "
                  f"{prog2['current_epoch']}; /health sessions "
                  f"{health['sessions']}")
            report["webtrain"] = {"launches": counts, "session_s": secs}
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
            served.jobs.join(timeout=120)
            shutil.rmtree(tmp, ignore_errors=True)

    # ---------------------------------------------------------------- 7
    def groupnorm():
        """K5's path: its entry point at the DoubleConv tail's forms."""
        def gn_form(shape, dtype, relu, residual=None):
            """residual: None, "x" (x itself) or "other" (a tensor of
            its own)."""
            x = rnd(shape, 2.0, dtype) + 0.5
            c = shape[-1]
            r = (x if residual == "x" else None if residual is None
                 else rnd(shape, 1.0, dtype))
            return dict(x=x, gamma=1 + rnd((c,), 0.3, torch.float32),
                        beta=rnd((c,), 0.3, torch.float32), num_groups=8,
                        relu=relu, residual=r)

        big = (1, 240, 240, 160, C)   # the shape of groupnorm.py:152
        gforms = {
            "(4,128^3,32) GN8 ReLU bf16": gn_form(
                (B, S, S, S, C), bf16, True),
            "(4,128^3,32) GN8 ReLU + x bf16 (DoubleConv tail)": gn_form(
                (B, S, S, S, C), bf16, True, "x"),
            "(1,240,240,160,32) GN8 ReLU + residual bf16": gn_form(
                big, bf16, True, "other"),
            "(4,128^3,32) GN8 f32": gn_form(
                (B, S, S, S, C), torch.float32, False),
        }
        outs, counts = request_counts(lambda: {
            k: GN.fused_group_norm(**kw) for k, kw in gforms.items()})
        want = launches_of(fused_group_norm=3 * len(gforms))
        print(f"groupnorm path ({len(gforms)} calls): launches {counts}")
        check(counts == want, f"launches {counts} != {want}")
        worst = 0.0
        for name, kw in gforms.items():
            y = outs[name]
            ref = GN.fused_group_norm_plain(**kw)
            again = GN.fused_group_norm(**kw)
            torch.cuda.synchronize()
            m = ref.float().abs().max().item()
            bf = kw["x"].dtype == bf16
            tol = ulp(m) if bf else 1e-5 * m
            err = (y.float() - ref.float()).abs().max().item()
            ndiff = (y != ref).sum().item()
            same = torch.equal(y, again)
            print(f"fused_group_norm {name}: max_abs_err {err} (tolerance "
                  f"{tol}: {'1 bf16 ulp' if bf else '1e-5'} of max|ref| {m});"
                  f" {ndiff} of {y.numel()} values differ; two runs "
                  f"bit-identical: {same}; finite: "
                  f"{bool(torch.isfinite(y).all())}")
            check(y.shape == kw["x"].shape and y.dtype == kw["x"].dtype
                  and bool(torch.isfinite(y).all()) and err <= tol and same,
                  f"fused_group_norm {name} differs from its plain version")
            worst = max(worst, err)
            del ref, again
        report["fused_group_norm"] = {"max_abs_err": worst}
        report["groupnorm"] = {"launches": counts}
        return gforms
    gforms = run.phase("groupnorm", groupnorm)

    # ---------------------------------------------------------------- 8
    def wtile():
        """K7's path: its entry point at bench_wtile.py's nine shapes
        (batch 1, bf16, weights * 0.05 as there), and its VJP at the
        first with the JAX test's loss sum(y^2)."""
        ins = {f"{ci}->{co} @({D},{H},{W})": (rnd((1, D, H, W, ci)),
                                              rnd((3, 3, 3, ci, co), 0.05))
               for ci, co, D, H, W in K7_SHAPES}
        first = next(iter(ins))

        def path():
            ys = {k: K7.wtile_conv3d(x, w) for k, (x, w) in ins.items()}
            x, w = (t.clone().requires_grad_() for t in ins[first])
            loss = (K7.wtile_conv3d(x, w).float() ** 2).sum()
            return ys, torch.autograd.grad(loss, [x, w])

        (ys, grads), counts = request_counts(path)
        want = launches_of(conv3d_same=len(ins) + 2)
        print(f"wtile path ({len(ins)} forwards, one VJP): launches {counts}")
        check(counts == want, f"launches {counts} != {want}")
        # K7's launch geometry at each shape, and its kernels' ptxas report
        for k, (x, w) in ins.items():
            print(f"conv3d_same {k}: launch "
                  f"{K7.conv3d_same_plan(*x.shape[:4], *w.shape[3:])}")
        log = built.log.splitlines()
        if not log:
            print("conv3d_same kernels: build reused, no ptxas report")
        for i, line in enumerate(log):
            if "entry function" in line and "conv3d_same" in line:
                info = [x.strip().removeprefix("ptxas info    : ")
                        for x in log[i + 1:i + 4]
                        if "Used" in x or "spill" in x]
                print(f"  {line.split(chr(39))[1]}: {'; '.join(info)}")
        # no float atomics: a second run gives the same bits
        for k, (x, w) in ins.items():
            check(torch.equal(ys[k], K7.conv3d_same(x, w)),
                  f"conv3d_same {k}: two runs differ")
        print(f"conv3d_same: two runs bit-identical at all {len(ins)} "
              f"shapes")
        worst = 0.0
        # every shape: M 256 with N 32, 64 and 128, M 128 with KC 64
        for k in ins:
            y, ref = ys[k], K7.wtile_conv3d_plain(*ins[k])
            torch.cuda.synchronize()
            m = ref.float().abs().max().item()
            err = (y.float() - ref.float()).abs().max().item()
            print(f"conv3d_same {k}: max_abs_err {err} (tolerance "
                  f"{2 ** -7 * m} = 2^-7 max|ref|); finite: "
                  f"{bool(torch.isfinite(y).all())}")
            check(y.shape == ref.shape and bool(torch.isfinite(y).all())
                  and err <= 2 ** -7 * m,
                  f"conv3d_same {k} differs from its plain version")
            worst = max(worst, err)
            del ref
        del ys
        x, w = (t.clone().requires_grad_() for t in ins[first])
        loss = (K7.wtile_conv3d_plain(x, w).float() ** 2).sum()
        refs = torch.autograd.grad(loss, [x, w])
        errs = []
        for label, a, b in zip(("dx", "dw"), grads, refs):
            e = (a.float() - b.float()).abs().max().item()
            m = b.float().abs().max().item()
            errs.append(f"{label} {e} (tolerance {2 ** -5 * m})")
            check(e <= 2 ** -5 * m, f"wtile_conv3d VJP: {label} differs "
                  f"from autograd through the plain version")
        print(f"wtile_conv3d VJP {first}, loss sum(y^2): max_abs_err "
              + ", ".join(errs))
        report["conv3d_same"] = {"max_abs_err": worst}
        report["wtile"] = {"launches": counts}
        return ins
    k7_in = run.phase("wtile", wtile)

    # ---------------------------------------------------------------- 9
    def time_forms(name, fs):
        """CUDA-event ms of each form of kernel ``name``: (shape, kernel,
        plain version, library call or None, (bound ms, bound by), reps,
        [pieces timed apart, [extra keys]]) -> one row each."""
        timed = []
        for shape, kern, plain, lib, (bms, by), reps, *more in fs:
            pieces, extra = (*more, {}, {})[:2]
            ms = event_ms(kern, reps)
            if name.startswith("up_k2s2_into_halo"):
                extra = {"bound_share": bms / ms}
            pms = event_ms(plain, max(reps // 2, 3))
            lms = event_ms(lib, reps) if lib else None
            ms2 = event_ms(kern, reps)   # kernel again: spread in a call
            row = {"shape": shape, "ms": ms, "ms_again": ms2,
                   "plain_ms": pms, "library_ms": lms,
                   "bound_ms": bms, "bound_by": by, **extra}
            for piece, fn in pieces.items():
                row[f"{piece}_ms"] = event_ms(fn, reps)
            print(f"{name} {shape}: kernel {ms:.4f} / {ms2:.4f} ms, "
                  f"plain {pms:.4f} ms, library "
                  + ("none" if lms is None else f"{lms:.4f} ms")
                  + f", bound {bms:.4f} ms ({by})" + "".join(
                      f", {k} {row[k]:.4f}" for k in
                      [*extra, *(f"{p}_ms" for p in pieces)]))
            timed.append(row)
        return timed

    def total_sampled(fwd, label="conv3d_same"):
        """K7's forwards at the nine benchmark shapes, summed."""
        tk, tl = (sum(r[k] for r in fwd) for k in ("ms", "library_ms"))
        print(f"TOTAL sampled: F.conv3d {tl:.3f} ms  {label} "
              f"{tk:.3f} ms  ({tl / tk:.2f}x)")

    def kernel_entry(name, src, line, timed, main=0):
        """The kernels line's entry of kernel ``name`` (its launches are
        filled in at the end), its main form's numbers on top."""
        m = timed[main]
        return {
            "name": name, "route": "cuda",
            "source": f"{PKG}/csrc/{src}",
            "replaces": f"{REF}/ops/pallas/{line}",
            "launches": None, "launches_by_path": None,   # below
            "max_abs_err": report[name]["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "shape": m["shape"],
            "forms": timed}

    # the timing rows of each kernel form: (shape, kernel, plain version,
    # library call, (bound ms, bound by), reps[, pieces timed apart]); the
    # bound's operations at ``peak`` (bf16 tensor cores by default)
    def conv_row(name, kw, reps, peak=PEAK_BF16_FLOPS):
        """K1 at one call form."""
        xs, w = kw["xs"], kw["w"]
        y = T.conv3d_halo(emit_stats=True, **kw)[0]
        xcat = torch.cat([T.halo_to_normal(t) for t in xs], -1).permute(
            0, 4, 1, 2, 3)
        wn = w.permute(4, 3, 0, 1, 2).contiguous()
        n = xs[0].shape[0] * T.interior_count(xs[0])
        flops = 2.0 * 27 * w.shape[3] * w.shape[4] * n
        return (name, lambda: T.conv3d_halo(emit_stats=True, **kw),
                lambda: T.conv3d_halo_plain(emit_stats=True, **kw),
                lambda: F.conv3d(xcat, wn, padding=1),
                bound_ms(nbytes(*xs, w, kw.get("in_mul0"),
                                kw.get("in_scale"), kw.get("in_shift"), y),
                         flops, peak), reps)

    def up_row(label, x2, w2, b2, reps, peak=PEAK_BF16_FLOPS):
        """K2 at one level."""
        y2 = T.up_k2s2_into_halo_plain(x2, w2, b2)
        x2n = x2.permute(0, 4, 1, 2, 3)          # channels-last NCDHW
        w2n = w2.flip(0, 1, 2).permute(3, 4, 0, 1, 2).contiguous()
        return (label, lambda: T.up_k2s2_into_halo(x2, w2, b2),
                lambda: T.up_k2s2_into_halo_plain(x2, w2, b2),
                lambda: F.conv_transpose3d(x2n, w2n, b2.to(x2.dtype),
                                           stride=2),
                bound_ms(nbytes(x2, w2, b2, y2),
                         2.0 * x2.numel() * 8 * w2.shape[-1], peak), reps)

    def pack_row(x3, reps):
        """K3 at the level-0 window batch."""
        y3 = T.pack_halo_plain(x3)
        return ("(4,128^3,32) -> (4,130^3,32)", lambda: T.pack_halo(x3),
                lambda: T.pack_halo_plain(x3),
                lambda: F.pad(x3, (0, 0, 1, 1, 1, 1, 1, 1)),
                bound_ms(nbytes(x3, y3), 0.0), reps)

    def pool_row(x4, reps):
        """K4 from the level-0 skip; the function reads the interior."""
        y4 = T.pool_into_halo_plain(x4)
        x4n = T.halo_to_normal(x4).permute(0, 4, 1, 2, 3)
        return ("(4,130^3,32) -> (4,66^3,32)", lambda: T.pool_into_halo(x4),
                lambda: T.pool_into_halo_plain(x4),
                lambda: F.pad(F.max_pool3d(x4n, 2), (1, 1, 1, 1, 1, 1)),
                bound_ms(nbytes(x4n, y4), 0.0), reps)

    def train_row(name, xs, w, dy, reps, peak=PEAK_BF16_FLOPS):
        """K6 at one call form: forward + both gradients (the function),
        and the three pieces apart."""
        cis = [x.shape[-1] for x in xs]
        xr = [x.clone().requires_grad_() for x in xs]
        wr = w.clone().requires_grad_()

        def fwd_bwd(fn):
            return lambda: torch.autograd.grad(fn(xr, wr), [wr, *xr], dy)

        xn = torch.cat([T.halo_to_normal(x) for x in xs], -1).permute(
            0, 4, 1, 2, 3)
        wn = w.permute(4, 3, 0, 1, 2).contiguous()
        dyn = T.halo_to_normal(dy).permute(0, 4, 1, 2, 3)

        def library():
            F.conv3d(xn, wn, padding=1)
            torch.ops.aten.convolution_backward(
                dyn, xn, wn, None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
                False, [0, 0, 0], 1, [True, True, False])

        n = xs[0].shape[0] * T.interior_count(xs[0])
        flops = 3 * 2.0 * 27 * sum(cis) * w.shape[-1] * n
        # reads xs, w, dy; writes y, the dxs (as large as the xs), dw
        nb = 2 * nbytes(*xs, w) + 2 * nbytes(dy)
        pieces = {
            "forward": lambda: T.conv3d_halo(xs, w),
            "data_grad": lambda: [T.conv3d_halo_dgrad(dy, w, i, cis)
                                  for i in range(len(xs))],
            "weight_grad": lambda: T.conv3d_halo_wgrad(xs, dy),
        }
        return (name, fwd_bwd(T.conv3d_halo_train),
                fwd_bwd(T.conv3d_halo_train_plain), library,
                bound_ms(nb, flops, peak), reps, pieces)

    def wtile_row(name, x, w, reps, peak=PEAK_BF16_FLOPS):
        """K7 forward at one benchmark shape."""
        xn = x.permute(0, 4, 1, 2, 3)             # channels-last NCDHW
        wn = w.permute(4, 3, 0, 1, 2).contiguous()
        ci, co = w.shape[3], w.shape[4]
        vox = x.numel() // ci
        return (name, lambda: K7.conv3d_same(x, w),
                lambda: K7.wtile_conv3d_plain(x, w),
                lambda: F.conv3d(xn, wn, padding=1),
                bound_ms(nbytes(x, w) + x.element_size() * vox * co,   # + y
                         2.0 * 27 * ci * co * vox, peak), reps)

    def wtile_vjp_row(name, x, w, dy, reps, peak=PEAK_BF16_FLOPS):
        """K7's op: forward + both gradients for a cotangent dy, and the
        three pieces apart."""
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        xn, dyn = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
        wn = w.permute(4, 3, 0, 1, 2).contiguous()

        def fwd_bwd(fn):
            return lambda: torch.autograd.grad(fn(xr, wr), [xr, wr], dy)

        def library():
            F.conv3d(xn, wn, padding=1)
            torch.ops.aten.convolution_backward(
                dyn, xn, wn, None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
                False, [0, 0, 0], 1, [True, True, False])

        flops = 3 * 2.0 * 27 * w.shape[3] * dy.numel()
        # reads x, w, dy; writes y, dx, dw
        nb = 2 * nbytes(x, w) + 2 * nbytes(dy)
        pieces = {
            "forward": lambda: K7.conv3d_same(x, w),
            "data_grad": lambda: K7.conv3d_same_dgrad(dy, w),
            "weight_grad": lambda: K7.conv3d_same_wgrad(x, dy, w.dtype),
        }
        return (f"VJP {name}: forward + data grad + weight grad",
                fwd_bwd(K7.wtile_conv3d), fwd_bwd(K7.wtile_conv3d_plain),
                library, bound_ms(nb, flops, peak), reps, pieces)

    def timings():
        print(f"card before the timings: {card_state()}")

        def gn_row(name):
            """K5 at one form. The library's F.group_norm computes the
            function where it is a GroupNorm alone; beside the fused forms
            it is timed as a piece. The bound counts x (and a residual
            that is not x) read once and y written once; the two passes
            read x twice: their floor is the bound with x's bytes once
            more."""
            kw = gforms[name]
            x, r = kw["x"], kw["residual"]
            xn = x.permute(0, 4, 1, 2, 3)             # channels-last NCDHW
            gm, bt = kw["gamma"].to(x.dtype), kw["beta"].to(x.dtype)

            def gn_alone():
                F.group_norm(xn, kw["num_groups"], gm, bt, 1e-5)

            fused = kw["relu"] or r is not None
            nb = nbytes(x, None if r is x else r, x)  # x, residual, y
            return (name, lambda: GN.fused_group_norm(**kw),
                    lambda: GN.fused_group_norm_plain(**kw),
                    None if fused else gn_alone, bound_ms(nb, 0.0),
                    10 if x.numel() > 3e8 else 20,
                    {"group_norm_alone": gn_alone} if fused else {},
                    {"two_pass_floor_ms": bound_ms(nb + nbytes(x), 0.0)[0]})

        first = next(iter(k7_in))
        # name, source, TPU kernel, [forms: the main path's first]
        rows = [
            ("conv3d_halo", "ps2d_conv3d.cu", "ps2d.py:667",
             [conv_row(n, kw, 10) for n, kw in forms.items()]),
            ("up_k2s2_into_halo", "up_k2s2_into_halo.cu", "ps2d.py:228",
             [up_row(f"{lvl} {shape}", x2, w2, b2, 20)
              for lvl, (x2, w2, b2, shape) in k2_in.items()]),
            ("pack_halo", "pack_halo.cu", "ps2d.py:167",
             [pack_row(k3_in[0], 20)]),
            ("pool_into_halo", "pool_into_halo.cu", "ps2d.py:316",
             [pool_row(k4_in, 20)]),
            # K6: forward, data gradients (K1) and weight gradient
            # (library), against autograd through the plain version
            ("conv3d_halo_train", "ps2d_conv3d.cu", "ps2d.py:840",
             [train_row(n, *v, 5) for n, v in forms6.items()]),
            ("fused_group_norm", "group_norm.cu", "groupnorm.py:68",
             [gn_row(n) for n in gforms]),
            # K7: the nine benchmark shapes, then the VJP at the first
            ("conv3d_same", "conv3d_same.cu", "conv3d.py:338",
             [wtile_row(n, x, w, 5 if x.numel() > 2e8 else 20)
              for n, (x, w) in k7_in.items()]
             + [wtile_vjp_row(first, *k7_in[first],
                              rnd(k7_in[first][0].shape[:-1]
                                  + (k7_in[first][1].shape[-1],)), 3)]),
        ]
        # the main form of each kernel: dec0.conv1 for K1
        main_form = {"conv3d_halo": 1}
        out = []
        for name, src, line, fs in rows:
            timed = time_forms(name, fs)
            if name == "conv3d_same":
                total_sampled(timed[:len(k7_in)])
            out.append(kernel_entry(name, src, line, timed,
                                    main_form.get(name, 0)))
        return out
    kernels_json = run.phase("timings", timings)
    print(f"card after the timings: {card_state()}")

    # ---------------------------------------------------------------- 13
    def f32region():
        """The f32 forms of K1-K4, K6 and K7: each against its plain
        version at the serving shapes (K3, K4 bit-exact; the convs within
        1e-5 max|ref|; two runs bit-identical); the full-width f32
        request and five f32 train steps on them, held to the f32 normal
        path given K1's weights rounded to bf16 (the same function);
        then the forms' timings, the f32 request and train step beside
        the f32 normal path's. Returns the kernels line's f32 entries."""
        f32 = torch.float32
        peak = f32_peak()
        print(f"f32 peak (132 SMs x 128 lanes x 2 x the max SM clock): "
              f"{peak / 1e12:.2f} TFLOP/s")

        def rnd32(shape, s=1.0):
            return torch.randn(shape, device=dev, generator=g) * s

        def hold(label, got, ref, exact=False):
            """got against ref: f32, finite, within 1e-5 max|ref| (or
            equal); returns the max abs error."""
            check(got.dtype == f32 and got.shape == ref.shape
                  and bool(torch.isfinite(got).all()), f"{label}: bad output")
            e = (got - ref).abs().max().item()
            tol = 0.0 if exact else 1e-5 * ref.abs().max().item()
            check(e <= tol, f"{label}: max_abs_err {e} > tolerance {tol}")
            return e, tol

        def halo_zero(y):
            return (y * (1 - T.halo_mask(y))).abs().max().item() == 0

        # ---- each f32 form against its plain version
        x3 = rnd32((B, S, S, S, C))
        e3, _ = hold("pack_halo f32", T.pack_halo(x3), T.pack_halo_plain(x3),
                     exact=True)
        x4 = T.pack_halo_plain(x3)
        e4, _ = hold("pool_into_halo f32", T.pool_into_halo(x4),
                     T.pool_into_halo_plain(x4), exact=True)
        print(f"pack_halo f32 (4,128^3,32): max_abs_err {e3}; pool_into_halo "
              f"f32 (4,130^3,32)->(4,66^3,32): max_abs_err {e4} (tolerance 0)")
        report["pack_halo_f32"] = {"max_abs_err": e3}
        report["pool_into_halo_f32"] = {"max_abs_err": e4}

        k2, worst = {}, 0.0
        for lvl, (d2, ci, co) in k2_levels.items():
            x2, w2 = rnd32((B, d2, d2, d2, ci)), rnd32((2, 2, 2, ci, co), 0.1)
            b2 = rnd32((co,), 0.1)
            torch.full((B, *(2 * d2 + 2,) * 3, co), float("nan"), device=dev)
            got = T.up_k2s2_into_halo(x2, w2, b2)
            same = torch.equal(got, T.up_k2s2_into_halo(x2, w2, b2))
            e, tol = hold(f"up_k2s2_into_halo f32 {lvl}", got,
                          T.up_k2s2_into_halo_plain(x2, w2, b2))
            shape = f"(4,{d2}^3,{ci})->(4,{2 * d2 + 2}^3,{co})"
            print(f"up_k2s2_into_halo f32 {lvl} {shape}: max_abs_err {e} "
                  f"(tolerance {tol}); halo exactly zero: {halo_zero(got)}; "
                  f"two runs bit-identical: {same}")
            check(halo_zero(got) and same, f"up_k2s2_into_halo f32 {lvl}")
            k2[lvl], worst = (x2, w2, b2, shape), max(worst, e)
            del got
        report["up_k2s2_into_halo_f32"] = {"max_abs_err": worst}

        forms32 = k1_forms(f32)
        worst = 0.0
        for name, kw in forms32.items():
            y, (s1, s2) = T.conv3d_halo(emit_stats=True, **kw)
            y2, (t1, t2) = T.conv3d_halo(emit_stats=True, **kw)
            yr, (r1, r2) = T.conv3d_halo_plain(emit_stats=True, **kw)
            e, tol = hold(f"conv3d_halo f32 {name}", y, yr)
            for s, r in ((s1, r1), (s2, r2)):
                hold(f"conv3d_halo f32 {name} stats", s, r)
            same = (torch.equal(y, y2) and torch.equal(s1, t1)
                    and torch.equal(s2, t2))
            xs = kw["xs"]
            geo = T.conv3d_halo_plan(
                B, *(n - 2 for n in xs[0].shape[1:4]), xs[0].shape[-1],
                sum(x.shape[-1] for x in xs[1:]), kw["w"].shape[-1], f32)
            print(f"conv3d_halo f32 {name}: max_abs_err {e} (tolerance "
                  f"{tol} = 1e-5 max|ref|); stats within 1e-5; two runs "
                  f"bit-identical (y, stats): {same}; halo zero: "
                  f"{halo_zero(y)}; launch {geo}")
            check(same and halo_zero(y), f"conv3d_halo f32 {name}")
            worst = max(worst, e)
            del y, y2, yr
        for i, line in enumerate(built.log.splitlines()):
            if "entry function" in line and "_f32" in line:
                info = [x.strip().removeprefix("ptxas info    : ")
                        for x in built.log.splitlines()[i + 1:i + 4]
                        if "Used" in x or "spill" in x]
                print(f"  {line.split(chr(39))[1]}: {'; '.join(info)}")
        report["conv3d_halo_f32"] = {"max_abs_err": worst}

        TB = 2
        k6, worst = {}, 0.0
        for name, cis in {"enc0.conv2 (2,130^3,32)->32": (C,),
                          "dec0.conv1 2x(2,130^3,32)->32": (C, C),
                          "dec0.conv2 (2,130^3,32)->32": (C,)}.items():
            xs = tuple(T.pack_halo_plain(rnd32((TB, S, S, S, c))) for c in cis)
            w = rnd32((3, 3, 3, sum(cis), C), (2 / (27 * C)) ** 0.5)
            dy = T.pack_halo_plain(rnd32((TB, S, S, S, C)))
            dy = dy + 100 * rnd32(dy.shape) * (1 - T.halo_mask(dy))

            def run_k6(fn):
                xr = [x.clone().requires_grad_() for x in xs]
                wr = w.clone().requires_grad_()
                y = fn(xr, wr)
                gr = torch.autograd.grad(y, [wr, *xr], dy)
                return [y.detach(), *gr]

            errs = []
            got, ref = run_k6(T.conv3d_halo_train), run_k6(
                T.conv3d_halo_train_plain)
            for label, a, b in zip(["y", "dw"] + [f"dx{i}" for i in
                                                  range(len(xs))], got, ref):
                e, tol = hold(f"K6 f32 {name} {label}", a, b)
                errs.append(f"{label} {e:.3e} (tolerance {tol:.3e})")
                worst = max(worst, e)
            check(all(halo_zero(dx) for dx in got[2:]), "K6 f32 dx halo")
            print(f"conv3d_halo_train f32 {name}: max_abs_err "
                  + ", ".join(errs))
            k6[name] = (xs, w, dy)
        report["conv3d_halo_train_f32"] = {"max_abs_err": worst}

        k7 = {f"{ci}->{co} @({D},{H},{W})": (rnd32((1, D, H, W, ci)),
                                             rnd32((3, 3, 3, ci, co), 0.05))
              for ci, co, D, H, W in K7_SHAPES}
        first = next(iter(k7))

        def wtile_path():
            ys = {k: K7.wtile_conv3d(x, w) for k, (x, w) in k7.items()}
            x, w = (t.clone().requires_grad_() for t in k7[first])
            loss = (K7.wtile_conv3d(x, w) ** 2).sum()
            return ys, torch.autograd.grad(loss, [x, w])

        (ys, grads), wcounts = request_counts(wtile_path)
        check(wcounts == launches_of(conv3d_same=len(k7) + 2),
              f"f32 wtile path launches {wcounts}")
        worst = 0.0
        for k, (x, w) in k7.items():
            check(torch.equal(ys[k], K7.conv3d_same(x, w)),
                  f"conv3d_same f32 {k}: two runs differ")
            e, tol = hold(f"conv3d_same f32 {k}", ys[k],
                          K7.wtile_conv3d_plain(x, w))
            print(f"conv3d_same f32 {k}: max_abs_err {e} (tolerance {tol});"
                  f" two runs bit-identical; launch "
                  f"{K7.conv3d_same_plan(*x.shape[:4], *w.shape[3:], f32)}")
            worst = max(worst, e)
        del ys
        x, w = (t.clone().requires_grad_() for t in k7[first])
        refs = torch.autograd.grad((K7.wtile_conv3d_plain(x, w) ** 2).sum(),
                                   [x, w])
        errs = [f"{lb} {hold(f'wtile_conv3d f32 VJP {lb}', a, b)[0]:.3e}"
                for lb, a, b in zip(("dx", "dw"), grads, refs)]
        print(f"wtile_conv3d f32 VJP {first}, loss sum(y^2): max_abs_err "
              + ", ".join(errs) + f"; wtile path launches {wcounts}")
        del grads, refs, x, w
        report["conv3d_same_f32"] = {"max_abs_err": worst}

        # ---- the full-width f32 request on the region's f32 forms
        conf = cfg.Config(model=cfg.ModelConfig(
            compute_dtype="float32", ps2d_eval=True, ps2d_levels=2))
        pred = Predictor(conf, seed=0)
        check(pred.seg_model.compute_dtype == f32
              and pred.seg_model.halo_levels((S, S, S)) == 2,
              "not the f32 level-2 region")
        joint = models.UNet3DWithClassifier(seed=0)
        tree = models.to_flax_variables(joint.state_dict())
        del joint
        pred.load_joint_grade(tree["params"], tree["batch_stats"])
        # the f32 normal path, given K1's weights rounded to bf16
        sd = pred.seg_model.state_dict()
        for k in pred.seg_model.k1_kernel_names(2):
            sd[k] = sd[k].to(torch.bfloat16).float()
        normal = Predictor(cfg.Config(model=cfg.ModelConfig(
            compute_dtype="float32")), seed=0)
        normal.seg_model.load_state_dict(sd)
        normal.joint_model = pred.joint_model

        def request(p, vol):
            lab, cf = p.segment_with_confidence(vol, mode="cropped")
            return lab, cf, p.classify_tumor(vol, lab), p.classify_grade(vol)

        want = launches_of(conv3d_halo=14, up_k2s2_into_halo=4, pack_halo=4,
                           pool_into_halo=2)
        secs = {"region": [], "normal": []}
        for s, vol in enumerate(vols[:2]):
            t = time.perf_counter()
            (lab, cf, name, grade), counts = request_counts(
                lambda: request(pred, vol))
            secs["region"].append(time.perf_counter() - t)
            inside, bucket, offs = check_labels(lab, vol, conf, "(f32 region)")
            check(not lab[~inside].any() and np.isfinite(cf).all()
                  and grade is not None, "bad f32 region request")
            print(f"f32 region request, volume seed {s}: bucket {bucket}; "
                  f"classify {name}; grade {grade}; "
                  f"{secs['region'][-1]:.3f} s; launches {counts}")
            check(counts == want, f"launches {counts} != {want}")
        fcounts = counts
        for side in ("normal", "region", "region", "normal"):
            p = pred if side == "region" else normal
            t = time.perf_counter()
            (_, _, _, _), counts = request_counts(lambda: request(p, vols[0]))
            secs[side].append(time.perf_counter() - t)
            check(counts == (want if side == "region" else launches_of()),
                  f"{side} request launches {counts}")
        print(f"f32 requests (volume seed 0; region first two volumes, then "
              f"alternated): region {[round(v, 4) for v in secs['region']]} "
              f"s, normal path {[round(v, 4) for v in secs['normal']]} s")

        # one window batch (4 x 128^3): the region against the normal path
        offs, bucket = cropping.plan_crop(
            vols[0], multiple=16, min_size=S,
            ladder=conf.inference.crop_bucket_ladder)
        crop = torch.from_numpy(cropping.extract_crop(pred._canon(vols[0]),
                                                      offs, bucket)).to(dev)
        starts = [sw.compute_patch_starts(d, S, 0.5) for d in bucket]
        wins = [(a, b, c) for a in starts[0] for b in starts[1]
                for c in starts[2]][:4]
        x = torch.stack([crop[a:a + S, b:b + S, c:c + S] for a, b, c in wins])
        out, ref = pred.seg_model(x), normal.seg_model(x)
        scale = max(ref.abs().max().item(), 1.0)
        d = (out - ref).abs().max().item()
        unrounded = models.UNet3D(seed=0, compute_dtype="float32")
        unrounded.load_state_dict(pred.seg_model.state_dict())
        unrounded.eval()
        du = (out - unrounded(x)).abs().max().item()
        del unrounded, crop
        print(f"f32 region window batch {tuple(x.shape)} vs the f32 normal "
              f"path with K1's weights rounded to bf16 (TF32 off): max "
              f"|d logit| {d:.3e} (bound {1e-4 * scale:.3e} = 1e-4 max(scale,"
              f" 1)); against unrounded weights {du:.3e}")
        check(bool(torch.isfinite(out).all()) and d <= 1e-4 * scale,
              "f32 region logits drift from the normal path")
        del pred, normal, out, ref, x

        # ---- five f32 train steps on K6 (K1's f32 form)
        tconf = cfg.Config()
        mc = tconf.model
        gen = torch.Generator(device=dev).manual_seed(1)
        image = torch.randn((TB, S, S, S, 4), device=dev, generator=gen)
        mask = (torch.rand((TB, S, S, S), device=dev, generator=gen)
                < 0.2).long() * 2
        batch = {"image": image, "mask": mask}

        def new32(ps2d=True, rate=mc.dropout_rate):
            return models.UNet3D(features=mc.features, ps2d_train=ps2d,
                                 remat=mc.remat, dropout_rate=rate, seed=0,
                                 compute_dtype="float32")

        step = train_mod.make_train_step(tconf)
        state = train_mod.create_train_state(new32(), tconf,
                                             steps_per_epoch=10)
        tw = launches_of(conv3d_halo=7)
        losses, step_ms, ttotal = [], [], dict.fromkeys(tw, 0)
        torch.cuda.reset_peak_memory_stats()
        for i in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

            def one():
                ev[0].record()
                o = step(state, batch, gen)
                ev[1].record()
                return o

            (_, m), counts = request_counts(one)
            step_ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(m["loss"]))
            print(f"f32 train step {i}: loss {losses[-1]:.5f}; "
                  f"{step_ms[-1]:.1f} ms; launches {counts}")
            check(counts == tw, f"launches {counts} != {tw}")
            ttotal = {k: ttotal[k] + counts[k] for k in ttotal}
        peak_b = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)), f"non-finite f32 loss {losses}")
        # the same steps on the f32 normal path, alternated with the region
        states = {"region": state, "normal": train_mod.create_train_state(
            new32(ps2d=False), tconf, steps_per_epoch=10)}
        step(states["normal"], batch, gen)           # first call, untimed
        tsecs = {"region": [], "normal": []}
        for side in ("normal", "region", "region", "normal"):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            step(states[side], batch, gen)
            e1.record()
            torch.cuda.synchronize()
            tsecs[side].append(e0.elapsed_time(e1))
        del states, state
        print(f"f32 train steps (CUDA events): region "
              f"{[round(v, 2) for v in step_ms]} then "
              f"{[round(v, 2) for v in tsecs['region']]} ms, normal path "
              f"{[round(v, 2) for v in tsecs['normal']]} ms; peak "
              f"{peak_b / 2 ** 30:.2f} GiB")

        # the region's loss and gradients against the normal path's with
        # K1's weights rounded, dropout off
        loss_fn = train_mod.make_loss_fn(tconf)
        conv_mod = import_module(PKG + ".ops.conv")

        def loss_grads(model):
            with conv_mod.full_f32():
                out = model.forward_train(image)
                loss = loss_fn(out, mask)
                names, params = zip(*model.named_parameters())
                gs = torch.autograd.grad(loss, params, allow_unused=True)
            return float(loss.detach()), dict(zip(names, gs))

        km = new32(rate=0.0)
        lk, gk = loss_grads(km)
        nm = new32(ps2d=False, rate=0.0)
        sd = km.state_dict()
        for k in km.k1_kernel_names(1):
            sd[k] = sd[k].to(torch.bfloat16).float()
        nm.load_state_dict(sd)
        ln, gn = loss_grads(nm)
        del km, nm
        # every leaf of 8 values or more (a cosine says nothing of a
        # scalar; tests/test_torch_train_step.py's rule)
        cmin, rdev, n, worst = 1.0, 0.0, 0, ""
        for k, b in gn.items():
            a = gk[k]
            if a is None or b is None:      # a head the loss does not read
                check(a is None and b is None, f"f32 gradient of {k} on one "
                      f"side only")
                continue
            check(bool(torch.isfinite(a).all()), f"f32 gradient of {k}")
            a, b = a.reshape(-1), b.reshape(-1)
            na, nb = a.norm().item(), b.norm().item()
            if k == "head_conv.bias" or nb < 1e-6 or b.numel() < 8:
                continue          # zero in exact arithmetic (BatchNorm next)
            cmin = min(cmin, (a @ b).item() / (na * nb))
            if abs(na / nb - 1) > rdev:
                rdev, worst = abs(na / nb - 1), k
            n += 1
        print(f"f32 train region vs normal path (K1's weights rounded): loss "
              f"{lk:.7f} vs {ln:.7f} (rel {abs(lk - ln) / abs(ln):.2e}, bound "
              f"1e-5); {n} gradient leaves: least cosine {cmin:.6f} (bound "
              f"0.9999), largest |norm ratio - 1| {rdev:.2e} at {worst} "
              f"(bound 1e-3)")
        check(abs(lk - ln) <= 1e-5 * max(abs(ln), 1.0) and cmin >= 0.9999
              and rdev <= 1e-3 and n >= 40, "f32 region train drifts")
        del gk, gn
        report["f32region"] = {
            "launches": fcounts, "train_launches": ttotal,
            "wtile_launches": wcounts, "request_s": secs,
            "train_step_ms": {"steps": step_ms, **tsecs},
            "train_losses": losses, "train_peak_bytes": peak_b,
            "drift_vs_normal": d, "drift_unrounded": du,
            "train_cosine_min": cmin}

        # ---- the f32 forms' timings
        print(f"card before the f32 timings: {card_state()}")

        rows = [
            ("conv3d_halo_f32", "ps2d_conv3d_f32.cu", "ps2d.py:667",
             [conv_row(n, kw, 5, peak) for n, kw in forms32.items()]),
            ("up_k2s2_into_halo_f32", "up_k2s2_into_halo_f32.cu",
             "ps2d.py:228", [up_row(f"{lvl} {shape}", x2, w2, b2, 10, peak)
                             for lvl, (x2, w2, b2, shape) in k2.items()]),
            ("pack_halo_f32", "pack_halo.cu", "ps2d.py:167",
             [pack_row(x3, 10)]),
            ("pool_into_halo_f32", "pool_into_halo.cu", "ps2d.py:316",
             [pool_row(x4, 10)]),
            ("conv3d_halo_train_f32", "ps2d_conv3d_f32.cu", "ps2d.py:840",
             [train_row(n, *v, 3, peak) for n, v in k6.items()]),
            ("conv3d_same_f32", "conv3d_same_f32.cu", "conv3d.py:338",
             [wtile_row(n, x, w, 3 if x.numel() > 2e8 else 10, peak)
              for n, (x, w) in k7.items()]
             + [wtile_vjp_row(first, *k7[first],
                              rnd32(k7[first][0].shape[:-1]
                                    + (k7[first][1].shape[-1],)), 2, peak)]),
        ]
        out = []
        for name, src, line, fs in rows:
            timed = time_forms(name, fs)
            if name == "conv3d_same_f32":
                total_sampled(timed[:len(k7)], name)
            out.append(kernel_entry(name, src, line, timed,
                                    1 if name == "conv3d_halo_f32" else 0))
        print(f"card after the f32 timings: {card_state()}")
        return out

    # the later slices' paths run after the timings, so that they leave
    # the kernels' readings as the earlier runs took them; first the
    # tensors of the kernel phases go
    del forms, k3_in, k2_in, k4_in, forms6, gforms, k7_in
    torch.cuda.empty_cache()
    # ---------------------------------------------------------------- 14
    def cli():
        """The headless batch path: the host library, a BraTS-layout
        cohort of the three volumes (int16 .nii.gz, gzip level 1, a seg
        with enhancing tumour stored as 4, one case at 1x1x1.5 mm), each
        file's native decode against the NumPy codec, the predict CLI as
        users run it (pass A) and through its seam at the serving setting
        (pass B), then the evaluate CLI on pass B's masks."""
        import gzip
        import logging
        import os
        import re
        import shutil
        import tempfile
        from concurrent.futures import ThreadPoolExecutor
        from dataclasses import replace

        from scipy import ndimage
        CLI = import_module(PKG + ".inference.cli")
        EV = import_module(PKG + ".inference.evaluate")
        hn = import_module(PKG + ".data.native")
        ds = import_module(PKG + ".data.dataset")
        nifti = import_module(PKG + ".data.nifti")
        pre = import_module(PKG + ".data.preprocess")

        # 1. the host library (built beside the kernels in phase build)
        probe = subprocess.run(
            ["sh", "-c", "g++ --version | head -n 1; echo | g++ -fopenmp "
             "-x c - -E >/dev/null && echo 'openmp: ok'; ls "
             "/usr/include/zlib.h"], capture_output=True, text=True,
            timeout=120)
        print("host toolchain: " + "; ".join(
            (probe.stdout + probe.stderr).strip().splitlines()))
        if hn.available():
            print(f"host native: {hn.library_path().name}, built in "
                  f"{report['host_build_s']:.2f} s, {hn.host_threads()} "
                  f"OpenMP threads")
        else:
            print(f"host native: unavailable ({report['host_build_log']}); "
                  f"holding the plain paths instead")

        tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
        try:
            # 2. the cohort: <case>/<case>_{modality}.nii.gz in int16 and
            # <case>_seg.nii.gz in uint8, as BraTS ships them
            root = os.path.join(tmp, "cohort")
            mods = cfg.BRATS_MODALITIES
            spacing = {0: None, 1: np.diag([1.0, 1.0, 1.5, 1.0]), 2: None}
            gts = {}
            jobs = []
            for s, vol in enumerate(vols):
                cid = f"BraTS-Smoke-{s:04d}"
                os.makedirs(os.path.join(root, cid))
                tumour = vol[..., 0] > 0.95
                seg = np.zeros(VOLUME_SHAPE, np.uint8)
                seg[tumour] = 2
                seg[ndimage.binary_erosion(tumour, iterations=4)] = 4
                seg[ndimage.binary_erosion(tumour, iterations=8)] = 1
                gts[cid] = seg
                for m, mod in enumerate(mods):
                    jobs.append((os.path.join(root, cid, f"{cid}_{mod}.nii.gz"),
                                 np.round(vol[..., m] * 1000).astype(np.int16),
                                 spacing[s]))
                jobs.append((os.path.join(root, cid, f"{cid}_seg.nii.gz"), seg,
                             spacing[s]))

            def write(job):
                path, data, affine = job
                with open(path, "wb") as f:
                    f.write(gzip.compress(nifti.encode(data, affine=affine),
                                          compresslevel=1))
            t = time.perf_counter()
            with ThreadPoolExecutor(8) as pool:
                list(pool.map(write, jobs))
            print(f"cli cohort: 3 cases x (4 int16 + 1 seg) .nii.gz of "
                  f"{VOLUME_SHAPE} written in {time.perf_counter() - t:.2f} s")

            # 3. every file: the native decode bit-equal to the NumPy codec
            decode = {"native": [], "numpy": []}
            for path, data, _ in jobs:
                t = time.perf_counter()
                a = hn.read_nifti(path)
                t_native = time.perf_counter() - t
                t = time.perf_counter()
                b = nifti.load_volume(path)
                t_numpy = time.perf_counter() - t
                if hn.available():
                    check(a is not None and a.dtype == b.dtype
                          and np.array_equal(a, b)
                          and np.array_equal(b, data.astype(np.float32)),
                          f"{os.path.basename(path)}: native decode differs "
                          "from the NumPy codec")
                    decode["native"].append(1e3 * t_native)
                decode["numpy"].append(1e3 * t_numpy)
                print(f"  decode {os.path.basename(path)}: native "
                      f"{1e3 * t_native:.2f} ms, NumPy codec "
                      f"{1e3 * t_numpy:.2f} ms"
                      + (", bit-equal" if hn.available() else ""))

            stages = []

            class Stages(logging.Handler):
                """The CLI's per-case stage lines; the launch counts at
                each case's closing line."""

                def emit(self, record):
                    msg = record.getMessage()
                    m = re.fullmatch(r"case (\S+) (\w+): ([0-9.]+) ms", msg)
                    if m:
                        stages.append((m.group(1), m.group(2),
                                       float(m.group(3))))
                    elif re.fullmatch(r"\S+: \d+ tumor voxels in .*", msg):
                        stages.append((msg.split(":")[0], "launches",
                                       {k.__name__: k.launches
                                        for k in counted}))
                    elif record.levelno >= logging.WARNING:
                        print(self.format(record), file=sys.stderr)
            log = logging.getLogger(CLI.__name__)
            handler = Stages()
            log.addHandler(handler)
            log.setLevel(logging.INFO)

            def cases_of(before=None):
                rows, prev = {}, dict(before or {})
                for cid, stage, v in stages:
                    row = rows.setdefault(cid, {})
                    if stage == "launches":
                        row["launches"] = {k: v[k] - prev.get(k, 0)
                                           for k in v}
                        prev = v
                    else:
                        row[stage] = v
                return rows

            def norm_of(case_dir, cid):
                raw = np.stack([ds.load_any_volume(os.path.join(
                    case_dir, f"{cid}_{mod}.nii.gz")) for mod in mods], -1)
                return pre.preprocess_multimodal(
                    torch.from_numpy(raw).to(dev), None).cpu().numpy()

            try:
                # 4. pass A, as users run it: the default preset, region off
                out_a = os.path.join(tmp, "pass_a")
                stages.clear()
                t = time.perf_counter()
                summ_a, counts_a = request_counts(lambda: CLI.predict_main(
                    ["--input", root, "--output", out_a, "--checkpoint",
                     "none", "--save_confidence", "--format", "npy"]))
                wall_a = time.perf_counter() - t
                check(not any(counts_a.values()),
                      f"pass A (region off) launched {counts_a}")
                rows_a = cases_of()
                conf_a = cfg.get_config("standard")
                check(not conf_a.model.ps2d_eval
                      and conf_a.model.features == (32, 64, 128, 256, 512),
                      "pass A is not the full-width default preset")
                ref = Predictor(conf_a)
                for sm in summ_a:
                    cid = sm["case_id"]
                    lab, cf = ref.segment_with_confidence(
                        norm_of(os.path.join(root, cid), cid), mode="cropped")
                    got_l = np.load(sm["mask"])
                    got_c = np.load(sm["confidence"])
                    check(got_l.dtype == lab.dtype and np.array_equal(got_l, lab)
                          and got_c.dtype == cf.dtype
                          and np.array_equal(got_c, cf),
                          f"pass A {cid}: mask or confidence differs from "
                          "Predictor.segment_with_confidence")
                del ref
                print(f"cli pass A (predict_main, default preset, region off, "
                      f"npy + confidence): {len(summ_a)} cases in "
                      f"{wall_a:.2f} s, masks and confidences bit-equal to "
                      f"the predictor's; launches {counts_a}")

                # 5. pass B, the seam at the serving setting
                out_b = os.path.join(tmp, "pass_b")
                base = cfg.get_config("standard")
                conf_b = base.replace(model=replace(
                    base.model, ps2d_eval=True, ps2d_levels=2))
                args = CLI.build_parser().parse_args(
                    ["--input", root, "--output", out_b, "--checkpoint",
                     "none", "--report", "--brats_labels", "--format",
                     "nii.gz"])
                stages.clear()
                t = time.perf_counter()
                summ_b, counts_b = request_counts(
                    lambda: CLI._predict(args, conf_b))
                wall_b = time.perf_counter() - t
                rows_b = cases_of()
                per_case = launches_of(conv3d_halo=14, up_k2s2_into_halo=4,
                                       pack_halo=4, pool_into_halo=2)
                check(len(summ_b) == 3 and all(
                    rows_b[s["case_id"]]["launches"] == per_case
                    for s in summ_b), f"pass B launches per case "
                    f"{[rows_b[s['case_id']]['launches'] for s in summ_b]}"
                    f" != {per_case}")
                index = json.load(open(os.path.join(out_b, "predictions.json")))
                check([c["case_id"] for c in index["cases"]] == sorted(gts),
                      f"predictions.json lists {index['cases']}")
                ref = Predictor(conf_b)
                preds = {}
                for sm in summ_b:
                    cid = sm["case_id"]
                    img = os.path.join(root, cid, f"{cid}_{mods[0]}.nii.gz")
                    lab, _ = ref.segment_with_confidence(
                        norm_of(os.path.join(root, cid), cid), mode="cropped")
                    want = np.where(lab == 3, 4, lab).astype(np.uint8)
                    got = nifti.load(sm["mask"])
                    check(got.data.dtype == np.uint8
                          and np.array_equal(got.data, want),
                          f"pass B {cid}: mask differs from the predictor's "
                          "labels with 3 -> 4")
                    check(np.array_equal(nifti.load_affine(sm["mask"]),
                                         nifti.load_affine(img)),
                          f"pass B {cid}: the mask's affine is not its input's")
                    rep = json.load(open(sm["report"]))
                    check(rep.get("quality_metrics", {}).get("estimated")
                          is False, f"pass B {cid}: no GT quality metrics")
                    preds[cid] = want
                del ref
                print(f"cli pass B (_predict, ps2d_eval, ps2d_levels=2, "
                      f"--report --brats_labels, nii.gz at gzip level 9): "
                      f"{len(summ_b)} cases in {wall_b:.2f} s, launches per "
                      f"case {per_case}, masks bit-equal (3 -> 4), affines "
                      f"kept, reports with GT quality metrics")
            finally:
                log.removeHandler(handler)

            # 6. the evaluate CLI on pass B's masks
            t = time.perf_counter()
            res = EV.evaluate_main(["--pred", out_b, "--gt", root])
            eval_s = time.perf_counter() - t
            check(res["n_cases"] == 3, f"evaluated {res['n_cases']} cases")

            def recompute(cid):
                sp = nifti.affine_spacing(nifti.load_affine(os.path.join(
                    root, cid, f"{cid}_seg.nii.gz")))
                return EV.evaluate_case(preds[cid], gts[cid], spacing=sp)
            # the host EDTs release the GIL: one thread a case
            with ThreadPoolExecutor(3) as pool:
                wants = dict(zip(res["cases"], pool.map(recompute,
                                                        res["cases"])))
            for cid, m in res["cases"].items():
                want = wants[cid]
                check(list(m) == list(want) and all(
                    (a == b) or (np.isnan(a) and np.isnan(b))
                    for a, b in zip(m.values(), want.values())),
                    f"evaluate {cid}: {m} != {want}")
            print(f"cli evaluate: 3 cases in {eval_s:.2f} s, each equal to "
                  f"evaluate_case on the arrays (HD95 in the GT header's mm)")

            # 7. timings
            for name, rows, wall in (("A", rows_a, wall_a),
                                     ("B", rows_b, wall_b)):
                for cid, row in rows.items():
                    print(f"  pass {name} {cid}: " + ", ".join(
                        f"{k} {v:.2f} ms" for k, v in row.items()
                        if k != "launches"))
                print(f"  pass {name}: {wall / 3:.3f} s wall per case")
            report["cli"] = {
                "launches": counts_b, "launches_a": counts_a,
                "decode_ms": decode, "wall_a_s": wall_a, "wall_b_s": wall_b,
                "rows_a": rows_a, "rows_b": rows_b, "eval_s": eval_s}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    run.phase("f32", f32)
    run.phase("trainer", trainer)
    run.phase("webtrain", webtrain)
    kernels_json += run.phase("f32region", f32region)
    run.phase("cli", cli)

    # launches per path: the server requests' (K1-K4), the five
    # train steps' (K1, forwards and K6's data gradients), the
    # entry points' of K5 and K7; the f32 forms' on the f32region phase's
    # request, five train steps and K7 path. A bf16 form and its f32 form
    # share their wrapper's count: each path runs one of them.
    paths = {"server": report["launches"],
             "app": report["app"]["launches"],
             "f32": report["f32"]["launches"],
             "train": report["train"]["launches"],
             "trainer": report["trainer"]["launches"],
             "trainer_steps": report["trainer"]["step_launches"],
             "webtrain": report["webtrain"]["launches"],
             "cli": report["cli"]["launches"],
             "groupnorm": report["groupnorm"]["launches"],
             "wtile": report["wtile"]["launches"]}
    paths32 = {"f32region": report["f32region"]["launches"],
               "f32region_train": report["f32region"]["train_launches"],
               "f32region_wtile": report["f32region"]["wtile_launches"]}
    main_path = {"conv3d_halo_train": "train",
                 "fused_group_norm": "groupnorm",
                 "conv3d_same": "wtile",
                 "conv3d_halo_train_f32": "f32region_train",
                 "conv3d_same_f32": "f32region_wtile"}
    train_paths = ("train", "trainer_steps", "f32region_train")

    def launches(name, path):
        """K6 has no kernel of its own: its launches are K1's on
        the train paths, and none on the others."""
        counts = {**paths, **paths32}[path]
        wrapper = name.removesuffix("_f32")
        if wrapper == "conv3d_halo_train":
            return counts["conv3d_halo"] if path in train_paths else 0
        return counts[wrapper]
    for row in kernels_json:
        f32_form = row["name"].endswith("_f32")
        row["launches"] = launches(row["name"], main_path.get(
            row["name"], "f32region" if f32_form else "server"))
        row["launches_by_path"] = {p: launches(row["name"], p)
                                   for p in (paths32 if f32_form else paths)}

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    tr = report["train"]
    print(f"train step (full width, batch 2 of 4x128^3, ps2d_train): "
          f"{tr['step_ms_median_2_5']:.1f} ms steady, peak memory "
          f"{tr['peak_bytes'] / 2 ** 30:.2f} GiB, losses {tr['losses']}")
    tt = report["trainer"]
    print(f"trainer (full width, 2 epochs, patch batches of 2 x 128^3): "
          f"{np.median(tt['event_step_ms'][1:]):.2f} ms a train step "
          f"(CUDA events; host enqueue {np.median(tt['step_ms'][1:]):.2f} ms"
          f"; median of steps 2-4), loader wait {np.mean(tt['loader_wait_ms']):.2f} "
          f"ms a step, validation epochs {tt['val_epoch_ms']} ms, "
          f"checkpoint {tt['checkpoint_bytes'] / 2 ** 20:.2f} MiB saved in "
          f"{tt['save_ms']:.2f} ms and loaded in {tt['load_ms']:.2f} ms, "
          f"peak {tt['peak_bytes'] / 2 ** 30:.2f} GiB, cohort written in "
          f"{tt['cohort_write_s']:.2f} s")
    fr = report["f32region"]
    req, stp = fr["request_s"], fr["train_step_ms"]
    print(f"f32 region (full width, compute_dtype float32): requests "
          f"{[round(v, 4) for v in req['region']]} s against the f32 normal "
          f"path's {[round(v, 4) for v in req['normal']]} s; train steps "
          f"{[round(v, 2) for v in stp['region']]} ms against "
          f"{[round(v, 2) for v in stp['normal']]} ms; launches per request "
          f"{fr['launches']}, per five steps {fr['train_launches']}")
    cl = report["cli"]
    print(f"cli (full width, 3 BraTS-layout cases): pass A "
          f"{cl['wall_a_s'] / 3:.3f} s a case (default preset, npy), pass B "
          f"{cl['wall_b_s'] / 3:.3f} s a case (ps2d_levels=2, report, "
          f"nii.gz); native decode {np.median(cl['decode_ms']['native'] or [0]):.2f}"
          f" ms against the NumPy codec's "
          f"{np.median(cl['decode_ms']['numpy']):.2f} ms per file (median); "
          f"evaluate {cl['eval_s']:.2f} s")
    print(f"total {time.perf_counter() - run.t0:.2f} s")
    print(json.dumps({"kernels": kernels_json}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:              # any failed phase: report, exit non-zero
        traceback.print_exc()
        sys.exit(1)
