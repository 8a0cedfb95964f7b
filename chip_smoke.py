#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device and
the CUDA toolkit. Imports no JAX. Phases, each printing its seconds:

  1. build  — compile the port's kernels (one nvcc call) and load them;
  2. kernels — each kernel against its plain PyTorch version at the
     serving path's shapes (batch 4 windows of 128^3);
  3. slice  — a full-width Predictor (ps2d_eval=True, ps2d_levels=1,
     random weights from a seed) segments three synthetic 240x240x155
     volumes in "cropped" mode; every kernel must have launched; then
     one batch of windows through the kernel path is held against the
     port's normal path on the card;
  4. timings — CUDA-event times of each kernel, its plain version and
     one library call computing the same function, beside its bound.

It prints the per-kernel JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failure, or a run past
its own time budget, exits non-zero without that last line.
"""

from __future__ import annotations

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


def bound_ms(nbytes: float, flops: float):
    """Least time for the work: the larger of the bytes over the HBM
    rate and the bf16 operations over the tensor-core peak."""
    tb, tf = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


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
    """Where one cropped request's time goes: the host steps of
    ``segment_tumor`` timed one by one, then the whole request under
    ``torch.profiler`` for the device's busy share and its top kernels.
    Opt-in (``--profile``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    labels = timed("argmax + copy out", lambda: logits.argmax(-1).to(
        torch.int8).cpu().numpy())
    timed("paste_full", lambda: cropping.paste_full(labels, offs,
                                                    v.shape[:3]))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pred.segment_tumor(vol, mode="cropped")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kern) / 1e3
    print(f"  profiled request: {wall:.2f} ms wall, device busy "
          f"{busy:.2f} ms, idle share {1 - busy / wall:.4f}")
    for e in sorted(kern, key=dev_us, reverse=True)[:15]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main() -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also break one request down (host steps, "
                         "device busy share, top kernels)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    before = set(sys.modules)
    try:
        from importlib import import_module
        T = import_module(PKG + ".ops.ps2d")
        native = import_module(PKG + ".ops.native")
        cfg = import_module(PKG + ".config")
        Predictor = import_module(PKG + ".inference.predictor").Predictor
        UNet3D = import_module(PKG + ".models").UNet3D
        cropping = import_module(PKG + ".inference.cropping")
        sw = import_module(PKG + ".inference.sliding_window")
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    pulled = {m.split(".")[0] for m in set(sys.modules) - before}
    check(not pulled & {"jax", "jaxlib", "flax", REF},
          f"the port imported JAX or the JAX package: {sorted(pulled)}")
    # plain references in full f32 where they compute in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    run = Run()
    report = {}

    # ---------------------------------------------------------------- 1
    def build():
        b = native.build()
        print(f"nvcc: {b.seconds:.2f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print("  " + line.strip())
        native.library()
        return b
    run.phase("build", build)

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, s=1.0, dtype=bf16):
        return (torch.randn(shape, device=dev, generator=g) * s).to(dtype)

    B, S, C = 4, 128, 32    # one sw batch of 128^3 windows, level-0 width

    # ---------------------------------------------------------------- 2
    def kernels():
        x3 = rnd((B, S, S, S, C))
        got, ref = T.pack_halo(x3), T.pack_halo_plain(x3)
        err = (got.float() - ref.float()).abs().max().item()
        print(f"pack_halo (4,128^3,32): max_abs_err {err} (tolerance 0)")
        check(err == 0, "pack_halo differs from its plain version")
        report["pack_halo"] = {"max_abs_err": err}

        x2, w2 = rnd((B, S // 2, S // 2, S // 2, 2 * C)), rnd(
            (2, 2, 2, 2 * C, C), 0.1)
        b2 = rnd((C,), 0.1, torch.float32)
        got, ref = T.up_k2s2_into_halo(x2, w2, b2), \
            T.up_k2s2_into_halo_plain(x2, w2, b2)
        err = (got.float() - ref.float()).abs().max().item()
        m = ref.float().abs().max().item()
        tol = 2.0 ** (np.floor(np.log2(m)) - 7)       # 1 bf16 ulp of max
        print(f"up_k2s2_into_halo (4,64^3,64)->(4,130^3,32): max_abs_err "
              f"{err} (tolerance {tol}: 1 bf16 ulp of max|ref| {m})")
        check(err <= tol, "up_k2s2_into_halo differs from its plain version")
        report["up_k2s2_into_halo"] = {"max_abs_err": err}

        wk = (2.0 / (27 * C)) ** 0.5       # kaiming fan-out scale
        h = [T.pack_halo_plain(rnd((B, S, S, S, C))) for _ in range(2)]
        forms = {
            "enc0.conv2/dec0.conv2 (1 input 32, affine+relu, stats)": dict(
                xs=(h[0],), w=rnd((3, 3, 3, C, C), wk),
                in_scale=1 + rnd((B, C), 0.3), in_shift=rnd((B, C), 0.3),
                in_relu=True),
            "dec0.conv1 (2 inputs 32+32, mask, stats)": dict(
                xs=(h[0], h[1]), w=rnd((3, 3, 3, 2 * C, C), wk),
                in_mul0=T.pack_halo_plain(torch.rand(
                    (B, S, S, S, C), device=dev, generator=g).to(bf16))),
        }
        worst = 0.0
        for name, kw in forms.items():
            xs, w = kw.pop("xs"), kw.pop("w")
            y, (s1, s2) = T.conv3d_halo(xs, w, emit_stats=True, **kw)
            yr, (r1, r2) = T.conv3d_halo_plain(xs, w, emit_stats=True, **kw)
            torch.cuda.synchronize()
            err = (y.float() - yr.float()).abs().max().item()
            tol = 2 ** -7 * yr.float().abs().max().item()
            serr = max(((s - r).abs().max() / r.abs().max()).item()
                       for s, r in ((s1, r1), (s2, r2)))
            print(f"conv3d_halo {name}: max_abs_err {err} (tolerance {tol}"
                  f" = 2^-7 max|ref|); stats rel err {serr} (tolerance 1e-3)")
            check(err <= tol and serr <= 1e-3,
                  f"conv3d_halo {name} differs from its plain version")
            worst = max(worst, err)
            kw.update(xs=xs, w=w)
        report["conv3d_halo"] = {"max_abs_err": worst}
        return forms, (x3,), (x2, w2, b2)
    forms, k3_in, k2_in = run.phase("kernels", kernels)

    # ---------------------------------------------------------------- 3
    def slice_():
        conf = cfg.Config(model=cfg.ModelConfig(ps2d_eval=True,
                                                ps2d_levels=1))
        check(conf.model.features == (32, 64, 128, 256, 512),
              "not the full-width model")
        pred = Predictor(conf, seed=0)
        vols = [make_volume(np.random.default_rng(s)) for s in range(3)]
        torch.cuda.synchronize()
        T.reset_launch_counts()
        secs, labels = [], []
        for vol in vols:
            t = time.perf_counter()
            lab = pred.segment_tumor(vol, mode="cropped")
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            labels.append(lab)
        counts = T.launch_counts()
        print(f"launches over {len(vols)} requests: {counts}")
        check(all(v > 0 for v in counts.values()),
              f"a kernel never launched on the main path: {counts}")
        for s, vol, lab in zip(range(3), vols, labels):
            offs, bucket = cropping.plan_crop(
                vol, multiple=16, min_size=128,
                ladder=conf.inference.crop_bucket_ladder)
            hist = np.bincount(lab.reshape(-1).astype(np.int64),
                               minlength=4).tolist()
            print(f"volume seed {s}: bucket {bucket} offsets {offs} "
                  f"labels {hist} in {secs[s]:.3f} s")
            check(lab.shape == VOLUME_SHAPE and lab.dtype == np.int8
                  and lab.min() >= 0 and lab.max() < 4, "bad label map")
            inside = np.zeros(VOLUME_SHAPE, bool)
            inside[tuple(slice(o, o + b) for o, b in zip(offs, bucket))] = 1
            check(not lab[~inside].any(), "labels outside the crop")
        report["requests_s"] = secs
        report["launches"] = counts

        # one batch of windows of the first crop: kernel path against the
        # port's normal path (no kernels) with the same weights
        offs, bucket = cropping.plan_crop(
            vols[0], multiple=16, min_size=128,
            ladder=conf.inference.crop_bucket_ladder)
        crop = torch.from_numpy(
            cropping.extract_crop(vols[0], offs, bucket)).to(dev)
        starts = [sw.compute_patch_starts(d, 128, 0.5) for d in bucket]
        wins = [(a, b, c) for a in starts[0] for b in starts[1]
                for c in starts[2]][:4]
        x = torch.stack([crop[a:a + S, b:b + S, c:c + S]
                         for a, b, c in wins])
        out = pred.seg_model(x).float()
        normal = UNet3D(ps2d_eval=False, seed=0)
        normal.eval()
        ref = normal(x).float()
        d = (out - ref).abs()
        scale = max(ref.abs().max().item(), 1.0)
        top2 = ref.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        dis = out.argmax(-1) != ref.argmax(-1)
        wide = (dis & (margin > 2 * d.max())).sum().item()
        print(f"kernel path vs normal path, {tuple(x.shape)}: max |d logit| "
              f"{d.max().item():.5f} (bound {2 ** -5 * scale:.5f}), mean "
              f"{d.mean().item():.6f} (bound {2 ** -9 * scale:.6f}), labels "
              f"agree {1 - dis.float().mean().item():.5f}, flips at margin "
              f"> 2x max drift: {wide}; finite: "
              f"{bool(torch.isfinite(out).all())}")
        check(bool(torch.isfinite(out).all()), "non-finite logits")
        check(d.max().item() <= 2 ** -5 * scale
              and d.mean().item() <= 2 ** -9 * scale and wide == 0,
              "kernel path drifts from the normal path")
        return pred, vols[0]
    pred, vol0 = run.phase("slice", slice_)
    if args.profile:
        def profile_phase():
            profile_request(pred, vol0, cropping)
            # the same request on the normal path (no kernels), for scale
            plain = Predictor(cfg.Config(), seed=0)
            for i in range(3):
                t = time.perf_counter()
                plain.segment_tumor(vol0, mode="cropped")
                torch.cuda.synchronize()
                print(f"  normal-path request {i}: "
                      f"{time.perf_counter() - t:.4f} s")
        run.phase("profile", profile_phase)
    del pred

    # ---------------------------------------------------------------- 4
    def timings():
        import torch.nn.functional as F
        rows = []
        (x3,) = k3_in
        y3 = T.pack_halo_plain(x3)
        rows.append(("pack_halo", "pack_halo.cu", "ps2d.py:167",
                     lambda: T.pack_halo(x3), lambda: T.pack_halo_plain(x3),
                     lambda: F.pad(x3, (0, 0, 1, 1, 1, 1, 1, 1)),
                     bound_ms(nbytes(x3, y3), 0.0), 20,
                     "(4,128^3,32) -> (4,130^3,32)"))
        x2, w2, b2 = k2_in
        y2 = T.up_k2s2_into_halo_plain(x2, w2, b2)
        x2n = x2.permute(0, 4, 1, 2, 3)            # channels-last NCDHW
        w2n = w2.flip(0, 1, 2).permute(3, 4, 0, 1, 2).contiguous()
        rows.append(("up_k2s2_into_halo", "up_k2s2_into_halo.cu",
                     "ps2d.py:228",
                     lambda: T.up_k2s2_into_halo(x2, w2, b2),
                     lambda: T.up_k2s2_into_halo_plain(x2, w2, b2),
                     lambda: F.conv_transpose3d(x2n, w2n, b2.to(bf16),
                                                stride=2),
                     bound_ms(nbytes(x2, w2, b2, y2),
                              2.0 * x2.numel() * 8 * C), 20,
                     "(4,64^3,64) -> (4,130^3,32)"))
        kw = next(f for n, f in forms.items() if n.startswith("dec0.conv1"))
        xs, w = kw["xs"], kw["w"]
        yk = T.conv3d_halo(xs, w, in_mul0=kw["in_mul0"], emit_stats=True)[0]
        xcat = torch.cat([T.halo_to_normal(t) for t in xs], -1).permute(
            0, 4, 1, 2, 3)
        wn = w.permute(4, 3, 0, 1, 2).contiguous()
        flops = 2.0 * 27 * w.shape[3] * w.shape[4] * B * S ** 3
        rows.append(("conv3d_halo", "ps2d_conv3d.cu", "ps2d.py:667",
                     lambda: T.conv3d_halo(xs, w, in_mul0=kw["in_mul0"],
                                           emit_stats=True),
                     lambda: T.conv3d_halo_plain(xs, w,
                                                 in_mul0=kw["in_mul0"],
                                                 emit_stats=True),
                     lambda: F.conv3d(xcat, wn, padding=1),
                     bound_ms(nbytes(*xs, w, kw["in_mul0"], yk), flops), 10,
                     "dec0.conv1: 2 x (4,130^3,32) + mask -> (4,130^3,32)"))
        out = []
        for (name, src, line, kern, plain, lib, (bms, by), reps,
             shape) in rows:
            ms = event_ms(kern, reps)
            pms = event_ms(plain, max(reps // 2, 3))
            lms = event_ms(lib, reps)
            ms2 = event_ms(kern, reps)     # kernel again: spread in one call
            print(f"{name} {shape}: kernel {ms:.4f} / {ms2:.4f} ms, plain "
                  f"{pms:.4f} ms, library {lms:.4f} ms, bound {bms:.4f} ms "
                  f"({by})")
            out.append({
                "name": name, "route": "cuda",
                "source": f"{PKG}/csrc/{src}",
                "replaces": f"{REF}/ops/pallas/{line}",
                "launches": report["launches"][name],
                "max_abs_err": report[name]["max_abs_err"],
                "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "library_ms": lms, "shape": shape})
        # the other K1 call form of the main path (enc0.conv2, dec0.conv2)
        kw1 = next(f for n, f in forms.items() if n.startswith("enc0"))
        ms = event_ms(lambda: T.conv3d_halo(
            kw1["xs"], kw1["w"], in_scale=kw1["in_scale"],
            in_shift=kw1["in_shift"], in_relu=True, emit_stats=True), 10)
        bms, by = bound_ms(nbytes(kw1["xs"][0], kw1["w"], yk), flops / 2)
        print(f"conv3d_halo enc0.conv2/dec0.conv2 (1 input 32, affine+relu,"
              f" stats): kernel {ms:.4f} ms, bound {bms:.4f} ms ({by})")
        return out
    kernels_json = run.phase("timings", timings)

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
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
