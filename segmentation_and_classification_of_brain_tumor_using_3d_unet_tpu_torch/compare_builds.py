"""Time a kernel as built from other source trees beside the package's
own build, in one process on one card.

Each ``--against LABEL=DIR`` names a ``csrc`` directory (for example the
parent commit's, unpacked with ``git archive``). Every tree is built by
``ops/native.py`` as the package's own is, and the wrapper is pointed at
each build in turn. The builds are timed in rounds that run them forward
and then backward (A B B A for two), each time the mean of ``--reps``
launches between CUDA events; the script prints the median per build.

  * ``--kernel k1`` (the default): K1 (``ops/ps2d.py::conv3d_halo``) at
    ``chip_smoke.py``'s six call forms (the UNet's level-0 and level-1
    forms at the server's batch of 4 windows of 128^3, and co = 128 at
    level 1) and at K6's data gradient of enc0.conv2 (batch 2, garbage on
    the cotangent's halo); ``F.conv3d`` on the same inputs is timed in
    the same rounds. Every build's output must lie within 2^-7 * max|ref|
    of the plain version and its statistics within 1e-3 relative (a new
    summation order changes the last bits). A build from before per-block
    statistics (no ``ps2d_conv3d_plan``, PR 9's and earlier) is called
    with its own statistics buffer. Prints each form's launch geometry in
    this build and each build's share of the form's bound.
  * ``--kernel k1f32``: K1's f32 form at the same seven forms with f32
    inputs (values bf16 does not hold), beside ``F.conv3d`` in f32 with
    TF32 off (``ops.conv.full_f32``, around the whole comparison). Every
    build's output must lie within 1e-5 * max|ref| of the plain version
    (f32, TF32 off) and its statistics within 1e-5 relative; whether they
    equal this build's bit for bit is printed. Each build's share of the
    split design's bound (the bytes, or three bf16 passes' operations on
    the tensor cores) is printed.
  * ``--kernel k7``: K7 (``ops/conv3d.py::conv3d_same``) at
    ``benchmarks/bench_wtile.py``'s nine shapes (batch 1) and at the data
    gradient of its VJP at the first shape; ``F.conv3d`` on the same
    inputs is timed in the same rounds. Every build's output must lie
    within 2^-7 * max|ref| of the plain version; whether it equals this
    build's bit for bit is printed. Prints each shape's launch geometry
    in this build and each build's share of the shape's bound.
  * ``--kernel k7f32``: K7's f32 form at the same ten forms with f32
    inputs, beside ``F.conv3d`` in f32 with TF32 off (``full_f32``,
    around the whole comparison). Every build's output must lie within
    1e-5 * max|ref| of the plain version (f32, TF32 off). Each build's
    share of the split design's bound (the bytes, or six bf16 passes'
    operations on the tensor cores) is printed.
  * ``--kernel k2``: K2 (``ops/ps2d.py::up_k2s2_into_halo``) at its two
    request forms (``chip_smoke.py``'s: the server's batch of 4 windows of
    128^3, level 0 (4, 64^3, 64) -> (4, 130^3, 32) and level 1
    (4, 32^3, 128) -> (4, 66^3, 64), with bias); ``F.conv_transpose3d``
    on the same inputs is timed in the same rounds. Every build's output
    must lie within 1 bf16 ulp of max|ref| of the plain version, its halo
    exactly zero; whether it equals this build's bit for bit is printed.
    Prints each form's launch geometry in this build and each build's
    share of the form's bound.
  * ``--kernel k2f32``: K2's f32 form at the same two forms with f32
    inputs (values bf16 does not hold), beside ``F.conv_transpose3d`` in
    f32 with TF32 off (``ops.conv.full_f32``, around the whole
    comparison). Every build's output must lie within 1e-5 * max|ref| of
    the plain version (f32, TF32 off), its halo exactly zero; whether it
    equals this build's bit for bit is printed. Each build's share of the
    split design's bound (the bytes, or six bf16 passes' operations on the
    tensor cores) and this build's launch geometry are printed, and each
    build's max |error| against the float64 transposed conv of the same
    inputs over the plain f32 GEMM's. A tree from before the split design
    (the SIMT kernel) takes the same arguments.

  * ``--kernel k5``: K5 (``ops/groupnorm.py::fused_group_norm``) at
    ``chip_smoke.py``'s four forms ((4, 128^3, 32) GN8 with ReLU in bf16,
    the same ``+ x``, (1, 240, 240, 160, 32) with ReLU and a residual in
    bf16, (4, 128^3, 32) in f32) and an f32 form with ReLU and a residual;
    the library's ``F.group_norm`` (then ``relu_`` and ``add_`` where the
    form has them) on the same inputs is timed in the same rounds. Each
    build and the library are timed back to back and with an L2 flush (a
    256 MiB write, outside the events) before every launch; the flushed
    medians are the readings. Every build's output must lie within 1 bf16
    ulp (bf16) or 1e-5 (f32) of max|ref| of the plain version; whether
    two runs are bit-identical is printed. Each build's share of the
    single-read bound and of the two-pass floor (x's bytes once more) is
    printed, with this build's launch plan. A build from before the
    one-launch kernel (``group_norm_stats`` and ``group_norm_apply`` in
    place of ``group_norm``) runs those two C entry points with
    ``group_affine`` between them, and its pieces
    (the statistics' two kernels, the fold, the apply) are timed apart;
    ``torch.profiler`` splits every build's call into its kernels.

  * ``--kernel q8``: Q8 (``ops/conv_int8.py::conv3d_int8``) at the 17
    distinct (ci, co, side) shapes of the full-width UNet's 22 DoubleConv
    convs at the server's batch of 4 windows of 128^3 (x bf16, a
    calibrated-like scale, no bias), each build's output held bit-equal
    to the plain version; this build timed with its weights prepared once
    ("cached", the serving path) and with them quantized in the call
    ("per call"), and its weights' preparation alone; bf16 ``F.conv3d``
    and bf16 K7 (where ci and co are multiples of 32) on the same inputs
    as yardsticks; ``torch.profiler`` splits this build's cached call into
    its kernels (x's quantizing pass, the conv, the split's memset and
    epilogue). Rounds A B B A; each form's two bounds (the per-call
    one counts the f32 weights, the cached one the int8 weights, scales
    and bias that the call reads); this build's plan; the 22 convs' sum
    per forward of each build, weighted by each shape's count. A build
    from before the prepared weights (no ``conv3d_int8_weights``) runs
    with its own signature (the weights quantized in every call).

    python -m segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.compare_builds \\
        --kernel k1 --against parent=/path/to/parent/csrc

The last line is a JSON object of the medians, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path


def event_ms(fn, reps: int) -> float:
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_forms(seed: int = 0, dtype=None):
    """K1's timed forms: ``chip_smoke.py``'s six (the UNet's level-0 and
    level-1 call forms in the server's batch of 4 windows of 128^3, and
    co = 128 at level 1), then K6's data gradient at enc0.conv2 (batch 2,
    as the train step runs it, garbage on the cotangent's halo), with
    tensors in ``dtype`` (bf16 by default): name -> (kwargs of
    ``conv3d_halo``, or for the data gradient (dy, w, cis)).
    """
    import torch
    from .ops import ps2d as T

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, device="cuda", generator=g)
                * scale).to(dtype)

    def halo(b, s, c):
        return T.pack_halo_plain(rnd((b, s, s, s, c)))

    def mask(s, c):
        return T.pack_halo_plain(torch.rand(
            (B, s, s, s, c), device="cuda", generator=g).to(dtype))

    def conv(ci, co):
        return rnd((3, 3, 3, ci, co), (2 / (27 * co)) ** 0.5)

    def affine(c):
        return dict(in_scale=1 + rnd((B, c), 0.3), in_shift=rnd((B, c), 0.3),
                    in_relu=True)

    B, S, C = 4, 128, 32
    S1, C1 = S // 2, 2 * C
    h0 = [halo(B, S, C) for _ in range(2)]
    h1 = [halo(B, S1, c) for c in (C, C1, C1)]
    dy = halo(2, S, C)
    dy = dy + 100 * rnd(dy.shape) * (1 - T.halo_mask(dy))
    return {
        "enc0.conv2/dec0.conv2 (4,130^3,32)->32, affine+relu": dict(
            xs=(h0[0],), w=conv(C, C), **affine(C)),
        "dec0.conv1 2x(4,130^3,32)->32, mask": dict(
            xs=(h0[0], h0[1]), w=conv(2 * C, C), in_mul0=mask(S, C)),
        "enc1.conv1 (4,66^3,32)->64": dict(xs=(h1[0],), w=conv(C, C1)),
        "enc1.conv2/dec1.conv2 (4,66^3,64)->64, affine+relu": dict(
            xs=(h1[1],), w=conv(C1, C1), **affine(C1)),
        "dec1.conv1 2x(4,66^3,64)->64, mask": dict(
            xs=(h1[1], h1[2]), w=conv(2 * C1, C1), in_mul0=mask(S1, C1)),
        "co=128 (4,66^3,128)->128, affine+relu": dict(
            xs=(halo(B, S1, 2 * C1),), w=conv(2 * C1, 2 * C1),
            **affine(2 * C1)),
        "K6 data grad of enc0.conv2 (2,130^3,32)->32": (dy, conv(C, C),
                                                         (C,)),
    }


K7_SHAPES = [(32, 32, 240, 240, 160), (64, 32, 240, 240, 160),
             (32, 64, 120, 120, 80), (64, 64, 120, 120, 80),
             (128, 64, 120, 120, 80), (64, 128, 60, 60, 40),
             (128, 128, 60, 60, 40), (256, 256, 30, 30, 20),
             (512, 512, 15, 15, 10)]
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3


def k7_forms(seed: int = 0, dtype=None):
    """K7's timed forms: name -> (kernel call, plain call, F.conv3d call,
    bound ms, reps, launch geometry or None). The nine benchmark shapes
    (weights * 0.05 as there), then the VJP's data gradient at the
    first, with tensors in ``dtype`` (bf16 by default). In f32 the
    bound's operations are six bf16 passes (the split design's)."""
    import torch
    import torch.nn.functional as F
    from .ops import conv3d as K7

    dtype = dtype or torch.bfloat16
    passes = 1 if dtype == torch.bfloat16 else 6
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, device="cuda", generator=g)
                * scale).to(dtype)

    def form(x, w, kern, plain, reps, geo):
        ci, co = w.shape[3], w.shape[4]
        vox = x.numel() // ci
        xn = x.permute(0, 4, 1, 2, 3)             # channels-last NCDHW
        wn = w.permute(4, 3, 0, 1, 2).contiguous()
        flops = passes * 2.0 * 27 * ci * co * vox
        nb = (x.numel() + w.numel() + vox * co) * x.element_size()
        bound = max(flops / PEAK_BF16_FLOPS, nb / PEAK_HBM_BYTES) * 1e3
        return (kern, plain, lambda: F.conv3d(xn, wn, padding=1), bound,
                reps, geo)

    out = {}
    for ci, co, D, H, W in K7_SHAPES:
        x, w = rnd((1, D, H, W, ci)), rnd((3, 3, 3, ci, co), 0.05)
        reps = 5 if x.numel() > 2e8 else 20
        out[f"{ci}->{co} @({D},{H},{W})"] = form(
            x, w, lambda x=x, w=w: K7.conv3d_same(x, w),
            lambda x=x, w=w: K7.wtile_conv3d_plain(x, w), reps,
            lambda ci=ci, co=co, D=D, H=H, W=W: K7.conv3d_same_plan(
                1, D, H, W, ci, co, dtype))
    ci, co, D, H, W = K7_SHAPES[0]
    dy, w = rnd((1, D, H, W, co)), rnd((3, 3, 3, ci, co), 0.05)
    wt = w.flip(0, 1, 2).transpose(3, 4)
    out[f"data grad {co}->{ci} @({D},{H},{W})"] = form(
        dy, wt, lambda: K7.conv3d_same_dgrad(dy, w),
        lambda: K7.wtile_conv3d_plain(dy, wt), 5, None)
    return out


def k2_forms(seed: int = 0, dtype=None):
    """K2's timed forms, ``chip_smoke.py``'s, with tensors in ``dtype``
    (bf16 by default; the bias f32): name -> (kernel call, plain call,
    F.conv_transpose3d call, bound ms, reps, launch geometry[, float64
    reference]). In f32 the bound's operations are six bf16 passes (the
    split design's), and the float64 transposed conv of the same inputs
    comes last."""
    import torch
    import torch.nn.functional as F
    from .ops import ps2d as T

    dtype = dtype or torch.bfloat16
    passes = 1 if dtype == torch.bfloat16 else 6
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, device="cuda", generator=g)
                * scale).to(dt)

    def f64(x, w, b):
        return T._phases_into_halo(
            torch.matmul(x.double(), T._phase_matrix(w.double(),
                                                     torch.float64))
            + b.double().repeat(8), x.shape)

    out = {}
    for lvl, (d2, ci, co) in {"level 0": (64, 64, 32),
                              "level 1": (32, 128, 64)}.items():
        x, w = rnd((4, d2, d2, d2, ci)), rnd((2, 2, 2, ci, co), 0.1)
        b = rnd((co,), 0.1, torch.float32)
        xn = x.permute(0, 4, 1, 2, 3)             # channels-last NCDHW
        wn = w.flip(0, 1, 2).permute(3, 4, 0, 1, 2).contiguous()
        nb = (x.numel() + w.numel() + 4 * (2 * d2 + 2) ** 3 * co) \
            * x.element_size() + b.numel() * 4
        flops = passes * 2.0 * x.numel() * 8 * co
        out[f"{lvl} (4,{d2}^3,{ci})->(4,{2 * d2 + 2}^3,{co})"] = (
            lambda x=x, w=w, b=b: T.up_k2s2_into_halo(x, w, b),
            lambda x=x, w=w, b=b: T.up_k2s2_into_halo_plain(x, w, b),
            lambda xn=xn, wn=wn, b=b: F.conv_transpose3d(
                xn, wn, b.to(dtype), stride=2),
            max(flops / PEAK_BF16_FLOPS, nb / PEAK_HBM_BYTES) * 1e3,
            20 if passes == 1 else 10,
            lambda d2=d2, ci=ci, co=co: T.up_k2s2_plan(4, d2, d2, d2, ci,
                                                       co, dtype),
            *(() if passes == 1 else (lambda x=x, w=w, b=b: f64(x, w, b),)))
    return out


def _ulp(m: float) -> float:
    """One bf16 ulp at magnitude m."""
    import math
    return 2.0 ** (math.floor(math.log2(m)) - 7)


def compare_forms(forms: dict, libs, use, rounds: int, library: str,
                  tol_of, halo: bool = False) -> dict:
    """A kernel at its forms in every build: checked against the plain
    version (within ``tol_of(max|ref|)``; with ``halo``, the halo
    exactly zero too), then timed in alternated rounds beside the
    library call. A form with a float64 reference also prints each
    build's max |error| against it over the plain version's."""
    import numpy as np
    import torch
    from .ops import ps2d as T

    result = {}
    order = list(libs) + list(libs)[::-1]
    ratios = {}
    for name, (kern, plain, lib_fn, bound, reps, geo, *f64) in forms.items():
        ref = plain().float()
        tol = tol_of(ref.abs().max().item())
        outs = {}
        for label in libs:
            use(label)
            outs[label] = kern()
            err = (outs[label].float() - ref).abs().max().item()
            zero = not halo or (outs[label].float() * (
                1 - T.halo_mask(outs[label]).float())).abs().max() == 0
            if not (err <= tol and zero):
                raise SystemExit(f"compare_builds: {label} differs from the "
                                 f"plain version at {name}: {err} (> {tol}?)"
                                 f", halo zero {zero}")
            print(f"{name}: {label} max_abs_err {err} (tolerance {tol})"
                  + (", halo zero" if halo else ""))
        print(f"{name}: bit-identical to this build: " + ", ".join(
            f"{k} {torch.equal(v, outs['this'])}" for k, v in outs.items()
            if k != "this"))
        if f64:
            r64 = f64[0]()
            ep = (ref.double() - r64).abs().max().item()
            ratios[name] = {k: (v.double() - r64).abs().max().item() / ep
                            for k, v in outs.items()}
            print(f"{name}: max |error| against float64 over the plain "
                  f"version's ({ep:.4e}): " + ", ".join(
                      f"{k} {v:.4f}" for k, v in ratios[name].items()))
            del r64
        del ref, outs
        use("this")
        if geo is not None:
            print(f"{name}: this build's launch {geo()}")
        times = {label: [] for label in [*libs, library]}
        for _ in range(rounds):
            for label in order:
                use(label)
                times[label].append(event_ms(kern, reps))
            times[library].append(event_ms(lib_fn, reps))
        med = {k: float(np.median(v)) for k, v in times.items()}
        result[name] = {"median_ms": med, "bound_ms": bound,
                        "bound_share": {k: bound / v for k, v in med.items()}}
        print(f"{name}: bound {bound:.4f} ms; " + ", ".join(
            f"{k} {v:.4f} ms ({bound / v:.1%} of bound; "
            f"{' '.join(f'{t:.4f}' for t in times[k])})"
            for k, v in med.items()))
    return {"forms": {k: v["median_ms"] for k, v in result.items()},
            "bound_ms": {k: v["bound_ms"] for k, v in result.items()},
            "bound_share": {k: v["bound_share"] for k, v in result.items()},
            **({"f64_error_ratio": ratios} if ratios else {})}


def compare_k7(libs, use, rounds: int, f32: bool = False) -> dict:
    """K7 at its forms in every build, within 2^-7 max|ref| of the plain
    version, timed beside F.conv3d; the nine forwards' total. ``f32``:
    its f32 form, held to 1e-5 max|ref|, the bound that of six bf16
    passes."""
    if f32:
        import torch
        forms, tol = k7_forms(dtype=torch.float32), 1e-5
    else:
        forms, tol = k7_forms(), 2 ** -7
    out = compare_forms(forms, libs, use, rounds, "F.conv3d",
                        lambda m: tol * m)
    fwd = [v for k, v in out["forms"].items() if k[0].isdigit()]
    total = {k: sum(m[k] for m in fwd) for k in fwd[0]}
    print("TOTAL sampled (nine forwards): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in total.items()))
    return {**out, "total_sampled_ms": total}


def _legacy_k1(lib, xs, w, in_scale=None, in_shift=None, in_relu=False,
               in_mul0=None):
    """K1 with statistics through a build from before per-block sums (no
    ``ps2d_conv3d_plan``; PR 9's and earlier): its statistics buffer is
    (B, 2, co), zeroed by the caller, summed with atomics."""
    import torch
    from .ops import ps2d as T

    B, Dp, Hp, Wp, _ = xs[0].shape
    cis, co = [x.shape[-1] for x in xs], w.shape[-1]
    sc = sh = None
    if in_scale is not None or in_shift is not None:
        sc, sh = T._affine_pair(in_scale, in_shift, B, sum(cis), xs[0].device,
                                torch.bfloat16)
    y = torch.empty((B, Dp, Hp, Wp, co), dtype=torch.bfloat16,
                    device=xs[0].device)
    stats = torch.zeros((B, 2, co), dtype=torch.float32, device=xs[0].device)
    lib.check("conv3d_halo", lib.ps2d_conv3d(
        xs[0].data_ptr(), T._ptr(xs[1]) if len(xs) > 1 else None, cis[0],
        cis[1] if len(xs) > 1 else 0, w.data_ptr(), T._ptr(sc), T._ptr(sh),
        int(in_relu), T._ptr(in_mul0), y.data_ptr(), stats.data_ptr(),
        B, Dp - 2, Hp - 2, Wp - 2, co, T._stream(), 0))
    return y, (stats[:, 0], stats[:, 1])


def compare_k1(libs, use, rounds: int, reps: int, f32: bool = False) -> dict:
    """K1 at its forms in every build: checked against the plain version
    (whether each build's output and statistics equal this build's bit for
    bit is printed), then timed in alternated rounds beside F.conv3d.
    ``f32``: its f32 form, held to 1e-5 (output and statistics), the
    bound that of three bf16 passes."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from .ops import ps2d as T

    dtype = torch.float32 if f32 else torch.bfloat16
    tol_y, tol_s, passes = (1e-5, 1e-5, 3) if f32 else (2 ** -7, 1e-3, 1)
    order = list(libs) + list(libs)[::-1]
    result = {}
    for name, form in k1_forms(dtype=dtype).items():
        if isinstance(form, dict):      # a forward, with statistics
            xs, w = form["xs"], form["w"]
            cis = [x.shape[-1] for x in xs]
            xn = torch.cat([T.halo_to_normal(x) for x in xs], -1)
            ref, sums = T.conv3d_halo_plain(emit_stats=True, **form)

            def kern(label, form=form):
                if hasattr(libs[label]._dll, "ps2d_conv3d_plan"):
                    return T.conv3d_halo(emit_stats=True, **form)
                return _legacy_k1(libs[label], **form)
        else:                           # K6's data gradient, no statistics
            dy, w0, cis = form
            xs, sums = (dy,), None
            w = w0.flip(0, 1, 2).transpose(3, 4)
            xn = T.halo_to_normal(dy)
            ref = T.conv3d_halo_plain((dy * T.halo_mask(dy),), w)

            def kern(label, dy=dy, w=w, w0=w0, cis=cis):
                return T.conv3d_halo_dgrad(dy, w0, 0, cis)
        ci, co = sum(cis), w.shape[-1]
        tol = tol_y * ref.float().abs().max().item()
        outs = {}
        for label in libs:
            use(label)
            out = kern(label)
            outs[label] = out if sums is not None else (out,)
            y, got = (out[0], out[1]) if sums is not None else (out, None)
            err = (y.float() - ref.float()).abs().max().item()
            serr = 0.0 if got is None else max(
                ((s - r).abs().max() / r.abs().max()).item()
                for s, r in zip(got, sums))
            if not (err <= tol and serr <= tol_s):
                raise SystemExit(f"compare_builds: {label} differs from the "
                                 f"plain version at {name}: {err} (> {tol}?),"
                                 f" stats {serr} (> {tol_s}?)")
            print(f"{name}: {label} max_abs_err {err} (tolerance {tol}); "
                  f"stats rel err {serr} (tolerance {tol_s})")

        def flat(out):
            return [out[0], *(out[1] if len(out) > 1 else ())]
        print(f"{name}: bit-identical to this build (output and statistics):"
              " " + ", ".join(
                  f"{k} " + str(all(torch.equal(a, b) for a, b in zip(
                      flat(v), flat(outs["this"]))))
                  for k, v in outs.items() if k != "this"))
        del ref, out, y, outs
        B, Dp, Hp, Wp = xs[0].shape[:4]
        use("this")
        print(f"{name}: this build's launch " + str(T.conv3d_halo_plan(
            B, Dp - 2, Hp - 2, Wp - 2, cis[0], sum(cis[1:]), co, dtype)))
        n = B * T.interior_count(xs[0])
        nbytes = sum(t.numel() * t.element_size() for t in
                     (*xs, w, form.get("in_mul0"), form.get("in_scale"),
                      form.get("in_shift")) if t is not None) \
            if isinstance(form, dict) else (dy.numel() + w.numel()) \
            * dy.element_size()
        nbytes += B * Dp * Hp * Wp * co * xs[0].element_size()   # y
        bound = max(passes * 2.0 * 27 * ci * co * n / PEAK_BF16_FLOPS,
                    nbytes / PEAK_HBM_BYTES) * 1e3
        xl = xn.permute(0, 4, 1, 2, 3)                 # channels-last NCDHW
        wl = w.to(dtype).permute(4, 3, 0, 1, 2).contiguous()
        times = {label: [] for label in [*libs, "F.conv3d"]}
        for _ in range(rounds):
            for label in order:
                use(label)
                times[label].append(event_ms(lambda: kern(label), reps))
            times["F.conv3d"].append(event_ms(
                lambda: F.conv3d(xl, wl, padding=1), reps))
        med = {k: float(np.median(v)) for k, v in times.items()}
        result[name] = {"median_ms": med, "bound_ms": bound,
                        "bound_share": {k: bound / v for k, v in med.items()}}
        print(f"{name}: bound {bound:.4f} ms; " + ", ".join(
            f"{k} {v:.4f} ms ({bound / v:.1%} of bound; "
            f"{' '.join(f'{t:.4f}' for t in times[k])})"
            for k, v in med.items()))
    return {"forms": {k: v["median_ms"] for k, v in result.items()},
            "bound_ms": {k: v["bound_ms"] for k, v in result.items()},
            "bound_share": {k: v["bound_share"] for k, v in result.items()}}


def k5_forms(seed: int = 0) -> dict:
    """K5's timed forms: name -> kwargs of ``fused_group_norm``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, scale, dt):
        return (torch.randn(shape, device="cuda", generator=g)
                * scale).to(dt)

    def form(shape, dt, relu, residual=None):
        x = rnd(shape, 2.0, dt) + 0.5
        r = (x if residual == "x" else None if residual is None
             else rnd(shape, 1.0, dt))
        c = shape[-1]
        return dict(x=x, gamma=1 + rnd((c,), 0.3, torch.float32),
                    beta=rnd((c,), 0.3, torch.float32), num_groups=8,
                    relu=relu, residual=r)

    bf, f32 = torch.bfloat16, torch.float32
    small, big = (4, 128, 128, 128, 32), (1, 240, 240, 160, 32)
    return {
        "(4,128^3,32) GN8 ReLU bf16": form(small, bf, True),
        "(4,128^3,32) GN8 ReLU + x bf16": form(small, bf, True, "x"),
        "(1,240,240,160,32) GN8 ReLU + residual bf16": form(big, bf, True,
                                                            "other"),
        "(4,128^3,32) GN8 f32": form(small, f32, False),
        "(4,128^3,32) GN8 ReLU + residual f32": form(small, f32, True,
                                                     "other"),
    }


def _legacy_k5(lib, x, gamma, beta, num_groups, eps=1e-5, residual=None,
               relu=False):
    """K5 through a build from before the one-launch kernel: its
    statistics entry (two kernels: per-chunk sums, then their sum),
    ``group_affine`` (PyTorch), its apply entry. Returns the three pieces
    as calls (each may run again) and the whole."""
    import ctypes
    import math

    import torch
    from .ops import ps2d as T
    from .ops.norm import group_affine

    P, I = ctypes.c_void_p, ctypes.c_int
    stats, apply_ = lib._dll.group_norm_stats, lib._dll.group_norm_apply
    stats.argtypes = (P, I, P, P, I, I, I, I, I, P)
    apply_.argtypes = (P, I, P, P, P, I, I, P, I, I, I, P)
    stats.restype = apply_.restype = ctypes.c_int
    dt = {torch.float32: 0, torch.bfloat16: 1}
    n, c = x.shape[0], x.shape[-1]
    m = x.numel() // (n * c)
    chunks = max(1, min(math.ceil(m / 512), math.ceil(1056 / n)))
    chunk_rows = math.ceil(m / chunks)
    chunks = math.ceil(m / chunk_rows)
    part = torch.empty((n, chunks, 2, c), dtype=torch.float32,
                       device=x.device)
    sums = torch.empty((n, 2, c), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    aff = {}

    def do_stats():
        lib.check("group_norm_stats", stats(
            x.data_ptr(), dt[x.dtype], part.data_ptr(), sums.data_ptr(), n,
            m, c, chunk_rows, chunks, T._stream()))

    def do_fold():
        sc, sh = group_affine(sums[:, 0] / m, sums[:, 1] / m, gamma, beta,
                              num_groups, eps)
        aff["scale"], aff["shift"] = sc.contiguous(), sh.contiguous()

    def do_apply():
        lib.check("group_norm_apply", apply_(
            x.data_ptr(), dt[x.dtype], aff["scale"].data_ptr(),
            aff["shift"].data_ptr(), T._ptr(residual),
            0 if residual is None else dt[residual.dtype], int(relu),
            y.data_ptr(), n, m, c, T._stream()))

    def whole():
        do_stats()
        do_fold()
        do_apply()
        return y

    return {"stats": do_stats, "fold": do_fold, "apply": do_apply}, whole


def flushed_ms(fn, reps: int, scratch) -> float:
    """Mean ms of ``fn`` between CUDA events, each launch after a write
    of ``scratch`` (outside the events) that leaves none of its inputs in
    the 50 MB L2."""
    import torch
    fn()
    ev = []
    for _ in range(reps):
        scratch.zero_()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        fn()
        end.record()
        ev.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / reps


def kernels_of(fn, calls: int = 5, width: int = 60) -> dict:
    """Device ms per call of each kernel ``fn`` launches, from
    ``torch.profiler`` over ``calls`` calls, by the first ``width``
    characters of each kernel's name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        if t > 0 and e.count >= calls:
            out[e.key[:width]] = (t / 1e3 / calls, e.count // calls)
    return out


def compare_k5(libs, use, rounds: int) -> dict:
    """K5 at its five forms in every build, within K5's tolerances of the
    plain version, two runs compared; timed flushed and back to back in
    alternated rounds beside the library sequence. A build from before the
    one-launch kernel runs through ``_legacy_k5`` and has its pieces
    timed apart."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from .ops import groupnorm as GN

    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    order = list(libs) + list(libs)[::-1]
    result = {}
    for name, kw in k5_forms().items():
        x, r = kw["x"], kw["residual"]
        n, c = x.shape[0], x.shape[-1]
        m = x.numel() // (n * c)
        bf = x.dtype == torch.bfloat16
        calls, pieces = {}, {}
        for label, lib in libs.items():
            if hasattr(lib._dll, "group_norm"):
                calls[label] = lambda kw=kw: GN.fused_group_norm(**kw)
            else:
                pieces[label], calls[label] = _legacy_k5(lib, **kw)
        ref = GN.fused_group_norm_plain(**kw).float()
        mx = ref.abs().max().item()
        tol = _ulp(mx) if bf else 1e-5 * mx
        for label in libs:
            use(label)
            y = calls[label]().clone()
            again = calls[label]()
            err = (y.float() - ref).abs().max().item()
            same = torch.equal(y, again)
            if not (err <= tol and bool(torch.isfinite(y).all())):
                raise SystemExit(f"compare_builds: {label} differs from the "
                                 f"plain version at {name}: {err} (> {tol}?)")
            print(f"{name}: {label} max_abs_err {err} (tolerance {tol}: "
                  f"{'1 bf16 ulp' if bf else '1e-5'} of max|ref| {mx}); two "
                  f"runs bit-identical: {same}")
            del y, again
        del ref
        use("this")
        plan = GN.group_norm_device_plan(n, m, c, x.dtype,
                                         GN.residual_stream_dtype(x, r))
        print(f"{name}: this build's plan {plan}")
        xn = x.permute(0, 4, 1, 2, 3)              # channels-last NCDHW
        gm, bt = kw["gamma"].to(x.dtype), kw["beta"].to(x.dtype)

        def library(xn=xn, gm=gm, bt=bt, kw=kw, r=r):
            y = F.group_norm(xn, kw["num_groups"], gm, bt, 1e-5)
            if kw["relu"]:
                y.relu_()
            if r is not None:
                y.add_(r.permute(0, 4, 1, 2, 3))
            return y
        calls["library"] = library
        for label, fn in calls.items():
            use(label if label in libs else "this")
            print(f"{name}: {label} kernels (torch.profiler, ms a call, "
                  f"launches a call): {kernels_of(fn)}")
        for label, ps in pieces.items():
            use(label)
            calls[label]()
            print(f"{name}: {label} pieces flushed / back to back: " + ", ".join(
                f"{k} {flushed_ms(f, 10, scratch):.4f} / "
                f"{event_ms(f, 10):.4f} ms" for k, f in ps.items()))
        use("this")
        nb = sum(t.numel() * t.element_size()
                 for t in (x, None if r is x else r, x) if t is not None)
        bound = nb / PEAK_HBM_BYTES * 1e3
        floor = (nb + x.numel() * x.element_size()) / PEAK_HBM_BYTES * 1e3
        reps = 10 if x.numel() > 3e8 else 20
        keys = [*libs, "library"]
        times = {(k, how): [] for k in keys for how in ("flushed", "b2b")}
        for _ in range(rounds):
            for label in [*order, "library"]:
                use(label if label in libs else "this")
                times[(label, "flushed")].append(
                    flushed_ms(calls[label], reps, scratch))
                times[(label, "b2b")].append(event_ms(calls[label], reps))
        use("this")
        med = {f"{k} {how}": float(np.median(v))
               for (k, how), v in times.items()}
        result[name] = {"median_ms": med, "bound_ms": bound,
                        "two_pass_floor_ms": floor,
                        "bound_share": {k: bound / v for k, v in med.items()},
                        "floor_share": {k: floor / v for k, v in med.items()}}
        print(f"{name}: bound {bound:.4f} ms, two-pass floor {floor:.4f} ms; "
              + "; ".join(
                  f"{k} {v:.4f} ms ({bound / v:.1%} of bound, {floor / v:.1%}"
                  f" of floor; {' '.join(f'{t:.4f}' for t in times[tuple(k.rsplit(' ', 1))])})"
                  for k, v in med.items()))
        del calls, pieces, kw
    return {"forms": {k: v["median_ms"] for k, v in result.items()},
            "bound_ms": {k: v["bound_ms"] for k, v in result.items()},
            "two_pass_floor_ms": {k: v["two_pass_floor_ms"]
                                  for k, v in result.items()},
            "bound_share": {k: v["bound_share"] for k, v in result.items()},
            "floor_share": {k: v["floor_share"] for k, v in result.items()}}


PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8 (NVIDIA data sheet)


def q8_shapes(feats=(32, 64, 128, 256, 512), side: int = 128) -> dict:
    """The 17 distinct (ci, co, side) of the UNet's 22 DoubleConv convs at
    a ``side``^3 window: name lists keyed by shape (``down{i}`` at side
    >> i from 4 input channels, the bottleneck at side >> n, ``dec{i}``
    at side >> (n - 1 - i) on the skip concatenation)."""
    n, out = len(feats), {}

    def add(name, ci, co, s):
        out.setdefault((ci, co, s), []).append(name)
    for i, f in enumerate(feats):
        add(f"down{i}.conv1", feats[i - 1] if i else 4, f, side >> i)
        add(f"down{i}.conv2", f, f, side >> i)
    add("bottleneck.conv1", feats[-1], 2 * feats[-1], side >> n)
    add("bottleneck.conv2", 2 * feats[-1], 2 * feats[-1], side >> n)
    for i in range(n):
        f = feats[n - 1 - i]
        add(f"dec{i}.conv1", 2 * f, f, side >> (n - 1 - i))
        add(f"dec{i}.conv2", f, f, side >> (n - 1 - i))
    return out


def _legacy_q8(lib, x, w, s):
    """A build from before the prepared weights (its C signature:
    x, x is bf16, w, act_scale, bias, wq, f32 scratch, y, B, D, H, W, ci,
    co, stream; the weights quantized in the call)."""
    import ctypes
    import torch
    from .ops.ps2d import _stream
    B, D, H, W, ci = x.shape
    co = w.shape[-1]
    fn = lib._dll["conv3d_int8"]
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = (P, I, P, P, P, P, P, P, I, I, I, I, I, I, P)
    fn.restype = ctypes.c_int
    wq = torch.empty((co, 27, -(-ci // 32) * 32), dtype=torch.int8,
                     device=x.device)
    f32s = torch.empty((33, co), dtype=torch.float32, device=x.device)
    y = torch.empty((B, D, H, W, co), dtype=torch.bfloat16, device=x.device)
    lib.check("conv3d_int8", fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                                w.data_ptr(), s.data_ptr(), None,
                                wq.data_ptr(), f32s.data_ptr(), y.data_ptr(),
                                B, D, H, W, ci, co, _stream()))
    return y


def compare_q8(libs, use, rounds: int) -> dict:
    """Q8 at the 17 DoubleConv shapes in every build (the docstring's
    ``--kernel q8``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from .ops import conv3d as K7
    from .ops import conv_int8 as Q8

    g = torch.Generator(device="cuda").manual_seed(0)
    order = list(libs) + list(libs)[::-1]
    shapes = q8_shapes()
    result, sums = {}, {}
    for (ci, co, side), names in sorted(shapes.items(),
                                        key=lambda kv: -kv[0][2]):
        name = f"{ci}->{co} @(4,{side}^3)"
        x = torch.randn((4, side, side, side, ci), device="cuda",
                        generator=g).to(torch.bfloat16)
        w = torch.randn((3, 3, 3, ci, co), device="cuda", generator=g) * (
            2 / (27 * co)) ** 0.5
        s = (x.float().abs().amax() * 0.8 / 127).reshape(1)
        ref = Q8.conv3d_int8_plain(x, w, s)
        calls = {}
        for label, lib in libs.items():
            use(label)
            if hasattr(lib, "conv3d_int8_weights"):
                prep = Q8.prepare_weights_int8(w)
                calls[f"{label} cached"] = (
                    label, lambda prep=prep: Q8.conv3d_int8(x, w, s, None,
                                                            prep))
                calls[f"{label} per call"] = (
                    label, lambda: Q8.conv3d_int8(x, w, s))
            else:
                calls[f"{label} per call"] = (
                    label, lambda lib=lib: _legacy_q8(lib, x, w, s))
        outs = {}
        for k, (label, fn) in calls.items():
            use(label)
            outs[k] = fn()
            if not torch.equal(outs[k], ref):
                raise SystemExit(f"compare_builds: {k} differs from the "
                                 f"plain version at {name}: max |d| "
                                 f"{(outs[k].float() - ref.float()).abs().max().item()}")
        use("this")
        again = calls["this cached"][1]()
        print(f"{name} ({', '.join(names)}): every build bit-equal to the "
              f"plain version; this build's two runs identical "
              f"{torch.equal(again, outs['this cached'])}")
        del ref, outs, again
        use("this")
        plan = Q8.conv3d_int8_plan_of(4, side, side, side, ci, co)
        print(f"{name}: this build's plan {plan}")
        split = kernels_of(calls["this cached"][1], width=100)
        print(f"{name}: this build's kernels, cached (torch.profiler, ms a "
              f"call, launches a call): {split}")
        xn = x.permute(0, 4, 1, 2, 3)                 # channels-last NCDHW
        wn = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous()
        lib_calls = {"F.conv3d bf16": lambda: F.conv3d(xn, wn, padding=1),
                     "prepare weights": lambda: Q8.prepare_weights_int8(w)}
        if ci % 32 == 0 and co % 32 == 0:
            lib_calls["K7 bf16"] = lambda: K7.conv3d_same(x, w)
        reps = 5 if side == 128 else 20
        times = {k: [] for k in [*calls, *lib_calls]}
        for _ in range(rounds):
            for label in order:
                for k, (lb, fn) in calls.items():
                    if lb == label:
                        use(label)
                        times[k].append(event_ms(fn, reps))
            use("this")
            for k, fn in lib_calls.items():
                times[k].append(event_ms(fn, reps))
        med = {k: float(np.median(v)) for k, v in times.items()}
        vox = x.numel() // ci
        io = (x.numel() + vox * co) * 2
        ops = 2.0 * 27 * ci * co * vox
        b_call = max(ops / PEAK_INT8_OPS,
                     (io + w.numel() * 4) / PEAK_HBM_BYTES) * 1e3
        b_cached = max(ops / PEAK_INT8_OPS,
                       (io + w.numel() + co * 4) / PEAK_HBM_BYTES) * 1e3
        bound = {k: (b_cached if k.endswith("cached") else b_call)
                 for k in calls}
        result[name] = {"convs": names, "median_ms": med,
                        "bound_ms": {"per call": b_call, "cached": b_cached},
                        "bound_share": {k: bound[k] / med[k] for k in calls},
                        "plan": plan, "kernels": split}
        for k in med:
            sums[k] = sums.get(k, 0.0) + len(names) * med[k]
        print(f"{name}: bounds per call {b_call:.4f} ms, cached "
              f"{b_cached:.4f} ms; " + ", ".join(
                  f"{k} {v:.4f} ms"
                  + (f" ({bound[k] / v:.1%} of bound)" if k in bound else "")
                  + f" [{' '.join(f'{t:.4f}' for t in times[k])}]"
                  for k, v in med.items()), flush=True)
        del x, w, xn, wn, calls, lib_calls
        torch.cuda.empty_cache()
    print("22 convs a forward (each shape's median times its count): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in sums.items()))
    return {"forms": {k: v["median_ms"] for k, v in result.items()},
            "bound_ms": {k: v["bound_ms"] for k, v in result.items()},
            "bound_share": {k: v["bound_share"] for k, v in result.items()},
            "plans": {k: v["plan"] for k, v in result.items()},
            "kernels": {k: v["kernels"] for k, v in result.items()},
            "forward_22_ms": sums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    metavar="LABEL=DIR", help="a csrc directory to compare")
    ap.add_argument("--kernel", choices=("k1", "k1f32", "k2", "k2f32", "k5",
                                         "k7", "k7f32", "q8"), default="k1")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10,
                    help="launches per timing (k1, k1f32; k2 takes 20, "
                    "k2f32 10, k7 and k7f32 5-20)")
    args = ap.parse_args(argv)

    import torch
    from .ops import native

    if not torch.cuda.is_available():
        raise SystemExit("compare_builds: needs a CUDA device")
    trees = {"this": native.CSRC_DIR}
    for spec in args.against:
        label, _, path = spec.partition("=")
        if not path or label in trees or label.startswith("F."):
            raise SystemExit(f"compare_builds: bad --against {spec!r}")
        trees[label] = Path(path)
    libs = {}
    for label, src in trees.items():
        built = native.build(src)
        libs[label] = native.Library(built)
        print(f"build {label} ({src}): {built.seconds:.2f} s -> "
              f"{built.path.name}")
        # ptxas -v: each entry's registers and spills (the lines follow
        # it), K2's or the convs'
        log = built.log.splitlines()
        entry = {"k2": ("up_kernel",), "k1f32": ("split_f32_kernel",),
                 "k2f32": ("up_split6_kernel", "up_f32_kernel"),
                 "k7f32": ("split6_kernel", "conv_same_f32_kernel"),
                 "k5": ("gn_kernel", "stats_partial", "stats_final",
                        "apply_kernel"),
                 "q8": ("conv3d_int8",)}.get(
            args.kernel, ("conv_kernel",))
        for i, line in enumerate(log):
            if "entry function" in line and any(e in line for e in entry):
                info = [x.strip() for x in log[i + 1:i + 5]
                        if "Used" in x or "spill" in x]
                print(f"  {line.split(chr(39))[1]}: {'; '.join(info)}")

    def use(label):
        native._library = libs[label]

    if args.kernel == "k5":
        out = compare_k5(libs, use, args.rounds)
    elif args.kernel == "q8":
        out = compare_q8(libs, use, args.rounds)
    elif args.kernel == "k7":
        out = compare_k7(libs, use, args.rounds)
    elif args.kernel == "k7f32":
        from .ops.conv import full_f32
        with full_f32():
            out = compare_k7(libs, use, args.rounds, True)
    elif args.kernel == "k2":
        out = compare_forms(k2_forms(), libs, use, args.rounds,
                            "F.conv_transpose3d", _ulp, halo=True)
    elif args.kernel == "k2f32":
        from .ops.conv import full_f32
        with full_f32():
            out = compare_forms(k2_forms(dtype=torch.float32), libs, use,
                                args.rounds, "F.conv_transpose3d",
                                lambda m: 1e-5 * m, halo=True)
    elif args.kernel == "k1f32":
        from .ops.conv import full_f32
        with full_f32():
            out = compare_k1(libs, use, args.rounds, args.reps, True)
    else:
        out = compare_k1(libs, use, args.rounds, args.reps)
    native._library = None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "kernel": args.kernel, **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
