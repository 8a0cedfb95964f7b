"""Where K5's time goes: variant builds of ``csrc/group_norm.cu`` and a
per-block timeline, on the card, at ``compare_builds.py --kernel k5``'s
five forms.

  * ``variants``: the package's ``csrc`` copied once per variant with one
    change each, built by ``ops/native.py``, and timed in alternated
    rounds (flushed medians, as ``compare_builds.py``): ``base`` (the
    source as it is), ``stats_only`` (the apply pass does no work: the
    statistics pass, the grid barrier and the launch), ``no_compute``
    (the apply pass moves its stages but computes nothing),
    ``no_resident`` (no resident area), ``no_evict_last`` (no stage kept
    in L2 by policy), ``stages_16k`` (16 KB stages). Timing only: the
    ``stats_only`` and ``no_compute`` builds return wrong values by
    design, and no build is checked.
  * ``timeline``: a build with ``%globaltimer`` stamps (a block's start,
    its statistics done, the grid barrier passed, its apply done),
    written past the scratch the kernel uses; prints their spread over
    the blocks in microseconds.

    python -m segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.k5_probe variants
    python -m segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.k5_probe timeline

The last line is a JSON object of the readings, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import tempfile
from pathlib import Path

APPLY_LOOP = "for (int t = 0; t < S; ++t)"
VARIANTS = {
    "base": [],
    "stats_only": [(APPLY_LOOP, "for (int t = 0; t < 0; ++t)")],
    "no_compute": [("    apply_rows<T, R, V, false>(\n",
                    "    if (0) apply_rows<T, R, V, false>(\n")],
    "no_resident": [("if (p.nres > 32 - p.depth) p.nres = 32 - p.depth;",
                     "p.nres = 0;")],
    "no_evict_last": [("const bool keep = s >= nres",
                       "const bool keep = false && s >= nres")],
    "stages_16k": [("constexpr int kStageBytes = 32768;",
                    "constexpr int kStageBytes = 16384;")],
}
STAMP = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"({}));'
TIMELINE = [
    ("  for (int i = threadIdx.x; i < red_floats; i += kThreads) red[i] = 0.f;\n"
     "  __syncthreads();\n",
     "  for (int i = threadIdx.x; i < red_floats; i += kThreads) red[i] = 0.f;\n"
     "  __syncthreads();\n  unsigned long long t0;\n  " + STAMP.format("t0") + "\n"),
    ("  cg::this_grid().sync();\n\n  // ------",
     "  unsigned long long t1, t2;\n  " + STAMP.format("t1") + "\n"
     "  cg::this_grid().sync();\n  " + STAMP.format("t2") + "\n\n  // ------"),
    ("    if (threadIdx.x == 0) mbar_arrive(ready(i));\n  }\n}\n",
     "    if (threadIdx.x == 0) mbar_arrive(ready(i));\n  }\n"
     "  if (threadIdx.x == 0) {\n    unsigned long long t3;\n    "
     + STAMP.format("t3") + "\n    unsigned long long* o = reinterpret_cast"
     "<unsigned long long*>(a.part + (size_t)(p.grid + a.N) * 2 * C) + 4 * b;\n"
     "    o[0] = t0;\n    o[1] = t1;\n    o[2] = t2;\n    o[3] = t3;\n  }\n}\n"),
]


def variant_tree(root: Path, label: str, subs) -> Path:
    """A copy of the package's csrc with each (old, new) replaced; every
    old text must occur."""
    from .ops import native

    d = root / label
    shutil.copytree(native.CSRC_DIR, d)
    src = (d / "group_norm.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"k5_probe: {label}: {old!r} not in the source")
        src = src.replace(old, new)
    (d / "group_norm.cu").write_text(src)
    return d


def variants(root: Path, rounds: int) -> dict:
    import numpy as np
    import torch
    from .compare_builds import flushed_ms, k5_forms
    from .ops import groupnorm as GN
    from .ops import native

    libs = {}
    for label, subs in VARIANTS.items():
        built = native.build(variant_tree(root, label, subs))
        libs[label] = native.Library(built)
        print(f"built {label}: {built.seconds:.2f} s", flush=True)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    order = list(libs) + list(libs)[::-1]
    out = {}
    for name, kw in k5_forms().items():
        times = {label: [] for label in libs}
        for _ in range(rounds):
            for label in order:
                native._library = libs[label]
                times[label].append(flushed_ms(
                    lambda: GN.fused_group_norm(**kw), 10, scratch))
        out[name] = {k: float(np.median(v)) for k, v in times.items()}
        print(f"{name}: " + ", ".join(f"{k} {v:.4f} ms"
                                      for k, v in out[name].items()),
              flush=True)
    native._library = None
    return out


def timeline(root: Path) -> dict:
    import numpy as np
    import torch
    from .compare_builds import k5_forms
    from .ops import groupnorm as GN
    from .ops import native
    from .ops import ps2d as T

    lib = native.Library(native.build(variant_tree(root, "timeline",
                                                   TIMELINE)))
    dt = {torch.float32: 0, torch.bfloat16: 1}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, kw in k5_forms().items():
        x, r = kw["x"], kw["residual"]
        n, c = x.shape[0], x.shape[-1]
        m = x.numel() // (n * c)
        part = torch.zeros((sms + n) * 2 * c + 8 * sms, device="cuda")
        y = torch.empty_like(x)
        for _ in range(3):                      # the last launch is read
            lib.check("group_norm", lib.group_norm(
                x.data_ptr(), dt[x.dtype], T._ptr(r),
                0 if r is None else dt[r.dtype], int(kw["relu"]),
                kw["gamma"].float().data_ptr(), kw["beta"].float().data_ptr(),
                1e-5, y.data_ptr(), part.data_ptr(), sms, n, m, c,
                kw["num_groups"], T._stream()))
            torch.cuda.synchronize()
        grid = GN.group_norm_device_plan(
            n, m, c, x.dtype, GN.residual_stream_dtype(x, r))["grid"]
        off = (grid + n) * 2 * c
        ts = part[off:off + 8 * grid].view(torch.int64).reshape(grid, 4)
        ts = (ts.cpu().numpy() - int(ts[:, 0].min())) / 1e3

        def spread(v):
            return [round(float(f(v)), 2) for f in (np.min, np.median,
                                                    np.max)]
        out[name] = {"stats_done": spread(ts[:, 1]),
                     "barrier_passed": spread(ts[:, 2]),
                     "apply_done": spread(ts[:, 3]),
                     "stats_us": spread(ts[:, 1] - ts[:, 0]),
                     "apply_us": spread(ts[:, 3] - ts[:, 2])}
        print(f"{name} (min, median, max over {grid} blocks, us from the "
              f"first start): {out[name]}", flush=True)
    native._library = None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("variants", "timeline"))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k5_probe: needs a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        out = (variants(Path(tmp), args.rounds) if args.mode == "variants"
               else timeline(Path(tmp)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "mode": args.mode, **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
