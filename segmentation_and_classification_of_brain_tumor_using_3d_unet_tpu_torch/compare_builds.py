"""Time K1 (``ops/ps2d.py::conv3d_halo``) as built from other source
trees beside the package's own build, in one process on one card.

Each ``--against LABEL=DIR`` names a ``csrc`` directory (for example the
parent commit's, unpacked with ``git archive``). Every tree is built by
``ops/native.py`` as the package's own is, and the wrapper is pointed at
each build in turn. At each of the UNet's level-0 call forms, at the
server's batch of 4 windows of 128^3, the builds are timed in rounds
that run them forward and then backward (A B B A for two), each time the
mean of ``--reps`` launches between CUDA events; the script prints the
median per build. Every build's output must equal the package build's
bit for bit, and its statistics (summed with float atomics, in no fixed
order) within 1e-5 relative.

    python -m segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.compare_builds \\
        --against parent=/path/to/parent/csrc

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


def level0_forms(B: int = 4, S: int = 128, C: int = 32, seed: int = 0):
    """K1's level-0 call forms in the server's request (as
    ``chip_smoke.py``'s kernel phase builds them): name -> kwargs."""
    import torch
    from .ops import ps2d as T

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, device="cuda", generator=g)
                * scale).to(dtype)

    h0 = [T.pack_halo_plain(rnd((B, S, S, S, C))) for _ in range(2)]
    mask = T.pack_halo_plain(torch.rand((B, S, S, S, C), device="cuda",
                                        generator=g).to(torch.bfloat16))
    std = (2 / (27 * C)) ** 0.5
    return {
        "enc0.conv2/dec0.conv2 (4,130^3,32)->32, affine+relu": dict(
            xs=(h0[0],), w=rnd((3, 3, 3, C, C), std),
            in_scale=1 + rnd((B, C), 0.3), in_shift=rnd((B, C), 0.3),
            in_relu=True),
        "dec0.conv1 2x(4,130^3,32)->32, mask": dict(
            xs=(h0[0], h0[1]), w=rnd((3, 3, 3, 2 * C, C), std),
            in_mul0=mask),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    metavar="LABEL=DIR", help="a csrc directory to compare")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from .ops import native
    from .ops import ps2d as T

    if not torch.cuda.is_available():
        raise SystemExit("compare_builds: needs a CUDA device")
    trees = {"this": native.CSRC_DIR}
    for spec in args.against:
        label, _, path = spec.partition("=")
        if not path or label in trees:
            raise SystemExit(f"compare_builds: bad --against {spec!r}")
        trees[label] = Path(path)
    libs = {}
    for label, src in trees.items():
        built = native.build(src)
        libs[label] = native.Library(built)
        print(f"build {label} ({src}): {built.seconds:.2f} s -> "
              f"{built.path.name}")
        # ptxas -v: each conv entry's registers (the lines follow it)
        log = built.log.splitlines()
        for i, line in enumerate(log):
            if "entry function" in line and "conv_kernel" in line:
                regs = next((x for x in log[i + 1:i + 5] if "Used" in x), "")
                print(f"  {line.split(chr(39))[1]}: {regs.strip()}")

    def use(label):
        native._library = libs[label]

    order = list(libs) + list(libs)[::-1]
    result = {}
    for name, kw in level0_forms().items():
        outs = {}
        for label in libs:
            use(label)
            outs[label] = T.conv3d_halo(emit_stats=True, **kw)
        y0, sums0 = outs["this"]
        for label, (y, sums) in outs.items():
            if not torch.equal(y, y0) or any(
                    (s - r).abs().max() > 1e-5 * r.abs().max()
                    for s, r in zip(sums, sums0)):
                raise SystemExit(f"compare_builds: {label} differs from "
                                 f"this build at {name}")
        del outs
        times = {label: [] for label in libs}
        for _ in range(args.rounds):
            for label in order:
                use(label)
                times[label].append(event_ms(
                    lambda: T.conv3d_halo(emit_stats=True, **kw), args.reps))
        med = {k: float(np.median(v)) for k, v in times.items()}
        result[name] = {"median_ms": med, "ms": times}
        print(f"{name}: " + ", ".join(
            f"{k} {v:.4f} ms ({' '.join(f'{t:.4f}' for t in times[k])})"
            for k, v in med.items()))
    native._library = None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "forms": {
        k: v["median_ms"] for k, v in result.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
