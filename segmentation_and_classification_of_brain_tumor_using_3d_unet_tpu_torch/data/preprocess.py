"""The preprocessing chain on the tensor's device (counterpart of the JAX
package's ``data/preprocess.py``).

The deterministic half: percentile clip (1, 99) -> z-score (eps 1e-8) ->
trilinear resize, and the label chain (BraTS label 4 -> 3, nearest
resize); ``normalize_batch`` runs it over a batch.

The random half (``augment_pair``, ``augment_batch``): rot90 in the
(H, W) plane, flips along D, H and W, Gaussian noise, intensity scaling
and a gamma curve. Where JAX splits a key and branches on traced draws,
the port draws every decision from a CPU ``torch.Generator``
(``draw_augment``), so no draw waits on the device, and only the noise
field is drawn on the image's device, from a generator seeded by that
CPU generator; ``apply_augment`` then applies fixed draws.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..config import AugmentConfig
from ..ops.resize import resize_nearest, resize_trilinear
from ..ops.stats import percentile_clip, zscore_normalize


def preprocess_image(vol: torch.Tensor,
                     out_size: Optional[Tuple[int, int, int]] = (128, 128,
                                                                 128),
                     clip: Tuple[float, float] = (1.0, 99.0)
                     ) -> torch.Tensor:
    """clip -> z-score -> resize of (D, H, W) or (D, H, W, C), float32
    out. A (D, H, W, C) volume is clipped and z-scored as one tensor
    across all its channels, as JAX does. ``out_size=None`` keeps the
    native resolution."""
    squeeze = vol.ndim == 3
    if squeeze:
        vol = vol[..., None]
    vol = zscore_normalize(percentile_clip(vol, *clip))
    if out_size is not None and tuple(out_size) != tuple(vol.shape[:3]):
        vol = resize_trilinear(vol[None], out_size)[0]
    return vol[..., 0] if squeeze else vol


def preprocess_multimodal(vols: torch.Tensor,
                          out_size: Optional[Tuple[int, int, int]]
                          = (128, 128, 128),
                          clip: Tuple[float, float] = (1.0, 99.0)
                          ) -> torch.Tensor:
    """(D, H, W, M) stack, each modality normalised on its own."""
    return torch.stack([preprocess_image(vols[..., m], out_size, clip)
                        for m in range(vols.shape[-1])], dim=-1)


def preprocess_segmentation(seg: torch.Tensor,
                            out_size: Optional[Tuple[int, int, int]]
                            = (128, 128, 128)) -> torch.Tensor:
    """BraTS label 4 -> 3, nearest resize, int32. ``out_size=None``
    keeps the native resolution."""
    seg = torch.where(seg == 4, 3, seg).to(torch.int32)
    if out_size is None:
        return seg
    return resize_nearest(seg[None, ..., None], out_size)[0, ..., 0]


def _uniform(g: torch.Generator, lo: float, hi: float) -> float:
    return lo + (hi - lo) * float(torch.rand((), generator=g,
                                             dtype=torch.float64))


def _bernoulli(g: torch.Generator, p: float) -> bool:
    return float(torch.rand((), generator=g, dtype=torch.float64)) < p


def draw_augment(generator: torch.Generator, shape: Sequence[int],
                 cfg: AugmentConfig = AugmentConfig(), device="cpu",
                 dtype=torch.float32) -> Dict:
    """Every random decision of ``augment_pair`` for one (D, H, W, C)
    image, drawn from the CPU ``generator`` in a fixed order: rot90 on
    or off and its k (1-3 for a square H == W plane; rectangular planes
    keep their shape, so k = 2 only), the three flips, noise on or off
    with sigma ~ U(0, noise_sigma_max), intensity scaling on or off with
    its factor ~ U(range), the gamma curve on or off with gamma ~
    U(range). The unit noise field (N(0, 1), ``shape``) is drawn on
    ``device`` only when noise is on."""
    draws = _draw_decisions(generator, shape, cfg)
    if draws["noise"]:
        dg = torch.Generator(device=device).manual_seed(draws["noise_seed"])
        draws["noise_field"] = torch.randn(tuple(shape), generator=dg,
                                           device=device, dtype=dtype)
    return draws


def _draw_decisions(g: torch.Generator, shape: Sequence[int],
                    cfg: AugmentConfig) -> Dict:
    """``draw_augment``'s draws from ``g`` without the noise field."""
    square = shape[1] == shape[2]
    return {"rot": _bernoulli(g, cfg.rot90_prob),
            "k": int(torch.randint(1, 4, (), generator=g)) if square else 2,
            "flips": tuple(_bernoulli(g, cfg.flip_prob) for _ in range(3)),
            "noise": _bernoulli(g, cfg.noise_prob),
            "sigma": _uniform(g, 0.0, cfg.noise_sigma_max),
            "noise_seed": int(torch.randint(2 ** 62, (), generator=g)),
            "scale_on": _bernoulli(g, cfg.intensity_prob),
            "scale": _uniform(g, *cfg.intensity_range),
            "gamma_on": (cfg.gamma_prob > 0.0
                         and _bernoulli(g, cfg.gamma_prob)),
            "gamma": _uniform(g, *cfg.gamma_range),
            "noise_field": None}


def apply_augment(image: torch.Tensor, seg: torch.Tensor, draws: Dict
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``draws`` (``draw_augment``'s) applied to image (D, H, W, C) and
    seg (D, H, W): the geometric transforms to both, the intensity ones
    to the image only, in JAX's order."""
    if draws["rot"]:
        image = torch.rot90(image, draws["k"], dims=(1, 2))
        seg = torch.rot90(seg, draws["k"], dims=(1, 2))
    for ax, flip in enumerate(draws["flips"]):
        if flip:
            image, seg = image.flip(ax), seg.flip(ax)
    if draws["noise"]:
        image = image + draws["noise_field"] * draws["sigma"]
    if draws["scale_on"]:
        image = image * draws["scale"]
    if draws["gamma_on"]:
        # per-volume min/max over every channel
        mn, mx = image.min(), image.max()
        unit = (image - mn) / (mx - mn + 1e-8)
        image = unit ** draws["gamma"] * (mx - mn) + mn
    return image.contiguous(), seg.contiguous()


def augment_pair(image: torch.Tensor, seg: torch.Tensor,
                 cfg: AugmentConfig = AugmentConfig(),
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random rot90 / flips / noise / intensity / gamma on one (image
    (D, H, W, C) float, seg (D, H, W) int) pair, on their device (JAX
    ``augment_pair``); ``generator`` is a CPU generator."""
    draws = draw_augment(generator or torch.Generator(), image.shape, cfg,
                         image.device, image.dtype)
    return apply_augment(image, seg, draws)


def normalize_batch(images: torch.Tensor, segs: torch.Tensor,
                    out_size: Optional[Tuple[int, int, int]] = (128, 128,
                                                                128),
                    clip: Tuple[float, float] = (1.0, 99.0)
                    ) -> Dict[str, torch.Tensor]:
    """The deterministic half over a batch (B, D, H, W, M) + (B, D, H, W)
    raw labels: each modality clipped, z-scored and resized, the labels
    remapped and resized ({"image" f32, "mask" int32})."""
    imgs = [preprocess_multimodal(i, out_size, clip) for i in images]
    masks = [preprocess_segmentation(m, out_size) for m in segs]
    return {"image": torch.stack(imgs), "mask": torch.stack(masks)}


def augment_batch(images: torch.Tensor, segs: torch.Tensor,
                  generator: torch.Generator,
                  aug_cfg: AugmentConfig = AugmentConfig(),
                  rows: slice = None, total: int = None
                  ) -> Dict[str, torch.Tensor]:
    """The random half over a normalised batch, one draw per sample.

    ``rows`` / ``total``: ``images`` are rows ``rows`` of a batch of
    ``total`` (a data-parallel rank's share); the other rows' draws are
    taken from ``generator`` and dropped, so that each row gets the
    draws it gets in the whole batch."""
    lo = 0 if rows is None else rows.start
    hi = images.shape[0] + lo if total is None else total
    shape = tuple(images.shape[1:])
    for _ in range(lo):
        _draw_decisions(generator, shape, aug_cfg)
    pairs = [augment_pair(i, s, aug_cfg, generator)
             for i, s in zip(images, segs)]
    for _ in range(lo + images.shape[0], hi):
        _draw_decisions(generator, shape, aug_cfg)
    return {"image": torch.stack([p[0] for p in pairs]),
            "mask": torch.stack([p[1] for p in pairs])}


def preprocess_batch(images: torch.Tensor, segs: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     out_size: Tuple[int, int, int] = (128, 128, 128),
                     augment: bool = False,
                     clip: Tuple[float, float] = (1.0, 99.0),
                     aug_cfg: AugmentConfig = AugmentConfig()
                     ) -> Dict[str, torch.Tensor]:
    """Raw (B, D, H, W, M) + (B, D, H, W) labels -> the normalised,
    resized and (with ``augment``) augmented training batch."""
    out = normalize_batch(images, segs, out_size, clip)
    if augment:
        out = augment_batch(out["image"], out["mask"],
                            generator or torch.Generator(), aug_cfg)
    return out


def create_data_transforms():
    """Augmentation on or off per split (the reference's transform
    dictionary); the transforms themselves are the functions above."""
    return {"train": True, "val": False}
