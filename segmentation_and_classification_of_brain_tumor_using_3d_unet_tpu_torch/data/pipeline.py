"""Host -> device data pipeline (counterpart of the JAX package's
``data/pipeline.py``).

  host threads decode and assemble batches -> bounded queue -> pinned
  host buffers -> asynchronous copy on a side CUDA stream -> augmentation
  on the device

The deterministic half of the chain (clip -> z-score -> resize,
``preprocess.normalize_batch``) runs once per sample, on the device on
a stream of its own, and its result is cached on the host (LRU), so
later epochs pay only the copy and the augmentation. The random draws
are JAX's: the shuffle order is ``default_rng(seed + epoch)`` and a
patch's ``default_rng(seed * 1_000_003 + epoch * 10_007 + idx)``, so
the two packages train on the same voxels; the augmentation draws from
a ``torch.Generator`` seeded with ``seed + 1000 * epoch``.

With a ``sharding`` (``parallel.mesh.batch_sharding``, data-parallel
training) every rank draws the same global batches and keeps its rows of
each: only those are decoded, normalised, copied and augmented, and the
other rows' augmentation draws are taken and dropped, so that each row
is what one process would give it. When the mesh's ``space`` axis is
longer than 1, each rank then keeps its D slab of its rows: the rows are
augmented whole (a flip along D, the noise field and the gamma curve's
range are the whole sample's), with the same draws on every rank of a
``space`` group, and sliced after.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import AugmentConfig
from ..device import resolve_device
from ..inference import cropping
from .dataset import BraTS2024Dataset
from .preprocess import augment_batch, normalize_batch

_STOP = object()


class DeviceDataLoader:
    """Iterates preprocessed batches on ``device``: ``{"image": (B,
    *image_size, M) float32, "mask": (B, *image_size) int32}`` (with
    ``patch_size``, native-resolution foreground-biased patches of that
    size instead of whole volumes resized to ``image_size``).

    ``stats`` holds, for the last epoch, the host seconds the consumer
    waited for the producer (``wait_s``) and the batches delivered;
    ``h2d_ms()`` the device milliseconds of their host -> device
    copies."""

    def __init__(self, dataset, batch_size: int = 2,
                 image_size: Tuple[int, int, int] = (128, 128, 128),
                 augment: bool = False, shuffle: bool = False,
                 seed: int = 42, num_workers: int = 4,
                 prefetch: int = 2, drop_last: bool = False,
                 device="cuda", aug_cfg: AugmentConfig = AugmentConfig(),
                 norm_cache_size: int = 64,
                 patch_size: Optional[Tuple[int, int, int]] = None,
                 fg_patch_prob: float = 0.5, sharding=None):
        self.sharding = sharding
        self.dataset = dataset
        self.batch_size = batch_size
        self.image_size = tuple(image_size)
        self.patch_size = tuple(patch_size) if patch_size else None
        self.fg_patch_prob = float(fg_patch_prob)
        self.augment = augment
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.device = resolve_device(device)
        self.aug_cfg = aug_cfg
        self.norm_cache_size = norm_cache_size
        self._norm_cache: "OrderedDict[int, tuple]" = OrderedDict()
        self._cache_lock = threading.Lock()
        self._epoch = 0
        cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._norm_stream = torch.cuda.Stream(self.device) if cuda else None
        self.stats: Dict[str, float] = {}
        self._events: list = []

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    # ------------------------------------------------------------------

    def _load_raw(self, idx: int):
        it = self.dataset[int(idx)]
        img = it["image"]
        mask = it["mask"] if "mask" in it else it["segmentation"]
        if img.ndim == 3:
            img = img[..., None]
        return img.astype(np.float32), mask

    def _normalize(self, img: np.ndarray, mask: np.ndarray, out_size):
        """``normalize_batch`` of one sample on the device (on the
        loader's own stream, so it never waits on the train step's),
        back as host arrays."""
        def run():
            out = normalize_batch(
                torch.from_numpy(np.ascontiguousarray(img))[None]
                .to(self.device),
                torch.from_numpy(np.ascontiguousarray(mask, np.int32))[None]
                .to(self.device), out_size=out_size)
            return (out["image"][0].cpu().numpy(),
                    out["mask"][0].cpu().numpy())
        if self._norm_stream is None:
            return run()
        with torch.cuda.stream(self._norm_stream):
            return run()

    def _get_normalized(self, idx: int):
        """Host-cached (image float32, mask int32[, foreground table]).

        Whole-volume mode: resized to ``image_size``. Patch mode: native
        resolution, cropped to the raw nonzero bounding box rounded up to
        multiples of 32 (JAX's buckets), with a subsampled table of
        foreground voxel coordinates for the biased sampling."""
        with self._cache_lock:
            if idx in self._norm_cache:
                self._norm_cache.move_to_end(idx)
                return self._norm_cache[idx]
        img, mask = self._load_raw(idx)
        if self.patch_size is None:
            entry = self._normalize(img, mask, self.image_size)
        else:
            # the box of the RAW image (the z-score moves exact zeros)
            lo, hi = cropping.nonzero_bbox(img)
            full = img.shape[:3]
            bucket = cropping.bucket_shape(
                [h - l for l, h in zip(lo, hi)], full, multiple=32,
                min_size=32)
            offs = cropping.crop_offsets((lo, hi), bucket, full)
            sl = tuple(slice(o, min(o + b, f))
                       for o, b, f in zip(offs, bucket, full))
            nimg, nmask = self._normalize(img[sl], mask[sl], None)
            fg = np.argwhere(nmask > 0).astype(np.int32)
            if len(fg) > 4096:
                fg = fg[:: len(fg) // 4096 + 1]
            entry = (nimg, nmask, fg)
        with self._cache_lock:
            self._norm_cache[idx] = entry
            while len(self._norm_cache) > self.norm_cache_size:
                self._norm_cache.popitem(last=False)
        return entry

    def _sample_patch(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """One foreground-biased random patch: a ``fg_patch_prob`` share
        of the patches is centred on a random tumour voxel."""
        img, mask, fg = self._get_normalized(idx)
        ps = self.patch_size
        rng = np.random.default_rng(
            self.seed * 1_000_003 + self._epoch * 10_007 + idx)
        shape = mask.shape
        if len(fg) and rng.random() < self.fg_patch_prob:
            center = fg[rng.integers(len(fg))]
            starts = [int(np.clip(c - p // 2, 0, max(s - p, 0)))
                      for c, p, s in zip(center, ps, shape)]
        else:
            starts = [int(rng.integers(0, max(s - p, 0) + 1))
                      for p, s in zip(ps, shape)]
        sl = tuple(slice(st, min(st + p, s))
                   for st, p, s in zip(starts, ps, shape))
        pimg = img[sl]
        pmask = mask[sl]
        pads = [(0, p - (s.stop - s.start)) for p, s in zip(ps, sl)]
        if any(p[1] for p in pads):
            pimg = np.pad(pimg, pads + [(0, 0)])
            pmask = np.pad(pmask, pads)
        return pimg, pmask

    def _assemble(self, indices) -> Dict[str, torch.Tensor]:
        """One host batch; in pinned memory when the device is a card."""
        imgs, masks = [], []
        for i in indices:
            if self.patch_size is not None:
                img, mask = self._sample_patch(int(i))
            else:
                img, mask = self._get_normalized(int(i))
            imgs.append(img)
            masks.append(mask)
        out = {"image": torch.from_numpy(np.stack(imgs)),
               "mask": torch.from_numpy(np.stack(masks))}
        if self._copy_stream is not None:
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _to_device(self, host: Dict[str, torch.Tensor]):
        """Start the batch's copy; returns (tensors, events): the copy
        runs on the side stream, and the consumer's stream waits on its
        end event before it reads the batch."""
        if self._copy_stream is None:
            return host, None
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with torch.cuda.stream(self._copy_stream):
            ev[0].record()
            dev = {k: v.to(self.device, non_blocking=True)
                   for k, v in host.items()}
            ev[1].record()
        return dev, ev

    def _ready(self, dev, ev, generator, rows=None, total=None
               ) -> Dict[str, torch.Tensor]:
        """The batch, usable on the current stream: the stream waits for
        its copy, and the copy's memory is marked in use there so the
        allocator does not hand it out again before that stream is done
        with it; then the augmentation, and this rank's D slab."""
        if ev is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ev[1])
            for t in dev.values():
                t.record_stream(stream)
            self._events.append(ev)
        if self.augment:
            dev = augment_batch(dev["image"], dev["mask"], generator,
                                self.aug_cfg, rows, total)
        if self.sharding is not None and self.sharding.mesh.shape.get(
                "space", 1) > 1:
            dev = {k: self.sharding.slab(v).contiguous()
                   for k, v in dev.items()}
        return dev

    def _rows(self, indices) -> slice:
        """This rank's rows of a global batch (all without a sharding)."""
        if self.sharding is None:
            return slice(0, len(indices))
        return self.sharding.rows(len(indices))

    def h2d_ms(self) -> float:
        """Device ms of the last epoch's host -> device copies (0 on the
        CPU); waits for the copies to end."""
        if self._copy_stream is None:
            return 0.0
        self._copy_stream.synchronize()
        return float(sum(a.elapsed_time(b) for a, b in self._events))

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        self._epoch += 1
        batches = self._batch_indices()
        generator = torch.Generator().manual_seed(self.seed
                                                  + 1000 * self._epoch)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        closed = threading.Event()   # the consumer has gone
        self._events = []
        self.stats = {"wait_s": 0.0, "batches": 0}

        def producer():
            def put(obj) -> bool:
                """Deliver unless the consumer abandoned the epoch: a
                plain blocking put would pin this thread, and every
                assembled batch, once the consumer stops reading."""
                while not closed.is_set():
                    try:
                        out_q.put(obj, timeout=0.5)
                        return True
                    except queue.Full:
                        continue
                return False

            inflight: "deque" = deque()
            try:
                # submit with a bounded in-flight window, so that host
                # memory stays bounded by the queue
                window = self.num_workers + self.prefetch
                with ThreadPoolExecutor(self.num_workers) as pool:
                    alive = True
                    for b in batches:
                        inflight.append(pool.submit(self._assemble,
                                                    b[self._rows(b)]))
                        if len(inflight) >= window:
                            if not put(inflight.popleft().result()):
                                alive = False
                                break
                    while alive and inflight:
                        if not put(inflight.popleft().result()):
                            break
                    for f in inflight:
                        f.cancel()
            except Exception as e:   # a decode error: to the consumer
                put(e)
            finally:
                put(_STOP)

        t = threading.Thread(target=producer, daemon=True,
                             name="loader-producer")
        t.start()
        self._producer = t

        def get():
            t0 = time.perf_counter()
            host = out_q.get()
            self.stats["wait_s"] += time.perf_counter() - t0
            if isinstance(host, Exception):
                raise host
            return host

        try:
            for b in batches:
                host = get()
                if host is _STOP:
                    break
                # the copy overlaps the device's work on the step before
                batch = self._ready(*self._to_device(host), generator,
                                    self._rows(b), len(b))
                self.stats["batches"] += 1
                yield batch
        finally:
            closed.set()   # unblock the producer if we leave early


def create_brats_data_loaders(data_dir: str, batch_size: int = 2,
                              num_workers: int = 4,
                              image_size: Tuple[int, int, int]
                              = (128, 128, 128),
                              seed: int = 42, device="cuda",
                              aug_cfg: AugmentConfig = AugmentConfig(),
                              patch_size: Optional[
                                  Tuple[int, int, int]] = None,
                              fg_patch_prob: float = 0.5, sharding=None
                              ) -> Tuple[DeviceDataLoader,
                                         DeviceDataLoader]:
    """The train / val loader pair of a BraTS cohort directory. The
    train loader shuffles, drops the last short batch and augments; with
    ``patch_size`` it samples native-resolution patches. Validation is
    whole-volume at ``image_size``, unshuffled, unaugmented. Both keep
    this rank's rows under ``sharding``."""
    train_ds = BraTS2024Dataset(data_dir, mode="train", augment=True)
    val_ds = BraTS2024Dataset(data_dir, mode="val", augment=False)
    train = DeviceDataLoader(
        train_ds, batch_size=batch_size, image_size=image_size,
        augment=True, shuffle=True, seed=seed, num_workers=num_workers,
        drop_last=True, device=device, aug_cfg=aug_cfg,
        patch_size=patch_size, fg_patch_prob=fg_patch_prob,
        sharding=sharding)
    val = DeviceDataLoader(
        val_ds, batch_size=batch_size, image_size=image_size,
        augment=False, shuffle=False, seed=seed, num_workers=num_workers,
        drop_last=False, device=device, sharding=sharding)
    return train, val


def get_data_loader(dataset, batch_size: int = 1, shuffle: bool = False,
                    **kw) -> DeviceDataLoader:
    """A loader over ``dataset`` (the reference's factory)."""
    return DeviceDataLoader(dataset, batch_size=batch_size,
                            shuffle=shuffle, **kw)
