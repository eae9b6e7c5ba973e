"""Shared dataset machinery (copy of itermvs_tpu/data/base.py).

Loaders emit NHWC numpy samples with the reference's field layout:

    imgs:          level_0..3 → [V, H_l, W_l, 3] float32 in [−1, 1]
                   (level_0 optionally raw uint8)
    proj_matrices: level_0..3 → [V, 4, 4]
    depth_min/max: float scalars
    (train) depth/mask: level_0..3 → [H_l, W_l, 1]
    (eval)  filename:   '<scan>/{}/<refview:08d>{}' template

Image pyramids: scale to [−1, 1], optional INTER_LINEAR resize to the
target, then INTER_LINEAR /2 /4 /8; GT depth and mask pyramids use
INTER_NEAREST. `cv2` and `PIL` are imported only inside the functions
that decode or resize image files, so the rest of the port runs where
they are not installed.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np

from itermvs_tpu_torch.io import read_cam_file, read_pair_file

LEVELS = 4


def image_pyramid(img, img_wh: tuple[int, int] | None,
                  uint8_level0: bool = False) -> dict:
    """[-1,1]-scaled multi-scale pyramid from an HWC uint8 image.

    With `uint8_level0`, level_0 stays raw uint8 and the model scales it
    with the same expression `2·x/255 − 1` (Pipeline._normalize)."""
    import cv2

    raw = np.asarray(img)
    np_img = 2.0 * raw.astype(np.float32) / 255.0 - 1.0
    resize = (img_wh is not None
              and (np_img.shape[1], np_img.shape[0]) != tuple(img_wh))
    if resize:
        np_img = cv2.resize(np_img, tuple(img_wh), interpolation=cv2.INTER_LINEAR)
    h, w, _ = np_img.shape
    if uint8_level0:
        level0 = raw.astype(np.uint8, copy=False)
        if resize:
            level0 = cv2.resize(level0, tuple(img_wh),
                                interpolation=cv2.INTER_LINEAR)
    else:
        level0 = np_img
    return {
        "level_3": cv2.resize(np_img, (w // 8, h // 8), interpolation=cv2.INTER_LINEAR),
        "level_2": cv2.resize(np_img, (w // 4, h // 4), interpolation=cv2.INTER_LINEAR),
        "level_1": cv2.resize(np_img, (w // 2, h // 2), interpolation=cv2.INTER_LINEAR),
        "level_0": level0,
    }


class _PyramidCache:
    """Per-process LRU of decoded eval image pyramids.

    Every image appears in ~n_views eval samples; a pyramid is a pure
    function of (path, img_wh, uint8_level0), so an LRU keyed on those
    plus (mtime, size) saves the repeated decodes. Entries are read-only
    and returned by reference (`stack_views` copies). Capacity
    `ITERMVS_DECODE_CACHE_MB` (default 256; 0 disables), split across
    loader worker processes by `split_decode_cache_cap`."""

    def __init__(self, cap_mb: float):
        self.cap = cap_mb * 1e6
        self.size = 0
        self.lock = threading.Lock()
        self.data: OrderedDict = OrderedDict()

    def _evict(self):
        while self.size > self.cap and len(self.data) > 1:
            _, (old, _) = self.data.popitem(last=False)
            self.size -= sum(a.nbytes for a in old.values())

    def set_cap(self, cap_mb: float):
        with self.lock:
            self.cap = cap_mb * 1e6
            self._evict()

    def get(self, path, img_wh, uint8_level0: bool):
        """(pyramid dict, original (w, h)) for an image file."""
        st = os.stat(path)
        key = (os.path.abspath(path),
               tuple(img_wh) if img_wh is not None else None,
               bool(uint8_level0), st.st_mtime_ns, st.st_size)
        with self.lock:
            entry = self.data.get(key)
            if entry is not None:
                self.data.move_to_end(key)
                return entry
        from PIL import Image

        pil = Image.open(path)
        orig_wh = pil.size
        pyr = image_pyramid(pil, img_wh, uint8_level0=uint8_level0)
        for a in pyr.values():
            a.setflags(write=False)
        entry = (pyr, orig_wh)
        if self.cap <= 0:
            return entry
        with self.lock:
            if key not in self.data:      # concurrent miss: first wins
                self.data[key] = entry
                self.size += sum(a.nbytes for a in pyr.values())
                self._evict()
        return entry


def _cache_cap_mb() -> float:
    return float(os.environ.get("ITERMVS_DECODE_CACHE_MB", "256"))


_pyramid_cache = _PyramidCache(_cache_cap_mb())


def cached_image_pyramid(path, img_wh, uint8_level0: bool = False):
    """LRU-cached decode + `image_pyramid` for eval loaders.

    Returns (pyramid dict of read-only arrays, original (w, h))."""
    return _pyramid_cache.get(path, img_wh, uint8_level0)


def split_decode_cache_cap(workers: int):
    """Shrink this process's decode-cache cap to 1/workers of the
    configured budget (called in each loader worker process)."""
    _pyramid_cache.set_cap(_cache_cap_mb() / max(1, workers))


def nearest_pyramid(arr: np.ndarray) -> dict:
    """INTER_NEAREST /1 /2 /4 /8 pyramid of an [H, W] float map."""
    import cv2

    h, w = arr.shape
    return {f"level_{i}": cv2.resize(arr, (w // (2 ** i), h // (2 ** i)),
                                     interpolation=cv2.INTER_NEAREST)
            for i in range(LEVELS)}


def color_jitter(pil_img, rng, brightness=0.5, contrast=0.5):
    """torchvision-equivalent ColorJitter(brightness, contrast) on PIL:
    factors U[1−b, 1+b] and U[1−c, 1+c], applied in random order (the
    reference's training augmentation)."""
    from PIL import ImageEnhance

    b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    ops = [lambda im: ImageEnhance.Brightness(im).enhance(b),
           lambda im: ImageEnhance.Contrast(im).enhance(c)]
    for i in rng.permutation(2):
        pil_img = ops[i](pil_img)
    return pil_img


def proj_matrix_pyramid(intrinsics: np.ndarray, extrinsics: np.ndarray) -> dict:
    """Per-level 4×4 projections `[K_l·E ; E_lastrow]`; level l scales the
    first two rows of the full-resolution K by 2^−l."""
    out = {}
    for level in range(LEVELS):
        k = intrinsics.copy()
        k[:2] *= 0.5 ** level
        p = extrinsics.copy()
        p[:3, :4] = k @ extrinsics[:3, :4]
        out[f"level_{level}"] = p
    return out


def stack_views(per_view: list[dict], keys=("level_0", "level_1", "level_2", "level_3")):
    """List of per-view level dicts → level dict of [V, ...] stacks."""
    return {k: np.stack([pv[k] for pv in per_view]) for k in keys}


class MVSDatasetBase:
    """Map-style dataset protocol (len / getitem), usable by
    `torch.utils.data.DataLoader`."""

    metas: list
    seed: int = 0
    _epoch: int = 0

    def __len__(self):
        return len(self.metas)

    def set_epoch(self, epoch: int):
        """Set by the loader so that per-item randomness varies by epoch."""
        self._epoch = int(epoch)

    def item_rng(self, idx: int) -> np.random.Generator:
        """Per-item generator: (seed, epoch, idx) fully determines the
        sample, whichever worker draws it."""
        return np.random.default_rng((self.seed, self._epoch, int(idx)))

    def __getitem__(self, idx):
        raise NotImplementedError

    @staticmethod
    def read_pair_list(path):
        return read_pair_file(path)

    @staticmethod
    def read_cam(path):
        return read_cam_file(path)

    @staticmethod
    def read_image(path):
        from PIL import Image

        return Image.open(path)

    @staticmethod
    def expand_map(level_dict):
        """[H,W] float maps → [H,W,1] (NHWC channel axis)."""
        return {k: v[..., None].astype(np.float32) for k, v in level_dict.items()}
