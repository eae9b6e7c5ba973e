"""TensorBoard logging (copy of itermvs_tpu/engine/tb_writer.py for the
port): the reference's tag convention `{mode}/{key}` through
`torch.utils.tensorboard` where it imports, else a no-op.
"""
from __future__ import annotations

import numpy as np


class SummaryWriter:
    def __init__(self, logdir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter as TorchWriter
        except ImportError:
            return
        self._writer = TorchWriter(log_dir=logdir)

    def save_scalars(self, mode: str, scalars: dict, global_step: int):
        if self._writer is None:
            return
        for key, value in scalars.items():
            self._writer.add_scalar(f"{mode}/{key}", float(value), global_step)
        self._writer.flush()

    def save_images(self, mode: str, images: dict, global_step: int):
        """images: dict of [B, H, W, C] or [B, H, W] arrays; logs the first
        item, min-max normalized."""
        if self._writer is None:
            return
        for key, value in images.items():
            img = np.asarray(value).astype(np.float32)
            if img.ndim == 3:
                img = img[..., None]
            img = img[0]
            lo, hi = float(img.min()), float(img.max())
            if hi > lo:
                img = (img - lo) / (hi - lo)
            self._writer.add_image(f"{mode}/{key}", img, global_step,
                                   dataformats="HWC")
        self._writer.flush()
