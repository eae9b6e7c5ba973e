"""Top-level model: FeatureNet → IterMVS (counterpart of
itermvs_tpu/models/pipeline.py).

Consumes the dataset sample layout of the loaders:
  imgs:           dict level_0..level_3 → [B, V, H, W, 3] (NHWC, as the
                  loaders emit it; only level_0 is read)
  proj_matrices:  dict level_0..level_3 → [B, V, 4, 4]
  depth_min/max:  [B]
and returns maps as [B, H, W, C], the JAX layout (test mode: depth and
confidence; train mode: the JAX train dict). Inside, maps are NCHW.

`dtype` is the compute precision, as in the JAX `Pipeline`: float32 (the
default) or bfloat16, which runs convolutions, features and the sweep's
gather tables in bfloat16 and keeps geometry, the correlation sums,
probability softmaxes, depth readout and every head output float32.
Parameters are float32 in both modes (the same checkpoints). float32
is full float32: constructing a `Pipeline` turns TF32 off for cuDNN
convolutions and for matmuls (`disable_tf32`), since PyTorch runs f32
convolutions in TF32 on the card by default.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from itermvs_tpu_torch.models.feature_net import FeatureNet
from itermvs_tpu_torch.models.itermvs import LEVELS, IterMVS
from itermvs_tpu_torch.ops.warping import relative_projection


def disable_tf32() -> None:
    """The port's f32 path is IEEE float32: no TF32 in cuDNN convolutions
    or in matmuls (both are process-wide backend flags)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class Pipeline(nn.Module):
    """IterMVS pipeline (the JAX `Pipeline`; `test` defaults to True here).

    A test-mode Pipeline stays in eval mode whatever `.train()` asks. A
    train-mode one (`test=False`) returns the JAX train dict and follows
    `.train()` / `.eval()`: BatchNorm uses batch statistics (over the B·V
    fold of views) and updates its running ones only in `.train()`, as
    the JAX package's `train=True`."""

    def __init__(self, iteration: int = 4, test: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        disable_tf32()
        self.test = test
        self.compute_dtype = dtype
        self.feature_net = FeatureNet(dtype)
        self.iter_mvs = IterMVS(iteration=iteration, test=test, dtype=dtype)
        if test:
            self.eval()

    def train(self, mode: bool = True):
        return super().train(mode and not self.test)

    @staticmethod
    def _normalize(x: torch.Tensor) -> torch.Tensor:
        """uint8 images → [-1, 1] float32, the loader's `2·x/255 − 1` bit
        for bit; float inputs pass through as float32.

        The divisor is a tensor on `x`'s device: CUDA turns a division by
        a Python scalar into a product with its reciprocal, which is one
        bit off the loader's quotient for 111 of the 256 values."""
        if x.dtype == torch.uint8:
            return torch.div(2.0 * x.float(), torch.full((), 255.0, device=x.device)) - 1.0
        return x.float()

    def extract(self, imgs: torch.Tensor) -> dict:
        """FeatureNet over a flat batch of views.

        imgs: [N, H, W, 3] NHWC float in [-1, 1] (or raw uint8) → dict
        level1..3 of NCHW [N, C, h, w] in the compute dtype. A separate entry point so that
        inference can compute each image's features once per scan and
        reuse them for every depth map it appears in (the eval feature
        cache)."""
        x = self._normalize(imgs).permute(0, 3, 1, 2).contiguous()
        return self.feature_net(x)

    def match(self, features, proj_matrices, depth_min, depth_max) -> dict:
        """IterMVS on precomputed features.

        features: dict level1..3 of [B, V, C, h, w] (view 0 = reference),
        or a sequence of V per-view dicts level1..3 of [B, C, h, w] (the
        eval feature cache's form)."""
        if isinstance(features, (list, tuple)):
            ref = {k: features[0][k] for k in LEVELS}
            src = {k: [f[k] for f in features[1:]] for k in LEVELS}
        else:
            ref = {k: features[k][:, 0] for k in LEVELS}
            src = {k: list(features[k][:, 1:].unbind(1)) for k in LEVELS}
        rel_projs = {}
        for level in (1, 2, 3):
            proj = proj_matrices[f"level_{level}"].float()              # [B,V,4,4]
            rel_projs[f"level{level}"] = relative_projection(proj[:, 1:],
                                                             proj[:, 0:1])
        b = ref["level2"].shape[0]
        out = self.iter_mvs(ref, src, rel_projs, depth_min.float().reshape(b),
                            depth_max.float().reshape(b))
        nhwc = lambda x: x.permute(0, 2, 3, 1)
        if self.test:
            depth, depth_up, conf, conf_up = out
            return {
                "depth": nhwc(depth),
                "depths_upsampled": nhwc(depth_up),
                "confidence": nhwc(conf),
                "confidence_upsampled": nhwc(conf_up),
            }
        depths, depths_up, confs, conf_up = out
        return {
            "depths": {k: [nhwc(x) for x in v] for k, v in depths.items()},
            "depths_upsampled": [nhwc(x) for x in depths_up],
            "confidences": [nhwc(x) for x in confs],
            "confidence_upsampled": nhwc(conf_up),
        }

    def forward(self, imgs, proj_matrices, depth_min, depth_max) -> dict:
        x = imgs["level_0"]                                       # [B,V,H,W,3]
        b, v = x.shape[:2]
        flat = self.extract(x.reshape(b * v, *x.shape[2:]))
        features = {k: f.reshape(b, v, *f.shape[1:]) for k, f in flat.items()}
        return self.match(features, proj_matrices, depth_min, depth_max)
