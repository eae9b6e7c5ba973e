"""Depth metrics + epoch aggregation (counterpart of
itermvs_tpu/engine/metrics.py).

Metrics are computed per image over the valid mask, then averaged over
the images of the batch that have any valid pixel. Functions take
[B, H, W, 1] maps and return 0-dim tensors, so a step reads them back
only when it logs.
"""
from __future__ import annotations

import torch


def _per_image_masked_mean(values, mask):
    """[B, ...] masked mean per image → ([B] means, [B] has-valid flags)."""
    b = values.shape[0]
    v = values.reshape(b, -1)
    m = mask.reshape(b, -1)
    count = m.sum(dim=1)
    means = (v * m).sum(dim=1) / torch.clamp(count, min=1.0)
    means = torch.where(count > 0, means, torch.zeros_like(means))
    return means, (count > 0).to(values.dtype)


def _batch_mean(per_image, has_valid):
    """Average per-image metrics over images that have any valid pixels
    (an image whose mask is empty counts for nothing)."""
    n = has_valid.sum()
    mean = (per_image * has_valid).sum() / torch.clamp(n, min=1.0)
    return torch.where(n > 0, mean, torch.zeros_like(mean))


def abs_depth_error(depth_est, depth_gt, mask):
    """Mean |est − gt| over mask, averaged per image then over batch."""
    mask = (mask > 0.5).to(depth_est.dtype)
    return _batch_mean(*_per_image_masked_mean((depth_est - depth_gt).abs(), mask))


def threshold_metric(depth_est, depth_gt, mask, thres):
    """Fraction of masked pixels with |err| > thres (outlier rate)."""
    mask = (mask > 0.5).to(depth_est.dtype)
    outlier = ((depth_est - depth_gt).abs() > thres).to(depth_est.dtype)
    return _batch_mean(*_per_image_masked_mean(outlier, mask))


def depth_metrics(depths_combine, depth_upsampled, depth_gt, mask, num_iters):
    """The reference's scalar set as a flat dict."""
    gt_1, mask_1 = depth_gt["level_2"], mask["level_2"]
    gt_0, mask_0 = depth_gt["level_0"], mask["level_0"]
    out = {
        "abs_error_initial": abs_depth_error(depths_combine[0], gt_1, mask_1),
        "thres1mm_initial": threshold_metric(depths_combine[0], gt_1, mask_1, 1),
        "abs_error_final_full": abs_depth_error(depth_upsampled, gt_0, mask_0),
        "thres1mm_final_full": threshold_metric(depth_upsampled, gt_0, mask_0, 1),
        "thres2mm_final_full": threshold_metric(depth_upsampled, gt_0, mask_0, 2),
        "thres4mm_final_full": threshold_metric(depth_upsampled, gt_0, mask_0, 4),
        "thres8mm_final_full": threshold_metric(depth_upsampled, gt_0, mask_0, 8),
    }
    for j in range(1, num_iters + 1):
        out[f"thres1mm_gru_{j}"] = threshold_metric(depths_combine[j], gt_1, mask_1, 1)
        out[f"abs_error_gru_{j}"] = abs_depth_error(depths_combine[j], gt_1, mask_1)
    return out


class DictAverageMeter:
    """Running mean of scalar dicts (each update weighs `n`)."""

    def __init__(self):
        self.data: dict[str, float] = {}
        self.count = 0

    def update(self, new_input: dict, n: int = 1):
        self.count += n
        for k, v in new_input.items():
            self.data[k] = self.data.get(k, 0.0) + float(v) * n

    def mean(self):
        return {k: v / self.count for k, v in self.data.items()}
