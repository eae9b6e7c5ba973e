"""Multi-term IterMVS training loss (counterpart of
itermvs_tpu/models/losses.py).

All depth terms operate in normalized inverse-depth space. Components,
with per-prediction decay 0.8^(n−i−1):
  1. L1 ×256 on the initialization-sweep depth (level-2 GT);
  2. per GRU prediction: 256-bin cross-entropy vs the one-hot GT bin;
  3. (regress mode) windowed L1 ×256 where the GT bin falls within ±4
     bins of the predicted argmax;
  4. (regress mode) confidence BCE-with-logits, GT = |err| < 0.002 with
     the prediction detached;
  5. L1 ×256 on the ×4-upsampled final depth (level-0 GT).

Inputs are the JAX layout, [B, H, W, C]. Every masked mean is sum/count
with an empty-mask guard (0 when the mask is empty). In a process group
(parallel/mesh.py) the count is the global batch's, and each rank's
loss is its share of the global loss: local sum / global count. The
ranks' shares, and their gradients, sum to the JAX step's global loss
and its gradient; the training step sums both over the ranks.
"""
from __future__ import annotations

import torch

from itermvs_tpu_torch.models.itermvs import NUM_BINS, RADIUS
from itermvs_tpu_torch.ops.depth_range import depth_normalization
from itermvs_tpu_torch.parallel.mesh import all_reduce_sum, is_initialized


def _masked_mean(x, mask):
    count = mask.sum()
    if is_initialized():
        count = all_reduce_sum(count.detach())
    mean = (x * mask).sum() / torch.clamp(count, min=1.0)
    return torch.where(count > 0, mean, torch.zeros_like(mean))


def _bce_with_logits(logits, targets):
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def full_loss(outputs, depths_gt, masks, depth_min, depth_max, regress=True):
    """Args:
      outputs: train-mode Pipeline output dict (depths / depths_upsampled /
        confidences).
      depths_gt: dict level_0..3 of [B, H, W, 1] GT depth.
      masks: dict level_0..3 of [B, H, W, 1] validity (thresholded > 0.5).
      depth_min, depth_max: [B].
      regress: include the windowed-regression and confidence terms
        (stage 2).

    Returns the scalar loss (in a process group, this rank's share).
    """
    batch = depth_min.shape[0]
    idmin = (1.0 / depth_min).reshape(batch, 1, 1, 1)
    idmax = (1.0 / depth_max).reshape(batch, 1, 1, 1)

    mask_0 = (masks["level_0"] > 0.5).float()
    mask_1 = (masks["level_2"] > 0.5).float()
    depth_gt_0 = depths_gt["level_0"]
    depth_gt_1 = depths_gt["level_2"]

    norm_gt = depth_normalization(depth_gt_1, idmin, idmax)          # [B,H,W,1]
    gt_index = torch.clamp(norm_gt, 0.0, 1.0) * (NUM_BINS - 1)
    gt_index = torch.floor(gt_index * mask_1).long()                 # [B,H,W,1]

    probabilities = outputs["depths"]["probability"]
    combines = outputs["depths"]["combine"]
    confidences = outputs["confidences"]
    num_prediction = len(combines)

    # 1. Initialization sweep depth.
    init_norm = depth_normalization(outputs["depths"]["initial"][0], idmin, idmax)
    loss = 0.8 ** num_prediction * NUM_BINS * _masked_mean(
        (init_norm - norm_gt).abs(), mask_1)

    for i in range(num_prediction):
        coeff = 0.8 ** (num_prediction - i - 1)
        probability = torch.clamp(probabilities[i], min=1e-5)         # [B,H,W,256]
        # The one-hot cross-entropy: −log p at the GT bin.
        ce = -torch.log(probability).gather(-1, gt_index)
        loss = loss + coeff * _masked_mean(ce, mask_1)

        if regress:
            pred_index = probability.argmax(dim=-1, keepdim=True)
            in_window = ((gt_index >= pred_index - RADIUS)
                         & (gt_index <= pred_index + RADIUS)).float()
            norm_depth = depth_normalization(combines[i], idmin, idmax)
            loss = loss + coeff * NUM_BINS * _masked_mean(
                (norm_depth - norm_gt).abs(), mask_1 * in_window)

            conf_gt = ((norm_depth.detach() - norm_gt).abs() < 0.002).float()
            bce = _bce_with_logits(confidences[i], conf_gt)
            loss = loss + coeff * _masked_mean(bce, mask_1)

    # 5. Upsampled final depth at full crop resolution.
    norm_gt_0 = depth_normalization(depth_gt_0, idmin, idmax)
    norm_up = depth_normalization(outputs["depths_upsampled"][0], idmin, idmax)
    return loss + NUM_BINS * _masked_mean((norm_up - norm_gt_0).abs(), mask_0)
