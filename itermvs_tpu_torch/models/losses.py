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

On the card the loss runs as kernels K23 and K24 (ops/full_loss.py,
label `full_loss`); on the CPU as eager PyTorch ops (`full_loss_plain`).
"""
from __future__ import annotations

from torch.profiler import record_function

# `_masked_mean` is imported from here by the process-group tests.
from itermvs_tpu_torch.ops.full_loss import _masked_mean, full_loss_plain, fused_full_loss

__all__ = ["full_loss", "_masked_mean"]


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
    if depth_min.device.type == "cpu":
        return full_loss_plain(outputs, depths_gt, masks, depth_min, depth_max, regress)
    with record_function("full_loss"):
        return fused_full_loss(outputs, depths_gt, masks, depth_min, depth_max, regress)
